import os
import sys

import pytest

# Tests run on the CPU backend, with 8 virtual devices so the sharding
# logic is exercised without a multi-GPU host. COMPAIRR_TEST_GPU=1
# leaves the platform alone, for running the `gpu`-marked tests on a
# machine with a card (`python -m pytest tests -m gpu`).
if not os.environ.get("COMPAIRR_TEST_GPU"):
    os.environ["JAX_PLATFORMS"] = "cpu"
    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (
            flags + " --xla_force_host_platform_device_count=8"
        ).strip()

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

# Golden fixtures of the reference's own test (see tests/data/README)
REF_TEST_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data")


@pytest.fixture
def gpu():
    """Skips the test unless JAX runs on a CUDA GPU. Decided here, at
    run time, so every xdist worker collects the same tests."""
    import jax

    if jax.default_backend() != "gpu":
        pytest.skip(
            "needs a CUDA GPU: COMPAIRR_TEST_GPU=1 python -m pytest "
            "tests -m gpu"
        )
