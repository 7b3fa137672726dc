"""Deferred JAX loading for host-only routes.

CompAIRR's most common runs — exact joins, dedup, substitution-distance
pigeonhole, existence variant joins — never touch a device, so the
engine imports jax through the lazy proxies below: the first attribute
access imports the real module, and host-only runs never pay the jax
import.
"""

from __future__ import annotations

import importlib

_loaded: dict = {}


class _Lazy:
    """Module proxy resolving on first attribute access."""

    def __init__(self, name: str):
        self._name = name

    def __getattr__(self, attr):
        mod = _loaded.get(self._name)
        if mod is None:
            mod = importlib.import_module(self._name)
            _loaded[self._name] = mod
        return getattr(mod, attr)


jax = _Lazy("jax")
jnp = _Lazy("jax.numpy")
lax = _Lazy("jax.lax")
