"""compairr_tpu — a GPU engine for comparing adaptive immune receptor repertoires.

A from-scratch reimplementation of the capabilities of CompAIRR
(uio-bmi/compairr): repertoire overlap matrices (--matrix), sequence
existence (--existence), single-linkage clustering (--cluster), and
deduplication (--deduplicate) over amino-acid or nucleotide
CDR3/junction sequences, with V/J-gene matching and
duplicate-count-weighted scoring.

Instead of the reference's CPU design (Zobrist hashing + Bloom filter +
open-addressing hash table; see the reference's src/zobrist.cc,
bloompat.cc, hashtable.cc), the device path here is JAX/XLA with
Triton kernels for the GPU: sequences are packed into fixed-width int8
tensors, approximate matching (Hamming distance and the one-indel
prefix/suffix check) runs as per-tile kernels over a block-sparse
all-vs-all grid, and multi-device scaling shards one set row-wise over
a jax.sharding.Mesh and merges partial overlap matrices with psum.
"""

__version__ = "0.1.0"

PROG_CMD = "compairr_tpu"
PROG_NAME = "CompAIRR-GPU"
PROG_BRIEF = "Comparison of Adaptive Immune Receptor Repertoires"
