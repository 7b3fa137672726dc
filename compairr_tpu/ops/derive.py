"""Device-side layouts for the sparse tile kernels.

The host computes only the bucket sort order and the sorted keys
(engine.pack_keys) and packs residues five bits each; the device
gathers the rows into bucket order, unpacks them, reverses each row
within its own length (for the one-indel suffix check) and lays both
out position-major, so a kernel reads one position of a whole row
block as one contiguous vector.

Per set, device_rows_raw returns a dict of device arrays:
  seqs   int8  [lmax, npad]  residues, position-major
  rseqs  int8  [lmax, npad]  per-row reversed residues (indel runs only)
  grp    int32 [npad]        (v, j) bucket of the row; 0 when genes are
                             ignored, -1 for padding rows
  len    int32 [npad]        sequence length; 0 for padding rows
  orig   int32 [npad]        original row index; -1 for padding rows
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np

from ..utils.lazyjax import jax, jnp, lax

RES_PER_WORD = 6  # 5-bit residues per int32 word (values < 32)


def _pack_residues(seqs_i8: np.ndarray) -> np.ndarray:
    """Host half of the residue compression: 6 five-bit residues per
    int32 word, a quarter of the int8 layout's upload bytes at lmax
    24. All residue codes (aa 0..20 incl. pad, nt 0..4) fit 5 bits."""
    n, l = seqs_i8.shape
    nw = -(-l // RES_PER_WORD)
    grown = np.zeros((n, nw * RES_PER_WORD), dtype=np.uint32)
    grown[:, :l] = seqs_i8.astype(np.uint32)
    g = grown.reshape(n, nw, RES_PER_WORD)
    packed = g[:, :, 0].copy()
    for k in range(1, RES_PER_WORD):
        packed |= g[:, :, k] << np.uint32(5 * k)
    return packed.astype(np.int32)


def _packed_upload(db, m: int, lpad: int, pad_val: int) -> np.ndarray:
    """[m, nw] int32 packed residues for upload: native single pass
    when available, else the staging-copy + numpy pack."""
    from ..io.native import pack5_rows_native

    nw = -(-lpad // RES_PER_WORD)
    nat = pack5_rows_native(db.seqs, m, lpad, nw, pad_val)
    if nat is not None:
        return nat
    n = db.n
    seqs = np.full((m, lpad), pad_val, dtype=np.int8)
    if n:
        seqs[:n, : db.seqs.shape[1]] = db.seqs
    return _pack_residues(seqs)


def _unpack_residues(packed, lmax: int):
    """Device half: [N, nw] int32 -> [N, lmax] int8."""
    npad, nw = packed.shape
    shifts = (jnp.arange(RES_PER_WORD, dtype=jnp.int32) * 5).reshape(
        1, 1, RES_PER_WORD
    )
    res = ((packed[:, :, None] >> shifts) & 31).astype(jnp.int8)
    return res.reshape(npad, nw * RES_PER_WORD)[:, :lmax]


_DERIVE_CHUNK = 1 << 21  # rows per derive step: bounds int32 temps


def _seqs_chunk(seqs_packed, lengths_c, order_c, pad_val: int, lmax: int,
                with_rseqs: bool):
    """Gather + unpack (+ per-row reversal) for one row chunk, returned
    position-major ([lmax, rows])."""
    seqs = _unpack_residues(jnp.take(seqs_packed, order_c, axis=0), lmax)
    if not with_rseqs:
        return seqs.T, None
    pos = jnp.arange(lmax, dtype=jnp.int32)[None, :]
    idx = jnp.clip(lengths_c[:, None] - 1 - pos, 0, lmax - 1)
    rev = jnp.take_along_axis(seqs, idx, axis=1)
    rseqs = jnp.where(
        pos < lengths_c[:, None], rev, jnp.int8(pad_val)
    ).astype(jnp.int8)
    return seqs.T, rseqs.T


def _gathered_seqs(seqs_packed, lengths_s, order, pad_val: int, lmax: int,
                   with_rseqs: bool):
    """Sorted position-major residue matrices (+ reversed rows when the
    indel check needs them), derived in fixed-size row chunks: the
    gather/unpack/reversal temporaries are int32 [rows, lmax], which
    at tens of millions of rows would otherwise exceed device memory
    in one shot."""
    npad = order.shape[0]
    if npad <= _DERIVE_CHUNK:
        return _seqs_chunk(
            seqs_packed, lengths_s, order, pad_val, lmax, with_rseqs
        )
    c = _DERIVE_CHUNK
    nchunks = -(-npad // c)

    def body(i, bufs):
        sb, rb = bufs
        start = jnp.minimum(i * c, npad - c)
        o = lax.dynamic_slice_in_dim(order, start, c)
        lens = lax.dynamic_slice_in_dim(lengths_s, start, c)
        s, r = _seqs_chunk(seqs_packed, lens, o, pad_val, lmax, with_rseqs)
        sb = lax.dynamic_update_slice(sb, s, (0, start))
        if with_rseqs:
            rb = lax.dynamic_update_slice(rb, r, (0, start))
        return sb, rb

    init = (
        jnp.zeros((lmax, npad), jnp.int8),
        jnp.zeros((lmax, npad if with_rseqs else 1), jnp.int8),
    )
    seqs, rseqs = lax.fori_loop(0, nchunks, body, init)
    return seqs, (rseqs if with_rseqs else None)


@lru_cache(maxsize=None)
def _derive_fn(pad_val: int, lmax: int, with_indels: bool):
    """Device-side bucket gather from the raw (unsorted) upload. The
    row order, bucket and length rows arrive sorted from the host;
    `orig` is the order itself, with padding rows (which point at the
    all-pad sentinel row `sentinel`) set to -1."""

    @jax.jit
    def f(seqs_packed, grp, lengths, sentinel, order):
        seqs, rseqs = _gathered_seqs(
            seqs_packed, lengths, order, pad_val, lmax, with_indels
        )
        orig = jnp.where(order >= sentinel, jnp.int32(-1), order)
        return dict(seqs=seqs, rseqs=rseqs, grp=grp, len=lengths, orig=orig)

    return f


def _canon_src(n: int) -> int:
    """Canonical raw-upload row count (see engine.canon_rows)."""
    from .engine import canon_rows

    return canon_rows(n, 1024)


def device_rows_raw(db, order: np.ndarray, sort_key: np.ndarray,
                    npad: int, lmax: int, indels: bool) -> dict:
    """Upload a SeqDB's packed residues and derive the sorted kernel
    layouts on device (see the module docstring). `order` and
    `sort_key` are engine.pack_keys' outputs: the bucket key is
    (vj << 16) | length, or the length alone when genes are ignored."""
    n = db.n
    pad_val = int(db.pad_value)
    m = _canon_src(n + 1)
    order_full = np.full(npad, n, dtype=np.int32)
    order_full[:n] = order
    real = sort_key[:n]
    grp = np.full(npad, -1, dtype=np.int32)
    lengths = np.zeros(npad, dtype=np.int32)
    if n:
        vj = real >> 16
        if int(vj.max()) >= 1 << 31:
            raise ValueError("gene table too large for int32 buckets")
        grp[:n] = vj
        lengths[:n] = real & 0xFFFF
    dev = jax.device_put
    return _derive_fn(pad_val, lmax, indels)(
        dev(_packed_upload(db, m, lmax, pad_val)),
        dev(grp),
        dev(lengths),
        jnp.int32(n),
        dev(order_full),
    )
