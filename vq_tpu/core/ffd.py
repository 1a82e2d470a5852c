"""First-Fit-Decreasing packing of per-dimension bit widths into bytes.

Capability parity with the reference's FFD packer
(methods/ffd_packing.py:25-117): every dim's b_d-bit field lives wholly
inside one byte (b_d ≤ 8), placed by FFD with the "4-fix" (width-4 fields
inserted after the width-3 fields so a lone 4 can't break the 3s' packing —
the reference verified this exhaustively optimal for cap 8).

Vectorized encode/decode: non-overlapping fields make bitwise-OR equal to
addition, so packing is `(codes << shift) @ Assign` — one small integer
matmul with a static (D, n_bytes) 0/1 assignment matrix — and unpacking is
a byte gather (static indices) + shift/mask on the VPU.  No per-dim loops
on device.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp
import numpy as np


class FFDLayout(NamedTuple):
    bits: np.ndarray  # (D,) widths
    byte_idx: np.ndarray  # (D,) byte each dim lands in (-1 for width 0)
    shift: np.ndarray  # (D,) left-shift placing the field (MSB-first), -1 for width 0
    n_bytes: int


def ffd_layout(bits_per_dim: np.ndarray, byte_cap: int = 8) -> FFDLayout:
    b = np.asarray(bits_per_dim, dtype=np.int64)
    d_total = b.shape[0]
    if np.any(b < 0) or np.any(b > byte_cap):
        raise ValueError(f"bit widths must be in [0, {byte_cap}]")
    byte_idx = np.full(d_total, -1, dtype=np.int64)
    bit_off = np.full(d_total, -1, dtype=np.int64)

    order = sorted((d for d in range(d_total) if b[d] > 0), key=lambda d: (-b[d], d))
    # 4-fix: width-4 fields go after the width-3 fields (cap 8 only)
    if byte_cap == 8:
        fours = [d for d in order if b[d] == 4]
        if fours:
            rest = [d for d in order if b[d] != 4]
            ins = next((i for i, d in enumerate(rest) if b[d] <= 2), len(rest))
            order = rest[:ins] + fours + rest[ins:]

    remaining: list = []
    for d in order:
        w = int(b[d])
        placed = next((i for i, r in enumerate(remaining) if r >= w), -1)
        if placed < 0:
            placed = len(remaining)
            remaining.append(byte_cap)
        bit_off[d] = byte_cap - remaining[placed]
        byte_idx[d] = placed
        remaining[placed] -= w

    shift = np.where(b > 0, byte_cap - bit_off - b, -1)
    return FFDLayout(bits=b, byte_idx=byte_idx, shift=shift, n_bytes=len(remaining))


def _assign_matrix(layout: FFDLayout) -> np.ndarray:
    """(D, n_bytes) 0/1 matrix mapping dims to their byte."""
    d_total = len(layout.bits)
    a = np.zeros((d_total, max(layout.n_bytes, 1)), dtype=np.float32)
    for d in range(d_total):
        if layout.bits[d] > 0:
            a[d, layout.byte_idx[d]] = 1.0
    return a


def ffd_encode(codes: jax.Array, layout: FFDLayout) -> jax.Array:
    """(N, D) int codes → (N, n_bytes) uint8 via shifted-OR-as-matmul."""
    shift = jnp.asarray(np.maximum(layout.shift, 0), dtype=jnp.int32)
    shifted = (codes.astype(jnp.int32) << shift[None, :]).astype(jnp.float32)
    assign = jnp.asarray(_assign_matrix(layout))
    packed = jnp.dot(shifted, assign, precision=jax.lax.Precision.HIGHEST)
    return jnp.round(packed).astype(jnp.uint8)


def ffd_decode_codes(packed: jax.Array, layout: FFDLayout) -> jax.Array:
    """(N, n_bytes) uint8 → (N, D) int32 codes (0 where width 0)."""
    byte_idx = np.maximum(layout.byte_idx, 0)
    gathered = packed[:, jnp.asarray(byte_idx)]  # static-index gather (N, D)
    shift = jnp.asarray(np.maximum(layout.shift, 0), dtype=jnp.int32)
    mask = jnp.asarray(
        np.where(layout.bits > 0, (1 << layout.bits) - 1, 0), dtype=jnp.int32
    )
    return (gathered.astype(jnp.int32) >> shift[None, :]) & mask[None, :]


def dense_layout_cols(bits_per_dim: np.ndarray) -> Tuple[np.ndarray, np.ndarray, int]:
    """Static column indices for DENSE (cross-byte, reference-default)
    variable-width packing: per-dim absolute bit offsets, MSB-first.

    Returns (dim_of_bit, weight_exp, total_bits): for global bit position p,
    dim_of_bit[p] is the source dim and weight_exp[p] the bit significance
    within that dim's field.
    """
    b = np.asarray(bits_per_dim, dtype=np.int64)
    dims, exps = [], []
    for d in range(len(b)):
        for j in range(int(b[d])):
            dims.append(d)
            exps.append(int(b[d]) - 1 - j)
    return np.asarray(dims, dtype=np.int64), np.asarray(exps, dtype=np.int64), len(dims)


def dense_encode(codes: jax.Array, bits_per_dim: np.ndarray) -> jax.Array:
    """(N, D) codes → (N, ceil(Σb/8)) uint8, contiguous MSB-first bit stream
    (the reference's 'dense' packing, rank_aware_quantization.py offsets)."""
    dims, exps, total = dense_layout_cols(bits_per_dim)
    bitsv = (codes.astype(jnp.int32)[:, jnp.asarray(dims)] >> jnp.asarray(exps)[None, :]) & 1
    pad = (-total) % 8
    if pad:
        bitsv = jnp.pad(bitsv, ((0, 0), (0, pad)))
    bitsv = bitsv.reshape(codes.shape[0], -1, 8)
    weights = 1 << jnp.arange(7, -1, -1, dtype=jnp.int32)
    return jnp.sum(bitsv * weights[None, None, :], axis=-1).astype(jnp.uint8)


def dense_decode_codes(packed: jax.Array, bits_per_dim: np.ndarray) -> jax.Array:
    """Inverse of dense_encode → (N, D) int32."""
    b = np.asarray(bits_per_dim, dtype=np.int64)
    d_total = len(b)
    dims, exps, total = dense_layout_cols(b)
    n = packed.shape[0]
    positions = jnp.arange(7, -1, -1, dtype=jnp.int32)
    bitsv = (packed.astype(jnp.int32)[:, :, None] >> positions[None, None, :]) & 1
    bitsv = bitsv.reshape(n, -1)[:, :total]  # (N, total_bits)
    # accumulate bit · 2^exp into its dim: one-hot matmul with static weights
    w = np.zeros((total, d_total), dtype=np.float32)
    w[np.arange(total), dims] = (1 << exps).astype(np.float32)
    out = jnp.dot(bitsv.astype(jnp.float32), jnp.asarray(w),
                  precision=jax.lax.Precision.HIGHEST)
    return jnp.round(out).astype(jnp.int32)
