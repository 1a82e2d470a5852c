"""Scalar Quantization.

Parity with reference methods/scalar_quantization.py:6-100: per-dimension
min/max uniform quantization at 4/8/16 bits, with 4-bit nibble packing
(reference lines 58-66).  The reference chunks compression in 2M-row pieces
as a 53M OOM guard (lines 41-50); here encode/decode are single fused
elementwise XLA programs — tiling, when needed at corpus scale, happens at
the harness/sharding layer.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from vq_tpu.core.config import SQConfig
from vq_tpu.methods.base import BaseQuantizer


class SQParams(NamedTuple):
    lo: jax.Array  # (D,) per-dim min
    scale: jax.Array  # (D,) (max-min)/(2^b - 1), zeros→1 guarded


def fit(x, cfg: SQConfig) -> SQParams:
    """x may be a jax array, numpy array, or np.memmap (streamed)."""
    # chunked per-dim min/max: host corpora (numpy/mmap) stream to device in
    # bounded chunks instead of one full-corpus transfer (the reference SQ's
    # 53M OOM guard, scalar_quantization.py:41-50)
    from vq_tpu.data.sampling import chunked_min_max

    lo, hi = chunked_min_max(x)
    levels = (1 << cfg.num_bits) - 1
    scale = (hi - lo) / levels
    scale = jnp.where(scale > 0, scale, 1.0)
    return SQParams(lo=lo, scale=scale)


@functools.partial(jax.jit, static_argnames=("num_bits",))
def encode(params: SQParams, x: jax.Array, num_bits: int) -> jax.Array:
    x = jnp.asarray(x, dtype=jnp.float32)
    levels = (1 << num_bits) - 1
    q = jnp.clip(jnp.round((x - params.lo) / params.scale), 0, levels)
    if num_bits == 4:
        q = q.astype(jnp.uint8)
        if q.shape[1] % 2:
            q = jnp.pad(q, ((0, 0), (0, 1)))
        return q[:, 0::2] | (q[:, 1::2] << 4)  # two dims per byte
    if num_bits <= 8:
        return q.astype(jnp.uint8)
    return q.astype(jnp.uint16)


@functools.partial(jax.jit, static_argnames=("num_bits", "dim"))
def decode(params: SQParams, codes: jax.Array, num_bits: int, dim: int) -> jax.Array:
    if num_bits == 4:
        lo_nib = codes & 0x0F
        hi_nib = codes >> 4
        q = jnp.stack([lo_nib, hi_nib], axis=-1).reshape(codes.shape[0], -1)
        q = q[:, :dim]
    else:
        q = codes
    return params.lo + q.astype(jnp.float32) * params.scale


class SQ(BaseQuantizer):
    name = "sq"

    def __init__(self, cfg: SQConfig = SQConfig()):
        super().__init__()
        if cfg.num_bits not in (4, 8, 16):
            raise ValueError("SQ supports 4, 8, or 16 bits")
        self.cfg = cfg

    def fit(self, X: np.ndarray) -> "SQ":
        self._dim = X.shape[1]
        self.params = fit(X, self.cfg)
        return self

    def compress(self, X: np.ndarray) -> np.ndarray:
        return np.asarray(encode(self.params, jnp.asarray(X), self.cfg.num_bits))

    def decompress(self, codes: np.ndarray) -> np.ndarray:
        return np.asarray(
            decode(self.params, jnp.asarray(codes), self.cfg.num_bits, self._dim)
        )

    def decode_fn(self):
        params, num_bits, dim = self.params, self.cfg.num_bits, self._dim
        return lambda ct: decode(params, ct, num_bits, dim)

    def encode_fn(self):
        params, num_bits = self.params, self.cfg.num_bits
        return lambda x: encode(params, x, num_bits)

    def code_bytes_per_vector(self) -> float:
        return self._dim * self.cfg.num_bits / 8.0

    def config_dict(self):
        return {"B": self.cfg.num_bits}
