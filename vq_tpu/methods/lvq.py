"""Locally-adaptive Vector Quantization (LVQ).

Parity with the reference's single-level SVS-style LVQ
(methods/lvq_quantization.py:23-151): global mean, per-vector lo/delta
uniform scalar quantizer, self-contained rows
[packed B-bit indices ‖ lo f32 ‖ delta f32] = ceil(D·B/8)+8 bytes.
Encode/decode are fused elementwise XLA programs over the whole batch; the
per-tile decode plugs into the generic fused ADC scan.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from vq_tpu.core.config import LVQConfig
from vq_tpu.core.packing import (
    bytes_to_f32,
    f32_to_bytes,
    pack_bits,
    packed_bytes,
    unpack_bits,
)
from vq_tpu.methods.base import BaseQuantizer


class LVQParams(NamedTuple):
    mean: jax.Array  # (D,) global mean


def fit(x: jax.Array) -> LVQParams:
    return LVQParams(mean=jnp.mean(jnp.asarray(x, dtype=jnp.float32), axis=0))


def encode(params: LVQParams, x: jax.Array, num_bits: int) -> jax.Array:
    x = jnp.asarray(x, dtype=jnp.float32)
    levels = (1 << num_bits) - 1
    r = x - params.mean
    lo = jnp.min(r, axis=1)
    span = jnp.max(r, axis=1) - lo
    delta = jnp.where(span == 0.0, jnp.finfo(jnp.float32).tiny, span / levels)
    idx = jnp.clip(jnp.round((r - lo[:, None]) / delta[:, None]), 0, levels).astype(
        jnp.int32
    )
    return jnp.concatenate(
        [pack_bits(idx, num_bits), f32_to_bytes(lo), f32_to_bytes(delta)], axis=1
    )


def decode(params: LVQParams, codes: jax.Array, num_bits: int) -> jax.Array:
    d = params.mean.shape[0]
    ib = packed_bytes(d, num_bits)
    idx = unpack_bits(codes[:, :ib], num_bits, d)
    lo = bytes_to_f32(codes[:, ib : ib + 4])
    delta = bytes_to_f32(codes[:, ib + 4 : ib + 8])
    return idx.astype(jnp.float32) * delta[:, None] + lo[:, None] + params.mean


class LVQ(BaseQuantizer):
    name = "lvq"

    def __init__(self, cfg: LVQConfig = LVQConfig()):
        super().__init__()
        if not 1 <= cfg.num_bits <= 8:
            raise ValueError("num_bits must be in [1, 8]")
        self.cfg = cfg

    def fit(self, X: np.ndarray) -> "LVQ":
        self._dim = X.shape[1]
        self.params = fit(jnp.asarray(X))
        return self

    def compress(self, X: np.ndarray, chunk: int = 16384) -> np.ndarray:
        # row-chunked: pack_bits materializes an (n, D, bits) bit tensor
        # (4.9 GB at 100k×1536×8 before reshape copies)
        out = []
        for i0 in range(0, X.shape[0], chunk):
            out.append(np.asarray(encode(
                self.params, jnp.asarray(X[i0 : i0 + chunk]),
                self.cfg.num_bits)))
        return np.concatenate(out) if len(out) > 1 else out[0]

    def decompress(self, codes: np.ndarray) -> np.ndarray:
        return np.asarray(decode(self.params, jnp.asarray(codes), self.cfg.num_bits))

    def decode_fn(self):
        params, bits = self.params, self.cfg.num_bits
        return lambda ct: decode(params, ct, bits)

    def code_bytes_per_vector(self) -> float:
        return float(packed_bytes(self._dim, self.cfg.num_bits) + 8)

    def config_dict(self):
        return {"B": self.cfg.num_bits}
