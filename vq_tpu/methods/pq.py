"""Product Quantization.

Capability parity with the reference's faiss-backed ProductQuantizer
(src/haag_vq/methods/product_quantization.py:9-99): M subquantizers × B bits,
per-chunk codebooks of shape (M, 2^B, D/M).  Training runs all M subspace
k-means problems as one vmapped batched-Lloyd program
(kernels/kmeans.py) instead of faiss's sequential per-subspace loop; encoding
is a tiled matmul-argmin; decoding is the one-hot × codebook matmul shared
with the fused ADC scan (kernels/adc.py).
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from vq_tpu.core.config import PQConfig
from vq_tpu.kernels.adc import decode_pq
from vq_tpu.kernels.kmeans import kmeans_batched
from vq_tpu.methods.base import BaseQuantizer


class PQParams(NamedTuple):
    codebooks: jax.Array  # (M, K, dsub) float32


def _to_subspaces(x: jax.Array, m: int) -> jax.Array:
    """(N, D) → (M, N, D/M)."""
    n, d = x.shape
    if d % m != 0:
        raise ValueError(f"dim {d} not divisible by num_subquantizers {m}")
    return x.reshape(n, m, d // m).transpose(1, 0, 2)


def fit(key: jax.Array, x, cfg: PQConfig, seed: int = 0) -> PQParams:
    # subsample rows BEFORE any device transfer or the (M, N, dsub)
    # transpose: kmeans only trains on max_points_per_centroid·K rows, and a
    # full-corpus jnp.asarray is a 217 GB HBM transfer at the 53M target;
    # host corpora (numpy/mmap) sample host-side
    from vq_tpu.data.sampling import host_sample_rows

    cap = cfg.kmeans.max_points_per_centroid * cfg.codebook_size
    x = jnp.asarray(host_sample_rows(x, cap, seed), jnp.float32)
    xs = _to_subspaces(x, cfg.num_subquantizers)
    codebooks = kmeans_batched(key, xs, cfg.codebook_size, cfg.kmeans)
    return PQParams(codebooks=codebooks)


def encode_chunked(
    codebooks: jax.Array,
    x: jax.Array,
    rotation: jax.Array | None = None,
    chunk: int = 65536,
) -> jax.Array:
    """Subspace argmin encode, row-chunked: (N, D) → (N, M) integer codes.

    Peak memory is O(chunk), not O(N): a full-corpus (M, N, dsub)
    transpose plus a pad copy tripled the corpus footprint and OOM'd HBM
    at N=1M, D=1536.  Per chunk this is (optional rotation matmul +) one
    batched einsum + argmin; ‖x_sub‖² is constant per (row, m) so
    argmin only needs ‖cb‖² − 2·x_sub·cb.  Shared by PQ and OPQ (which
    passes its learned rotation)."""
    cb = codebooks  # (M, K, dsub)
    m, kk, dsub = cb.shape
    x = jnp.asarray(x, dtype=jnp.float32)
    n, d = x.shape
    if d != m * dsub:
        raise ValueError(f"dim {d} != M·dsub = {m}·{dsub}")
    dtype = jnp.uint8 if kk <= 256 else jnp.uint16
    c2 = jnp.sum(cb * cb, axis=-1)  # (M, K)

    chunk = min(chunk, max(8, n))
    if n < chunk:
        x = jnp.pad(x, ((0, chunk - n), (0, 0)))  # tiny corpora only
    nc = -(-n // chunk)

    def encode_one(xc):
        if rotation is not None:
            xc = jnp.dot(xc, rotation, preferred_element_type=jnp.float32,
                         precision=jax.lax.Precision.HIGHEST)
        xs = xc.reshape(chunk, m, dsub)
        ip = jnp.einsum(
            "cmd,mkd->cmk", xs, cb, preferred_element_type=jnp.float32,
            precision=jax.lax.Precision.HIGHEST,
        )
        return jnp.argmin(c2[None, :, :] - 2.0 * ip, axis=-1).astype(dtype)

    # ragged tail: clamp the slice start and write codes back at the same
    # clamped offset — the overlap rewrites identical values, and no padded
    # copy of the corpus is ever made (jnp.pad would double the footprint)
    def body(i, out):
        st = jnp.minimum(i * chunk, x.shape[0] - chunk)
        xc = jax.lax.dynamic_slice_in_dim(x, st, chunk, axis=0)
        return jax.lax.dynamic_update_slice(out, encode_one(xc), (st, 0))

    out = jnp.zeros((x.shape[0], m), dtype=dtype)
    return jax.lax.fori_loop(0, nc, body, out)[:n]


def encode(params: PQParams, x: jax.Array, chunk: int = 65536) -> jax.Array:
    """(N, D) → (N, M) integer codes (uint8 for B ≤ 8, else uint16)."""
    return encode_chunked(params.codebooks, x, chunk=chunk)


def decode(params: PQParams, codes: jax.Array) -> jax.Array:
    return decode_pq(params.codebooks, codes)


class PQ(BaseQuantizer):
    name = "pq"

    def __init__(self, cfg: PQConfig = PQConfig(), seed: int = 0):
        super().__init__()
        self.cfg = cfg
        self.seed = seed

    def fit(self, X: np.ndarray) -> "PQ":
        self._dim = X.shape[1]
        self.params = fit(jax.random.PRNGKey(self.seed), X, self.cfg, seed=self.seed)
        return self

    def compress(self, X: np.ndarray) -> np.ndarray:
        return np.asarray(encode(self.params, jnp.asarray(X)))

    def decompress(self, codes: np.ndarray) -> np.ndarray:
        return np.asarray(decode(self.params, jnp.asarray(codes)))

    def decode_fn(self):
        codebooks = self.params.codebooks
        return lambda ct: decode_pq(codebooks, ct)

    def encode_fn(self):
        params = self.params
        return lambda x: encode(params, x)

    def scan_topk(self, queries, codes, k, metric, norms=None, tile_rows=16384,
                  use_bf16=True, approx=False, num_valid=None):
        from vq_tpu.kernels.adc import scan_codes_topk

        return scan_codes_topk(
            queries, codes, self.params.codebooks, k, metric, norms, tile_rows,
            use_bf16, approx=approx, num_valid=num_valid,
        )

    def code_bytes_per_vector(self) -> float:
        bytes_per_code = 1 if self.cfg.num_bits <= 8 else 2
        return float(self.cfg.num_subquantizers * bytes_per_code)

    def config_dict(self):
        return {
            "M": self.cfg.num_subquantizers,
            "B": self.cfg.num_bits,
            "kmeans_iters": self.cfg.kmeans.iters,
        }
