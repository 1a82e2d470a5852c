"""Optimized Product Quantization.

Capability parity with the reference's faiss-backed OPQ
(src/haag_vq/methods/optimized_product_quantization.py:7-46: OPQMatrix
learned rotation + PQ on rotated data, reverse_transform on decode).

Algorithm (OPQ-NP, SURVEY.md §7.2 M1): start from a PQ fit on the
raw data, then alternate
  (1) one batched-Lloyd refinement of all M sub-codebooks on X·R (batched matmuls),
  (2) the orthogonal Procrustes update R = U·Vᵀ from SVD(Xᵀ·X̂)
until `opq_iters`.  The rotation is orthogonal, so L2/IP search in rotated
space is exact: queries are rotated once and the corpus scan is the same
fused PQ ADC kernel.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from vq_tpu.core.config import OPQConfig
from vq_tpu.kernels.adc import decode_pq
from vq_tpu.kernels.kmeans import assign_batched, kmeans_batched, pairwise_sqdist_xc
from vq_tpu.methods.base import BaseQuantizer
from vq_tpu.methods.pq import PQParams, _to_subspaces


class OPQParams(NamedTuple):
    rotation: jax.Array  # (D, D) orthogonal, applied as X @ R
    codebooks: jax.Array  # (M, K, dsub)


def _lloyd_refine(xs: jax.Array, codebooks: jax.Array,
                  budget_bytes: int = 1 << 30) -> jax.Array:
    """One Lloyd iteration keeping existing codebooks (M, K, dsub).

    Vmapped over subquantizer GROUPS: the all-M vmap materializes
    (M, n, K) distance + one-hot buffers — 19.6 GB at M=192, n=100k,
    K=256; grouping bounds the transient to ~budget_bytes with identical math."""
    def one(x, c):
        a = jnp.argmin(pairwise_sqdist_xc(x, c), axis=-1)
        onehot = jax.nn.one_hot(a, c.shape[0], dtype=jnp.float32)
        counts = jnp.sum(onehot, axis=0)
        sums = jnp.dot(onehot.T, x, preferred_element_type=jnp.float32,
                       precision=jax.lax.Precision.HIGHEST)
        new_c = sums / jnp.maximum(counts, 1.0)[:, None]
        return jnp.where((counts > 0)[:, None], new_c, c)

    m, n, _ = xs.shape
    kk = codebooks.shape[1]
    group = max(1, min(m, int(budget_bytes // (2 * 4 * n * kk))))
    if group >= m:
        return jax.vmap(one)(xs, codebooks)
    outs = [
        jax.vmap(one)(xs[g : g + group], codebooks[g : g + group])
        for g in range(0, m, group)
    ]
    return jnp.concatenate(outs, axis=0)


def _encode_decode(codebooks: jax.Array, xs: jax.Array) -> jax.Array:
    """(M, n, dsub) → reconstruction (n, D) using current codebooks."""
    codes = assign_batched(xs, codebooks).T
    return decode_pq(codebooks, codes)


def _xt_xhat(xt: jax.Array, xs: jax.Array, codebooks: jax.Array,
             budget_bytes: int = 1 << 30) -> jax.Array:
    """Xᵀ·X̂ accumulated over row chunks: the Procrustes update only needs
    the (D, D) product, so X̂ is never materialized whole."""
    n = xt.shape[0]
    m_sub, k_sz, _ = codebooks.shape
    chunk = max(512, int(budget_bytes // (4 * m_sub * k_sz)))
    acc = jnp.zeros((xt.shape[1], xt.shape[1]), jnp.float32)
    for i0 in range(0, n, chunk):
        xh = _encode_decode(codebooks, xs[:, i0 : i0 + chunk, :])
        acc = acc + jnp.dot(
            xt[i0 : i0 + chunk].T, xh, preferred_element_type=jnp.float32,
            precision=jax.lax.Precision.HIGHEST,
        )
    return acc


@jax.jit
def _procrustes_from_m(m: jax.Array) -> jax.Array:
    """argmin_{R orthogonal} ‖X·R − X̂‖_F = U·Vᵀ with U,S,Vᵀ = svd(Xᵀ·X̂)."""
    u, _, vt = jnp.linalg.svd(m, full_matrices=False)
    return jnp.dot(u, vt, precision=jax.lax.Precision.HIGHEST)


def fit(key: jax.Array, x, cfg: OPQConfig, train_cap: int = 100_000,
        seed: int = 0) -> OPQParams:
    # host-side subsampling BEFORE any device transfer: only the ≤train_cap
    # sample ever reaches HBM (53M-safe)
    from vq_tpu.data.sampling import host_sample_rows

    xt = jnp.asarray(host_sample_rows(x, train_cap, seed), jnp.float32)
    d = xt.shape[1]
    m = cfg.num_subquantizers
    if d % m != 0:
        raise ValueError(f"dim {d} not divisible by num_subquantizers {m}")
    _, key_pq = jax.random.split(key)

    r = jnp.eye(d, dtype=jnp.float32)
    # initial codebooks from a plain PQ fit
    codebooks = kmeans_batched(
        key_pq, _to_subspaces(xt, m), cfg.codebook_size, cfg.kmeans
    )
    for _ in range(cfg.opq_iters):
        xr = jnp.dot(xt, r, precision=jax.lax.Precision.HIGHEST)
        xs = _to_subspaces(xr, m)
        codebooks = _lloyd_refine(xs, codebooks)
        r = _procrustes_from_m(_xt_xhat(xt, xs, codebooks))
    # final codebook polish on the converged rotation
    xr = jnp.dot(xt, r, precision=jax.lax.Precision.HIGHEST)
    xs = _to_subspaces(xr, m)
    for _ in range(3):
        codebooks = _lloyd_refine(xs, codebooks)
    return OPQParams(rotation=r, codebooks=codebooks)


def encode(params: OPQParams, x: jax.Array) -> jax.Array:
    """Rotation folded into the row-chunked subspace encode so peak memory
    stays O(chunk) — see methods/pq.py encode_chunked."""
    from vq_tpu.methods.pq import encode_chunked

    return encode_chunked(params.codebooks, x, rotation=params.rotation)


def decode(params: OPQParams, codes: jax.Array) -> jax.Array:
    rec_rot = decode_pq(params.codebooks, codes)
    return jnp.dot(rec_rot, params.rotation.T, precision=jax.lax.Precision.HIGHEST)


class OPQ(BaseQuantizer):
    name = "opq"

    def __init__(self, cfg: OPQConfig = OPQConfig(), seed: int = 0):
        super().__init__()
        self.cfg = cfg
        self.seed = seed

    def fit(self, X: np.ndarray) -> "OPQ":
        self._dim = X.shape[1]
        self.params = fit(jax.random.PRNGKey(self.seed), X, self.cfg, seed=self.seed)
        return self

    def compress(self, X: np.ndarray) -> np.ndarray:
        return np.asarray(encode(self.params, jnp.asarray(X)))

    def decompress(self, codes: np.ndarray) -> np.ndarray:
        return np.asarray(decode(self.params, jnp.asarray(codes)))

    def decode_fn(self):
        params = self.params
        return lambda ct: decode(params, ct)

    def scan_topk(self, queries, codes, k, metric, norms=None, tile_rows=16384,
                  use_bf16=True, approx=False, num_valid=None):
        """Rotation is orthogonal → rotate queries once, then the fused PQ
        scan in rotated space gives exact L2/IP/NIP ranking."""
        from vq_tpu.kernels.adc import scan_codes_topk

        qr = jnp.dot(jnp.asarray(queries, dtype=jnp.float32), self.params.rotation,
                     precision=jax.lax.Precision.HIGHEST)
        return scan_codes_topk(
            qr, codes, self.params.codebooks, k, metric, norms, tile_rows,
            use_bf16, approx=approx, num_valid=num_valid,
        )

    def code_bytes_per_vector(self) -> float:
        bytes_per_code = 1 if self.cfg.num_bits <= 8 else 2
        return float(self.cfg.num_subquantizers * bytes_per_code)

    def config_dict(self):
        return {
            "M": self.cfg.num_subquantizers,
            "B": self.cfg.num_bits,
            "opq_iters": self.cfg.opq_iters,
        }
