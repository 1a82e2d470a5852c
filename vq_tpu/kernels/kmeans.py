"""Batched Lloyd k-means.

Replaces every place the reference calls faiss k-means: PQ subquantizer
training (reference methods/product_quantization.py:67-68), IVF coarse
quantizers (methods/search/ivf_quantized_index.py:45-84,
methods/search/saq_index.py:14-23), and the SAQ engine's preprocessing
(external/saq/src/preprocessing/kmeans_faiss.cpp).

Design (SURVEY.md §7.1): assignment is a matmul-argmin
(‖x‖² − 2x·c + ‖c‖²), the centroid update is a one-hot ⊤-matmul
segment-sum — both tile straight onto the 128×128 systolic array.  The
whole Lloyd loop is a `lax.fori_loop` under one `jit`; k-means++ init is a
`lax.scan` using the Gumbel-max trick for the D² sampling.  `vmap` over a
leading axis trains all M PQ subquantizers simultaneously.
"""

from __future__ import annotations

import functools
from typing import Tuple

import jax
import jax.numpy as jnp

from vq_tpu.core.config import KMeansConfig


def pairwise_sqdist_xc(x: jax.Array, c: jax.Array) -> jax.Array:
    """Squared euclidean distances (n, d) × (k, d) → (n, k), as one matmul."""
    x2 = jnp.sum(x * x, axis=-1, keepdims=True)
    c2 = jnp.sum(c * c, axis=-1)
    xc = jnp.dot(x, c.T, preferred_element_type=jnp.float32,
        precision=jax.lax.Precision.HIGHEST)
    return x2 - 2.0 * xc + c2[None, :]


def _kmeanspp_init(key: jax.Array, x: jax.Array, k: int) -> jax.Array:
    """k-means++ seeding via Gumbel-max sampling of the D² distribution."""
    n = x.shape[0]
    key0, key_scan = jax.random.split(key)
    first = jax.random.randint(key0, (), 0, n)
    c0 = x[first]

    def step(carry, step_key):
        min_d2, prev_c = carry
        d2 = jnp.sum((x - prev_c[None, :]) ** 2, axis=-1)
        min_d2 = jnp.minimum(min_d2, d2)
        # sample index w.p. ∝ min_d2 : argmax(log d2 + Gumbel)
        g = jax.random.gumbel(step_key, (n,))
        logits = jnp.where(min_d2 > 0, jnp.log(min_d2 + 1e-30), -jnp.inf) + g
        idx = jnp.argmax(logits)
        c = x[idx]
        return (min_d2, c), c

    keys = jax.random.split(key_scan, k - 1)
    init = (jnp.full((n,), jnp.inf, dtype=jnp.float32), c0)
    _, rest = jax.lax.scan(step, init, keys)
    return jnp.concatenate([c0[None, :], rest], axis=0)


def _random_init(key: jax.Array, x: jax.Array, k: int) -> jax.Array:
    idx = jax.random.choice(key, x.shape[0], (k,), replace=False)
    return x[idx]


def _lloyd_iter(x: jax.Array, centroids: jax.Array) -> jax.Array:
    """One Lloyd iteration: assign + one-hot-matmul update.

    Empty clusters keep their previous centroid (deterministic; the
    reference relies on faiss's split heuristic — recall parity holds
    without it on the embedding datasets).

    Large n·k tiles over rows: the (n, k) one-hot/distance intermediates
    would otherwise materialize (16 GB at n=1M, k=4096 — the IVF coarse
    flagship geometry); partial (k, d) sums and (k,) counts accumulate
    across row tiles instead.
    """
    k = centroids.shape[0]
    n, d = x.shape

    def tile_stats(xt, valid):
        d2 = pairwise_sqdist_xc(xt, centroids)
        assignments = jnp.argmin(d2, axis=-1)
        onehot = jax.nn.one_hot(assignments, k, dtype=jnp.float32)
        onehot = onehot * valid[:, None]
        counts = jnp.sum(onehot, axis=0)  # (k,)
        sums = jnp.dot(onehot.T, xt, preferred_element_type=jnp.float32,
            precision=jax.lax.Precision.HIGHEST)  # (k, d)
        return sums, counts

    if n * k <= (1 << 27):
        sums, counts = tile_stats(x, jnp.ones((n,), jnp.float32))
    else:
        row_tile = max(8192, (1 << 27) // k)
        nt = -(-n // row_tile)

        def body(t, carry):
            acc_s, acc_c = carry
            start = jnp.minimum(t * row_tile, max(n - row_tile, 0))
            xt = jax.lax.dynamic_slice_in_dim(x, start, row_tile, 0)
            gid = start + jnp.arange(row_tile)
            # the last tile's clamped start re-reads rows of the previous
            # tile; count only rows this tile owns
            valid = ((gid >= t * row_tile) & (gid < n)).astype(jnp.float32)
            s, c = tile_stats(xt, valid)
            return acc_s + s, acc_c + c

        sums, counts = jax.lax.fori_loop(
            0, nt, body,
            (jnp.zeros((k, d), jnp.float32), jnp.zeros((k,), jnp.float32)),
        )
    new_c = sums / jnp.maximum(counts, 1.0)[:, None]
    return jnp.where((counts > 0)[:, None], new_c, centroids)


@functools.partial(jax.jit, static_argnames=("k", "cfg"))
def _kmeans_impl(key: jax.Array, x: jax.Array, k: int, cfg: KMeansConfig) -> jax.Array:
    x = x.astype(jnp.float32)
    # "auto": k-means++ seeding reads the whole training set once per
    # centroid (a k-step sequential scan — prohibitive at IVF-coarse K,
    # e.g. 4096 × 6 GB of HBM traffic at 1M rows); beyond 1024 centroids
    # fall back to random-row init, which is also faiss's default
    # (the reference's coarse quantizer, saq_index.py:14-23).
    init = cfg.init
    if init == "auto":
        init = "kmeanspp" if k <= 1024 else "random"
    if init == "kmeanspp":
        c0 = _kmeanspp_init(key, x, k)
    else:
        c0 = _random_init(key, x, k)
    return jax.lax.fori_loop(
        0, cfg.iters, lambda _, c: _lloyd_iter(x, c), c0
    )


def _subsample(key: jax.Array, x: jax.Array, cap: int) -> jax.Array:
    n = x.shape[0]
    if n <= cap:
        return x
    idx = jax.random.choice(key, n, (cap,), replace=False)
    return x[idx]


def kmeans(
    key: jax.Array,
    x: jax.Array,
    k: int,
    cfg: KMeansConfig = KMeansConfig(),
) -> jax.Array:
    """Train k centroids on (n, d) data. Returns (k, d) float32.

    Training data is subsampled to `max_points_per_centroid * k` rows,
    faiss-style, so fit cost is independent of corpus size.
    """
    key_sub, key_fit = jax.random.split(jax.random.PRNGKey(cfg.seed) if key is None else key)
    x = _subsample(key_sub, x, cfg.max_points_per_centroid * k)
    return _kmeans_impl(key_fit, x, k, cfg)


def kmeans_batched(
    key: jax.Array,
    xs: jax.Array,
    k: int,
    cfg: KMeansConfig = KMeansConfig(),
) -> jax.Array:
    """Train M independent k-means problems at once: (M, n, d) → (M, k, d).

    This is how all PQ subquantizers train in one compiled program — the
    Batched replacement for faiss's per-subspace sequential training
    loop (reference methods/product_quantization.py:67-68).
    """
    m = xs.shape[0]
    key_sub, key_fit = jax.random.split(key)
    cap = cfg.max_points_per_centroid * k
    if xs.shape[1] > cap:
        idx = jax.random.choice(key_sub, xs.shape[1], (cap,), replace=False)
        xs = xs[:, idx, :]
    keys = jax.random.split(key_fit, m)
    return jax.vmap(lambda kk, xx: _kmeans_impl(kk, xx, k, cfg))(keys, xs)


@functools.partial(jax.jit, static_argnames=("tile",))
def assign(x: jax.Array, centroids: jax.Array, tile: int = 16384) -> jax.Array:
    """Nearest-centroid assignment for all rows, tiled over n.

    (n, d) × (k, d) → (n,) int32.  Tiling bounds the transient distance
    matrix to (tile, k) regardless of corpus size (the reference's 53M
    OOM-guard chunking, scalar_quantization.py:41-50, done the XLA way).
    """
    n = x.shape[0]
    x = x.astype(jnp.float32)
    n_pad = (-n) % tile
    xp = jnp.pad(x, ((0, n_pad), (0, 0)))
    xt = xp.reshape(-1, tile, x.shape[1])

    def body(xtile):
        return jnp.argmin(pairwise_sqdist_xc(xtile, centroids), axis=-1)

    out = jax.lax.map(body, xt).reshape(-1)
    return out[:n].astype(jnp.int32)


def assign_batched(xs: jax.Array, centroids: jax.Array, tile: int = 16384) -> jax.Array:
    """(M, n, d) × (M, k, d) → (M, n) int32 — all PQ subspaces at once."""
    return jax.vmap(lambda x, c: assign(x, c, tile=tile))(xs, centroids)
