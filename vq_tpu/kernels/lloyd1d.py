"""1-D scalar codebook builders (Lloyd on sorted samples), in XLA.

Replaces the reference's 1-D codebook machinery: `_lloyd_1d_normal`
(methods/extended_rabitq.py:6-44, rank_aware_quantization.py) and the SAQ
engine's `build_codebook_lloyd` / per-dim parallel variants
(external/saq/include/saq/preprocessing/codebook_builder.h:44-84).

The trick: with SORTED samples and sorted levels, Lloyd assignment
boundaries are midpoints, so per-bin sums/counts are differences of prefix
sums at `searchsorted` cut points — O(n log L) per iteration with no
scatter, fully vectorized, `vmap`-able over many independent columns (every
dimension's codebook trains simultaneously — the engine's OpenMP
parallel-for over dims, done as one XLA program).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp


@functools.partial(jax.jit, static_argnames=("num_levels", "iters"))
def lloyd_1d_sorted(
    sorted_samples: jax.Array, num_levels: int, iters: int = 60
) -> jax.Array:
    """Lloyd-optimal scalar codebook for one column of SORTED samples.

    Returns sorted (num_levels,) float32 levels.  Quantile init (the
    reference's choice, extended_rabitq.py:20-23) keeps it deterministic.
    """
    s = sorted_samples.astype(jnp.float32)
    n = s.shape[0]
    csum = jnp.concatenate([jnp.zeros(1, jnp.float32), jnp.cumsum(s)])

    # quantile init: value at rank (j + .5)/L
    ranks = ((jnp.arange(num_levels) + 0.5) / num_levels * n).astype(jnp.int32)
    levels0 = s[jnp.clip(ranks, 0, n - 1)]

    def body(_, levels):
        bounds = 0.5 * (levels[:-1] + levels[1:])
        # cut[j] = #samples < bounds[j]; bins are [cut[j-1], cut[j])
        cut = jnp.searchsorted(s, bounds)
        lo = jnp.concatenate([jnp.zeros(1, cut.dtype), cut])
        hi = jnp.concatenate([cut, jnp.full(1, n, cut.dtype)])
        counts = (hi - lo).astype(jnp.float32)
        sums = csum[hi] - csum[lo]
        new = jnp.where(counts > 0, sums / jnp.maximum(counts, 1.0), levels)
        return jnp.sort(new)

    return jax.lax.fori_loop(0, iters, body, levels0)


def lloyd_1d(samples: jax.Array, num_levels: int, iters: int = 60) -> jax.Array:
    """Lloyd codebook for one unsorted sample column."""
    return lloyd_1d_sorted(jnp.sort(samples), num_levels, iters)


def lloyd_1d_normal(
    num_levels: int, seed: int = 0, n_samples: int = 200_000, iters: int = 100
) -> jax.Array:
    """Gaussian-optimal scalar codebook (reference _lloyd_1d_normal,
    extended_rabitq.py:6-44): Lloyd on a seeded N(0,1) sample."""
    samples = jax.random.normal(jax.random.PRNGKey(seed), (n_samples,))
    return lloyd_1d(samples, num_levels, iters)


def lloyd_1d_columns(x: jax.Array, num_levels: int, iters: int = 60) -> jax.Array:
    """Per-dimension codebooks for all columns at once: (n, D) → (D, L).

    The vectorized equivalent of the SAQ engine's `build_all_dims` OpenMP loop
    (codebook_builder.h:70-78)."""
    xs = jnp.sort(x, axis=0).T  # (D, n) sorted per column
    return jax.vmap(lambda col: lloyd_1d_sorted(col, num_levels, iters))(xs)


def quantize_to_levels(x: jax.Array, levels: jax.Array) -> jax.Array:
    """Nearest-level index via midpoint boundaries (levels sorted).

    x (...,), levels (L,) → int32 indices (...,).
    """
    bounds = 0.5 * (levels[:-1] + levels[1:])
    return jnp.searchsorted(bounds, x).astype(jnp.int32)


def quantize_to_levels_per_dim(x: jax.Array, levels: jax.Array) -> jax.Array:
    """Per-dimension codebooks: x (n, D), levels (D, L) → (n, D) int32."""
    return jax.vmap(lambda col, lv: quantize_to_levels(col, lv), in_axes=(1, 0), out_axes=1)(
        x, levels
    )
