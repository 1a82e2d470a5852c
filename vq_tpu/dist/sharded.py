"""Sharded search and training steps over a device mesh.

The replacement for the reference's scale-out story (SURVEY.md §2.3): the
compressed corpus is row-sharded across devices (`P("data", None)`),
codebooks and queries are replicated, each device runs the same fused ADC
scan over its shard, and the per-shard top-k candidates are merged with an
all-gather + final top-k (exact merge: k candidates per shard ⊇ global
top-k).  Metric reductions (e.g. Lloyd sums) ride `psum`.
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import jax
import jax.numpy as jnp

from jax import shard_map as _shard_map
from jax.sharding import Mesh, PartitionSpec as P

from vq_tpu.core.config import Metric
from vq_tpu.dist.mesh import DATA_AXIS
from vq_tpu.kernels.adc import exact_topk, scan_codes_topk


def shard_map(f, mesh, in_specs, out_specs):
    # check_vma=False: the streaming-top-k fori_loop carry starts as a
    # replicated constant but becomes shard-varying, which the varying-
    # manual-axes checker rejects.
    return _shard_map(
        f, mesh=mesh, in_specs=in_specs, out_specs=out_specs, check_vma=False
    )


def _merge_local_topk(
    scores: jax.Array, idx: jax.Array, k: int, metric: Metric
) -> Tuple[jax.Array, jax.Array]:
    """All-gather per-shard (Q, k) candidates and take the global top-k."""
    maximize = scores if metric != Metric.L2 else -scores
    s_all = jax.lax.all_gather(maximize, DATA_AXIS, axis=1, tiled=True)  # (Q, P*k)
    i_all = jax.lax.all_gather(idx, DATA_AXIS, axis=1, tiled=True)
    ms, mi = jax.lax.top_k(s_all, k)
    out_i = jnp.take_along_axis(i_all, mi, axis=-1)
    out_s = ms if metric != Metric.L2 else -ms
    return out_s, out_i


def _sharded_scan(
    mesh: Mesh,
    queries: jax.Array,
    codes: jax.Array,
    norms: Optional[jax.Array],
    scan_fn,
    k: int,
    metric: Metric,
    true_n: Optional[int],
    overlap_chunks: int,
    extra_args: Tuple[jax.Array, ...] = (),
    extra_specs: Tuple = (),
) -> Tuple[jax.Array, jax.Array]:
    """Shared machinery for row-sharded scans with cross-chip top-k merge.

    scan_fn(q, codes_c, norms_c, num_valid, *extra) → maximize-or-natural
    (scores, local ids) over one chunk of the local shard; `extra_args`
    are replicated inputs (e.g. PQ codebooks) threaded through shard_map
    so large arrays are arguments, not constants baked into the compiled
    program.
    """
    n_pad = codes.shape[0]
    true_n = true_n if true_n is not None else n_pad
    has_norms = norms is not None
    if metric == Metric.NIP and not has_norms:
        raise ValueError("Metric.NIP requires norms")
    n_local_g = n_pad // mesh.devices.size
    chunks = max(1, min(overlap_chunks, n_local_g))
    while n_local_g % chunks:
        chunks -= 1

    def local(q, codes_l, norms_l, *extra):
        shard = jax.lax.axis_index(DATA_AXIS)
        n_local = codes_l.shape[0]

        def scan_rows(codes_c, norms_c, row0):
            # pad rows live at the global tail → mask inside the local scan
            # so they never occupy candidate slots
            nv = jnp.clip(true_n - shard * n_local - row0, 0,
                          codes_c.shape[0])
            s, i = scan_fn(
                q, codes_c, norms_c if has_norms else None, nv, *extra
            )
            gid = i + shard * n_local + row0
            bad = gid >= true_n
            s = jnp.where(bad, jnp.inf if metric == Metric.L2 else -jnp.inf, s)
            return s, gid

        if chunks == 1:
            s, gid = scan_rows(codes_l, norms_l, 0)
            return _merge_local_topk(s, gid, k, metric)

        csz = n_local // chunks
        num_q = q.shape[0]

        def step(carry, c):
            run_s, run_i = carry  # maximize-form, replicated-merged so far
            row0 = c * csz
            s, gid = scan_rows(
                jax.lax.dynamic_slice_in_dim(codes_l, row0, csz, axis=0),
                jax.lax.dynamic_slice_in_dim(norms_l, row0, csz, axis=0),
                row0,
            )
            smax = s if metric != Metric.L2 else -s
            g_s = jax.lax.all_gather(smax, DATA_AXIS, axis=1, tiled=True)
            g_i = jax.lax.all_gather(gid, DATA_AXIS, axis=1, tiled=True)
            cat_s = jnp.concatenate([run_s, g_s], axis=1)
            cat_i = jnp.concatenate([run_i, g_i], axis=1)
            ms, mi = jax.lax.top_k(cat_s, k)
            return (ms, jnp.take_along_axis(cat_i, mi, axis=-1)), None

        init = (
            jnp.full((num_q, k), -jnp.inf, jnp.float32),
            jnp.zeros((num_q, k), jnp.int32),
        )
        (ms, mi), _ = jax.lax.scan(step, init, jnp.arange(chunks))
        return (ms if metric != Metric.L2 else -ms), mi

    if not has_norms:
        norms = jnp.ones((n_pad,), dtype=jnp.float32)

    code_spec = P(DATA_AXIS, *([None] * (codes.ndim - 1)))
    fn = shard_map(
        local,
        mesh=mesh,
        in_specs=(P(None, None), code_spec, P(DATA_AXIS)) + tuple(extra_specs),
        out_specs=(P(None, None), P(None, None)),
    )
    return jax.jit(fn)(queries, codes, norms, *extra_args)


def sharded_scan_topk(
    mesh: Mesh,
    queries: jax.Array,
    codes: jax.Array,
    codebooks: jax.Array,
    k: int,
    metric: Metric = Metric.L2,
    norms: Optional[jax.Array] = None,
    true_n: Optional[int] = None,
    tile_rows: int = 2048,
    use_bf16: bool = True,
    overlap_chunks: int = 1,
) -> Tuple[jax.Array, jax.Array]:
    """ADC search over a row-sharded PQ corpus with cross-chip top-k merge.

    codes (N_pad, M) must be row-sharded with N_pad divisible by the mesh;
    `true_n` masks the pad rows (global ids ≥ true_n never surface).
    Returns replicated (Q, k) scores/ids with GLOBAL row ids.

    overlap_chunks > 1 overlaps the cross-shard merge with the scan
    (SURVEY.md §5 long-context row): the local shard is scanned in C
    chunks inside a lax.scan, each chunk's (Q, k) local top-k is
    all_gather-merged into the running result, and because chunk c+1's
    scan does not depend on chunk c's merge, XLA's async collectives hide
    each tiny (Q, P·k) gather behind the next chunk's scan — instead
    of one all_gather serialized after the entire local scan.  Exact:
    every chunk's candidates pass through the merge.
    """

    def scan_fn(q, codes_c, norms_c, nv, cb):
        return scan_codes_topk(
            q, codes_c, cb, k, metric=metric, norms=norms_c,
            tile_rows=tile_rows, use_bf16=use_bf16, num_valid=nv,
        )

    return _sharded_scan(
        mesh, queries, codes, norms, scan_fn, k, metric, true_n,
        overlap_chunks, extra_args=(codebooks,),
        extra_specs=(P(*([None] * codebooks.ndim)),),
    )


def sharded_generic_scan_topk(
    mesh: Mesh,
    queries: jax.Array,
    codes: jax.Array,
    decode_fn,
    k: int,
    metric: Metric = Metric.L2,
    norms: Optional[jax.Array] = None,
    true_n: Optional[int] = None,
    tile_rows: int = 4096,
    use_bf16: bool = True,
    overlap_chunks: int = 1,
) -> Tuple[jax.Array, jax.Array]:
    """Row-sharded fused decode→score→top-k scan for ANY quantizer.

    The generic-method analog of sharded_scan_topk: each shard runs
    kernels/adc.scan_generic_topk over its rows with the method's
    jax-traceable `decode_fn` (methods/base.BaseQuantizer contract), and
    per-shard candidates merge exactly across the mesh (optionally
    overlapped, see sharded_scan_topk).  Quantizer params ride inside
    decode_fn's closure — fine for the rotation/level tables of the
    scalar methods; PQ's big codebooks use the specialised path above.
    """
    from vq_tpu.kernels.adc import scan_generic_topk

    def scan_fn(q, codes_c, norms_c, nv):
        return scan_generic_topk(
            q, codes_c, decode_fn, k, metric=metric, norms=norms_c,
            tile_rows=tile_rows, use_bf16=use_bf16, num_valid=nv,
        )

    return _sharded_scan(
        mesh, queries, codes, norms, scan_fn, k, metric, true_n,
        overlap_chunks,
    )


def sharded_exact_topk(
    mesh: Mesh,
    queries: jax.Array,
    x: jax.Array,
    k: int,
    metric: Metric = Metric.L2,
    true_n: Optional[int] = None,
    tile_rows: int = 8192,
) -> Tuple[jax.Array, jax.Array]:
    """Exact brute-force top-k over a row-sharded raw corpus (multi-chip GT)."""
    n_pad = x.shape[0]
    true_n = true_n if true_n is not None else n_pad

    def local(q, x_l):
        shard = jax.lax.axis_index(DATA_AXIS)
        n_local = x_l.shape[0]
        nv = jnp.clip(true_n - shard * n_local, 0, n_local)
        s, i = exact_topk(q, x_l, k, metric=metric, tile_rows=tile_rows, num_valid=nv)
        gid = i + shard * n_local
        bad = gid >= true_n
        s = jnp.where(bad, jnp.inf if metric == Metric.L2 else -jnp.inf, s)
        return _merge_local_topk(s, gid, k, metric)

    fn = shard_map(
        local,
        mesh=mesh,
        in_specs=(P(None, None), P(DATA_AXIS, None)),
        out_specs=(P(None, None), P(None, None)),
    )
    return jax.jit(fn)(queries, x)


def dp_lloyd_step(
    mesh: Mesh, x: jax.Array, centroids: jax.Array
) -> jax.Array:
    """One data-parallel Lloyd iteration over a row-sharded training set.

    Each chip computes partial one-hot sums/counts for its rows; `psum` over
    ICI merges them — the distributed form of kernels/kmeans._lloyd_iter and
    the training step the multichip dryrun compiles.
    """
    kk = centroids.shape[0]

    def local(x_l, c):
        from vq_tpu.kernels.kmeans import pairwise_sqdist_xc

        a = jnp.argmin(pairwise_sqdist_xc(x_l, c), axis=-1)
        onehot = jax.nn.one_hot(a, kk, dtype=jnp.float32)
        sums = jnp.dot(onehot.T, x_l, preferred_element_type=jnp.float32,
                       precision=jax.lax.Precision.HIGHEST)
        counts = jnp.sum(onehot, axis=0)
        sums = jax.lax.psum(sums, DATA_AXIS)
        counts = jax.lax.psum(counts, DATA_AXIS)
        new_c = sums / jnp.maximum(counts, 1.0)[:, None]
        return jnp.where((counts > 0)[:, None], new_c, c)

    fn = shard_map(
        local,
        mesh=mesh,
        in_specs=(P(DATA_AXIS, None), P(None, None)),
        out_specs=P(None, None),
    )
    return jax.jit(fn)(x, centroids)
