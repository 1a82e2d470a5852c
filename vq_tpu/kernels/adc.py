"""ADC (asymmetric distance) scan + streaming top-k.

The reference's hot search path is an AVX-512 vpshufb 16-way LUT fastscan
(external/saq/include/saq/fast_scan.h:73-110) — gather-bound even on CPU
(reference bench/ffd_speed.cpp:10-16).  Here the scan is written as matrix
products (SURVEY.md §7.3), using the identity

    adc_l2(q, codes) = ‖q − x̂‖²   with   x̂ = decode(codes),

i.e. the ADC scan IS the exact scan over reconstructions.  Per tile of rows
we (1) decode codes → x̂ by gathering codebook rows, (2) score q·x̂ᵀ with one
matmul (bf16 in / f32 accumulate), (3) fold the tile into a running top-k.

All entry points are jit-compiled with static tile sizes; the same code runs
on the CPU (tests), one GPU, and under shard_map across a mesh
(vq_tpu/dist/).
"""

from __future__ import annotations

import functools
from typing import Callable, Optional, Tuple

import jax
import jax.numpy as jnp

from vq_tpu.core.config import Metric


def _bf16_supported() -> bool:
    """CPU XLA can't do bf16×bf16→f32 dots; use f32 there so the same call
    sites run on the accelerator (bf16 path) and in CPU tests."""
    return jax.default_backend() != "cpu"


def pairwise_sqdist(a: jax.Array, b: jax.Array) -> jax.Array:
    """(n, d) × (m, d) → (n, m) squared L2, via the matmul expansion."""
    a2 = jnp.sum(a * a, axis=-1, keepdims=True)
    b2 = jnp.sum(b * b, axis=-1)
    ab = jnp.dot(a, b.T, preferred_element_type=jnp.float32,
        precision=jax.lax.Precision.HIGHEST)
    return a2 - 2.0 * ab + b2[None, :]


def decode_pq(codebooks: jax.Array, codes: jax.Array) -> jax.Array:
    """Decode PQ codes: (M, K, dsub) × (n, M) → (n, M*dsub).

    A gather of codebook rows: dec[t, m] = codebooks[m, codes[t, m]].  The
    scan decodes its tiles with this same function, so decode and scan are
    numerically identical.
    """
    m, _, dsub = codebooks.shape
    dec = codebooks[jnp.arange(m)[None, :], codes.astype(jnp.int32)]
    return dec.reshape(codes.shape[0], m * dsub)


def build_lut(codebooks: jax.Array, queries: jax.Array, metric: Metric = Metric.L2) -> jax.Array:
    """Per-query distance lookup tables: (M, K, dsub) × (Q, D) → (Q, M, K).

    Parity with the reference's Lut::prepare (external/saq/src/lut.cpp);
    used for diagnostics; the scan decodes rows and scores them with one
    matmul instead.
    """
    m, k, dsub = codebooks.shape
    q = queries.reshape(queries.shape[0], m, dsub).astype(jnp.float32)
    ip = jnp.einsum("qmd,mkd->qmk", q, codebooks, preferred_element_type=jnp.float32,
        precision=jax.lax.Precision.HIGHEST)
    if metric == Metric.L2:
        q2 = jnp.sum(q * q, axis=-1, keepdims=True)  # (Q, M, 1)
        c2 = jnp.sum(codebooks * codebooks, axis=-1)  # (M, K)
        return q2 - 2.0 * ip + c2[None, :, :]
    return ip


def _streaming_topk(
    score_tile_fn: Callable[[jax.Array], jax.Array],
    n: int,
    num_queries: int,
    k: int,
    tile: int,
    approx: bool = False,
) -> Tuple[jax.Array, jax.Array]:
    """Fold per-tile scores (maximize) into a running (Q, k) top-k.

    score_tile_fn(start) must return (Q, tile) f32 scores with padded /
    out-of-range columns already set to -inf.

    Per-tile candidate selection is exact `top_k` by default; with
    approx=True it uses `lax.approx_max_k` (recall_target 0.99; XLA lowers
    it to an exact top-k off the platforms with a partial-reduction
    top-k); the cross-tile merge is always exact.  Tiles are unrolled as a Python loop (few, large tiles)
    so XLA can overlap decode/score/top-k across tiles.
    """
    n_tiles = -(-n // tile)
    k = min(k, n)

    def tile_topk(t):
        start = t * tile
        s = score_tile_fn(start)
        if approx and s.shape[-1] >= 512:
            ts, ti = jax.lax.approx_max_k(s, k, recall_target=0.99)
        else:
            ts, ti = jax.lax.top_k(s, k)
        return ts, ti.astype(jnp.int32) + start

    if n_tiles == 1:
        return tile_topk(0)

    if n_tiles <= 32:  # unroll: XLA overlaps decode/score/top-k across tiles
        parts = [tile_topk(t) for t in range(n_tiles)]
        cs = jnp.concatenate([p[0] for p in parts], axis=-1)
        ci = jnp.concatenate([p[1] for p in parts], axis=-1)
        ms, mi = jax.lax.top_k(cs, k)
        return ms, jnp.take_along_axis(ci, mi, axis=-1)

    # many tiles (large corpora): rolled loop with running merge keeps
    # compile time and memory bounded
    init = (
        jnp.full((num_queries, k), -jnp.inf, dtype=jnp.float32),
        jnp.zeros((num_queries, k), dtype=jnp.int32),
    )

    def body(t, carry):
        best_s, best_i = carry
        ts, ti = tile_topk(t)
        cs = jnp.concatenate([best_s, ts], axis=-1)
        ci = jnp.concatenate([best_i, ti], axis=-1)
        ms, mi = jax.lax.top_k(cs, k)
        return ms, jnp.take_along_axis(ci, mi, axis=-1)

    return jax.lax.fori_loop(0, n_tiles, body, init)


def _finalize(
    scores: jax.Array, idx: jax.Array, metric: Metric, q_sq: Optional[jax.Array]
) -> Tuple[jax.Array, jax.Array]:
    """Convert internal maximize-scores back to the metric's natural value."""
    if metric == Metric.L2:
        return q_sq[:, None] - scores, idx  # ‖q‖² − (2·ip − ‖x̂‖²)
    return scores, idx


@functools.partial(
    jax.jit, static_argnames=("k", "metric", "tile_rows", "use_bf16", "approx")
)
def scan_codes_topk(
    queries: jax.Array,
    codes: jax.Array,
    codebooks: jax.Array,
    k: int,
    metric: Metric = Metric.L2,
    norms: Optional[jax.Array] = None,
    tile_rows: int = 16384,
    use_bf16: bool = True,
    num_valid: Optional[jax.Array] = None,
    approx: bool = False,
) -> Tuple[jax.Array, jax.Array]:
    """Fused ADC scan over a PQ-coded corpus with streaming top-k.

    queries   (Q, D) f32
    codes     (N, M) integer PQ codes
    codebooks (M, K, dsub) f32
    norms     (N,) original row ‖x‖ — required for Metric.NIP (the study
              pipeline's q·x̂/‖x‖ convention, reference
              benchmarks/exact_search.py:4-8)
    num_valid — optional traced scalar: rows with index ≥ num_valid are
              masked out (used by the sharded path where pad rows land in
              the last shard; static n handles whole-array padding).
    returns   (scores (Q, k), indices (Q, k)); scores are squared L2
              distances for L2 (ascending), inner products otherwise
              (descending).
    """
    n = codes.shape[0]
    num_q = queries.shape[0]
    tile = min(tile_rows, max(8, n))
    use_bf16 = use_bf16 and _bf16_supported()

    queries = queries.astype(jnp.float32)
    q_sq = jnp.sum(queries * queries, axis=-1)
    dtype = jnp.bfloat16 if use_bf16 else jnp.float32
    # bf16 path: bf16 operands with f32 accumulation.  f32 path: force
    # HIGHEST, or the matmul may run in reduced precision (TF32 on the GPU).
    prec = jax.lax.Precision.DEFAULT if use_bf16 else jax.lax.Precision.HIGHEST
    qd = queries.astype(dtype)
    cb = codebooks.astype(dtype)

    n_pad = (-n) % tile
    codes_p = jnp.pad(codes, ((0, n_pad), (0, 0)))
    norms_p = None
    if metric == Metric.NIP:
        if norms is None:
            raise ValueError("Metric.NIP requires original row norms")
        norms_p = jnp.pad(norms.astype(jnp.float32), (0, n_pad), constant_values=1.0)

    def score_tile(start):
        ct = jax.lax.dynamic_slice_in_dim(codes_p, start, tile, axis=0)
        dec = decode_pq(cb, ct).astype(jnp.float32)
        ip = jnp.dot(
            qd, dec.astype(dtype).T, preferred_element_type=jnp.float32,
            precision=prec,
        )  # (Q, T)
        if metric == Metric.L2:
            recon_sq = jnp.sum(dec * dec, axis=-1)
            s = 2.0 * ip - recon_sq[None, :]
        elif metric == Metric.IP:
            s = ip
        else:  # NIP
            nt = jax.lax.dynamic_slice_in_dim(norms_p, start, tile, axis=0)
            s = ip / jnp.maximum(nt, 1e-30)[None, :]
        col = start + jax.lax.broadcasted_iota(jnp.int32, (1, tile), 1)
        limit = n if num_valid is None else jnp.minimum(n, num_valid)
        return jnp.where(col < limit, s, -jnp.inf)

    scores, idx = _streaming_topk(score_tile, n, num_q, k, tile, approx=approx)
    return _finalize(scores, idx, metric, q_sq)


def scan_generic_topk(
    queries: jax.Array,
    codes: jax.Array,
    decode_fn: Callable[[jax.Array], jax.Array],
    k: int,
    metric: Metric = Metric.L2,
    norms: Optional[jax.Array] = None,
    tile_rows: int = 16384,
    use_bf16: bool = True,
    num_valid: Optional[jax.Array] = None,
    approx: bool = False,
) -> Tuple[jax.Array, jax.Array]:
    """Fused decode→score→top-k scan for any quantizer.

    `decode_fn(codes_tile) → (T, D)` must be jax-traceable.  This is the
    generic path behind FlatQuantizedIndex for non-PQ methods; PQ uses the
    specialised `scan_codes_topk`.  Same streaming-top-k core, so all
    methods share one search implementation (vs the reference's three
    redundant brute-force recall paths, SURVEY.md §3.1).
    """
    n = codes.shape[0]
    num_q = queries.shape[0]
    tile = min(tile_rows, max(8, n))
    use_bf16 = use_bf16 and _bf16_supported()
    queries = jnp.asarray(queries, dtype=jnp.float32)
    q_sq = jnp.sum(queries * queries, axis=-1)
    dtype = jnp.bfloat16 if use_bf16 else jnp.float32
    qd = queries.astype(dtype)

    n_pad = (-n) % tile
    codes_p = jnp.pad(codes, ((0, n_pad),) + ((0, 0),) * (codes.ndim - 1))
    norms_p = None
    if metric == Metric.NIP:
        if norms is None:
            raise ValueError("Metric.NIP requires original row norms")
        norms_p = jnp.pad(norms.astype(jnp.float32), (0, n_pad), constant_values=1.0)

    def score_tile(start):
        ct = jax.lax.dynamic_slice_in_dim(codes_p, start, tile, axis=0)
        dec = decode_fn(ct).astype(jnp.float32)
        ip = jnp.dot(qd, dec.astype(dtype).T, preferred_element_type=jnp.float32,
        precision=jax.lax.Precision.HIGHEST)
        if metric == Metric.L2:
            s = 2.0 * ip - jnp.sum(dec * dec, axis=-1)[None, :]
        elif metric == Metric.IP:
            s = ip
        else:
            nt = jax.lax.dynamic_slice_in_dim(norms_p, start, tile, axis=0)
            s = ip / jnp.maximum(nt, 1e-30)[None, :]
        col = start + jax.lax.broadcasted_iota(jnp.int32, (1, tile), 1)
        limit = n if num_valid is None else jnp.minimum(n, num_valid)
        return jnp.where(col < limit, s, -jnp.inf)

    scores, idx = _streaming_topk(score_tile, n, num_q, k, tile, approx=approx)
    return _finalize(scores, idx, metric, q_sq)


@functools.partial(jax.jit, static_argnames=("k", "metric", "tile_rows"))
def exact_topk(
    queries: jax.Array,
    x: jax.Array,
    k: int,
    metric: Metric = Metric.L2,
    norms: Optional[jax.Array] = None,
    tile_rows: int = 8192,
    num_valid: Optional[jax.Array] = None,
) -> Tuple[jax.Array, jax.Array]:
    """Exact brute-force top-k over raw (or reconstructed) vectors.

    Used for ground-truth precompute (reference
    benchmarks/precompute_ground_truth.py:14-129, data/datasets.py:8-34) and
    the study pipeline's exact normalized-IP search
    (benchmarks/exact_search.py:32-77) — one implementation for all three
    of the reference's redundant recall paths (SURVEY.md §3.1).
    """
    n = x.shape[0]
    num_q = queries.shape[0]
    tile = min(tile_rows, max(8, n))
    queries = queries.astype(jnp.float32)
    q_sq = jnp.sum(queries * queries, axis=-1)

    # No pad copy: a ragged tail would force jnp.pad to copy the whole f32
    # corpus (12 GB transient at N=1M, D=1536).  Instead the last tile's
    # slice start is clamped in-bounds (dynamic_slice clamps anyway; we
    # clamp explicitly so column ids stay correct) and the rows it re-reads
    # from the previous tile are masked out.
    xp = x.astype(jnp.float32)
    if n < tile:  # tiny corpora only
        xp = jnp.pad(xp, ((0, tile - n), (0, 0)))
    norms_p = None
    if metric == Metric.NIP:
        nn = jnp.linalg.norm(x.astype(jnp.float32), axis=-1) if norms is None else norms
        norms_p = jnp.pad(
            nn.astype(jnp.float32), (0, xp.shape[0] - n), constant_values=1.0
        )

    def score_tile(start):
        st = jnp.minimum(start, xp.shape[0] - tile)
        xt = jax.lax.dynamic_slice_in_dim(xp, st, tile, axis=0)
        ip = jnp.dot(queries, xt.T, preferred_element_type=jnp.float32,
        precision=jax.lax.Precision.HIGHEST)
        if metric == Metric.L2:
            s = 2.0 * ip - jnp.sum(xt * xt, axis=-1)[None, :]
        elif metric == Metric.IP:
            s = ip
        else:
            nt = jax.lax.dynamic_slice_in_dim(norms_p, st, tile, axis=0)
            s = ip / jnp.maximum(nt, 1e-30)[None, :]
        # realign so position j holds row id start+j (the contract
        # _streaming_topk's `ti + start` assumes): the clamped slice holds
        # ids st+j, so shift left by (start − st) and drop the re-read rows
        s = jax.lax.dynamic_slice(
            jnp.pad(s, ((0, 0), (0, tile)), constant_values=-jnp.inf),
            (0, start - st), (num_q, tile),
        )
        col = start + jax.lax.broadcasted_iota(jnp.int32, (1, tile), 1)
        limit = n if num_valid is None else jnp.minimum(n, num_valid)
        return jnp.where(col < limit, s, -jnp.inf)

    scores, idx = _streaming_topk(score_tile, n, num_q, k, tile)
    return _finalize(scores, idx, metric, q_sq)
