#!/usr/bin/env python
"""Smoke run of vq_tpu's main path on one GPU, through the public index API.

Every phase fits an index on a 1,000,000 × 1536 float32 corpus (the shape
of the reference's DBpedia-1M set) generated on the device from --seed,
searches 256 queries at k=10, and compares the result with a plain float32
reference written here: a chunked matmul at Precision.HIGHEST followed by
lax.top_k over the quantizer's decompressed rows (ADC is an exact scan over
reconstructions).  Phases:

  1. FlatQuantizedIndex(PQ M=192 B=8), L2
  2. FlatQuantizedIndex(SAQ bpd=2), NIP — code-row scan and packed scan
  3. IvfPackedFlatIndex(SAQ bpd=2, K=1024, nprobe=32) — vs the reference
     restricted to rows of masked-in tiles; at nprobe=K vs phase 2's
     packed scan
  4. IvfQuantizedIndex(RaBitQ 4-bit, K=1024, nprobe=32), union strategy —
     vs a per-query probed brute force
  5. the CLI: `python -m vq_tpu run --dataset dummy-100000x1536 --method pq`

With --four-cards only the sharded indexes run, on a 1-D mesh of four GPUs
over a 4,000,000 × 1024 corpus, each compared with its single-device
counterpart on the same data.

The script needs a GPU: without one it exits non-zero and prints no
result.  Any phase failure or tolerance miss exits non-zero.  The last
line of a successful run is one JSON object naming the device.

Usage: python chip_smoke.py [--four-cards] [--seed 0]
"""

from __future__ import annotations

import argparse
import contextlib
import functools
import io
import json
import os
import subprocess
import sys
import time
import traceback

import jax
import jax.numpy as jnp
import numpy as np

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

K = 10
NQ = 256
TOL_F32 = 0.999  # id overlap@10 for float32 scoring
TOL_BF16 = 0.98  # id overlap@10 for bf16 scoring
TOL_BF16_SCORE = 1e-2  # relative score error for bf16 scoring
TOLERANCE_REASONS = (
    f"float32 runs: mean id overlap@10 >= {TOL_F32} — only near-ties may "
    "differ, from another float32 summation order;  "
    f"bf16 runs: overlap >= {TOL_BF16} and scores within "
    f"{TOL_BF16_SCORE} relative — operands are rounded to 8 mantissa bits "
    "before float32 accumulation;  the reference states Precision.HIGHEST "
    "because this card may run unspecified float32 matmuls in TF32"
)


class PhaseFailure(Exception):
    pass


def require_gpu() -> None:
    """Exit non-zero unless JAX's default backend is a GPU."""
    backend = jax.default_backend()
    if backend != "gpu" or jax.devices()[0].platform != "gpu":
        raise SystemExit(
            f"{os.path.basename(sys.argv[0])}: JAX found no GPU (backend "
            f"{backend!r}); this run has no CPU fallback"
        )


def card_line() -> str:
    """`name, power.limit` of each visible card, as nvidia-smi reports."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()
    return out[0] if len(set(out)) == 1 else " | ".join(out)


# ---------------------------------------------------------------------------
# data and the plain reference
# ---------------------------------------------------------------------------


def planted_corpus(n, d, nq, seed, csize=100, spread=1.0,
                   block=65536):
    """Planted-neighbourhood corpus at full intrinsic rank on the device:
    n/csize "documents" with csize noisy variants each, a power-law
    spectrum, unit-normalized rows; queries are fresh variants of random
    documents.  Generated in row blocks so one (block, d) slab is live."""
    kc = n // csize
    ks = jax.random.split(jax.random.PRNGKey(seed), 5)
    n_pad = -(-n // block) * block

    @jax.jit
    def gen():
        a = jax.random.normal(ks[0], (d, d), jnp.float32)
        a = a * ((1.0 + jnp.arange(d)) ** -0.5)
        cents = jax.random.normal(ks[1], (kc, d), jnp.float32)

        def one_block(i):
            rows = i * block + jnp.arange(block)
            z = cents[rows % kc] + spread * jax.random.normal(
                jax.random.fold_in(ks[2], i), (block, d), jnp.float32)
            xb = z @ a
            return xb / jnp.linalg.norm(xb, axis=1, keepdims=True)

        x = jax.lax.map(one_block, jnp.arange(n_pad // block))
        x = x.reshape(n_pad, d)[:n]
        qdoc = jax.random.randint(ks[3], (nq,), 0, kc)
        zq = cents[qdoc] + spread * jax.random.normal(ks[4], (nq, d),
                                                      jnp.float32)
        q = zq @ a
        return x, q / jnp.linalg.norm(q, axis=1, keepdims=True)

    return gen()


@functools.partial(jax.jit, static_argnames=("k", "metric"))
def _ref_step(q, rows, row_norms, allowed, best_s, best_i, base, k, metric):
    hi = jax.lax.Precision.HIGHEST
    ip = jnp.dot(q, rows.T, precision=hi)
    if metric == "l2":
        d2 = (jnp.sum(q * q, axis=1)[:, None] - 2.0 * ip
              + jnp.sum(rows * rows, axis=1)[None, :])
        s = -d2
    elif metric == "ip":
        s = ip
    else:
        s = ip / row_norms[None, :]
    if allowed is not None:
        s = jnp.where(allowed, s, -jnp.inf)
    ts, ti = jax.lax.top_k(s, min(k, rows.shape[0]))
    cat_s = jnp.concatenate([best_s, ts], axis=1)
    cat_i = jnp.concatenate([best_i, ti.astype(jnp.int32) + base], axis=1)
    ms, mi = jax.lax.top_k(cat_s, k)
    return ms, jnp.take_along_axis(cat_i, mi, axis=1)


def reference_topk(queries, rows_fn, n, k, metric, norms=None, allowed_fn=None,
                   chunk=65536):
    """Plain float32 top-k, independent of the repo's scans.

    rows_fn(i0, i1) → (i1-i0, D) float32 rows (the quantizer's
    reconstructions); metric "l2" | "ip" | "nip" (ip / norms[row]);
    allowed_fn(i0, i1) → (Q, i1-i0) bool candidate mask or None.
    Returns natural-form (scores, ids) as numpy: ascending distances for
    "l2", descending scores otherwise."""
    q = jnp.asarray(queries, jnp.float32)
    best_s = jnp.full((q.shape[0], k), -jnp.inf, jnp.float32)
    best_i = jnp.zeros((q.shape[0], k), jnp.int32)
    for i0 in range(0, n, chunk):
        i1 = min(n, i0 + chunk)
        rows = jnp.asarray(rows_fn(i0, i1), jnp.float32)
        nrm = (jnp.ones((i1 - i0,), jnp.float32) if norms is None
               else jnp.asarray(norms[i0:i1], jnp.float32))
        allowed = None if allowed_fn is None else allowed_fn(i0, i1)
        best_s, best_i = _ref_step(q, rows, nrm, allowed, best_s, best_i,
                                   i0, k=k, metric=metric)
    s = np.asarray(best_s)
    return (-s if metric == "l2" else s), np.asarray(best_i)


def overlap(ids, ref_ids):
    ids, ref_ids = np.asarray(ids), np.asarray(ref_ids)
    return float(np.mean([
        len(set(a.tolist()) & set(b.tolist())) / ref_ids.shape[1]
        for a, b in zip(ids, ref_ids)
    ]))


def check(label, ids, scores, ref_ids, ref_scores, bf16=False):
    """Apply the stated tolerance; print the numbers; raise on a miss."""
    ov = overlap(ids, ref_ids)
    ok = ov >= (TOL_BF16 if bf16 else TOL_F32)
    msg = f"  check {label}: overlap@{K}={ov:.4f}"
    if bf16:
        ref = np.asarray(ref_scores, np.float64)
        err = np.abs(np.asarray(scores, np.float64) - ref)
        rel = float(np.max(err / np.maximum(np.abs(ref), 1e-6)))
        ok = ok and rel <= TOL_BF16_SCORE
        msg += f" max_rel_score_err={rel:.2e} (tol {TOL_BF16}, {TOL_BF16_SCORE})"
    else:
        msg += f" (tol {TOL_F32})"
    if not np.all(np.isfinite(np.asarray(scores))):
        ok = False
        msg += " non-finite scores"
    print(msg + (" ok" if ok else " FAIL"), flush=True)
    if not ok:
        raise PhaseFailure(label)


def timed(fn):
    t0 = time.perf_counter()
    out = jax.block_until_ready(fn())
    return out, time.perf_counter() - t0


# ---------------------------------------------------------------------------
# one-card phases
# ---------------------------------------------------------------------------


class Ctx:
    def __init__(self, card, seed):
        self.card = card
        self.seed = seed


def _timing(ctx, phase, fit_s, **searches):
    parts = " ".join(f"{k}={v:.4f}" for k, v in searches.items())
    print(f"  timing {phase}: fit_s={fit_s:.2f} {parts} "
          f"[card: {ctx.card}]", flush=True)


def _search_pair(index, q, set_bf16):
    """Warm + timed searches in float32 then bf16 scoring."""
    out = {}
    for bf16 in (False, True):
        set_bf16(bf16)
        index.search_with_scores(q, k=K)  # compile
        (ids, scores), t = timed(lambda: index.search_with_scores(q, k=K))
        out[bf16] = (ids, scores, t)
    return out


def _flat_cfg_setter(index):
    import dataclasses

    def set_bf16(v):
        index.search_cfg = dataclasses.replace(index.search_cfg, use_bf16=v)
    return set_bf16


def phase_pq(ctx):
    from vq_tpu.core.config import KMeansConfig, Metric, PQConfig, SearchConfig
    from vq_tpu.index.flat import FlatQuantizedIndex
    from vq_tpu.methods.pq import PQ

    x, q = ctx.x, ctx.q
    pq = PQ(PQConfig(num_subquantizers=192, num_bits=8,
                     kmeans=KMeansConfig(iters=10)))
    index = FlatQuantizedIndex(pq, SearchConfig(metric=Metric.L2))
    _, fit_s = timed(lambda: index.fit(x).codes)
    res = _search_pair(index, q, _flat_cfg_setter(index))
    dec = jax.jit(pq.decode_fn())
    ref_s, ref_i = reference_topk(
        q, lambda i0, i1: dec(index.codes[i0:i1]), x.shape[0], K, "l2")
    _timing(ctx, "1 pq-flat", fit_s, search_f32_s=res[False][2],
            search_bf16_s=res[True][2])
    check("1 pq-flat f32", res[False][0], res[False][1], ref_i, ref_s)
    check("1 pq-flat bf16", res[True][0], res[True][1], ref_i, ref_s,
          bf16=True)


def phase_saq_flat(ctx):
    from vq_tpu.core.config import Metric, SAQConfig, SearchConfig
    from vq_tpu.index.flat import FlatQuantizedIndex
    from vq_tpu.kernels.adc import _finalize
    from vq_tpu.methods.saq import SAQ

    x, q = ctx.x, ctx.q
    saq = SAQ(SAQConfig(bits_per_dim=2.0, use_pca=True))
    index = FlatQuantizedIndex(saq, SearchConfig(metric=Metric.NIP))
    _, fit_s = timed(lambda: index.fit(x).codes)
    res = _search_pair(index, q, _flat_cfg_setter(index))
    dec = jax.jit(saq.decode_fn())
    ref_s, ref_i = reference_topk(
        q, lambda i0, i1: dec(index.codes[i0:i1]), x.shape[0], K, "nip",
        norms=index.norms)
    # the packed scan over the same codes
    cache, pack_s = timed(
        lambda: saq.prepare_tile_cache(index.codes, norms=index.norms))
    qd = jnp.asarray(q, jnp.float32)
    q_sq = jnp.sum(qd * qd, axis=1)

    @functools.partial(jax.jit, static_argnames=("bf16",))
    def packed(qd, cache, bf16):
        s, i = saq.packed_scan_raw(qd, cache, K, Metric.NIP, use_bf16=bf16)
        return _finalize(s, i, Metric.NIP, q_sq)

    pk = {}
    for bf16 in (False, True):
        packed(qd, cache, bf16=bf16)
        (s, i), t = timed(lambda: packed(qd, cache, bf16=bf16))
        pk[bf16] = (np.asarray(i), np.asarray(s), t)
    ctx.saq, ctx.saq_codes, ctx.saq_norms = saq, index.codes, index.norms
    ctx.saq_ref = (ref_s, ref_i)
    ctx.saq_packed = pk[False]
    _timing(ctx, "2 saq-flat", fit_s, search_f32_s=res[False][2],
            search_bf16_s=res[True][2], pack_s=pack_s,
            packed_f32_s=pk[False][2], packed_bf16_s=pk[True][2])
    check("2 saq-flat code-row f32", res[False][0], res[False][1], ref_i, ref_s)
    check("2 saq-flat code-row bf16", res[True][0], res[True][1], ref_i,
          ref_s, bf16=True)
    check("2 saq packed f32", pk[False][0], pk[False][1], ref_i, ref_s)
    check("2 saq packed bf16", pk[True][0], pk[True][1], ref_i, ref_s,
          bf16=True)


def _probes(q, centroids, nprobe):
    """Top-nprobe nearest centroids by L2 (plain jnp, HIGHEST)."""
    qd = jnp.asarray(q, jnp.float32)
    d2 = (jnp.sum(qd * qd, 1)[:, None]
          - 2.0 * jnp.dot(qd, centroids.T, precision=jax.lax.Precision.HIGHEST)
          + jnp.sum(centroids * centroids, 1)[None, :])
    return np.asarray(jax.lax.top_k(-d2, nprobe)[1])


def phase_ivf_packed(ctx):
    import dataclasses

    from vq_tpu.core.config import IVFConfig, KMeansConfig, Metric, SearchConfig
    from vq_tpu.index.ivf_packed import IvfPackedFlatIndex

    x, q, saq = ctx.x, ctx.q, ctx.saq
    n = x.shape[0]
    kc, nprobe = 1024, 32
    index = IvfPackedFlatIndex(
        saq, IVFConfig(num_clusters=kc, nprobe=nprobe,
                       kmeans=KMeansConfig(iters=10)),
        SearchConfig(metric=Metric.NIP, use_bf16=False),
    )
    _, fit_s = timed(lambda: index.fit(x).cache.factors)

    def set_bf16(v):
        index.search_cfg = dataclasses.replace(index.search_cfg, use_bf16=v)
        index._search_fn = None

    res = _search_pair(index, q, set_bf16)
    dec = jax.jit(saq.decode_fn())

    def restricted_ref(qb):
        """Reference over rows of tiles whose [first, last] cluster range
        holds a cluster probed by any query of the batch."""
        probed = np.zeros(kc, bool)
        probed[_probes(qb, index.centroids, nprobe).reshape(-1)] = True
        pref = np.concatenate([[0], np.cumsum(probed)])
        first, last = np.asarray(index.cl_first), np.asarray(index.cl_last)
        tile_in = pref[last + 1] - pref[first] > 0
        row_in = np.zeros(n, bool)
        row_in[np.asarray(index.ids_sorted)] = np.repeat(tile_in, 512)[:n]
        row_in_d = jnp.asarray(row_in)
        ref = reference_topk(
            qb, lambda i0, i1: dec(ctx.saq_codes[i0:i1]), n, K, "nip",
            norms=ctx.saq_norms,
            allowed_fn=lambda i0, i1: jnp.broadcast_to(
                row_in_d[i0:i1][None, :], (qb.shape[0], i1 - i0)))
        return ref, float(tile_in.mean())

    (ref_s, ref_i), frac = restricted_ref(q)
    # a small batch probes a strict subset of the tiles
    set_bf16(False)
    q8 = q[:8]
    ids8, s8 = index.search_with_scores(q8, k=K)
    (ref_s8, ref_i8), frac8 = restricted_ref(q8)
    _timing(ctx, "3 ivf-packed", fit_s, search_f32_s=res[False][2],
            search_bf16_s=res[True][2], tiles_frac=frac, tiles_frac_q8=frac8)
    check("3 ivf-packed f32", res[False][0], res[False][1], ref_i, ref_s)
    check("3 ivf-packed bf16", res[True][0], res[True][1], ref_i, ref_s,
          bf16=True)
    check("3 ivf-packed f32 batch of 8", ids8, s8, ref_i8, ref_s8)
    index.ivf_cfg = dataclasses.replace(index.ivf_cfg, nprobe=kc)
    set_bf16(False)
    ids, scores = index.search_with_scores(q, k=K)
    pk_i, pk_s, _ = ctx.saq_packed
    check("3 ivf-packed nprobe=K vs phase-2 packed", ids, scores, pk_i, pk_s)


def phase_ivf_rabitq(ctx):
    from vq_tpu.core.config import (
        IVFConfig, KMeansConfig, Metric, RaBitQConfig, SearchConfig)
    from vq_tpu.index.ivf import IvfQuantizedIndex
    from vq_tpu.methods.rabitq import RaBitQ

    x, q = ctx.x, ctx.q
    n = x.shape[0]
    kc, nprobe = 1024, 32
    rq = RaBitQ(RaBitQConfig(num_bits=4))
    index = IvfQuantizedIndex(
        rq, IVFConfig(num_clusters=kc, nprobe=nprobe,
                      kmeans=KMeansConfig(iters=10)),
        SearchConfig(metric=Metric.L2),
    )
    _, fit_s = timed(lambda: index.fit(x).codes_sorted)
    index.search_with_scores(q, k=K, strategy="union")  # compile
    (ids, scores), t = timed(
        lambda: index.search_with_scores(q, k=K, strategy="union"))
    # per-query probed brute force over x̂ = centroid + decoded residual
    probes = _probes(q, index.centroids, nprobe)
    allowed_cl = np.zeros((q.shape[0], kc), bool)
    np.put_along_axis(allowed_cl, probes, True, axis=1)
    allowed_cl = jnp.asarray(allowed_cl)
    asn = jnp.asarray(index._assignment)
    pos = jnp.asarray(index._inv_perm.astype(np.int32))
    dec = jax.jit(rq.decode_fn())

    def rows(i0, i1):
        res = dec(jnp.take(index.codes_sorted, pos[i0:i1], axis=0))
        return res + jnp.take(index.centroids, asn[i0:i1], axis=0)

    ref_s, ref_i = reference_topk(
        q, rows, n, K, "l2",
        allowed_fn=lambda i0, i1: jnp.take(allowed_cl, asn[i0:i1], axis=1))
    _timing(ctx, "4 ivf-rabitq", fit_s, search_f32_s=t)
    check("4 ivf-rabitq f32", ids, scores, ref_i, ref_s)


def phase_cli(ctx):
    from vq_tpu import cli

    db = os.path.join(os.path.dirname(os.path.abspath(__file__)), "logs",
                      "chip_smoke.db")
    argv = ["run", "--dataset", "dummy-100000x1536", "--method", "pq",
            "--param", "M=192", "--param", "B=8", "--param",
            "kmeans_iters=10", "--num-queries", str(NQ), "--db-path", db]
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(argv)
    wall = time.perf_counter() - t0
    metrics = json.loads(buf.getvalue())
    print(f"  timing 5 cli-run: wall_s={wall:.2f} "
          f"fit_time_s={metrics['fit_time_s']:.2f} [card: {ctx.card}]",
          flush=True)
    r10 = metrics["recall@10"]
    ok = (rc == 0 and 0.0 <= r10 <= 1.0
          and metrics["code_bytes_per_vector"] == 192
          and all(np.isfinite(float(v)) for v in metrics.values()
                  if isinstance(v, (int, float))))
    print(f"  check 5 cli-run: rc={rc} recall@10={r10:.4f} "
          f"code_bytes={metrics['code_bytes_per_vector']} "
          f"(finite metrics, recall in [0, 1], 192 B/vector)"
          + (" ok" if ok else " FAIL"), flush=True)
    if not ok:
        raise PhaseFailure("5 cli-run")


# ---------------------------------------------------------------------------
# four-card phases
# ---------------------------------------------------------------------------


def _assert_sharded(label, arrays, n_dev):
    """Every array is split over all mesh devices, one equal row block
    each — nothing silently lands on one device."""
    for a in arrays:
        devs = a.sharding.device_set
        shards = a.addressable_shards
        rows = {s.data.shape[0] for s in shards}
        if len(devs) != n_dev or len(shards) != n_dev or rows != {a.shape[0] // n_dev}:
            raise PhaseFailure(f"{label}: array {a.shape} not row-sharded "
                               f"over {n_dev} devices ({len(devs)} devices)")
    print(f"  check {label}: {len(arrays)} arrays row-sharded over "
          f"{n_dev} devices ok", flush=True)


def phase4_pq(ctx):
    from vq_tpu.core.config import KMeansConfig, Metric, PQConfig, SearchConfig
    from vq_tpu.dist.sharded_index import ShardedFlatPQIndex
    from vq_tpu.index.flat import FlatQuantizedIndex
    from vq_tpu.methods.pq import PQ

    x, q, mesh = ctx.x, ctx.q, ctx.mesh
    pq = PQ(PQConfig(num_subquantizers=128, num_bits=8,
                     kmeans=KMeansConfig(iters=10)))
    cfg = SearchConfig(metric=Metric.L2, use_bf16=False)
    sh = ShardedFlatPQIndex(pq, cfg, mesh=mesh)
    _, fit_s = timed(lambda: sh.fit(x).codes)
    _assert_sharded("4c-1 sharded-pq", [sh.codes, sh.norms], ctx.n_dev)
    single = FlatQuantizedIndex(pq, cfg).fit(x)
    sh.search_with_scores(q, k=K)
    (ids, s), t = timed(lambda: sh.search_with_scores(q, k=K))
    ref_i, ref_s = single.search_with_scores(q, k=K)
    _timing(ctx, "4c-1 sharded-pq", fit_s, search_f32_s=t)
    check("4c-1 sharded-pq vs single-device", ids, s, ref_i, ref_s)


def phase4_packed(ctx):
    from vq_tpu.core.config import Metric, SAQConfig, SearchConfig
    from vq_tpu.dist.sharded_packed import ShardedPackedFlatIndex
    from vq_tpu.index.ivf import encode_rows_ordered
    from vq_tpu.kernels.adc import _finalize
    from vq_tpu.methods.saq import SAQ

    x, q, mesh = ctx.x, ctx.q, ctx.mesh
    n, d = x.shape
    saq = SAQ(SAQConfig(bits_per_dim=2.0, use_pca=True))
    sh = ShardedPackedFlatIndex(
        saq, SearchConfig(metric=Metric.L2, use_bf16=False), mesh=mesh)
    _, fit_s = timed(lambda: sh.fit(x)._factors)
    _assert_sharded("4c-2 sharded-packed", [sh._factors, *sh._words],
                    ctx.n_dev)
    sh.search_with_scores(q, k=K)
    (ids, s), t = timed(lambda: sh.search_with_scores(q, k=K))
    # single-device packed scan over the same quantizer's codes
    codes, _ = encode_rows_ordered(
        x, np.arange(n), np.zeros(n, np.int32), jnp.zeros((1, d)), saq, 65536)
    cache = saq.prepare_tile_cache(jnp.asarray(codes))
    qd = jnp.asarray(q, jnp.float32)
    rs, ri = saq.packed_scan_raw(qd, cache, K, Metric.L2, use_bf16=False)
    rs, ri = _finalize(rs, ri, Metric.L2, jnp.sum(qd * qd, axis=1))
    ctx.saq4 = saq
    _timing(ctx, "4c-2 sharded-packed", fit_s, search_f32_s=t)
    check("4c-2 sharded-packed vs single-device", ids, s, np.asarray(ri),
          np.asarray(rs))


def phase4_ivf_packed(ctx):
    from vq_tpu.core.config import IVFConfig, KMeansConfig, Metric, SearchConfig
    from vq_tpu.data.sampling import host_sample_rows
    from vq_tpu.dist.sharded_ivf_packed import ShardedIvfPackedIndex
    from vq_tpu.index.ivf import chunked_assign
    from vq_tpu.index.ivf_packed import IvfPackedFlatIndex
    from vq_tpu.kernels.kmeans import kmeans

    x, q, mesh = ctx.x, ctx.q, ctx.mesh
    kmc = KMeansConfig(iters=10)
    ivf = IVFConfig(num_clusters=1024, nprobe=32, kmeans=kmc)
    cfg = SearchConfig(metric=Metric.L2, use_bf16=False)
    cents = kmeans(jax.random.PRNGKey(0),
                   jnp.asarray(host_sample_rows(x, 262_144, 0)), 1024, kmc)
    asn = chunked_assign(x, cents, 65536)
    sh = ShardedIvfPackedIndex(ctx.saq4, ivf, cfg, mesh=mesh)
    _, fit_s = timed(lambda: sh.fit(x, coarse=(cents, asn))._factors)
    _assert_sharded("4c-3 sharded-ivf-packed",
                    [sh._factors, sh._ids, *sh._words], ctx.n_dev)
    sh.search_with_scores(q, k=K)
    (ids, s), t = timed(lambda: sh.search_with_scores(q, k=K))
    single = IvfPackedFlatIndex(ctx.saq4, ivf, cfg).fit(x, coarse=(cents, asn))
    ref_i, ref_s = single.search_with_scores(q, k=K)
    _timing(ctx, "4c-3 sharded-ivf-packed", fit_s, search_f32_s=t)
    check("4c-3 sharded-ivf-packed vs single-device", ids, s, ref_i, ref_s)


def phase4_ivf(ctx):
    from vq_tpu.core.config import (
        IVFConfig, KMeansConfig, Metric, RaBitQConfig, SearchConfig)
    from vq_tpu.dist.sharded_ivf import ShardedIVFIndex
    from vq_tpu.index.ivf import IvfQuantizedIndex, chunked_assign
    from vq_tpu.methods.rabitq import RaBitQ

    x, q, mesh = ctx.x, ctx.q, ctx.mesh
    ivf = IVFConfig(num_clusters=1024, nprobe=32,
                    kmeans=KMeansConfig(iters=10))
    cfg = SearchConfig(metric=Metric.L2)
    rq = RaBitQ(RaBitQConfig(num_bits=4))
    sh = ShardedIVFIndex(rq, ivf, cfg, mesh=mesh)
    _, fit_s = timed(lambda: sh.fit(x).centroids)
    _assert_sharded("4c-4 sharded-ivf", [sh.codes_sh, sh.ids_sh, sh.norms_sh],
                    ctx.n_dev)
    sh.search_with_scores(q, k=K)
    (ids, s), t = timed(lambda: sh.search_with_scores(q, k=K))
    # the single-device index on the same coarse quantizer and residual
    # quantizer (rq keeps the params the sharded fit trained)
    asn = chunked_assign(x, sh.centroids, 65536)
    single = IvfQuantizedIndex(rq, ivf, cfg).fit(x, coarse=(sh.centroids, asn))
    ref_i, ref_s = single.search_with_scores(q, k=K)
    _timing(ctx, "4c-4 sharded-ivf", fit_s, search_f32_s=t)
    check("4c-4 sharded-ivf vs single-device", ids, s, ref_i, ref_s)


def phase4_lloyd(ctx):
    from vq_tpu.dist.mesh import replicate, shard_rows
    from vq_tpu.dist.sharded import dp_lloyd_step

    x, mesh = ctx.x, ctx.mesh
    xs = x[:1_048_576]
    c0 = xs[:1024]
    xsh = shard_rows(mesh, xs)
    _assert_sharded("4c-5 dp-lloyd input", [xsh], ctx.n_dev)
    c1, t = timed(lambda: dp_lloyd_step(mesh, xsh, replicate(mesh, c0)))
    # plain single-device Lloyd step (same distance function, so only the
    # order of the float32 centroid sums differs)
    from vq_tpu.kernels.kmeans import pairwise_sqdist_xc

    @jax.jit
    def lloyd(x, c):
        a = jnp.argmin(pairwise_sqdist_xc(x, c), axis=1)
        sums = jax.ops.segment_sum(x, a, num_segments=c.shape[0])
        cnt = jax.ops.segment_sum(jnp.ones_like(a, jnp.float32), a,
                                  num_segments=c.shape[0])
        return jnp.where((cnt > 0)[:, None],
                         sums / jnp.maximum(cnt, 1.0)[:, None], c)

    ref = np.asarray(lloyd(xs, c0))
    err = float(np.max(np.abs(np.asarray(c1) - ref)))
    ok = err <= 1e-4
    print(f"  timing 4c-5 dp-lloyd: step_s={t:.4f} [card: {ctx.card}]")
    print(f"  check 4c-5 dp-lloyd vs single-device: max_abs_err={err:.2e} "
          "(tol 1e-4: float32 sums of unit rows in another order)"
          + (" ok" if ok else " FAIL"), flush=True)
    if not ok:
        raise PhaseFailure("4c-5 dp-lloyd")


ONE_CARD = [("1 pq-flat", phase_pq), ("2 saq-flat", phase_saq_flat),
            ("3 ivf-packed", phase_ivf_packed),
            ("4 ivf-rabitq", phase_ivf_rabitq), ("5 cli-run", phase_cli)]
FOUR_CARDS = [("4c-1 sharded-pq", phase4_pq),
              ("4c-2 sharded-packed", phase4_packed),
              ("4c-3 sharded-ivf-packed", phase4_ivf_packed),
              ("4c-4 sharded-ivf", phase4_ivf),
              ("4c-5 dp-lloyd", phase4_lloyd)]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the sharded phases on a 4-GPU mesh")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    require_gpu()
    from vq_tpu.cli import _enable_compilation_cache, compilation_cache_dir
    from vq_tpu.dist.mesh import make_mesh

    card = card_line()
    n_dev = 4 if args.four_cards else 1
    if len(jax.devices()) < n_dev:
        raise SystemExit(f"chip_smoke: need {n_dev} GPUs, JAX sees "
                         f"{len(jax.devices())}")
    _enable_compilation_cache()
    print(f"card: {card}", flush=True)
    print(f"jax {jax.__version__}; devices {len(jax.devices())} x "
          f"{jax.devices()[0].device_kind}; compile cache "
          f"{compilation_cache_dir() or os.environ['JAX_COMPILATION_CACHE_DIR']}",
          flush=True)
    print(f"tolerances: {TOLERANCE_REASONS}", flush=True)

    ctx = Ctx(card, args.seed)
    n, d = (4_000_000, 1024) if args.four_cards else (1_000_000, 1536)
    (ctx.x, ctx.q), gen_s = timed(
        lambda: planted_corpus(n, d, NQ, args.seed))
    print(f"corpus {n} x {d} float32 + {NQ} queries on the device "
          f"(seed {args.seed}) in {gen_s:.2f} s", flush=True)
    ctx.n_dev = n_dev
    if args.four_cards:
        ctx.mesh = make_mesh(4)
    failed = []
    for name, fn in (FOUR_CARDS if args.four_cards else ONE_CARD):
        print(f"phase {name}", flush=True)
        try:
            fn(ctx)
        except Exception:  # report every phase, then fail the run
            traceback.print_exc()
            failed.append(name)
            print(f"phase {name}: FAILED", flush=True)
    if failed:
        print(f"chip_smoke: failed phases: {', '.join(failed)}",
              file=sys.stderr)
        return 1
    dev = jax.devices()[0]
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
