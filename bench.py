"""Headline benchmark: ADC queries/sec at recall@10, PQ M=16 B=8, D=1536.

Prints ONE JSON line {"metric", "value", "unit", "vs_baseline", ...} with
the device it ran on (`platform`, `device_kind`, `device_count`, and the
card's name and power limit from nvidia-smi).  Further fields:

  value_median / value_spread — spread over the timed calls.
  recall_gate_pq192 — quality-bearing gate: PQ M=192 B=8 at D=1536 (≈1 bpd,
      the reference study's bpd=1 config — results_full_20260612_235308.csv
      pq R@10 0.8034 on dbpedia; here the same geometry on a planted-
      neighborhood corpus where that target is reachable — see
      recall_gate_pq192).  The run FAILS (exit 1) below the floor (0.763).
  saq_packed_* / rabitq_packed_* — the packed scan (kernels/packed.py) on
      the record: SAQ bpd=2 and RaBitQ B=2 at D=1024, N=1M, Q=256, k=10,
      QPS + recall@10.
  ivf_* / ivfpk_* / flat_* — IVF at the reference's flagship operating
      point (ivf_flagship).

Every timing is a served call: the jitted search ended by
block_until_ready (or a search returning host arrays), warm, the best and
median of a few calls.

vs_baseline: the reference's measured single-core ADC scoring rate is
~2.4 M vec/s for uniform-width ADC (reference bench/ffd_speed.cpp:10-16, at
D=1024); at N=100k rows that is 24 queries/s/core.  vs_baseline = our
QPS ÷ 24.

Env knobs: VQ_BENCH_N/D/Q/TILE (headline shape), VQ_BENCH_FAST=1 runs the
1M sections at 131k rows (dev loop).  Full results go to
results/bench.json.
"""

from __future__ import annotations

import json
import os
import sys
import time

import numpy as np

# regression floor for the gate corpus, with slack for bf16 scoring; the
# reference's dbpedia value at this geometry is 0.8034.
RECALL_GATE_PQ192_FLOOR = float(os.environ.get("VQ_GATE_PQ192", 0.763))


def _served(fn, reps=5):
    """(median, best, all) seconds of `reps` warm calls of fn, each ended
    by block_until_ready; the first (compiling) call is not timed."""
    import jax

    jax.block_until_ready(fn())
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn())
        times.append(time.perf_counter() - t0)
    return float(np.median(times)), float(min(times)), times


def device_info() -> dict:
    """The device this run measured, as JAX and nvidia-smi report it;
    exits without a GPU."""
    import jax

    from chip_smoke import card_line, require_gpu

    require_gpu()
    dev = jax.devices()[0]
    name, power = [v.strip() for v in card_line().split(" | ")[0].split(",")]
    return {"platform": dev.platform, "device_kind": dev.device_kind,
            "device_count": len(jax.devices()), "card": name,
            "power_limit": power}


def headline_pq(jax, jnp, out):
    from vq_tpu.core.config import KMeansConfig, Metric, PQConfig
    from vq_tpu.kernels.adc import exact_topk, scan_codes_topk
    from vq_tpu.methods import pq as pq_mod
    from vq_tpu.metrics.recall import recall_at_k

    n = int(os.environ.get("VQ_BENCH_N", 100_000))
    d = int(os.environ.get("VQ_BENCH_D", 1536))
    nq = int(os.environ.get("VQ_BENCH_Q", 1024))
    k = 10

    # power-law spectrum mimicking text-embedding covariance decay; queries
    # are jittered corpus rows so GT neighbors are findable.  Note M=16 B=8
    # at D=1536 is 0.083 bits/dim (512x compression) — recall@10 is
    # intrinsically modest at this geometry on ANY data; the headline here
    # is the scan throughput at the north-star code shape.  Data is
    # generated on the device.
    sigma = jnp.asarray(((1.0 + np.arange(d)) ** -0.75).astype(np.float32))
    kx, kq, kj = jax.random.split(jax.random.PRNGKey(0), 3)

    @jax.jit
    def gen_data():
        x = jax.random.normal(kx, (n, d), dtype=jnp.float32) * sigma
        qidx = jax.random.randint(kq, (nq,), 0, n)
        q = x[qidx] + 0.25 * sigma * jax.random.normal(kj, (nq, d),
                                                       dtype=jnp.float32)
        return x, q

    xd, qd = gen_data()
    xd.block_until_ready()

    cfg = PQConfig(num_subquantizers=16, num_bits=8, kmeans=KMeansConfig(iters=20))
    params = pq_mod.fit(jax.random.PRNGKey(0), xd, cfg)
    codes = pq_mod.encode(params, xd)
    codes.block_until_ready()

    _, gt = exact_topk(qd, xd, k=k, metric=Metric.L2)
    gt = np.asarray(gt)

    tile = int(os.environ.get("VQ_BENCH_TILE", 16384))

    ids = np.asarray(scan_codes_topk(
        qd, codes, params.codebooks, k=k, metric=Metric.L2,
        tile_rows=tile, use_bf16=True,
    )[1])
    recall = recall_at_k(gt, ids, k)

    med, best, _ = _served(lambda: scan_codes_topk(
        qd, codes, params.codebooks, k=k, metric=Metric.L2,
        tile_rows=tile, use_bf16=True,
    ), reps=10)
    qps = nq / best

    # encode throughput (north-star aux metric) on a ≤100k subset
    n_enc = min(n, 100_000)
    xe = xd[:n_enc]
    enc = jax.jit(lambda x: pq_mod.encode(params, x))
    _, enc_best, _ = _served(lambda: enc(xe), reps=3)
    encode_vps = n_enc / enc_best

    from vq_tpu.utils.profiling import ScanStats

    stats = ScanStats(
        num_rows=n, num_queries=nq, dim=d, code_bytes_per_row=16.0
    ).report(best)

    baseline_qps = 2.4e6 / n
    # the quality guarantee lives in the bpd-matched recall_gate_pq192
    # field, which FAILS the run below its floor
    out.update(
        metric="adc_qps_per_chip_pq16x8_d1536_n100k",
        value=round(qps, 1),
        unit="queries/s/chip",
        vs_baseline=round(qps / baseline_qps, 1),
        value_median=round(nq / med, 1),
        value_spread=round((med - best) / med, 3),
        recall_at_10=round(recall, 4),
        scan_wall_s=round(best, 5),
        n=n,
        num_queries=nq,
        encode_vecs_per_s=round(encode_vps, 1),
        effective_tflops=round(stats["effective_tflops"], 2),
    )
    return xd, qd, gt


def recall_gate_pq192(jax, jnp, out):
    """bpd-matched quality gate: PQ M=192 B=8 at D=1536 (≈1 bit/dim).

    The headline's iid power-law corpus has NO usable neighbor structure at
    D=1536 (top-10 distances concentrate; measured ceilings: iid 0.18,
    rank-16 manifold 0.59 — no quantizer can reach the reference's dbpedia
    0.8034 there).  The gate therefore runs on a corpus that plants the
    structure real embedding sets have: low intrinsic dimension (rank-32
    manifold in D=1536), near-duplicate neighborhoods (10k "documents" ×
    10 variants, within-document spread 0.5), unit-normalized rows — the
    same geometry/compression as the reference study's bpd=1 dbpedia row
    (results_full_20260612_235308.csv pq R@10 0.8034), so the
    reference-derived floor 0.763 is meaningful and a scoring regression
    (worse codebooks, broken estimator, precision loss) fails the run."""
    from vq_tpu.core.config import KMeansConfig, Metric, PQConfig
    from vq_tpu.kernels.adc import exact_topk, scan_codes_topk
    from vq_tpu.methods import pq as pq_mod
    from vq_tpu.metrics.recall import recall_at_k

    n, d, nq, k = 100_000, 1536, 1024, 10
    rank, csize, spread = 32, 10, 0.5
    kc = n // csize
    ks = jax.random.split(jax.random.PRNGKey(0), 6)

    @jax.jit
    def gen():
        a = jax.random.normal(ks[0], (rank, d), jnp.float32)
        a = a * ((1.0 + jnp.arange(d)) ** -0.5)
        cents = jax.random.normal(ks[1], (kc, rank), jnp.float32)
        asn = jnp.arange(n) % kc
        z = cents[asn] + spread * jax.random.normal(ks[3], (n, rank),
                                                    jnp.float32)
        qdoc = jax.random.randint(ks[4], (nq,), 0, kc)
        zq = cents[qdoc] + spread * jax.random.normal(ks[5], (nq, rank),
                                                      jnp.float32)
        x, q = z @ a, zq @ a
        x = x / jnp.linalg.norm(x, axis=1, keepdims=True)
        q = q / jnp.linalg.norm(q, axis=1, keepdims=True)
        return x, q

    xg, qg = gen()
    _, gt = exact_topk(qg, xg, k=k, metric=Metric.L2)
    gt = np.asarray(gt)
    cfg = PQConfig(num_subquantizers=192, num_bits=8,
                   kmeans=KMeansConfig(iters=10))
    params = pq_mod.fit(jax.random.PRNGKey(1), xg, cfg)
    codes = pq_mod.encode(params, xg)
    ids = np.asarray(scan_codes_topk(
        qg, codes, params.codebooks, k=k, metric=Metric.L2, use_bf16=True,
    )[1])
    r = recall_at_k(gt, ids, k)
    out["recall_gate_pq192"] = round(r, 4)
    out["recall_gate_floor"] = RECALL_GATE_PQ192_FLOOR
    return r >= RECALL_GATE_PQ192_FLOOR


def _gen_corpus_chunks(jax, jnp, n, d, chunk, seed, encode_chunk):
    """Generate a power-law corpus on device chunk-by-chunk, encode each
    chunk, and keep (raw corpus, byte codes) resident."""
    sigma = jnp.asarray(((1.0 + np.arange(d)) ** -0.6).astype(np.float32))
    xs, cs = [], []
    for i in range(0, n, chunk):
        key = jax.random.PRNGKey(seed + i)
        x = jax.random.normal(key, (min(chunk, n - i), d), jnp.float32) * sigma
        xs.append(x)
        cs.append(encode_chunk(x))
    x = jnp.concatenate(xs, axis=0)
    codes = jnp.concatenate(cs, axis=0)
    return x, codes


def packed_saq_1m(jax, jnp, out, fast):
    from vq_tpu.core.config import Metric, SAQConfig
    from vq_tpu.kernels.adc import _finalize, exact_topk
    from vq_tpu.methods import saq as saq_mod
    from vq_tpu.metrics.recall import recall_at_k

    n = 131_072 if fast else 1_048_576
    d = 1024
    nq, k = 256, 10
    cfg = SAQConfig(bits_per_dim=2.0, use_pca=True)
    m = saq_mod.SAQ(cfg)
    # fit on an on-device 131k sample (host_sample_rows keeps jax arrays on
    # device)
    sigma = jnp.asarray(((1.0 + np.arange(d)) ** -0.6).astype(np.float32))
    xfit = jax.random.normal(jax.random.PRNGKey(7), (131_072, d),
                             jnp.float32) * sigma
    m._dim = d
    m.plan, m.params = saq_mod.fit(jax.random.PRNGKey(0), xfit, cfg)

    enc = jax.jit(lambda x: saq_mod.encode(m.plan, m.params, x))
    x, codes = _gen_corpus_chunks(jax, jnp, n, d, 131_072, 100, enc)
    cache = m.prepare_tile_cache(codes)

    kq = jax.random.PRNGKey(3)
    qidx = jax.random.randint(kq, (nq,), 0, n)
    q = x[qidx] + 0.1 * sigma * jax.random.normal(
        jax.random.PRNGKey(4), (nq, d), jnp.float32
    )
    _, gt = exact_topk(q, x, k=k, metric=Metric.L2)
    gt = np.asarray(gt)
    q_sq = jnp.sum(q * q, axis=-1)

    @jax.jit
    def scan(q, cache):
        s, i = m.packed_scan_raw(q, cache, k, Metric.L2)
        return _finalize(s, i, Metric.L2, q_sq)

    recall = recall_at_k(gt, np.asarray(scan(q, cache)[1]), k)
    med, best, _ = _served(lambda: scan(q, cache))
    out.update(
        saq_packed_qps=round(nq / best, 1),
        saq_packed_qps_median=round(nq / med, 1),
        saq_packed_recall10=round(recall, 4),
        saq_packed_n=n,
        saq_code_bytes=int(m.plan.code_bytes),
    )


def packed_rabitq_1m(jax, jnp, out, fast):
    from vq_tpu.core.config import Metric, RaBitQConfig
    from vq_tpu.kernels.adc import _finalize, exact_topk
    from vq_tpu.methods import rabitq as rb_mod
    from vq_tpu.metrics.recall import recall_at_k

    n = 131_072 if fast else 1_048_576
    d = 1024
    nq, k = 256, 10
    bits = 2
    m = rb_mod.RaBitQ(RaBitQConfig(num_bits=bits))
    sigma = jnp.asarray(((1.0 + np.arange(d)) ** -0.6).astype(np.float32))
    xfit = jax.random.normal(jax.random.PRNGKey(9), (65_536, d),
                             jnp.float32) * sigma
    m.fit(np.asarray(xfit))

    enc = jax.jit(lambda x: rb_mod.encode(m.params, x, bits))
    x, codes = _gen_corpus_chunks(jax, jnp, n, d, 131_072, 200, enc)
    cache = m.prepare_tile_cache(codes)

    q = x[jax.random.randint(jax.random.PRNGKey(5), (nq,), 0, n)] + \
        0.1 * sigma * jax.random.normal(jax.random.PRNGKey(6), (nq, d),
                                        jnp.float32)
    _, gt = exact_topk(q, x, k=k, metric=Metric.L2)
    gt = np.asarray(gt)
    q_sq = jnp.sum(q * q, axis=-1)

    @jax.jit
    def scan(q, cache):
        s, i = m.packed_scan_raw(q, cache, k, Metric.L2)
        return _finalize(s, i, Metric.L2, q_sq)

    recall = recall_at_k(gt, np.asarray(scan(q, cache)[1]), k)
    med, best, _ = _served(lambda: scan(q, cache))
    out.update(
        rabitq_packed_qps=round(nq / best, 1),
        rabitq_packed_qps_median=round(nq / med, 1),
        rabitq_packed_recall10=round(recall, 4),
        rabitq_packed_n=n,
    )


def gen_fullrank_corpus(jax, jnp, n, d, nq, rank=None, csize=100,
                        spread=1.0, seed=11, block=65536):
    """Planted-neighborhood corpus at full intrinsic rank, generated in
    row blocks under lax.map so the latent z never coexists with x — the
    one-shot generator held z (N, rank) AND x (N, D) live (12.2 GB at
    N=1M, rank=D=1536).
    Peak here is x + one (block, D) slab."""
    if rank is None:
        rank = d
    kc = n // csize
    ks = jax.random.split(jax.random.PRNGKey(seed), 6)
    n_pad = -(-n // block) * block

    @jax.jit
    def gen():
        a = jax.random.normal(ks[0], (rank, d), jnp.float32)
        a = a * ((1.0 + jnp.arange(d)) ** -0.5)
        cents = jax.random.normal(ks[1], (kc, rank), jnp.float32)

        def one_block(i):
            rows = i * block + jnp.arange(block)
            z = cents[rows % kc] + spread * jax.random.normal(
                jax.random.fold_in(ks[3], i), (block, rank), jnp.float32)
            xb = z @ a
            return xb / jnp.linalg.norm(xb, axis=1, keepdims=True)

        x = jax.lax.map(one_block, jnp.arange(n_pad // block))
        x = x.reshape(n_pad, d)[:n]
        qdoc = jax.random.randint(ks[4], (nq,), 0, kc)
        zq = cents[qdoc] + spread * jax.random.normal(ks[5], (nq, rank),
                                                      jnp.float32)
        q = zq @ a
        return x, q / jnp.linalg.norm(q, axis=1, keepdims=True)

    return gen()


def ivf_flagship(jax, jnp, out, fast):
    """IVF at the reference's flagship operating point.

    The reference's headline quality claims are IVF-engine recalls on
    dbpedia-100k at D=1536, K=4096, nprobe=200: recall@1/10/100 =
    85.0/87.3/86.6 (bpd=1) … 97.0/94.8/90.9 (bpd=4)
    (external/saq/README.md:50-56; searcher ivf_index.h:249-266).  Here the
    same geometry runs on a planted-neighborhood corpus scaled to N=1M
    (the real dataset needs a download) at FULL intrinsic
    rank with a power-law spectrum — the gate corpus's rank-32 variant is
    quantization-INSENSITIVE (SAQ concentrates the whole bit budget on 32
    informative dims; bpd 1 vs 4 measured identical recall), while at
    rank=D / csize=100 / spread=1.0 the flat-scan recall ladder lands on
    the reference's (bpd 1/2/4 → r@1 0.80/0.92/0.98 vs the reference's
    0.85/0.93/0.97).  IVF+SAQ at bpd ∈
    {1, 2, 4} and IVF+PQ at the matching bpd=1 (M=192), nprobe ∈
    {50, 200}, recall@1/10/100 vs exact GT + serving QPS + build
    time.  Fast mode shrinks to N=131k / K=1024 / two configs."""
    import dataclasses

    from vq_tpu.core.config import (
        IVFConfig,
        KMeansConfig,
        Metric,
        PQConfig,
        SAQConfig,
    )
    from vq_tpu.index.ivf import IvfQuantizedIndex
    from vq_tpu.index.ivf_packed import IvfPackedFlatIndex
    from vq_tpu.kernels.adc import exact_topk
    from vq_tpu.methods.pq import PQ
    from vq_tpu.methods.saq import SAQ
    from vq_tpu.metrics.recall import recall_at_k

    n = 131_072 if fast else 1_048_576
    d, nq = 1536, 256
    rank, csize, spread = 1536, 100, 1.0
    xg, qg = gen_fullrank_corpus(jax, jnp, n, d, nq, rank, csize, spread)
    xg.block_until_ready()
    _, gt = exact_topk(qg, xg, k=100, metric=Metric.L2)
    gt = np.asarray(gt)

    kcl = 1024 if fast else 4096
    # coarse k-means: random-row init (auto), 64 samples/centroid — the
    # k-means++ scan is prohibitive at K=4096 (kernels/kmeans.py note).
    # The coarse pass (k-means + assignment) is shared by every config —
    # they differ only in the residual quantizer (the reference's SaqIndex
    # also splits k-means from construct, saq_index.py:80-96).
    kmc = KMeansConfig(iters=10, max_points_per_centroid=64)
    from vq_tpu.data.sampling import chunk_rows_for_bytes, host_sample_rows
    from vq_tpu.index.ivf import chunked_assign
    from vq_tpu.kernels.kmeans import kmeans

    t0 = time.perf_counter()
    cap = min(n, max(200_000, kmc.max_points_per_centroid * kcl))
    xs = host_sample_rows(xg, cap, kmc.seed)
    cents = kmeans(jax.random.PRNGKey(kmc.seed),
                   jnp.asarray(xs, jnp.float32), kcl, kmc)
    del xs
    asn = chunked_assign(xg, cents, chunk_rows_for_bytes(d))
    out["ivf_coarse_s"] = round(time.perf_counter() - t0, 1)

    configs = [
        ("saq_bpd1", lambda: SAQ(SAQConfig(bits_per_dim=1.0, use_pca=True))),
        ("saq_bpd2", lambda: SAQ(SAQConfig(bits_per_dim=2.0, use_pca=True))),
        ("saq_bpd4", lambda: SAQ(SAQConfig(bits_per_dim=4.0, use_pca=True))),
        ("pq_m192", lambda: PQ(PQConfig(num_subquantizers=192, num_bits=8,
                                        kmeans=KMeansConfig(iters=10)))),
    ]
    if fast:
        configs = [configs[1], configs[3]]
    for name, make in configs:
        idx = IvfQuantizedIndex(
            make(), IVFConfig(num_clusters=kcl, nprobe=200, kmeans=kmc)
        )
        t0 = time.perf_counter()
        idx.fit(xg, coarse=(cents, asn))
        out[f"ivf_{name}_build_s"] = round(time.perf_counter() - t0, 1)
        for nprobe in (50, 200):
            idx.ivf_cfg = dataclasses.replace(idx.ivf_cfg, nprobe=nprobe)
            ids, _ = idx.search_with_scores(qg, k=100)  # warm + compile
            times = []
            for _ in range(3):
                t0 = time.perf_counter()
                ids, _ = idx.search_with_scores(qg, k=100)
                times.append(time.perf_counter() - t0)
            pre = f"ivf_{name}_np{nprobe}"
            out[f"{pre}_qps"] = round(nq / min(times), 1)
            for kk in (1, 10, 100):
                out[f"{pre}_recall{kk}"] = round(recall_at_k(gt, ids, kk), 4)
        del idx

    # the probed-TILE packed scan (index/ivf_packed.py): IVF routing as a
    # tile mask over the flat packed scan.  A bpd {1,2,4} + RaBitQ LADDER
    # (the reference's three-bpd IVF table is the comparison surface,
    # external/saq/README.md:50-56), a dense-flat baseline AT THE SAME
    # GEOMETRY (nprobe=K masks every tile in — equal to the flat packed
    # scan per tests/test_ivf_packed.py, so the IVF table carries its own
    # baseline), and a batch-size × query-groups sweep on the bpd=2 index
    # (probe-coherent grouping, ivf_packed.py module docstring).
    from vq_tpu.core.config import RaBitQConfig
    from vq_tpu.methods.rabitq import RaBitQ

    ladder = [
        ("saq_bpd1", lambda: SAQ(SAQConfig(bits_per_dim=1.0, use_pca=True))),
        ("saq_bpd2", lambda: SAQ(SAQConfig(bits_per_dim=2.0, use_pca=True))),
        ("saq_bpd4", lambda: SAQ(SAQConfig(bits_per_dim=4.0, use_pca=True))),
        ("rabitq_b2", lambda: RaBitQ(RaBitQConfig(num_bits=2))),
    ]
    if fast:
        ladder = [ladder[1]]
    nb_total = -(-n // 512)
    mk_bpd2 = None
    for lname, lmake in ladder:
        mk = IvfPackedFlatIndex(
            lmake(), IVFConfig(num_clusters=kcl, nprobe=200, kmeans=kmc)
        )
        t0 = time.perf_counter()
        mk.fit(xg, coarse=(cents, asn))
        out[f"ivfpk_{lname}_build_s"] = round(time.perf_counter() - t0, 1)
        # nprobe=K == the dense flat packed scan at flagship geometry
        # (N=1M, D=1536, k=100): the "should a user use IVF here?" row
        for nprobe, pre in ((50, f"ivfpk_{lname}_np50"),
                            (200, f"ivfpk_{lname}_np200"),
                            (kcl, f"flat_{lname}")):
            mk.ivf_cfg = dataclasses.replace(mk.ivf_cfg, nprobe=nprobe)
            ids, _ = mk.search_with_scores(qg, k=100)
            _, wall, _ = _served(
                lambda: mk.search_with_scores(qg, k=100), reps=3)
            out[f"{pre}_qps"] = round(nq / wall, 1)
            out[f"{pre}_tiles_frac"] = round(
                mk.last_tiles_scanned / nb_total, 3)
            for kk in (1, 10, 100):
                out[f"{pre}_recall{kk}"] = round(recall_at_k(gt, ids, kk), 4)
        if lname == "saq_bpd2":
            mk_bpd2 = mk
        else:
            del mk

    # batch-size × probe-coherent-grouping sweep (where probing beats
    # dense).  Same index, same k; per-cell QPS, tile-scan fraction
    # (grouped = Σ_g tiles_g / nb — traffic vs ONE dense pass), recall@100
    # vs the batch-restricted GT.
    if mk_bpd2 is not None:
        for bs in (8, 64, 256):
            qb = qg[:bs]
            gtb = gt[:bs]
            cells = [("flat", kcl, 1), ("np50", 50, 1), ("np200", 200, 1)]
            if bs >= 64:
                cells += [("np50", 50, bs // 16), ("np200", 200, bs // 16)]
            for cname, nprobe, ng in cells:
                mk_bpd2.ivf_cfg = dataclasses.replace(
                    mk_bpd2.ivf_cfg, nprobe=nprobe)
                ids, _ = mk_bpd2.search_with_scores(
                    qb, k=100, query_groups=ng)
                _, wall, _ = _served(
                    lambda: mk_bpd2.search_with_scores(
                        qb, k=100, query_groups=ng), reps=3)
                gtag = f"_g{ng}" if ng > 1 else ""
                pre = f"ivfpk_bs{bs}_{cname}{gtag}"
                out[f"{pre}_qps"] = round(bs / wall, 1)
                out[f"{pre}_tiles_frac"] = round(
                    mk_bpd2.last_tiles_scanned / nb_total, 3)
                out[f"{pre}_recall100"] = round(
                    recall_at_k(gtb, ids, 100), 4)
        del mk_bpd2
    del xg, qg


def main() -> None:
    import jax
    import jax.numpy as jnp

    from vq_tpu.cli import _enable_compilation_cache

    _enable_compilation_cache()

    fast = os.environ.get("VQ_BENCH_FAST", "") == "1"
    out = device_info()
    xd, qd, gt = headline_pq(jax, jnp, out)
    del xd, qd
    gate_ok = recall_gate_pq192(jax, jnp, out)
    packed_saq_1m(jax, jnp, out, fast)
    packed_rabitq_1m(jax, jnp, out, fast)
    ivf_flagship(jax, jnp, out, fast)

    # full results → a git-ignored file; stdout's FINAL line stays a
    # compact headline that fits a tail capture
    self_path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                             "results", "bench.json")
    os.makedirs(os.path.dirname(self_path), exist_ok=True)
    with open(self_path, "w") as f:
        json.dump(out, f, indent=1, sort_keys=True)
        f.write("\n")
    print(f"full results ({len(out)} fields) -> {self_path}",
          file=sys.stderr)
    compact_keys = (
        "metric", "value", "unit", "vs_baseline", "value_median",
        "recall_at_10", "recall_gate_pq192", "saq_packed_qps",
        "ivfpk_saq_bpd2_np200_qps", "ivfpk_saq_bpd2_np200_recall100",
        "flat_saq_bpd2_qps", "flat_saq_bpd2_recall100", "platform",
        "device_kind", "device_count", "card", "power_limit",
    )
    compact = {k_: out[k_] for k_ in compact_keys if k_ in out}
    compact["full_results"] = "results/bench.json"
    print(json.dumps(compact))
    if not gate_ok:
        print(
            f"FATAL: recall gate pq192 {out['recall_gate_pq192']} < "
            f"{RECALL_GATE_PQ192_FLOOR}",
            file=sys.stderr,
        )
        sys.exit(1)


if __name__ == "__main__":
    main()
