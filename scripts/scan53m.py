#!/usr/bin/env python
"""53M-row streaming PQ on ONE device — the reference's full-53M envelope.

The reference's full 53M MS MARCO streaming-PQ run is an 18–24 h / 12 GB
CPU job (reference README.md:222-228,345-352); its single-core ADC rate is
~2.4 M rows/s (bench/ffd_speed.cpp).  This script runs the same shape of
pipeline end to end on one device: stream-generate a 53M×1024
corpus in 131k-row chunks ON DEVICE (the real pipeline streams from disk;
generation stands in for IO so the measurement isolates the engine), fit
PQ M=16 B=8 on the first chunk, encode every chunk (only the 16-byte codes
stay resident — 848 MB at 53M), then run the streaming-top-k ADC scan over
all 53M rows.

Smoke-quality check: queries are jittered rows of the LAST chunk (whose
raw vectors we still hold); their true nearest neighbor is their source
row, so top-1 must recover the source global id for ≥95% of queries —
a correctness signal that needs no 217 GB ground-truth corpus.

Usage: python scripts/scan53m.py [--n 53000000] [--q 1024] [--method pq|saq]

--method saq: the same 53M envelope through the SAQ bpd=1 packed scan —
stream-encode chunks with the CAQ encoder, convert each chunk's byte rows
straight into the packed-word scan cache (the byte rows are FREED per
chunk, so peak residency is the 1-bit word planes ≈ 6.8 GB + factors, not
the 8.5 GB byte rows on top), then run the packed scan over all 53M rows.
Reference envelope README.md:222-228.
"""

from __future__ import annotations

import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _saq_53m(jax, jnp, gen_chunk, n, nq, d, k, chunk, sigma) -> None:
    """SAQ bpd=1 (uniform allocator → one 1-bit full-width segment) packed
    scan over the streamed corpus; per-chunk byte rows convert to the
    packed cache and are freed immediately."""
    import time

    from vq_tpu.core.config import Metric, SAQConfig
    from vq_tpu.kernels.adc import _finalize
    from vq_tpu.kernels.packed import PackedCorpus
    from vq_tpu.methods import saq as saq_mod

    import functools

    cfg = SAQConfig(bits_per_dim=1.0, allocator="uniform", use_pca=True)
    t0 = time.perf_counter()
    plan, params = saq_mod.fit(jax.random.PRNGKey(0), gen_chunk(0, chunk),
                               cfg)
    t_fit = time.perf_counter() - t0

    enc = jax.jit(lambda x: saq_mod.encode(plan, params, x))
    t0 = time.perf_counter()
    # Preallocate the full packed planes and fill them IN PLACE (buffer
    # donation): the previous accumulate-then-concatenate held all chunk
    # parts AND the concatenated result live — 2× the 6.8 GB 1-bit word
    # planes at 53M rows.
    n_pad = -(-n // 512) * 512
    first = saq_mod.prepare_packed(plan, params, enc(gen_chunk(0, chunk)))
    s_cnt = plan.num_segments
    u_list = [chunk // first.words[s].shape[0] for s in range(s_cnt)]
    words_bufs = [
        jnp.zeros((n_pad // u_list[s],) + first.words[s].shape[1:],
                  first.words[s].dtype)
        for s in range(s_cnt)
    ]
    # the skinny (N, 3) factor plane is assembled host-side (1.6 MB per
    # chunk) and put on the device once
    fac_np = np.zeros((n_pad,) + first.factors.shape[1:], np.float32)

    @functools.partial(jax.jit, donate_argnums=(0,))
    def put(buf, part, off):
        # off is a traced scalar: one compile per buffer shape, not per
        # chunk offset
        return jax.lax.dynamic_update_slice_in_dim(buf, part, off, 0)

    last_x = None
    for i0 in range(0, n, chunk):
        x = gen_chunk(i0, min(chunk, n - i0))
        pc = first if i0 == 0 else saq_mod.prepare_packed(
            plan, params, enc(x))
        for s in range(s_cnt):
            words_bufs[s] = put(words_bufs[s], pc.words[s],
                                i0 // u_list[s])
        rows_pad = pc.factors.shape[0]
        fac_np[i0 : i0 + rows_pad] = np.asarray(pc.factors)
        last_x, last_i0 = x, i0
        del pc  # byte rows freed per chunk — the 53M enabler
    first = None
    words = tuple(words_bufs)
    factors = jnp.asarray(fac_np)
    del fac_np
    cache = PackedCorpus(words=words, factors=factors, num_rows=n)
    factors.block_until_ready()
    t_encode = time.perf_counter() - t0

    qi = jax.random.randint(jax.random.PRNGKey(2), (nq,), 0, last_x.shape[0])
    q = last_x[qi] + 0.05 * sigma * jax.random.normal(
        jax.random.PRNGKey(3), (nq, d), jnp.float32)
    src_gid = np.asarray(qi) + last_i0
    del last_x

    @jax.jit
    def scan(qq, cache):
        # the cache is a jit argument, so nothing large is baked into the
        # compiled program
        s, i = saq_mod._packed_scan(plan, params, qq, cache, k, Metric.L2)
        return _finalize(s, i, Metric.L2, jnp.sum(qq * qq, axis=-1))

    ids = np.asarray(scan(q, cache)[1])
    top1 = float(np.mean(ids[:, 0] == src_gid))

    best = float("inf")
    for _ in range(3):
        t0 = time.perf_counter()
        jax.block_until_ready(scan(q, cache))
        best = min(best, time.perf_counter() - t0)

    code_bytes = sum(int(w.nbytes) for w in words) + int(factors.nbytes)
    print(json.dumps({
        "method": "saq_bpd1_packed",
        "n": n,
        "fit_s": round(t_fit, 1),
        "encode_s": round(t_encode, 1),
        "encode_rows_per_s": round(n / t_encode, 0),
        "scan_s_per_batch": round(best, 3),
        "qps_per_chip": round(nq / best, 1),
        "rows_scored_per_s": round(n * nq / best, 0),
        "top1_source_recovery": round(top1, 4),
        "packed_cache_bytes": code_bytes,
        "segments": [
            {"len": l, "bits": b}
            for l, b in zip(plan.seg_lens, plan.seg_bits)
        ],
    }))


def main() -> None:
    import jax
    import jax.numpy as jnp

    from vq_tpu.cli import _enable_compilation_cache
    from vq_tpu.core.config import KMeansConfig, Metric, PQConfig
    from vq_tpu.kernels.adc import scan_codes_topk
    from vq_tpu.methods import pq as pq_mod

    _enable_compilation_cache()

    args = sys.argv[1:]

    def _get(flag, default):
        return int(args[args.index(flag) + 1]) if flag in args else default

    n = _get("--n", 53_000_000)
    nq = _get("--q", 1024)
    method = args[args.index("--method") + 1] if "--method" in args else "pq"
    d, k, chunk = 1024, 10, 131_072
    sigma = jnp.asarray(((1.0 + np.arange(d)) ** -0.6).astype(np.float32))

    def gen_chunk(i0, rows):
        key = jax.random.PRNGKey(1000 + i0)
        return jax.random.normal(key, (rows, d), jnp.float32) * sigma

    if method == "saq":
        _saq_53m(jax, jnp, gen_chunk, n, nq, d, k, chunk, sigma)
        return

    t0 = time.perf_counter()
    cfg = PQConfig(num_subquantizers=16, num_bits=8,
                   kmeans=KMeansConfig(iters=15))
    params = pq_mod.fit(jax.random.PRNGKey(0), gen_chunk(0, chunk), cfg)
    t_fit = time.perf_counter() - t0

    enc = jax.jit(lambda x: pq_mod.encode(params, x))
    t0 = time.perf_counter()
    code_chunks = []
    last_x = None
    for i0 in range(0, n, chunk):
        x = gen_chunk(i0, min(chunk, n - i0))
        code_chunks.append(enc(x))
        last_x, last_i0 = x, i0
    codes = jnp.concatenate(code_chunks, axis=0)
    codes.block_until_ready()
    del code_chunks
    t_encode = time.perf_counter() - t0

    # queries: jittered rows of the last (still-resident) chunk
    qi = jax.random.randint(jax.random.PRNGKey(2), (nq,), 0, last_x.shape[0])
    q = last_x[qi] + 0.05 * sigma * jax.random.normal(
        jax.random.PRNGKey(3), (nq, d), jnp.float32)
    src_gid = np.asarray(qi) + last_i0
    del last_x

    tile = 16384
    ids = np.asarray(scan_codes_topk(
        q, codes, params.codebooks, k=k, metric=Metric.L2,
        tile_rows=tile, use_bf16=True)[1])
    top1 = float(np.mean(ids[:, 0] == src_gid))

    best = float("inf")
    for _ in range(3):
        t0 = time.perf_counter()
        jax.block_until_ready(scan_codes_topk(
            q, codes, params.codebooks, k=k, metric=Metric.L2,
            tile_rows=tile, use_bf16=True))
        best = min(best, time.perf_counter() - t0)

    print(json.dumps({
        "n": n,
        "fit_s": round(t_fit, 1),
        "encode_s": round(t_encode, 1),
        "encode_rows_per_s": round(n / t_encode, 0),
        "scan_s_per_batch": round(best, 3),
        "qps_per_chip": round(nq / best, 1),
        "rows_scored_per_s": round(n * nq / best, 0),
        "top1_source_recovery": round(top1, 4),
        "code_bytes_total": int(codes.nbytes),
    }))


if __name__ == "__main__":
    main()
