#!/usr/bin/env python
"""Study pipeline (Metric.NIP) at the flagship corpus.

Runs the study metric (normalized inner product, reference
exact_search.py:4-8) at the flagship geometry (N=1M, D=1536, the full-rank
power-law corpus of bench.gen_fullrank_corpus) through the flat scans,
recording recall@{1,10,100} and QPS per (method, bpd).

Method fits use a 131k sample (the engine trains codebooks on a ≤200k
sample, external/saq/src/ivf_index.cpp:55-86); encoding streams the corpus
through the device in chunks via encode_fn.

Usage: python scripts/study_nip_flagship.py   (VQ_FAST=1 shrinks to 131k)
"""

from __future__ import annotations

import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main() -> None:
    import jax
    import jax.numpy as jnp

    import bench
    from vq_tpu.bench.registry import build_quantizer
    from vq_tpu.bench.study import _study_params
    from vq_tpu.cli import _enable_compilation_cache
    from vq_tpu.core.config import Metric
    from vq_tpu.kernels.adc import exact_topk
    from vq_tpu.metrics.recall import recall_at_k

    _enable_compilation_cache()
    fast = os.environ.get("VQ_FAST", "") == "1"
    n = 131_072 if fast else 1_048_576
    d, nq, kmax = 1536, 256, 100

    x, q = bench.gen_fullrank_corpus(jax, jnp, n, d, nq)
    x.block_until_ready()
    norms = jnp.maximum(jnp.linalg.norm(x, axis=1), 1e-12)
    _, gt = exact_topk(q, x, k=kmax, metric=Metric.NIP, norms=norms)
    gt = np.asarray(gt)

    # bpd {1, 4, 8} mirror the reference study table's comparison points
    # (results_full_20260612_235308.csv: pq/ours/saq_paper at 1/4/8)
    grid = [("pq", 1.0), ("saq_paper", 1.0), ("saq_paper", 2.0),
            ("saq_paper", 4.0), ("saq_paper", 8.0), ("ours", 2.0),
            ("ours", 4.0)]
    if fast:
        grid = [("saq_paper", 2.0)]
    xs_fit = x[:131_072]
    chunk = 131_072
    for method, bpd in grid:
        base, params_kw = _study_params(method, bpd, d)
        model = build_quantizer(base, d, **params_kw)
        t0 = time.perf_counter()
        model.fit(xs_fit)
        fit_s = time.perf_counter() - t0

        enc = jax.jit(model.encode_fn())
        t0 = time.perf_counter()
        codes = jnp.concatenate(
            [enc(x[i0:i0 + chunk]) for i0 in range(0, n, chunk)], axis=0)
        codes.block_until_ready()
        enc_s = time.perf_counter() - t0

        scan = jax.jit(lambda q, codes, model=model: model.scan_topk(
            q, codes, kmax, Metric.NIP, norms=norms))
        _, ids = scan(q, codes)
        ids = np.asarray(ids)
        row = {
            "method": method, "bpd": bpd, "n": n, "metric": "NIP",
            "fit_s": round(fit_s, 1),
            "encode_s": round(enc_s, 1),
        }
        for kk in (1, 10, 100):
            row[f"recall{kk}"] = round(recall_at_k(gt, ids, kk), 4)

        best = float("inf")
        for _ in range(3):
            t0 = time.perf_counter()
            jax.block_until_ready(scan(q, codes))
            best = min(best, time.perf_counter() - t0)
        row["qps"] = round(nq / best, 1)
        print(json.dumps(row), flush=True)
        del model, codes


if __name__ == "__main__":
    main()
