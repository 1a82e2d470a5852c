#!/usr/bin/env python
"""RankAware α ablation at the gate corpus (BASELINE.md row:
rankaware_sweep.csv:2-3 — dbpedia bpd=2: recall@10 0.9454 at α=0.5 vs
0.9251 at α=0.0, i.e. the rank-aware objective beats pure-MSE greedy
allocation).  Same geometry here on the planted gate corpus (real
dataset egress-blocked): N=100k, D=1536, unit rows, 1024 queries.

Usage: python scripts/rankaware_alpha_ab.py   (VQ_FAST=1 shrinks)
"""

from __future__ import annotations

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main() -> None:
    import jax
    import jax.numpy as jnp
    import numpy as np

    import bench
    from vq_tpu.cli import _enable_compilation_cache
    from vq_tpu.core.config import Metric, RankAwareConfig, SearchConfig
    from vq_tpu.index.flat import FlatQuantizedIndex
    from vq_tpu.kernels.adc import exact_topk
    from vq_tpu.methods.rankaware import RankAware
    from vq_tpu.metrics.recall import recall_at_k

    _enable_compilation_cache()
    fast = os.environ.get("VQ_FAST", "") == "1"
    # the FULL-RANK power-law corpus — the planted rank-32 gate corpus is
    # quantization-insensitive (bpd 1 vs 4 measured identical there), so
    # an allocation ablation needs the discriminating spectrum the bpd
    # ladder was tuned on (bench.gen_fullrank_corpus)
    n = 32_768 if fast else 262_144
    d, nq = 1536, 256
    x, q = bench.gen_fullrank_corpus(jax, jnp, n, d, nq)
    x.block_until_ready()
    _, gt = exact_topk(q, x, k=100, metric=Metric.L2)
    gt = np.asarray(gt)
    for alpha in (0.0, 0.5):
        m = RankAware(RankAwareConfig(bits_per_dim=2.0, alpha=alpha,
                                      codebook="lloyd"))
        t0 = time.perf_counter()
        idx = FlatQuantizedIndex(m, SearchConfig()).fit(x)
        fit_s = time.perf_counter() - t0
        ids = idx.search(np.asarray(q), k=100)
        print(json.dumps({
            "alpha": alpha, "bpd": 2.0, "n": n,
            "fit_s": round(fit_s, 1),
            "recall10": round(recall_at_k(gt, ids, 10), 4),
            "recall100": round(recall_at_k(gt, ids, 100), 4),
        }), flush=True)
        del idx


if __name__ == "__main__":
    main()
