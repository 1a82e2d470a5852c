#!/usr/bin/env python
"""Union-scan serving-batch memory/time profile.

Round-4 weak #4: the union scan's L2 recompute materialized (Q, P, D)
(315 MB at Q=256, P=200, D=1536) and the one-block policy ran the whole
serving batch unclamped.  Round 5 bounds both (probe-slab recompute,
decode-budget block cap — index/ivf.py).  This profiles a 1024-query
batch at the flagship geometry (D=1536, K=4096, nprobe=200) through both
strategies and records wall time plus device peak-memory stats (when the
backend exposes them), with the corpus sized so the numbers are about
the SCAN working set, not the corpus residency.

Usage: python scripts/union_mem_profile.py   (VQ_FAST=1 shrinks)
"""

from __future__ import annotations

import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _mem(dev):
    try:
        s = dev.memory_stats()
        return {k: int(v) for k, v in s.items()
                if k in ("bytes_in_use", "peak_bytes_in_use")}
    except Exception:
        return {}


def main() -> None:
    import jax
    import jax.numpy as jnp

    import bench
    from vq_tpu.cli import _enable_compilation_cache
    from vq_tpu.core.config import IVFConfig, KMeansConfig, SAQConfig
    from vq_tpu.index.ivf import IvfQuantizedIndex
    from vq_tpu.methods.saq import SAQ

    _enable_compilation_cache()
    fast = os.environ.get("VQ_FAST", "") == "1"
    n = 65_536 if fast else 524_288
    d, kcl, nprobe, nq = 1536, (256 if fast else 4096), (16 if fast else 200), 1024

    x, q = bench.gen_fullrank_corpus(jax, jnp, n, d, nq)
    x.block_until_ready()
    dev = jax.devices()[0]

    idx = IvfQuantizedIndex(
        SAQ(SAQConfig(bits_per_dim=2.0, use_pca=True)),
        IVFConfig(num_clusters=kcl, nprobe=nprobe,
                  kmeans=KMeansConfig(iters=10, max_points_per_centroid=64)),
    )
    idx.fit(x)
    base = _mem(dev)
    for strategy in ("union", "windows"):
        idx._search_fn = None
        t0 = time.perf_counter()
        ids, _ = idx.search_with_scores(q, k=100, strategy=strategy)
        warm = time.perf_counter() - t0
        times = []
        for _ in range(3):
            t0 = time.perf_counter()
            ids, _ = idx.search_with_scores(q, k=100, strategy=strategy)
            times.append(time.perf_counter() - t0)
        after = _mem(dev)
        print(json.dumps({
            "strategy": strategy, "n": n, "K": kcl, "nprobe": nprobe,
            "num_queries": nq,
            "qps": round(nq / min(times), 1),
            "warm_s": round(warm, 1),
            "base_bytes_in_use": base.get("bytes_in_use"),
            "peak_bytes_in_use": after.get("peak_bytes_in_use"),
        }), flush=True)


if __name__ == "__main__":
    main()
