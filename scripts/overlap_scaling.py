#!/usr/bin/env python
"""Measure sharded-scan scaling 1→8 devices and the overlapped-merge mode.

Runs `dist/sharded.py::sharded_scan_topk` over a virtual CPU mesh at
n_devices ∈ {1, 2, 4, 8} with overlap_chunks ∈ {1, 8} and prints a
markdown table of ms/scan (fixed TOTAL corpus, so ideal scaling halves the
time per doubling).  The virtual devices timeshare one host CPU, so
absolute throughput scaling is not observable here — what this measures is
(a) the sharded program compiles and runs at every width, (b) the
relative cost of the merge strategy: per-chunk all_gather (overlap mode)
vs one post-scan gather, at the same total work.  On real devices joined
by a fast interconnect the per-chunk gathers hide behind the next chunk's scan; on the
shared-core CPU mesh they can only add overhead, so overlap≈dense here is
the pass criterion (the collective is not serializing the scan).

Usage: XLA_FLAGS=--xla_force_host_platform_device_count=8 \
       python scripts/overlap_scaling.py [--n 262144] [--q 64]
"""

from __future__ import annotations

import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main() -> None:
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_num_cpu_devices", 8)

    import jax.numpy as jnp

    from vq_tpu.core.config import Metric
    from vq_tpu.dist.mesh import make_mesh, replicate, shard_rows
    from vq_tpu.dist.sharded import sharded_scan_topk

    args = sys.argv[1:]

    def _get(flag, default):
        return int(args[args.index(flag) + 1]) if flag in args else default

    n, nq, d, m, k = _get("--n", 262_144), _get("--q", 64), 512, 16, 10
    rng = np.random.default_rng(0)
    codes_np = rng.integers(0, 256, (n, m)).astype(np.uint8)
    cb_np = rng.standard_normal((m, 256, d // m)).astype(np.float32)
    q_np = rng.standard_normal((nq, d)).astype(np.float32)

    print(f"| devices | overlap_chunks | ms/scan | ids == dense |")
    print("|---|---|---|---|")
    ref_ids = None
    for ndev in (1, 2, 4, 8):
        mesh = make_mesh(ndev)
        codes = shard_rows(mesh, jnp.asarray(codes_np))
        cb = replicate(mesh, jnp.asarray(cb_np))
        q = replicate(mesh, jnp.asarray(q_np))
        for chunks in (1, 8):
            def run():
                s, i = sharded_scan_topk(
                    mesh, q, codes, cb, k, Metric.L2, tile_rows=4096,
                    overlap_chunks=chunks,
                )
                return np.asarray(s), np.asarray(i)

            run()  # compile
            best = float("inf")
            for _ in range(3):
                t0 = time.perf_counter()
                _, ids = run()
                best = min(best, time.perf_counter() - t0)
            if ref_ids is None:
                ref_ids = ids
            same = bool(np.array_equal(ids, ref_ids))
            print(f"| {ndev} | {chunks} | {best*1e3:.1f} | {same} |",
                  flush=True)


if __name__ == "__main__":
    main()
