#!/usr/bin/env python
"""Flat SAQ scan strategies on one device: the packed scan
(kernels/packed.py over a PackedCorpus) vs the code-row scan
(methods/saq.scan_topk over the stored byte rows) vs the code-row
head-segment prune+rerank cascade, at N rows, D dims, bpd bits/dim.

The corpus is an iid power-law gaussian generated on the device in chunks;
plan/params are fit once per bpd on a 131k sample.  Each strategy is timed
as one served call (a jitted scan ended by block_until_ready), warm, as
the median of --reps calls; quality is top-10 overlap vs the packed scan.
One line per strategy is printed with the device name.

Usage: python scripts/saq_scan_bench.py [--n 1048576] [--d 1536]
       [--bpd 2] [--nq 256] [--reps 10] [--no-cascade]
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def time_call(fn, reps):
    """Median seconds of `reps` warm calls, each ended by
    block_until_ready; the first (compiling) call is returned separately."""
    import jax

    t0 = time.perf_counter()
    out = jax.block_until_ready(fn())
    first = time.perf_counter() - t0
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn())
        times.append(time.perf_counter() - t0)
    return out, float(np.median(times)), first


def main() -> None:
    import jax
    import jax.numpy as jnp

    from vq_tpu.cli import _enable_compilation_cache
    from vq_tpu.core.config import Metric, SAQConfig
    from vq_tpu.kernels.adc import _finalize
    from vq_tpu.methods import saq as saq_mod

    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=1_048_576)
    ap.add_argument("--d", type=int, default=1536)
    ap.add_argument("--bpd", type=float, default=2.0)
    ap.add_argument("--nq", type=int, default=256)
    ap.add_argument("--k", type=int, default=10)
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--no-cascade", action="store_true")
    args = ap.parse_args()
    _enable_compilation_cache()

    n, d, nq, k = args.n, args.d, args.nq, args.k
    dev = jax.devices()[0]
    sigma = jnp.asarray(((1.0 + np.arange(d)) ** -0.6).astype(np.float32))

    def gen_chunk(seed, rows):
        return jax.random.normal(
            jax.random.PRNGKey(seed), (rows, d), jnp.float32) * sigma

    cfg = SAQConfig(bits_per_dim=args.bpd, use_pca=True)
    m = saq_mod.SAQ(cfg)
    m._dim = d
    m.plan, m.params = saq_mod.fit(jax.random.PRNGKey(0),
                                   gen_chunk(7, 131_072), cfg)
    enc = jax.jit(lambda x: saq_mod.encode(m.plan, m.params, x))
    chunk = 131_072
    code_chunks = []
    q = None
    for i0 in range(0, n, chunk):
        x = gen_chunk(100 + i0, min(chunk, n - i0))
        if q is None:
            qi = jax.random.randint(jax.random.PRNGKey(3), (nq,), 0,
                                    x.shape[0])
            q = x[qi] + 0.1 * sigma * jax.random.normal(
                jax.random.PRNGKey(4), (nq, d), jnp.float32)
        code_chunks.append(enc(x))
        del x
    codes = jnp.concatenate(code_chunks, axis=0)
    del code_chunks
    cache = m.prepare_tile_cache(codes)
    jax.block_until_ready(cache.factors)
    q_sq = jnp.sum(q * q, axis=-1)

    @jax.jit
    def packed(q, cache):
        s, i = m.packed_scan_raw(q, cache, k, Metric.L2)
        return _finalize(s, i, Metric.L2, q_sq)

    @jax.jit
    def code_row(q, codes):
        return saq_mod.scan_topk(m.plan, m.params, q, codes, k, Metric.L2)

    @jax.jit
    def cascade(q, codes):
        return saq_mod.scan_topk(m.plan, m.params, q, codes, k, Metric.L2,
                                 prune_segments=1, rerank_factor=12)

    rows = [("packed", lambda: packed(q, cache)),
            ("code-row", lambda: code_row(q, codes))]
    if not args.no_cascade:
        rows.append(("code-row head-prune+rerank", lambda: cascade(q, codes)))
    ref = None
    for name, fn in rows:
        (s, ids), t, first = time_call(fn, args.reps)
        ids = np.asarray(ids)
        if ref is None:
            ref = ids
        ov = np.mean([len(set(ids[j]) & set(ref[j])) / k for j in range(nq)])
        print(f"saq_scan {name}: N={n} D={d} bpd={args.bpd:g} Q={nq} k={k} "
              f"median_s={t:.6f} first_call_s={first:.3f} qps={nq / t:.1f} "
              f"overlap_vs_packed={ov:.4f} device={dev.device_kind}",
              flush=True)


if __name__ == "__main__":
    main()
