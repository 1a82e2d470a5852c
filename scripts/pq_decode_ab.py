#!/usr/bin/env python
"""PQ scan decode A/B on one device: the gather decode that
kernels/adc.scan_codes_topk uses (codebook rows taken by code) vs a one-hot
× codebook einsum decode, both inside the same streaming top-k scan.

Random codes and codebooks (timing does not depend on their values) at
N rows, D dims, M subquantizers of K=256 entries; Q queries, k=10, bf16
scoring.  Each variant is timed as the median of --reps warm calls ended by
block_until_ready.  The two variants' ids are compared as a check.

Usage: python scripts/pq_decode_ab.py [--n 1048576] [--d 1536]
       [--m 16,192] [--nq 256] [--reps 10]
"""

from __future__ import annotations

import argparse
import functools
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from saq_scan_bench import time_call  # noqa: E402


def main() -> None:
    import jax
    import jax.numpy as jnp

    from vq_tpu.cli import _enable_compilation_cache
    from vq_tpu.core.config import Metric
    from vq_tpu.kernels.adc import (
        _bf16_supported, _finalize, _streaming_topk, scan_codes_topk)

    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=1_048_576)
    ap.add_argument("--d", type=int, default=1536)
    ap.add_argument("--m", default="16,192")
    ap.add_argument("--nq", type=int, default=256)
    ap.add_argument("--reps", type=int, default=10)
    args = ap.parse_args()
    _enable_compilation_cache()
    n, d, nq, k, kk, tile = args.n, args.d, args.nq, 10, 256, 16384
    dev = jax.devices()[0]

    @functools.partial(jax.jit, static_argnames=("k",))
    def onehot_scan(queries, codes, codebooks, k):
        m, _, dsub = codebooks.shape
        dt = jnp.bfloat16 if _bf16_supported() else jnp.float32
        cb = codebooks.astype(dt)
        qd = queries.astype(dt)
        q_sq = jnp.sum(queries * queries, axis=-1)
        codes_p = jnp.pad(codes, ((0, (-n) % tile), (0, 0)))

        def score_tile(start):
            ct = jax.lax.dynamic_slice_in_dim(codes_p, start, tile, axis=0)
            onehot = jax.nn.one_hot(ct, kk, dtype=dt)
            dec = jnp.einsum("tmk,mkd->tmd", onehot, cb,
                             preferred_element_type=jnp.float32
                             ).reshape(tile, m * dsub)
            ip = jnp.dot(qd, dec.astype(dt).T,
                         preferred_element_type=jnp.float32)
            s = 2.0 * ip - jnp.sum(dec * dec, axis=-1)[None, :]
            col = start + jnp.arange(tile)[None, :]
            return jnp.where(col < n, s, -jnp.inf)

        s, i = _streaming_topk(score_tile, n, queries.shape[0], k, tile)
        return _finalize(s, i, Metric.L2, q_sq)

    for m in [int(v) for v in args.m.split(",")]:
        kq, kc, kb = jax.random.split(jax.random.PRNGKey(m), 3)
        queries = jax.random.normal(kq, (nq, d), jnp.float32)
        codes = jax.random.randint(kc, (n, m), 0, kk).astype(jnp.uint8)
        cb = jax.random.normal(kb, (m, kk, d // m), jnp.float32)
        out = {}
        for name, fn in (
            ("gather", lambda: scan_codes_topk(queries, codes, cb, k=k,
                                               metric=Metric.L2)),
            ("one-hot", lambda: onehot_scan(queries, codes, cb, k=k)),
        ):
            (s, ids), t, first = time_call(fn, args.reps)
            out[name] = np.asarray(ids)
            print(f"pq_decode {name}: N={n} D={d} M={m} K={kk} Q={nq} k={k} "
                  f"median_s={t:.6f} first_call_s={first:.3f} "
                  f"qps={nq / t:.1f} device={dev.device_kind}", flush=True)
        same = np.mean(out["gather"] == out["one-hot"])
        print(f"pq_decode M={m}: id agreement gather vs one-hot {same:.4f}",
              flush=True)


if __name__ == "__main__":
    main()
