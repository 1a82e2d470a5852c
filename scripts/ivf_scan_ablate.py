#!/usr/bin/env python
"""IVF list-scan strategy ablation on one device ("test the ivf.py design
note instead of asserting it").

At the flagship shape (D=1536, K=4096, nprobe ∈ {50, 200}, SAQ bpd=2,
N=1M gate-structured corpus) measures:

  decode     — the decode_fn window scan (r3's only path): every probed
               window pays the quantizer's seg+PCA un-rotation matmuls.
  scorer     — the rotated-query window scan (methods/base.residual_scorer):
               queries/centroids rotate into code space once, windows only
               dequantize.  Same scores (f32 op order aside).
  flat_packed — NO IVF: the dense packed scan over a flat-encoded corpus
               — the baseline any probing strategy must beat at batch
               sizes.

Also sweeps the query batch (8 / 64 / 256) since probing's win regime is
small batches: a batched IVF scan approaches a dense scan's work while a
dense scan amortizes all queries in one matmul per tile.

Prints one JSON line per cell.
"""

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import jax.numpy as jnp
import numpy as np

from vq_tpu.cli import _enable_compilation_cache
from vq_tpu.core.config import IVFConfig, KMeansConfig, Metric, SAQConfig
from vq_tpu.index.ivf import IvfQuantizedIndex
from vq_tpu.kernels.adc import _finalize, exact_topk
from vq_tpu.methods import saq as saq_mod
from vq_tpu.metrics.recall import recall_at_k


def gen_gate(n, d, nq, rank=None, csize=100, spread=1.0, seed=11):
    """Planted-neighborhood corpus at FULL intrinsic rank by default — the
    rank-32 gate variant is quantization-insensitive (see bench.py
    ivf_flagship docstring).  Blocked
    generation (bench.gen_fullrank_corpus) so z and x never coexist."""
    from bench import gen_fullrank_corpus

    return gen_fullrank_corpus(jax, jnp, n, d, nq, rank=rank, csize=csize,
                               spread=spread, seed=seed)


def timed(fn, reps=3):
    fn()  # warm
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        times.append(time.perf_counter() - t0)
    return min(times)


def main():
    _enable_compilation_cache()
    fast = os.environ.get("VQ_FAST", "") == "1"
    n = 131_072 if fast else 1_048_576
    d, nq_max = 1536, 256
    kcl = 1024 if fast else 4096

    x, q_all = gen_gate(n, d, nq_max)
    x.block_until_ready()
    _, gt = exact_topk(q_all, x, k=10, metric=Metric.L2)
    gt = np.asarray(gt)

    quant = saq_mod.SAQ(SAQConfig(bits_per_dim=2.0, use_pca=True))
    idx = IvfQuantizedIndex(
        quant,
        IVFConfig(num_clusters=kcl, nprobe=200,
                  kmeans=KMeansConfig(iters=10, max_points_per_centroid=64)),
    )
    t0 = time.perf_counter()
    idx.fit(x)
    print(json.dumps({"build_s": round(time.perf_counter() - t0, 1),
                      "n": n, "K": kcl}), flush=True)

    # flat-encoded corpus for the dense packed baseline (encode in chunks)
    enc = jax.jit(lambda xx: saq_mod.encode(quant.plan, quant.params, xx))
    codes_flat = jnp.concatenate(
        [enc(x[i0:i0 + 131_072]) for i0 in range(0, n, 131_072)])
    cache = saq_mod.prepare_packed(quant.plan, quant.params, codes_flat)

    import dataclasses

    for nq in (8, 64, 256):
        q = q_all[:nq]
        gtq = gt[:nq]
        for nprobe in (50, 200):
            idx.ivf_cfg = dataclasses.replace(idx.ivf_cfg, nprobe=nprobe)

            def run_union():
                return idx.search_with_scores(q, k=10, strategy="union")

            def run_windows():
                return idx.search_with_scores(q, k=10, strategy="windows")

            ids, _ = run_union()
            r10 = recall_at_k(gtq, ids, 10)
            t_union = timed(run_union)
            t_windows = timed(run_windows)

            # force decode_fn windows on the same index
            orig = quant.residual_scorer
            quant.residual_scorer = lambda: None
            idx._search_fn = None
            idx._c_side = None
            t_decode = timed(run_windows)
            quant.residual_scorer = orig
            idx._search_fn = None
            idx._c_side = None

            print(json.dumps({
                "nq": nq, "nprobe": nprobe,
                "ivf_recall10": round(r10, 4),
                "ivf_union_ms": round(t_union * 1e3, 1),
                "ivf_windows_ms": round(t_windows * 1e3, 1),
                "ivf_decode_ms": round(t_decode * 1e3, 1),
                "ivf_union_qps": round(nq / t_union, 1),
            }), flush=True)

        # dense packed flat scan (full corpus, exact over the quantization)
        def run_flat():
            s, i = quant.packed_scan_raw(q, cache, 10, Metric.L2)
            s, i = _finalize(s, i, Metric.L2, jnp.sum(q * q, axis=-1))
            return np.asarray(i)

        ids_f = run_flat()
        t_flat = timed(run_flat)
        print(json.dumps({
            "nq": nq, "flat_packed_ms": round(t_flat * 1e3, 1),
            "flat_packed_qps": round(nq / t_flat, 1),
            "flat_recall10": round(recall_at_k(gtq, ids_f, 10), 4),
        }), flush=True)


if __name__ == "__main__":
    main()
