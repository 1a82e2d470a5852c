#!/usr/bin/env python
"""Shared vs per-cluster residual quantizer A/B.

The reference's IvfQuantizedIndex fits one quantizer PER CLUSTER
(src/haag_vq/methods/search/ivf_quantized_index.py:59-74) and the engine
derives per-cluster data (ivf_index.cpp:156-170); vq_tpu fits ONE shared
quantizer on pooled residuals (replicated codebooks, one
compiled scan).  This measures the recall cost of that choice on the gate
corpus: build both variants at the same geometry and compare
recall@1/10/100 against exact GT.

Per-cluster search here is measurement-only (python loop over clusters,
decompress + exact rescoring) — the point is the QUALITY delta, not QPS.

Usage: python scripts/percluster_ab.py  (VQ_FAST=1 shrinks shapes)
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
from vq_tpu.core.config import (
    IVFConfig,
    KMeansConfig,
    Metric,
    PQConfig,
    SAQConfig,
)
from vq_tpu.index.ivf import IvfQuantizedIndex
from vq_tpu.kernels.adc import exact_topk
from vq_tpu.kernels.kmeans import assign, kmeans
from vq_tpu.methods.pq import PQ
from vq_tpu.methods.saq import SAQ
from vq_tpu.metrics.recall import recall_at_k

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from ivf_scan_ablate import gen_gate  # noqa: E402


def _pad_cycle(rows: np.ndarray, bucket: int) -> np.ndarray:
    """Cycle rows up to a pow2 bucket size so per-cluster ENCODES hit only
    ~log2 distinct jit shapes instead of one compile PER CLUSTER.
    Duplicated rows encode/decode identically and are sliced off — used
    only for compress/decompress; FITS use an unbiased floor-bucket
    subsample instead (cycling into a fit would double-weight the partial
    tail's rows and bias the codebook statistics)."""
    reps = -(-bucket // len(rows))
    return np.tile(rows, (reps,) + (1,) * (rows.ndim - 1))[:bucket]


def per_cluster_search(x, q, gt, kcl, nprobe, make_quant, kq=100):
    """Reference-style per-cluster-quantizer IVF: fit one quantizer per
    cluster, search by decompress + exact rescoring of probed lists."""
    n, d = x.shape
    cents = kmeans(jax.random.PRNGKey(0), x, kcl,
                   KMeansConfig(iters=10, max_points_per_centroid=64))
    asn = np.asarray(assign(x, cents))
    cents_np = np.asarray(cents)
    x_np = np.asarray(x)

    # fit + encode + decode per cluster (reference ivf_quantized_index
    # fit:45-84 semantics); shapes pow2-bucketed to bound compiles
    recon = np.empty_like(x_np)
    t0 = time.perf_counter()
    for c in range(kcl):
        rows = np.nonzero(asn == c)[0]
        if len(rows) == 0:
            continue
        res = x_np[rows] - cents_np[c]
        bucket = 1 << int(np.ceil(np.log2(max(2, len(rows)))))
        fit_n = 1 << int(np.floor(np.log2(max(2, len(rows)))))
        quant = make_quant()
        quant.fit(res[:fit_n])  # unbiased pow2 subsample
        rec_p = quant.decompress(quant.compress(_pad_cycle(res, bucket)))
        recon[rows] = rec_p[: len(rows)] + cents_np[c]
    fit_s = time.perf_counter() - t0

    # probed exact search over per-cluster reconstructions (candidate
    # lists pow2-bucketed too; pad slots masked to +inf distance)
    qn = np.asarray(q)
    cd = np.asarray(
        jnp.sum((jnp.asarray(qn)[:, None, :] - cents[None]) ** 2, axis=-1)
    )
    probes = np.argsort(cd, axis=1)[:, :nprobe]
    ids = np.zeros((len(qn), kq), np.int64)
    recon_j = jnp.asarray(recon)

    @jax.jit
    def cand_dists(recon_a, cand_idx, qi):
        # recon rides as an ARGUMENT, not a 600 MB constant baked into
        # the compiled program
        return jnp.sum((recon_a[cand_idx] - qi[None]) ** 2, axis=-1)

    for i in range(len(qn)):
        cand = np.concatenate([np.nonzero(asn == c)[0] for c in probes[i]])
        bucket = 1 << int(np.ceil(np.log2(max(2, len(cand)))))
        dc = np.array(cand_dists(recon_j,
                                 jnp.asarray(_pad_cycle(cand, bucket)),
                                 jnp.asarray(qn[i])))
        dc[len(cand):] = np.inf
        ids[i] = _pad_cycle(cand, bucket)[np.argsort(dc)[:kq]]
    return ids, fit_s


def main():
    _enable_compilation_cache()
    fast = os.environ.get("VQ_FAST", "") == "1"
    n = 20_000 if fast else 100_000
    d = 1536
    nq = 64 if fast else 128
    kcl = 16 if fast else 64
    nprobe = kcl // 4

    x, q = gen_gate(n, d, nq)
    _, gt = exact_topk(q, x, k=100, metric=Metric.L2)
    gt = np.asarray(gt)

    configs = [
        ("pq_m192", lambda: PQ(PQConfig(num_subquantizers=192, num_bits=8,
                                        kmeans=KMeansConfig(iters=8)))),
        ("saq_bpd2", lambda: SAQ(SAQConfig(bits_per_dim=2.0, use_pca=True))),
    ]
    for name, make in configs:
        # each config prints its shared leg IMMEDIATELY and isolates
        # errors — a failure in the measurement-only per-cluster leg must
        # not lose the whole run's output
        try:
            # shared (the vq_tpu design)
            idx = IvfQuantizedIndex(
                make(),
                IVFConfig(num_clusters=kcl, nprobe=nprobe,
                          kmeans=KMeansConfig(iters=10,
                                              max_points_per_centroid=64)),
            )
            t0 = time.perf_counter()
            idx.fit(x)
            shared_fit_s = time.perf_counter() - t0
            ids_s, _ = idx.search_with_scores(q, k=100)
            row = {"config": name, "K": kcl, "nprobe": nprobe, "n": n,
                   "shared_fit_s": round(shared_fit_s, 1)}
            for kk in (1, 10, 100):
                row[f"shared_recall{kk}"] = round(
                    recall_at_k(gt, ids_s, kk), 4)
            print(json.dumps({"partial": row}), flush=True)
            del idx

            # per-cluster (the reference design)
            ids_p, pc_fit_s = per_cluster_search(x, q, gt, kcl, nprobe,
                                                 make)
            row["percluster_fit_s"] = round(pc_fit_s, 1)
            for kk in (1, 10, 100):
                row[f"percluster_recall{kk}"] = round(
                    recall_at_k(gt, ids_p, kk), 4)
            print(json.dumps(row), flush=True)
        except Exception as e:  # per-config isolation
            print(json.dumps({"config": name,
                              "error": f"{type(e).__name__}: {e}"}),
                  flush=True)


if __name__ == "__main__":
    main()
