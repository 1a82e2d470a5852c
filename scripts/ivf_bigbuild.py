#!/usr/bin/env python
"""10M-row IVF construction on one device.

The chunked build (index/ivf.fit: host-sample coarse k-means, streamed
assignment, streamed cluster-ordered residual encode) keeps peak device
memory at one chunk, not the corpus.  This script runs it at 10M×1024 —
41 GB of f32 input — streaming from a virtual corpus that generates rows on demand (the
tests/test_bigfit.py VirtualRows pattern, so no 41 GB host buffer either).

Reference envelope for contrast: 1M rows build in 12 GB CPU RAM
(README.md:222-228); 53M streams in chunks (streaming_sweep.py:151-186).

Prints one JSON line per stage.  VQ_FAST=1 shrinks to 1M rows.
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
from vq_tpu.methods.saq import SAQ
from vq_tpu.metrics.recall import recall_at_k


class ClusteredVirtualRows:
    """N×D corpus generated on demand ON DEVICE: hash noise around KC
    planted centroids (gives the coarse k-means real structure without
    ever materializing the corpus).  __getitem__ returns jax arrays — the
    chunked-build helpers (index/ivf._take_rows, chunked_assign,
    data/sampling.host_sample_rows) consume those without a host round
    trip.  Host-side generation is a non-starter on this machine: the
    hash+fma alone measured ~25 s per 131k×1024 numpy chunk (~95 min of
    pure generation for three 10M passes)."""

    def __init__(self, n, d, kc=4096, seed=3):
        self.shape = (n, d)
        self.dtype = np.float32
        cents = jax.random.normal(jax.random.PRNGKey(seed), (kc, d),
                                  jnp.float32)
        self.kc = kc

        @jax.jit
        def gen(idx):
            h = (idx.astype(jnp.uint32) * jnp.uint32(2654435761))[:, None]
            h = h + (jnp.arange(d, dtype=jnp.uint32)
                     * jnp.uint32(2246822519))
            noise = (h & jnp.uint32(1023)).astype(jnp.float32) / 1024.0 - 0.5
            return cents[idx % kc] * 0.3 + noise

        self._gen = gen

    def __len__(self):
        return self.shape[0]

    def _make(self, idx):
        return self._gen(jnp.asarray(np.asarray(idx).reshape(-1)))

    def __getitem__(self, key):
        if isinstance(key, slice):
            start, stop, step = key.indices(self.shape[0])
            return self._make(np.arange(start, stop, step))
        if isinstance(key, (np.ndarray, list)):
            return self._make(np.asarray(key))
        raise TypeError(f"unsupported index {key!r}")

    def __array__(self, *a, **k):
        raise MemoryError("full materialization of the virtual corpus")


def main():
    _enable_compilation_cache()
    fast = os.environ.get("VQ_FAST", "") == "1"
    n = int(os.environ.get("VQ_BIGBUILD_N", 0)) or (
        1_048_576 if fast else 10_000_000)
    d, kcl = 1024, 4096
    if n <= 131_072:  # CPU shape-smoke
        kcl = 256
    x = ClusteredVirtualRows(n, d, kc=kcl)

    quant = SAQ(SAQConfig(bits_per_dim=1.0, use_pca=True))
    idx = IvfQuantizedIndex(
        quant,
        IVFConfig(num_clusters=kcl, nprobe=50,
                  kmeans=KMeansConfig(iters=10, max_points_per_centroid=64)),
    )
    # stage-timed build (same code path as fit(); bench-style coarse reuse)
    from vq_tpu.data.sampling import chunk_rows_for_bytes, host_sample_rows
    from vq_tpu.index.ivf import chunked_assign, fit_quantizer_on_residuals
    from vq_tpu.kernels.kmeans import kmeans

    kmc = idx.ivf_cfg.kmeans
    t_all = time.perf_counter()
    t0 = time.perf_counter()
    cap = min(n, max(200_000, kmc.max_points_per_centroid * kcl))
    xs = host_sample_rows(x, cap, kmc.seed)
    cents = kmeans(jax.random.PRNGKey(kmc.seed),
                   jnp.asarray(xs, jnp.float32), kcl, kmc)
    cents.block_until_ready()
    del xs
    t_kmeans = time.perf_counter() - t0
    t0 = time.perf_counter()
    asn = chunked_assign(x, cents, chunk_rows_for_bytes(d))
    t_assign = time.perf_counter() - t0
    t0 = time.perf_counter()
    fit_quantizer_on_residuals(x, asn, cents, quant, seed=kmc.seed)
    t_qfit = time.perf_counter() - t0
    t0 = time.perf_counter()
    idx.fit(x, coarse=(cents, asn))
    t_encode = time.perf_counter() - t0
    build_s = time.perf_counter() - t_all
    print(json.dumps({
        "kmeans_s": round(t_kmeans, 1), "assign_s": round(t_assign, 1),
        "quant_fit_s": round(t_qfit, 1), "encode_install_s": round(t_encode, 1),
    }), flush=True)
    code_bytes = int(idx.codes_sorted.nbytes)  # no device→host transfer
    print(json.dumps({
        "n": n, "d": d, "K": kcl,
        "build_s": round(build_s, 1),
        "rows_per_s": round(n / build_s, 1),
        "codes_gb": round(code_bytes / 2**30, 2),
        "index_gb": round(idx.memory_footprint() / 2**30, 2),
    }), flush=True)

    # serving sanity: jittered copies of known rows must come back top-1
    nq = 256
    probe_ids = np.arange(0, n, n // nq)[:nq]
    q = x[probe_ids] + 0.01
    t0 = time.perf_counter()
    ids, _ = idx.search_with_scores(q, k=10)
    warm_s = time.perf_counter() - t0
    times = []
    for _ in range(3):
        t0 = time.perf_counter()
        ids, _ = idx.search_with_scores(q, k=10)
        times.append(time.perf_counter() - t0)
    top1 = float(np.mean(ids[:, 0] == probe_ids))
    print(json.dumps({
        "search_qps": round(nq / min(times), 1),
        "warm_s": round(warm_s, 1),
        "self_top1": round(top1, 4),
    }), flush=True)
    del idx

    # ---- probed-tile packed IVF at the SAME 10M build (round-5 task:
    # the operating point where probing must beat dense — at 10M a dense
    # packed pass streams ~1.3 GB of bitplanes per batch while nprobe=50
    # of K=4096 touches ~1.2% of rows).  Quality
    # signal: recall@100 against the nprobe=K row, which IS the dense
    # packed scan over the same codes (tests/test_ivf_packed.py
    # full-probe equality) — probing's loss is routing loss only.
    import dataclasses

    from vq_tpu.index.ivf_packed import IvfPackedFlatIndex
    from vq_tpu.metrics.recall import recall_at_k

    mkp = IvfPackedFlatIndex(
        SAQ(SAQConfig(bits_per_dim=1.0, use_pca=True)),
        IVFConfig(num_clusters=kcl, nprobe=50,
                  kmeans=KMeansConfig(iters=10, max_points_per_centroid=64)),
    )
    t0 = time.perf_counter()
    mkp.fit(x, coarse=(cents, asn))
    print(json.dumps({
        "ivfpk_build_s": round(time.perf_counter() - t0, 1),
        "ivfpk_cache_gb": round(mkp.memory_footprint() / 2**30, 2),
    }), flush=True)
    nb = -(-n // 512)
    for bs in (8, 256):
        qs = q[:bs]
        cells = [("flat", kcl, 1), ("np50", 50, 1), ("np200", 200, 1)]
        if bs >= 64:
            cells += [("np50_g", 50, bs // 16), ("np200_g", 200, bs // 16)]
        dense_ids = None
        for name, np_, ng in cells:
            mkp.ivf_cfg = dataclasses.replace(mkp.ivf_cfg, nprobe=np_)
            ids, _ = mkp.search_with_scores(qs, k=100, query_groups=ng)
            t0 = time.perf_counter()
            mkp.search_with_scores(qs, k=100, query_groups=ng)
            wall = time.perf_counter() - t0
            if name == "flat":
                dense_ids = ids
            print(json.dumps({
                "cell": f"ivfpk_bs{bs}_{name}" + (str(ng) if ng > 1 else ""),
                "qps": round(bs / wall, 1),
                "tiles_frac": round(mkp.last_tiles_scanned / nb, 4),
                "recall100_vs_dense": round(
                    recall_at_k(dense_ids, ids, 100), 4),
                "self_top1": round(float(np.mean(ids[:, 0]
                                                 == probe_ids[:bs])), 4),
            }), flush=True)


if __name__ == "__main__":
    main()
