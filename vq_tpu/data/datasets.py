"""Dataset container and loaders.

Parity with the reference's data layer (src/haag_vq/data/datasets.py:36-105,
dbpedia_loader.py, cohere_msmarco_loader.py) with an on-device ground-truth
path: GT is the exact-scan kernel (kernels/adc.py `exact_topk`) instead of a
faiss IndexFlat (reference data/datasets.py:8-34,
benchmarks/precompute_ground_truth.py:14-129).

Real embedding datasets are consumed as .npy / .fvecs files pre-materialised
per host (the reference's scripts/prep_msmarco_bench.py pattern; SURVEY.md
§7.3 "53M ingestion").  HuggingFace streaming loaders are provided behind a
soft import in vq_tpu/data/hf_loaders.py.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import Dict, Optional

import jax.numpy as jnp
import numpy as np

from vq_tpu.core.config import Metric
from vq_tpu.data.io import load_fvecs, load_ivecs


@dataclass
class Dataset:
    """Vectors + queries + ground truth (reference data/datasets.py:36-76)."""

    name: str
    vectors: np.ndarray  # (N, D) float32
    queries: np.ndarray  # (nq, D) float32
    ground_truth: Optional[np.ndarray] = None  # (nq, k) int — best-first ids
    metric: Metric = Metric.L2
    gt_k: int = 100

    def __post_init__(self):
        self.vectors = np.asarray(self.vectors, dtype=np.float32)
        self.queries = np.asarray(self.queries, dtype=np.float32)
        if self.ground_truth is None and len(self.vectors) and len(self.queries):
            self.ground_truth = compute_ground_truth(
                self.vectors, self.queries, k=min(self.gt_k, len(self.vectors)),
                metric=self.metric,
            )

    @property
    def dim(self) -> int:
        return self.vectors.shape[1]

    @property
    def num_vectors(self) -> int:
        return self.vectors.shape[0]


def compute_ground_truth(
    vectors: np.ndarray,
    queries: np.ndarray,
    k: int = 100,
    metric: Metric = Metric.L2,
    batch_queries: int = 1024,
) -> np.ndarray:
    """Exact brute-force k-NN on device (replaces the reference's faiss GT,
    precompute_ground_truth.py:74-110).  Queries are batched so the scores
    buffer stays bounded at 53M-corpus scale."""
    xs = jnp.asarray(vectors, dtype=jnp.float32)
    out = np.empty((len(queries), k), dtype=np.int32)
    from vq_tpu.kernels.adc import exact_topk

    for start in range(0, len(queries), batch_queries):
        qb = jnp.asarray(queries[start : start + batch_queries], dtype=jnp.float32)
        _, idx = exact_topk(qb, xs, k, metric=metric)
        out[start : start + len(qb)] = np.asarray(idx)
    return out


def load_dummy_dataset(
    num_vectors: int = 10000,
    dim: int = 128,
    num_queries: int = 100,
    seed: int = 0,
    metric: Metric = Metric.L2,
    normalized: bool = False,
) -> Dataset:
    """Synthetic seeded Gaussian data — the reference's test/demo substrate
    (data/datasets.py:79-82 and every file in tests/)."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((num_vectors, dim), dtype=np.float32)
    q = rng.standard_normal((num_queries, dim), dtype=np.float32)
    if normalized:
        x /= np.linalg.norm(x, axis=1, keepdims=True)
        q /= np.linalg.norm(q, axis=1, keepdims=True)
    return Dataset(name=f"dummy-{num_vectors}x{dim}", vectors=x, queries=q, metric=metric)


def load_planted_dataset(
    num_vectors: int = 100_000,
    dim: int = 1536,
    num_queries: int = 1024,
    rank: int = 32,
    cluster_size: int = 10,
    spread: float = 0.5,
    seed: int = 0,
    metric: Metric = Metric.L2,
) -> Dataset:
    """Low-intrinsic-dimension corpus with planted near-duplicate
    neighborhoods: a rank-`rank` manifold in `dim` dimensions,
    N/cluster_size "documents" × cluster_size variants, unit-normalized
    rows; queries are fresh variants of random documents.

    This is the structure real embedding sets have, and the regime where
    the reference's dbpedia-level recall targets (~0.8 at 1 bit/dim) are
    actually reachable — iid gaussians at D≳1000 have no usable neighbor
    structure (bench.py recall_gate_pq192 docstring; real datasets need a
    download).  Generated on
    device; bit-stable for a given (shape, seed)."""
    import jax.random as jrandom

    kc = max(1, num_vectors // cluster_size)
    ks = jrandom.split(jrandom.PRNGKey(seed + 11), 6)

    a = jrandom.normal(ks[0], (rank, dim), jnp.float32)
    a = a * ((1.0 + jnp.arange(dim)) ** -0.5)
    cents = jrandom.normal(ks[1], (kc, rank), jnp.float32)
    asn = jnp.arange(num_vectors) % kc
    z = cents[asn] + spread * jrandom.normal(
        ks[3], (num_vectors, rank), jnp.float32)
    qdoc = jrandom.randint(ks[4], (num_queries,), 0, kc)
    zq = cents[qdoc] + spread * jrandom.normal(
        ks[5], (num_queries, rank), jnp.float32)
    x, q = z @ a, zq @ a
    x = x / jnp.linalg.norm(x, axis=1, keepdims=True)
    q = q / jnp.linalg.norm(q, axis=1, keepdims=True)
    return Dataset(
        name=f"planted-{num_vectors}x{dim}",
        vectors=np.asarray(x),
        queries=np.asarray(q),
        metric=metric,
    )


def load_npy_dataset(
    base_path: str,
    query_path: Optional[str] = None,
    gt_path: Optional[str] = None,
    name: Optional[str] = None,
    num_queries: int = 1000,
    metric: Metric = Metric.L2,
) -> Dataset:
    """.npy corpus (+ optional queries/GT). Without a query file the last
    `num_queries` rows are split off as queries (reference
    benchmarks/ivf_benchmark.py:32-57 fallback)."""
    base = np.load(base_path, mmap_mode="r")
    if query_path:
        queries = np.load(query_path)
        vectors = np.asarray(base, dtype=np.float32)
    else:
        vectors = np.asarray(base[:-num_queries], dtype=np.float32)
        queries = np.asarray(base[-num_queries:], dtype=np.float32)
    gt = np.load(gt_path) if gt_path else None
    return Dataset(
        name=name or os.path.basename(base_path),
        vectors=vectors,
        queries=np.asarray(queries, dtype=np.float32),
        ground_truth=gt,
        metric=metric,
    )


def load_fvecs_dataset(
    base_path: str,
    query_path: str,
    gt_path: Optional[str] = None,
    name: Optional[str] = None,
    metric: Metric = Metric.NIP,
) -> Dataset:
    """fvecs base/query pair — the study pipeline's input format (reference
    benchmarks/quantizer_study.py:95-106)."""
    vectors = load_fvecs(base_path)
    queries = load_fvecs(query_path)
    gt = load_ivecs(gt_path) if gt_path else None
    return Dataset(
        name=name or os.path.basename(base_path),
        vectors=vectors,
        queries=queries,
        ground_truth=gt,
        metric=metric,
    )


# Registry of named datasets (reference sweep.py dataset dispatch,
# sweep.py:129-161). Entries resolve lazily; real datasets look for
# pre-materialised files under $VQ_DATA_DIR.
def get_dataset(name: str, data_dir: Optional[str] = None, **kw) -> Dataset:
    data_dir = data_dir or os.environ.get("VQ_DATA_DIR", "data")
    if name in ("dummy", "demo_sweep"):
        return load_dummy_dataset(**kw)
    if name.startswith("dummy-"):  # e.g. dummy-20000x256
        n, d = name.split("-", 1)[1].split("x")
        return load_dummy_dataset(num_vectors=int(n), dim=int(d), **kw)
    if name.startswith("planted-"):  # e.g. planted-100000x1536
        n, d = name.split("-", 1)[1].split("x")
        return load_planted_dataset(num_vectors=int(n), dim=int(d), **kw)
    # dbpedia-100k / dbpedia-1m / dbpedia-3072 / msmarco-* resolve to files
    candidates = [
        (os.path.join(data_dir, f"{name}_base.npy"), os.path.join(data_dir, f"{name}_query.npy")),
        (os.path.join(data_dir, name, "base.npy"), os.path.join(data_dir, name, "query.npy")),
        (os.path.join(data_dir, name, "base.fvecs"), os.path.join(data_dir, name, "query.fvecs")),
    ]
    for base, query in candidates:
        if os.path.exists(base):
            q = query if os.path.exists(query) else None
            gt_npy = base.replace("base", "gt").replace(".fvecs", ".npy")
            gt = gt_npy if os.path.exists(gt_npy) else None
            if base.endswith(".fvecs"):
                return load_fvecs_dataset(base, query, gt_path=gt, name=name, **kw)
            return load_npy_dataset(base, query_path=q, gt_path=gt, name=name, **kw)
    raise FileNotFoundError(
        f"dataset {name!r}: no files found under {data_dir} "
        f"(expected {name}_base.npy / {name}/base.npy / {name}/base.fvecs); "
        f"use scripts to pre-materialise, or the 'dummy' datasets"
    )
