"""vq_tpu — a vector-quantization engine and benchmarking framework.

Built from scratch in JAX/XLA with the capabilities of the
reference CPU framework ``Human-Augment-Analytics/vector-quantization``
(see SURVEY.md): five quantization families (PQ, OPQ, SQ, SAQ, RaBitQ /
Extended RaBitQ, plus LVQ / RankAware / FFD parity variants), flat and IVF
search indexes with fused ADC/LUT distance scans, a sweep harness with
recall@k / MSE / pairwise & rank distortion / compression / QPS metrics,
SQLite run logging, and multi-host corpus sharding over a `jax.sharding.Mesh`.

Layout (SURVEY.md §7.1):
    core/     array types, packed-code layouts, dataclass configs
    kernels/  device compute: batched k-means, ADC scan + top-k, the packed
              per-dimension-code scan, 1-D Lloyd codebooks, CAQ encode
    methods/  the quantization schemes as pure functions over (params, X)
    index/    Flat and IVF search indexes
    dist/     mesh setup, corpus sharding, cross-shard top-k merge
    data/     datasets, fvecs/npy IO, ground-truth precompute
    metrics/  recall, distortion, pairwise/rank distortion, QPS
    bench/    sweep harness, method registry, study driver
    utils/    SQLite run logger
    viz/      plots
"""

__version__ = "0.1.0"
