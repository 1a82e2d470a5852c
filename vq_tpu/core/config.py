"""Unified dataclass configs for the whole engine.

The reference spreads configuration over four overlapping systems (typer CLI
grids, YAML StudyConfig, env vars, and the C++ engine's QuantizeConfig /
SearcherConfig / LloydOpts structs — reference src/haag_vq/benchmarks/
study_config.py:14-35 and external/saq/include/saq/config.h:13-86).  Here one
set of frozen dataclasses covers all of it; frozen → hashable → usable as
static args under `jax.jit`.
"""

from __future__ import annotations

import dataclasses
import enum
from dataclasses import dataclass
from typing import Optional, Tuple


class Metric(str, enum.Enum):
    """Distance conventions used across the framework.

    L2  — squared euclidean (reference sweep pipeline, metrics/recall.py:6).
    IP  — inner product (maximise).
    NIP — normalized inner product q·x̂/‖x‖ (reference study pipeline,
          benchmarks/exact_search.py:4-8); needs original row norms.
    """

    L2 = "l2"
    IP = "ip"
    NIP = "nip"


@dataclass(frozen=True)
class KMeansConfig:
    """Batched Lloyd k-means (kernels/kmeans.py).

    Mirrors the knobs faiss exposes where the reference calls it
    (methods/search/saq_index.py:14-23 uses niter=20, seed=0).
    """

    iters: int = 20
    seed: int = 0
    # Cap on training points per centroid, faiss-style subsampling.
    max_points_per_centroid: int = 256
    # "auto" = k-means++ (full-D² Gumbel-max seeding) for k ≤ 1024,
    # random-row init beyond (the ++ scan reads the training set once per
    # centroid — prohibitive at IVF-coarse K; random is faiss's default).
    init: str = "auto"  # "auto" | "kmeanspp" | "random"


@dataclass(frozen=True)
class PQConfig:
    """Product quantization: M subquantizers × B bits each.

    Parity with reference methods/product_quantization.py:9-99.
    """

    num_subquantizers: int = 8  # M
    num_bits: int = 8  # B, codebook size K = 2**B
    kmeans: KMeansConfig = KMeansConfig()

    @property
    def codebook_size(self) -> int:
        return 1 << self.num_bits


@dataclass(frozen=True)
class OPQConfig:
    """Optimized PQ: learned rotation + PQ (reference
    methods/optimized_product_quantization.py:7-46, which wraps
    faiss.OPQMatrix).  Alternates PQ-fit ↔ Procrustes SVD.
    """

    num_subquantizers: int = 8
    num_bits: int = 8
    opq_iters: int = 10
    kmeans: KMeansConfig = KMeansConfig()

    @property
    def codebook_size(self) -> int:
        return 1 << self.num_bits

    @property
    def pq(self) -> PQConfig:
        return PQConfig(self.num_subquantizers, self.num_bits, self.kmeans)


@dataclass(frozen=True)
class SQConfig:
    """Per-dimension uniform scalar quantization at 4/8/16 bits
    (reference methods/scalar_quantization.py:6-100)."""

    num_bits: int = 8  # one of 4, 8, 16


@dataclass(frozen=True)
class RaBitQConfig:
    """RaBitQ / Extended RaBitQ.

    num_bits=1 reproduces the classic sign-binarized RaBitQ (reference
    methods/rabit_quantization.py:9-40); num_bits>1 is the Extended variant
    with a shared N(0,1) Lloyd codebook and per-vector rescale factor
    (reference methods/extended_rabitq.py:47-204).
    """

    num_bits: int = 1
    seed: int = 0


@dataclass(frozen=True)
class SAQConfig:
    """SAQ: variance-aware segmented CAQ quantization.

    Re-design of the native engine's QuantizeConfig
    (external/saq/include/saq/config.h:13-50): total bit budget = D *
    bits_per_dim, allocated over dimension blocks by a DP or greedy
    allocator (quantization_plan.cpp:144-255), then each segment is
    rotated and CAQ-encoded (caq_encoder.h:58-220).
    """

    bits_per_dim: float = 4.0
    allocator: str = "greedy"  # "greedy" | "dp" | "uniform"
    block_dims: int = 64  # allocation granularity (kDimPaddingSize=64)
    max_bits: int = 8  # per-dim bit cap (reference KMaxQuantizeBits=13; 8 keeps uint8 codes)
    caq_rounds: int = 6  # code-adjustment round limit (caq_encoder.h round limit 6)
    use_pca: bool = True
    # Base quantization grid per segment dim: "uniform" = the CAQ mid-rise
    # grid (engine derive_codebooks=false); "lloyd" = data-fit per-dim Lloyd
    # levels (derive_codebooks=true, the study's "ours"); "exact" = optimal
    # 1-D k-means levels via the native D&C DP (exact_codebooks=true,
    # "ours_exact").  Reference method_registry_saq.py:27-45,
    # ivf_index.cpp:55-117.
    codebook: str = "uniform"
    seed: int = 0


@dataclass(frozen=True)
class LVQConfig:
    """SVS-style locally-adaptive VQ: global mean, per-vector lo/delta
    (reference methods/lvq_quantization.py:23-151)."""

    num_bits: int = 8


@dataclass(frozen=True)
class RankAwareConfig:
    """PCA rotation + var^(1+alpha)-weighted greedy per-dim bit allocation +
    per-dim codebooks (reference methods/rank_aware_quantization.py:56-329)."""

    bits_per_dim: float = 4.0
    alpha: float = 0.5
    max_bits: int = 8
    codebook: str = "lloyd"  # "gaussian" | "lloyd"
    packing: str = "dense"  # "dense" (cross-byte bit stream) | "ffd" (byte-aligned)
    seed: int = 0


@dataclass(frozen=True)
class IVFConfig:
    """IVF coarse quantizer over K cells, nprobe probing
    (reference methods/search/ivf_quantized_index.py:16-259 and the native
    IVF engine external/saq/include/index/ivf_index.h:46-317)."""

    num_clusters: int = 256  # K / nlist
    nprobe: int = 16
    kmeans: KMeansConfig = KMeansConfig()


@dataclass(frozen=True)
class SearchConfig:
    """Runtime knobs for the distance scan."""

    metric: Metric = Metric.L2
    k: int = 10
    # Rows per scan tile; large tiles amortize the per-tile top-k cost —
    # few unrolled tiles beat many small ones.
    tile_rows: int = 16384
    # bf16 scoring with f32 accumulation (recall targets are tight at 8-bit,
    # SURVEY.md §7.3); flip to False for full-f32 scoring.
    use_bf16: bool = True
    # approx=True uses lax.approx_max_k for per-tile candidate selection
    # (recall_target 0.99; the cross-tile merge stays exact).  Default
    # False: fully exact ranking.
    approx: bool = False


def asdict(cfg) -> dict:
    """JSON-serializable view of any config (for the run logger)."""
    d = dataclasses.asdict(cfg)

    def _clean(v):
        if isinstance(v, dict):
            return {k: _clean(x) for k, x in v.items()}
        if isinstance(v, enum.Enum):
            return v.value
        return v

    return _clean(d)
