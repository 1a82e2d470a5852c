"""Method registry: (method name, hyperparams, dim) → quantizer.

Unifies the reference's two registries (benchmarks/method_registry.py:16-61
for the faiss family and method_registry_saq.py:20-74 for the SAQ/study
family) into one dispatch.  Methods are added here as the corresponding
modules land; `ALL_METHODS` is the sweep grid's universe.
"""

from __future__ import annotations

from typing import Dict, List

from vq_tpu.core.config import (
    KMeansConfig,
    LVQConfig,
    OPQConfig,
    PQConfig,
    RaBitQConfig,
    RankAwareConfig,
    SAQConfig,
    SQConfig,
)
from vq_tpu.methods.base import BaseQuantizer


def largest_divisor_leq(d: int, target: int) -> int:
    """Largest divisor of d that is ≤ target (reference
    method_registry.py:16-28: PQ needs M | D)."""
    target = max(1, min(d, target))
    for m in range(target, 0, -1):
        if d % m == 0:
            return m
    return 1


def bpd_to_pq_m(bits_per_dim: float, d: int, b: int = 8) -> int:
    """Convert a bits-per-dimension budget to a PQ subquantizer count:
    M ≈ bpd·D/B, snapped to a divisor of D (reference ivf_benchmark.py:81-93)."""
    m_target = max(1, int(round(bits_per_dim * d / b)))
    return largest_divisor_leq(d, m_target)


def _check_consumed(method: str, kw: Dict) -> None:
    """Reject unrecognized kwargs instead of silently dropping them — a
    dropped `codebook`/`packing` made two study variants silently identical
    in round 1."""
    if kw:
        raise TypeError(
            f"method {method!r} got unknown kwargs {sorted(kw)}; check the "
            "spelling against build_quantizer's per-method options"
        )


def build_quantizer(method: str, dim: int, **kw) -> BaseQuantizer:
    """Construct a quantizer by name.

    Common kwargs: M / B (PQ, OPQ), bits (SQ, RaBitQ, LVQ), bpd + allocator
    + codebook (SAQ), bpd + alpha + codebook + packing (RankAware),
    kmeans_iters, seed.  Unknown kwargs raise TypeError.
    """
    method = method.lower()
    iters = kw.pop("kmeans_iters", 20)
    seed = kw.pop("seed", 0)
    km = KMeansConfig(iters=iters, seed=seed)

    if method == "pq":
        b = kw.pop("B", 8)
        m = kw.pop("M", None) or bpd_to_pq_m(kw.pop("bpd", 1.0), dim, b)
        kw.pop("bpd", None)  # M wins when both are given
        _check_consumed(method, kw)
        from vq_tpu.methods.pq import PQ

        return PQ(PQConfig(num_subquantizers=m, num_bits=b, kmeans=km), seed=seed)

    if method == "sq":
        bits = kw.pop("bits", kw.pop("B", 8))
        _check_consumed(method, kw)
        from vq_tpu.methods.sq import SQ

        return SQ(SQConfig(num_bits=bits))

    if method == "opq":
        b = kw.pop("B", 8)
        m = kw.pop("M", None) or bpd_to_pq_m(kw.pop("bpd", 1.0), dim, b)
        kw.pop("bpd", None)
        opq_iters = kw.pop("opq_iters", 10)
        _check_consumed(method, kw)
        from vq_tpu.methods.opq import OPQ

        return OPQ(
            OPQConfig(
                num_subquantizers=m,
                num_bits=b,
                opq_iters=opq_iters,
                kmeans=km,
            ),
            seed=seed,
        )

    if method in ("rabitq", "extended_rabitq", "xrabitq"):
        bits = kw.pop("bits", kw.pop("B", 1 if method == "rabitq" else 4))
        _check_consumed(method, kw)
        from vq_tpu.methods.rabitq import RaBitQ

        return RaBitQ(RaBitQConfig(num_bits=bits, seed=seed))

    if method in ("saq", "saq_paper", "ours", "caq"):
        cfg = SAQConfig(
            bits_per_dim=kw.pop("bpd", 4.0),
            allocator=kw.pop("allocator", "greedy"),
            use_pca=kw.pop("use_pca", True),
            caq_rounds=kw.pop("caq_rounds", 6),
            codebook=kw.pop("codebook", "uniform"),
            seed=seed,
        )
        _check_consumed(method, kw)
        from vq_tpu.methods.saq import SAQ

        return SAQ(cfg)

    if method == "lvq":
        bits = kw.pop("bits", kw.pop("B", 8))
        _check_consumed(method, kw)
        from vq_tpu.methods.lvq import LVQ

        return LVQ(LVQConfig(num_bits=bits))

    if method in ("rankaware", "perdim_mse"):
        cfg = RankAwareConfig(
            bits_per_dim=kw.pop("bpd", 4.0),
            alpha=kw.pop("alpha", 0.5 if method == "rankaware" else 0.0),
            codebook=kw.pop("codebook", "lloyd"),
            packing=kw.pop("packing", "dense"),
            seed=seed,
        )
        _check_consumed(method, kw)
        from vq_tpu.methods.rankaware import RankAware

        return RankAware(cfg)

    raise ValueError(f"unknown method {method!r}; known: {ALL_METHODS}")


ALL_METHODS: List[str] = [
    "pq",
    "sq",
    "opq",
    "rabitq",
    "extended_rabitq",
    "saq",
    "lvq",
    "rankaware",
    "perdim_mse",
]
