"""Scan observability: effective-bandwidth / effective-FLOPs counters.

Parity with the SAQ engine's QueryRuntimeMetrics (reference
external/saq/include/saq/caq_estimator.h:33-37, saq_searcher.h:157-165:
fast_bitsum / acc_bitsum / total_comp_cnt — bits actually scanned per
stage).  The scan is dense, so the counters are exact functions of the scan
geometry; combined with a measured wall time they give the effective code
bandwidth and FLOP rate per scan.
"""

from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class ScanStats:
    """Static cost model of one fused ADC scan."""

    num_rows: int
    num_queries: int
    dim: int
    code_bytes_per_row: float

    @property
    def bytes_scanned(self) -> float:
        """HBM traffic for the corpus codes (the quantity the reference
        counts as bits scanned)."""
        return self.num_rows * self.code_bytes_per_row

    @property
    def score_flops(self) -> float:
        """Q·x̂ᵀ scoring: Q·N·D MACs (the decode is a gather, no FLOPs)."""
        return 2.0 * self.num_queries * self.num_rows * self.dim

    def report(self, wall_seconds: float) -> dict:
        """Effective rates for a measured scan time."""
        w = max(wall_seconds, 1e-12)
        return {
            "rows_scanned": self.num_rows,
            "bytes_scanned": self.bytes_scanned,
            "effective_code_bandwidth_gbps": self.bytes_scanned / w / 1e9,
            "effective_tflops": self.score_flops / w / 1e12,
            "qps": self.num_queries / w,
            "rows_per_s": self.num_rows * self.num_queries / w,
        }
