#!/usr/bin/env python
"""Quality-parity check against the reference's recorded demo results.

The reference repo ships logs/benchmark_runs.db with 56 runs on its demo
dataset — np.random.seed(42) gaussian, N=10000, D=1024, queries = first 100
corpus rows (reference data/datasets.py:79-82,57-58).  That dataset is
exactly reproducible offline, so this script regenerates it bit-for-bit,
runs the same (method, config) grid through vq_tpu, and prints our
recall@10/@100 next to the reference's recorded values — the
apples-to-apples quality comparison BASELINE.md's Δ-parity target asks
for, with no network access needed.

Writes PARITY_RESULTS.md at the repo root.
"""

from __future__ import annotations

import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from vq_tpu.core.config import (
    KMeansConfig,
    OPQConfig,
    PQConfig,
    RaBitQConfig,
    SAQConfig,
    SQConfig,
    SearchConfig,
)
from vq_tpu.data.datasets import Dataset
from vq_tpu.index.flat import FlatQuantizedIndex
from vq_tpu.metrics.recall import recall_at_k

# (label, quantizer factory, reference recall@10, reference recall@100)
# reference values: logs/benchmark_runs.db demo runs (queried 2026-08-17).
# Rows with ref=None are study variants the reference demo DB never ran
# (engine derive_codebooks / exact codebooks / rankaware — reference
# method_registry_saq.py:27-74); they are recorded for cross-round
# regression tracking and sanity-ordered against their uniform baselines.
KM = KMeansConfig(iters=20)
GRID = [
    ("pq M=8 B=8",  lambda: _pq(8),  0.110, 0.0522),
    ("pq M=16 B=8", lambda: _pq(16), 0.116, 0.0765),
    ("pq M=32 B=8", lambda: _pq(32), 0.131, 0.1215),
    ("opq M=8 B=8", lambda: _opq(8), 0.102, 0.0393),
    ("opq M=16 B=8", lambda: _opq(16), 0.108, 0.0608),
    ("sq 8-bit",    lambda: _sq(8),  0.984, 0.988),
    ("rabitq 1-bit", lambda: _rabitq(1), 0.398, 0.4358),
    ("rabitq 4-bit (ext)", lambda: _rabitq(4), None, None),
    ("saq 4-bit",   lambda: _saq(4.0), 0.794, 0.8323),
    ("saq 8-bit",   lambda: _saq(8.0), 0.986, 0.989),
    ("saq 4-bit lloyd ('ours')", lambda: _saq(4.0, "lloyd"), None, None),
    ("saq 4-bit exact ('ours_exact')", lambda: _saq(4.0, "exact"), None, None),
    ("rankaware 2-bit lloyd", lambda: _rankaware(2.0, "lloyd"), None, None),
    ("rankaware 2-bit exact", lambda: _rankaware(2.0, "exact"), None, None),
    ("rankaware 2-bit ffd", lambda: _rankaware(2.0, "lloyd", "ffd"), None, None),
]


def _pq(m):
    from vq_tpu.methods.pq import PQ

    return PQ(PQConfig(num_subquantizers=m, num_bits=8, kmeans=KM))


def _opq(m):
    from vq_tpu.methods.opq import OPQ

    return OPQ(OPQConfig(num_subquantizers=m, num_bits=8, opq_iters=10, kmeans=KM))


def _sq(b):
    from vq_tpu.methods.sq import SQ

    return SQ(SQConfig(num_bits=b))


def _rabitq(b):
    from vq_tpu.methods.rabitq import RaBitQ

    return RaBitQ(RaBitQConfig(num_bits=b))


def _saq(bpd, codebook="uniform"):
    from vq_tpu.methods.saq import SAQ

    return SAQ(SAQConfig(bits_per_dim=bpd, codebook=codebook))


def _rankaware(bpd, codebook="lloyd", packing="dense"):
    from vq_tpu.core.config import RankAwareConfig
    from vq_tpu.methods.rankaware import RankAware

    return RankAware(RankAwareConfig(bits_per_dim=bpd, codebook=codebook,
                                     packing=packing))


# Gate-corpus grid: the planted-neighborhood corpus at
# the reference study's geometry (N=100k, D=1536, unit rows) — recall sits
# near the reference's dbpedia regime (~0.8 at 1 bpd) instead of the demo
# table's ~0.11, so deltas are meaningful.  "ref dbpedia" columns are the
# reference study's GEOMETRY-MATCHED dbpedia-100k results
# (results_full_20260612_235308.csv) — context anchors, not same-data
# parity (the real dataset needs a download).
GATE_GRID = [
    ("pq M=192 B=8 (1 bpd)", lambda: _pq(192), 0.8034),
    ("saq 1-bit ('saq_paper')", lambda: _saq(1.0), 0.8608),
    ("saq 1-bit lloyd ('ours')", lambda: _saq(1.0, "lloyd"), None),
    ("rabitq 1-bit", lambda: _rabitq(1), None),
    ("saq 4-bit", lambda: _saq(4.0), 0.9813),
    ("saq 4-bit lloyd ('ours')", lambda: _saq(4.0, "lloyd"), 0.9693),
    ("ext-rabitq 4-bit", lambda: _rabitq(4), 0.9690),
    ("rankaware 2-bit lloyd", lambda: _rankaware(2.0, "lloyd"), None),
    ("opq M=192 B=8", lambda: _opq192(), None),
    ("sq 8-bit", lambda: _sq(8), None),
    ("lvq 8-bit", lambda: _lvq(8), None),
]


def _opq192():
    from vq_tpu.methods.opq import OPQ

    return OPQ(OPQConfig(num_subquantizers=192, num_bits=8, opq_iters=4,
                         kmeans=KMeansConfig(iters=10)))


def _lvq(b):
    from vq_tpu.core.config import LVQConfig
    from vq_tpu.methods.lvq import LVQ

    return LVQ(LVQConfig(num_bits=b))


def gate_table() -> list:
    from vq_tpu.data.datasets import load_planted_dataset

    data = load_planted_dataset(num_vectors=100_000, dim=1536,
                                num_queries=1024, seed=0)
    rows = []
    for label, make, ref10 in GATE_GRID:
        try:  # per-row isolation: one OOM/flake must not lose the table
            idx = FlatQuantizedIndex(make(), SearchConfig()).fit(data.vectors)
            ids = idx.search(data.queries, k=100)
            r10 = recall_at_k(data.ground_truth, ids, 10)
            r100 = recall_at_k(data.ground_truth, ids, 100)
            rows.append((label, r10, ref10, r100))
            anchor = f" (dbpedia anchor {ref10:.3f})" if ref10 else ""
            print(f"[gate] {label:<28} R@10 {r10:.3f}{anchor}  "
                  f"R@100 {r100:.3f}", flush=True)
            del idx
        except Exception as e:
            print(f"[gate] {label:<28} ERROR {type(e).__name__}: {e}",
                  flush=True)
            rows.append((label, float("nan"), ref10, float("nan")))
    return rows


def main() -> int:
    np.random.seed(42)  # the reference's exact demo data
    vectors = np.random.randn(10000, 1024).astype(np.float32)
    data = Dataset(
        name="reference-demo", vectors=vectors, queries=vectors[:100], gt_k=100
    )

    rows = []
    for label, make, ref10, ref100 in GRID:
        idx = FlatQuantizedIndex(make(), SearchConfig()).fit(data.vectors)
        ids = idx.search(data.queries, k=100)
        r10 = recall_at_k(data.ground_truth, ids, 10)
        r100 = recall_at_k(data.ground_truth, ids, 100)
        rows.append((label, r10, ref10, r100, ref100))
        if ref10 is None:
            print(f"{label:<32} R@10 {r10:.3f}  R@100 {r100:.3f}", flush=True)
        else:
            print(
                f"{label:<32} R@10 {r10:.3f} (ref {ref10:.3f}, Δ {r10-ref10:+.3f})  "
                f"R@100 {r100:.3f} (ref {ref100:.4f}, Δ {r100-ref100:+.3f})",
                flush=True,
            )

    by_label = {r[0]: r[1] for r in rows}
    # sanity orderings for the study variants (no recorded reference values):
    # derived codebooks must not lose much to the uniform grid at equal bpd
    assert by_label["saq 4-bit lloyd ('ours')"] >= by_label["saq 4-bit"] - 0.03
    assert by_label["saq 4-bit exact ('ours_exact')"] >= by_label["saq 4-bit"] - 0.03
    # ffd packing is a layout change only — identical codes, identical recall
    assert abs(by_label["rankaware 2-bit ffd"]
               - by_label["rankaware 2-bit lloyd"]) < 1e-9

    out = ["# Quality parity vs reference demo results",
           "",
           "Same data as the reference's logs/benchmark_runs.db demo runs",
           "(np.random.seed(42) gaussian, N=10000, D=1024, queries = first 100",
           "rows; reference data/datasets.py:79-82).  Reference values are the",
           "recorded CPU/faiss results; ours are vq_tpu's.  Rows with",
           "ref '—' are study variants the demo DB never ran, tracked for",
           "cross-round regression.",
           "",
           "| config | vq_tpu R@10 | ref R@10 | Δ | vq_tpu R@100 | ref R@100 | Δ |",
           "|---|---|---|---|---|---|---|"]
    for label, r10, ref10, r100, ref100 in rows:
        if ref10 is None:
            out.append(f"| {label} | {r10:.3f} | — | — | {r100:.3f} | — | — |")
        else:
            out.append(
                f"| {label} | {r10:.3f} | {ref10:.3f} | {r10-ref10:+.3f} "
                f"| {r100:.3f} | {ref100:.4f} | {r100-ref100:+.3f} |"
            )
    gate_rows = gate_table()
    out += [
        "",
        "Notes:",
        "- PQ tracks the reference within ±0.006; SQ matches exactly; OPQ and",
        "  SAQ exceed the reference (+0.016 and +0.078 recall@10).",
        "- RaBitQ 1-bit matches faiss within noise (Δ −0.003 @10, +0.004 @100)",
        "  since the scan switched to the paper's unbiased estimator",
        "  (divide by ⟨o,ō⟩ rather than project — methods/rabitq.py).",
        "- Regenerate with scripts/parity_check.py (rebuilds the demo",
        "  dataset bit-for-bit; no network needed).",
        "",
        "## Gate-corpus method matrix (recall ≈ 0.8 regime)",
        "",
        "Planted-neighborhood corpus (data/datasets.load_planted_dataset),",
        "N=100k, D=1536, unit rows, 1024 queries — the quality regime of the",
        "reference's dbpedia study (its demo table sits at R@10 ≈ 0.11 on",
        "random gaussians, where ±0.006 parity tolerates large relative",
        "error).  'dbpedia anchor' = the reference",
        "study's geometry-matched dbpedia-100k value",
        "(results_full_20260612_235308.csv) — a context anchor, not",
        "same-data parity (the real dataset needs a download).",
        "",
        "| config | R@10 | dbpedia anchor | R@100 |",
        "|---|---|---|---|",
    ]
    for label, r10, ref10, r100 in gate_rows:
        anchor = f"{ref10:.3f}" if ref10 else "—"
        out.append(f"| {label} | {r10:.3f} | {anchor} | {r100:.3f} |")
    path = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                        "PARITY_RESULTS.md")
    with open(path, "w") as f:
        f.write("\n".join(out) + "\n")
    print(f"wrote {path}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
