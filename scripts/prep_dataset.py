#!/usr/bin/env python
"""Pre-materialize dataset shards as .npy / .fvecs per host.

Parity with the reference's scripts/prep_msmarco_bench.py (SURVEY.md §2.1
P45): build base/query files from raw sources (npy shards, fvecs, or an HF
stream when `datasets` is installed), chunked so memory stays bounded.
Multi-host runs mmap these per host instead of re-streaming HF at fit time
(SURVEY.md §7.3 "53M ingestion").

Usage:
  python scripts/prep_dataset.py --source hf-dbpedia-1536 --rows 100000 \
      --out data/dbpedia-100k
  python scripts/prep_dataset.py --source some/shards_*.npy --queries 1000 \
      --out data/msmarco --format fvecs
"""

from __future__ import annotations

import argparse
import glob
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from vq_tpu.data.io import write_fvecs


def iter_source(source: str, rows: int, batch: int):
    if source.startswith("hf-dbpedia"):
        from vq_tpu.data.hf_loaders import load_dbpedia_openai

        dim = 3072 if "3072" in source else 1536
        ds = load_dbpedia_openai(rows, dim, num_queries=0)
        yield ds.vectors
        return
    if source.startswith("hf-msmarco"):
        from vq_tpu.data.hf_loaders import stream_cohere_msmarco_passages

        yield from stream_cohere_msmarco_passages(batch_size=batch, max_vectors=rows)
        return
    paths = sorted(glob.glob(source))
    if not paths:
        raise FileNotFoundError(source)
    remaining = rows
    for p in paths:
        arr = np.load(p, mmap_mode="r")
        for start in range(0, len(arr), batch):
            if remaining <= 0:
                return
            chunk = np.asarray(
                arr[start : start + min(batch, remaining)], dtype=np.float32
            )
            remaining -= len(chunk)
            yield chunk


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--source", required=True,
                    help="hf-dbpedia-1536 | hf-dbpedia-3072 | hf-msmarco | npy glob")
    ap.add_argument("--rows", type=int, default=1_000_000)
    ap.add_argument("--queries", type=int, default=1000,
                    help="rows split off the tail as queries")
    ap.add_argument("--batch", type=int, default=200_000)
    ap.add_argument("--out", required=True, help="output directory")
    ap.add_argument("--format", choices=["npy", "fvecs"], default="npy")
    args = ap.parse_args()

    os.makedirs(args.out, exist_ok=True)
    chunks = list(iter_source(args.source, args.rows + args.queries, args.batch))
    data = np.concatenate(chunks) if len(chunks) > 1 else chunks[0]
    base, queries = data[: -args.queries] if args.queries else data, (
        data[-args.queries :] if args.queries else data[:0]
    )
    if args.format == "npy":
        np.save(os.path.join(args.out, "base.npy"), base)
        if len(queries):
            np.save(os.path.join(args.out, "query.npy"), queries)
    else:
        write_fvecs(os.path.join(args.out, "base.fvecs"), base)
        if len(queries):
            write_fvecs(os.path.join(args.out, "query.fvecs"), queries)
    print(f"wrote base {base.shape} (+ queries {queries.shape}) to {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
