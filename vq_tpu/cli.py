"""vq-benchmark CLI.

Parity with the reference's typer app (src/haag_vq/cli.py:9-21): six
subcommands — run, sweep, streaming-sweep, precompute-gt, ivf-bench, plot —
implemented with argparse (stdlib-only).  Invoke as `python -m vq_tpu ...`.
"""

from __future__ import annotations

import argparse
import os
import json
import sys
from typing import List, Optional


def _parse_kv(pairs: List[str]) -> dict:
    """--param M=16 --param B=8 → {"M": 16, "B": 8} (numbers auto-coerced)."""
    out = {}
    for p in pairs or []:
        k, _, v = p.partition("=")
        try:
            out[k] = json.loads(v)
        except json.JSONDecodeError:
            out[k] = v
    return out


def _add_common(p: argparse.ArgumentParser) -> None:
    p.add_argument("--dataset", default="dummy", help="dataset name (data registry)")
    p.add_argument("--data-dir", default=None, help="override $VQ_DATA_DIR")
    p.add_argument("--metric", default="l2", choices=["l2", "ip", "nip"])
    p.add_argument("--k", type=int, default=10)
    p.add_argument("--num-queries", type=int, default=100)
    p.add_argument("--db-path", default=None, help="SQLite path (default $DB_PATH)")
    p.add_argument("--no-bf16", action="store_true", help="score in f32")


def cmd_run(args) -> int:
    from vq_tpu.bench.sweep import run_single_config
    from vq_tpu.core.config import Metric
    from vq_tpu.data.datasets import get_dataset

    data = get_dataset(args.dataset, data_dir=args.data_dir)
    metrics = run_single_config(
        data, args.method, _parse_kv(args.param), k=args.k,
        num_queries=args.num_queries, metric=Metric(args.metric),
        db_path=args.db_path, use_bf16=not args.no_bf16,
    )
    print(json.dumps(metrics, indent=2, default=float))
    return 0


def cmd_sweep(args) -> int:
    from vq_tpu.bench.sweep import sweep
    from vq_tpu.core.config import Metric

    grid = {}
    for method in args.methods:
        g = {}
        if args.pq_subquantizers and method in ("pq", "opq"):
            g["M"] = [int(x) for x in args.pq_subquantizers.split(",")]
        if args.pq_bits and method in ("pq", "opq"):
            g["B"] = [int(x) for x in args.pq_bits.split(",")]
        if args.sq_bits and method == "sq":
            g["bits"] = [int(x) for x in args.sq_bits.split(",")]
        if args.bpd and method in ("saq", "rankaware", "perdim_mse"):
            g["bpd"] = [float(x) for x in args.bpd.split(",")]
        if g:
            grid[method] = g
    sweep(
        dataset=args.dataset, methods=args.methods, grid=grid, k=args.k,
        num_queries=args.num_queries, metric=Metric(args.metric),
        db_path=args.db_path, use_bf16=not args.no_bf16,
    )
    return 0


def cmd_precompute_gt(args) -> int:
    import numpy as np

    from vq_tpu.core.config import Metric
    from vq_tpu.data.datasets import compute_ground_truth, get_dataset

    data = get_dataset(args.dataset, data_dir=args.data_dir)
    gt = compute_ground_truth(
        data.vectors, data.queries, k=args.k, metric=Metric(args.metric)
    )
    np.save(args.output, gt)
    print(f"saved ({gt.shape[0]}, {gt.shape[1]}) ground truth ids to {args.output}")
    return 0


def cmd_streaming_sweep(args) -> int:
    from vq_tpu.bench.streaming import streaming_sweep
    from vq_tpu.core.config import Metric

    streaming_sweep(
        dataset=args.dataset, methods=args.methods,
        train_size=args.train_size, batch_size=args.batch_size,
        max_vectors=args.max_vectors, db_path=args.db_path,
        metric=Metric(args.metric),
    )
    return 0


def cmd_ivf_bench(args) -> int:
    from vq_tpu.bench.ivf_bench import ivf_benchmark

    ivf_benchmark(
        dataset=args.dataset, methods=args.methods, k=args.k,
        bpd=[float(x) for x in args.bpd.split(",")] if args.bpd else [1.0, 2.0, 4.0],
        num_clusters=args.num_clusters, nprobe=args.nprobe,
        output=args.output, data_dir=args.data_dir,
    )
    return 0


def cmd_study(args) -> int:
    from vq_tpu.bench.study import StudyConfig, load_study_config, run_study

    if args.config:
        cfg = load_study_config(args.config)
        if args.plot:
            cfg.plot = True
    else:
        cfg = StudyConfig(
            base_path=args.base, query_path=args.queries,
            methods=args.methods, bpd=[float(b) for b in args.bpd.split(",")],
            output_dir=args.output_dir, plot=args.plot,
        )
    run_study(cfg)
    return 0


def cmd_plot(args) -> int:
    from vq_tpu.viz.plot import plot

    plot(db_path=args.db_path, output_dir=args.output_dir, sweep_id=args.sweep_id)
    return 0


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="vq-benchmark", description=__doc__)
    sub = ap.add_subparsers(dest="command", required=True)

    p = sub.add_parser("run", help="run a single (method, params) config")
    _add_common(p)
    p.add_argument("--method", required=True)
    p.add_argument("--param", action="append", help="hyperparam, e.g. --param M=16")
    p.set_defaults(fn=cmd_run)

    p = sub.add_parser("sweep", help="hyperparameter grid sweep")
    _add_common(p)
    p.add_argument("--methods", nargs="+", default=["pq"])
    p.add_argument("--pq-subquantizers", default=None, help="comma list of M")
    p.add_argument("--pq-bits", default=None, help="comma list of B")
    p.add_argument("--sq-bits", default=None, help="comma list of SQ bits")
    p.add_argument("--bpd", default=None, help="comma list of bits-per-dim")
    p.set_defaults(fn=cmd_sweep)

    p = sub.add_parser("precompute-gt", help="exact k-NN ground truth → .npy")
    _add_common(p)
    p.add_argument("--output", required=True)
    p.set_defaults(fn=cmd_precompute_gt)

    p = sub.add_parser("streaming-sweep", help="streamed out-of-core sweep")
    _add_common(p)
    p.add_argument("--methods", nargs="+", default=["pq"])
    p.add_argument("--train-size", type=int, default=1_000_000)
    p.add_argument("--batch-size", type=int, default=100_000)
    p.add_argument("--max-vectors", type=int, default=None)
    p.set_defaults(fn=cmd_streaming_sweep)

    p = sub.add_parser("ivf-bench", help="IVF index benchmark → CSV")
    _add_common(p)
    p.add_argument("--methods", nargs="+", default=["ivf_pq"])
    p.add_argument("--bpd", default=None)
    p.add_argument("--num-clusters", type=int, default=1024)
    p.add_argument("--nprobe", type=int, default=32)
    p.add_argument("--output", default="ivf_bench_results.csv")
    p.set_defaults(fn=cmd_ivf_bench)

    p = sub.add_parser("study", help="quantizer study: (method, bpd) grid -> CSV")
    p.add_argument("--config", default=None, help="YAML StudyConfig")
    p.add_argument("--base", default=None, help="base fvecs path")
    p.add_argument("--queries", default=None, help="query fvecs path")
    p.add_argument("--methods", nargs="+", default=["pq", "ours", "saq_paper"])
    p.add_argument("--bpd", default="1,2,4")
    p.add_argument("--output-dir", default="results")
    p.add_argument("--plot", action="store_true")
    p.set_defaults(fn=cmd_study)

    p = sub.add_parser("plot", help="render plots from the runs database")
    p.add_argument("--db-path", default=None)
    p.add_argument("--output-dir", default="plots")
    p.add_argument("--sweep-id", default=None)
    p.set_defaults(fn=cmd_plot)

    return ap


# Fixed, git-ignored compile-cache directory in the checkout: the path is
# part of the cache key, so a directory that moves never hits.
DEFAULT_CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), ".jax_cache"
)


def compilation_cache_dir() -> Optional[str]:
    """The directory this program sets for JAX's persistent compilation
    cache: None when JAX_COMPILATION_CACHE_DIR is set (JAX reads that
    variable itself and the program sets no other), else DEFAULT_CACHE_DIR."""
    if os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        return None
    return DEFAULT_CACHE_DIR


def _enable_compilation_cache() -> None:
    """Persistent XLA compilation cache, so repeated runs skip compiles."""
    import jax

    cache_dir = compilation_cache_dir()
    if cache_dir is not None:
        jax.config.update("jax_compilation_cache_dir", cache_dir)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)


def main(argv: Optional[List[str]] = None) -> int:
    _enable_compilation_cache()
    args = build_parser().parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
