import os

import numpy as np

from vq_tpu.bench.ivf_bench import ivf_benchmark, timestamped_output_path
from vq_tpu.bench.streaming import iterate_batches, streaming_sweep
from vq_tpu.core.config import Metric
from vq_tpu.data.datasets import load_dummy_dataset
from vq_tpu.utils.run_logger import load_runs
from vq_tpu.viz.plot import pareto_frontier, plot


def test_timestamped_path_never_same():
    p = timestamped_output_path("out/results.csv")
    assert p.startswith("out/results_") and p.endswith(".csv")


def test_ivf_benchmark_to_csv(tmp_path):
    data = load_dummy_dataset(num_vectors=1200, dim=32, num_queries=15, seed=0)
    out = str(tmp_path / "ivf.csv")
    rows = ivf_benchmark(
        data=data, methods=["ivf_pq", "sq_flat"], k=5, bpd=[2.0],
        num_clusters=8, nprobe=4, output=out,
    )
    assert len(rows) == 2
    assert all(r["error"] == "" for r in rows)
    csvs = [f for f in os.listdir(tmp_path) if f.endswith(".csv")]
    assert len(csvs) == 1
    header = open(tmp_path / csvs[0]).readline()
    assert "recall@5" in header and "qps" in header


def test_ivf_benchmark_isolates_method_errors(tmp_path):
    data = load_dummy_dataset(num_vectors=300, dim=30, num_queries=5, seed=1)
    out = str(tmp_path / "ivf.csv")
    # dim 30: pq bpd→M snapping works; add a bogus method to check isolation
    rows = ivf_benchmark(
        data=data, methods=["sq_flat", "not_a_method"], k=5, bpd=[2.0],
        num_clusters=4, nprobe=2, output=out,
    )
    assert rows[0]["error"] == ""
    assert "unknown ivf-bench method" in rows[1]["error"]


def test_streaming_sweep(tmp_path):
    db = str(tmp_path / "runs.db")
    results = streaming_sweep(
        dataset="dummy-20000x32",
        methods=["sq", "pq"],
        train_size=5000,
        batch_size=4000,
        db_path=db,
        method_params={"pq": {"M": 4, "B": 6, "kmeans_iters": 5}},
    )
    assert len(results) == 2
    for r in results:
        assert r["metrics"]["streamed_vectors"] == 20000
        assert r["metrics"]["mse"] >= 0
        assert r["metrics"]["encode_vecs_per_s"] > 0
    runs = load_runs(db_path=db)
    assert {r["dataset"] for r in runs} == {"dummy-20000x32-streaming"}


def test_iterate_batches_bounds():
    src = np.arange(25 * 2, dtype=np.float32).reshape(25, 2)
    batches = list(iterate_batches(src, 10, max_vectors=22))
    assert [len(b) for b in batches] == [10, 10, 2]


def test_pareto_frontier_dominance():
    pts = [(1, 1), (2, 3), (3, 2), (4, 1), (2, 2)]
    front = pareto_frontier(pts)
    assert (2, 2) not in front  # dominated by (2,3)
    assert (2, 3) in front and (3, 2) in front and (4, 1) in front


def test_plot_suite(tmp_path):
    from vq_tpu.utils.run_logger import log_run

    db = str(tmp_path / "runs.db")
    for method, comp, rec in (("pq", 32, 0.8), ("sq", 4, 0.99), ("saq", 10, 0.9)):
        log_run(method, "dummy", {
            "compression_ratio": comp, "recall@10": rec, "mse": 1e-4 / comp,
            "pairwise_distortion": 0.1, "rank_distortion": 1 - rec, "qps": 1000,
        }, {"x": 1}, db_path=db)
    written = plot(db_path=db, output_dir=str(tmp_path / "plots"))
    assert len(written) == 7
    for p in written:
        assert os.path.exists(p) and os.path.getsize(p) > 0


def test_planted_dataset_has_neighbor_structure():
    """load_planted_dataset: unit rows, registry dispatch, and planted
    near-duplicate neighborhoods (queries' true neighbors are same-document
    variants — the property that makes reference-level recall reachable)."""
    import numpy as np

    from vq_tpu.data.datasets import get_dataset, load_planted_dataset

    d = load_planted_dataset(num_vectors=2000, dim=64, num_queries=20,
                             rank=8, cluster_size=10, spread=0.3, seed=1)
    assert d.vectors.shape == (2000, 64)
    assert np.allclose(np.linalg.norm(d.vectors, axis=1), 1.0, atol=1e-5)
    # each query's top-10 true neighbors should be dominated by one document
    kc = 200  # 2000 / cluster_size
    docs = d.ground_truth[:, :10] % kc
    frac_same = np.mean([
        np.max(np.bincount(row, minlength=kc)) / 10 for row in docs
    ])
    assert frac_same > 0.5, frac_same
    d2 = get_dataset("planted-1000x32", num_queries=10)
    assert d2.vectors.shape == (1000, 32)


def test_ivf_benchmark_packed_runners(tmp_path):
    """The probed-tile packed IVF is reachable from the harness runner
    table (the reference exposes every method through its runner table,
    benchmarks/ivf_benchmark.py:351-359)."""
    from vq_tpu.bench.ivf_bench import METHOD_RUNNERS

    assert "saq_ivf_packed" in METHOD_RUNNERS
    assert "rabitq_ivf_packed" in METHOD_RUNNERS
    data = load_dummy_dataset(num_vectors=2000, dim=32, num_queries=10,
                              seed=2)
    rows = ivf_benchmark(
        data=data, methods=["saq_ivf_packed"], k=5, bpd=[2.0],
        num_clusters=8, nprobe=4, output=str(tmp_path / "ivfpk.csv"),
    )
    assert rows[0]["error"] == ""
    assert rows[0]["recall@5"] > 0.3
