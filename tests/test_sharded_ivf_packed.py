"""ShardedIvfPackedIndex: per-shard tile masks over the packed scan on
the 8-virtual-device CPU mesh.

Semantics under test (dist/sharded_ivf_packed.py): candidates are tiles
overlapping the batch's probed clusters — per shard over its LOCAL tiles
of the globally cluster-sorted corpus — so a full probe equals the
single-device flat packed scan, and results match the single-device
IvfPackedFlatIndex at any nprobe (the shard split only moves tile
boundaries at shard edges, which are also tile boundaries: n_loc is a
512 multiple).
"""

import numpy as np
import pytest

from vq_tpu.core.config import (
    IVFConfig,
    KMeansConfig,
    Metric,
    SAQConfig,
    SearchConfig,
)
from vq_tpu.data.datasets import load_dummy_dataset
from vq_tpu.dist.mesh import make_mesh
from vq_tpu.dist.sharded_ivf_packed import ShardedIvfPackedIndex
from vq_tpu.index.ivf_packed import IvfPackedFlatIndex
from vq_tpu.methods.saq import SAQ
from vq_tpu.metrics.recall import recall_at_k


def _ivf(nq=8, nprobe=4):
    return IVFConfig(num_clusters=nq, nprobe=nprobe,
                     kmeans=KMeansConfig(iters=8))


def _saq():
    return SAQ(SAQConfig(bits_per_dim=2.0, use_pca=True))


def test_matches_single_device_probed_tile():
    """Same coarse pass → the sharded probed-tile scan returns the same
    candidates/scores as IvfPackedFlatIndex (tile boundaries coincide:
    shard blocks are 512 multiples)."""
    data = load_dummy_dataset(num_vectors=9000, dim=32, num_queries=12,
                              seed=41)
    single = IvfPackedFlatIndex(_saq(), _ivf(nq=8, nprobe=2),
                                SearchConfig(use_bf16=False))
    single.fit(data.vectors)
    # same kmeans seed → both fits produce the same coarse pass
    sharded = ShardedIvfPackedIndex(_saq(), _ivf(nq=8, nprobe=2),
                                    SearchConfig(use_bf16=False),
                                    mesh=make_mesh())
    sharded.fit(data.vectors)
    ids_s, sc_s = sharded.search_with_scores(data.queries, k=7)
    ids_1, sc_1 = single.search_with_scores(data.queries, k=7)
    # same kmeans seed → same coarse pass → same candidate tiles (up to
    # shard-edge tiles, which only ADD candidates); top-7 must agree on
    # scores
    np.testing.assert_allclose(np.sort(sc_s, axis=1)[:, :5],
                               np.sort(sc_1, axis=1)[:, :5],
                               rtol=1e-4, atol=1e-4)


def test_full_probe_equals_flat_scan():
    from vq_tpu.index.flat import FlatQuantizedIndex

    data = load_dummy_dataset(num_vectors=6000, dim=32, num_queries=10,
                              seed=42)
    idx = ShardedIvfPackedIndex(_saq(), _ivf(nq=8, nprobe=8),
                                SearchConfig(use_bf16=False),
                                mesh=make_mesh()).fit(data.vectors)
    ids_m, sc_m = idx.search_with_scores(data.queries, k=6)
    flat = FlatQuantizedIndex(_saq()).fit(data.vectors)
    ids_f, sc_f = flat.search_with_scores(data.queries, k=6)
    np.testing.assert_allclose(np.sort(sc_m, axis=1), np.sort(sc_f, axis=1),
                               rtol=1e-4, atol=1e-4)


def test_recall_reasonable_partial_probe():
    data = load_dummy_dataset(num_vectors=6000, dim=32, num_queries=25,
                              seed=43)
    idx = ShardedIvfPackedIndex(_saq(), _ivf(nq=16, nprobe=6),
                                SearchConfig(use_bf16=False),
                                mesh=make_mesh()).fit(data.vectors)
    ids, _ = idx.search_with_scores(data.queries, k=10)
    r = recall_at_k(data.ground_truth, ids, 10)
    assert r > 0.5, r


def test_sharded_ivf_packed_save_load(tmp_path):
    data = load_dummy_dataset(num_vectors=5000, dim=32, num_queries=8,
                              seed=44)
    idx = ShardedIvfPackedIndex(_saq(), _ivf(nq=8, nprobe=3),
                                SearchConfig(use_bf16=False),
                                mesh=make_mesh()).fit(data.vectors)
    ids, sc = idx.search_with_scores(data.queries, k=5)
    p = str(tmp_path / "sivfpk.pkl")
    idx.save(p)
    idx2 = ShardedIvfPackedIndex(_saq(), _ivf(), SearchConfig(use_bf16=False),
                                 mesh=make_mesh()).load(p)
    ids2, sc2 = idx2.search_with_scores(data.queries, k=5)
    np.testing.assert_array_equal(ids, ids2)
    np.testing.assert_allclose(sc, sc2, rtol=1e-5)

    state = idx._state()
    state["num_shards"] = idx.num_shards + 1
    with pytest.raises(ValueError, match="shards"):
        idx2._restore(state)
