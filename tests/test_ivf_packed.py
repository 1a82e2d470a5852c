"""IvfPackedFlatIndex: IVF routing as a tile mask over the packed scan.

Semantics under test (index/ivf_packed.py): candidates are exactly the
rows of tiles overlapping the batch's probed clusters, scored with the
flat packed scores — so a full probe equals the flat packed scan, and a
partial probe equals a brute-force scan restricted to the masked-in rows.
"""

import numpy as np

from vq_tpu.core.config import (
    IVFConfig,
    KMeansConfig,
    Metric,
    SAQConfig,
    SearchConfig,
)
from vq_tpu.data.datasets import load_dummy_dataset
from vq_tpu.index.ivf import IvfQuantizedIndex
from vq_tpu.index.ivf_packed import _TILE, IvfPackedFlatIndex
from vq_tpu.methods.saq import SAQ
from vq_tpu.metrics.recall import recall_at_k


def _ivf(nq=8, nprobe=4):
    return IVFConfig(num_clusters=nq, nprobe=nprobe,
                     kmeans=KMeansConfig(iters=8))


def _fit(data, nprobe, metric=Metric.L2):
    return IvfPackedFlatIndex(
        SAQ(SAQConfig(bits_per_dim=2.0, use_pca=True)),
        _ivf(nq=8, nprobe=nprobe),
        search_cfg=SearchConfig(metric=metric),
    ).fit(data.vectors)


def test_full_probe_matches_flat_packed():
    """nprobe == K masks every tile in → identical to the dense flat
    packed scan over the same quantizer."""
    from vq_tpu.index.flat import FlatQuantizedIndex

    data = load_dummy_dataset(num_vectors=3000, dim=32, num_queries=12,
                              seed=21)
    idx = _fit(data, nprobe=8)
    ids_m, sc_m = idx.search_with_scores(data.queries, k=7)
    assert idx.last_tiles_scanned == -(-3000 // _TILE)

    flat = FlatQuantizedIndex(
        SAQ(SAQConfig(bits_per_dim=2.0, use_pca=True))
    ).fit(data.vectors)
    ids_f, sc_f = flat.search_with_scores(data.queries, k=7)
    np.testing.assert_allclose(np.sort(sc_m, axis=1), np.sort(sc_f, axis=1),
                               rtol=1e-4, atol=1e-4)


def test_partial_probe_matches_masked_bruteforce():
    """Partial probe == exact top-k over the reconstructions of exactly
    the masked-in rows (tile-overlap candidate semantics)."""
    data = load_dummy_dataset(num_vectors=6000, dim=32, num_queries=3,
                              seed=22)
    data.queries = data.queries[:3]
    idx = IvfPackedFlatIndex(
        SAQ(SAQConfig(bits_per_dim=2.0, use_pca=True)),
        IVFConfig(num_clusters=16, nprobe=1, kmeans=KMeansConfig(iters=8)),
    ).fit(data.vectors)
    ids_m, sc_m = idx.search_with_scores(data.queries, k=5)
    assert 0 < idx.last_tiles_scanned < -(-6000 // _TILE)

    # reproduce the candidate set host-side
    import jax.numpy as jnp

    from vq_tpu.kernels.kmeans import pairwise_sqdist_xc

    cd = np.asarray(pairwise_sqdist_xc(
        jnp.asarray(data.queries, jnp.float32), idx.centroids))
    probe = np.argsort(cd, axis=1)[:, :1]
    probed = np.zeros(idx.centroids.shape[0], bool)
    probed[probe.reshape(-1)] = True
    cl_first = np.asarray(idx.cl_first)
    cl_last = np.asarray(idx.cl_last)
    tile_in = np.array([probed[lo : hi + 1].any()
                        for lo, hi in zip(cl_first, cl_last)])
    order = np.asarray(idx.ids_sorted)
    cand = np.concatenate([
        order[t * _TILE : min((t + 1) * _TILE, len(order))]
        for t in np.nonzero(tile_in)[0]
    ])
    rec = idx.quantizer.decompress(
        idx.quantizer.compress(np.asarray(data.vectors, np.float32)))
    d = ((data.queries[:, None, :] - rec[None, cand, :]) ** 2).sum(-1)
    ref_scores = np.sort(d, axis=1)[:, :5]
    np.testing.assert_allclose(sc_m, ref_scores, rtol=1e-3, atol=1e-3)
    ref_ids = cand[np.argsort(d, axis=1)[:, :5]]
    tied = np.isclose(sc_m, ref_scores, rtol=1e-4)
    assert np.all((ids_m == ref_ids) | tied)


def test_recall_not_below_residual_ivf():
    """Superset candidates + flat scoring: recall must be >= the per-query
    residual IVF at the same coarse geometry (up to quantizer noise)."""
    data = load_dummy_dataset(num_vectors=4000, dim=32, num_queries=25,
                              seed=23)
    idx_m = _fit(data, nprobe=3)
    ids_m, _ = idx_m.search_with_scores(data.queries, k=10)
    r_m = recall_at_k(data.ground_truth, ids_m, 10)

    idx_r = IvfQuantizedIndex(
        SAQ(SAQConfig(bits_per_dim=2.0, use_pca=True)), _ivf(nq=8, nprobe=3)
    ).fit(data.vectors)
    ids_r, _ = idx_r.search_with_scores(data.queries, k=10)
    r_r = recall_at_k(data.ground_truth, ids_r, 10)
    assert r_m >= r_r - 0.05, (r_m, r_r)


def test_nip_metric_masked():
    data = load_dummy_dataset(num_vectors=2000, dim=32, num_queries=8,
                              seed=24)
    idx = _fit(data, nprobe=8, metric=Metric.NIP)
    ids, sc = idx.search_with_scores(data.queries, k=5)
    assert ids.shape == (8, 5)
    assert np.all(np.diff(sc, axis=1) <= 1e-5)  # NIP descending


def test_ivf_packed_save_load(tmp_path):
    data = load_dummy_dataset(num_vectors=3000, dim=32, num_queries=12,
                              seed=25)
    idx = _fit(data, nprobe=3)
    ids, sc = idx.search_with_scores(data.queries, k=5)
    p = str(tmp_path / "ivfpk.pkl")
    idx.save(p)
    idx2 = IvfPackedFlatIndex(
        SAQ(SAQConfig(bits_per_dim=2.0, use_pca=True)), _ivf()
    ).load(p)
    ids2, sc2 = idx2.search_with_scores(data.queries, k=5)
    np.testing.assert_array_equal(ids, ids2)
    np.testing.assert_allclose(sc, sc2, rtol=1e-5)
    assert idx2.memory_footprint() > 0


def test_query_groups_same_results():
    """Probe-coherent grouping changes WORK (per-group masks), never the
    per-query candidate floor: every query's own probed clusters are in
    its group's union, so grouped results match the ungrouped batch-union
    results whenever the ungrouped mask covers each group's mask — checked
    here at full probe (both scan everything) and at partial probe against
    the per-query semantics used in test_partial_probe_matches_masked_
    bruteforce (recall must not drop)."""
    data = load_dummy_dataset(num_vectors=4000, dim=32, num_queries=24,
                              seed=26)
    idx = _fit(data, nprobe=8)  # full probe: groups mask everything in
    ids_u, sc_u = idx.search_with_scores(data.queries, k=7)
    ids_g, sc_g = idx.search_with_scores(data.queries, k=7, query_groups=4)
    np.testing.assert_allclose(np.sort(sc_g, axis=1), np.sort(sc_u, axis=1),
                               rtol=1e-4, atol=1e-4)

    # partial probe: each group's mask is a SUBSET of the batch union
    # (that is the work restriction), but every query keeps its OWN
    # probed clusters — so the floor is the per-query residual-IVF
    # recall at the same coarse geometry, not the batch-union recall
    idx_p = _fit(data, nprobe=2)
    tiles_u = idx_p.last_tiles_scanned  # 0 before any search
    ids_g, _ = idx_p.search_with_scores(data.queries, k=10, query_groups=6)
    r_g = recall_at_k(data.ground_truth, ids_g, 10)
    idx_r = IvfQuantizedIndex(
        SAQ(SAQConfig(bits_per_dim=2.0, use_pca=True)), _ivf(nq=8, nprobe=2)
    ).fit(data.vectors)
    ids_r, _ = idx_r.search_with_scores(data.queries, k=10)
    r_r = recall_at_k(data.ground_truth, ids_r, 10)
    assert r_g >= r_r - 0.05, (r_g, r_r)
    assert idx_p.last_tiles_scanned >= tiles_u  # sum over groups


def test_query_groups_pad_by_repeat():
    """nq not divisible by G: the pad repeats the last query (never a
    zero row probing origin clusters) and results cover exactly nq."""
    data = load_dummy_dataset(num_vectors=3000, dim=32, num_queries=11,
                              seed=27)
    idx = _fit(data, nprobe=3)
    ids_u, sc_u = idx.search_with_scores(data.queries, k=5)
    ids_g, sc_g = idx.search_with_scores(data.queries, k=5, query_groups=4)
    assert ids_g.shape == (11, 5)
    # per-query top-1 must survive grouping (own probes always in-mask)
    assert (ids_g[:, 0] == ids_u[:, 0]).mean() >= 0.9
