import numpy as np

from vq_tpu.core.config import (
    IVFConfig,
    KMeansConfig,
    Metric,
    PQConfig,
    RaBitQConfig,
    SearchConfig,
    SQConfig,
)
from vq_tpu.data.datasets import load_dummy_dataset
from vq_tpu.index.ivf import IvfQuantizedIndex
from vq_tpu.methods.pq import PQ
from vq_tpu.methods.rabitq import RaBitQ
from vq_tpu.methods.sq import SQ
from vq_tpu.metrics.recall import recall_at_k


def _ivf(nq=16, nprobe=8):
    return IVFConfig(num_clusters=nq, nprobe=nprobe, kmeans=KMeansConfig(iters=8))


def test_ivf_search_shapes():
    data = load_dummy_dataset(num_vectors=1500, dim=32, num_queries=12, seed=0)
    idx = IvfQuantizedIndex(SQ(SQConfig(num_bits=8)), _ivf()).fit(data.vectors)
    ids, scores = idx.search_with_scores(data.queries, k=7)
    assert ids.shape == (12, 7)
    assert ids.dtype == np.uint32
    assert np.all(np.diff(scores, axis=1) >= -1e-4)  # L2 ascending


def test_ivf_full_probe_matches_flat_recall():
    # nprobe == nlist → exhaustive: recall should match the flat index
    data = load_dummy_dataset(num_vectors=2000, dim=32, num_queries=30, seed=1)
    sq_flat = SQ(SQConfig(num_bits=8))
    from vq_tpu.index.flat import FlatQuantizedIndex

    flat = FlatQuantizedIndex(sq_flat).fit(data.vectors)
    r_flat = recall_at_k(data.ground_truth, flat.search(data.queries, 10), 10)
    ivf = IvfQuantizedIndex(
        SQ(SQConfig(num_bits=8)), _ivf(nq=16, nprobe=16)
    ).fit(data.vectors)
    r_ivf = recall_at_k(data.ground_truth, ivf.search(data.queries, 10), 10)
    assert r_ivf >= r_flat - 0.05, (r_ivf, r_flat)


def test_ivf_recall_increases_with_nprobe():
    data = load_dummy_dataset(num_vectors=3000, dim=32, num_queries=40, seed=2)
    recalls = []
    for nprobe in (1, 4, 16):
        idx = IvfQuantizedIndex(
            SQ(SQConfig(num_bits=8)), _ivf(nq=16, nprobe=nprobe)
        ).fit(data.vectors)
        recalls.append(
            recall_at_k(data.ground_truth, idx.search(data.queries, 10), 10)
        )
    assert recalls[0] <= recalls[1] <= recalls[2]
    assert recalls[2] > 0.9  # 8-bit SQ residuals, full-ish probing


def test_ivf_pq_composite():
    data = load_dummy_dataset(num_vectors=2000, dim=32, num_queries=25, seed=3)
    idx = IvfQuantizedIndex(
        PQ(PQConfig(num_subquantizers=8, num_bits=8, kmeans=KMeansConfig(iters=8))),
        _ivf(nq=16, nprobe=12),
    ).fit(data.vectors)
    r = recall_at_k(data.ground_truth, idx.search(data.queries, 10), 10)
    assert r > 0.45, r


def test_ivf_rabitq_composite():
    data = load_dummy_dataset(num_vectors=2000, dim=32, num_queries=25, seed=4)
    idx = IvfQuantizedIndex(
        RaBitQ(RaBitQConfig(num_bits=4)), _ivf(nq=16, nprobe=12)
    ).fit(data.vectors)
    r = recall_at_k(data.ground_truth, idx.search(data.queries, 10), 10)
    assert r > 0.45, r


def test_ivf_save_load(tmp_path):
    data = load_dummy_dataset(num_vectors=900, dim=16, num_queries=10, seed=5)
    idx = IvfQuantizedIndex(SQ(SQConfig(num_bits=8)), _ivf(nq=8, nprobe=4)).fit(
        data.vectors
    )
    ids, scores = idx.search_with_scores(data.queries, k=5)
    p = str(tmp_path / "ivf.pkl")
    idx.save(p)
    idx2 = IvfQuantizedIndex(SQ(SQConfig(num_bits=8)), _ivf()).load(p)
    ids2, scores2 = idx2.search_with_scores(data.queries, k=5)
    np.testing.assert_array_equal(ids, ids2)
    np.testing.assert_allclose(scores, scores2, rtol=1e-5)


def test_ivf_reconstruction_mse():
    data = load_dummy_dataset(num_vectors=1200, dim=16, num_queries=5, seed=6)
    idx = IvfQuantizedIndex(SQ(SQConfig(num_bits=8)), _ivf(nq=8)).fit(data.vectors)
    mse = idx.reconstruction_mse(data.vectors, sample=500)
    assert 0 <= mse < 0.01  # 8-bit residual quantization


def test_ivf_decompress_by_global_id():
    """decompress(ids) reconstructs any row by GLOBAL id (reference
    ivf_index.cpp:245-374) — matches residual-quantize-then-add-centroid."""
    data = load_dummy_dataset(num_vectors=1000, dim=16, num_queries=5, seed=7)
    idx = IvfQuantizedIndex(SQ(SQConfig(num_bits=8)), _ivf(nq=8)).fit(
        data.vectors
    )
    ids = np.array([0, 17, 999, 500, 17])
    rec = idx.decompress(ids)
    assert rec.shape == (5, 16)
    # duplicate ids decode identically; reconstruction close to original
    np.testing.assert_allclose(rec[1], rec[4])
    err = np.mean((rec - data.vectors[ids]) ** 2)
    assert err < 0.01, err
    # round-trips through save/load
    import tempfile, os

    with tempfile.TemporaryDirectory() as td:
        p = os.path.join(td, "ivf.pkl")
        idx.save(p)
        idx2 = IvfQuantizedIndex(SQ(SQConfig(num_bits=8)), _ivf()).load(p)
        np.testing.assert_allclose(idx2.decompress(ids), rec)


def test_ivf_search_fn_cached_across_calls():
    """The jitted search is created once per (index, chunk) and re-traces
    only per new (block shape, k, nprobe) — a regression test: the old
    per-call closure re-traced on EVERY query block."""
    data = load_dummy_dataset(num_vectors=1500, dim=32, num_queries=40, seed=9)
    idx = IvfQuantizedIndex(SQ(SQConfig(num_bits=8)), _ivf()).fit(data.vectors)
    traces = {"n": 0}
    inner = idx.quantizer.decode_fn()

    def counting_decode_fn():
        def g(ct):
            traces["n"] += 1  # python side-effect fires only while TRACING
            return inner(ct)
        return g

    idx.quantizer.decode_fn = counting_decode_fn
    idx._search_fn = None
    ids1, _ = idx.search_with_scores(data.queries, k=5, query_block=8)
    first = traces["n"]
    assert first > 0
    # 5 blocks of 8 queries ran; a per-block retrace would have multiplied
    # the count — and a repeat call must not trace at all
    ids2, _ = idx.search_with_scores(data.queries, k=5, query_block=8)
    assert traces["n"] == first
    np.testing.assert_array_equal(ids1, ids2)


def test_ivf_fit_streams_chunks_never_materializes():
    """Chunked IVF construction: fit on an
    array-like corpus whose __array__ raises must succeed touching only
    bounded chunks — `jnp.asarray(X)` on the whole corpus fails loudly."""
    from test_bigfit import VirtualRows

    x = VirtualRows(n=60_000, d=64)
    idx = IvfQuantizedIndex(
        PQ(PQConfig(num_subquantizers=8, num_bits=4,
                    kmeans=KMeansConfig(iters=3))),
        IVFConfig(num_clusters=16, nprobe=8, kmeans=KMeansConfig(iters=3)),
    )
    idx.fit(x, chunk_rows=8192)
    # coarse sample + assignment pass + residual-fit sample + encode pass
    assert x.rows_served <= 4 * 60_000
    q = x[np.arange(8)]
    ids, scores = idx.search_with_scores(q, k=5)
    assert ids.shape == (8, 5)
    assert np.all(np.isfinite(scores))
    # jittered self-queries find themselves under full-ish probing
    rec = idx.decompress(np.arange(4))
    assert rec.shape == (4, 64)
    assert np.mean((rec - x[np.arange(4)]) ** 2) < np.var(x[np.arange(256)])


def test_ivf_chunked_fit_matches_unchunked():
    """Chunk size must not change the build: same centroids seed → same
    assignment → identical codes and search results."""
    data = load_dummy_dataset(num_vectors=2000, dim=32, num_queries=10, seed=10)
    a = IvfQuantizedIndex(SQ(SQConfig(num_bits=8)), _ivf()).fit(
        data.vectors, chunk_rows=333
    )
    b = IvfQuantizedIndex(SQ(SQConfig(num_bits=8)), _ivf()).fit(
        data.vectors
    )
    np.testing.assert_array_equal(
        np.asarray(a.codes_sorted), np.asarray(b.codes_sorted)
    )
    ia, sa = a.search_with_scores(data.queries, k=7)
    ib, sb = b.search_with_scores(data.queries, k=7)
    np.testing.assert_array_equal(ia, ib)
    np.testing.assert_allclose(sa, sb, rtol=1e-5)


def test_ivf_residual_scorer_matches_decode_path():
    """The rotated-query window scorer (methods/base.residual_scorer) must
    produce the same neighbors/scores as the decode_fn window path for
    every method that provides one (SAQ, RaBitQ, RankAware)."""
    from vq_tpu.core.config import RankAwareConfig, SAQConfig
    from vq_tpu.methods.rankaware import RankAware
    from vq_tpu.methods.saq import SAQ

    data = load_dummy_dataset(num_vectors=2000, dim=32, num_queries=15,
                              seed=11)
    quants = [
        SAQ(SAQConfig(bits_per_dim=2.0, use_pca=True)),
        RaBitQ(RaBitQConfig(num_bits=4)),
        RankAware(RankAwareConfig(bits_per_dim=2.0)),
    ]
    for quant in quants:
        idx = IvfQuantizedIndex(quant, _ivf(nq=16, nprobe=8)).fit(
            data.vectors
        )
        assert quant.residual_scorer() is not None
        ids_s, sc_s = idx.search_with_scores(data.queries, k=8)
        # force the decode_fn path on the SAME fitted index
        orig = quant.residual_scorer
        quant.residual_scorer = lambda: None
        idx._search_fn = None
        idx._c_side = None
        ids_d, sc_d = idx.search_with_scores(data.queries, k=8)
        quant.residual_scorer = orig
        np.testing.assert_array_equal(ids_s, ids_d)
        np.testing.assert_allclose(sc_s, sc_d, rtol=1e-4, atol=1e-4)


def test_ivf_skewed_cluster_sizes():
    """One giant cluster + many tiny ones: the windowed scan must stay
    correct (regression for the fixed max_cluster window, whose memory blew
    up with the largest cluster)."""
    rng = np.random.default_rng(8)
    # 2000 rows piled into one tight blob + 500 spread far apart
    blob = rng.standard_normal((2000, 16)).astype(np.float32) * 0.05
    spread = rng.standard_normal((500, 16)).astype(np.float32) * 10.0 + 30.0
    x = np.concatenate([blob, spread])
    q = np.concatenate([blob[:10] + 0.01, spread[:10] + 0.01])
    idx = IvfQuantizedIndex(
        SQ(SQConfig(num_bits=8)), _ivf(nq=16, nprobe=16)
    ).fit(x)
    assert int(np.max(np.asarray(idx.sizes))) > 500  # skew actually present
    ids_i, scores_i = idx.search_with_scores(q, k=5)
    # full probe → the windowed scan is an exact L2 scan over the index's
    # own reconstructions (residual decode + centroid)
    rec = idx.decompress(np.arange(len(x)))
    d_all = ((q[:, None, :] - rec[None, :, :]) ** 2).sum(-1)
    ref_scores = np.sort(d_all, axis=1)[:, :5]
    np.testing.assert_allclose(scores_i, ref_scores, rtol=1e-3, atol=1e-3)


def test_ivf_coarse_reuse_matches_self_fit():
    """fit(coarse=(centroids, assignment)) must equal the self-computed
    coarse pass (bench shares one k-means across residual configs)."""
    from vq_tpu.index.ivf import chunked_assign

    data = load_dummy_dataset(num_vectors=1200, dim=24, num_queries=10, seed=5)
    a = IvfQuantizedIndex(SQ(SQConfig(num_bits=8)), _ivf()).fit(data.vectors)
    asn = chunked_assign(data.vectors, a.centroids, 400)
    b = IvfQuantizedIndex(SQ(SQConfig(num_bits=8)), _ivf()).fit(
        data.vectors, coarse=(np.asarray(a.centroids), asn)
    )
    ia, sa = a.search_with_scores(data.queries, k=6)
    ib, sb = b.search_with_scores(data.queries, k=6)
    np.testing.assert_array_equal(ia, ib)
    np.testing.assert_allclose(sa, sb, rtol=1e-5, atol=1e-5)


def test_ivf_union_matches_windows_strategy():
    """The query-shared union scan (scan_union_lists) must return the same
    neighbors/scores as the per-(query, probe) window scan for scorer-less
    (SQ), scorer (RaBitQ) and PQ quantizers, across metrics — candidate
    sets are identical by construction, this asserts the scoring algebra
    (cd-table reuse, in-window centroid dots)."""
    from vq_tpu.core.config import SearchConfig

    data = load_dummy_dataset(num_vectors=2500, dim=32, num_queries=17,
                              seed=13)
    quants = [
        lambda: SQ(SQConfig(num_bits=8)),
        lambda: RaBitQ(RaBitQConfig(num_bits=4)),
        lambda: PQ(PQConfig(num_subquantizers=8, num_bits=6,
                            kmeans=KMeansConfig(iters=6))),
    ]
    for metric in (Metric.L2, Metric.IP, Metric.NIP):
        for make in quants:
            idx = IvfQuantizedIndex(
                make(), _ivf(nq=16, nprobe=7),
                search_cfg=SearchConfig(metric=metric),
            ).fit(data.vectors)
            iu, su = idx.search_with_scores(data.queries, k=8,
                                            strategy="union")
            iw, sw = idx.search_with_scores(data.queries, k=8,
                                            strategy="windows")
            np.testing.assert_allclose(su, sw, rtol=2e-4, atol=2e-4)
            # ids may legitimately swap at score ties; require the score
            # multisets to match and ids to match wherever scores are
            # distinct
            gap = np.abs(np.diff(sw, axis=1))
            distinct = np.ones_like(iw, bool)
            distinct[:, 1:] &= gap > 1e-4
            distinct[:, :-1] &= gap > 1e-4
            np.testing.assert_array_equal(iu[distinct], iw[distinct])


def test_union_qrs_slab_path_matches_oneshot(monkeypatch):
    """The probe-slabbed L2 recompute (bounded (Q, slab, D) buffers)
    must produce the same results as the one-shot
    (Q, P, D) difference — force the slab path by shrinking the budget."""
    import vq_tpu.index.ivf as ivf_mod

    data = load_dummy_dataset(num_vectors=2500, dim=32, num_queries=20,
                              seed=30)
    idx = IvfQuantizedIndex(SQ(SQConfig(num_bits=8)), _ivf(nq=16, nprobe=6)
                            ).fit(data.vectors)
    ids_a, sc_a = idx.search_with_scores(data.queries, k=8)

    monkeypatch.setattr(ivf_mod, "_QRS_SLAB_BYTES", 1024)  # slab of 1-2 probes
    idx._search_fn = None  # retrace under the patched constant
    ids_b, sc_b = idx.search_with_scores(data.queries, k=8)
    np.testing.assert_array_equal(ids_a, ids_b)
    np.testing.assert_allclose(sc_a, sc_b, rtol=1e-5, atol=1e-5)


def test_union_query_block_cap_matches_single_block():
    """A tiny decode budget forces the union path to map multiple query
    blocks; results must equal the one-block run."""
    data = load_dummy_dataset(num_vectors=2500, dim=32, num_queries=40,
                              seed=31)
    idx = IvfQuantizedIndex(SQ(SQConfig(num_bits=8)), _ivf(nq=16, nprobe=6)
                            ).fit(data.vectors)
    ids_a, sc_a = idx.search_with_scores(data.queries, k=8)
    idx._search_fn = None
    ids_b, sc_b = idx.search_with_scores(
        data.queries, k=8, decode_budget_bytes=16 * 4 * (16 + 2 * 4096)
    )  # cap = 16 queries/block → 3 blocks (pad-masked union per block)
    np.testing.assert_array_equal(ids_a, ids_b)
    np.testing.assert_allclose(sc_a, sc_b, rtol=1e-5, atol=1e-5)


def test_union_pad_queries_masked_out():
    """q_valid masks a block's pad rows out of the batch union: an
    invalid query contributes no probes (its scores come back -inf) and
    valid queries' results are unchanged."""
    import jax
    import jax.numpy as jnp

    from vq_tpu.index.ivf import scan_union_lists
    from vq_tpu.kernels.kmeans import pairwise_sqdist_xc

    data = load_dummy_dataset(num_vectors=1500, dim=32, num_queries=8,
                              seed=32)
    idx = IvfQuantizedIndex(SQ(SQConfig(num_bits=8)), _ivf(nq=16, nprobe=4)
                            ).fit(data.vectors)
    q = jnp.asarray(data.queries, jnp.float32)
    cd = pairwise_sqdist_xc(q, idx.centroids)
    _, probes = jax.lax.top_k(-cd, 4)
    decode_fn = idx.quantizer.decode_fn()

    args = (q, probes, cd, idx.centroids, idx.codes_sorted, idx.ids_sorted,
            idx.norms_sorted, idx.offsets, idx.sizes, decode_fn, 5,
            Metric.L2)
    s_all, i_all = scan_union_lists(*args)
    qv = jnp.array([True] * 7 + [False])
    s_m, i_m = scan_union_lists(*args, q_valid=qv)
    # valid queries unchanged
    np.testing.assert_array_equal(np.asarray(i_all)[:7], np.asarray(i_m)[:7])
    np.testing.assert_allclose(np.asarray(s_all)[:7], np.asarray(s_m)[:7],
                               rtol=1e-5)
    # masked query surfaces no candidates
    assert np.all(np.asarray(s_m)[7] == -np.inf)
