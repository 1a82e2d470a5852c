"""The jnp packed scan (kernels/packed.py) vs the code-row XLA scans.

The packed scan reads the tile-ordered word layout and the precomputed
factor columns; the code-row scans (methods/*.scan_topk) parse the stored
byte rows.  Equal ids and scores check the layout and the factor algebra.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from vq_tpu.core.config import Metric, SAQConfig
from vq_tpu.kernels.adc import _finalize
from vq_tpu.kernels.packed import _unpack_words, make_segspec, pack_words
from vq_tpu.methods import saq as saq_mod


def _packed_topk(m, q, codes, k, metric, norms=None, num_valid=None,
                 cache=None):
    """Finalized top-k through the packed scan (methods' packed_scan_raw)."""
    if cache is None:
        cache = m.prepare_tile_cache(
            codes, norms=norms if metric == Metric.NIP else None)
    q = jnp.asarray(q, jnp.float32)
    s, i = m.packed_scan_raw(q, cache, k, metric, num_valid=num_valid,
                             use_bf16=False)
    return _finalize(s, i, metric, jnp.sum(q * q, axis=-1))


@pytest.mark.parametrize("bits", [1, 2, 3, 4, 5, 6, 8])
def test_pack_words_roundtrip_all_widths(bits):
    """pack_words → the scan's _unpack_words is the identity at every
    width (beff = bits rounded up to a power of two)."""
    rng = np.random.default_rng(0)
    ln, n = 37, 1024
    seg = make_segspec(bits, ln, "uniform", -1)
    idx = rng.integers(0, 1 << bits, size=(n, ln))
    w = pack_words(jnp.asarray(idx), bits, seg.beff)
    assert w.shape == (n // seg.u, ln)
    np.testing.assert_array_equal(np.asarray(_unpack_words(w, seg)), idx)


def test_pack_words_tile_order_roundtrip():
    """Within each `tile` rows, shift-plane j holds natural rows
    [j·tile/u, (j+1)·tile/u) — what _unpack_words relies on."""
    rng = np.random.default_rng(4)
    for bits, beff, tile in ((1, 1, 512), (2, 2, 512), (4, 4, 512),
                             (8, 8, 512), (1, 2, 512), (3, 4, 1024)):
        u = 32 // beff
        n, ln = 2 * tile, 19
        idx = rng.integers(0, 1 << bits, size=(n, ln))
        w = np.asarray(pack_words(jnp.asarray(idx), bits, beff, tile=tile))
        assert w.shape == (n // u, ln)
        rt = tile // u
        chunks = [((w.astype(np.uint32) >> (beff * j)) & ((1 << bits) - 1))
                  for j in range(u)]
        # per tile t, plane j rows are w[t*rt:(t+1)*rt] → natural block j
        got = np.concatenate(
            [np.concatenate([c[t * rt : (t + 1) * rt] for c in chunks])
             for t in range(n // tile)]
        )
        np.testing.assert_array_equal(got, idx)


def test_pack_words_explicit_beff_roundtrip():
    """1-bit codes stored at beff=2 (u=16) unpack exactly."""
    rng = np.random.default_rng(2)
    idx = rng.integers(0, 2, size=(512, 14))
    seg = make_segspec(1, 14, "uniform", -1)._replace(beff=2)
    w = pack_words(jnp.asarray(idx), 1, 2)
    assert w.shape == (32, 14)
    np.testing.assert_array_equal(np.asarray(_unpack_words(w, seg)), idx)


def _mk_saq(rng, n=640, d=48, bpd=2.0, codebook="uniform", use_pca=True):
    x = (rng.standard_normal((n, d)) * (1.0 + np.arange(d))[::-1] ** 0.5
         ).astype(np.float32)
    cfg = SAQConfig(bits_per_dim=bpd, use_pca=use_pca, codebook=codebook)
    m = saq_mod.SAQ(cfg)
    m.fit(x)
    codes = jnp.asarray(m.compress(x))
    return m, x, codes


@pytest.mark.parametrize("codebook", ["uniform", "lloyd"])
@pytest.mark.parametrize("metric", [Metric.L2, Metric.IP, Metric.NIP])
def test_saq_packed_matches_xla_scan(codebook, metric):
    rng = np.random.default_rng(3)
    m, x, codes = _mk_saq(rng, codebook=codebook)
    q = rng.standard_normal((16, x.shape[1])).astype(np.float32)
    norms = jnp.linalg.norm(jnp.asarray(x), axis=-1)

    s_ref, i_ref = saq_mod.scan_topk(
        m.plan, m.params, jnp.asarray(q), codes, 8, metric, norms=norms,
        use_bf16=False,
    )
    s_pk, i_pk = _packed_topk(m, q, codes, 8, metric, norms=norms)
    np.testing.assert_array_equal(np.asarray(i_pk), np.asarray(i_ref))
    np.testing.assert_allclose(
        np.asarray(s_pk), np.asarray(s_ref), rtol=2e-4, atol=2e-4
    )


def test_saq_packed_cache_reuse_and_num_valid():
    rng = np.random.default_rng(5)
    m, x, codes = _mk_saq(rng)
    q = rng.standard_normal((8, x.shape[1])).astype(np.float32)
    cache = saq_mod.prepare_packed(m.plan, m.params, codes)
    nv = jnp.int32(300)
    s_ref, i_ref = saq_mod.scan_topk(
        m.plan, m.params, jnp.asarray(q), codes, 5, Metric.L2,
        use_bf16=False, num_valid=nv,
    )
    for _ in range(2):  # one cache serves repeated scans
        s_pk, i_pk = _packed_topk(m, q, codes, 5, Metric.L2, num_valid=nv,
                                  cache=cache)
        np.testing.assert_array_equal(np.asarray(i_pk), np.asarray(i_ref))
    assert np.asarray(i_pk).max() < 300


@pytest.mark.parametrize("codebook", ["uniform", "lloyd"])
def test_saq_packed_high_bpd_values_path(codebook):
    """bpd=6 derived codebooks allocate ≥5-bit segments → the f32
    value-plane layout (kernels/packed.py "values") must stay id-exact vs
    the code-row scan."""
    rng = np.random.default_rng(21)
    m, x, codes = _mk_saq(rng, n=640, d=48, bpd=6.0, codebook=codebook)
    if codebook == "lloyd":
        segs = saq_mod.packed_segspecs(m.plan, m.params)[0]
        assert any(s.dequant == "values" for s in segs), segs
    q = rng.standard_normal((12, 48)).astype(np.float32)
    s_ref, i_ref = saq_mod.scan_topk(
        m.plan, m.params, jnp.asarray(q), codes, 8, Metric.L2,
        use_bf16=False,
    )
    s_pk, i_pk = _packed_topk(m, q, codes, 8, Metric.L2)
    np.testing.assert_array_equal(np.asarray(i_pk), np.asarray(i_ref))
    np.testing.assert_allclose(
        np.asarray(s_pk), np.asarray(s_ref), rtol=2e-4, atol=2e-4
    )


@pytest.mark.parametrize("num_bits", [1, 4, 8])
@pytest.mark.parametrize("metric", [Metric.L2, Metric.IP, Metric.NIP])
def test_rabitq_packed_matches_xla_scan(num_bits, metric):
    from vq_tpu.core.config import RaBitQConfig
    from vq_tpu.methods import rabitq as rb_mod

    rng = np.random.default_rng(11)
    x = rng.standard_normal((640, 40)).astype(np.float32) + 0.3
    m = rb_mod.RaBitQ(RaBitQConfig(num_bits=num_bits))
    m.fit(x)
    codes = jnp.asarray(m.compress(x))
    q = rng.standard_normal((16, 40)).astype(np.float32)
    norms = jnp.linalg.norm(jnp.asarray(x), axis=-1)

    s_ref, i_ref = rb_mod.scan_topk(
        m.params, jnp.asarray(q), codes, 8, metric, num_bits, norms=norms,
        use_bf16=False,
    )
    s_pk, i_pk = _packed_topk(m, q, codes, 8, metric, norms=norms)
    np.testing.assert_array_equal(np.asarray(i_pk), np.asarray(i_ref))
    np.testing.assert_allclose(
        np.asarray(s_pk), np.asarray(s_ref), rtol=2e-4, atol=2e-4
    )


@pytest.mark.parametrize("packing", ["dense", "ffd"])
@pytest.mark.parametrize("metric", [Metric.L2, Metric.NIP])
def test_rankaware_packed_matches_xla_scan(packing, metric):
    from vq_tpu.core.config import RankAwareConfig
    from vq_tpu.methods import rankaware as ra_mod

    rng = np.random.default_rng(13)
    x = (rng.standard_normal((640, 40)) * (1.0 + np.arange(40))[::-1]
         ).astype(np.float32)
    m = ra_mod.RankAware(RankAwareConfig(bits_per_dim=2.0, packing=packing))
    m.fit(x)
    codes = jnp.asarray(m.compress(x))
    q = rng.standard_normal((12, 40)).astype(np.float32)
    norms = jnp.linalg.norm(jnp.asarray(x), axis=-1)

    s_ref, i_ref = m.scan_topk(
        jnp.asarray(q), codes, 8, metric, norms=norms, use_bf16=False,
    )
    s_pk, i_pk = _packed_topk(m, q, codes, 8, metric, norms=norms)
    np.testing.assert_array_equal(np.asarray(i_pk), np.asarray(i_ref))
    np.testing.assert_allclose(
        np.asarray(s_pk), np.asarray(s_ref), rtol=2e-4, atol=2e-4
    )


def test_saq_packed_cascade_matches_dense_recall():
    """Stage-1 (head segments) + exact rescore finds the same neighbors as
    the dense scan on easy data."""
    rng = np.random.default_rng(7)
    # d=128 → two 64-dim allocation blocks; the steep variance profile makes
    # the allocator give them different widths → ≥ 2 segments
    m, x, codes = _mk_saq(rng, n=1024, d=128, bpd=2.0)
    assert m.plan.num_segments >= 2, m.plan
    qi = rng.integers(0, 1024, size=12)
    q = x[qi] + 0.01 * rng.standard_normal((12, 128)).astype(np.float32)

    s_d, i_d = saq_mod.scan_topk(
        m.plan, m.params, jnp.asarray(q), codes, 10, Metric.L2,
        use_bf16=False,
    )
    s_c, i_c = saq_mod.scan_topk(
        m.plan, m.params, jnp.asarray(q), codes, 10, Metric.L2,
        use_bf16=False, prune_segments=1, rerank_factor=10,
    )
    # top-1 must agree; cascade top-10 overlap ≥ 80% (stage-1 is an estimate)
    np.testing.assert_array_equal(
        np.asarray(i_c)[:, 0], np.asarray(i_d)[:, 0]
    )
    overlap = np.mean([
        len(set(np.asarray(i_c)[j]) & set(np.asarray(i_d)[j])) / 10
        for j in range(12)
    ])
    assert overlap >= 0.8, overlap


def test_nip_refuses_normless_packed_cache():
    """A PackedCorpus built without real norms must be rejected for NIP
    instead of silently returning un-normalized scores."""
    rng = np.random.default_rng(37)
    m, x, codes = _mk_saq(rng)
    q = jnp.asarray(rng.standard_normal((4, x.shape[1])), jnp.float32)
    cache = saq_mod.prepare_packed(m.plan, m.params, codes)  # no norms
    assert not cache.has_norms
    with pytest.raises(ValueError, match="norms"):
        m.packed_scan_raw(q, cache, 5, Metric.NIP)
    with pytest.raises(ValueError, match="norms"):
        saq_mod.scan_topk(m.plan, m.params, q, codes, 5, Metric.NIP)


def test_saq_packed_high_bits_derived_codebook():
    """B=7/8 derived-codebook segments take the value-plane layout;
    equality vs the code-row scan at bpd=7.5, codebook=lloyd."""
    rng = np.random.default_rng(41)
    m, x, codes = _mk_saq(rng, n=640, d=32, bpd=7.5, codebook="lloyd")
    assert max(m.plan.seg_bits) >= 7, m.plan
    segs, lv = saq_mod.packed_segspecs(m.plan, m.params)
    assert all(s.dequant == "values" for s in segs if s.bits >= 7)
    q = rng.standard_normal((8, 32)).astype(np.float32)
    s_ref, i_ref = saq_mod.scan_topk(
        m.plan, m.params, jnp.asarray(q), codes, 8, Metric.L2,
        use_bf16=False,
    )
    s_pk, i_pk = _packed_topk(m, q, codes, 8, Metric.L2)
    np.testing.assert_array_equal(np.asarray(i_pk), np.asarray(i_ref))
    np.testing.assert_allclose(
        np.asarray(s_pk), np.asarray(s_ref), rtol=2e-4, atol=2e-4
    )


def _restricted_ref(m, codes, q, tiles, n, k):
    """Brute-force L2 top-k over the rows of `tiles` (maximize form, the
    raw scan's convention without the query constant −‖q‖²)."""
    rec = m.decompress(np.asarray(codes))
    rows = np.concatenate([np.arange(t * 512, (t + 1) * 512) for t in tiles])
    rows = rows[rows < n]
    d2 = ((np.asarray(q)[:, None, :] - rec[None, rows, :]) ** 2).sum(-1)
    q_sq = (np.asarray(q) ** 2).sum(-1, keepdims=True)
    return rows[np.argsort(d2, axis=1)[:, :k]], q_sq - np.sort(d2, axis=1)[:, :k]


def test_tile_gather_mask_matches_restricted_scan():
    """The gather-compacted tile mask: a partial mask must equal a brute
    scan restricted to masked-in rows, and an all-ones mask must equal the
    unmasked scan."""
    rng = np.random.default_rng(11)
    m, x, codes = _mk_saq(rng, n=4096)
    q = jnp.asarray(rng.standard_normal((8, x.shape[1])).astype(np.float32))
    cache = m.prepare_tile_cache(codes)
    nb = cache.factors.shape[0] // 512
    assert nb >= 4

    s_um, i_um = m.packed_scan_raw(q, cache, 6, Metric.L2, use_bf16=False)
    ones = jnp.ones((nb,), jnp.int32)
    s_m1, i_m1 = m.packed_scan_raw(q, cache, 6, Metric.L2, use_bf16=False,
                                   tile_mask=ones)
    np.testing.assert_array_equal(np.asarray(i_m1), np.asarray(i_um))

    mask = (jnp.arange(nb) % 3 == 1).astype(jnp.int32)
    s_mp, i_mp = m.packed_scan_raw(q, cache, 6, Metric.L2, use_bf16=False,
                                   tile_mask=mask)
    ref_ids, ref_s = _restricted_ref(
        m, codes, q, np.nonzero(np.asarray(mask))[0], x.shape[0], 6)
    np.testing.assert_allclose(np.asarray(s_mp), ref_s, rtol=1e-3,
                               atol=1e-3)
    tied = np.isclose(np.asarray(s_mp), ref_s, rtol=1e-4, atol=1e-4)
    assert np.all((np.asarray(i_mp) == ref_ids) | tied)


@pytest.mark.parametrize("case", ["at_cap", "under_cap", "over_cap", "empty"])
def test_tile_mask_gather_cap(case):
    """mask_cap bounds the compacted tile walk: a masked-in count at or
    under the cap walks only `cap` tiles, one over it falls back to the
    full tile set — exact either way; an empty mask scores nothing."""
    rng = np.random.default_rng(19)
    m, x, codes = _mk_saq(rng, n=20 * 512 - 100)
    q = jnp.asarray(rng.standard_normal((5, x.shape[1])).astype(np.float32))
    cache = m.prepare_tile_cache(codes)
    nb = cache.factors.shape[0] // 512
    tiles = [] if case == "empty" else [1, 4, 7, nb - 1]
    mask = jnp.zeros((nb,), jnp.int32).at[jnp.asarray(tiles, jnp.int32)].set(1)
    cap = {"at_cap": 4, "under_cap": 9, "over_cap": 3, "empty": 4}[case]
    s, i = m.packed_scan_raw(q, cache, 7, Metric.L2, use_bf16=False,
                             tile_mask=mask, mask_cap=cap)
    if case == "empty":
        assert np.all(np.isneginf(np.asarray(s)))
        return
    s_full, i_full = m.packed_scan_raw(q, cache, 7, Metric.L2,
                                       use_bf16=False, tile_mask=mask)
    np.testing.assert_array_equal(np.asarray(i), np.asarray(i_full))
    np.testing.assert_array_equal(np.asarray(s), np.asarray(s_full))
    ref_ids, ref_s = _restricted_ref(m, codes, q, tiles, x.shape[0], 7)
    np.testing.assert_allclose(np.asarray(s), ref_s, rtol=1e-3, atol=1e-3)
    tied = np.isclose(np.asarray(s), ref_s, rtol=1e-4, atol=1e-4)
    assert np.all((np.asarray(i) == ref_ids) | tied)


def test_packed_scan_ragged_chunks_match_xla_scan():
    """A tile count that is not a multiple of the 32-tile scan chunk (and a
    ragged last tile) matches the code-row scan at large k."""
    rng = np.random.default_rng(12)
    m, x, codes = _mk_saq(rng, n=37 * 512 - 200)
    q = jnp.asarray(rng.standard_normal((16, x.shape[1])).astype(np.float32))
    norms = jnp.linalg.norm(jnp.asarray(x), axis=-1)
    for k in (32, 100):
        s_ref, i_ref = saq_mod.scan_topk(
            m.plan, m.params, q, codes, k, Metric.L2, norms=norms,
            use_bf16=False,
        )
        s_pk, i_pk = _packed_topk(m, q, codes, k, Metric.L2)
        np.testing.assert_array_equal(np.asarray(i_pk), np.asarray(i_ref))
        np.testing.assert_allclose(np.asarray(s_pk), np.asarray(s_ref),
                                   rtol=2e-4, atol=2e-4)


def test_merge_fold_large_k_matches_xla_scan():
    """Large k (several tiles' worth of candidates) — ids must stay
    identical to the code-row scan, including with a tile mask."""
    rng = np.random.default_rng(12)
    m, x, codes = _mk_saq(rng, n=4096)
    q = jnp.asarray(rng.standard_normal((16, x.shape[1])).astype(np.float32))
    norms = jnp.linalg.norm(jnp.asarray(x), axis=-1)
    for k in (32, 64, 100):
        s_ref, i_ref = saq_mod.scan_topk(
            m.plan, m.params, q, codes, k, Metric.L2, norms=norms,
            use_bf16=False,
        )
        s_pk, i_pk = _packed_topk(m, q, codes, k, Metric.L2)
        np.testing.assert_array_equal(np.asarray(i_pk), np.asarray(i_ref))
        np.testing.assert_allclose(np.asarray(s_pk), np.asarray(s_ref),
                                   rtol=2e-4, atol=2e-4)

    cache = saq_mod.prepare_packed(m.plan, m.params, codes)
    nb = cache.factors.shape[0] // 512
    mask = (jnp.arange(nb) % 2 == 0).astype(jnp.int32)
    s_mp, i_mp = m.packed_scan_raw(q, cache, 64, Metric.L2, use_bf16=False,
                                   tile_mask=mask)
    ref_ids, ref_s = _restricted_ref(
        m, codes, q, np.nonzero(np.asarray(mask))[0], x.shape[0], 64)
    np.testing.assert_allclose(np.asarray(s_mp), ref_s, rtol=1e-3, atol=1e-3)
    tied = np.isclose(np.asarray(s_mp), ref_s, rtol=1e-4, atol=1e-4)
    assert np.all((np.asarray(i_mp) == ref_ids) | tied)
