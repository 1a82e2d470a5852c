"""Sharded packed-scan serving (dist/sharded_packed.py) vs the
single-device packed scan and the code-row sharded path — 8-virtual-device
CPU mesh."""

import jax.numpy as jnp
import numpy as np
import pytest

from vq_tpu.core.config import (
    Metric,
    RaBitQConfig,
    SAQConfig,
    SearchConfig,
)
from vq_tpu.dist.mesh import make_mesh
from vq_tpu.dist.sharded_index import ShardedFlatIndex
from vq_tpu.dist.sharded_packed import ShardedPackedFlatIndex
from vq_tpu.kernels.adc import _finalize
from vq_tpu.methods import rabitq as rb_mod
from vq_tpu.methods import saq as saq_mod


def _corpus(rng, n=2600, d=48, lognorm=True):
    x = (rng.standard_normal((n, d)) * (1.0 + np.arange(d))[::-1] ** 0.5
         ).astype(np.float32)
    if lognorm:  # norm-heterogeneous rows
        x *= np.exp(0.5 * rng.standard_normal((n, 1))).astype(np.float32)
    q = x[rng.integers(0, n, 12)] + 0.05 * rng.standard_normal(
        (12, d)).astype(np.float32)
    return x, q


def _single_device(m, q, codes, k, metric, norms=None):
    q = jnp.asarray(q, jnp.float32)
    cache = m.prepare_tile_cache(codes, norms=norms)
    s, i = m.packed_scan_raw(q, cache, k, metric, use_bf16=False)
    return _finalize(s, i, metric, jnp.sum(q * q, axis=-1))


@pytest.mark.parametrize("overlap_chunks", [1, 4])
def test_sharded_packed_saq_matches_single_device(overlap_chunks):
    rng = np.random.default_rng(0)
    x, q = _corpus(rng)
    m = saq_mod.SAQ(SAQConfig(bits_per_dim=2.0, use_pca=True))
    m.fit(x)
    codes = jnp.asarray(m.compress(x))

    idx = ShardedPackedFlatIndex(
        m, SearchConfig(metric=Metric.L2, use_bf16=False),
        mesh=make_mesh(),
    )
    idx.fit(x)
    ids, scores = idx.search_with_scores(q, k=8,
                                         overlap_chunks=overlap_chunks)

    # single-device packed reference
    s_ref, i_ref = _single_device(m, q, codes, 8, Metric.L2)
    np.testing.assert_array_equal(ids, np.asarray(i_ref).astype(np.uint32))
    np.testing.assert_allclose(scores, np.asarray(s_ref), rtol=2e-4,
                               atol=2e-4)


def test_sharded_packed_matches_xla_sharded_index():
    rng = np.random.default_rng(1)
    x, q = _corpus(rng, n=2100)
    m = saq_mod.SAQ(SAQConfig(bits_per_dim=2.0, use_pca=True))
    m.fit(x)

    packed = ShardedPackedFlatIndex(
        m, SearchConfig(metric=Metric.L2, use_bf16=False), mesh=make_mesh()
    ).fit(x)
    xla = ShardedFlatIndex(
        m, SearchConfig(metric=Metric.L2, use_bf16=False), mesh=make_mesh()
    ).fit(x)
    ids_p, s_p = packed.search_with_scores(q, k=7)
    ids_x, s_x = xla.search_with_scores(q, k=7)
    np.testing.assert_array_equal(ids_p, ids_x)
    np.testing.assert_allclose(s_p, s_x, rtol=2e-4, atol=2e-4)


def test_sharded_packed_rabitq():
    rng = np.random.default_rng(2)
    x, q = _corpus(rng, n=2304, lognorm=False)
    m = rb_mod.RaBitQ(RaBitQConfig(num_bits=2))
    m.fit(x)
    codes = jnp.asarray(m.compress(x))

    idx = ShardedPackedFlatIndex(
        m, SearchConfig(metric=Metric.L2, use_bf16=False), mesh=make_mesh()
    ).fit(x)
    ids, scores = idx.search_with_scores(q, k=6)
    s_ref, i_ref = _single_device(m, q, codes, 6, Metric.L2)
    np.testing.assert_array_equal(ids, np.asarray(i_ref).astype(np.uint32))
    np.testing.assert_allclose(scores, np.asarray(s_ref), rtol=2e-4,
                               atol=2e-4)


def test_sharded_packed_nip_metric():
    rng = np.random.default_rng(3)
    x, q = _corpus(rng, n=2100)
    m = saq_mod.SAQ(SAQConfig(bits_per_dim=2.0, use_pca=True))
    m.fit(x)
    codes = jnp.asarray(m.compress(x))
    norms = jnp.linalg.norm(jnp.asarray(x), axis=-1)

    idx = ShardedPackedFlatIndex(
        m, SearchConfig(metric=Metric.NIP, use_bf16=False), mesh=make_mesh()
    ).fit(x)
    ids, scores = idx.search_with_scores(q, k=6)
    s_ref, i_ref = _single_device(m, q, codes, 6, Metric.NIP, norms=norms)
    np.testing.assert_array_equal(ids, np.asarray(i_ref).astype(np.uint32))
    np.testing.assert_allclose(scores, np.asarray(s_ref), rtol=2e-4,
                               atol=2e-4)


def test_sharded_packed_save_load(tmp_path):
    """Round-trip through save/load reproduces identical results on the
    same-size mesh; a mismatched shard count is rejected."""
    rng = np.random.default_rng(4)
    x, q = _corpus(rng, n=2100)
    m = saq_mod.SAQ(SAQConfig(bits_per_dim=2.0, use_pca=True))
    idx = ShardedPackedFlatIndex(
        m, SearchConfig(use_bf16=False), mesh=make_mesh()
    ).fit(x)
    ids, scores = idx.search_with_scores(q, k=6)
    p = str(tmp_path / "spf.pkl")
    idx.save(p)

    idx2 = ShardedPackedFlatIndex(
        saq_mod.SAQ(SAQConfig(bits_per_dim=2.0, use_pca=True)),
        SearchConfig(use_bf16=False), mesh=make_mesh(),
    ).load(p)
    ids2, scores2 = idx2.search_with_scores(q, k=6)
    np.testing.assert_array_equal(ids, ids2)
    np.testing.assert_allclose(scores, scores2, rtol=1e-5)

    state = idx._state()
    state["num_shards"] = idx.num_shards + 1
    with pytest.raises(ValueError, match="shards"):
        idx2._restore(state)
