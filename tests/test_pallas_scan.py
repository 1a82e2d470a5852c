"""The XLA PQ scan (kernels/adc.scan_codes_topk) against a decoded brute
force in numpy: L2 and IP scores, the num_valid limit, tie order, and large
k over several tiles.  f32 scoring throughout (the CPU backend has no bf16
dot), so the comparisons are exact up to f32 summation order."""

import numpy as np
import pytest

import jax.numpy as jnp

from vq_tpu.core.config import Metric
from vq_tpu.kernels.adc import decode_pq, scan_codes_topk


def _setup(n=1024, d=64, q=16, m=8, k=16, seed=0):
    rng = np.random.default_rng(seed)
    queries = rng.standard_normal((q, d)).astype(np.float32)
    codes = rng.integers(0, k, (n, m)).astype(np.uint8)
    cb = rng.standard_normal((m, k, d // m)).astype(np.float32)
    return queries, codes, cb


def _decode_np(cb, codes):
    m = cb.shape[0]
    return np.concatenate([cb[j][codes[:, j]] for j in range(m)], axis=1)


def _brute(queries, codes, cb, metric):
    """Natural-form scores over the decoded corpus (float64)."""
    dec = _decode_np(cb, codes).astype(np.float64)
    q = queries.astype(np.float64)
    if metric == Metric.L2:
        return ((q[:, None, :] - dec[None]) ** 2).sum(-1)
    return q @ dec.T


def _check_topk(s, i, ref, k, ascending):
    """ids agree with the reference ranking up to exact f32 near-ties, and
    scores equal the reference score of the returned id."""
    s, i = np.asarray(s), np.asarray(i)
    got = np.take_along_axis(ref, i.astype(np.int64), axis=1)
    np.testing.assert_allclose(s, got, rtol=1e-4, atol=1e-3)
    want = np.sort(ref, axis=1)[:, :k] if ascending else -np.sort(-ref, axis=1)[:, :k]
    np.testing.assert_allclose(s, want, rtol=1e-4, atol=1e-3)


def test_decode_pq_matches_numpy_gather():
    queries, codes, cb = _setup(seed=8)
    np.testing.assert_array_equal(
        np.asarray(decode_pq(jnp.asarray(cb), jnp.asarray(codes))),
        _decode_np(cb, codes),
    )


@pytest.mark.parametrize("metric", [Metric.L2, Metric.IP])
def test_pq_scan_matches_decoded_brute_force(metric):
    queries, codes, cb = _setup(seed=1)
    s, i = scan_codes_topk(jnp.asarray(queries), jnp.asarray(codes),
                           jnp.asarray(cb), k=7, metric=metric,
                           use_bf16=False)
    ref = _brute(queries, codes, cb, metric)
    _check_topk(s, i, ref, 7, ascending=(metric == Metric.L2))


def test_pq_scan_num_valid_masks_rows():
    queries, codes, cb = _setup(n=512, seed=3)
    limit = 300
    s, i = scan_codes_topk(jnp.asarray(queries), jnp.asarray(codes),
                           jnp.asarray(cb), k=5, metric=Metric.L2,
                           tile_rows=128, use_bf16=False,
                           num_valid=jnp.int32(limit))
    assert np.all(np.asarray(i) < limit)
    ref = _brute(queries, codes[:limit], cb, Metric.L2)
    _check_topk(s, i, ref, 5, ascending=True)


def test_pq_scan_duplicate_rows_tie_to_lowest_id():
    """Identical rows produce identical scores; ties order by ascending id
    across tile boundaries (tile_rows=96 splits the corpus into 6 tiles)."""
    rng = np.random.default_rng(4)
    row = rng.integers(0, 16, (1, 8))
    codes = jnp.asarray(np.repeat(row, 512, axis=0), jnp.uint8)
    queries = jnp.asarray(rng.standard_normal((4, 64)), jnp.float32)
    cb = jnp.asarray(rng.standard_normal((8, 16, 8)), jnp.float32)
    s, i = scan_codes_topk(queries, codes, cb, k=6, metric=Metric.L2,
                           tile_rows=96, use_bf16=False)
    np.testing.assert_array_equal(np.asarray(i), np.tile(np.arange(6), (4, 1)))
    assert np.allclose(np.asarray(s), np.asarray(s)[:, :1])


@pytest.mark.parametrize("tile_rows", [256, 1000])
def test_pq_scan_tiling_does_not_change_result(tile_rows):
    """Ragged and even tilings give the single-tile result exactly."""
    queries, codes, cb = _setup(n=2048, seed=5)
    args = (jnp.asarray(queries), jnp.asarray(codes), jnp.asarray(cb))
    s1, i1 = scan_codes_topk(*args, k=9, metric=Metric.L2, tile_rows=2048,
                             use_bf16=False)
    s2, i2 = scan_codes_topk(*args, k=9, metric=Metric.L2,
                             tile_rows=tile_rows, use_bf16=False)
    np.testing.assert_array_equal(np.asarray(i1), np.asarray(i2))
    np.testing.assert_allclose(np.asarray(s1), np.asarray(s2), rtol=1e-6,
                               atol=1e-5)


def test_pq_scan_large_k_over_many_tiles():
    """k=100 over 40 tiles takes the rolled running-merge loop."""
    queries, codes, cb = _setup(n=4096, seed=9)
    s, i = scan_codes_topk(jnp.asarray(queries), jnp.asarray(codes),
                           jnp.asarray(cb), k=100, metric=Metric.L2,
                           tile_rows=104, use_bf16=False)
    ref = _brute(queries, codes, cb, Metric.L2)
    _check_topk(s, i, ref, 100, ascending=True)
