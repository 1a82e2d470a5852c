"""53M-safe fit paths.

The contract: fitting on a host corpus (numpy / np.memmap / array-like)
must never materialize the full corpus — only host-side row samples or
bounded chunks may be touched.  `VirtualRows` below enforces this by
raising MemoryError from __array__, so any `jnp.asarray(X)` /
`np.asarray(X)` on the whole corpus fails the test immediately.
"""

import os

import numpy as np
import pytest

from vq_tpu.bench.registry import build_quantizer


class VirtualRows:
    """A 10M×1024 corpus that generates rows on demand and refuses full
    materialization."""

    def __init__(self, n=10_000_000, d=1024):
        self.shape = (n, d)
        self.dtype = np.float32
        self.rows_served = 0

    def __len__(self):
        return self.shape[0]

    def _make(self, idx):
        idx = np.asarray(idx).reshape(-1)
        self.rows_served += len(idx)
        d = self.shape[1]
        # cheap deterministic pseudo-data with per-dim scale spread
        base = ((idx[:, None] * 2654435761 + np.arange(d)[None, :] * 97) % 1013)
        return (base.astype(np.float32) / 1013.0 - 0.5) * (
            1.0 + np.arange(d, dtype=np.float32) / d
        )

    def __getitem__(self, key):
        if isinstance(key, slice):
            start, stop, step = key.indices(self.shape[0])
            return self._make(np.arange(start, stop, step))
        if isinstance(key, np.ndarray):
            return self._make(key)
        raise TypeError(f"unsupported index {key!r}")

    def __array__(self, *a, **k):
        raise MemoryError(
            "full materialization of a 40 GB virtual corpus attempted"
        )


def test_host_sample_rows_never_materializes():
    from vq_tpu.data.sampling import host_sample_rows

    x = VirtualRows()
    s = host_sample_rows(x, 10_000, seed=1)
    assert s.shape == (10_000, 1024) and s.dtype == np.float32
    assert x.rows_served == 10_000


@pytest.mark.parametrize(
    "method,kw",
    [
        ("pq", {"M": 8, "B": 4}),
        ("saq", {"bpd": 1.0}),
        ("rankaware", {"bpd": 1.0}),
        ("opq", {"M": 8, "B": 4, "opq_iters": 1}),
    ],
)
def test_fit_on_10m_virtual_corpus(method, kw):
    """fit() must complete on a 10M-row corpus touching only its sample."""
    x = VirtualRows()
    model = build_quantizer(method, 1024, **kw)
    model.fit(x)
    assert x.rows_served <= 300_000  # ≤ sample cap (+slack), NOT 10M
    # encode a small batch end-to-end to prove the fit is usable
    batch = x[np.arange(256)]
    rec = model.decompress(model.compress(batch))
    assert rec.shape == batch.shape
    assert np.mean((batch - rec) ** 2) < np.var(batch)


def test_sq_chunked_min_max_on_host_corpus(rng):
    """SQ's per-dim min/max accumulates in bounded chunks (no full-corpus
    device transfer) and matches the exact answer."""
    from vq_tpu.data.sampling import chunked_min_max

    x = rng.standard_normal((30_000, 64)).astype(np.float32)
    lo, hi = chunked_min_max(x, chunk_rows=4096)
    assert np.allclose(np.asarray(lo), x.min(axis=0))
    assert np.allclose(np.asarray(hi), x.max(axis=0))

    model = build_quantizer("sq", 64, bits=8).fit(x)
    rec = model.decompress(model.compress(x[:128]))
    assert np.mean((x[:128] - rec) ** 2) < 1e-4


def test_streaming_sweep_over_mmap(tmp_path, rng):
    """streaming_sweep over an np.memmap shard: the 53M pattern in miniature
    (sparse file, bounded train slice, batched compress)."""
    from vq_tpu.bench.streaming import streaming_sweep

    path = tmp_path / "huge_base.npy"
    mm = np.lib.format.open_memmap(
        str(path), mode="w+", dtype=np.float32, shape=(400_000, 128)
    )
    mm[:5000] = rng.standard_normal((5000, 128)).astype(np.float32)
    del mm  # flush; the rest of the file stays sparse zeros

    res = streaming_sweep(
        dataset="huge",
        methods=("pq",),
        train_size=5000,
        batch_size=100_000,
        max_vectors=300_000,
        db_path=str(tmp_path / "runs.db"),
        data_dir=str(tmp_path),
        method_params={"pq": {"M": 8, "B": 4}},
    )
    m = res[0]["metrics"]
    assert m["streamed_vectors"] == 300_000
    assert np.isfinite(m["mse"])
