"""Host-side subsampling and chunked statistics for pod-scale fits.

Round-1 fits did `jnp.asarray(X)` on the FULL corpus and then subsampled on
device — a 217 GB HBM transfer at the 53M×1024-d target.
Every fit path now calls `host_sample_rows` first: numpy / np.memmap /
array-like corpora are sampled on the host (sorted indices keep mmap reads
sequential) and only the ≤cap sample is transferred; jax arrays that are
already on device keep the cheap on-device path.

The reference's equivalents: 200k-row sampling in the engine
(ivf_index.cpp:55-86, codebook_builder.h:79-84) and the 53M chunked
compress/cov guards (scalar_quantization.py:41-50,
rank_aware_quantization.py:117-131).
"""

from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np


def host_sample_rows(x, cap: int, seed: int = 0):
    """Return ≤cap rows of x without materializing the full corpus on device.

    jax.Array inputs are sampled on device (they're already in HBM).
    Anything else (numpy, np.memmap, h5py-style array-likes) is sampled
    host-side via sorted fancy indexing, then returned as float32 numpy.
    """
    n = x.shape[0]
    if isinstance(x, jax.Array):
        if n <= cap:
            return jnp.asarray(x, jnp.float32)
        idx = jax.random.choice(jax.random.PRNGKey(seed), n, (cap,), replace=False)
        return jnp.asarray(x[idx], jnp.float32)
    if n <= cap:
        rows = x[:]
    else:
        rng = np.random.default_rng(seed)
        idx = np.sort(rng.choice(n, cap, replace=False))
        rows = x[idx]
    if isinstance(rows, jax.Array):  # device-generating virtual corpus
        return rows.astype(jnp.float32)
    return np.asarray(rows, dtype=np.float32)


def chunk_rows_for_bytes(dim: int, itemsize: int = 4,
                         budget_bytes: int = 1 << 28) -> int:
    """Rows per chunk so one host→device transfer stays ≤ budget (256 MB)."""
    return max(1024, budget_bytes // max(1, dim * itemsize))


def chunked_min_max(x, chunk_rows: int = 0) -> Tuple[jax.Array, jax.Array]:
    """Per-dimension (min, max) over an arbitrarily large host corpus,
    accumulated in row chunks on device — the reference SQ's 53M OOM guard
    (scalar_quantization.py:41-50) done the streaming way."""
    n, d = x.shape
    if isinstance(x, jax.Array):
        xf = x.astype(jnp.float32)
        return jnp.min(xf, axis=0), jnp.max(xf, axis=0)
    if not chunk_rows:
        chunk_rows = chunk_rows_for_bytes(d)
    lo = jnp.full((d,), jnp.inf, jnp.float32)
    hi = jnp.full((d,), -jnp.inf, jnp.float32)
    for start in range(0, n, chunk_rows):
        xc = jnp.asarray(x[start : start + chunk_rows], jnp.float32)
        lo = jnp.minimum(lo, jnp.min(xc, axis=0))
        hi = jnp.maximum(hi, jnp.max(xc, axis=0))
    return lo, hi
