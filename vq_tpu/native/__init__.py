"""Native host-side components (C++ via ctypes).

The reference's performance core is a vendored C++20 engine; this package
keeps all per-vector compute in XLA, but the host-side
scalar programs — the bit allocators and the exact 1-D codebook DP
(SURVEY.md §7.3: "scalar dynamic programs don't vectorize; run them
host-side ... on sampled columns") — live here as a small C++ library.

The library self-builds with g++ on first import (no pybind11 in this
environment — plain C ABI + ctypes) and every entry point has a pure-NumPy
fallback, so the package works without a compiler and the tests can check
native-vs-fallback equivalence.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
from typing import Optional

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_HERE, "allocator.cpp")
_LIB_PATH = os.path.join(_HERE, "_libvq.so")

_lib: Optional[ctypes.CDLL] = None
_build_error: Optional[str] = None


def _build() -> Optional[str]:
    cmd = [
        "g++", "-O3", "-std=c++17", "-shared", "-fPIC", "-march=native",
        _SRC, "-o", _LIB_PATH,
    ]
    try:
        out = subprocess.run(cmd, capture_output=True, text=True, timeout=120)
        if out.returncode != 0:
            return out.stderr[-2000:]
        return None
    except Exception as e:  # compiler missing etc.
        return str(e)


def _load() -> Optional[ctypes.CDLL]:
    global _build_error
    if not os.path.exists(_LIB_PATH) or os.path.getmtime(_LIB_PATH) < os.path.getmtime(_SRC):
        _build_error = _build()
        if _build_error:
            return None
    try:
        lib = ctypes.CDLL(_LIB_PATH)
    except OSError as e:
        _build_error = str(e)
        return None
    i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
    f64p = np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")
    f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
    lib.vq_allocate_greedy.argtypes = [
        f64p, i64p, ctypes.c_int64, ctypes.c_int32, ctypes.c_int64, i64p
    ]
    lib.vq_allocate_dp.argtypes = lib.vq_allocate_greedy.argtypes
    lib.vq_codebook_exact.argtypes = [
        f32p, ctypes.c_int64, ctypes.c_int32, f32p
    ]
    lib.vq_codebook_exact.restype = ctypes.c_int32
    return lib


def available() -> bool:
    global _lib
    if _lib is None and _build_error is None:
        _lib = _load()
    return _lib is not None


def build_error() -> Optional[str]:
    return _build_error


def allocate_greedy_native(
    block_mse: np.ndarray, block_lens: np.ndarray, budget_bits: int, max_bits: int
) -> Optional[np.ndarray]:
    """Native greedy allocator; None if the library is unavailable."""
    if not available():
        return None
    mse = np.ascontiguousarray(block_mse, dtype=np.float64)
    lens = np.ascontiguousarray(block_lens, dtype=np.int64)
    out = np.zeros(len(lens), dtype=np.int64)
    _lib.vq_allocate_greedy(mse, lens, len(lens), max_bits, budget_bits, out)
    return out


def allocate_dp_native(
    block_mse: np.ndarray, block_lens: np.ndarray, budget_bits: int, max_bits: int
) -> Optional[np.ndarray]:
    if not available():
        return None
    mse = np.ascontiguousarray(block_mse, dtype=np.float64)
    lens = np.ascontiguousarray(block_lens, dtype=np.int64)
    out = np.zeros(len(lens), dtype=np.int64)
    _lib.vq_allocate_dp(mse, lens, len(lens), max_bits, budget_bits, out)
    return out


def codebook_exact(
    samples: np.ndarray, num_levels: int, sample_cap: int = 65536, seed: int = 0
) -> np.ndarray:
    """Exact optimal 1-D k-means levels (divide-and-conquer DP, C++).

    Falls back to the jax Lloyd builder if the library is unavailable.
    Parity with the reference engine's build_codebook_exact
    (external/saq/include/saq/preprocessing/codebook_builder.h:44-84).
    """
    x = np.asarray(samples, dtype=np.float32).ravel()
    if len(x) > sample_cap:
        x = np.random.default_rng(seed).choice(x, sample_cap, replace=False)
    x = np.sort(x)
    if available():
        out = np.zeros(num_levels, dtype=np.float32)
        rc = _lib.vq_codebook_exact(np.ascontiguousarray(x), len(x), num_levels, out)
        if rc == 0:
            return out
    from vq_tpu.kernels.lloyd1d import lloyd_1d_sorted
    import jax.numpy as jnp

    return np.asarray(lloyd_1d_sorted(jnp.asarray(x), num_levels, iters=100))
