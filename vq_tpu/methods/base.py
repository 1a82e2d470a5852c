"""Quantizer interface.

API parity with the reference's BaseQuantizer ABC
(src/haag_vq/methods/base_quantizer.py:8-91): `fit / compress / decompress`
plus `get_compression_ratio` (product_quantization.py:88-99) and codebook
export (base_quantizer.py:53-91).  Unlike the reference, every concrete
method here is a thin stateful wrapper over pure jittable functions
`fit(key, X, cfg) → params`, `encode(params, X) → codes`,
`decode(params, codes) → x̂` whose params are pytrees — the functional core
is what runs on-device and under shard_map; the class exists for the
harness/CLI layer.
"""

from __future__ import annotations

import os
import pickle
from typing import Any, Dict, Optional

import jax
import jax.numpy as jnp
import numpy as np


class BaseQuantizer:
    """Common harness-facing interface for all quantization methods."""

    name: str = "base"

    def __init__(self):
        self.params = None
        self._dim: Optional[int] = None

    # -- to implement ------------------------------------------------------
    def fit(self, X: np.ndarray) -> "BaseQuantizer":
        raise NotImplementedError

    def compress(self, X: np.ndarray) -> np.ndarray:
        raise NotImplementedError

    def decompress(self, codes: np.ndarray) -> np.ndarray:
        raise NotImplementedError

    def code_bytes_per_vector(self) -> float:
        """Bytes of code storage per vector (incl. per-vector side-channels)."""
        raise NotImplementedError

    def decode_fn(self):
        """Return a jax-traceable `codes_tile → (T, D)` decoder.

        This is what lets every method plug into the fused decode→score→top-k
        scan (kernels/adc.py) and the sharded search path without a
        method-specific search implementation.
        """
        raise NotImplementedError

    def encode_fn(self):
        """Optionally return a jax-traceable `x_tile (T, D) → codes` encoder.

        Chunked index builds (index/ivf.py encode_rows_ordered) jit this
        together with the residual subtraction so construction streams
        through the device one chunk at a time — the scale path that lets
        IVF fits run past HBM (reference chunked-build philosophy,
        streaming_sweep.py:151-186, scalar_quantization.py:41-50).  Default
        None falls back to `compress` on host chunks.
        """
        return None

    # -- provided ----------------------------------------------------------
    def scan_topk(
        self,
        queries,
        codes,
        k: int,
        metric,
        norms=None,
        tile_rows: int = 16384,
        use_bf16: bool = True,
        approx: bool = False,
        num_valid=None,
    ):
        """Fused ADC search over this method's codes (device arrays in/out).
        `num_valid` masks rows with id ≥ num_valid."""
        from vq_tpu.kernels.adc import scan_generic_topk

        return scan_generic_topk(
            queries, codes, self.decode_fn(), k, metric, norms, tile_rows,
            use_bf16, approx=approx, num_valid=num_valid,
        )

    def prepare_tile_cache(self, codes, norms=None):
        """Build the ORDER-PRESERVING packed scan layout (a
        kernels/packed.PackedCorpus; rows stay where the caller put them)
        for the packed-scan indexes: the IVF-as-tile-mask index
        (index/ivf_packed.py) keeps rows sorted by coarse cluster so each
        512-row tile maps to a contiguous cluster range, and the sharded
        packed indexes build one per shard.  `norms` (original row ‖x‖)
        are required for Metric.NIP.  Default None = this method has no
        packed layout."""
        return None

    def packed_scan_raw(self, queries, packed, k, metric, num_valid=None,
                        use_bf16=True, tile_mask=None, mask_cap=None):
        """Maximize-form (scores, ROW-POSITION ids) over a PackedCorpus
        (kernels/packed.packed_scan_topk).  The caller owns id mapping, pad
        masking (num_valid) and metric finalization.  tile_mask (N/512,)
        i32 restricts the scan to masked-in tiles; mask_cap is the optional
        static cap on the compacted tile count.  Only required when
        prepare_tile_cache returns a cache."""
        raise NotImplementedError

    def residual_scorer(self):
        """Optionally return a CODE-SPACE window scorer for IVF list scans
        (index/ivf.scan_probed_lists): a pair of jax-traceable functions

            q_map(v (N, D)) → (v_cat (N, Dc) f32, v_add (N,) f32)
                such that v · decode(ct)[t] == v_cat · ô[t] + v_add
                for every row t (a rotation into code space plus the
                constant mean/centroid dot),
            window(ct (T, row_bytes)) → (ô (T, Dc) f32, r2 (T,) f32)
                with r2[t] == ‖decode(ct)[t]‖².

        Rotation-based methods (SAQ, RaBitQ, RankAware) implement this so
        the probed-window scan rotates QUERIES AND CENTROIDS once instead
        of un-rotating every decoded window — decode_fn pays ~chunk·D²
        rotation FLOPs per (query, probe) window, the scorer only the
        dequant (the IVF analog of the flat scan's rotated-query trick).
        Default None = windows score through decode_fn."""
        return None

    @property
    def dim(self) -> Optional[int]:
        return self._dim

    def get_compression_ratio(self, X: np.ndarray) -> float:
        """float32 input bytes / code bytes (reference
        product_quantization.py:88-99 semantics)."""
        raw = X.shape[1] * 4.0
        return raw / self.code_bytes_per_vector()

    def reconstruction_mse(self, X: np.ndarray, sample: Optional[int] = None) -> float:
        xs = X if sample is None or len(X) <= sample else X[:sample]
        rec = self.decompress(self.compress(xs))
        return float(np.mean((np.asarray(xs, dtype=np.float32) - rec) ** 2))

    def config_dict(self) -> Dict[str, Any]:
        return {}

    # -- persistence -------------------------------------------------------
    def save(self, path: str) -> None:
        """Persist params as a pickle of host numpy arrays."""
        host = jax.tree_util.tree_map(np.asarray, self.params)
        payload = {
            "name": self.name,
            "dim": self._dim,
            "params": host,
            "config": self.config_dict(),
        }
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        with open(path, "wb") as f:
            pickle.dump(payload, f)

    def load(self, path: str) -> "BaseQuantizer":
        with open(path, "rb") as f:
            payload = pickle.load(f)
        self._dim = payload["dim"]
        self.params = jax.tree_util.tree_map(jnp.asarray, payload["params"])
        return self

    def save_codebooks(self, path: str) -> None:
        """Codebook export hook (reference base_quantizer.py:53-91).

        Default: save full params; methods with explicit codebooks override.
        """
        self.save(path)
