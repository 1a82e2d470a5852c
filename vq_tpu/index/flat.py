"""Flat (exhaustive) quantized index.

Parity with the reference's FlatQuantizedIndex
(src/haag_vq/methods/search/flat_quantized_index.py:17-155), which
decompresses the whole corpus and brute-force scans with scipy cdist.  Here
the corpus stays compressed in HBM and search is the fused
decode→score→top-k ADC scan (kernels/adc.py) — codes are the only per-row
device-memory traffic and the scoring is one matmul per tile.

Keeps the original row norms as a 4 B/vec side-channel to support the study
pipeline's normalized-IP metric (reference benchmarks/quantizer_adapters.py:17
NORM_SIDECHANNEL_BYTES).
"""

from __future__ import annotations

from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from vq_tpu.core.config import Metric, SearchConfig
from vq_tpu.index.base import BaseSearchIndex, nbytes_of
from vq_tpu.methods.base import BaseQuantizer


class FlatQuantizedIndex(BaseSearchIndex):
    name = "flat"

    def __init__(
        self,
        quantizer: BaseQuantizer,
        search_cfg: SearchConfig = SearchConfig(),
    ):
        self.quantizer = quantizer
        self.search_cfg = search_cfg
        self.codes: Optional[jax.Array] = None
        self.norms: Optional[jax.Array] = None  # original ‖x‖ side-channel
        self.num_rows = 0

    def fit(self, X: np.ndarray) -> "FlatQuantizedIndex":
        xd = jnp.asarray(X, dtype=jnp.float32)
        if self.quantizer.params is None:
            self.quantizer.fit(X)
        self.codes = jnp.asarray(self.quantizer.compress(X))
        self.norms = jnp.linalg.norm(xd, axis=-1)
        self.num_rows = X.shape[0]
        return self

    def search_with_scores(
        self, queries: np.ndarray, k: int = 10
    ) -> Tuple[np.ndarray, np.ndarray]:
        scores, idx = self.quantizer.scan_topk(
            jnp.asarray(queries, dtype=jnp.float32),
            self.codes,
            k,
            self.search_cfg.metric,
            norms=self.norms,
            tile_rows=self.search_cfg.tile_rows,
            use_bf16=self.search_cfg.use_bf16,
            approx=self.search_cfg.approx,
        )
        return np.asarray(idx).astype(np.uint32), np.asarray(scores)

    def memory_footprint(self) -> int:
        codes_b = nbytes_of(self.codes)
        params_b = sum(
            nbytes_of(p) for p in jax.tree_util.tree_leaves(self.quantizer.params)
        )
        norms_b = nbytes_of(self.norms)
        return codes_b + params_b + norms_b

    def reconstruction_mse(self, X: np.ndarray, sample: Optional[int] = 10000) -> float:
        return self.quantizer.reconstruction_mse(X, sample)

    def _state(self) -> dict:
        import pickle

        # Pickle the WHOLE quantizer (as IvfQuantizedIndex does): SAQ's plan
        # and RankAware's bits/layout live outside `params`, and a params-only
        # snapshot could not restore those methods.
        return {
            "codes": np.asarray(self.codes),
            "norms": np.asarray(self.norms),
            "num_rows": self.num_rows,
            "quantizer": pickle.dumps(self.quantizer),
            "search_cfg": self.search_cfg,
        }

    def _restore(self, state: dict) -> None:
        import pickle

        self.quantizer = pickle.loads(state["quantizer"])
        self.codes = jnp.asarray(state["codes"])
        self.norms = jnp.asarray(state["norms"])
        self.num_rows = state["num_rows"]
        self.search_cfg = state["search_cfg"]
