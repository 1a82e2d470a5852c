"""Sharded serving through the packed scan (kernels/packed.py).

The PackedCorpus itself is sharded:

  fit    — rows are split into equal per-shard blocks (padded at the global
           tail) and EACH SHARD builds its own order-preserving packed
           cache from its local rows via quantizer.prepare_tile_cache; a
           local prefix limit masks the pad rows.
  search — the packed scan (methods/*.packed_scan_raw) runs per shard
           under shard_map; per-shard (Q, k) candidates all_gather-merge
           exactly, optionally per-chunk so XLA's async collectives hide
           each small gather behind the next chunk's scan (overlap_chunks —
           the dist/sharded.py overlapped-merge pattern).

On one device the sharding is a no-op and results equal the single-device
packed scan (tests/test_sharded_packed.py asserts equality on the
8-virtual-device CPU mesh).
"""

from __future__ import annotations

from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import PartitionSpec as P

from vq_tpu.core.config import Metric, SearchConfig
from vq_tpu.data.sampling import chunk_rows_for_bytes
from vq_tpu.dist.mesh import DATA_AXIS, make_mesh, replicate, shard_rows
from vq_tpu.dist.sharded import shard_map
from vq_tpu.index.base import BaseSearchIndex, nbytes_of
from vq_tpu.index.ivf import encode_rows_ordered
from vq_tpu.kernels.adc import _bf16_supported, _finalize
from vq_tpu.kernels.packed import _TILE, PackedCorpus
from vq_tpu.methods.base import BaseQuantizer


class ShardedPackedFlatIndex(BaseSearchIndex):
    """Flat index serving SAQ/RaBitQ/RankAware through the packed scan
    with the corpus row-sharded over the mesh."""

    name = "sharded_packed_flat"

    def __init__(
        self,
        quantizer: BaseQuantizer,
        search_cfg: SearchConfig = SearchConfig(),
        mesh=None,
    ):
        self.quantizer = quantizer
        self.search_cfg = search_cfg
        self.mesh = mesh if mesh is not None else make_mesh()
        self.num_rows = 0
        self._n_loc = 0
        self._words = None  # tuple of (P, n_loc/u_s, ln_s) sharded leaves
        self._factors = None  # (P, n_loc, F) sharded
        self._has_norms = False
        self._search_cache = {}

    @property
    def num_shards(self) -> int:
        return int(self.mesh.devices.size)

    # ------------------------------------------------------------------ fit
    def fit(self, X, chunk_rows: int = 0) -> "ShardedPackedFlatIndex":
        n, d = X.shape
        if self.quantizer.params is None:
            self.quantizer.fit(X)
        chunk = chunk_rows or chunk_rows_for_bytes(d)
        # chunked flat encode = the IVF streamed-encode core with a zero
        # centroid (residual == row); norms ride along for Metric.NIP
        codes, norms = encode_rows_ordered(
            X, np.arange(n), np.zeros(n, np.int32),
            jnp.zeros((1, d), jnp.float32), self.quantizer, chunk,
        )
        self._install(codes, norms, n)
        return self

    def _install(self, codes: np.ndarray, norms: np.ndarray, n: int) -> None:
        p_cnt = self.num_shards
        blk = p_cnt * _TILE
        n_pad = -(-n // blk) * blk
        n_loc = n_pad // p_cnt
        codes_p = np.pad(codes, ((0, n_pad - n),) + ((0, 0),) * (codes.ndim - 1))
        norms_p = np.pad(norms, (0, n_pad - n), constant_values=1.0)

        caches = []
        for p in range(p_cnt):
            sl = slice(p * n_loc, (p + 1) * n_loc)
            cache = self.quantizer.prepare_tile_cache(
                jnp.asarray(codes_p[sl]), norms=jnp.asarray(norms_p[sl]),
            )
            if cache is None:
                raise RuntimeError(
                    f"{self.quantizer.name} has no packed layout — serve it "
                    "with dist.sharded_index.ShardedFlatIndex instead"
                )
            caches.append(cache)

        s_cnt = len(caches[0].words)
        self._words = tuple(
            shard_rows(self.mesh, jnp.stack([c.words[s] for c in caches]))
            for s in range(s_cnt)
        )
        self._factors = shard_rows(
            self.mesh, jnp.stack([c.factors for c in caches])
        )
        self._has_norms = caches[0].has_norms
        self.num_rows = n
        self._n_loc = n_loc
        self._search_cache = {}

    # --------------------------------------------------------------- search
    def _build_search_fn(self, k: int, overlap_chunks: int):
        metric = self.search_cfg.metric
        quantizer = self.quantizer
        n_loc = self._n_loc
        true_n = self.num_rows
        s_cnt = len(self._words)
        has_norms = self._has_norms
        use_bf16 = self.search_cfg.use_bf16 and _bf16_supported()
        u_s = tuple(n_loc // int(w.shape[1]) for w in self._words)
        chunks = max(1, min(overlap_chunks, n_loc // _TILE))
        while (n_loc // _TILE) % chunks:
            chunks -= 1
        csz = n_loc // chunks

        def local(q, fac, *words):
            p = jax.lax.axis_index(DATA_AXIS)
            valid = jnp.clip(true_n - p * n_loc, 0, n_loc)
            fac = fac[0]
            words_l = [w[0] for w in words]

            def scan_chunk(c):
                fac_c = jax.lax.dynamic_slice_in_dim(fac, c * csz, csz, 0)
                words_c = tuple(
                    jax.lax.dynamic_slice_in_dim(
                        w, c * (csz // u), csz // u, 0
                    )
                    for w, u in zip(words_l, u_s)
                )
                sub = PackedCorpus(
                    words=words_c, factors=fac_c, num_rows=csz,
                    has_norms=has_norms,
                )
                nv = jnp.clip(valid - c * csz, 0, csz)
                s, pos = quantizer.packed_scan_raw(
                    q, sub, k, metric, num_valid=nv, use_bf16=use_bf16,
                )
                gid = pos + c * csz + p * n_loc
                s = jnp.where(gid >= true_n, -jnp.inf, s)
                return s, gid

            num_q = q.shape[0]
            run_s = jnp.full((num_q, k), -jnp.inf, jnp.float32)
            run_i = jnp.zeros((num_q, k), jnp.int32)
            # python-unrolled chunk loop: the per-chunk rotated-query work
            # is loop-invariant (CSE'd), and chunk c+1's scan does not
            # depend on chunk c's merge — XLA's async collectives hide
            # each (Q, P·k) gather behind the next chunk's scan
            for c in range(chunks):
                s, gid = scan_chunk(c)
                g_s = jax.lax.all_gather(s, DATA_AXIS, axis=1, tiled=True)
                g_i = jax.lax.all_gather(gid, DATA_AXIS, axis=1, tiled=True)
                cat_s = jnp.concatenate([run_s, g_s], axis=1)
                cat_i = jnp.concatenate([run_i, g_i], axis=1)
                run_s, mi = jax.lax.top_k(cat_s, k)
                run_i = jnp.take_along_axis(cat_i, mi, axis=-1)
            q_sq = jnp.sum(q.astype(jnp.float32) ** 2, axis=-1)
            return _finalize(run_s, run_i, metric, q_sq)

        in_specs = [P(None, None), P(DATA_AXIS, None, None)]
        in_specs += [P(DATA_AXIS, None, None)] * s_cnt
        fn = shard_map(
            local,
            mesh=self.mesh,
            in_specs=tuple(in_specs),
            out_specs=(P(None, None), P(None, None)),
        )
        return jax.jit(fn)

    def search_with_scores(
        self, queries: np.ndarray, k: int = 10, overlap_chunks: int = 1
    ) -> Tuple[np.ndarray, np.ndarray]:
        key = (k, overlap_chunks)
        if key not in self._search_cache:
            self._search_cache[key] = self._build_search_fn(k, overlap_chunks)
        q = replicate(self.mesh, jnp.asarray(queries, jnp.float32))
        scores, ids = self._search_cache[key](q, self._factors, *self._words)
        ids = np.asarray(ids)
        return np.where(ids < 0, 0, ids).astype(np.uint32), np.asarray(scores)

    # ---------------------------------------------------------------- misc
    def memory_footprint(self) -> int:
        total = 0
        leaves = list(self._words or ()) + [self._factors]
        for a in leaves:
            if a is not None:
                total += nbytes_of(a)
        total += sum(
            nbytes_of(p)
            for p in jax.tree_util.tree_leaves(self.quantizer.params)
        )
        return total

    def reconstruction_mse(self, X: np.ndarray, sample: Optional[int] = 10000) -> float:
        return self.quantizer.reconstruction_mse(X, sample)

    # ------------------------------------------------------------ save/load
    def _state(self) -> dict:
        """Persist the stacked (P, …) per-shard cache leaves (np.asarray
        gathers a sharded array).  The per-shard layout (local pad tails)
        is baked into the leaves, so a load re-shards the SAME split — the
        restoring mesh must have the same device count (re-splitting P
        shards over P' devices would break each shard's num_valid layout;
        refit for a different mesh).
        Reference: base_search_index.py:21-89 persists every index."""
        import pickle

        return {
            "quantizer": pickle.dumps(self.quantizer),
            "search_cfg": self.search_cfg,
            "num_rows": self.num_rows,
            "n_loc": self._n_loc,
            "num_shards": self.num_shards,
            "words": [np.asarray(w) for w in self._words],
            "factors": np.asarray(self._factors),
            "has_norms": self._has_norms,
        }

    def _restore(self, state: dict) -> None:
        import pickle

        if state["num_shards"] != self.num_shards:
            raise ValueError(
                f"index was saved with {state['num_shards']} shards but the "
                f"current mesh has {self.num_shards} devices — per-shard "
                "packed layouts are not re-splittable; refit on this mesh"
            )
        self.quantizer = pickle.loads(state["quantizer"])
        self.search_cfg = state["search_cfg"]
        self.num_rows = state["num_rows"]
        self._n_loc = state["n_loc"]
        self._words = tuple(
            shard_rows(self.mesh, jnp.asarray(w)) for w in state["words"]
        )
        self._factors = shard_rows(self.mesh, jnp.asarray(state["factors"]))
        self._has_norms = state["has_norms"]
        self._search_cache = {}
