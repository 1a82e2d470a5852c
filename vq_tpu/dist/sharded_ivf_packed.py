"""Sharded probed-tile IVF: per-shard tile masks over the packed scan.

The single-device IvfPackedFlatIndex (index/ivf_packed.py) restricts the
packed scan to tiles overlapping the batch's probed clusters — here the
cluster-sorted corpus is split into contiguous row blocks over the mesh
and EACH SHARD masks its own local tiles:

  fit    — coarse k-means (or a shared `coarse=`), rows cluster-sorted
           GLOBALLY (so a cluster's rows land contiguously, almost always
           on one shard), flat-encoded in that order (zero centroid, the
           IvfPackedFlatIndex recipe), split into equal per-shard blocks
           (global tail padded), per-shard ORDER-PRESERVING packed caches
           (prepare_tile_cache), per-shard per-tile cluster ranges.
  search — coarse routing is replicated math (one (Q, K) matmul per
           shard); each shard turns the batch's probed set into a mask
           over its LOCAL tiles (per-cluster prefix sums) and runs the
           tile-masked packed scan (masked-out tiles are never read —
           kernels/packed.py) with a num_valid prefix limit for the global
           pad tail; per-shard (Q, k) candidates all_gather-merge
           exactly.

Semantics match IvfPackedFlatIndex (tile-overlap candidate superset,
flat packed scores); on one device the sharding is a no-op and results
equal the single-device probed-tile scan (tests/test_sharded_ivf_packed
asserts equality on the 8-virtual-device CPU mesh).
Reference contrast: the engine's IVF shards by list assignment with
per-cluster heap scans (external/saq/include/index/ivf_index.h:249-266);
here probing is a tile predicate per shard and the merge is one tiled
all_gather.
"""

from __future__ import annotations

from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import PartitionSpec as P

from vq_tpu.core.config import IVFConfig, Metric, SearchConfig
from vq_tpu.data.sampling import chunk_rows_for_bytes, host_sample_rows
from vq_tpu.dist.mesh import DATA_AXIS, make_mesh, replicate, shard_rows
from vq_tpu.dist.sharded import _merge_local_topk, shard_map
from vq_tpu.index.base import BaseSearchIndex, nbytes_of
from vq_tpu.index.ivf import chunked_assign, encode_rows_ordered
from vq_tpu.index.ivf_packed import default_mask_cap, tile_mask_from_probes
from vq_tpu.kernels.adc import _bf16_supported, _finalize
from vq_tpu.kernels.kmeans import kmeans, pairwise_sqdist_xc
from vq_tpu.kernels.packed import _TILE, PackedCorpus
from vq_tpu.methods.base import BaseQuantizer


class ShardedIvfPackedIndex(BaseSearchIndex):
    """Probed-tile packed IVF with the corpus row-sharded over the mesh."""

    name = "sharded_ivf_packed"

    def __init__(
        self,
        quantizer: BaseQuantizer,
        ivf_cfg: IVFConfig = IVFConfig(),
        search_cfg: SearchConfig = SearchConfig(),
        mesh=None,
    ):
        self.quantizer = quantizer
        self.ivf_cfg = ivf_cfg
        self.search_cfg = search_cfg
        self.mesh = mesh if mesh is not None else make_mesh()
        self.centroids: Optional[jax.Array] = None
        self.num_rows = 0
        self._n_loc = 0
        self._words = None  # tuple of (P, n_loc/u_s, ln_s) sharded leaves
        self._factors = None  # (P, n_loc, F) sharded
        self._ids = None  # (P, n_loc) sharded: local pos → global row id
        self._cl_first = None  # (P, n_loc/512) sharded
        self._cl_last = None  # (P, n_loc/512)
        self._has_norms = False
        self._search_cache = {}

    @property
    def num_shards(self) -> int:
        return int(self.mesh.devices.size)

    # ------------------------------------------------------------------ fit
    def fit(self, X, chunk_rows: int = 0, coarse=None) -> "ShardedIvfPackedIndex":
        n, d = X.shape
        chunk = chunk_rows or chunk_rows_for_bytes(d)
        if coarse is not None:
            self.centroids = jnp.asarray(coarse[0], jnp.float32)
            assignment = np.asarray(coarse[1], np.int32)
        else:
            k = min(self.ivf_cfg.num_clusters, max(1, n // 2))
            key = jax.random.PRNGKey(self.ivf_cfg.kmeans.seed)
            cap = min(n, max(
                200_000, self.ivf_cfg.kmeans.max_points_per_centroid * k
            ))
            xs = host_sample_rows(X, cap, self.ivf_cfg.kmeans.seed)
            self.centroids = kmeans(
                key, jnp.asarray(xs, jnp.float32), k, self.ivf_cfg.kmeans
            )
            del xs
            assignment = chunked_assign(X, self.centroids, chunk)
        order = np.argsort(assignment, kind="stable")
        if self.quantizer.params is None:
            xs = host_sample_rows(X, 200_000, self.ivf_cfg.kmeans.seed)
            self.quantizer.fit(np.asarray(xs) if not isinstance(xs, jax.Array)
                               else xs)
            del xs
        codes, norms = encode_rows_ordered(
            X, order, np.zeros(n, np.int32),
            jnp.zeros((1, d), jnp.float32), self.quantizer, chunk,
        )

        p_cnt = self.num_shards
        blk = p_cnt * _TILE
        n_pad = -(-n // blk) * blk
        n_loc = n_pad // p_cnt
        codes_p = np.pad(codes, ((0, n_pad - n),) + ((0, 0),) * (codes.ndim - 1))
        norms_p = np.pad(norms, (0, n_pad - n), constant_values=1.0)
        ids_p = np.pad(order.astype(np.int32), (0, n_pad - n),
                       constant_values=-1)
        # pad rows inherit the last real cluster so per-tile ranges stay
        # monotone; they are excluded by the num_valid prefix limit
        asn_sorted = np.pad(assignment[order], (0, n_pad - n),
                            mode="edge")

        caches = []
        for p in range(p_cnt):
            sl = slice(p * n_loc, (p + 1) * n_loc)
            cache = self.quantizer.prepare_tile_cache(
                jnp.asarray(codes_p[sl]), norms=jnp.asarray(norms_p[sl]),
            )
            if cache is None:
                raise RuntimeError(
                    f"{self.quantizer.name} has no packed layout — use "
                    "dist.sharded_ivf.ShardedIVFIndex"
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
        self._ids = shard_rows(
            self.mesh, jnp.asarray(ids_p.reshape(p_cnt, n_loc))
        )
        nb_loc = n_loc // _TILE
        firsts = asn_sorted[np.arange(n_pad // _TILE) * _TILE]
        lasts = asn_sorted[(np.arange(n_pad // _TILE) + 1) * _TILE - 1]
        self._cl_first = shard_rows(
            self.mesh, jnp.asarray(firsts.reshape(p_cnt, nb_loc).astype(np.int32))
        )
        self._cl_last = shard_rows(
            self.mesh, jnp.asarray(lasts.reshape(p_cnt, nb_loc).astype(np.int32))
        )
        self._has_norms = caches[0].has_norms
        self.num_rows = n
        self._n_loc = n_loc
        self._search_cache = {}
        return self

    # --------------------------------------------------------------- search
    def _build_search_fn(self, k: int, nprobe: int):
        metric = self.search_cfg.metric
        quantizer = self.quantizer
        centroids = self.centroids
        k_cl = int(centroids.shape[0])
        n_loc = self._n_loc
        nb_loc = n_loc // _TILE
        true_n = self.num_rows
        s_cnt = len(self._words)
        has_norms = self._has_norms
        use_bf16 = self.search_cfg.use_bf16 and _bf16_supported()
        mask_cap = default_mask_cap(nb_loc, nprobe, true_n, k_cl)

        def local(q, fac, ids_l, cl_f, cl_l, *words):
            p = jax.lax.axis_index(DATA_AXIS)
            q = q.astype(jnp.float32)
            valid = jnp.clip(true_n - p * n_loc, 0, n_loc)
            cd = pairwise_sqdist_xc(q, centroids)  # replicated math
            _, probe = jax.lax.top_k(-cd, nprobe)
            mask = tile_mask_from_probes(probe, cl_f[0], cl_l[0], k_cl)
            sub = PackedCorpus(
                words=tuple(w[0] for w in words), factors=fac[0],
                num_rows=n_loc, has_norms=has_norms,
            )
            s, pos = quantizer.packed_scan_raw(
                q, sub, k, metric, num_valid=valid, use_bf16=use_bf16,
                tile_mask=mask, mask_cap=mask_cap,
            )
            gid = jnp.take(ids_l[0], jnp.clip(pos, 0, n_loc - 1))
            s = jnp.where(gid < 0, -jnp.inf, s)  # pad rows never surface
            q_sq = jnp.sum(q * q, axis=-1)
            s_nat, gid = _finalize(s, gid, metric, q_sq)  # natural form
            return _merge_local_topk(s_nat, gid, k, metric)

        in_specs = [P(None, None), P(DATA_AXIS, None, None)]
        in_specs += [P(DATA_AXIS, None), P(DATA_AXIS, None),
                     P(DATA_AXIS, None)]
        in_specs += [P(DATA_AXIS, None, None)] * s_cnt
        fn = shard_map(
            local, mesh=self.mesh, in_specs=tuple(in_specs),
            out_specs=(P(None, None), P(None, None)),
        )
        return jax.jit(fn)

    def search_with_scores(
        self, queries: np.ndarray, k: int = 10
    ) -> Tuple[np.ndarray, np.ndarray]:
        nprobe = min(self.ivf_cfg.nprobe, int(self.centroids.shape[0]))
        key = (k, nprobe)
        if key not in self._search_cache:
            self._search_cache[key] = self._build_search_fn(k, nprobe)
        q = replicate(self.mesh, jnp.asarray(queries, jnp.float32))
        args = [q, self._factors]
        args += [self._ids, self._cl_first, self._cl_last]
        args += list(self._words)
        scores, ids = self._search_cache[key](*args)
        ids = np.asarray(ids)
        return np.where(ids < 0, 0, ids).astype(np.uint32), np.asarray(scores)

    # ---------------------------------------------------------------- misc
    def memory_footprint(self) -> int:
        total = 0
        leaves = list(self._words or ()) + [
            self._factors, self._ids, self._cl_first,
            self._cl_last, self.centroids,
        ]
        for a in leaves:
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
        import pickle

        return {
            "quantizer": pickle.dumps(self.quantizer),
            "ivf_cfg": self.ivf_cfg,
            "search_cfg": self.search_cfg,
            "num_rows": self.num_rows,
            "n_loc": self._n_loc,
            "num_shards": self.num_shards,
            "centroids": np.asarray(self.centroids),
            "words": [np.asarray(w) for w in self._words],
            "factors": np.asarray(self._factors),
            "ids": np.asarray(self._ids),
            "cl_first": np.asarray(self._cl_first),
            "cl_last": np.asarray(self._cl_last),
            "has_norms": self._has_norms,
        }

    def _restore(self, state: dict) -> None:
        import pickle

        if state["num_shards"] != self.num_shards:
            raise ValueError(
                f"index was saved with {state['num_shards']} shards but the "
                f"current mesh has {self.num_shards} devices — refit"
            )
        self.quantizer = pickle.loads(state["quantizer"])
        self.ivf_cfg = state["ivf_cfg"]
        self.search_cfg = state["search_cfg"]
        self.num_rows = state["num_rows"]
        self._n_loc = state["n_loc"]
        self.centroids = jnp.asarray(state["centroids"])
        self._words = tuple(
            shard_rows(self.mesh, jnp.asarray(w)) for w in state["words"]
        )
        self._factors = shard_rows(self.mesh, jnp.asarray(state["factors"]))
        self._ids = shard_rows(self.mesh, jnp.asarray(state["ids"]))
        self._cl_first = shard_rows(self.mesh, jnp.asarray(state["cl_first"]))
        self._cl_last = shard_rows(self.mesh, jnp.asarray(state["cl_last"]))
        self._has_norms = state["has_norms"]
        self._search_cache = {}
