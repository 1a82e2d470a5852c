"""IVF routing as a TILE MASK over the flat packed scan.

This index keeps the packed scan (kernels/packed.py) as the scorer and uses
IVF coarse routing only to restrict which 512-row tiles it reads:

  fit    — coarse k-means (or a shared `coarse=`), rows sorted by cluster,
           FLAT-encoded (original rows, not residuals — it keeps the packed
           layout's score algebra untouched), packed with the
           order-preserving tile cache (methods/base.prepare_tile_cache).
           Per-tile cluster ranges (first/last cluster in each 512-row
           tile) are precomputed.
  search — one matmul routes each query to its top-nprobe clusters; a (K,)
           probed flag + per-cluster prefix sums turn the batch's probed
           set into a (num_tiles,) mask in O(K + tiles); the packed scan
           gathers and scores ONLY masked-in tiles (packed_scan_topk
           tile_mask), in one dispatch.

Semantics: candidates are all rows in tiles OVERLAPPING a probed cluster
— a superset of per-query probed lists (tile-boundary rows and
co-probed-by-the-batch lists are scored too, exactly), so recall is ≥ the
per-query probing path's at equal nprobe; scores are the flat packed
scores.  Reference contrast: the engine scans per (query, cluster) with
AVX heaps (external/saq/include/index/ivf_index.h:249-266); here probing
is a tile predicate on the flat scan.

Probe-coherent query grouping: one batch-union mask saturates at serving
batch sizes — the union of many incoherent queries' probes covers nearly
every cluster.  `query_groups=G` sorts the batch by nearest coarse cell
and runs G per-group tile masks + G masked scans inside ONE jit
(lax.map): each group's union is the probes of nq/G COHERENT queries.
Total traffic is Σ_g tiles_g (can exceed one dense pass when groups don't
cohere — last_tiles_scanned reports the sum so callers can see whether
probing paid).
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from vq_tpu.core.config import IVFConfig, Metric, SearchConfig
from vq_tpu.data.sampling import chunk_rows_for_bytes, host_sample_rows
from vq_tpu.index.base import BaseSearchIndex, nbytes_of
from vq_tpu.index.ivf import chunked_assign, encode_rows_ordered
from vq_tpu.kernels.adc import _bf16_supported, _finalize
from vq_tpu.kernels.kmeans import kmeans, pairwise_sqdist_xc
from vq_tpu.kernels.packed import _TILE, PackedCorpus
from vq_tpu.methods.base import BaseQuantizer


def tile_mask_from_probes(probes: jax.Array, cl_first: jax.Array,
                          cl_last: jax.Array, k_cl: int) -> jax.Array:
    """Probed cluster ids (any shape) → (nb,) i32 tile mask in O(K+tiles):
    a tile is scanned iff any cluster in its [first, last] range is probed
    — prefix sums over the probed flag make the range-any a two-gather
    subtraction.  Shared by the single-device and sharded probed-tile
    indexes (their semantics contract requires identical masks)."""
    probed = jnp.zeros((k_cl,), jnp.int32)
    probed = probed.at[probes.reshape(-1)].set(1)
    pref = jnp.cumsum(probed)  # (K,) inclusive
    hi = pref[cl_last]
    lo = jnp.where(cl_first > 0, pref[jnp.maximum(cl_first - 1, 0)], 0)
    return (hi - lo > 0).astype(jnp.int32)


def default_mask_cap(nb: int, nprobe: int, num_rows: int, k_cl: int):
    """Static cap on one mask's compacted tile count: a coherence-aware
    estimate of its tile budget (~4× the perfectly-coherent nprobe span);
    None when it wouldn't shorten the walk.  Overflow falls back to the
    full tile set inside packed_scan_topk (exact either way)."""
    tiles_per_cl = num_rows // (k_cl * _TILE) + 1
    cap = int(min(nb, 4 * nprobe * tiles_per_cl + 64))
    return cap if cap < nb else None


class IvfPackedFlatIndex(BaseSearchIndex):
    """Probed-tile packed scan for SAQ/RaBitQ/RankAware-family quantizers
    (anything with prepare_tile_cache + packed_scan_raw)."""

    name = "ivf_packed"

    def __init__(
        self,
        quantizer: BaseQuantizer,
        ivf_cfg: IVFConfig = IVFConfig(),
        search_cfg: SearchConfig = SearchConfig(),
        query_groups: int = 1,
    ):
        self.quantizer = quantizer
        self.ivf_cfg = ivf_cfg
        self.search_cfg = search_cfg
        self.query_groups = query_groups  # default G for search calls
        self.centroids: Optional[jax.Array] = None
        self.cache = None  # order-preserving PackedCorpus
        self.ids_sorted: Optional[jax.Array] = None  # (N,) position → gid
        self.cl_first: Optional[jax.Array] = None  # (nb,) first cluster/tile
        self.cl_last: Optional[jax.Array] = None  # (nb,)
        self.num_rows = 0
        self._search_fn = None
        self._last_tiles = None  # device scalar; synced lazily (property)

    # ------------------------------------------------------------------ fit
    def fit(self, X, chunk_rows: int = 0, coarse=None) -> "IvfPackedFlatIndex":
        n, d = X.shape
        chunk = chunk_rows or chunk_rows_for_bytes(d)
        if coarse is not None:
            self.centroids = jnp.asarray(coarse[0], jnp.float32)
            assignment = np.asarray(coarse[1], np.int32)
            k = self.centroids.shape[0]
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
        # FLAT encode in cluster order (zero centroid: row == "residual")
        codes, norms = encode_rows_ordered(
            X, order, np.zeros(n, np.int32),
            jnp.zeros((1, d), jnp.float32), self.quantizer, chunk,
        )
        cache = self.quantizer.prepare_tile_cache(
            jnp.asarray(codes), norms=jnp.asarray(norms)
        )
        if cache is None:
            raise RuntimeError(
                f"{self.quantizer.name} has no packed layout — use "
                "IvfQuantizedIndex instead"
            )
        self.cache = cache
        self.ids_sorted = jnp.asarray(order.astype(np.int32))
        # per-tile cluster ranges: rows are cluster-sorted, so tile t spans
        # clusters [assignment[order][t·512], assignment[order][min(end)−1]]
        asn_sorted = assignment[order]
        nb = -(-n // _TILE)
        firsts = asn_sorted[np.arange(nb) * _TILE]
        last_rows = np.minimum((np.arange(nb) + 1) * _TILE, n) - 1
        lasts = asn_sorted[last_rows]
        self.cl_first = jnp.asarray(firsts.astype(np.int32))
        self.cl_last = jnp.asarray(lasts.astype(np.int32))
        self.num_rows = n
        self._search_fn = None
        self._last_tiles = None  # stale count from a previous corpus
        return self

    # --------------------------------------------------------------- search
    def _build_search_fn(self):
        metric = self.search_cfg.metric
        quantizer = self.quantizer
        k_cl = int(self.centroids.shape[0])
        use_bf16 = self.search_cfg.use_bf16 and _bf16_supported()
        nb = -(-self.num_rows // _TILE)
        num_rows = self.num_rows

        def _cap(np_):
            return default_mask_cap(nb, np_, num_rows, k_cl)

        @functools.partial(jax.jit, static_argnames=("kk", "np_", "ng"))
        def run(q, centroids, cache, ids_sorted, cl_first, cl_last,
                kk, np_, ng):
            q = q.astype(jnp.float32)
            nq = q.shape[0]
            cd = pairwise_sqdist_xc(q, centroids)  # (Q, K)
            _, probe = jax.lax.top_k(-cd, np_)
            if ng > 1:
                # probe-coherent grouping: sort the batch by its nearest
                # coarse cell so each group's probe union stays small
                order = jnp.argsort(probe[:, 0])
                qs = jnp.take(q, order, axis=0).reshape(ng, nq // ng, -1)
                ps = jnp.take(probe, order, axis=0).reshape(
                    ng, nq // ng, np_)
            else:
                qs, ps = q[None], probe[None]

            def one_group(args):
                qb, pb = args
                mask = tile_mask_from_probes(pb, cl_first, cl_last, k_cl)
                s, pos = quantizer.packed_scan_raw(
                    qb, cache, kk, metric, use_bf16=use_bf16,
                    tile_mask=mask, mask_cap=_cap(np_),
                )
                return s, pos, jnp.sum(mask)

            if ng > 1:
                s, pos, tiles = jax.lax.map(one_group, (qs, ps))
                inv = jnp.argsort(order)
                s = jnp.take(s.reshape(nq, kk), inv, axis=0)
                pos = jnp.take(pos.reshape(nq, kk), inv, axis=0)
                tiles = jnp.sum(tiles)
            else:
                s, pos, tiles = one_group((qs[0], ps[0]))
            gid = jnp.take(ids_sorted, jnp.clip(pos, 0, ids_sorted.shape[0] - 1))
            q_sq = jnp.sum(q * q, axis=-1)
            scores, ids = _finalize(s, gid, metric, q_sq)
            return scores, ids, tiles

        return run

    def search_with_scores(
        self, queries: np.ndarray, k: int = 10,
        query_groups: Optional[int] = None,
    ) -> Tuple[np.ndarray, np.ndarray]:
        """query_groups=G > 1 runs G probe-coherent group masks + masked
        scans (module docstring); None uses the index default.
        The batch is padded to a G multiple by REPEATING its last query
        (zero-pad rows would probe origin-nearest clusters and inflate
        their group's mask)."""
        nprobe = min(self.ivf_cfg.nprobe, int(self.centroids.shape[0]))
        if self._search_fn is None:
            self._search_fn = self._build_search_fn()
        q = jnp.asarray(queries, jnp.float32)
        nq = q.shape[0]
        ng = self.query_groups if query_groups is None else query_groups
        ng = max(1, min(int(ng), nq))
        pad = (-nq) % ng
        if pad:
            q = jnp.concatenate(
                [q, jnp.broadcast_to(q[-1:], (pad, q.shape[1]))])
        scores, ids, tiles = self._search_fn(
            q, self.centroids, self.cache,
            self.ids_sorted, self.cl_first, self.cl_last,
            kk=k, np_=nprobe, ng=ng,
        )
        self._last_tiles = tiles  # no host sync here — the
        # last_tiles_scanned property syncs only when read
        ids = np.asarray(ids)[:nq]
        scores = np.asarray(scores)[:nq]
        return np.where(ids < 0, 0, ids).astype(np.uint32), scores

    @property
    def last_tiles_scanned(self) -> int:
        """Tile-scans the last search's masks let through, summed over
        query groups (== masked-in tiles when query_groups == 1).  Reading this property is what syncs the device scalar."""
        return int(self._last_tiles) if self._last_tiles is not None else 0

    last_tiles_masked_in = last_tiles_scanned

    # ---------------------------------------------------------------- misc
    def memory_footprint(self) -> int:
        total = 0
        leaves = list(self.cache.words) + [
            self.cache.factors, self.ids_sorted,
            self.centroids, self.cl_first, self.cl_last,
        ]
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
        """Persist the packed cache leaves directly (reference persists
        every index — base_search_index.py:21-89, ivf_index.cpp:376-425);
        the cache is order-preserving, so a load needs no re-encode or
        re-sort."""
        import pickle

        c = self.cache
        return {
            "quantizer": pickle.dumps(self.quantizer),
            "ivf_cfg": self.ivf_cfg,
            "search_cfg": self.search_cfg,
            "query_groups": self.query_groups,
            "centroids": np.asarray(self.centroids),
            "ids_sorted": np.asarray(self.ids_sorted),
            "cl_first": np.asarray(self.cl_first),
            "cl_last": np.asarray(self.cl_last),
            "num_rows": self.num_rows,
            "cache": {
                "words": [np.asarray(w) for w in c.words],
                "factors": np.asarray(c.factors),
                "num_rows": c.num_rows,
                "has_norms": c.has_norms,
            },
        }

    def _restore(self, state: dict) -> None:
        import pickle

        self.quantizer = pickle.loads(state["quantizer"])
        self.ivf_cfg = state["ivf_cfg"]
        self.search_cfg = state["search_cfg"]
        self.query_groups = state.get("query_groups", 1)
        self.centroids = jnp.asarray(state["centroids"])
        self.ids_sorted = jnp.asarray(state["ids_sorted"])
        self.cl_first = jnp.asarray(state["cl_first"])
        self.cl_last = jnp.asarray(state["cl_last"])
        self.num_rows = state["num_rows"]
        cs = state["cache"]
        self.cache = PackedCorpus(
            words=tuple(jnp.asarray(w) for w in cs["words"]),
            factors=jnp.asarray(cs["factors"]),
            num_rows=cs["num_rows"],
            has_norms=cs["has_norms"],
        )
        self._search_fn = None
        self._last_tiles = None
