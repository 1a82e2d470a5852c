"""Sharded IVF: inverted lists distributed across the device mesh — the
expert-parallel analog (SURVEY.md §2.3 EP row: "IVF clusters as experts;
shard inverted lists across devices, route queries by coarse assignment").

Reference scale path: one-node OpenMP over clusters
(external/saq/src/ivf_index.cpp:28-194).  Design:

  fit    — global coarse k-means (every device could run it; it is done
           once on the default device), rows sorted by cluster, then
           CLUSTERS are assigned to shards by greedy size balancing
           (largest list → least-loaded shard).  Each shard holds only its
           own lists' rows, padded to the common per-shard row count; the
           (K,) routing tables (shard_of, local offset, size) and the
           centroids/quantizer are replicated.
  search — queries are replicated; every device computes the SAME
           top-nprobe coarse routing (one replicated matmul — cheaper
           than routing on one device and broadcasting) and then scans
           only the probed lists IT OWNS (probe_mask), using the same
           bounded-window list scan as the single-device index
           (index/ivf.scan_probed_lists).  Per-shard top-k candidates are
           all_gather-merged exactly — k per shard ⊇ global top-k.

On one device the sharding is a no-op and results equal IvfQuantizedIndex
(tests/test_sharded_ivf.py asserts this on the 8-virtual-device CPU mesh).
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
from vq_tpu.dist.sharded import shard_map
from vq_tpu.index.base import BaseSearchIndex, nbytes_of
from vq_tpu.index.ivf import (
    _PAD_SLACK,
    chunked_assign,
    encode_rows_ordered,
    fit_quantizer_on_residuals,
    scan_probed_lists,
    scan_union_lists,
)
from vq_tpu.kernels.kmeans import assign, kmeans, pairwise_sqdist_xc
from vq_tpu.methods.base import BaseQuantizer


def balance_clusters(sizes: np.ndarray, num_shards: int) -> np.ndarray:
    """Greedy LPT assignment: largest list → least-loaded shard → (K,)."""
    order = np.argsort(-sizes, kind="stable")
    load = np.zeros(num_shards, dtype=np.int64)
    shard_of = np.zeros(len(sizes), dtype=np.int32)
    for c in order:
        p = int(np.argmin(load))
        shard_of[c] = p
        load[p] += int(sizes[c])
    return shard_of


class ShardedIVFIndex(BaseSearchIndex):
    name = "sharded_ivf"

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
        self.centroids = None
        self.num_rows = 0
        self._search_cache = {}  # (k, nprobe, chunk) → jitted shard_map fn

    @property
    def num_shards(self) -> int:
        return int(self.mesh.devices.size)

    def fit(self, X, chunk_rows: int = 0) -> "ShardedIVFIndex":
        """Chunked sharded-IVF build: the same streamed-construction core as
        IvfQuantizedIndex.fit (index/ivf.encode_rows_ordered) with rows
        ordered by (shard, cluster) — the full corpus never reaches HBM."""
        n, d = X.shape
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
        chunk = chunk_rows or chunk_rows_for_bytes(d)
        assignment = chunked_assign(X, self.centroids, chunk)
        sizes = np.bincount(assignment, minlength=k).astype(np.int64)
        shard_of = balance_clusters(sizes, self.num_shards)

        # order rows by (shard, cluster); per-shard CSR with LOCAL offsets
        shard_key = shard_of[assignment].astype(np.int64) * (k + 1) + assignment
        order = np.argsort(shard_key, kind="stable")
        if self.quantizer.params is None:
            fit_quantizer_on_residuals(
                X, assignment, self.centroids, self.quantizer,
                seed=self.ivf_cfg.kmeans.seed,
            )
        codes, norms = encode_rows_ordered(
            X, order, assignment, self.centroids, self.quantizer, chunk
        )
        ids = order.astype(np.int32)

        # per-shard row blocks, padded to the max shard load + window slack
        # (a window reads ≤ chunk ≤ _PAD_SLACK rows past a list end and
        # dynamic_slice clamps in-bounds; slack only needs to keep PARTIAL
        # windows un-clamped — see index/ivf._PAD_SLACK)
        loads = np.bincount(shard_of[assignment[order]],
                            minlength=self.num_shards)
        pad_to = int(loads.max()) + _PAD_SLACK
        p_cnt = self.num_shards
        cb = codes.shape[1:]
        codes_blk = np.zeros((p_cnt, pad_to) + cb, dtype=codes.dtype)
        ids_blk = np.full((p_cnt, pad_to), -1, dtype=np.int32)
        norms_blk = np.ones((p_cnt, pad_to), dtype=np.float32)
        row = 0
        for p in range(p_cnt):
            rows_p = int(loads[p])
            sl = slice(row, row + rows_p)
            codes_blk[p, :rows_p] = codes[sl]
            ids_blk[p, :rows_p] = ids[sl]
            norms_blk[p, :rows_p] = norms[sl]
            row += rows_p
        # local offset of each cluster inside its shard block (rows are
        # grouped by shard then cluster id in `order`) — vectorized per
        # shard instead of the old O(K·P) python loop
        local_off = np.zeros(k, dtype=np.int32)
        for p in range(p_cnt):
            cl = np.nonzero(shard_of == p)[0]
            if len(cl):
                local_off[cl] = np.concatenate(
                    [[0], np.cumsum(sizes[cl])[:-1]]
                ).astype(np.int32)

        self.codes_sh = shard_rows(self.mesh, jnp.asarray(codes_blk))
        self.ids_sh = shard_rows(self.mesh, jnp.asarray(ids_blk))
        self.norms_sh = shard_rows(self.mesh, jnp.asarray(norms_blk))
        self.shard_of = jnp.asarray(shard_of)
        self.local_off = jnp.asarray(local_off)
        self.sizes = jnp.asarray(sizes.astype(np.int32))
        self.num_rows = n
        self._search_cache = {}
        return self

    def _build_search_fn(self, k, nprobe, chunk, strategy):
        """Jitted shard_map search, cached per (k, nprobe, chunk, strategy)
        — the previous per-call `jax.jit(fn)` re-traced every invocation.
        Uses the quantizer's residual_scorer
        (rotated-query window scoring) when available, and the query-shared
        union scan by default (scan_union_lists: each owned probed row
        decodes once per batch; the ownership mask folds into the
        per-(query, cluster) membership mask), like IvfQuantizedIndex."""
        metric = self.search_cfg.metric
        decode_fn = self.quantizer.decode_fn()
        scorer = self.quantizer.residual_scorer()
        centroids = self.centroids
        shard_of = self.shard_of
        local_off = self.local_off
        sizes = self.sizes
        if scorer is not None:
            q_map, window_fn = scorer
            c_side = jax.jit(q_map)(centroids)
        else:
            q_map = window_fn = c_side = None

        def local(q, codes_b, ids_b, norms_b):
            p = jax.lax.axis_index(DATA_AXIS)
            q = q.astype(jnp.float32)
            cd = pairwise_sqdist_xc(q, centroids)  # (Q, K) — replicated math
            _, probe = jax.lax.top_k(-cd, nprobe)
            own = shard_of[probe] == p  # (Q, P) lists this device holds
            scan_kw = dict(
                probe_mask=own,
                scorer_window=window_fn,
                q_side=q_map(q) if q_map is not None else None,
                c_side=c_side,
            )
            if strategy == "union":
                s, gid = scan_union_lists(
                    q, probe, cd, centroids, codes_b[0], ids_b[0],
                    norms_b[0], local_off, sizes, decode_fn, k, metric,
                    chunk=chunk, **scan_kw,
                )
            else:
                s, gid = scan_probed_lists(
                    q, probe, centroids, codes_b[0], ids_b[0], norms_b[0],
                    local_off, sizes, decode_fn, k, metric, chunk=chunk,
                    **scan_kw,
                )
            # masked probes / pad slots carry −inf maximize scores (+∞ after
            # the L2 sign flip); the exact merge never surfaces them
            from vq_tpu.dist.sharded import _merge_local_topk

            s_nat = -s if metric == Metric.L2 else s
            return _merge_local_topk(s_nat, gid, k, metric)

        fn = shard_map(
            local,
            mesh=self.mesh,
            in_specs=(
                P(None, None),
                P(DATA_AXIS, *([None] * (self.codes_sh.ndim - 1))),
                P(DATA_AXIS, None),
                P(DATA_AXIS, None),
            ),
            out_specs=(P(None, None), P(None, None)),
        )
        return jax.jit(fn)

    def _search_device(self, queries, k, nprobe, chunk=None,
                       strategy="union"):
        if chunk is None:
            chunk = 4096 if strategy == "union" else 512
        if strategy != "union":
            assert chunk <= _PAD_SLACK, (chunk, _PAD_SLACK)
        key = (k, nprobe, chunk, strategy)
        if key not in self._search_cache:
            self._search_cache[key] = self._build_search_fn(
                k, nprobe, chunk, strategy
            )
        return self._search_cache[key](
            replicate(self.mesh, jnp.asarray(queries, jnp.float32)),
            self.codes_sh, self.ids_sh, self.norms_sh,
        )

    def search_with_scores(
        self, queries: np.ndarray, k: int = 10, strategy: str = "union"
    ) -> Tuple[np.ndarray, np.ndarray]:
        nprobe = min(self.ivf_cfg.nprobe, self.centroids.shape[0])
        scores, ids = self._search_device(queries, k, nprobe,
                                          strategy=strategy)
        ids = np.asarray(ids)
        scores = np.asarray(scores)
        ids = np.where(ids < 0, 0, ids)
        return ids.astype(np.uint32), scores

    def memory_footprint(self) -> int:
        total = 0
        for a in (self.codes_sh, self.ids_sh, self.norms_sh, self.centroids):
            if a is not None:
                total += nbytes_of(a)
        total += sum(
            nbytes_of(p)
            for p in jax.tree_util.tree_leaves(self.quantizer.params)
        )
        return total

    def reconstruction_mse(self, X: np.ndarray, sample: Optional[int] = 10000) -> float:
        xs = np.asarray(X[: sample or len(X)], np.float32)
        a = np.asarray(assign(jnp.asarray(xs), self.centroids))
        res = xs - np.asarray(self.centroids)[a]
        rec = self.quantizer.decompress(self.quantizer.compress(res))
        return float(np.mean((res - rec) ** 2))
