"""IVF index: coarse k-means cells + residual-quantized inverted lists.

Capability parity with the reference's three IVF paths — IvfQuantizedIndex
(methods/search/ivf_quantized_index.py:16-259), faiss IndexIVFPQ baseline
(faiss_ivfpq_index.py), RaBitQIVFIndex (rabitq_ivf_index.py:42) and the SAQ
engine's IVF (external/saq/src/ivf_index.cpp:28-374) — as ONE index
parameterized by any BaseQuantizer for the residual codes (PQ → IVFPQ,
RaBitQ → IVF+RaBitQ, SAQ → the engine's index).

Layout (SURVEY.md §7.3 "ragged IVF lists"): rows are sorted by cluster into
CSR form (codes_sorted, ids_sorted, offsets); search
  1. scores all K centroids with one matmul and takes top-nprobe,
  2. walks the probed lists in fixed `chunk`-row windows inside a
     lax.while_loop — by default the QUERY-SHARED UNION walk
     (scan_union_lists: the batch's probed lists concatenate, every
     window decodes once and all queries score it with one matmul,
     per-(query, cluster) membership masks keep candidate sets exact);
     scan_probed_lists keeps the per-(query, probe) window walk for A/B,
  3. rescores candidates against per-cluster RESIDUALS with the
     quantizer's jax decode (or its rotated-query residual_scorer),
     entirely on device,
  4. folds every window into a running top-k per query, the whole batch
     in ONE dispatch (lax.map over query blocks).
decompress() reconstructs any row by GLOBAL id (residual decode +
centroid add), the reference engine's IVF::decompress
(external/saq/src/ivf_index.cpp:245-374).

Scan-strategy note: the flat scan's cascades don't transfer here by
design — IVF probing IS the candidate-restriction stage (it reads
~nprobe/K of the corpus before any scoring), the probed windows are far
below the 512-row tiles of the flat packed layout, and cluster
residuals are norm-concentrated by construction.  The union walk is the
measured-right default at every batch size (scripts/ivf_scan_ablate.py):
it pays ≤ one corpus decode per batch like the dense scan while scanning
only probed rows, where the per-query walk paid num_queries× the decode
volume and lost to the dense scan at Q ≥ 64.
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
from vq_tpu.kernels.kmeans import assign, kmeans, pairwise_sqdist_xc
from vq_tpu.methods.base import BaseQuantizer

# Tail padding (rows) past the last cluster so a scan window slice never
# runs off the codes array; bounds the largest legal `chunk` for
# scan_probed_lists (a window reads at most `chunk` rows past a list end).
_PAD_SLACK = 1024

# Working-buffer budget for the union scan's probed-distance recompute:
# the (Q, slab, D) difference slabs stay under this many bytes (tests
# shrink it to force the slab path at small shapes).
_QRS_SLAB_BYTES = 32 << 20


def _take_rows(X, idx) -> jax.Array:
    """Gather corpus rows by host integer index → (len(idx), D) f32 device
    array.  jax corpora gather on device (no host round trip); host
    corpora (numpy / np.memmap / array-likes) gather host-side and transfer
    one chunk.  An array-like whose __getitem__ already returns jax arrays
    (a device-generating virtual corpus, e.g. scripts/ivf_bigbuild.py) is
    consumed without a host round trip."""
    if isinstance(X, jax.Array):
        return jnp.take(X, jnp.asarray(idx), axis=0).astype(jnp.float32)
    rows = X[np.asarray(idx)]
    if isinstance(rows, jax.Array):
        return rows.astype(jnp.float32)
    return jnp.asarray(np.asarray(rows, dtype=np.float32))


def chunked_assign(X, centroids: jax.Array, chunk: int) -> np.ndarray:
    """Nearest-centroid assignment streamed in `chunk`-row slices → (N,)
    int32 host array.  The full corpus never reaches device memory at
    once (reference scale philosophy: streaming_sweep.py:151-186)."""
    n = X.shape[0]
    out = np.empty(n, dtype=np.int32)
    for i0 in range(0, n, chunk):
        i1 = min(i0 + chunk, n)
        sl = X[i0:i1]
        xc = (
            sl.astype(jnp.float32)
            if isinstance(sl, jax.Array)
            else jnp.asarray(np.asarray(sl, dtype=np.float32))
        )
        out[i0:i1] = np.asarray(assign(xc, centroids))
    return out


def fit_quantizer_on_residuals(
    X, assignment: np.ndarray, centroids: jax.Array,
    quantizer: BaseQuantizer, cap: int = 200_000, seed: int = 0,
) -> None:
    """Fit the residual quantizer on a ≤cap-row sample of coarse residuals
    (the engine trains codebooks on a ≤200k sample too,
    external/saq/src/ivf_index.cpp:55-86)."""
    n = X.shape[0]
    if n <= cap:
        idx = np.arange(n)
    else:
        idx = np.sort(np.random.default_rng(seed).choice(n, cap, replace=False))
    rows = _take_rows(X, idx)
    res = rows - jnp.take(centroids, jnp.asarray(assignment[idx]), axis=0)
    quantizer.fit(res)


def encode_rows_ordered(
    X, order: np.ndarray, assignment: np.ndarray, centroids: jax.Array,
    quantizer: BaseQuantizer, chunk: int,
) -> Tuple[np.ndarray, np.ndarray]:
    """Residual-encode rows X[order] in `order` sequence, `chunk` rows at a
    time → (codes (N, ...) host, norms (N,) f32 host).

    The chunked-build core shared by IvfQuantizedIndex and ShardedIVFIndex:
    peak device memory is one (chunk, D) f32 slab + its codes, so IVF
    construction scales to corpora far past HBM (the flat fits'
    pattern).  When the quantizer exposes `encode_fn`, the
    residual subtraction + encode runs as ONE jitted program per chunk
    (no per-op eager dispatch)."""
    n = len(order)
    enc = quantizer.encode_fn()
    if enc is not None:

        @jax.jit
        def enc_res(rows, cts):
            rows = rows.astype(jnp.float32)
            return enc(rows - cts), jnp.linalg.norm(rows, axis=1)

    codes_np = None
    norms_np = np.empty(n, np.float32)
    for i0 in range(0, n, chunk):
        idx = order[i0 : i0 + chunk]
        rows = _take_rows(X, idx)
        cts = jnp.take(centroids, jnp.asarray(assignment[idx]), axis=0)
        if enc is not None:
            c, nm = enc_res(rows, cts)
            c, nm = np.asarray(c), np.asarray(nm)
        else:
            rows_h = np.asarray(rows, np.float32)
            c = np.asarray(quantizer.compress(rows_h - np.asarray(cts)))
            nm = np.linalg.norm(rows_h, axis=1)
        if codes_np is None:
            codes_np = np.empty((n,) + c.shape[1:], dtype=c.dtype)
        codes_np[i0 : i0 + len(idx)] = c
        norms_np[i0 : i0 + len(idx)] = nm
    return codes_np, norms_np


def scan_probed_lists(
    q: jax.Array,
    probes: jax.Array,
    centroids: jax.Array,
    codes_sorted: jax.Array,
    ids_sorted: jax.Array,
    norms_sorted: jax.Array,
    offsets: jax.Array,
    sizes: jax.Array,
    decode_fn,
    k: int,
    metric: Metric,
    chunk: int = 512,
    probe_mask: Optional[jax.Array] = None,
    scorer_window=None,
    q_side: Optional[Tuple[jax.Array, jax.Array]] = None,
    c_side: Optional[Tuple[jax.Array, jax.Array]] = None,
):
    """Scan the probed inverted lists in bounded windows → maximize-form
    (scores (Q, k), global ids (Q, k)).

    The memory-bounded replacement for the fixed max_cluster window: a
    lax.while_loop walks each probed list `chunk` rows at a time and stops
    at the largest size actually probed by THIS query batch, folding each
    window into a running top-k.  Peak live memory is the (Q, P, chunk)
    decoded window; one skewed cluster costs extra iterations only for the
    queries that probe it, never a bigger buffer.  (Reference scale path:
    per-cluster heap scans, external/saq/src/ivf_index.cpp:28-194.)

    probes (Q, P) int32; probe_mask (Q, P) bool optionally disables probes
    (the sharded IVF masks lists owned by other devices).  codes/ids/norms
    must carry ≥ chunk rows of tail padding so window slices never run off
    the array (fit() pads).  Scores for masked/invalid rows are −inf.

    scorer_window + q_side + c_side enable the ROTATED-QUERY window path
    (methods/base.residual_scorer): windows dequantize to code space and
    score against pre-rotated queries/centroids — exact same scores as the
    decode_fn path (up to f32 op order) without the per-window rotation
    matmuls that dominate decode for SAQ/RaBitQ/RankAware.  q_side =
    scorer.q_map(queries); c_side = scorer.q_map(centroids) — the caller
    precomputes c_side ONCE per index, not per call.
    """
    num_q, p_cnt = probes.shape
    qr = q[:, None, :] - centroids[probes]  # (Q, P, D) residual queries
    qr_sq = jnp.sum(qr * qr, axis=-1)  # (Q, P)
    q_cent = jnp.einsum("qd,qpd->qp", q, centroids[probes],
                        precision=jax.lax.Precision.HIGHEST)
    starts = offsets[probes]  # (Q, P)
    szs = sizes[probes]  # (Q, P)
    if probe_mask is not None:
        szs = jnp.where(probe_mask, szs, 0)
    max_sz = jnp.max(szs)

    use_scorer = scorer_window is not None
    if use_scorer:
        q_cat, q_add = q_side
        c_cat, c_add = c_side
        if metric == Metric.L2:
            # v·r̂ for v = q − c_p decomposes linearly through q_map
            qc_cat = q_cat[:, None, :] - c_cat[probes]  # (Q, P, Dc)
            qc_add = q_add[:, None] - c_add[probes]  # (Q, P)
        else:
            qc_cat = jnp.broadcast_to(
                q_cat[:, None, :], (num_q, p_cnt, q_cat.shape[1])
            )
            qc_add = jnp.broadcast_to(q_add[:, None], (num_q, p_cnt))
    else:
        dc = 1  # dummies so one vmap signature serves both paths
        qc_cat = jnp.zeros((num_q, p_cnt, dc), jnp.float32)
        qc_add = jnp.zeros((num_q, p_cnt), jnp.float32)

    cp = centroids[probes]  # (Q, P, D)

    def window(c, run_s, run_i):
        off = c * chunk

        def per_probe(start, size, qr_1, qr_sq_1, q_cent_1, qc_cat_1,
                      qc_add_1, c_1):
            ct = jax.lax.dynamic_slice_in_dim(
                codes_sorted, start + off, chunk, axis=0)
            rid = jax.lax.dynamic_slice_in_dim(
                ids_sorted, start + off, chunk, axis=0)
            nrm = jax.lax.dynamic_slice_in_dim(
                norms_sorted, start + off, chunk, axis=0)
            if use_scorer:
                ohat, r2 = scorer_window(ct)  # (chunk, Dc), (chunk,)
                ip_r = jnp.dot(ohat, qc_cat_1,
                               precision=jax.lax.Precision.HIGHEST) + qc_add_1
                if metric == Metric.L2:
                    s = -(qr_sq_1 - 2.0 * ip_r + r2)
                elif metric == Metric.IP:
                    s = ip_r + q_cent_1
                else:
                    s = (ip_r + q_cent_1) / jnp.maximum(nrm, 1e-30)
            else:
                r_hat = decode_fn(ct)  # (chunk, D)
                if metric == Metric.L2:
                    ip_r = jnp.dot(r_hat, qr_1,
                                   precision=jax.lax.Precision.HIGHEST)
                    rsq = jnp.sum(r_hat * r_hat, axis=1)
                    s = -(qr_sq_1 - 2.0 * ip_r + rsq)
                else:
                    # q·x̂ = q·c + q·r̂ — dot r̂ against the FULL query
                    # (qr_1 + c_1), not the residual query: r̂·(q−c) + q·c
                    # drops the c·r̂ term (measured 2.5 absolute on scores
                    # ~24, tests/test_ivf.py union-equality)
                    ip_full = jnp.dot(r_hat, qr_1 + c_1,
                                      precision=jax.lax.Precision.HIGHEST)
                    if metric == Metric.IP:
                        s = ip_full + q_cent_1
                    else:
                        s = (ip_full + q_cent_1) / jnp.maximum(nrm, 1e-30)
            valid = jax.lax.broadcasted_iota(jnp.int32, (chunk, 1), 0)[:, 0] \
                < (size - off)
            return jnp.where(valid, s, -jnp.inf), rid

        s_all, id_all = jax.vmap(jax.vmap(per_probe))(
            starts, szs, qr, qr_sq, q_cent, qc_cat, qc_add, cp
        )  # (Q, P, chunk)
        cat_s = jnp.concatenate([run_s, s_all.reshape(num_q, -1)], axis=1)
        cat_i = jnp.concatenate([run_i, id_all.reshape(num_q, -1)], axis=1)
        ms, mi = jax.lax.top_k(cat_s, k)
        return ms, jnp.take_along_axis(cat_i, mi, axis=-1)

    init = (
        jnp.zeros((1,), jnp.int32),
        jnp.full((num_q, k), -jnp.inf, jnp.float32),
        jnp.zeros((num_q, k), jnp.int32),
    )

    def cond(carry):
        return carry[0][0] * chunk < max_sz

    def body(carry):
        c, run_s, run_i = carry
        run_s, run_i = window(c[0], run_s, run_i)
        return (c + 1, run_s, run_i)

    _, run_s, run_i = jax.lax.while_loop(cond, body, init)
    return run_s, run_i


def scan_union_lists(
    q: jax.Array,
    probes: jax.Array,
    cd: jax.Array,
    centroids: jax.Array,
    codes_sorted: jax.Array,
    ids_sorted: jax.Array,
    norms_sorted: jax.Array,
    offsets: jax.Array,
    sizes: jax.Array,
    decode_fn,
    k: int,
    metric: Metric,
    chunk: int = 8192,
    probe_mask: Optional[jax.Array] = None,
    scorer_window=None,
    q_side: Optional[Tuple[jax.Array, jax.Array]] = None,
    c_side: Optional[Tuple[jax.Array, jax.Array]] = None,
    q_valid: Optional[jax.Array] = None,
):
    """QUERY-SHARED union scan of the probed lists → maximize-form
    (scores (Q, k), global ids (Q, k)).

    scan_probed_lists decodes each probed window once PER (query, probe)
    pair — at serving batch sizes the same list is probed by many queries
    and the batch pays num_queries× the decode volume (measured: the dense
    flat scan overtakes per-query probing at Q ≥ 64, scripts/
    ivf_scan_ablate.py).  Here the batch walks the CONCATENATED probed
    lists (the union over all queries) in `chunk`-row windows:

      1. each window's rows decode ONCE (the whole batch pays ≤ one
         corpus decode, like the flat scan),
      2. all queries score the window with ONE matmul (Q, Dc)·(Dc,
         chunk) — the flat scan's query-amortization, restricted to
         probed rows,
      3. a per-(query, cluster) membership mask −inf's rows of lists that
         query did not probe — candidate sets, hence recall, are
         IDENTICAL to the per-query path (equality-tested),
      4. per-row centroid terms (c·r̂) compute in-window from the scorer's
         c_side (or the gathered centroid rows), so no extra build-time
         columns are needed.

    Peak window memory is (chunk, Dc) decoded + (Q, chunk) scores —
    independent of nprobe, so the whole serving batch runs as one block
    (no query blocking, no decode-budget clamp).  Work ∝ rows in the
    probed UNION (≤ corpus), so a batched IVF scan is never asymptotically
    worse than the dense scan and keeps probing's advantage whenever the
    union is small (small batches, large K, small nprobe).

    cd is the (Q, K) squared-distance table from coarse routing (reused
    for the L2 ‖q−c‖² term; for IP/NIP the q·c table derives from it and
    the norms).  Reference contrast: the engine scans per (query, cluster)
    with AVX heaps (external/saq/include/index/ivf_index.h:249-266) — the
    union walk is the batched-matmul reformulation.
    """
    num_q = q.shape[0]
    kc = sizes.shape[0]
    allowed = jnp.zeros((num_q, kc), bool)
    qi = jnp.broadcast_to(jnp.arange(num_q)[:, None], probes.shape)
    if probe_mask is None:
        allowed = allowed.at[qi, probes].set(True)
    else:
        allowed = allowed.at[qi, probes].max(probe_mask)
    if q_valid is not None:
        # pad queries in a partially-filled block must not add their
        # (origin-nearest) probes to the batch union
        allowed = allowed & q_valid[:, None]
    union = jnp.any(allowed, axis=0)  # (K,)
    sz_u = jnp.where(union, sizes, 0)
    pref = jnp.cumsum(sz_u)  # (K,) inclusive prefix of probed rows
    total = pref[-1]

    use_scorer = scorer_window is not None
    if use_scorer:
        q_cat, q_add = q_side
        c_cat, c_add = c_side
    if metric == Metric.L2:
        # the routing table's ‖q‖²−2q·c+‖c‖² expansion cancels
        # catastrophically when norms dwarf the distances (f32 error
        # ~eps·‖q‖², 5% on the skewed-corpus test); recompute the PROBED
        # entries from the direct difference — a fused (Q, P) reduction,
        # the same accuracy the per-probe window path gets from qr.
        # Computed in probe SLABS: the one-shot (Q, P, D) difference is
        # 315 MB at Q=256, P=200, D=1536 and scales with the serving
        # batch — slabs cap the buffer at ~32 MB.
        d_dim = q.shape[1]
        num_p = probes.shape[1]
        slab = max(1, int(_QRS_SLAB_BYTES // (4 * num_q * d_dim)))
        if slab < num_p:
            p_pad = -(-num_p // slab) * slab
            pr = probes
            if p_pad > num_p:
                # repeat column 0: duplicate scatters write the same value
                pr = jnp.concatenate(
                    [probes,
                     jnp.broadcast_to(probes[:, :1],
                                      (num_q, p_pad - num_p))], axis=1)

            def one_slab(ps):  # (Q, slab) probe columns
                return jnp.sum((q[:, None, :] - centroids[ps]) ** 2,
                               axis=-1)

            qrs = jax.lax.map(
                one_slab,
                pr.reshape(num_q, p_pad // slab, slab).transpose(1, 0, 2),
            ).transpose(1, 0, 2).reshape(num_q, p_pad)[:, :num_p]
        else:
            qrs = jnp.sum((q[:, None, :] - centroids[probes]) ** 2, axis=-1)
        cd = cd.at[qi, probes].set(qrs)
    else:
        # q·c from the sqdist table: q·c = (‖q‖² + ‖c‖² − cd) / 2
        qsq = jnp.sum(q * q, axis=1, keepdims=True)
        csq = jnp.sum(centroids * centroids, axis=1)[None, :]
        qc = 0.5 * (qsq + csq - cd)  # (Q, K)

    def window(w, run_s, run_i):
        pos = w * chunk + jax.lax.broadcasted_iota(jnp.int32, (chunk, 1), 0)[:, 0]
        kk = jnp.searchsorted(pref, pos, side="right")  # (chunk,) cluster
        kk = jnp.minimum(kk, kc - 1)
        prev = jnp.where(kk > 0, pref[jnp.maximum(kk - 1, 0)], 0)
        row = offsets[kk] + (pos - prev)
        ct = jnp.take(codes_sorted, row, axis=0)  # (chunk, rb)
        rid = jnp.take(ids_sorted, row)
        if use_scorer:
            ohat, r2 = scorer_window(ct)  # (chunk, Dc), (chunk,)
            ip_q = (
                jnp.dot(q_cat, ohat.T, precision=jax.lax.Precision.HIGHEST)
                + q_add[:, None]
            )  # (Q, chunk) q·r̂
            c_dot = (
                jnp.sum(jnp.take(c_cat, kk, axis=0) * ohat, axis=1)
                + jnp.take(c_add, kk)
            )  # (chunk,) c·r̂
        else:
            r_hat = decode_fn(ct)  # (chunk, D)
            r2 = jnp.sum(r_hat * r_hat, axis=1)
            ip_q = jnp.dot(q, r_hat.T, precision=jax.lax.Precision.HIGHEST)
            c_dot = jnp.sum(jnp.take(centroids, kk, axis=0) * r_hat, axis=1)
        if metric == Metric.L2:
            # ‖q−c−r̂‖² = ‖q−c‖² − 2q·r̂ + 2c·r̂ + ‖r̂‖²
            s = -(
                jnp.take_along_axis(cd, kk[None, :], axis=1)
                - 2.0 * ip_q
                + (2.0 * c_dot + r2)[None, :]
            )
        else:
            ip_full = ip_q + jnp.take_along_axis(qc, kk[None, :], axis=1)
            if metric == Metric.IP:
                s = ip_full
            else:
                nrm = jnp.take(norms_sorted, row)
                s = ip_full / jnp.maximum(nrm, 1e-30)[None, :]
        valid = (pos < total)[None, :] & jnp.take(allowed, kk, axis=1)
        s = jnp.where(valid, s, -jnp.inf)
        cat_s = jnp.concatenate([run_s, s], axis=1)
        cat_i = jnp.concatenate([run_i, jnp.broadcast_to(rid[None, :], s.shape)],
                                axis=1)
        ms, mi = jax.lax.top_k(cat_s, k)
        return ms, jnp.take_along_axis(cat_i, mi, axis=-1)

    init = (
        jnp.zeros((1,), jnp.int32),
        jnp.full((num_q, k), -jnp.inf, jnp.float32),
        jnp.zeros((num_q, k), jnp.int32),
    )

    def cond(carry):
        return carry[0][0] * chunk < total

    def body(carry):
        w, run_s, run_i = carry
        run_s, run_i = window(w[0], run_s, run_i)
        return (w + 1, run_s, run_i)

    _, run_s, run_i = jax.lax.while_loop(cond, body, init)
    return run_s, run_i


class IvfQuantizedIndex(BaseSearchIndex):
    name = "ivf"

    def __init__(
        self,
        quantizer: BaseQuantizer,
        ivf_cfg: IVFConfig = IVFConfig(),
        search_cfg: SearchConfig = SearchConfig(),
    ):
        self.quantizer = quantizer
        self.ivf_cfg = ivf_cfg
        self.search_cfg = search_cfg
        self.centroids: Optional[jax.Array] = None
        self.codes_sorted: Optional[jax.Array] = None
        self.ids_sorted: Optional[jax.Array] = None
        self.norms_sorted: Optional[jax.Array] = None
        self.offsets: Optional[jax.Array] = None  # (K,) start row of each cluster
        self.sizes: Optional[jax.Array] = None  # (K,)
        self.max_cluster = 0
        self.num_rows = 0
        self._search_fn = None  # cached jitted search (one trace per shape)
        self._search_fn_chunk = 0
        self._c_side = None  # pre-rotated centroids (residual_scorer path)

    # ------------------------------------------------------------------ fit
    def fit(self, X, chunk_rows: int = 0, coarse=None) -> "IvfQuantizedIndex":
        """Chunked IVF construction: coarse k-means on a host-side sample,
        streamed assignment, residual-sample quantizer fit, streamed
        cluster-ordered residual encode — peak device memory is one chunk,
        never the corpus, so builds scale past HBM (reference envelope:
        1M in 12 GB CPU RAM, README.md:222-228; 53M streamed,
        streaming_sweep.py:151-186).

        coarse=(centroids (K, D), assignment (N,) int) reuses a coarse
        quantizer computed elsewhere — indexes differing only in the
        residual quantizer share one k-means + assignment pass (the
        reference's SaqIndex does its k-means python-side and hands
        centroids+assignments to construct, saq_index.py:80-96)."""
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
        if self.quantizer.params is None:
            fit_quantizer_on_residuals(
                X, assignment, self.centroids, self.quantizer,
                seed=self.ivf_cfg.kmeans.seed,
            )

        order = np.argsort(assignment, kind="stable")
        sizes = np.bincount(assignment, minlength=k)
        offsets = np.concatenate([[0], np.cumsum(sizes)[:-1]])
        codes, norms = encode_rows_ordered(
            X, order, assignment, self.centroids, self.quantizer, chunk
        )

        self.max_cluster = int(sizes.max())
        # pad the tail so a window slice never runs off the array (valid
        # windows read ≤ chunk rows past a cluster's end; see
        # scan_probed_lists / _PAD_SLACK)
        pad = _PAD_SLACK
        self.codes_sorted = jnp.asarray(
            np.pad(codes, ((0, pad),) + ((0, 0),) * (codes.ndim - 1))
        )
        self.ids_sorted = jnp.asarray(
            np.pad(order.astype(np.int32), (0, pad), constant_values=-1)
        )
        self.norms_sorted = jnp.asarray(
            np.pad(norms, (0, pad), constant_values=1.0)
        )
        self.offsets = jnp.asarray(offsets.astype(np.int32))
        self.sizes = jnp.asarray(sizes.astype(np.int32))
        # inverse permutation: global row id → position in the sorted layout
        # (decompress-by-id, reference ivf_index.cpp:245-374)
        inv = np.empty(n, dtype=np.int64)
        inv[order] = np.arange(n)
        self._inv_perm = inv
        self._assignment = assignment
        self.num_rows = n
        self._search_fn = None
        self._c_side = None
        return self

    # --------------------------------------------------------- decompress
    def decompress(self, ids: np.ndarray) -> np.ndarray:
        """Reconstruct rows by GLOBAL id: residual decode + centroid add —
        the engine's IVF::decompress (external/saq/src/ivf_index.cpp:
        245-374: dequantize raw codes, un-rotate per segment, restore norm,
        inverse PCA — all of which the quantizer's own decode performs)."""
        ids = np.asarray(ids).reshape(-1)
        pos = self._inv_perm[ids]
        # gather on device — a host round-trip of the whole codes array per
        # decompress call would defeat the chunked build
        rows = np.asarray(jnp.take(self.codes_sorted, jnp.asarray(pos), axis=0))
        res = self.quantizer.decompress(rows)
        cents = np.asarray(self.centroids)[self._assignment[ids]]
        return res + cents

    # --------------------------------------------------------------- search
    def _build_search_fn(self, chunk: int, strategy: str = "union"):
        """Jitted search, created ONCE per (index, chunk) and cached — the
        previous per-call `@jax.jit` closure re-traced on every query block.  Index
        arrays are jit ARGUMENTS (not closure constants) so they are never
        baked into the compiled program; jax.jit's own cache then gives one
        trace per (block shape, k, nprobe).

        When the quantizer provides a residual_scorer, windows score in
        code space against pre-rotated queries (rotated ONCE per block)
        and pre-rotated centroids (rotated ONCE per index, cached on
        self._c_side) — decode_fn's per-window rotation matmuls disappear
        (methods/base.residual_scorer)."""
        metric = self.search_cfg.metric
        decode_fn = self.quantizer.decode_fn()
        scorer = self.quantizer.residual_scorer()
        if scorer is not None:
            q_map, window_fn = scorer
            if self._c_side is None:
                self._c_side = jax.jit(q_map)(self.centroids)
        else:
            q_map = window_fn = None

        @functools.partial(jax.jit, static_argnames=("kk", "np_"))
        def run(qs, qs_valid, centroids, codes, ids, norms, offsets, sizes,
                c_side, kk, np_):
            # qs is (num_blocks, block, D): lax.map scans the query blocks
            # ON DEVICE, so a whole serving batch is ONE dispatch (not one
            # host round trip per block) while peak memory stays one
            # block's decoded window.  qs_valid (num_blocks,
            # block) bool masks pad rows out of the union's probe set.
            def one_block(args):
                q, qv = args
                q = q.astype(jnp.float32)
                cd = pairwise_sqdist_xc(q, centroids)  # (Q, K)
                _, probe = jax.lax.top_k(-cd, np_)  # nearest centroids (Q, P)
                q_side = q_map(q) if q_map is not None else None
                if strategy == "union":
                    ts, ti = scan_union_lists(
                        q, probe, cd, centroids, codes, ids, norms, offsets,
                        sizes, decode_fn, kk, metric, chunk=chunk,
                        scorer_window=window_fn, q_side=q_side, c_side=c_side,
                        q_valid=qv,
                    )
                else:
                    ts, ti = scan_probed_lists(
                        q, probe, centroids, codes, ids, norms, offsets,
                        sizes, decode_fn, kk, metric, chunk=chunk,
                        scorer_window=window_fn, q_side=q_side, c_side=c_side,
                    )
                if metric == Metric.L2:
                    ts = -ts
                return ts, ti

            return jax.lax.map(one_block, (qs, qs_valid))

        return run

    def _auto_chunk(self, strategy: str) -> int:
        """Window rows per while_loop step.

        windows: the next power of two ≥ the MEAN list size, clamped to
        [128, 512] — a fixed 512 paid ~4× masked decode on 128-row average
        lists; skewed lists above the chunk cost extra iterations, never a
        bigger buffer.  union: a fixed 4096 — windows there are batch-
        global, so the only trade is decode-buffer size (4096·D f32 ≈
        25 MB at D=1536) vs while-loop trip count."""
        if strategy == "union":
            return 4096
        k = int(self.sizes.shape[0])
        mean = max(1, self.num_rows // max(1, k))
        return int(np.clip(1 << int(np.ceil(np.log2(mean))), 128, 512))

    def _search_device(
        self, queries: jax.Array, k: int, nprobe: int, chunk: int = 512,
        strategy: str = "union",
    ) -> Tuple[jax.Array, jax.Array]:
        """Single-block search (qs stacked to one block); serving batches go
        through search_with_scores, which maps blocks in one dispatch.
        Default strategy matches search_with_scores' auto → "union"."""
        ts, ti = self._run_blocks(queries[None], k, nprobe, chunk, strategy)
        return ts[0], ti[0]

    def _run_blocks(
        self, qs: jax.Array, k: int, nprobe: int, chunk: int, strategy: str,
        qs_valid: Optional[jax.Array] = None,
    ) -> Tuple[jax.Array, jax.Array]:
        if strategy != "union":
            assert chunk <= _PAD_SLACK, (chunk, _PAD_SLACK)
        if qs_valid is None:
            qs_valid = jnp.ones(qs.shape[:2], bool)
        if self._search_fn is None or self._search_fn_chunk != (chunk, strategy):
            self._search_fn = self._build_search_fn(chunk, strategy)
            self._search_fn_chunk = (chunk, strategy)
        return self._search_fn(
            qs, qs_valid, self.centroids, self.codes_sorted, self.ids_sorted,
            self.norms_sorted, self.offsets, self.sizes, self._c_side,
            kk=k, np_=nprobe,
        )

    def search_with_scores(
        self, queries: np.ndarray, k: int = 10,
        query_block: Optional[int] = None, chunk: Optional[int] = None,
        decode_budget_bytes: int = 2 << 30, strategy: str = "auto",
    ) -> Tuple[np.ndarray, np.ndarray]:
        """strategy: "union" (default under "auto") decodes each probed row
        once per batch and amortizes all queries in one matmul per window
        (scan_union_lists); "windows" is the per-(query, probe) window scan
        (scan_probed_lists), kept for small-memory geometries and A/B
        (scripts/ivf_scan_ablate.py)."""
        if strategy == "auto":
            strategy = "union"
        nprobe = min(self.ivf_cfg.nprobe, self.centroids.shape[0])
        q = jnp.asarray(queries, jnp.float32)
        nq = q.shape[0]
        if chunk is None:
            chunk = self._auto_chunk(strategy)
        if query_block is None:
            if strategy == "union":
                # union memory is (chunk, D) decoded + per-query working
                # rows of ~4·(K + chunk + a few k) bytes ((Q, K) cd +
                # allowed, (Q, chunk) window scores, (Q, k+chunk) top-k
                # concat) — independent of nprobe.  Run the batch as ONE
                # block (pow2-padded, floor 16) up to the decode budget;
                # past it, cap the block so a very large serving batch
                # maps multiple blocks instead of OOMing.
                kc = int(self.sizes.shape[0])
                cap_rows = max(16, decode_budget_bytes // (4 * (kc + 2 * chunk)))
                cap = 1 << int(np.log2(cap_rows))
                query_block = min(
                    max(16, 1 << int(np.ceil(np.log2(max(1, nq))))), cap
                )
            else:
                # the scan window decodes (block, nprobe, chunk) rows of D
                # f32 — auto-size the query block so that buffer stays
                # under the budget at any (D, nprobe): e.g. D=1536,
                # nprobe=64 → block 8 (a fixed 256 block measured 24 GB
                # HBM → OOM).  Lower clamp is 1: at extreme D·nprobe·chunk
                # an 8-row floor would overrun the budget up to 8×
                #.
                d = self.centroids.shape[1]
                rows = max(1, decode_budget_bytes // (4 * d * nprobe * chunk))
                query_block = int(np.clip(1 << int(np.log2(rows)), 1, 256))
        # fixed-size query blocks bound the decoded-window buffer at
        # (block, nprobe, chunk) rows regardless of the serving batch; pad
        # the batch to a block multiple so exactly ONE block shape traces
        pad = (-nq) % query_block
        if pad:
            q = jnp.pad(q, ((0, pad), (0, 0)))
        qs = q.reshape(-1, query_block, q.shape[1])
        valid = jnp.arange(qs.shape[0] * query_block) < nq
        ts, ti = self._run_blocks(qs, k, nprobe, chunk, strategy,
                                  qs_valid=valid.reshape(qs.shape[:2]))
        scores = np.asarray(ts).reshape(-1, k)[:nq]
        ids = np.asarray(ti).reshape(-1, k)[:nq]
        ids = np.where(ids < 0, 0, ids)  # pad guard (masked scores are ±inf)
        return ids.astype(np.uint32), scores

    # ---------------------------------------------------------------- misc
    def memory_footprint(self) -> int:
        total = 0
        for a in (self.codes_sorted, self.ids_sorted, self.norms_sorted,
                  self.centroids, self.offsets, self.sizes):
            if a is not None:
                total += nbytes_of(a)
        total += sum(
            nbytes_of(p) for p in jax.tree_util.tree_leaves(self.quantizer.params)
        )
        return total

    def reconstruction_mse(self, X: np.ndarray, sample: Optional[int] = 10000) -> float:
        xs = np.asarray(X[: sample or len(X)], np.float32)
        a = np.asarray(assign(jnp.asarray(xs), self.centroids))
        res = xs - np.asarray(self.centroids)[a]
        rec = self.quantizer.decompress(self.quantizer.compress(res))
        return float(np.mean((res - rec) ** 2))

    def _state(self) -> dict:
        import pickle

        return {
            "centroids": np.asarray(self.centroids),
            "codes_sorted": np.asarray(self.codes_sorted),
            "ids_sorted": np.asarray(self.ids_sorted),
            "norms_sorted": np.asarray(self.norms_sorted),
            "offsets": np.asarray(self.offsets),
            "sizes": np.asarray(self.sizes),
            "max_cluster": self.max_cluster,
            "num_rows": self.num_rows,
            "ivf_cfg": self.ivf_cfg,
            "search_cfg": self.search_cfg,
            "quantizer": pickle.dumps(self.quantizer),
            "inv_perm": self._inv_perm,
            "assignment": self._assignment,
        }

    def _restore(self, state: dict) -> None:
        import pickle

        self.quantizer = pickle.loads(state["quantizer"])
        for name in ("centroids", "codes_sorted", "ids_sorted", "norms_sorted",
                     "offsets", "sizes"):
            setattr(self, name, jnp.asarray(state[name]))
        self.max_cluster = state["max_cluster"]
        self.num_rows = state["num_rows"]
        self.ivf_cfg = state["ivf_cfg"]
        self.search_cfg = state["search_cfg"]
        self._inv_perm = state.get("inv_perm")
        self._assignment = state.get("assignment")
        self._search_fn = None
        self._search_fn_chunk = 0
        self._c_side = None
