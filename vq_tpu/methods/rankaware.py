"""Rank-aware per-dimension bit-allocation quantizer.

Capability parity with the reference's RankAwareQuantizer
(methods/rank_aware_quantization.py:56-329): center → PCA rotate → per-dim
var^(1+α)-weighted greedy bit allocation (α=0 is the pure-MSE "perdim_mse"
variant) → per-dim scalar codebooks (analytic Gaussian-optimal × √var, or
data-fit Lloyd via kernels/lloyd1d) → dense or FFD bit packing.

Design deltas from the reference:
  * the greedy is solved in closed form — per-dim marginal gains are
    monotone in b, so the allocation is exactly the global top-`budget`
    entries of the (D, max_bits) gain matrix (one argpartition, no loop);
  * all per-dim Lloyd codebooks train as one vmapped program per bit-group;
  * FFD pack/unpack are assignment-matrix matmuls (core/ffd.py);
  * search rotates queries once (q·x̂ = (qV)·ŷ + q·mu) — no per-tile D×D.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp
import numpy as np

from vq_tpu.core.config import Metric, RankAwareConfig
from vq_tpu.core.ffd import (
    FFDLayout,
    dense_decode_codes,
    dense_encode,
    ffd_decode_codes,
    ffd_encode,
    ffd_layout,
)
from vq_tpu.kernels.adc import _bf16_supported, _finalize, _streaming_topk
from vq_tpu.kernels.lloyd1d import (
    lloyd_1d_columns,
    lloyd_1d_normal,
    quantize_to_levels_per_dim,
)
from vq_tpu.methods.base import BaseQuantizer


class RankAwareParams(NamedTuple):
    mean: jax.Array  # (D,)
    rotation: jax.Array  # (D, D) PCA, applied as (x − mean) @ rotation
    codebooks: jax.Array  # (D, 2^max_bits) dense per-dim levels (tail garbage)


def _gaussian_mse_table(max_bits: int, seed: int) -> tuple:
    """levels[b] and normalized N(0,1) quantizer MSE Dg[b] for b = 0..max."""
    samples = jax.random.normal(jax.random.PRNGKey(seed), (200_000,))
    levels, dg = [np.zeros(1)], [1.0]
    from vq_tpu.kernels.lloyd1d import lloyd_1d, quantize_to_levels

    for b in range(1, max_bits + 1):
        lv = lloyd_1d(samples, 1 << b)
        idx = quantize_to_levels(samples, lv)
        mse = float(jnp.mean((samples - lv[idx]) ** 2))
        levels.append(np.asarray(lv))
        dg.append(mse)
    return levels, np.asarray(dg)


def allocate_bits(
    variances: np.ndarray, dg: np.ndarray, budget_bits: int, alpha: float, max_bits: int
) -> np.ndarray:
    """Closed-form rank-aware greedy: gains g[d,b] = var_d^(1+α)·(Dg[b]−Dg[b+1])
    are decreasing in b, so the top-`budget` gains form per-dim prefixes —
    identical to the reference's sequential greedy
    (rank_aware_quantization.py:149-181)."""
    d = len(variances)
    var_pow = np.clip(variances, 1e-12, None) ** (1.0 + alpha)
    gains = var_pow[:, None] * (dg[:-1] - dg[1:])[None, :]  # (D, max_bits)
    flat = gains.ravel()
    budget = min(budget_bits, flat.size)
    if budget <= 0:
        return np.zeros(d, dtype=np.int64)
    thresh_idx = np.argpartition(flat, -budget)[-budget:]
    chosen = np.zeros_like(flat, dtype=bool)
    chosen[thresh_idx] = True
    return chosen.reshape(d, max_bits).sum(axis=1).astype(np.int64)


def fit(key: jax.Array, x, cfg: RankAwareConfig, sample_cap: int = 200_000):
    """→ (params, bits (D,) numpy, layout-or-None).

    Host corpora (numpy/mmap) are subsampled host-side before any device
    transfer (53M-safe).
    """
    from vq_tpu.data.sampling import host_sample_rows

    xs = jnp.asarray(host_sample_rows(x, sample_cap, cfg.seed), jnp.float32)
    d = xs.shape[1]

    mean = jnp.mean(xs, axis=0)
    xc = xs - mean
    cov = jnp.dot(xc.T, xc, precision=jax.lax.Precision.HIGHEST) / xs.shape[0]
    w, v = jnp.linalg.eigh(cov)
    order = jnp.argsort(-w)
    variances = np.clip(np.asarray(w[order]), 1e-12, None)
    rotation = v[:, order]

    levels, dg = _gaussian_mse_table(cfg.max_bits, cfg.seed)
    budget = int(round(cfg.bits_per_dim * d))
    bits = allocate_bits(variances, dg, budget, cfg.alpha, cfg.max_bits)

    lmax = 1 << cfg.max_bits
    cb = np.zeros((d, lmax), dtype=np.float32)
    if cfg.codebook == "gaussian":
        scale = np.sqrt(variances)
        for dd in range(d):
            b = int(bits[dd])
            cb[dd, : 1 << b] = levels[b] * scale[dd]
    elif cfg.codebook == "exact":
        # per-dim exact optimal 1-D k-means via the native D&C DP
        # (reference's 'exact' engine codebooks, method_registry_saq.py:44-49)
        from vq_tpu.native import codebook_exact

        y = np.asarray(jnp.dot(xc, rotation, precision=jax.lax.Precision.HIGHEST))
        for dd in range(d):
            b = int(bits[dd])
            if b:
                cb[dd, : 1 << b] = codebook_exact(y[:, dd], 1 << b,
                                                  sample_cap=16384, seed=cfg.seed)
    else:  # data-fit Lloyd per dim, grouped by bit width (one vmap per group)
        y = jnp.dot(xc, rotation, precision=jax.lax.Precision.HIGHEST)
        for b in sorted(set(int(b) for b in bits)):
            if b == 0:
                continue
            cols = np.nonzero(bits == b)[0]
            lv = lloyd_1d_columns(y[:, jnp.asarray(cols)], 1 << b)  # (G, 2^b)
            cb[cols, : 1 << b] = np.asarray(lv)

    layout = ffd_layout(bits) if cfg.packing == "ffd" else None
    params = RankAwareParams(
        mean=mean, rotation=rotation, codebooks=jnp.asarray(cb)
    )
    return params, bits, layout


def _quantize(params: RankAwareParams, bits: np.ndarray, x: jax.Array) -> jax.Array:
    """(N, D) → per-dim code indices (N, D) int32."""
    y = jnp.dot(
        jnp.asarray(x, jnp.float32) - params.mean, params.rotation,
        precision=jax.lax.Precision.HIGHEST,
    )
    n = y.shape[0]
    codes = jnp.zeros((n, len(bits)), dtype=jnp.int32)
    for b in sorted(set(int(b) for b in bits)):
        if b == 0:
            continue
        cols = np.nonzero(bits == b)[0]
        lv = params.codebooks[jnp.asarray(cols), : 1 << b]  # (G, 2^b)
        idx = quantize_to_levels_per_dim(y[:, jnp.asarray(cols)], lv)
        codes = codes.at[:, jnp.asarray(cols)].set(idx)
    return codes


def _dequantize_y(params: RankAwareParams, codes: jax.Array) -> jax.Array:
    """codes (N, D) → ŷ (N, D): per-dim codebook lookup as a batched gather
    over the (D, L) level table (vmapped over dims)."""
    return jax.vmap(lambda lv, c: lv[c], in_axes=(0, 1), out_axes=1)(
        params.codebooks, codes
    )


def encode(params, bits, layout, x, packing: str):
    codes = _quantize(params, bits, x)
    if packing == "ffd":
        return ffd_encode(codes, layout)
    return dense_encode(codes, bits)


# ---------------------------------------------------------------------------
# packed-word scan layout (kernels/packed.py)
# ---------------------------------------------------------------------------


def _bit_runs(bits: np.ndarray):
    """Maximal runs of equal nonzero bit width → [(start, len, b), ...].
    0-bit dims decode to ŷ=0 and are dropped from the scan entirely."""
    runs = []
    d = len(bits)
    i = 0
    while i < d:
        b = int(bits[i])
        j = i + 1
        while j < d and int(bits[j]) == b:
            j += 1
        if b > 0:
            runs.append((i, j - i, b))
        i = j
    return runs


def _packed_segspecs(params: "RankAwareParams", bits: np.ndarray):
    """→ (segspecs, lv_tables, dim_slices) — one segment per equal-bit run,
    per-dim level tables, no per-row scale (levels are absolute in y-space).
    B ≥ 5 runs use the f32 value-plane layout ("values", no table —
    kernels/packed.py); lv_tables carries only the tables the scan reads,
    in segment order."""
    from vq_tpu.kernels.packed import make_segspec
    from vq_tpu.methods.saq import _VALUES_MIN_BITS

    segs, lv_tables, dim_slices = [], [], []
    for st, ln, b in _bit_runs(np.asarray(bits)):
        if b >= _VALUES_MIN_BITS:
            segs.append(make_segspec(b, ln, "values", -1))
        else:
            segs.append(make_segspec(b, ln, "perdim", -1))
            lv_tables.append(params.codebooks[st : st + ln, : 1 << b])
        dim_slices.append((st, ln))
    return tuple(segs), tuple(lv_tables), dim_slices


def prepare_packed(params, bits, layout, codes, packing: str,
                   norms: Optional[jax.Array] = None, row_chunk: int = 131072):
    """Packed rows (dense or FFD) → PackedCorpus: decode to per-dim indices,
    re-pack as interleaved bitplane words per equal-bit segment.  factors =
    (r2_0..r2_{S-1}, original-norm-or-1): per-segment precomputed L2 shifts
    r2_s = 2·μ_s·ŷ_s + ‖ŷ_s‖² (kernels/packed.py r2_cols), then the
    norm column for Metric.NIP."""
    from vq_tpu.kernels.packed import PackedCorpus, pack_words

    n = codes.shape[0]
    runs = _bit_runs(np.asarray(bits))
    row_chunk = max(512, row_chunk - row_chunk % 512)
    pad = (-n) % 512
    if pad:  # zero rows decode to idx 0; `limit` masks them
        codes = jnp.pad(codes, ((0, pad), (0, 0)))
    n_pad = n + pad

    segspecs = _packed_segspecs(params, bits)[0]
    mu_v = jnp.dot(params.mean, params.rotation,
                   precision=jax.lax.Precision.HIGHEST)

    @jax.jit
    def convert(rows):
        if packing == "ffd":
            idx = ffd_decode_codes(rows, layout)
        else:
            idx = dense_decode_codes(rows, bits)
        # per-segment r2_s = 2·μ_s·ŷ_s + ‖ŷ_s‖² are the scan's L2 shifts
        y_hat = _dequantize_y(params, idx)
        r2_cols = []
        for st, ln, _b in runs:
            seg = y_hat[:, st : st + ln]
            rsq_s = jnp.sum(seg * seg, axis=1)
            md_s = jnp.dot(seg, mu_v[st : st + ln],
                           precision=jax.lax.Precision.HIGHEST)
            r2_cols.append((2.0 * md_s + rsq_s)[:, None])
        return tuple(
            y_hat[:, st : st + ln].astype(jnp.float32)
            if seg.dequant == "values"
            else pack_words(idx[:, st : st + ln], b, seg.beff)
            for (st, ln, b), seg in zip(runs, segspecs)
        ), jnp.concatenate(r2_cols, axis=1)

    chunks = [
        convert(codes[i0 : min(i0 + row_chunk, n_pad)])
        for i0 in range(0, n_pad, row_chunk)
    ]
    w_chunks = [c[0] for c in chunks]
    words = tuple(
        jnp.concatenate([c[s] for c in w_chunks], axis=0)
        if len(w_chunks) > 1 else w_chunks[0][s]
        for s in range(len(runs))
    )
    r2 = (
        jnp.concatenate([c[1] for c in chunks], axis=0)
        if len(chunks) > 1 else chunks[0][1]
    )
    nrm_col = (
        jnp.ones((n, 1), jnp.float32)
        if norms is None
        else norms.reshape(n, 1).astype(jnp.float32)
    )
    if pad:
        nrm_col = jnp.pad(nrm_col, ((0, pad), (0, 0)), constant_values=1.0)
    fac = jnp.concatenate([r2, nrm_col], axis=1)
    return PackedCorpus(words=words, factors=fac, num_rows=n,
                        has_norms=norms is not None)


def _packed_scan(params, bits, queries, packed, k, metric,
                 num_valid=None, use_bf16=True, tile_mask=None,
                 mask_cap=None):
    from vq_tpu.kernels.packed import packed_scan_topk

    if metric == Metric.NIP and not packed.has_norms:
        raise ValueError("Metric.NIP needs a packed cache built with norms")
    segs, lv_tables, dim_slices = _packed_segspecs(params, bits)
    queries = jnp.asarray(queries, jnp.float32)
    qv = jnp.dot(queries, params.rotation, precision=jax.lax.Precision.HIGHEST)
    q_mu = jnp.dot(queries, params.mean, precision=jax.lax.Precision.HIGHEST)
    mu_sq = jnp.sum(params.mean**2)
    q_cat = jnp.concatenate(
        [qv[:, st : st + ln] for st, ln in dim_slices], axis=1
    )
    if metric == Metric.L2:
        kind, qa = "l2", 2.0 * q_mu - mu_sq
    elif metric == Metric.IP:
        kind, qa = "ip", q_mu
    else:
        kind, qa = "nip", q_mu
    limit = packed.num_rows if num_valid is None else jnp.minimum(
        packed.num_rows, num_valid
    )
    s_cnt = len(segs)
    return packed_scan_topk(
        q_cat, qa, packed.words, packed.factors, lv_tables, segs, k,
        metric_kind=kind, norm_col=s_cnt, r2_cols=tuple(range(s_cnt)),
        limit=limit, use_bf16=use_bf16, tile_mask=tile_mask,
        mask_cap=mask_cap,
    )


def decode(params, bits, layout, packed, packing: str):
    if packing == "ffd":
        codes = ffd_decode_codes(packed, layout)
    else:
        codes = dense_decode_codes(packed, bits)
    y_hat = _dequantize_y(params, codes)
    return (
        jnp.dot(y_hat, params.rotation.T, precision=jax.lax.Precision.HIGHEST)
        + params.mean
    )


class RankAware(BaseQuantizer):
    name = "rankaware"

    def __init__(self, cfg: RankAwareConfig = RankAwareConfig()):
        super().__init__()
        if not 1 <= cfg.max_bits <= 8:
            raise ValueError("max_bits must be in [1, 8]")
        self.cfg = cfg
        self.bits: Optional[np.ndarray] = None
        self.layout: Optional[FFDLayout] = None

    def fit(self, X: np.ndarray) -> "RankAware":
        self._dim = X.shape[1]
        self.params, self.bits, self.layout = fit(
            jax.random.PRNGKey(self.cfg.seed), X, self.cfg
        )
        return self

    def compress(self, X: np.ndarray) -> np.ndarray:
        return np.asarray(
            encode(self.params, self.bits, self.layout, jnp.asarray(X), self.cfg.packing)
        )

    def decompress(self, codes: np.ndarray) -> np.ndarray:
        return np.asarray(
            decode(self.params, self.bits, self.layout, jnp.asarray(codes), self.cfg.packing)
        )

    def decode_fn(self):
        params, bits, layout, packing = self.params, self.bits, self.layout, self.cfg.packing
        return lambda ct: decode(params, bits, layout, ct, packing)

    def prepare_tile_cache(self, codes, norms=None):
        """Order-preserving PackedCorpus for the packed scan (base
        contract)."""
        return prepare_packed(self.params, self.bits, self.layout,
                              jnp.asarray(codes), self.cfg.packing,
                              norms=norms)

    def packed_scan_raw(self, queries, packed, k, metric, num_valid=None,
                        use_bf16=True, tile_mask=None, mask_cap=None):
        return _packed_scan(
            self.params, self.bits, queries, packed, k, metric,
            num_valid=num_valid, use_bf16=use_bf16, tile_mask=tile_mask,
            mask_cap=mask_cap,
        )

    def residual_scorer(self):
        """Code-space window scorer (base contract): decode(ct) =
        rotᵀ(ŷ) + mean, so v·decode = (v@rot)·ŷ + v·mean and ‖decode‖² =
        ‖mean‖² + 2·(mean@rot)·ŷ + ‖ŷ‖² — windows skip decode_fn's D×D
        un-rotation."""
        params, bits, layout, packing = (
            self.params, self.bits, self.layout, self.cfg.packing
        )
        mu_v = jnp.dot(params.mean, params.rotation,
                       precision=jax.lax.Precision.HIGHEST)
        mu_sq = jnp.sum(params.mean ** 2)

        def q_map(v):
            v = jnp.asarray(v, jnp.float32)
            v_cat = jnp.dot(v, params.rotation,
                            precision=jax.lax.Precision.HIGHEST)
            v_add = jnp.dot(v, params.mean,
                            precision=jax.lax.Precision.HIGHEST)
            return v_cat, v_add

        def window(ct):
            if packing == "ffd":
                idx = ffd_decode_codes(ct, layout)
            else:
                idx = dense_decode_codes(ct, bits)
            y_hat = _dequantize_y(params, idx)
            r2 = mu_sq + 2.0 * jnp.dot(
                y_hat, mu_v, precision=jax.lax.Precision.HIGHEST
            ) + jnp.sum(y_hat * y_hat, axis=1)
            return y_hat, r2

        return q_map, window

    def scan_topk(self, queries, codes, k, metric, norms=None, tile_rows=16384,
                  use_bf16=True, approx=False, num_valid=None):
        """Rotated-query fused scan: q·x̂ = (qV)·ŷ + q·mu, ‖x̂‖² from ŷ."""
        params, bits, layout, packing = self.params, self.bits, self.layout, self.cfg.packing
        n = codes.shape[0]
        num_q = queries.shape[0]
        tile = min(tile_rows, max(8, n))
        bf = use_bf16 and _bf16_supported()
        dt = jnp.bfloat16 if bf else jnp.float32
        prec = jax.lax.Precision.DEFAULT if bf else jax.lax.Precision.HIGHEST

        queries = jnp.asarray(queries, jnp.float32)
        q_sq = jnp.sum(queries * queries, axis=-1)
        qv = jnp.dot(queries, params.rotation,
                     precision=jax.lax.Precision.HIGHEST).astype(dt)
        q_mu = jnp.dot(queries, params.mean, precision=jax.lax.Precision.HIGHEST)
        mu_v = jnp.dot(params.mean, params.rotation,
                       precision=jax.lax.Precision.HIGHEST)
        mu_sq = jnp.sum(params.mean**2)

        n_pad = (-n) % tile
        codes_p = jnp.pad(codes, ((0, n_pad), (0, 0)))
        norms_p = None
        if metric == Metric.NIP:
            if norms is None:
                raise ValueError("Metric.NIP requires original row norms")
            norms_p = jnp.pad(norms.astype(jnp.float32), (0, n_pad), constant_values=1.0)

        def score_tile(start):
            ct = jax.lax.dynamic_slice_in_dim(codes_p, start, tile, axis=0)
            if packing == "ffd":
                idx = ffd_decode_codes(ct, layout)
            else:
                idx = dense_decode_codes(ct, bits)
            y_hat = _dequantize_y(params, idx)  # (T, D)
            ipr = jnp.dot(qv, y_hat.astype(dt).T, preferred_element_type=jnp.float32,
                          precision=prec)
            ip = ipr + q_mu[:, None]
            if metric == Metric.L2:
                xsq = (
                    jnp.sum(y_hat * y_hat, axis=1)
                    + 2.0 * jnp.dot(y_hat, mu_v, precision=jax.lax.Precision.HIGHEST)
                    + mu_sq
                )
                s = 2.0 * ip - xsq[None, :]
            elif metric == Metric.IP:
                s = ip
            else:
                nt = jax.lax.dynamic_slice_in_dim(norms_p, start, tile, axis=0)
                s = ip / jnp.maximum(nt, 1e-30)[None, :]
            col = start + jax.lax.broadcasted_iota(jnp.int32, (1, tile), 1)
            limit = n if num_valid is None else jnp.minimum(n, num_valid)
            return jnp.where(col < limit, s, -jnp.inf)

        scores, idx = _streaming_topk(score_tile, n, num_q, k, tile, approx=approx)
        return _finalize(scores, idx, metric, q_sq)

    def code_bytes_per_vector(self) -> float:
        if self.cfg.packing == "ffd":
            return float(self.layout.n_bytes)
        return float((int(self.bits.sum()) + 7) // 8)

    def config_dict(self):
        return {
            "bpd": self.cfg.bits_per_dim,
            "alpha": self.cfg.alpha,
            "codebook": self.cfg.codebook,
            "packing": self.cfg.packing,
        }

    def save(self, path: str) -> None:
        import os, pickle

        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        with open(path, "wb") as f:
            pickle.dump(
                {
                    "name": self.name,
                    "dim": self._dim,
                    "params": jax.tree_util.tree_map(np.asarray, self.params),
                    "bits": self.bits,
                    "layout": self.layout,
                    "config": self.config_dict(),
                },
                f,
            )

    def load(self, path: str) -> "RankAware":
        import pickle

        with open(path, "rb") as f:
            payload = pickle.load(f)
        self._dim = payload["dim"]
        self.params = jax.tree_util.tree_map(jnp.asarray, payload["params"])
        self.bits = payload["bits"]
        self.layout = payload["layout"]
        return self
