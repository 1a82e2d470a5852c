"""RaBitQ / Extended RaBitQ.

Capability parity with the reference's two RaBitQ paths: the faiss 1-bit
wrapper (methods/rabit_quantization.py:9-40) and the standalone multi-bit
Extended RaBitQ (methods/extended_rabitq.py:47-204).  One implementation
covers both (num_bits=1 → classic RaBitQ up to the shared-codebook scale,
which the per-vector rescale factor t absorbs).

Model (Gao & Long, Extended RaBitQ): centroid c, seeded random orthogonal
rotation P, and a shared B-bit Gaussian-optimal scalar codebook (1-D Lloyd
on N(0,1) — kernels/lloyd1d.py).  Encode: r = x−c, s = (r/‖r‖)·P·√D,
per-coord nearest level, rescale t = ⟨s,ŝ⟩/⟨ŝ,ŝ⟩.  Code row layout matches
the reference byte-for-byte: [packed B-bit indices ‖ ‖r‖ f32 ‖ t f32] =
ceil(D·B/8)+8 bytes, self-contained rows.

Search: the rotation is orthogonal, so the scan rotates the QUERIES once
(q·x̂ = α·(qP)·ŝ + q·c with α = ‖r‖·t/√D) and each corpus tile only needs
bit-unpack + tiny level lookup + one matmul — never a D×D rotation per
tile.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp
import numpy as np

from vq_tpu.core.config import Metric, RaBitQConfig
from vq_tpu.core.packing import (
    bytes_to_f32,
    f32_to_bytes,
    pack_bits,
    packed_bytes,
    unpack_bits,
)
from vq_tpu.kernels.adc import _bf16_supported, _finalize, _streaming_topk
from vq_tpu.kernels.lloyd1d import lloyd_1d_normal, quantize_to_levels
from vq_tpu.methods.base import BaseQuantizer


class RaBitQParams(NamedTuple):
    centroid: jax.Array  # (D,)
    rotation: jax.Array  # (D, D) orthogonal, applied as v @ rotation
    levels: jax.Array  # (2^B,) shared scalar codebook


def fit(key: jax.Array, x: jax.Array, cfg: RaBitQConfig) -> RaBitQParams:
    x = jnp.asarray(x, dtype=jnp.float32)
    d = x.shape[1]
    centroid = jnp.mean(x, axis=0)
    # seeded random orthogonal rotation via host float64 QR (one-time; exact
    # orthogonality matters because decode applies P^T)
    rng = np.random.default_rng(cfg.seed)
    q, _ = np.linalg.qr(rng.standard_normal((d, d)))
    rotation = jnp.asarray(q, dtype=jnp.float32)
    levels = lloyd_1d_normal(1 << cfg.num_bits, seed=cfg.seed)
    return RaBitQParams(centroid=centroid, rotation=rotation, levels=levels)


def _encode_arrays(params: RaBitQParams, x: jax.Array):
    """→ (idx (N,D) int32, nrm (N,), t (N,))."""
    x = jnp.asarray(x, dtype=jnp.float32)
    d = x.shape[1]
    r = x - params.centroid
    nrm = jnp.linalg.norm(r, axis=1)
    o = r / jnp.maximum(nrm, 1e-12)[:, None]
    s = jnp.dot(o, params.rotation, precision=jax.lax.Precision.HIGHEST) * jnp.sqrt(
        jnp.float32(d)
    )
    idx = quantize_to_levels(s, params.levels)
    s_hat = params.levels[idx]
    num = jnp.sum(s * s_hat, axis=1)
    den = jnp.sum(s_hat * s_hat, axis=1)
    t = jnp.where(den > 1e-12, num / den, 1.0)
    return idx, nrm, t


def encode(params: RaBitQParams, x: jax.Array, num_bits: int) -> jax.Array:
    """→ (N, ceil(D·B/8)+8) uint8 self-contained rows."""
    idx, nrm, t = _encode_arrays(params, x)
    packed = pack_bits(idx, num_bits)
    return jnp.concatenate([packed, f32_to_bytes(nrm), f32_to_bytes(t)], axis=1)


def _shat_from_packed(
    packed: jax.Array, levels: jax.Array, num_bits: int, d: int
) -> jax.Array:
    """Unpack indices and look up their levels (≤ 256-entry table)."""
    return jnp.take(levels, unpack_bits(packed, num_bits, d))


def decode(params: RaBitQParams, codes: jax.Array, num_bits: int) -> jax.Array:
    d = params.centroid.shape[0]
    ib = packed_bytes(d, num_bits)
    s_hat = _shat_from_packed(codes[:, :ib], params.levels, num_bits, d)
    nrm = bytes_to_f32(codes[:, ib : ib + 4])
    t = bytes_to_f32(codes[:, ib + 4 : ib + 8])
    o_hat = s_hat / jnp.sqrt(jnp.float32(d)) * t[:, None]
    return (
        jnp.dot(o_hat, params.rotation.T, precision=jax.lax.Precision.HIGHEST)
        * nrm[:, None]
        + params.centroid
    )


# ---------------------------------------------------------------------------
# packed-word scan layout (kernels/packed.py)
# ---------------------------------------------------------------------------


# B ≥ this width stores the precomputed f32 value plane instead of packed
# codes + shared-table lookup (kernels/packed.py "values").
_VALUES_MIN_BITS = 5


def _packed_segspec(d: int, num_bits: int):
    from vq_tpu.kernels.packed import make_segspec

    # scale_col 0 = the estimator scale α = ‖r‖√D/(t‖ŝ‖²), folded into the
    # dequantized values so the matmul emits α·⟨q,ŝ⟩ directly
    if num_bits >= _VALUES_MIN_BITS:
        return make_segspec(num_bits, d, "values", 0)
    return make_segspec(num_bits, d, "shared", 0)


def prepare_packed(
    params: RaBitQParams,
    codes: jax.Array,
    num_bits: int,
    norms: Optional[jax.Array] = None,
    row_chunk: int = 131072,
):
    """Byte rows → PackedCorpus.  factors = (α, c2, original-norm-or-1):
    α = ‖r‖√D/(t‖ŝ‖²) is the estimator scale the scan folds into the
    dequantized values (scale_col 0), c2 = 2α·(ŝ·c_rot) + ‖r‖² is the
    precomputed L2 shift (r2_cols) — all row-side score constants leave
    the scan (kernels/packed.py module docstring)."""
    from vq_tpu.kernels.packed import PackedCorpus, pack_words

    d = params.centroid.shape[0]
    ib = packed_bytes(d, num_bits)
    n = codes.shape[0]
    row_chunk = max(512, row_chunk - row_chunk % 512)
    pad = (-n) % 512
    if pad:  # zero rows parse to idx 0 / nrm 0 / t 0; `limit` masks them
        codes = jnp.pad(codes, ((0, pad), (0, 0)))
    n_pad = n + pad

    seg = _packed_segspec(d, num_bits)
    c_rot = jnp.dot(params.centroid, params.rotation,
                    precision=jax.lax.Precision.HIGHEST)

    @jax.jit
    def convert(rows):
        idx = unpack_bits(rows[:, :ib], num_bits, d)
        nrm = bytes_to_f32(rows[:, ib : ib + 4])
        t = bytes_to_f32(rows[:, ib + 4 : ib + 8])
        s_hat = params.levels[idx]
        snorm_sq = jnp.sum(s_hat * s_hat, axis=1)
        alpha = nrm * jnp.sqrt(jnp.float32(d)) / jnp.maximum(
            t * snorm_sq, 1e-12
        )
        cdot = jnp.dot(s_hat, c_rot, precision=jax.lax.Precision.HIGHEST)
        c2 = 2.0 * alpha * cdot + nrm * nrm
        if seg.dequant == "values":
            # f32 value plane (unscaled ŝ — the scan applies α via
            # scale_col)
            w = s_hat.astype(jnp.float32)
        else:
            w = pack_words(idx, num_bits, seg.beff)
        return w, jnp.stack([alpha, c2], axis=1)

    chunks = [convert(codes[i0 : min(i0 + row_chunk, n_pad)])
              for i0 in range(0, n_pad, row_chunk)]
    words = jnp.concatenate([c[0] for c in chunks], axis=0)
    fac = jnp.concatenate([c[1] for c in chunks], axis=0)
    nrm_col = (
        jnp.ones((n, 1), jnp.float32)
        if norms is None
        else norms.reshape(n, 1).astype(jnp.float32)
    )
    if pad:
        nrm_col = jnp.pad(nrm_col, ((0, pad), (0, 0)), constant_values=1.0)
    fac = jnp.concatenate([fac, nrm_col], axis=1)
    return PackedCorpus(words=(words,), factors=fac, num_rows=n,
                        has_norms=norms is not None)


def _packed_scan(params, queries, packed, k, metric, num_bits,
                 num_valid=None, use_bf16=True, tile_mask=None,
                 mask_cap=None):
    from vq_tpu.kernels.packed import packed_scan_topk

    if metric == Metric.NIP and not packed.has_norms:
        raise ValueError("Metric.NIP needs a packed cache built with norms")
    d = params.centroid.shape[0]
    seg = _packed_segspec(d, num_bits)
    queries = jnp.asarray(queries, jnp.float32)
    qr = jnp.dot(queries, params.rotation, precision=jax.lax.Precision.HIGHEST)
    qc = jnp.dot(queries, params.centroid, precision=jax.lax.Precision.HIGHEST)
    c_sq = jnp.sum(params.centroid**2)
    if metric == Metric.L2:
        kind, qa = "l2", 2.0 * qc - c_sq
    elif metric == Metric.IP:
        kind, qa = "ip", qc
    else:
        kind, qa = "nip", qc
    limit = packed.num_rows if num_valid is None else jnp.minimum(
        packed.num_rows, num_valid
    )
    lv_tables = (
        () if seg.dequant == "values" else (params.levels.reshape(1, -1),)
    )
    return packed_scan_topk(
        qr, qa, packed.words, packed.factors, lv_tables, (seg,), k,
        metric_kind=kind, norm_col=2, r2_cols=(1,), limit=limit,
        use_bf16=use_bf16, tile_mask=tile_mask, mask_cap=mask_cap,
    )


def scan_topk(
    params: RaBitQParams,
    queries: jax.Array,
    codes: jax.Array,
    k: int,
    metric: Metric,
    num_bits: int,
    norms: Optional[jax.Array] = None,
    tile_rows: int = 16384,
    use_bf16: bool = True,
    num_valid: Optional[jax.Array] = None,
    approx: bool = False,
):
    """Fused RaBitQ scan over the stored byte rows: rotated queries,
    per-tile bit-unpack + level lookup + one matmul; no per-tile D×D
    rotation."""
    d = params.centroid.shape[0]
    ib = packed_bytes(d, num_bits)
    n = codes.shape[0]
    num_q = queries.shape[0]
    tile = min(tile_rows, max(8, n))
    use_bf16 = use_bf16 and _bf16_supported()
    dt = jnp.bfloat16 if use_bf16 else jnp.float32
    prec = jax.lax.Precision.DEFAULT if use_bf16 else jax.lax.Precision.HIGHEST

    queries = jnp.asarray(queries, dtype=jnp.float32)
    q_sq = jnp.sum(queries * queries, axis=-1)
    qr = jnp.dot(queries, params.rotation, precision=jax.lax.Precision.HIGHEST)
    qc = jnp.dot(queries, params.centroid, precision=jax.lax.Precision.HIGHEST)  # (Q,)
    cr = jnp.dot(params.centroid, params.rotation, precision=jax.lax.Precision.HIGHEST)
    c_sq = jnp.sum(params.centroid**2)

    n_pad = (-n) % tile
    codes_p = jnp.pad(codes, ((0, n_pad), (0, 0)))
    norms_p = None
    if metric == Metric.NIP:
        if norms is None:
            raise ValueError("Metric.NIP requires original row norms")
        norms_p = jnp.pad(norms.astype(jnp.float32), (0, n_pad), constant_values=1.0)

    qrd = qr.astype(dt)

    def score_tile(start):
        ct = jax.lax.dynamic_slice_in_dim(codes_p, start, tile, axis=0)
        s_hat = _shat_from_packed(ct[:, :ib], params.levels, num_bits, d)  # (T, D)
        nrm = bytes_to_f32(ct[:, ib : ib + 4])
        t = bytes_to_f32(ct[:, ib + 4 : ib + 8])
        # Unbiased RaBitQ estimator (Gao & Long): ⟨q,o⟩ ≈ ⟨q,ō⟩/⟨o,ō⟩, i.e.
        # divide by the alignment rather than project onto ō.  The stored
        # factor is the projection coefficient t = ⟨s,ŝ⟩/⟨ŝ,ŝ⟩ (best for
        # decode MSE); the unbiased scale is recovered per tile from
        # ⟨s,ŝ⟩ = t·‖ŝ‖², so alpha = ‖r‖·√D/(t·‖ŝ‖²).  Projection scoring
        # multiplies each row by ⟨o,ō⟩² — a per-row bias that reorders
        # neighbors (measured: 1-bit R@10 0.374 → 0.395 on the parity set).
        snorm = jnp.sum(s_hat * s_hat, axis=-1)  # (T,)
        alpha = nrm * jnp.sqrt(jnp.float32(d)) / jnp.maximum(t * snorm, 1e-12)
        sdot = jnp.dot(qrd, s_hat.astype(dt).T, preferred_element_type=jnp.float32,
                       precision=prec)  # (Q, T)
        ip = alpha[None, :] * sdot + qc[:, None]  # q·x̂
        if metric == Metric.L2:
            cdot = jnp.dot(s_hat, cr, precision=jax.lax.Precision.HIGHEST)
            # ‖x‖² = ‖c‖² + 2⟨c,r⟩ + ‖r‖² with ⟨c,r⟩ estimated unbiasedly
            xhat_sq = nrm * nrm + 2.0 * alpha * cdot + c_sq
            s = 2.0 * ip - xhat_sq[None, :]
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


class RaBitQ(BaseQuantizer):
    name = "rabitq"

    def __init__(self, cfg: RaBitQConfig = RaBitQConfig()):
        super().__init__()
        if not 1 <= cfg.num_bits <= 8:
            raise ValueError("num_bits must be in [1, 8]")
        self.cfg = cfg

    def fit(self, X: np.ndarray) -> "RaBitQ":
        self._dim = X.shape[1]
        self.params = fit(jax.random.PRNGKey(self.cfg.seed), jnp.asarray(X), self.cfg)
        return self

    def compress(self, X: np.ndarray) -> np.ndarray:
        return np.asarray(encode(self.params, jnp.asarray(X), self.cfg.num_bits))

    def decompress(self, codes: np.ndarray) -> np.ndarray:
        return np.asarray(decode(self.params, jnp.asarray(codes), self.cfg.num_bits))

    def decode_fn(self):
        params, bits = self.params, self.cfg.num_bits
        return lambda ct: decode(params, ct, bits)

    def encode_fn(self):
        params, bits = self.params, self.cfg.num_bits
        return lambda x: encode(params, x, bits)

    def scan_topk(self, queries, codes, k, metric, norms=None, tile_rows=16384,
                  use_bf16=True, approx=False, num_valid=None):
        return scan_topk(
            self.params, queries, codes, k, metric, self.cfg.num_bits,
            norms=norms, tile_rows=tile_rows, use_bf16=use_bf16, approx=approx,
            num_valid=num_valid,
        )

    def prepare_tile_cache(self, codes, norms=None):
        """Order-preserving PackedCorpus for the packed scan (base
        contract)."""
        return prepare_packed(self.params, jnp.asarray(codes),
                              self.cfg.num_bits, norms=norms)

    def packed_scan_raw(self, queries, packed, k, metric, num_valid=None,
                        use_bf16=True, tile_mask=None, mask_cap=None):
        return _packed_scan(
            self.params, queries, packed, k, metric, self.cfg.num_bits,
            num_valid=num_valid, use_bf16=use_bf16, tile_mask=tile_mask,
            mask_cap=mask_cap,
        )

    def residual_scorer(self):
        """Code-space window scorer (base contract): with
        ô = ŝ·(‖r‖·t/√D), decode(ct) = rotᵀ(ô) + centroid, so
        v·decode = (v@rot)·ô + v·centroid and ‖decode‖² = ‖c‖² +
        2·(c@rot)·ô + ‖ô‖² — no per-window D×D rotation.  Matches
        decode_fn's projection-form scoring (the flat scan's unbiased
        estimator is a different score; IVF windows follow decode)."""
        params, bits = self.params, self.cfg.num_bits
        d = params.centroid.shape[0]
        ib = packed_bytes(d, bits)
        c_rot = jnp.dot(params.centroid, params.rotation,
                        precision=jax.lax.Precision.HIGHEST)
        c_sq = jnp.sum(params.centroid ** 2)
        sqrt_d = jnp.sqrt(jnp.float32(d))

        def q_map(v):
            v = jnp.asarray(v, jnp.float32)
            v_cat = jnp.dot(v, params.rotation,
                            precision=jax.lax.Precision.HIGHEST)
            v_add = jnp.dot(v, params.centroid,
                            precision=jax.lax.Precision.HIGHEST)
            return v_cat, v_add

        def window(ct):
            s_hat = _shat_from_packed(ct[:, :ib], params.levels, bits, d)
            nrm = bytes_to_f32(ct[:, ib : ib + 4])
            t = bytes_to_f32(ct[:, ib + 4 : ib + 8])
            o = s_hat * (nrm * t / sqrt_d)[:, None]
            r2 = c_sq + 2.0 * jnp.dot(
                o, c_rot, precision=jax.lax.Precision.HIGHEST
            ) + jnp.sum(o * o, axis=1)
            return o, r2

        return q_map, window

    def code_bytes_per_vector(self) -> float:
        return float(packed_bytes(self._dim, self.cfg.num_bits) + 8)

    def config_dict(self):
        return {"B": self.cfg.num_bits}
