"""SAQ — variance-aware segmented CAQ quantization.

Re-design of the reference's native SAQ C++20 engine (SURVEY.md §2.2
N1-N9): the quantization plan (external/saq/include/saq/quantization_plan.h),
greedy/DP bit allocators (bit_allocator_greedy.cpp, quantization_plan.cpp:
144-255), per-segment rotators (rotator.h:20-88), CAQ encoder
(caq_encoder.h — see kernels/caq.py), and the K=1 fit/decompress path the
study pipeline uses (SaqEngineAdapter, benchmarks/quantizer_adapters.py:
62-135; ivf_index.cpp:196-374).

Pipeline:
  fit:    (optional) PCA → per-dim variance → empirical per-block MSE table
          (uniform-CAQ quantizer MSE on a sample, the analog of the engine's
          Lloyd MSE table, quantization_plan.cpp:21-51) → greedy or DP bit
          allocation over 64-dim blocks under budget D·bpd − segment factor
          overhead → merge equal-bit blocks into segments → per-segment
          seeded random rotations.
  encode: per segment: slice + rotate + batched-Jacobi CAQ encode + bit-pack;
          row layout [seg codes...][rescale f32 × S][o_l2norm f32 × S] —
          self-contained rows, 2 float factors per segment (the engine's
          64-bit factor overhead, quantization_plan.h:166).
  search: queries are PCA-projected and segment-rotated ONCE; each corpus
          tile needs only bit-unpack + dequant + one matmul over the
          concatenated segments (no per-tile rotations) — the matmul form
          of the engine's LUT scan.

Allocation cost is a tiny host-side scalar loop (SURVEY.md §7.3: scalar DPs
don't vectorize; everything per-vector runs on device).
"""

from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import List, NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from vq_tpu.core.config import Metric, SAQConfig
from vq_tpu.core.packing import (
    bytes_to_f32,
    f32_to_bytes,
    pack_bits,
    packed_bytes,
    unpack_bits,
)
from vq_tpu.kernels.adc import _bf16_supported, _finalize, _streaming_topk
from vq_tpu.kernels.caq import (
    caq_decode,
    caq_decode_levels,
    caq_encode,
    caq_encode_levels,
)
from vq_tpu.kernels.lloyd1d import lloyd_1d_columns
from vq_tpu.kernels.packed import PackedCorpus
from vq_tpu.methods.base import BaseQuantizer


@dataclass(frozen=True)
class SAQPlan:
    """Static quantization plan (host-side; hashable for jit closures).

    Parity with the engine's SaqData plan container
    (quantization_plan.h:98-163): per-segment (start, length, bits) over the
    PCA-rotated, variance-descending dimension order.
    """

    dim: int
    seg_starts: Tuple[int, ...]
    seg_lens: Tuple[int, ...]
    seg_bits: Tuple[int, ...]

    @property
    def num_segments(self) -> int:
        return len(self.seg_starts)

    @property
    def code_bytes(self) -> int:
        return sum(
            packed_bytes(l, b) for l, b in zip(self.seg_lens, self.seg_bits)
        ) + 8 * self.num_segments


class SAQParams(NamedTuple):
    pca_mean: jax.Array  # (D,)
    pca_rot: jax.Array  # (D, D) orthogonal (identity when use_pca=False)
    seg_rots: Tuple[jax.Array, ...]  # per-segment (len, len) rotations
    # per-segment (len, 2^bits) sorted level tables when cfg.codebook is
    # "lloyd"/"exact" (engine derive_codebooks, ivf_index.cpp:55-117);
    # empty tuple for the uniform CAQ grid.
    seg_levels: Tuple[jax.Array, ...] = ()


# ---------------------------------------------------------------------------
# fit: PCA, MSE table, allocation
# ---------------------------------------------------------------------------


def _pca(x: jax.Array) -> Tuple[jax.Array, jax.Array, jax.Array]:
    """mean, rotation (descending eigenvalue order), variances."""
    mean = jnp.mean(x, axis=0)
    xc = x - mean
    cov = jnp.dot(xc.T, xc, precision=jax.lax.Precision.HIGHEST) / x.shape[0]
    w, v = jnp.linalg.eigh(cov)  # ascending
    order = jnp.argsort(-w)
    return mean, v[:, order], w[order]


def _uniform_caq_mse_table(
    x_rot: jax.Array, max_bits: int, block_dims: int, seed: int = 0
) -> np.ndarray:
    """Empirical per-dim MSE at each bit width 0..max_bits under the CAQ
    encoder the segments actually use — the engine's
    build_mse_table_for_allocation (quantization_plan.cpp:21-51).

    Models the full encoder per allocation block: seeded random rotation of
    the block (segments are rotated before CAQ), per-vector per-block
    symmetric range v_mx, mid-rise codes, AND the per-vector rescale factor
    ‖o‖²/⟨o,ô⟩.  Without the rescale, 1-bit mid-rise is WORSE than zero
    bits on scale-spread data (levels ±v_mx/2 overshoot every small
    coordinate) and the marginal-gain greedy stops at 0 bits.
    → (D, max_bits+1); only block sums feed the allocators.
    """
    d = x_rot.shape[1]
    rng = np.random.default_rng(seed)
    nfull = d // block_dims
    rem = d % block_dims

    @functools.partial(jax.jit, static_argnames=("mb",))
    def blocks_table(xb, rots, mb):
        """(nb, n, L) × (nb, L, L) → (nb, L, mb+1) — all blocks, all bit
        widths, one compiled program instead of an eager per-block loop."""

        def one(xo, r):
            o = jnp.dot(xo, r, precision=jax.lax.Precision.HIGHEST)
            v_mx = jnp.maximum(jnp.max(jnp.abs(o), axis=1, keepdims=True), 1e-20)
            ou = o / v_mx
            out = [jnp.mean(o * o, axis=0)]  # b=0 → MSE = E[x²]
            for b in range(1, mb + 1):
                delta = 2.0 / (1 << b)
                cmax = (1 << b) - 1
                codes = jnp.clip(jnp.floor((ou + 1.0) / delta), 0, cmax)
                oau = (codes + 0.5) * delta - 1.0
                ip = jnp.sum(ou * oau, axis=1)
                ousq = jnp.sum(ou * ou, axis=1)
                rescale = jnp.where(jnp.abs(ip) > 1e-20, ousq / ip, 0.0)
                oa = oau * rescale[:, None] * v_mx
                out.append(jnp.mean((o - oa) ** 2, axis=0))
            return jnp.stack(out, axis=1)

        return jax.vmap(one)(xb, rots)

    cols = []
    if nfull:
        rots = np.stack(
            [
                np.linalg.qr(rng.standard_normal((block_dims, block_dims)))[0]
                for _ in range(nfull)
            ]
        ).astype(np.float32)
        xb = (
            x_rot[:, : nfull * block_dims]
            .reshape(-1, nfull, block_dims)
            .transpose(1, 0, 2)
        )
        cols.append(
            np.asarray(blocks_table(xb, jnp.asarray(rots), max_bits)).reshape(
                nfull * block_dims, max_bits + 1
            )
        )
    if rem:
        r = np.linalg.qr(rng.standard_normal((rem, rem)))[0].astype(np.float32)
        xb = x_rot[:, nfull * block_dims :][None].transpose(0, 1, 2)
        cols.append(
            np.asarray(blocks_table(xb, jnp.asarray(r)[None], max_bits)).reshape(
                rem, max_bits + 1
            )
        )
    return np.concatenate(cols, axis=0)


def _allocate_greedy(
    block_mse: np.ndarray, block_lens: np.ndarray, budget_bits: int, max_bits: int
) -> np.ndarray:
    """Greedy marginal-gain allocation: repeatedly grant +1 bit/dim to the
    block with the best ΔMSE per bit (bit_allocator_greedy.cpp semantics).
    block_mse: (nblocks, max_bits+1) summed-over-dims MSE."""
    nb = len(block_lens)
    bits = np.zeros(nb, dtype=np.int64)
    spent = 0
    while True:
        gains = np.full(nb, -np.inf)
        for i in range(nb):
            b = bits[i]
            if b < max_bits and spent + block_lens[i] <= budget_bits:
                gains[i] = (block_mse[i, b] - block_mse[i, b + 1]) / block_lens[i]
        best = int(np.argmax(gains))
        if not np.isfinite(gains[best]) or gains[best] <= 0:
            break
        bits[best] += 1
        spent += int(block_lens[best])
    return bits


def _allocate_dp(
    block_mse: np.ndarray, block_lens: np.ndarray, budget_bits: int, max_bits: int
) -> np.ndarray:
    """Exact DP over (block, spent-bits) minimizing total MSE
    (quantization_plan.cpp:144-255 dynamic_programming, without the
    segment-overhead term which is charged up-front here)."""
    nb = len(block_lens)
    # quantize budget in units of the (uniform) block length when possible
    INF = np.inf
    dp = np.full(budget_bits + 1, INF)
    dp[0] = 0.0
    choice = np.zeros((nb, budget_bits + 1), dtype=np.int64)
    for i in range(nb):
        ndp = np.full(budget_bits + 1, INF)
        nch = np.zeros(budget_bits + 1, dtype=np.int64)
        for b in range(0, max_bits + 1):
            cost_bits = b * int(block_lens[i])
            if cost_bits > budget_bits:
                break
            mse = block_mse[i, b]
            prev = dp[: budget_bits + 1 - cost_bits]
            cand = prev + mse
            sl = np.s_[cost_bits : budget_bits + 1]
            upd = cand < ndp[sl]
            ndp[sl] = np.where(upd, cand, ndp[sl])
            nch[sl] = np.where(upd, b, nch[sl])
        dp = ndp
        choice[i] = nch
    # backtrack from the best total ≤ budget
    j = int(np.argmin(dp))
    bits = np.zeros(nb, dtype=np.int64)
    for i in range(nb - 1, -1, -1):
        b = int(choice[i, j])
        bits[i] = b
        j -= b * int(block_lens[i])
    return bits


def make_plan(
    variances: np.ndarray,
    mse_table: np.ndarray,
    cfg: SAQConfig,
) -> SAQPlan:
    """Build the segment plan from per-dim stats (host-side scalar work)."""
    d = len(variances)
    block = cfg.block_dims
    nb = (d + block - 1) // block
    block_lens = np.array(
        [min(block, d - i * block) for i in range(nb)], dtype=np.int64
    )
    block_mse = np.stack(
        [
            mse_table[i * block : i * block + block_lens[i]].sum(axis=0)
            for i in range(nb)
        ]
    )  # (nb, max_bits+1)

    total_budget = int(round(cfg.bits_per_dim * d))
    if cfg.allocator == "uniform":
        b = max(1, min(cfg.max_bits, int(round(cfg.bits_per_dim))))
        bits = np.full(nb, b, dtype=np.int64)
    elif cfg.allocator == "dp":
        from vq_tpu.native import allocate_dp_native

        bits = allocate_dp_native(block_mse, block_lens, total_budget, cfg.max_bits)
        if bits is None:
            bits = _allocate_dp(block_mse, block_lens, total_budget, cfg.max_bits)
    else:
        from vq_tpu.native import allocate_greedy_native

        bits = allocate_greedy_native(block_mse, block_lens, total_budget, cfg.max_bits)
        if bits is None:
            bits = _allocate_greedy(block_mse, block_lens, total_budget, cfg.max_bits)

    # merge adjacent equal-bit blocks into segments; drop 0-bit tails
    seg_starts: List[int] = []
    seg_lens: List[int] = []
    seg_bits: List[int] = []
    pos = 0
    for i in range(nb):
        ln, b = int(block_lens[i]), int(bits[i])
        if b > 0:
            if seg_bits and seg_bits[-1] == b and seg_starts[-1] + seg_lens[-1] == pos:
                seg_lens[-1] += ln
            else:
                seg_starts.append(pos)
                seg_lens.append(ln)
                seg_bits.append(b)
        pos += ln
    if not seg_starts:  # degenerate budget → at least one 1-bit segment
        seg_starts, seg_lens, seg_bits = [0], [min(block, d)], [1]
    return SAQPlan(
        dim=d,
        seg_starts=tuple(seg_starts),
        seg_lens=tuple(seg_lens),
        seg_bits=tuple(seg_bits),
    )


def fit(
    key: jax.Array, x, cfg: SAQConfig, sample_cap: int = 200_000
) -> Tuple[SAQPlan, SAQParams]:
    # host-side subsampling before device transfer (53M-safe): numpy/mmap
    # corpora never fully reach HBM
    from vq_tpu.data.sampling import host_sample_rows

    xs = jnp.asarray(host_sample_rows(x, sample_cap, cfg.seed), jnp.float32)
    d = xs.shape[1]

    if cfg.use_pca:
        mean, rot, variances = _pca(xs)
    else:
        mean = jnp.zeros((d,), jnp.float32)
        rot = jnp.eye(d, dtype=jnp.float32)
        variances = jnp.var(xs, axis=0)

    x_rot = jnp.dot(xs - mean, rot, precision=jax.lax.Precision.HIGHEST)
    mse_table = _uniform_caq_mse_table(x_rot, cfg.max_bits, cfg.block_dims, cfg.seed)
    plan = make_plan(np.asarray(variances), mse_table, cfg)

    rng = np.random.default_rng(cfg.seed)
    seg_rots = tuple(
        jnp.asarray(np.linalg.qr(rng.standard_normal((l, l)))[0], dtype=jnp.float32)
        for l in plan.seg_lens
    )

    seg_levels: Tuple[jax.Array, ...] = ()
    if cfg.codebook != "uniform":
        # derive per-dim codebooks on the rotated sample (the engine's
        # derive_codebooks pass, ivf_index.cpp:55-117: allocation first,
        # then data-fit levels at the allocated widths)
        levels_list = []
        for s in range(plan.num_segments):
            st, ln, b = plan.seg_starts[s], plan.seg_lens[s], plan.seg_bits[s]
            o = jnp.dot(x_rot[:, st : st + ln], seg_rots[s],
                        precision=jax.lax.Precision.HIGHEST)
            if cfg.codebook == "exact":
                from vq_tpu.native import codebook_exact

                on = np.asarray(o)
                lv = np.stack([
                    codebook_exact(on[:, dd], 1 << b, sample_cap=16384,
                                   seed=cfg.seed)
                    for dd in range(ln)
                ])
                levels_list.append(jnp.asarray(lv, dtype=jnp.float32))
            else:  # lloyd
                levels_list.append(lloyd_1d_columns(o, 1 << b))
        seg_levels = tuple(levels_list)
    return plan, SAQParams(
        pca_mean=mean, pca_rot=rot, seg_rots=seg_rots, seg_levels=seg_levels
    )


# ---------------------------------------------------------------------------
# encode / decode
# ---------------------------------------------------------------------------


def _seg_dequant(plan: SAQPlan, params: SAQParams, s: int, idx: jax.Array,
                 rescale: jax.Array) -> jax.Array:
    """Dequantize one segment's code indices (uniform grid or derived
    levels) including the per-vector rescale factor."""
    if params.seg_levels:
        return caq_decode_levels(idx, rescale, params.seg_levels[s])
    return caq_decode(idx, rescale, plan.seg_bits[s])


def encode(plan: SAQPlan, params: SAQParams, x: jax.Array, caq_rounds: int = 6) -> jax.Array:
    x = jnp.asarray(x, dtype=jnp.float32)
    xp = jnp.dot(x - params.pca_mean, params.pca_rot,
                 precision=jax.lax.Precision.HIGHEST)
    packed_parts, rescales, norms = [], [], []
    for s in range(plan.num_segments):
        st, ln, b = plan.seg_starts[s], plan.seg_lens[s], plan.seg_bits[s]
        o = jnp.dot(xp[:, st : st + ln], params.seg_rots[s],
                    precision=jax.lax.Precision.HIGHEST)
        if params.seg_levels:
            caq = caq_encode_levels(o, params.seg_levels[s], rounds=caq_rounds)
        else:
            caq = caq_encode(o, b, rounds=caq_rounds)
        packed_parts.append(pack_bits(caq.codes, b))
        rescales.append(f32_to_bytes(caq.rescale))
        norms.append(f32_to_bytes(caq.o_l2norm))
    return jnp.concatenate(packed_parts + rescales + norms, axis=1)


def _split_row(plan: SAQPlan, codes: jax.Array):
    """Slice a code-row batch into per-segment (packed, rescale, norm)."""
    offs = []
    pos = 0
    for s in range(plan.num_segments):
        nb = packed_bytes(plan.seg_lens[s], plan.seg_bits[s])
        offs.append((pos, nb))
        pos += nb
    out = []
    fpos = pos
    for s, (p, nb) in enumerate(offs):
        packed = codes[:, p : p + nb]
        rescale = bytes_to_f32(codes[:, fpos + 4 * s : fpos + 4 * s + 4])
        npos = fpos + 4 * plan.num_segments
        norm = bytes_to_f32(codes[:, npos + 4 * s : npos + 4 * s + 4])
        out.append((packed, rescale, norm))
    return out


def decode(plan: SAQPlan, params: SAQParams, codes: jax.Array) -> jax.Array:
    n = codes.shape[0]
    parts = _split_row(plan, codes)
    xp = jnp.zeros((n, plan.dim), dtype=jnp.float32)
    for s, (packed, rescale, _norm) in enumerate(parts):
        st, ln, b = plan.seg_starts[s], plan.seg_lens[s], plan.seg_bits[s]
        idx = unpack_bits(packed, b, ln)
        o_hat = _seg_dequant(plan, params, s, idx, rescale)
        seg = jnp.dot(o_hat, params.seg_rots[s].T,
                      precision=jax.lax.Precision.HIGHEST)
        xp = xp.at[:, st : st + ln].set(seg)
    return (
        jnp.dot(xp, params.pca_rot.T, precision=jax.lax.Precision.HIGHEST)
        + params.pca_mean
    )


# ---------------------------------------------------------------------------
# packed-word scan layout (kernels/packed.py)
# ---------------------------------------------------------------------------


# Derived-codebook segments at B ≥ this width are stored as a precomputed f32
# value plane instead of packed codes + level table (kernels/packed.py
# "values"; the reference covers all widths via code_helper.h tables).
_VALUES_MIN_BITS = 5


def packed_segspecs(plan: SAQPlan, params: SAQParams):
    """→ (segspecs tuple, per-SEGMENT level-table tuple) for
    kernels/packed.py.

    factors column s carries segment s's rescale (scale_col=s).  Derived
    codebooks ("lloyd"/"exact") emit per-dim level tables for B <
    _VALUES_MIN_BITS segments and switch to the f32 value-plane layout
    ("values", entry None) above; the uniform grid needs neither.  The
    level tuple aligns with SEGMENT ids (None = no table) — callers filter
    Nones in segment order when passing lv_tables to the scan."""
    from vq_tpu.kernels.packed import make_segspec

    segs = []
    lv_list = []
    for s in range(plan.num_segments):
        ln, b = plan.seg_lens[s], plan.seg_bits[s]
        if params.seg_levels and b >= _VALUES_MIN_BITS:
            segs.append(make_segspec(b, ln, "values", s))
            lv_list.append(None)
        elif params.seg_levels:
            segs.append(make_segspec(b, ln, "perdim", s))
            lv_list.append(params.seg_levels[s])  # (ln, 2^b)
        else:
            segs.append(make_segspec(b, ln, "uniform", s))
            lv_list.append(None)
    return tuple(segs), tuple(lv_list)


@functools.partial(jax.jit, static_argnames=("plan",))
def _convert_rows(plan: SAQPlan, params: SAQParams, rows: jax.Array):
    """One chunk of byte rows → (per-segment words/value-planes, factors).
    Module-level jit (plan static, params an argument) so repeated
    prepare_packed calls — e.g. a per-chunk streaming build — share ONE
    trace instead of re-jitting a fresh closure per call."""
    from vq_tpu.kernels.packed import pack_words

    segspecs = packed_segspecs(plan, params)[0]
    # mean in code space, per segment (the L2 cross-term side of r2_s)
    mean_p = jnp.dot(params.pca_mean, params.pca_rot,
                     precision=jax.lax.Precision.HIGHEST)
    mean_segs = [
        jnp.dot(mean_p[plan.seg_starts[s] : plan.seg_starts[s]
                       + plan.seg_lens[s]], params.seg_rots[s],
                precision=jax.lax.Precision.HIGHEST)
        for s in range(plan.num_segments)
    ]
    parts = _split_row(plan, rows)
    words = []
    fac_cols = []
    r2_cols = []
    for s, (packed, rescale, _nrm) in enumerate(parts):
        idx = unpack_bits(packed, plan.seg_bits[s], plan.seg_lens[s])
        if segspecs[s].dequant == "values":
            # f32 value plane (unscaled — the scan applies the rescale
            # column)
            words.append(
                caq_decode_levels(
                    idx, jnp.ones_like(rescale), params.seg_levels[s]
                ).astype(jnp.float32)
            )
        else:
            words.append(pack_words(idx, plan.seg_bits[s], segspecs[s].beff))
        fac_cols.append(rescale[:, None])
        val = _seg_dequant(plan, params, s, idx, rescale)
        rsq_s = jnp.sum(val * val, axis=1)
        md_s = jnp.dot(val, mean_segs[s],
                       precision=jax.lax.Precision.HIGHEST)
        r2_cols.append((2.0 * md_s + rsq_s)[:, None])
    fac = jnp.concatenate(fac_cols + r2_cols, axis=1)
    return tuple(words), fac


def prepare_packed(
    plan: SAQPlan,
    params: SAQParams,
    codes: jax.Array,
    norms: Optional[jax.Array] = None,
    row_chunk: int = 131072,
) -> "PackedCorpus":
    """Byte rows → PackedCorpus (factors col s = segment s rescale; col
    S+s = segment s's precomputed L2 shift r2_s = 2·mean_s·r̂_s + ‖r̂_s‖²,
    summed by the scan; col 2S = original row norm for Metric.NIP, 1.0
    when absent), chunked so the (chunk, D, 8) unpack intermediates stay
    bounded at multi-million-row corpora.  Rows keep their order; the
    tail is zero-padded to a 512 multiple (zero byte rows parse to idx 0 /
    rescale 0 and the scan's `limit` masks them)."""
    n = codes.shape[0]
    s_count = plan.num_segments
    row_chunk = max(512, row_chunk - row_chunk % 512)  # keep chunks % u == 0
    pad = (-n) % 512
    if pad:
        codes = jnp.pad(codes, ((0, pad), (0, 0)))
    n_pad = n + pad

    w_chunks, f_chunks = [], []
    for i0 in range(0, n_pad, row_chunk):  # row_chunk % 512 == 0
        w, f = _convert_rows(plan, params, codes[i0 : i0 + row_chunk])
        w_chunks.append(w)
        f_chunks.append(f)

    def _cat(chunks):
        return jnp.concatenate(chunks, axis=0) if len(chunks) > 1 else chunks[0]

    words = tuple(
        _cat([c[s] for c in w_chunks]) for s in range(s_count)
    )
    nrm_col = (
        jnp.ones((n, 1), jnp.float32)
        if norms is None
        else norms.reshape(n, 1).astype(jnp.float32)
    )
    if pad:
        nrm_col = jnp.pad(nrm_col, ((0, pad), (0, 0)), constant_values=1.0)
    fac = jnp.concatenate([_cat(f_chunks), nrm_col], axis=1)
    return PackedCorpus(words=words, factors=fac, num_rows=n,
                        has_norms=norms is not None)


def _packed_query_side(plan, params, queries, seg_ids):
    """Rotate queries/mean into the scan's concatenated code space.

    → (q_cat (Q, Σln), mean_cat (Σln,), q_mean (Q,), mean_sq scalar)
    restricted to `seg_ids`.
    """
    qp = jnp.dot(queries, params.pca_rot, precision=jax.lax.Precision.HIGHEST)
    mean_p = jnp.dot(params.pca_mean, params.pca_rot,
                     precision=jax.lax.Precision.HIGHEST)
    q_parts, m_parts = [], []
    for s in seg_ids:
        st, ln = plan.seg_starts[s], plan.seg_lens[s]
        q_parts.append(jnp.dot(qp[:, st : st + ln], params.seg_rots[s],
                               precision=jax.lax.Precision.HIGHEST))
        m_parts.append(jnp.dot(mean_p[st : st + ln], params.seg_rots[s],
                               precision=jax.lax.Precision.HIGHEST))
    q_cat = jnp.concatenate(q_parts, axis=1)
    mean_cat = jnp.concatenate(m_parts)
    q_mean = jnp.dot(queries, params.pca_mean,
                     precision=jax.lax.Precision.HIGHEST)
    mean_sq = jnp.sum(params.pca_mean**2)
    return q_cat, mean_cat, q_mean, mean_sq


def _packed_scan(plan, params, queries, packed: PackedCorpus, k, metric,
                 num_valid=None, use_bf16=True, tile_mask=None,
                 mask_cap=None):
    """Packed scan over all segments → maximize-form (scores, row
    positions); callers finalize."""
    from vq_tpu.kernels.packed import packed_scan_topk

    if metric == Metric.NIP and not packed.has_norms:
        # a cache built without real norms fills the norm column with 1.0
        # and would silently return un-normalized scores
        raise ValueError("Metric.NIP needs a packed cache built with norms")
    segs, lv_list = packed_segspecs(plan, params)
    seg_ids = tuple(range(plan.num_segments))
    q_cat, _mean_cat, q_mean, mean_sq = _packed_query_side(
        plan, params, jnp.asarray(queries, jnp.float32), seg_ids
    )
    if metric == Metric.L2:
        kind, qa = "l2", 2.0 * q_mean - mean_sq
    elif metric == Metric.IP:
        kind, qa = "ip", q_mean
    else:
        kind, qa = "nip", q_mean
    limit = packed.num_rows if num_valid is None else jnp.minimum(
        packed.num_rows, num_valid
    )
    s_cnt = plan.num_segments
    return packed_scan_topk(
        q_cat, qa, packed.words, packed.factors,
        tuple(t for t in lv_list if t is not None), segs, k,
        metric_kind=kind, norm_col=2 * s_cnt,
        r2_cols=tuple(s_cnt + s for s in seg_ids), limit=limit,
        use_bf16=use_bf16, tile_mask=tile_mask, mask_cap=mask_cap,
    )


# ---------------------------------------------------------------------------
# fused scan (queries rotated once; no per-tile rotations)
# ---------------------------------------------------------------------------


def scan_topk(
    plan: SAQPlan,
    params: SAQParams,
    queries: jax.Array,
    codes: jax.Array,
    k: int,
    metric: Metric,
    norms: Optional[jax.Array] = None,
    tile_rows: int = 16384,
    use_bf16: bool = True,
    num_valid: Optional[jax.Array] = None,
    approx: bool = False,
    prune_segments: int = 0,
    rerank_factor: int = 10,
):
    """Fused SAQ scan over the stored byte rows, optionally with the
    engine's fastscan-estimate cascade (external/saq/include/saq/
    saq_searcher.h:83-155): prune_segments > 0 scores every row using only
    the first `prune_segments` PCA segments (the high-variance head), keeps
    rerank_factor·k candidates, then gathers and rescores them exactly with
    all segments.  Default off.
    """
    n = codes.shape[0]
    num_q = queries.shape[0]
    tile = min(tile_rows, max(8, n))
    use_bf16 = use_bf16 and _bf16_supported()
    dt = jnp.bfloat16 if use_bf16 else jnp.float32
    prec = jax.lax.Precision.DEFAULT if use_bf16 else jax.lax.Precision.HIGHEST

    queries = jnp.asarray(queries, dtype=jnp.float32)
    q_sq = jnp.sum(queries * queries, axis=-1)
    qp = jnp.dot(queries - 0.0, params.pca_rot, precision=jax.lax.Precision.HIGHEST)
    # q·x̂ = q·mean + Σ_s (q R)_s · ô_s   with (qR)_s the segment-rotated query
    q_mean = jnp.dot(queries, params.pca_mean, precision=jax.lax.Precision.HIGHEST)
    mean_sq = jnp.sum(params.pca_mean**2)
    q_segs = []
    for s in range(plan.num_segments):
        st, ln = plan.seg_starts[s], plan.seg_lens[s]
        q_segs.append(
            jnp.dot(qp[:, st : st + ln], params.seg_rots[s],
                    precision=jax.lax.Precision.HIGHEST).astype(dt)
        )

    # mean in segment space, for the ‖x̂‖² cross term: x̂ = mean + r̂ with
    # r̂ = xp_hat @ rotᵀ, so mean·r̂ = (mean @ rot)_s · ô_s summed over segments
    mean_p = jnp.dot(params.pca_mean, params.pca_rot,
                     precision=jax.lax.Precision.HIGHEST)
    mean_segs = [
        jnp.dot(mean_p[plan.seg_starts[s] : plan.seg_starts[s] + plan.seg_lens[s]],
                params.seg_rots[s], precision=jax.lax.Precision.HIGHEST)
        for s in range(plan.num_segments)
    ]

    n_pad = (-n) % tile
    codes_p = jnp.pad(codes, ((0, n_pad), (0, 0)))
    norms_p = None
    if metric == Metric.NIP:
        if norms is None:
            raise ValueError("Metric.NIP requires original row norms")
        norms_p = jnp.pad(norms.astype(jnp.float32), (0, n_pad), constant_values=1.0)

    def make_score_tile(seg_ids):
        # one full-width matmul instead of one K=block_dims matmul per
        # segment: Σ_s (qR)_s·ô_s = concat(qR) · concat(ô) since segments
        # are disjoint — 64-wide contraction dims leave the matrix units idle
        q_cat = jnp.concatenate([q_segs[s] for s in seg_ids], axis=1)
        mean_cat = jnp.concatenate([mean_segs[s] for s in seg_ids])

        def score_tile(start):
            ct = jax.lax.dynamic_slice_in_dim(codes_p, start, tile, axis=0)
            parts = _split_row(plan, ct)
            o_parts = []
            for s in seg_ids:
                packed, rescale, _nrm = parts[s]
                ln, b = plan.seg_lens[s], plan.seg_bits[s]
                idx = unpack_bits(packed, b, ln)
                o_parts.append(_seg_dequant(plan, params, s, idx, rescale))
            o_cat = jnp.concatenate(o_parts, axis=1)  # (T, Σ len)
            ip_res = jnp.dot(
                q_cat, o_cat.astype(dt).T,
                preferred_element_type=jnp.float32, precision=prec,
            )
            if metric == Metric.L2:
                res_sq = jnp.sum(o_cat * o_cat, axis=1)  # ‖x̂−mean‖²
                md = jnp.dot(o_cat, mean_cat,
                             precision=jax.lax.Precision.HIGHEST)  # mean·r̂
            ip = ip_res + q_mean[:, None]
            if metric == Metric.L2:
                # maximize 2q·x̂ − ‖x̂‖² with
                # ‖x̂‖² = ‖mean‖² + 2·mean·r̂ + ‖r̂‖² (rotations orthogonal)
                s_val = 2.0 * ip - (mean_sq + 2.0 * md[None, :] + res_sq[None, :])
            elif metric == Metric.IP:
                s_val = ip
            else:
                nt = jax.lax.dynamic_slice_in_dim(norms_p, start, tile, axis=0)
                s_val = ip / jnp.maximum(nt, 1e-30)[None, :]
            col = start + jax.lax.broadcasted_iota(jnp.int32, (1, tile), 1)
            limit = n if num_valid is None else jnp.minimum(n, num_valid)
            return jnp.where(col < limit, s_val, -jnp.inf)

        return score_tile

    all_segs = tuple(range(plan.num_segments))
    if not (0 < prune_segments < plan.num_segments) or n <= 2 * rerank_factor * k:
        scores, idx = _streaming_topk(
            make_score_tile(all_segs), n, num_q, k, tile, approx=approx
        )
        return _finalize(scores, idx, metric, q_sq)

    # ---- stage 1: head-segments estimate over all rows -------------------
    k1 = min(n, rerank_factor * k)
    s1, cand = _streaming_topk(
        make_score_tile(all_segs[:prune_segments]), n, num_q, k1, tile,
        approx=True,
    )
    alive = jnp.isfinite(s1)  # pad/invalid rows carry -inf from stage 1
    return _saq_rerank(
        plan, params, queries, codes, cand, alive, k, metric,
        norms=norms, q_sq=q_sq,
    )


def _saq_rerank(plan, params, queries, codes, cand, alive, k, metric,
                norms=None, q_sq=None):
    """Stage 2/3 of the pruning cascade: gather candidate rows, rescore
    exactly with ALL segments (the matmul form of the reference's
    compAccurateDist rescore, caq_estimator.h:152-180), merge to top-k.

    cand (Q, k1) global row ids (< N); alive masks stage-1 −inf entries.
    """
    num_q, k1 = cand.shape
    q_cat, mean_cat, q_mean, mean_sq = _packed_query_side(
        plan, params, queries, tuple(range(plan.num_segments))
    )
    rows = codes[cand.reshape(-1)]  # (Q·k1, bytes)
    parts = _split_row(plan, rows)
    o_parts = []
    for s in range(plan.num_segments):
        packed, rescale, _nrm = parts[s]
        ln, b = plan.seg_lens[s], plan.seg_bits[s]
        idx = unpack_bits(packed, b, ln)
        o_parts.append(_seg_dequant(plan, params, s, idx, rescale))
    o_cat = jnp.concatenate(o_parts, axis=1).reshape(num_q, k1, -1)
    ip_res = jnp.einsum(
        "ql,qkl->qk", q_cat.astype(jnp.float32), o_cat,
        precision=jax.lax.Precision.HIGHEST,
    )
    if metric == Metric.L2:
        res_sq = jnp.sum(o_cat * o_cat, axis=-1)
        md = jnp.einsum("qkl,l->qk", o_cat, mean_cat,
                        precision=jax.lax.Precision.HIGHEST)
    ip = ip_res + q_mean[:, None]
    if metric == Metric.L2:
        s_val = 2.0 * ip - (mean_sq + 2.0 * md + res_sq)
    elif metric == Metric.IP:
        s_val = ip
    else:
        if norms is None:
            raise ValueError("Metric.NIP requires original row norms")
        s_val = ip / jnp.maximum(norms[cand], 1e-30)
    s_val = jnp.where(alive, s_val, -jnp.inf)
    ts, ti = jax.lax.top_k(s_val, min(k, k1))
    ids = jnp.take_along_axis(cand, ti, axis=-1)
    return _finalize(ts, ids, metric, q_sq)


class SAQ(BaseQuantizer):
    name = "saq"

    def __init__(self, cfg: SAQConfig = SAQConfig()):
        super().__init__()
        self.cfg = cfg
        self.plan: Optional[SAQPlan] = None

    def fit(self, X: np.ndarray) -> "SAQ":
        self._dim = X.shape[1]
        self.plan, self.params = fit(
            jax.random.PRNGKey(self.cfg.seed), X, self.cfg
        )
        return self

    def compress(self, X: np.ndarray) -> np.ndarray:
        return np.asarray(
            encode(self.plan, self.params, jnp.asarray(X), self.cfg.caq_rounds)
        )

    def decompress(self, codes: np.ndarray) -> np.ndarray:
        return np.asarray(decode(self.plan, self.params, jnp.asarray(codes)))

    def decode_fn(self):
        plan, params = self.plan, self.params
        return lambda ct: decode(plan, params, ct)

    def encode_fn(self):
        plan, params, rounds = self.plan, self.params, self.cfg.caq_rounds
        return lambda x: encode(plan, params, x, rounds)

    def scan_topk(self, queries, codes, k, metric, norms=None, tile_rows=16384,
                  use_bf16=True, approx=False, prune_segments=0,
                  rerank_factor=10, num_valid=None):
        return scan_topk(
            self.plan, self.params, queries, codes, k, metric,
            norms=norms, tile_rows=tile_rows, use_bf16=use_bf16, approx=approx,
            prune_segments=prune_segments, rerank_factor=rerank_factor,
            num_valid=num_valid,
        )

    def prepare_tile_cache(self, codes, norms=None):
        """Order-preserving PackedCorpus for the packed scan (base
        contract)."""
        return prepare_packed(self.plan, self.params, jnp.asarray(codes),
                              norms=norms)

    def packed_scan_raw(self, queries, packed, k, metric, num_valid=None,
                        use_bf16=True, tile_mask=None, mask_cap=None):
        return _packed_scan(
            self.plan, self.params, queries, packed, k, metric,
            num_valid=num_valid, use_bf16=use_bf16, tile_mask=tile_mask,
            mask_cap=mask_cap,
        )

    def residual_scorer(self):
        """Code-space window scorer for IVF list scans (base contract):
        v·decode(ct) = q_map(v)_cat·ô + v·pca_mean, ‖decode(ct)‖² =
        ‖mean‖² + 2·mean_cat·ô + ‖ô‖² (orthogonal rotations) — windows
        need only the per-segment dequant, not the seg/PCA un-rotations
        decode_fn pays per window."""
        plan, params = self.plan, self.params
        seg_ids = tuple(range(plan.num_segments))
        mean_p = jnp.dot(params.pca_mean, params.pca_rot,
                         precision=jax.lax.Precision.HIGHEST)
        mean_cat = jnp.concatenate([
            jnp.dot(mean_p[plan.seg_starts[s] : plan.seg_starts[s]
                           + plan.seg_lens[s]], params.seg_rots[s],
                    precision=jax.lax.Precision.HIGHEST)
            for s in seg_ids
        ])
        mean_sq = jnp.sum(params.pca_mean ** 2)

        def q_map(v):
            q_cat, _mc, q_mean, _ms = _packed_query_side(
                plan, params, jnp.asarray(v, jnp.float32), seg_ids
            )
            return q_cat, q_mean

        def window(ct):
            parts = _split_row(plan, ct)
            o_parts = []
            for s, (packed_b, rescale, _nrm) in enumerate(parts):
                idx = unpack_bits(packed_b, plan.seg_bits[s],
                                  plan.seg_lens[s])
                o_parts.append(_seg_dequant(plan, params, s, idx, rescale))
            o = (jnp.concatenate(o_parts, axis=1) if len(o_parts) > 1
                 else o_parts[0])
            r2 = mean_sq + 2.0 * jnp.dot(
                o, mean_cat, precision=jax.lax.Precision.HIGHEST
            ) + jnp.sum(o * o, axis=1)
            return o, r2

        return q_map, window

    def code_bytes_per_vector(self) -> float:
        return float(self.plan.code_bytes)

    def config_dict(self):
        return {
            "bpd": self.cfg.bits_per_dim,
            "allocator": self.cfg.allocator,
            "use_pca": self.cfg.use_pca,
            "codebook": self.cfg.codebook,
            "segments": [
                {"start": s, "len": l, "bits": b}
                for s, l, b in zip(
                    self.plan.seg_starts, self.plan.seg_lens, self.plan.seg_bits
                )
            ]
            if self.plan
            else None,
        }

    def save(self, path: str) -> None:
        import pickle, os

        host = jax.tree_util.tree_map(np.asarray, self.params)
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        with open(path, "wb") as f:
            pickle.dump(
                {"name": self.name, "dim": self._dim, "plan": self.plan,
                 "params": host, "config": self.config_dict()},
                f,
            )

    def load(self, path: str) -> "SAQ":
        import pickle

        with open(path, "rb") as f:
            payload = pickle.load(f)
        self._dim = payload["dim"]
        self.plan = payload["plan"]
        self.params = jax.tree_util.tree_map(jnp.asarray, payload["params"])
        return self
