"""Scan over bit-packed per-dimension codes (SAQ, RankAware, RaBitQ).

The segmented scalar quantizers store B-bit per-dimension indices plus
per-row float factors.  Their byte rows are self-contained (the
reference-compatible row format); this module holds the derived scan
layout, `PackedCorpus`, and the one scan over it, `packed_scan_topk`,
written in plain jnp/lax so XLA compiles it for any backend.  It is the
analog of the reference's packed fastscan over short/long codes
(external/saq/include/saq/fast_scan.h:73-110, code_helper.h).

Word layout ("tile-ordered bitplane words", built by pack_words): a
segment's (N, ln) B-bit indices become (N/u, ln) int32 words with
u = 32 // b_eff (b_eff = B rounded up to a power of two); within each
512-row tile, word r shift-slot j packs tile-local row j·(512/u) + r, so
shift-plane j of a tile is the contiguous row block [j·512/u, (j+1)·512/u)
and unpacking is a shift/mask per plane followed by a reshape.

Dequantization kinds per segment:
  "uniform" — mid-rise grid (c+.5)·δ−1 (kernels/caq.py _dequant_unit)
  "perdim"  — per-dim sorted level tables (SAQ derived codebooks, RankAware)
  "shared"  — one level table for all dims (RaBitQ Gaussian codebook)
  "values"  — a precomputed f32 VALUE PLANE: the builder dequantizes
              (without the per-row scale) at pack time and the segment's
              "words" array is the (N, ln) f32 values themselves.  Builders
              use it for B ≥ 5 derived-codebook segments; the stored byte
              rows stay at B bits/dim, only the derived PackedCorpus grows.
Per-row factors (rescale, norms, RaBitQ α) ride in an (N, F) f32 side array.

Score assembly: every family's maximize-form score is an affine map of one
matmul, with the row-side constants precomputed into factor columns at pack
time (methods/*.prepare_packed):

    L2:  s = 2·ip + qa − Σ_{c ∈ r2_cols} fac[:, c]
    IP:  s = ip + qa
    NIP: s = (ip + qa) / fac[:, norm_col]

with per-row multiplicative scales (SAQ rescale, RaBitQ's estimator
α = ‖r‖√D/(t‖ŝ‖²)) folded into the dequantized values via each segment's
scale_col.  Both families emit the same maximize-form contract as
kernels/adc.py, so _finalize and the recall paths are shared.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp

from vq_tpu.kernels.adc import _streaming_topk

_TILE = 512  # rows per packed tile: the word layout and tile_mask granularity
_CHUNK_TILES = 32  # tiles scored per streaming top-k step (16384 rows)


def _b_eff(bits: int) -> int:
    """Storage width: bits rounded up to a power of two ≤ 16."""
    for p in (1, 2, 4, 8, 16):
        if bits <= p:
            return p
    raise ValueError(f"bits={bits} too large")


class SegSpec(NamedTuple):
    """Static per-segment layout (hashable, a static jit argument).

    bits      true code width B
    beff      storage width (power of two); u = 32 // beff rows per word
    ln        segment length in dims (= width of its words array)
    dequant   "uniform" | "perdim" | "shared" | "values"
    scale_col column of the factors array holding the per-row scale
              multiplier (−1 = no scale)
    """

    bits: int
    beff: int
    ln: int
    dequant: str
    scale_col: int

    @property
    def u(self) -> int:
        return 32 // self.beff


def make_segspec(bits: int, ln: int, dequant: str, scale_col: int) -> SegSpec:
    if dequant == "values":
        # value-plane segment: the words array is (N, ln) f32 values
        # (u = 1, no bit packing)
        return SegSpec(bits, 32, ln, "values", scale_col)
    return SegSpec(bits, _b_eff(bits), ln, dequant, scale_col)


@jax.tree_util.register_pytree_node_class
class PackedCorpus:
    """Scan layout: per-segment tile-ordered words + per-row factors.

    The analog of the reference's ClusterPacker fastscan layout
    (external/saq/include/saq/cluster_packer.h:21-80): the stored row
    format stays the reference-compatible byte rows; this derived layout is
    built once per index so the hot scan never re-parses byte rows.  Rows
    keep the caller's order and are padded to a 512 multiple; `num_rows`
    masks the tail.  words[s] has shape (N_pad/u_s, ln_s).

    Registered as a pytree with (num_rows, has_norms) as STATIC aux data so
    a PackedCorpus can cross jit boundaries as an argument while python
    control flow on those fields keeps working.  has_norms records whether
    REAL original row norms were baked into the norm factors column —
    Metric.NIP must refuse a cache built without them.
    """

    def __init__(self, words, factors, num_rows, has_norms=False):
        self.words = tuple(words)
        self.factors = factors
        self.num_rows = num_rows
        self.has_norms = has_norms

    def tree_flatten(self):
        return (self.words, self.factors), (self.num_rows, self.has_norms)

    @classmethod
    def tree_unflatten(cls, aux, children):
        words, factors = children
        num_rows, has_norms = aux
        return cls(words, factors, num_rows, has_norms=has_norms)


@functools.partial(jax.jit, static_argnames=("bits", "beff", "tile"))
def pack_words(
    idx: jax.Array, bits: int, beff: Optional[int] = None, tile: int = _TILE,
) -> jax.Array:
    """(N, ln) indices in [0, 2^bits) → (N/u, ln) tile-ordered int32 words
    (u = 32 // beff rows per word; N % tile == 0).  Within each tile-row
    block, word r shift-slot j holds tile-local row j·(tile/u) + r, which
    is the layout _unpack_words reads back."""
    n, ln = idx.shape
    if beff is None:
        beff = _b_eff(bits)
    u = 32 // beff
    assert n % tile == 0 and tile % u == 0, (n, tile, u)
    rt = tile // u
    # (tiles, u, rt, ln): plane j is the row block [j·rt, (j+1)·rt)
    planes = idx.astype(jnp.uint32).reshape(n // tile, u, rt, ln)
    shifts = (beff * jnp.arange(u, dtype=jnp.uint32))[None, :, None, None]
    words = jax.lax.reduce(
        planes << shifts, jnp.uint32(0), jax.lax.bitwise_or, (1,)
    )
    return words.reshape(n // u, ln).astype(jnp.int32)


def _unpack_words(words: jax.Array, seg: SegSpec, tile: int = _TILE) -> jax.Array:
    """(R/u, ln) tile-ordered int32 words (R % tile == 0) → (R, ln) int32
    indices in natural row order."""
    u = seg.u
    rt = tile // u
    nt = words.shape[0] // rt
    uw = words.astype(jnp.uint32).reshape(nt, 1, rt, seg.ln)
    shifts = (seg.beff * jnp.arange(u, dtype=jnp.uint32))[None, :, None, None]
    idx = (uw >> shifts) & jnp.uint32((1 << seg.bits) - 1)
    return idx.reshape(nt * tile, seg.ln).astype(jnp.int32)


def _dequant_seg(words: jax.Array, seg: SegSpec, lv) -> jax.Array:
    """One segment's (R/u, ln) words → (R, ln) f32 values, before the
    per-row scale."""
    if seg.dequant == "values":
        return words.astype(jnp.float32)
    idx = _unpack_words(words, seg)
    if seg.dequant == "uniform":
        delta = 2.0 / (1 << seg.bits)
        return (idx.astype(jnp.float32) + 0.5) * delta - 1.0
    if seg.dequant == "shared":  # (1, L) table
        return jnp.take(lv.reshape(-1).astype(jnp.float32), idx)
    # perdim: (ln, L) table; flat index d·L + code
    n_lv = lv.shape[1]
    flat = idx + (n_lv * jnp.arange(seg.ln, dtype=jnp.int32))[None, :]
    return jnp.take(lv.reshape(-1).astype(jnp.float32), flat)


@functools.partial(
    jax.jit,
    static_argnames=(
        "segs", "k", "metric_kind", "norm_col", "r2_cols", "use_bf16",
        "mask_cap",
    ),
)
def packed_scan_topk(
    q_cat: jax.Array,
    qa: jax.Array,
    words: Tuple[jax.Array, ...],
    factors: jax.Array,
    lv_tables: Tuple[jax.Array, ...],
    segs: Tuple[SegSpec, ...],
    k: int,
    metric_kind: str = "l2",
    norm_col: int = -1,
    r2_cols: Tuple[int, ...] = (),
    limit: Optional[jax.Array] = None,
    use_bf16: bool = True,
    tile_mask: Optional[jax.Array] = None,
    mask_cap: Optional[int] = None,
):
    """Unpack + dequant + score + top-k → ((Q, k) maximize-form, (Q, k) i32
    row positions).

    q_cat   (Q, D) queries pre-rotated into code space (D = Σ ln_s)
    qa      (Q,) per-query additive term (mean/centroid ip, const folded)
    words   per-segment (N/u_s, ln_s) int32 — N % 512 == 0 (pad rows
            masked via `limit`), tile-ordered (pack_words)
    factors (N, F) f32 per-row factors: per-segment scales (scale_col),
            precomputed L2 row shifts (r2_cols — summed and subtracted
            from 2·ip for metric "l2"), original row norm (norm_col, NIP)
    lv_tables — one per "perdim"/"shared" segment, in segment order:
              (ln_s, 2^B) for "perdim", (1, 2^B) for "shared"
    limit   — rows with position ≥ limit score −inf (traced scalar ok)
    tile_mask — optional (N/512,) i32: only tiles with a nonzero mask are
              scored (the IVF probed-tile restriction, index/ivf_packed.py).
              The masked-in tile ids are compacted in ascending order and
              gathered chunk by chunk, so masked-out tiles are never read.
              The result equals a scan of the masked-in rows alone.
    mask_cap — optional STATIC cap on the compacted tile count: when the
              masked-in count fits, only mask_cap tiles are walked; when it
              overflows, the full tile set is walked (lax.cond) — exact
              either way.

    Ties in score go to the lowest row position.
    """
    n = factors.shape[0]
    nb = n // _TILE
    assert n % _TILE == 0 and 0 < k <= _TILE, (n, k)
    for w, seg in zip(words, segs):
        assert w.shape == (n // seg.u, seg.ln), (w.shape, seg)
    if metric_kind == "l2":
        assert r2_cols and all(0 <= c < factors.shape[1] for c in r2_cols)
    lim = jnp.asarray(n if limit is None else limit, jnp.int32)
    mm_dt = jnp.bfloat16 if use_bf16 else jnp.float32
    q = q_cat.astype(mm_dt)
    qa = qa.astype(jnp.float32)[:, None]
    num_q = q.shape[0]
    # tile-major views: a gathered tile id fetches one contiguous block
    words_t = tuple(
        w.reshape(nb, _TILE // seg.u, seg.ln) for w, seg in zip(words, segs)
    )
    fac_t = factors.astype(jnp.float32).reshape(nb, _TILE, -1)
    lv_iter = iter(lv_tables)
    lvs = tuple(
        next(lv_iter) if seg.dequant in ("perdim", "shared") else None
        for seg in segs
    )

    def scan(tile_ids: jax.Array, cnt) -> Tuple[jax.Array, jax.Array]:
        """Top-k over the tiles tile_ids[:cnt] (ids ascending)."""
        n_slots = tile_ids.shape[0]
        tpc = min(_CHUNK_TILES, n_slots)
        pad = (-n_slots) % tpc
        ids = jnp.pad(tile_ids, (0, pad), mode="edge")
        slot_ok = jnp.arange(n_slots + pad) < cnt

        def score_chunk(start):
            s0 = start // _TILE
            tid = jax.lax.dynamic_slice_in_dim(ids, s0, tpc)
            ok = jax.lax.dynamic_slice_in_dim(slot_ok, s0, tpc)
            fac = jnp.take(fac_t, tid, axis=0).reshape(tpc * _TILE, -1)
            parts = []
            for w, seg, lv in zip(words_t, segs, lvs):
                wc = jnp.take(w, tid, axis=0).reshape(-1, seg.ln)
                val = _dequant_seg(wc, seg, lv)
                if seg.scale_col >= 0:
                    val = val * fac[:, seg.scale_col][:, None]
                parts.append(val)
            ohat = jnp.concatenate(parts, axis=1) if len(parts) > 1 else parts[0]
            ip = jax.lax.dot_general(
                q, ohat.astype(mm_dt), (((1,), (1,)), ((), ())),
                precision=(None if use_bf16 else jax.lax.Precision.HIGHEST),
                preferred_element_type=jnp.float32,
            )  # (Q, rows)
            if metric_kind == "l2":
                shift = sum(fac[:, c] for c in r2_cols)
                s = 2.0 * ip + qa - shift[None, :]
            elif metric_kind == "ip":
                s = ip + qa
            else:  # nip
                s = (ip + qa) / jnp.maximum(fac[:, norm_col], 1e-30)[None, :]
            pos = (tid[:, None] * _TILE + jnp.arange(_TILE)[None, :]).reshape(-1)
            valid = jnp.repeat(ok, _TILE) & (pos < lim)
            return jnp.where(valid[None, :], s, -jnp.inf)

        s, slot_row = _streaming_topk(
            score_chunk, (n_slots + pad) * _TILE, num_q, k, tpc * _TILE
        )
        pos = jnp.take(ids, slot_row // _TILE) * _TILE + slot_row % _TILE
        return s, pos.astype(jnp.int32)

    if tile_mask is None:
        return scan(jnp.arange(nb, dtype=jnp.int32), nb)
    assert tile_mask.shape == (nb,), (tile_mask.shape, nb)
    maskb = tile_mask > 0
    cnt = jnp.sum(maskb.astype(jnp.int32))
    # masked-in tile ids first, in ascending order (stable sort)
    order = jnp.argsort(jnp.logical_not(maskb), stable=True).astype(jnp.int32)
    if mask_cap is not None and 0 < mask_cap < nb:
        return jax.lax.cond(
            cnt <= mask_cap,
            lambda: scan(order[:mask_cap], cnt),
            lambda: scan(order, cnt),
        )
    return scan(order, cnt)
