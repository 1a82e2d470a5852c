"""CAQ encoder — batched.

Re-design of the SAQ engine's CAQEncoder
(external/saq/include/saq/caq_encoder.h:58-220):

  * per-vector symmetric range v_mx = max|o_i|, mid-rise uniform code
    ô_j = (c_j + 0.5)·δ − v_mx with δ = 2·v_mx / 2^b  (caq_encoder.h:170-205)
  * code adjustment maximizing cos(o, ô) by ±1 coordinate steps
    (caq_encoder.h:67-140) — the reference is sequential Gauss-Seidel per
    vector; here it is a BATCHED JACOBI sweep (SURVEY.md §7.3): each round
    evaluates the ±1 improvement test for all N vectors × all D coordinates
    at once on the VPU, applies only individually-improving moves, then
    recomputes the global ⟨o,ô⟩ / ‖ô‖² exactly (the reference does the same
    per-round correction, caq_encoder.h:123-138).  The GPU build of the
    reference ships the same parallel variant behind `caq_sequential=false`
    (gpu_encoder.cuh:27).
  * factors: o_l2norm and fac_rescale = ‖o‖²/⟨o,ô⟩ (caq_encoder.h:220-232);
    v_mx is normalized to 1 by folding it into the rescale factor
    (the engine's rescale_vmx_to1), so δ is the static 2/2^b and only TWO
    floats per (vector, segment) are stored — the reference's 64-bit
    per-segment factor overhead (quantization_plan.h:166).
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp


_CONST_EPSILON = 1.9  # reference caq_encoder.h:59 kConstEpsilon


class CAQCode(NamedTuple):
    codes: jax.Array  # (N, D) int32 in [0, 2^b)
    rescale: jax.Array  # (N,) — multiply dequantized unit-grid ô to estimate o
    o_l2norm: jax.Array  # (N,) — ‖o‖ (error-bound factor, kept for parity)
    # ε-bound on the IP estimation error (reference caq_encoder.h:220-232):
    # fac_error = ‖o‖²·ε·sqrt((‖o‖²‖ô‖²/⟨o,ô⟩² − 1)/(D−1)), giving
    # |⟨q,o⟩ − rescale·⟨q,ô⟩| ≤ fac_error·‖q‖/‖o‖.  The byte-row format
    # stores only (rescale, o_l2norm) — 2 floats/segment, the engine's
    # layout.  This field is the encoder-side value, used by tests to
    # validate the bound.
    fac_error: jax.Array  # (N,)


def _dequant_unit(codes: jax.Array, bits: int) -> jax.Array:
    """Mid-rise dequantization on the v_mx=1 grid: (c + .5)·δ − 1, δ=2/2^b."""
    delta = 2.0 / (1 << bits)
    return (codes.astype(jnp.float32) + 0.5) * delta - 1.0


def _adjust_round(o, codes, bits, ip, l2):
    """One Jacobi adjustment round.  o: (N, D) normalized by v_mx."""
    delta = 2.0 / (1 << bits)
    cmax = (1 << bits) - 1
    oa = _dequant_unit(codes, bits)  # (N, D)
    l2_wo = l2[:, None] - oa * oa  # ‖ô‖² without coord j

    def gain(step):
        new_oa = oa + step * delta
        new_ip = ip[:, None] + step * delta * o
        new_l2 = l2_wo + new_oa * new_oa
        # improvement test: new_ip²/new_l2 > ip²/l2  (cosine², caq_encoder.h:90)
        return new_ip * new_ip * l2[:, None] - ip[:, None] * ip[:, None] * new_l2, new_ip, new_l2

    g_up, _, _ = gain(1.0)
    g_dn, _, _ = gain(-1.0)
    can_up = (codes < cmax) & (g_up > 0)
    can_dn = (codes > 0) & (g_dn > 0)
    step = jnp.where(can_up & (g_up >= g_dn), 1, jnp.where(can_dn, -1, 0))
    new_codes = jnp.clip(codes + step, 0, cmax)
    # exact recompute of global factors (the reference's per-round correction)
    oa = _dequant_unit(new_codes, bits)
    new_ip = jnp.sum(o * oa, axis=1)
    new_l2 = jnp.sum(oa * oa, axis=1)
    # a Jacobi round with interacting moves can overshoot: keep it only if
    # the true cosine improved, else keep previous codes
    better = new_ip * new_ip * l2 > ip * ip * new_l2
    codes = jnp.where(better[:, None], new_codes, codes)
    ip = jnp.where(better, new_ip, ip)
    l2 = jnp.where(better, new_l2, l2)
    return codes, ip, l2


@functools.partial(jax.jit, static_argnames=("bits", "rounds"))
def caq_encode(o: jax.Array, bits: int, rounds: int = 6) -> CAQCode:
    """Encode (N, D) vectors at `bits` per dim with CAQ code adjustment.

    Returns codes plus the two per-vector factors.  Reconstruction:
    ô = rescale · ((codes + .5)·2/2^b − 1).
    """
    o = jnp.asarray(o, dtype=jnp.float32)
    n, d = o.shape
    v_mx = jnp.max(jnp.abs(o), axis=1)  # (N,)
    v_safe = jnp.maximum(v_mx, 1e-20)
    ou = o / v_safe[:, None]  # normalized to [-1, 1]

    delta = 2.0 / (1 << bits)
    cmax = (1 << bits) - 1
    codes = jnp.clip(jnp.floor((ou + 1.0) / delta), 0, cmax).astype(jnp.int32)

    oa = _dequant_unit(codes, bits)
    ip = jnp.sum(ou * oa, axis=1)
    l2 = jnp.sum(oa * oa, axis=1)

    def body(_, carry):
        return _adjust_round(ou, carry[0], bits, carry[1], carry[2])

    codes, ip, l2 = jax.lax.fori_loop(0, rounds, body, (codes, ip, l2))

    o_l2sqr = jnp.sum(ou * ou, axis=1)
    # fac_rescale = ‖o‖²/⟨o,ô⟩ on the unit grid; multiply back v_mx to undo
    # the normalization (rescale_vmx_to1)
    rescale_unit = jnp.where(ip != 0, o_l2sqr / ip, 0.0)
    rescale = rescale_unit * v_safe
    o_l2norm = jnp.linalg.norm(o, axis=1)
    # ε error bound (caq_encoder.h:220-232) — scale-invariant inner term
    # (cos⁻² − 1), so the unit-grid ip/l2 work directly; the leading ‖o‖²
    # uses the true (unnormalized) norm.
    cos_term = jnp.where(
        ip * ip > 0, (o_l2sqr * l2) / jnp.maximum(ip * ip, 1e-38) - 1.0, 0.0
    )
    fac_error = (
        o_l2norm**2
        * _CONST_EPSILON
        * jnp.sqrt(jnp.maximum(cos_term, 0.0) / max(d - 1, 1))
    )
    return CAQCode(
        codes=codes, rescale=rescale, o_l2norm=o_l2norm, fac_error=fac_error
    )


def caq_decode(codes: jax.Array, rescale: jax.Array, bits: int) -> jax.Array:
    """(N, D) codes + (N,) rescale → (N, D) reconstruction of o."""
    return _dequant_unit(codes, bits) * rescale[:, None]


# ---------------------------------------------------------------------------
# derived-codebook variant: per-dim non-uniform levels instead of the
# mid-rise grid (the engine's derive_codebooks path, ivf_index.cpp:55-117 +
# codebook_builder.cpp — Lloyd or exact-DP levels per dimension)
# ---------------------------------------------------------------------------


def _dequant_levels(codes: jax.Array, levels: jax.Array) -> jax.Array:
    """(N, D) codes + (D, L) sorted level tables → (N, D) values."""
    return jax.vmap(lambda lv, c: lv[c], in_axes=(0, 1), out_axes=1)(
        levels, codes
    )


def _adjust_round_levels(o, codes, levels, ip, l2, cmax):
    """One Jacobi adjustment round over per-dim level tables: each coord may
    move to the adjacent level (±1 index) when that individually improves
    cos²(o, ô); the same overshoot guard as the uniform variant keeps the
    round only if the true cosine improved."""
    oa = _dequant_levels(codes, levels)  # (N, D)
    l2_wo = l2[:, None] - oa * oa
    ip_wo = ip[:, None] - o * oa

    def gain(step):
        c_new = jnp.clip(codes + step, 0, cmax)
        v_new = _dequant_levels(c_new, levels)
        new_ip = ip_wo + o * v_new
        new_l2 = l2_wo + v_new * v_new
        return new_ip * new_ip * l2[:, None] - ip[:, None] * ip[:, None] * new_l2

    g_up = gain(1)
    g_dn = gain(-1)
    can_up = (codes < cmax) & (g_up > 0)
    can_dn = (codes > 0) & (g_dn > 0)
    step = jnp.where(can_up & (g_up >= g_dn), 1, jnp.where(can_dn, -1, 0))
    new_codes = jnp.clip(codes + step, 0, cmax)
    oa = _dequant_levels(new_codes, levels)
    new_ip = jnp.sum(o * oa, axis=1)
    new_l2 = jnp.sum(oa * oa, axis=1)
    better = new_ip * new_ip * l2 > ip * ip * new_l2
    codes = jnp.where(better[:, None], new_codes, codes)
    ip = jnp.where(better, new_ip, ip)
    l2 = jnp.where(better, new_l2, l2)
    return codes, ip, l2


@functools.partial(jax.jit, static_argnames=("rounds",))
def caq_encode_levels(o: jax.Array, levels: jax.Array, rounds: int = 6) -> CAQCode:
    """CAQ encode against per-dim sorted level tables (D, L).

    Initial code = nearest level per dim; adjustment rounds move ±1 level
    index maximizing cos(o, ô); rescale = ‖o‖²/⟨o,ô⟩ exactly as the uniform
    variant (reference caq_encoder.h:220-232 applies the same factors to the
    codebook encoder, gpu_encoder.cuh launch_fused_codebook_encode).
    """
    o = jnp.asarray(o, dtype=jnp.float32)
    n, d = o.shape
    lmax = levels.shape[1]
    cmax = lmax - 1
    # nearest sorted level: index by midpoint comparison (L−1 thresholds)
    mids = 0.5 * (levels[:, 1:] + levels[:, :-1])  # (D, L-1)
    codes = jnp.sum(
        o[:, :, None] >= mids[None, :, :], axis=-1, dtype=jnp.int32
    )  # (N, D) in [0, L)

    oa = _dequant_levels(codes, levels)
    ip = jnp.sum(o * oa, axis=1)
    l2 = jnp.sum(oa * oa, axis=1)

    def body(_, carry):
        return _adjust_round_levels(o, carry[0], levels, carry[1], carry[2], cmax)

    codes, ip, l2 = jax.lax.fori_loop(0, rounds, body, (codes, ip, l2))

    o_l2sqr = jnp.sum(o * o, axis=1)
    rescale = jnp.where(ip != 0, o_l2sqr / ip, 0.0)
    o_l2norm = jnp.sqrt(o_l2sqr)
    cos_term = jnp.where(
        ip * ip > 0, (o_l2sqr * l2) / jnp.maximum(ip * ip, 1e-38) - 1.0, 0.0
    )
    fac_error = (
        o_l2sqr * _CONST_EPSILON
        * jnp.sqrt(jnp.maximum(cos_term, 0.0) / max(d - 1, 1))
    )
    return CAQCode(
        codes=codes, rescale=rescale, o_l2norm=o_l2norm, fac_error=fac_error
    )


def caq_decode_levels(
    codes: jax.Array, rescale: jax.Array, levels: jax.Array
) -> jax.Array:
    """(N, D) codes + (N,) rescale + (D, L) levels → (N, D) estimate of o."""
    return _dequant_levels(codes, levels) * rescale[:, None]


def caq_cosine(o: jax.Array, codes: jax.Array, bits: int) -> jax.Array:
    """cos(o, ô) per vector — the quantity code adjustment maximizes."""
    oa = _dequant_unit(codes, bits)
    ip = jnp.sum(o * oa, axis=1)
    return ip / jnp.maximum(
        jnp.linalg.norm(o, axis=1) * jnp.linalg.norm(oa, axis=1), 1e-20
    )
