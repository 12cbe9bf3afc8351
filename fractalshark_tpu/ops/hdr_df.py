"""HDR double-float ("HDRx2x32"): HDR exponent over a 2x32 mantissa.

Counterpart of the reference's ``HDRFloat<CudaDblflt>``
renderer family (``HpSharkFloatLib/HDRFloat.h:84`` instantiated over
``CudaDblflt.h``; kernels ``GPU_Render.cu`` HDRx2x32 variants): each
complex value carries double-float (hi, lo) f32 mantissa pairs
(~48 bits, ops/dblflt.py) plus ONE shared int32 exponent, for deep
zooms where f32's 24-bit mantissa glitches but f64 throughput is poor.

Exponent handling mirrors ops/hdrfloat.py exactly (lazy HdrReduce,
EXPONENT_DIFF_IGNORED drops, zero sentinel MIN_BIG_EXPONENT); all
mantissa scalings are exact powers of two, so the DF invariant
|lo| ≤ ulp(hi)/2 survives every alignment.

Includes the perturbation render for the Gpu2x32Perturbed* /
GpuHDRx2x32Perturbed* algorithm families (delta loop semantics
identical to ops/perturb.py: Zhuoran rebasing, counter liveness).
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from fractalshark_tpu.core.highprecision import HighPrecision
from fractalshark_tpu.core.pointzoom import PointZoomBBConverter
from fractalshark_tpu.ops import hdrfloat as hdr
from fractalshark_tpu.ops.dblflt import (DF, df_add, df_from_hp, df_mul,
                                         df_sub, two_prod)
from fractalshark_tpu.ops.hdrfloat import (EXPONENT_DIFF_IGNORED,
                                           MIN_BIG_EXPONENT, HDR, pow2i)

_INNER_STEPS = 8


class HDC2(NamedTuple):
    """Complex HDR with double-float mantissas and a shared exponent."""
    re: DF
    im: DF
    e: jax.Array


def zero(shape) -> HDC2:
    z = jnp.zeros(shape, jnp.float32)
    return HDC2(DF(z, z), DF(z, z),
                jnp.full(shape, MIN_BIG_EXPONENT, jnp.int32))


def _scale(v: DF, s) -> DF:
    """Multiply a DF by an exact power of two (exactness-preserving)."""
    return DF(v.hi * s, v.lo * s)


def add(a: HDC2, b: HDC2) -> HDC2:
    """Shared-exponent complex add (HDRFloatComplex::plus semantics:
    smaller operand scaled down, gaps > ignore threshold vanish)."""
    a_big = a.e >= b.e
    e = jnp.where(a_big, a.e, b.e)
    diff = jnp.minimum(e - jnp.where(a_big, b.e, a.e),
                       EXPONENT_DIFF_IGNORED + 6)
    s = pow2i(-diff, jnp.float32)

    def pick(big, small):
        return DF(jnp.where(a_big, big.hi, small.hi),
                  jnp.where(a_big, big.lo, small.lo))

    are = pick(a.re, b.re)
    aim = pick(a.im, b.im)
    bre = pick(b.re, a.re)
    bim = pick(b.im, a.im)
    return HDC2(df_add(are, _scale(bre, s)),
                df_add(aim, _scale(bim, s)), e)


def mul(a: HDC2, b: HDC2) -> HDC2:
    return HDC2(df_sub(df_mul(a.re, b.re), df_mul(a.im, b.im)),
                df_add(df_mul(a.re, b.im), df_mul(a.im, b.re)),
                a.e + b.e)


def mul_pow2(a: HDC2, k: int) -> HDC2:
    return HDC2(a.re, a.im, a.e + k)


def reduce(a: HDC2) -> HDC2:
    """HdrReduce by the Chebyshev-largest hi component; the pow2 scale
    is exact on both DF halves."""
    big = jnp.maximum(jnp.abs(a.re.hi), jnp.abs(a.im.hi))
    _, fe = hdr._frexp2(big)
    is_zero = big == 0
    fe = jnp.where(is_zero, jnp.int32(0), fe)
    s = pow2i(-fe, jnp.float32)
    return HDC2(_scale(a.re, s), _scale(a.im, s),
                jnp.where(is_zero, MIN_BIG_EXPONENT, a.e + fe))


def norm_squared_hi(a: HDC2) -> HDR:
    """|z|² as a plain-f32-mantissa HDR (hi parts only — compares in
    the escape/rebase tests don't need the low halves, exactly like
    the reference's HdrReduce-then-compare on the sub type)."""
    return HDR(a.re.hi * a.re.hi + a.im.hi * a.im.hi, a.e + a.e)


# ------------------------------------------------------------ dc grids


def _hp_to_df_exp(hp: HighPrecision):
    """(hi, lo, exp2) with hp == (hi + lo)·2^exp2, hi/lo f32."""
    m, e = hp.mantissa_exp2()
    hi = np.float32(m)
    lo = np.float32(m - float(hi))
    return float(hi), float(lo), int(e)


def _dc_grids_hdrdf(dx, dy, cx_off, cy_off, width, height) -> HDC2:
    """dc = (x·dx − centerX, −y·dy − centerY) as an HDC2 grid, ~48-bit
    mantissas at any zoom depth (mirrors perturb._dc_grids_hdr)."""
    shape = (height, width)

    def bc(v, axis):
        a = v[None, :] if axis else v[:, None]
        return jnp.broadcast_to(a, shape)

    def term(step_hp, count, axis):
        # per-pixel product idx·(hi+lo): idx ≤ 2^13 is exact in f32, so
        # two_prod(idx, hi) is error-free and idx·lo lands in the low
        # word — full ~48-bit accuracy per pixel
        hi, lo, e = _hp_to_df_exp(step_hp)
        idx = bc(jnp.arange(count, dtype=jnp.float32), axis)
        p_hi, p_err = two_prod(idx, jnp.full(shape, hi, jnp.float32))
        p_lo = p_err + idx * np.float32(lo)
        return HDC2(DF(p_hi, p_lo), DF(jnp.zeros(shape, jnp.float32),
                                       jnp.zeros(shape, jnp.float32)),
                    jnp.full(shape, e, jnp.int32))

    def const(c_hp):
        hi, lo, e = _hp_to_df_exp(c_hp)
        return HDC2(DF(jnp.full(shape, hi, jnp.float32),
                       jnp.full(shape, lo, jnp.float32)),
                    DF(jnp.zeros(shape, jnp.float32),
                       jnp.zeros(shape, jnp.float32)),
                    jnp.full(shape, e, jnp.int32))

    def neg(z: HDC2) -> HDC2:
        return HDC2(DF(-z.re.hi, -z.re.lo), z.im, z.e)

    x_dx = reduce(term(dx, width, axis=True))
    y_dy = reduce(term(dy, height, axis=False))
    cx = const(cx_off)
    cy = const(cy_off)
    dcx = reduce(add(x_dx, neg(cx)))          # x·dx − centerX
    dcy = reduce(add(neg(y_dy), neg(cy)))     # −y·dy − centerY
    # join into one complex: re from dcx, im from dcy
    e = jnp.maximum(dcx.e, dcy.e)
    sx = pow2i(-jnp.minimum(e - dcx.e, EXPONENT_DIFF_IGNORED + 6),
               jnp.float32)
    sy = pow2i(-jnp.minimum(e - dcy.e, EXPONENT_DIFF_IGNORED + 6),
               jnp.float32)
    return HDC2(_scale(dcx.re, sx), _scale(dcy.re, sy), e)


# ------------------------------------------------------- perturb kernel


@functools.partial(jax.jit, static_argnames=("max_iter",))
def _perturb_hdrdf_impl(ox_hi, ox_lo, oy_hi, oy_lo,
                        dc_rh, dc_rl, dc_ih, dc_il, dc_e,
                        max_iter, max_ref):
    """Perturbation loop with HDR-DF deltas (reference HDRx2x32
    perturbed kernels; loop semantics = ops/perturb._perturb_hdr_impl:
    dz ← (2Z+dz)·dz + dc, escape at 256, Zhuoran rebase)."""
    shape = dc_rh.shape
    n = jnp.int32(max_iter)
    dc = HDC2(DF(dc_rh, dc_rl), DF(dc_ih, dc_il), dc_e)
    two56 = HDR(jnp.full(shape, 1.0, jnp.float32),
                jnp.full(shape, 8, jnp.int32))

    def orbit_at(j):
        return HDC2(DF(ox_hi[j], ox_lo[j]), DF(oy_hi[j], oy_lo[j]),
                    jnp.zeros(shape, jnp.int32))

    def step(_, s):
        k, rh, rl, ih, il, dze, j, it = s
        live = (it == k) & (k < n)
        dz = HDC2(DF(rh, rl), DF(ih, il), dze)
        zj = orbit_at(j)
        t = add(mul_pow2(zj, 1), dz)
        ndz = reduce(add(mul(t, dz), dc))
        j1 = j + 1
        zf = reduce(add(orbit_at(j1), ndz))
        nsq = hdr.reduce(norm_squared_hi(zf))
        dsq = hdr.reduce(norm_squared_hi(ndz))
        esc = hdr.gt_reduced(nsq, two56)
        reb = hdr.lt_reduced(nsq, dsq) | (j1 >= max_ref)
        upd = live & ~esc

        def sel(new_reb, new_nrm, old):
            return jnp.where(upd, jnp.where(reb, new_reb, new_nrm), old)

        rh = sel(zf.re.hi, ndz.re.hi, rh)
        rl = sel(zf.re.lo, ndz.re.lo, rl)
        ih = sel(zf.im.hi, ndz.im.hi, ih)
        il = sel(zf.im.lo, ndz.im.lo, il)
        dze = sel(zf.e, ndz.e, dze)
        j = jnp.where(upd, jnp.where(reb, 0, j1), j)
        it = it + upd.astype(jnp.int32)
        return k + 1, rh, rl, ih, il, dze, j, it

    def cond(s):
        k, it = s[0], s[7]
        return jnp.logical_and(k < n,
                               jnp.max((it == k).astype(jnp.int32)) > 0)

    def chunk(s):
        return jax.lax.fori_loop(jnp.int32(0), jnp.int32(_INNER_STEPS),
                                 step, s)

    z0 = zero(shape)
    init = (jnp.int32(0), z0.re.hi, z0.re.lo, z0.im.hi, z0.im.lo, z0.e,
            jnp.zeros(shape, jnp.int32), jnp.zeros(shape, jnp.int32))
    out = jax.lax.while_loop(cond, chunk, init)
    return out[7].astype(jnp.uint32)


def perturb_render_hdr_df(results, ptz: PointZoomBBConverter,
                          width: int, height: int, max_iter: int):
    """Full 2x32/HDRx2x32 perturbation render."""
    from fractalshark_tpu.ops.perturb import delta_params
    ox_hi, ox_lo, oy_hi, oy_lo = results.device_orbit_df()
    dx, dy, cxo, cyo = delta_params(ptz, results.center_x,
                                    results.center_y, width, height)
    dc = _dc_grids_hdrdf(dx, dy, cxo, cyo, width, height)
    return _perturb_hdrdf_impl(
        jnp.asarray(ox_hi), jnp.asarray(ox_lo),
        jnp.asarray(oy_hi), jnp.asarray(oy_lo),
        dc.re.hi, dc.re.lo, dc.im.hi, dc.im.lo, dc.e,
        int(max_iter), jnp.int32(results.max_ref_iteration()))


__all__ = ["HDC2", "zero", "add", "mul", "mul_pow2", "reduce",
           "norm_squared_hi", "perturb_render_hdr_df", "df_from_hp"]
