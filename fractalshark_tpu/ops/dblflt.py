"""Double-float ("2x32"/"2x64") arithmetic: an unevaluated sum of two
native floats giving ~2× the mantissa bits.

Re-design of the reference's CUDA float-float types
(``HpSharkFloatLib/CudaDblflt.h``, ``dblflt.cuh``, ``dbldbl.cuh``):
a (hi, lo) f32 pair gives ~48 mantissa bits at f32 throughput.
Algorithms are the classical error-free transformations (Dekker
two-prod via splitting, Knuth two-sum), valid under IEEE
round-to-nearest.  The split works on the bit pattern, so its halves
are exact whether or not the compiler contracts a multiply and an add
into one FMA (XLA's GPU and CPU backends both may); products of the
halves are then exact, and contraction cannot change results.

Works elementwise over arrays.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from fractalshark_tpu.core.pointzoom import PointZoomBBConverter
from fractalshark_tpu.core.highprecision import HighPrecision


class DF(NamedTuple):
    """value = hi + lo, |lo| <= ulp(hi)/2."""
    hi: jax.Array
    lo: jax.Array


def two_sum(a, b):
    s = a + b
    bb = s - a
    err = (a - (s - bb)) + (b - bb)
    return s, err


def quick_two_sum(a, b):
    """Requires |a| >= |b| (or a == 0)."""
    s = a + b
    err = b - (s - a)
    return s, err


def split(a):
    """a = hi + lo exactly, hi the significand rounded to its top 12 of
    24 bits (f32) or 26 of 53 (f64), lo ≤ that many bits with its sign.
    Dekker's ``c - (c - 4097·a)`` form breaks when ``4097·a - a`` is
    contracted into an FMA; rounding on the bit pattern cannot be."""
    if a.dtype == jnp.float32:
        ity, drop = jnp.uint32, 12
    else:
        ity, drop = jnp.uint64, 27
    bits = jax.lax.bitcast_convert_type(a, ity)
    mask = np.array(~((1 << drop) - 1) & (2 ** (8 * bits.dtype.itemsize)
                                          - 1), bits.dtype)
    half = np.array(1 << (drop - 1), bits.dtype)
    hi = jax.lax.bitcast_convert_type((bits + half) & mask, a.dtype)
    return hi, a - hi


def two_prod(a, b):
    p = a * b
    ahi, alo = split(a)
    bhi, blo = split(b)
    err = ((ahi * bhi - p) + ahi * blo + alo * bhi) + alo * blo
    return p, err


# ------------------------------------------------------------- df ops


def df_zero(shape, dtype=jnp.float32) -> DF:
    z = jnp.zeros(shape, dtype)
    return DF(z, z)


def df_from_float(x) -> DF:
    return DF(x, jnp.zeros_like(x))


def df_neg(a: DF) -> DF:
    return DF(-a.hi, -a.lo)


def df_add(a: DF, b: DF) -> DF:
    s1, s2 = two_sum(a.hi, b.hi)
    t1, t2 = two_sum(a.lo, b.lo)
    s2 = s2 + t1
    s1, s2 = quick_two_sum(s1, s2)
    s2 = s2 + t2
    s1, s2 = quick_two_sum(s1, s2)
    return DF(s1, s2)


def df_sub(a: DF, b: DF) -> DF:
    return df_add(a, df_neg(b))


def df_mul(a: DF, b: DF) -> DF:
    p1, p2 = two_prod(a.hi, b.hi)
    p2 = p2 + a.hi * b.lo + a.lo * b.hi
    return DF(*quick_two_sum(p1, p2))


def df_sqr(a: DF) -> DF:
    p1, p2 = two_prod(a.hi, a.hi)
    p2 = p2 + 2.0 * a.hi * a.lo
    return DF(*quick_two_sum(p1, p2))


def df_mul_float(a: DF, s) -> DF:
    p1, p2 = two_prod(a.hi, s)
    p2 = p2 + a.lo * s
    return DF(*quick_two_sum(p1, p2))


def df_mul_pow2(a: DF, s) -> DF:
    """Multiply by an exact power of two."""
    return DF(a.hi * s, a.lo * s)


def df_gt_float(a: DF, thresh) -> jax.Array:
    return (a.hi > thresh) | ((a.hi == thresh) & (a.lo > 0))


def df_to_float(a: DF):
    return a.hi + a.lo


def df_from_hp(x: HighPrecision, dtype=np.float32) -> tuple[float, float]:
    """Exact (hi, lo) split of a HighPrecision value on host."""
    f = np.dtype(dtype).type
    hi = f(float(x))
    lo = f(float(x - HighPrecision(float(hi), prec=x.prec)))
    return float(hi), float(lo)


# --------------------------------------------------------- escape render


@functools.partial(jax.jit,
                   static_argnames=("width", "height", "dtype"))
def _escape_df_impl(scal, max_iter, width, height, dtype):
    """scal: [8] = [minx_hi, minx_lo, maxy_hi, maxy_lo,
                    dx_hi, dx_lo, dy_hi, dy_lo]."""
    xs = jnp.arange(width, dtype=dtype)
    ys = jnp.arange(height, dtype=dtype)
    shape = (height, width)

    def bcast_row(v):
        return jnp.broadcast_to(v[None, :], shape)

    def bcast_col(v):
        return jnp.broadcast_to(v[:, None], shape)

    min_x = DF(jnp.full(shape, scal[0], dtype), jnp.full(shape, scal[1], dtype))
    max_y = DF(jnp.full(shape, scal[2], dtype), jnp.full(shape, scal[3], dtype))
    dx = DF(jnp.full(shape, scal[4], dtype), jnp.full(shape, scal[5], dtype))
    dy = DF(jnp.full(shape, scal[6], dtype), jnp.full(shape, scal[7], dtype))
    cx = df_add(min_x, df_mul_float(dx, bcast_row(xs)))
    cy = df_sub(max_y, df_mul_float(dy, bcast_col(ys)))

    max_it = max_iter.astype(jnp.int32)

    def step(_, s):
        k, zxh, zxl, zyh, zyl, it = s
        zx = DF(zxh, zxl)
        zy = DF(zyh, zyl)
        zx2 = df_sqr(zx)
        zy2 = df_sqr(zy)
        mag = df_add(zx2, zy2)
        esc = mag.hi > 4.0
        cont = (it == k) & ~esc & (k < max_it)
        nzy = df_add(df_mul_pow2(df_mul(zx, zy), 2.0), cy)
        nzx = df_add(df_sub(zx2, zy2), cx)
        zxh = jnp.where(cont, nzx.hi, zxh)
        zxl = jnp.where(cont, nzx.lo, zxl)
        zyh = jnp.where(cont, nzy.hi, zyh)
        zyl = jnp.where(cont, nzy.lo, zyl)
        return k + 1, zxh, zxl, zyh, zyl, it + cont.astype(jnp.int32)

    def cond(s):
        k, it = s[0], s[5]
        return jnp.logical_and(k < max_it,
                               jnp.max((it == k).astype(jnp.int32)) > 0)

    def chunk(s):
        return jax.lax.fori_loop(jnp.int32(0), jnp.int32(8), step, s)

    init = (jnp.int32(0), cx.hi, cx.lo, cy.hi, cy.lo,
            jnp.zeros(shape, jnp.int32))
    _, _, _, _, _, iters = jax.lax.while_loop(cond, chunk, init)
    return iters.astype(jnp.uint32)


def escape_df(params_or_ptz, width: int, height: int, max_iter: int,
              variant: str = "2x32"):
    """Plain escape render in double-float arithmetic.

    variant: "2x32" (f32 pairs, ~48-bit) or "2x64" (f64 pairs,
    ~106-bit); the 4x variants live in ops/quadd.py.
    """
    if variant in ("4x32", "4x64"):
        raise NotImplementedError(
            f"quad-float variant {variant} not yet implemented")
    dtype = jnp.float32 if variant == "2x32" else jnp.float64
    np_dtype = np.float32 if variant == "2x32" else np.float64
    if isinstance(params_or_ptz, PointZoomBBConverter):
        ptz = params_or_ptz
        vals = []
        for hp in (ptz.min_x, ptz.max_y,
                   ptz.delta_x(width), ptz.delta_y(height)):
            vals += list(df_from_hp(hp, np_dtype))
    else:
        p = params_or_ptz
        vals = []
        for v in (p.min_x, p.max_y, p.dx, p.dy):
            hi = np_dtype(v)
            lo = np_dtype(v - float(hi))
            vals += [float(hi), float(lo)]
    scal = jnp.asarray(vals, dtype)
    return _escape_df_impl(scal, jnp.asarray(max_iter, jnp.int32),
                           width, height, dtype)
