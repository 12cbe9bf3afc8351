"""HDRFloat: high-dynamic-range float = (mantissa, int32 exponent).

Vectorized struct-of-arrays re-design of the reference scalar type
(``HpSharkFloatLib/HDRFloat.h:84``, complex variant
``HDRFloatComplex.h:7-14``): value = mantissa * 2**exp with the mantissa
kept *unreduced* between operations and renormalized to ±[1, 2) only at
explicit ``reduce`` points (``HDRFloat.h:416-489``), mirroring the
reference's lazy ``HdrReduce`` discipline so float rounding sequences
match.

Semantics preserved:
* zero sentinel: exp = MIN_BIG_EXPONENT = INT32_MIN >> 3
  (``HDRFloat.h:50-58``)
* adds ignore operands whose exponent differs by more than
  EXPONENT_DIFF_IGNORED = 120 (``HDRFloat.h:122``) — realized here by
  clamping the alignment shift so the small operand underflows to 0
* complex numbers share one exponent between re/im mantissas
* ``chebychev_norm`` = max(|re|, |im|)
* comparisons have "both positive reduced" fast paths

All functions are elementwise over arbitrary array shapes (f32
mantissas use integer bit-twiddling for frexp/ldexp; f64 uses
jnp.frexp/ldexp).
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

# INT32_MIN >> 3 — a numpy scalar, so no trace captures it as a device
# constant
MIN_BIG_EXPONENT = np.int32(-(2 ** 31) // 8)
EXPONENT_DIFF_IGNORED = 120

_F32_BIAS = 127
_F64_BIAS = 1023


class HDR(NamedTuple):
    """Scalar HDR float (struct of arrays)."""
    m: jax.Array  # mantissa (f32 or f64)
    e: jax.Array  # int32 exponent


class HDRComplex(NamedTuple):
    """Complex HDR with shared exponent (HDRFloatComplex.h:9-12)."""
    re: jax.Array
    im: jax.Array
    e: jax.Array


# ---------------------------------------------------------------- helpers


def _frexp2(m):
    """Return (mantissa', exp) with m == mantissa' * 2**exp and
    |mantissa'| in [1, 2) (zeros pass through with exp 0)."""
    dtype = m.dtype
    if dtype == jnp.float32:
        bits = jax.lax.bitcast_convert_type(m, jnp.int32)
        raw_exp = (bits >> 23) & 0xFF
        f_exp = raw_exp - _F32_BIAS
        sign_frac_mask = jnp.int32(np.int32(np.uint32(0x807FFFFF)))
        norm = jax.lax.bitcast_convert_type(
            (bits & sign_frac_mask) | jnp.int32(0x3F800000),
            jnp.float32)
        zero = m == 0
        return (jnp.where(zero, m, norm),
                jnp.where(zero, jnp.int32(0), f_exp.astype(jnp.int32)))
    # f64 path (CPU): jnp.frexp gives [0.5, 1)
    mm, ee = jnp.frexp(m)
    zero = m == 0
    return (jnp.where(zero, m, mm * 2.0),
            jnp.where(zero, jnp.int32(0), (ee - 1).astype(jnp.int32)))


def pow2i(shift, dtype):
    """2.0**shift as dtype, exact, for shift within the dtype's normal
    exponent range (clamped)."""
    if jnp.dtype(dtype) == jnp.float32:
        s = jnp.clip(shift, -126, 127).astype(jnp.int32)
        return jax.lax.bitcast_convert_type(
            (s + _F32_BIAS) << 23, jnp.float32)
    s = jnp.clip(shift, -1022, 1023).astype(jnp.int64)
    return jax.lax.bitcast_convert_type(
        (s + _F64_BIAS) << 52, jnp.float64)


# ---------------------------------------------------------- construction


def hdr_zero(shape, dtype=jnp.float32) -> HDR:
    return HDR(jnp.zeros(shape, dtype),
               jnp.full(shape, MIN_BIG_EXPONENT, jnp.int32))


def hdr_from_float(x) -> HDR:
    m, e = _frexp2(x)
    return HDR(m, jnp.where(x == 0, MIN_BIG_EXPONENT, e))


def hdr_from_mantissa_exp(m, e) -> HDR:
    """From a host-computed (mantissa, exp2) pair (e.g.
    HighPrecision.mantissa_exp2), then renormalize."""
    return reduce(HDR(jnp.asarray(m), jnp.asarray(e, jnp.int32)))


def hdr_to_float(x: HDR):
    """Collapse to a plain float (saturating; diagnostics only)."""
    return x.m * pow2i(x.e, x.m.dtype)


# ------------------------------------------------------------- reduction


def reduce(x: HDR) -> HDR:
    """HdrReduce: renormalize mantissa to ±[1,2), accumulate exponent
    (HDRFloat.h:416-454)."""
    mm, fe = _frexp2(x.m)
    zero = x.m == 0
    return HDR(mm, jnp.where(zero, MIN_BIG_EXPONENT, x.e + fe))


def reduce_complex(z: HDRComplex) -> HDRComplex:
    """Normalize a shared-exponent complex by its Chebyshev-largest
    component (mirrors HDRFloatComplex::Reduce)."""
    big = jnp.maximum(jnp.abs(z.re), jnp.abs(z.im))
    _, fe = _frexp2(big)
    zero = big == 0
    fe = jnp.where(zero, jnp.int32(0), fe)
    scale = pow2i(-fe, z.re.dtype)
    return HDRComplex(z.re * scale, z.im * scale,
                      jnp.where(zero, MIN_BIG_EXPONENT, z.e + fe))


# ------------------------------------------------------------ arithmetic


def negate(x: HDR) -> HDR:
    return HDR(-x.m, x.e)


def hdr_abs(x: HDR) -> HDR:
    return HDR(jnp.abs(x.m), x.e)


def add(a: HDR, b: HDR) -> HDR:
    """Unreduced add. The smaller-exponent operand is scaled down by the
    exponent gap; gaps > EXPONENT_DIFF_IGNORED underflow to zero, which
    reproduces the reference's ignore fast path (HDRFloat.h:122)."""
    a_big = a.e >= b.e
    eb = jnp.where(a_big, a.e, b.e)
    mb = jnp.where(a_big, a.m, b.m)
    ms = jnp.where(a_big, b.m, a.m)
    diff = eb - jnp.where(a_big, b.e, a.e)
    # clamp: beyond the ignore threshold the scaled operand vanishes
    scale = pow2i(-jnp.minimum(diff, EXPONENT_DIFF_IGNORED + 6), mb.dtype)
    return HDR(mb + ms * scale, eb)


def sub(a: HDR, b: HDR) -> HDR:
    return add(a, negate(b))


def mul(a: HDR, b: HDR) -> HDR:
    return HDR(a.m * b.m, a.e + b.e)


def square(a: HDR) -> HDR:
    return HDR(a.m * a.m, a.e + a.e)


def mul_pow2(a: HDR, k: int) -> HDR:
    return HDR(a.m, a.e + k)


def mul_float(a: HDR, s) -> HDR:
    """Multiply by a plain (small) scalar."""
    return HDR(a.m * s, a.e)


def divide(a: HDR, b: HDR) -> HDR:
    return HDR(a.m / b.m, a.e - b.e)


def reciprocal(a: HDR) -> HDR:
    return HDR(1.0 / a.m, -a.e)


def hdr_sqrt(a: HDR) -> HDR:
    """sqrt of a reduced non-negative HDR."""
    odd = (a.e & 1) != 0
    m = jnp.where(odd, a.m * 2.0, a.m)
    e = jnp.where(odd, a.e - 1, a.e)
    return HDR(jnp.sqrt(m), e // 2)


# ----------------------------------------------------------- comparisons
# "BothPositiveReduced" fast paths assume reduced, non-negative operands
# (mantissa in [1,2) or zero-sentinel exponent), as in the reference.


def gt_reduced(a: HDR, b: HDR):
    return (a.e > b.e) | ((a.e == b.e) & (a.m > b.m))


def lt_reduced(a: HDR, b: HDR):
    return (a.e < b.e) | ((a.e == b.e) & (a.m < b.m))


def gte_reduced(a: HDR, b: HDR):
    return ~lt_reduced(a, b)


# Unreduced compare fast paths (perturbation-tail hot loops).  Both are
# BOOLEAN-IDENTICAL to reducing first and comparing with the
# *_reduced forms, under the preconditions below — they exist to drop
# the per-step frexp/renormalize passes.  Preconditions (hold for every call site:
# chebychev_norm / norm_squared of a reduce_complex'd value, or a
# stored reduced threshold): operands are non-negative with mantissa
# either exactly 0 (any exponent; zero values carry the huge-negative
# sentinel-derived exponent) or in [1, 2^30).
#
# Proof sketch: the compare m_a·2^(e_a) < m_b·2^(e_b) is evaluated as
# m_a < m_b·pow2i(e_b − e_a).  In the f32-representable shift range
# the scaling is exact (both sides exact, no ties lost).  Outside it,
# pow2i clamps at ±126: with the shift that large the magnitudes
# differ by ≥ 2^96, so the clamped product still lands on the correct
# side of m_a (m_b·2^126 ≥ 2^126 > m_a, resp. m_b·2^-126 ≤ 2^-96 <
# any nonzero m_a); f32 overflow of the product gives +inf which
# compares correctly.  Zero mantissas: 0 < t ⟺ t > 0 and m_a < 0
# never — matching the reduced forms' sentinel-exponent compares.


def lt_unreduced(a: HDR, b: HDR):
    """a < b for unreduced non-negative operands (see block comment)."""
    return a.m < b.m * pow2i(b.e - a.e, a.m.dtype)


def gt_pow2_unreduced(a: HDR, k: int):
    """a > 2**k for an unreduced non-negative a (see block comment)."""
    return a.m > pow2i(k - a.e, a.m.dtype)


def lte_reduced(a: HDR, b: HDR):
    return ~gt_reduced(a, b)


def compare_signed(a: HDR, b: HDR):
    """Full signed compare of *reduced* values: -1 / 0 / +1."""
    sa = jnp.sign(a.m)
    sb = jnp.sign(b.m)
    mag_gt = gt_reduced(hdr_abs(a), hdr_abs(b))
    mag_lt = lt_reduced(hdr_abs(a), hdr_abs(b))
    same_sign = sa == sb
    res = jnp.where(sa > sb, 1, jnp.where(sa < sb, -1, 0))
    mag = jnp.where(mag_gt, sa, jnp.where(mag_lt, -sa, 0))
    return jnp.where(same_sign, mag, res).astype(jnp.int32)


# ---------------------------------------------------------------- complex


def complex_from_hdr(re: HDR, im: HDR) -> HDRComplex:
    """Join two reduced HDR scalars into a shared-exponent complex."""
    e = jnp.maximum(re.e, im.e)
    dre = jnp.minimum(e - re.e, EXPONENT_DIFF_IGNORED + 6)
    dim = jnp.minimum(e - im.e, EXPONENT_DIFF_IGNORED + 6)
    return HDRComplex(re.m * pow2i(-dre, re.m.dtype),
                      im.m * pow2i(-dim, im.m.dtype), e)


def complex_zero(shape, dtype=jnp.float32) -> HDRComplex:
    return HDRComplex(jnp.zeros(shape, dtype), jnp.zeros(shape, dtype),
                      jnp.full(shape, MIN_BIG_EXPONENT, jnp.int32))


def complex_re(z: HDRComplex) -> HDR:
    return HDR(z.re, z.e)


def complex_im(z: HDRComplex) -> HDR:
    return HDR(z.im, z.e)


def complex_add(a: HDRComplex, b: HDRComplex) -> HDRComplex:
    a_big = a.e >= b.e
    e = jnp.where(a_big, a.e, b.e)
    diff = jnp.minimum(e - jnp.where(a_big, b.e, a.e),
                       EXPONENT_DIFF_IGNORED + 6)
    s = pow2i(-diff, a.re.dtype)
    re = jnp.where(a_big, a.re + b.re * s, b.re + a.re * s)
    im = jnp.where(a_big, a.im + b.im * s, b.im + a.im * s)
    return HDRComplex(re, im, e)


def complex_sub(a: HDRComplex, b: HDRComplex) -> HDRComplex:
    return complex_add(a, HDRComplex(-b.re, -b.im, b.e))


def complex_mul(a: HDRComplex, b: HDRComplex) -> HDRComplex:
    return HDRComplex(a.re * b.re - a.im * b.im,
                      a.re * b.im + a.im * b.re,
                      a.e + b.e)


def complex_sqr(a: HDRComplex) -> HDRComplex:
    return HDRComplex(a.re * a.re - a.im * a.im,
                      2.0 * a.re * a.im,
                      a.e + a.e)


def complex_mul_float(a: HDRComplex, s) -> HDRComplex:
    return HDRComplex(a.re * s, a.im * s, a.e)


def complex_mul_pow2(a: HDRComplex, k: int) -> HDRComplex:
    return HDRComplex(a.re, a.im, a.e + k)


def complex_mul_hdr(a: HDRComplex, s: HDR) -> HDRComplex:
    return HDRComplex(a.re * s.m, a.im * s.m, a.e + s.e)


def norm_squared(a: HDRComplex) -> HDR:
    return HDR(a.re * a.re + a.im * a.im, a.e + a.e)


def chebychev_norm(a: HDRComplex) -> HDR:
    """max(|re|, |im|) (HDRFloatComplex::chebychevNorm)."""
    return HDR(jnp.maximum(jnp.abs(a.re), jnp.abs(a.im)), a.e)
