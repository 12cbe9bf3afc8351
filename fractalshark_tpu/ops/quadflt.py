"""Quad-float ("4x32"/"4x64") arithmetic: four-term float expansions.

Counterpart of the reference's QuadFloat/QuadDouble types
(``FractalSharkLib/QuadFloat/gqf_basic.cuh``): on f32 hardware a 4-term
f32 expansion gives ~90+ effective mantissa bits; 4×f64 gives ~200+.

Construction: a compensated pair of double-floats (value = A + B with
A, B each a DF pair from ops/dblflt.py, |B| ≲ ulp_df(A)). DF operations
are nearly correctly rounded, so Knuth-style error recovery at the DF
level yields ~76–100 effective mantissa bits for 4×f32 (measured
against a HighPrecision oracle) — short of textbook QD's ~96-bit
worst case but far beyond f64, ample for escape-time iteration, and
branch-free; the full renormalizing QD is ops/quadd.py.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from fractalshark_tpu.core.highprecision import HighPrecision
from fractalshark_tpu.core.pointzoom import PointZoomBBConverter
from fractalshark_tpu.ops.dblflt import (DF, df_add, df_mul, df_mul_pow2,
                                         df_sub, two_prod)


class QF(NamedTuple):
    """value = A + B, each an unevaluated DF sum."""
    a_hi: jax.Array
    a_lo: jax.Array
    b_hi: jax.Array
    b_lo: jax.Array

    @property
    def A(self) -> DF:
        return DF(self.a_hi, self.a_lo)

    @property
    def B(self) -> DF:
        return DF(self.b_hi, self.b_lo)


def _mk(A: DF, B: DF) -> QF:
    return QF(A.hi, A.lo, B.hi, B.lo)


def _df_two_sum(x: DF, y: DF) -> tuple[DF, DF]:
    """DF-level Knuth two-sum: s ≈ x + y with e capturing the residual
    (exact up to DF rounding of the partials)."""
    s = df_add(x, y)
    bb = df_sub(s, x)
    e = df_add(df_sub(x, df_sub(s, bb)), df_sub(y, bb))
    return s, e


def _renorm(A: DF, B: DF) -> QF:
    s = df_add(A, B)
    e = df_add(df_sub(A, s), B)
    return _mk(s, e)


def qf_zero(shape, dtype=jnp.float32) -> QF:
    z = jnp.zeros(shape, dtype)
    return QF(z, z, z, z)


def qf_from_df(x: DF) -> QF:
    return QF(x.hi, x.lo, jnp.zeros_like(x.hi), jnp.zeros_like(x.hi))


def qf_neg(x: QF) -> QF:
    return QF(-x.a_hi, -x.a_lo, -x.b_hi, -x.b_lo)


def qf_add(x: QF, y: QF) -> QF:
    s, e = _df_two_sum(x.A, y.A)
    e = df_add(e, df_add(x.B, y.B))
    return _renorm(s, e)


def qf_sub(x: QF, y: QF) -> QF:
    return qf_add(x, qf_neg(y))


def _df_two_prod(x: DF, y: DF) -> tuple[DF, DF]:
    """(p, e) with p + e ≈ x·y to ~quad accuracy: the product is the
    exact sum of four error-free component products; accumulate them
    with DF-level two-sums, collecting each step's recovered error."""
    hh = DF(*two_prod(x.hi, y.hi))        # exact
    hl = DF(*two_prod(x.hi, y.lo))        # exact
    lh = DF(*two_prod(x.lo, y.hi))        # exact
    ll = DF(x.lo * y.lo, jnp.zeros_like(x.lo))
    s, e = _df_two_sum(hh, df_add(hl, lh))
    s2, e2 = _df_two_sum(s, ll)
    return s2, df_add(e, e2)


def qf_mul(x: QF, y: QF) -> QF:
    p, e = _df_two_prod(x.A, y.A)
    e = df_add(e, df_add(df_mul(x.A, y.B), df_mul(x.B, y.A)))
    return _renorm(p, e)


def qf_sqr(x: QF) -> QF:
    p, e = _df_two_prod(x.A, x.A)
    e = df_add(e, df_mul_pow2(df_mul(x.A, x.B), 2.0))
    return _renorm(p, e)


def qf_mul_pow2(x: QF, s) -> QF:
    return QF(x.a_hi * s, x.a_lo * s, x.b_hi * s, x.b_lo * s)


def qf_to_f64(x: QF) -> jax.Array:
    return (x.a_hi.astype(jnp.float64) + x.a_lo.astype(jnp.float64) +
            x.b_hi.astype(jnp.float64) + x.b_lo.astype(jnp.float64))


def qf_from_hp(v: HighPrecision, dtype=np.float32):
    """Exact 4-way split of a HighPrecision value (host)."""
    f = np.dtype(dtype).type
    parts = []
    rem = v
    for _ in range(4):
        c = float(rem)
        c = float(f(c))
        parts.append(c)
        rem = rem - HighPrecision(c, prec=v.prec)
    return tuple(parts)


# --------------------------------------------------------- escape render


@functools.partial(jax.jit, static_argnames=("width", "height", "dtype"))
def _escape_qf_impl(scal, max_iter, width, height, dtype):
    xs = jnp.arange(width, dtype=dtype)
    ys = jnp.arange(height, dtype=dtype)
    shape = (height, width)

    def qf_scalar(i):
        return QF(jnp.full(shape, scal[i], dtype),
                  jnp.full(shape, scal[i + 1], dtype),
                  jnp.full(shape, scal[i + 2], dtype),
                  jnp.full(shape, scal[i + 3], dtype))

    min_x = qf_scalar(0)
    max_y = qf_scalar(4)
    dx = qf_scalar(8)
    dy = qf_scalar(12)
    xb = jnp.broadcast_to(xs[None, :], shape)
    yb = jnp.broadcast_to(ys[:, None], shape)
    cx = qf_add(min_x, qf_mul(dx, qf_from_df(DF(xb, jnp.zeros_like(xb)))))
    cy = qf_sub(max_y, qf_mul(dy, qf_from_df(DF(yb, jnp.zeros_like(yb)))))

    max_it = max_iter.astype(jnp.int32)

    def step(_, s):
        k, st, it = s
        zx = QF(*st[0:4])
        zy = QF(*st[4:8])
        zx2 = qf_sqr(zx)
        zy2 = qf_sqr(zy)
        mag = qf_add(zx2, zy2)
        esc = mag.a_hi > 4.0
        cont = (it == k) & ~esc & (k < max_it)
        nzy = qf_add(qf_mul_pow2(qf_mul(zx, zy), 2.0), cy)
        nzx = qf_add(qf_sub(zx2, zy2), cx)
        new = [jnp.where(cont, n, o) for n, o in
               zip(tuple(nzx) + tuple(nzy), st)]
        return k + 1, tuple(new), it + cont.astype(jnp.int32)

    def cond(s):
        k, it = s[0], s[2]
        return jnp.logical_and(k < max_it,
                               jnp.max((it == k).astype(jnp.int32)) > 0)

    def chunk(s):
        return jax.lax.fori_loop(jnp.int32(0), jnp.int32(8), step, s)

    st0 = tuple(cx) + tuple(cy)
    init = (jnp.int32(0), st0, jnp.zeros(shape, jnp.int32))
    _, _, iters = jax.lax.while_loop(cond, chunk, init)
    return iters.astype(jnp.uint32)


def escape_qf(ptz: PointZoomBBConverter, width: int, height: int,
              max_iter: int, variant: str = "4x32"):
    dtype = jnp.float32 if variant == "4x32" else jnp.float64
    np_dtype = np.float32 if variant == "4x32" else np.float64
    vals = []
    for hp in (ptz.min_x, ptz.max_y,
               ptz.delta_x(width), ptz.delta_y(height)):
        vals += list(qf_from_hp(hp, np_dtype))
    scal = jnp.asarray(vals, dtype)
    return _escape_qf_impl(scal, jnp.asarray(max_iter, jnp.int32),
                           width, height, dtype)
