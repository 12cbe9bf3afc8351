"""True renormalizing quad-double/quad-float arithmetic (QD4).

The reference ships textbook QD (four-term non-overlapping float
expansions with renormalization, ``FractalSharkLib/QuadFloat/
gqf_basic.cuh``, after Hida–Li–Bailey).  ops/quadflt.py's compensated
pair-of-DFs reaches ~76–100 effective bits; this module implements the
full four-component form with renormalization — branch-free (two
quick-two-sum sweeps) so it vectorizes elementwise — giving ~3.9×p
effective mantissa bits (≈92+ for f32 components, ≈200+ for f64).

All ops are elementwise over arrays and jit-safe.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from fractalshark_tpu.core.highprecision import HighPrecision
from fractalshark_tpu.ops.dblflt import quick_two_sum, two_prod, two_sum


class QD(NamedTuple):
    q0: jax.Array
    q1: jax.Array
    q2: jax.Array
    q3: jax.Array


def _three_sum(a, b, c):
    """(s, e1, e2) with a+b+c = s+e1+e2."""
    t1, t2 = two_sum(a, b)
    s, t3 = two_sum(c, t1)
    e1, e2 = two_sum(t2, t3)
    return s, e1, e2


def _three_sum2(a, b, c):
    """(s, e) with a+b+c ≈ s+e."""
    t1, t2 = two_sum(a, b)
    s, t3 = two_sum(c, t1)
    return s, t2 + t3


def renorm(c0, c1, c2, c3, c4=None):
    """Branch-free renormalization: two downward quick-two-sum sweeps
    compress the (possibly overlapping) terms into a canonical
    non-overlapping four-term expansion."""
    if c4 is not None:
        c3, c4 = quick_two_sum(c3, c4)
        c2, c3 = quick_two_sum(c2, c3)
        c1, c2 = quick_two_sum(c1, c2)
        c0, c1 = quick_two_sum(c0, c1)
        c3 = c3 + c4
    # sweep 1 (bottom-up alignment)
    c2, c3 = quick_two_sum(c2, c3)
    c1, c2 = quick_two_sum(c1, c2)
    c0, c1 = quick_two_sum(c0, c1)
    # sweep 2 (fix residual overlap)
    c2, c3 = quick_two_sum(c2, c3)
    c1, c2 = quick_two_sum(c1, c2)
    c0, c1 = quick_two_sum(c0, c1)
    return QD(c0, c1, c2, c3)


def qd_zero(shape, dtype=jnp.float32) -> QD:
    z = jnp.zeros(shape, dtype)
    return QD(z, z, z, z)


def qd_from_float(x) -> QD:
    z = jnp.zeros_like(x)
    return QD(x, z, z, z)


def qd_neg(x: QD) -> QD:
    return QD(-x.q0, -x.q1, -x.q2, -x.q3)


def qd_add(x: QD, y: QD) -> QD:
    """Hida–Li–Bailey 'sloppy' addition + renorm (~3.9p bits)."""
    s0, t0 = two_sum(x.q0, y.q0)
    s1, t1 = two_sum(x.q1, y.q1)
    s2, t2 = two_sum(x.q2, y.q2)
    s3, t3 = two_sum(x.q3, y.q3)
    s1, t0 = two_sum(s1, t0)
    s2, t0, t1 = _three_sum(s2, t0, t1)
    s3, t0 = _three_sum2(s3, t0, t2)
    t0 = t0 + t1 + t3
    return renorm(s0, s1, s2, s3, t0)


def qd_sub(x: QD, y: QD) -> QD:
    return qd_add(x, qd_neg(y))


def qd_mul(x: QD, y: QD) -> QD:
    """'Sloppy' multiplication: exact through O(ulp³) terms."""
    p0, q0 = two_prod(x.q0, y.q0)
    p1, q1 = two_prod(x.q0, y.q1)
    p2, q2 = two_prod(x.q1, y.q0)
    p3, q3 = two_prod(x.q0, y.q2)
    p4, q4 = two_prod(x.q1, y.q1)
    p5, q5 = two_prod(x.q2, y.q0)
    # order 1
    p1, p2, q0 = _three_sum(p1, p2, q0)
    # order 2
    p2, q1, q2 = _three_sum(p2, q1, q2)
    p3, p4, p5 = _three_sum(p3, p4, p5)
    s0, t0 = two_sum(p2, p3)
    s1, t1 = two_sum(q1, p4)
    s2 = q2 + p5
    s1, t0 = two_sum(s1, t0)
    s2 = s2 + (t0 + t1)
    # order 3 (plain products suffice)
    s1b = (x.q0 * y.q3 + x.q1 * y.q2 + x.q2 * y.q1 + x.q3 * y.q0 +
           q3 + q4 + q5)
    return renorm(p0, p1, s0, s1 + s1b, s2)


def qd_sqr(x: QD) -> QD:
    return qd_mul(x, x)


def qd_mul_pow2(x: QD, s) -> QD:
    return QD(x.q0 * s, x.q1 * s, x.q2 * s, x.q3 * s)


def qd_to_f64(x: QD) -> jax.Array:
    return (x.q0.astype(jnp.float64) + x.q1.astype(jnp.float64) +
            x.q2.astype(jnp.float64) + x.q3.astype(jnp.float64))


def qd_from_hp(v: HighPrecision, dtype=np.float32):
    """Split a HighPrecision value into four non-overlapping numpy
    components (host-side)."""
    comps = []
    rem = v
    for _ in range(4):
        c = dtype(float(rem))
        comps.append(c)
        rem = rem - HighPrecision(float(c), prec=max(256, v.prec))
    return tuple(comps)


# --------------------------------------------------------------- renderer


def _escape_qd_impl(scal, max_iter, width, height, dtype):
    import functools as _ft  # noqa: F401

    xs = jnp.arange(width, dtype=dtype)
    ys = jnp.arange(height, dtype=dtype)
    shape = (height, width)

    def qd_scalar(i):
        return QD(jnp.full(shape, scal[i], dtype),
                  jnp.full(shape, scal[i + 1], dtype),
                  jnp.full(shape, scal[i + 2], dtype),
                  jnp.full(shape, scal[i + 3], dtype))

    min_x = qd_scalar(0)
    max_y = qd_scalar(4)
    dx = qd_scalar(8)
    dy = qd_scalar(12)
    xb = jnp.broadcast_to(xs[None, :], shape)
    yb = jnp.broadcast_to(ys[:, None], shape)
    cx = qd_add(min_x, qd_mul(dx, qd_from_float(xb)))
    cy = qd_sub(max_y, qd_mul(dy, qd_from_float(yb)))

    max_it = max_iter.astype(jnp.int32)

    def step(_, s):
        k, st, it = s
        zx = QD(*st[0:4])
        zy = QD(*st[4:8])
        zx2 = qd_sqr(zx)
        zy2 = qd_sqr(zy)
        mag = qd_add(zx2, zy2)
        esc = mag.q0 > 4.0
        cont = (it == k) & ~esc & (k < max_it)
        nzy = qd_add(qd_mul_pow2(qd_mul(zx, zy), dtype(2.0)), cy)
        nzx = qd_add(qd_sub(zx2, zy2), cx)
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


def escape_qd(ptz, width: int, height: int, max_iter: int,
              variant: str = "4x32"):
    """Escape-time render on true QD coordinates (the reference's
    GQF/GQD direct kernels)."""
    dtype = jnp.float32 if variant == "4x32" else jnp.float64
    np_dtype = np.float32 if variant == "4x32" else np.float64
    vals = []
    for hp in (ptz.min_x, ptz.max_y,
               ptz.delta_x(width), ptz.delta_y(height)):
        vals += list(qd_from_hp(hp, np_dtype))
    scal = jnp.asarray(vals, dtype)
    return _escape_qd_impl(scal, jnp.asarray(max_iter, jnp.int32),
                           width, height, dtype)
