"""Plain escape-time rendering in HDR arithmetic (CpuHDR32 / CpuHDR64 /
GpuHDRx32 algorithm families).

Same iteration semantics as the f64 path (``Fractal.cpp:2139-2183``) but
with HDRFloat operands and the reference's HdrReduce placement: reduce
the magnitude sum before the escape compare, reduce zx/zy after each
update (``Fractal.cpp:2163-2180``).

Pixel coordinates are derived exactly from the high-precision view via
per-axis (mantissa, exp2) splits, so this renderer stays correct at
zooms far beyond f64 range (the point of HDR).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from fractalshark_tpu.core.pointzoom import PointZoomBBConverter
from fractalshark_tpu.ops import hdrfloat as hdr
from fractalshark_tpu.ops.hdrfloat import HDR

_INNER_STEPS = 8


def _hdr_scalar_arrays(hp_value, dtype):
    m, e = hp_value.mantissa_exp2()
    return np.asarray(m, dtype), np.int32(e)


def view_to_hdr_params(ptz: PointZoomBBConverter, width: int, height: int,
                       antialiasing: int = 1, dtype=np.float32):
    """Exact HDR (mantissa, exp) splits of min_x, max_y, dx, dy."""
    dx = ptz.delta_x(width, antialiasing)
    dy = ptz.delta_y(height, antialiasing)
    return {
        "min_x": _hdr_scalar_arrays(ptz.min_x, dtype),
        "max_y": _hdr_scalar_arrays(ptz.max_y, dtype),
        "dx": _hdr_scalar_arrays(dx, dtype),
        "dy": _hdr_scalar_arrays(dy, dtype),
    }


def hdr_escape_tile(cx: HDR, cy: HDR, max_iter, iter_dtype=jnp.uint32):
    """Masked lockstep escape iteration over one array of HDR pixel
    coordinates. Returns iteration counts.

    Liveness is counter-derived (it == k) — no boolean carry.
    """
    shape = cx.m.shape
    dtype = cx.m.dtype
    four = HDR(jnp.full(shape, 1.0, dtype), jnp.full(shape, 2, jnp.int32))
    max_it = jnp.asarray(max_iter, jnp.int32)

    def step(_, s):
        k, zxm, zxe, zym, zye, it = s
        zx = HDR(zxm, zxe)
        zy = HDR(zym, zye)
        zx2 = hdr.square(zx)
        zy2 = hdr.square(zy)
        mag = hdr.reduce(hdr.add(zx2, zy2))
        esc = hdr.gt_reduced(mag, four)
        cont = (it == k) & ~esc & (k < max_it)
        nzy = hdr.reduce(hdr.add(hdr.mul_pow2(hdr.mul(zx, zy), 1), cy))
        nzx = hdr.reduce(hdr.add(hdr.sub(zx2, zy2), cx))
        zxm = jnp.where(cont, nzx.m, zxm)
        zxe = jnp.where(cont, nzx.e, zxe)
        zym = jnp.where(cont, nzy.m, zym)
        zye = jnp.where(cont, nzy.e, zye)
        it = it + cont.astype(jnp.int32)
        return k + 1, zxm, zxe, zym, zye, it

    def cond(s):
        k, _, _, _, _, it = s
        return jnp.logical_and(
            k < max_it, jnp.max((it == k).astype(jnp.int32)) > 0)

    def chunk(s):
        return jax.lax.fori_loop(jnp.int32(0), jnp.int32(_INNER_STEPS),
                                 step, s)

    init = (jnp.int32(0), cx.m, cx.e, cy.m, cy.e,
            jnp.zeros(shape, jnp.int32))
    _, _, _, _, _, iters = jax.lax.while_loop(cond, chunk, init)
    return iters.astype(iter_dtype)


@functools.partial(jax.jit, static_argnames=("width", "height", "dtype"))
def _escape_hdr_impl(min_x_m, min_x_e, max_y_m, max_y_e,
                     dx_m, dx_e, dy_m, dy_e, max_iter, width, height, dtype):
    xs = jnp.arange(width, dtype=dtype)
    ys = jnp.arange(height, dtype=dtype)
    one_col = jnp.ones((height, 1), dtype)
    one_row = jnp.ones((1, width), dtype)

    def bc(v, shape_like):
        return jnp.broadcast_to(v, shape_like)

    min_x = HDR(bc(min_x_m, (height, width)),
                bc(min_x_e, (height, width)))
    max_y = HDR(bc(max_y_m, (height, width)),
                bc(max_y_e, (height, width)))
    # cx = min_x + x*dx ; cy = max_y - y*dy  (exact HDR arithmetic)
    xdx = HDR((xs[None, :] * dx_m) * one_col,
              bc(dx_e, (height, width)))
    ydy = HDR((ys[:, None] * dy_m) * one_row,
              bc(dy_e, (height, width)))
    cx = hdr.reduce(hdr.add(min_x, hdr.reduce(xdx)))
    cy = hdr.reduce(hdr.sub(max_y, hdr.reduce(ydy)))
    return hdr_escape_tile(cx, cy, max_iter)


def escape_hdr(ptz: PointZoomBBConverter, width: int, height: int,
               max_iter: int, sub_dtype=jnp.float32):
    """Render iteration counts [height, width] with HDR arithmetic."""
    np_dtype = np.float32 if sub_dtype == jnp.float32 else np.float64
    p = view_to_hdr_params(ptz, width, height, dtype=np_dtype)
    args = []
    for key in ("min_x", "max_y", "dx", "dy"):
        m, e = p[key]
        args += [jnp.asarray(m), jnp.asarray(e)]
    return _escape_hdr_impl(*args, jnp.asarray(max_iter, jnp.int32),
                            width, height, jnp.dtype(sub_dtype))
