"""Plain (non-perturbed) escape-time kernels.

Semantics match the reference CPU loop (``Fractal.cpp:2139-2183``,
``CalcCpuHDR``) and the direct GPU kernels
(``FractalSharkGpuLib/LowPrecisionKernels.cuh``):

    z = c;  i = 0
    while i < N:
        if zx^2 + zy^2 > 4: break        # check BEFORE update
        (zx, zy) = (zx^2 - zy^2 + cx, 2 zx zy + cy)
        i += 1
    iters = i                            # N if never escaped

Pixel coordinates: cx = minX + x*dx, cy = maxY - y*dy with
dx = (maxX-minX)/(W*aa), dy = (maxY-minY)/(H*aa)  (Fractal.cpp:2119-2152).

``escape_jax`` is a whole-image lockstep masked iteration in any float
dtype: XLA fuses the chunked update into one elementwise kernel.  The
iteration grid is never data-dependently shaped: exit is via a masked
``while_loop`` (compare SURVEY.md §7 hard part (c)).
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

import jax
import jax.numpy as jnp

from fractalshark_tpu.core.pointzoom import PointZoomBBConverter

# Iterations per masked chunk between "all done?" re-checks.
_INNER_STEPS = 8


@dataclass(frozen=True)
class PlainParams:
    """Plain-render coordinate parameters, all exactly representable in
    the target dtype. Derived from the high-precision view once per
    render."""
    min_x: float
    max_y: float
    dx: float
    dy: float

    @staticmethod
    def from_view(ptz: PointZoomBBConverter, width: int, height: int,
                  antialiasing: int = 1) -> "PlainParams":
        return PlainParams(
            min_x=float(ptz.min_x),
            max_y=float(ptz.max_y),
            dx=float(ptz.delta_x(width, antialiasing)),
            dy=float(ptz.delta_y(height, antialiasing)),
        )


def _iter_dtype(max_iter: int):
    return jnp.uint64 if max_iter >= (1 << 32) else jnp.uint32


# --------------------------------------------------------------------------
# Lockstep implementation (any backend, any dtype incl. f64)
# --------------------------------------------------------------------------


@functools.partial(jax.jit, static_argnames=("width", "height", "dtype", "iter_dtype"))
def _escape_jax_impl(min_x, max_y, dx, dy, max_iter, radius_sq, width,
                     height, dtype, iter_dtype, y0=0):
    xs = jnp.arange(width, dtype=dtype)
    ys = jnp.arange(height, dtype=dtype) + jnp.asarray(y0, dtype)
    cx = (min_x + xs * dx)[None, :] * jnp.ones((height, 1), dtype)
    cy = (max_y - ys * dy)[:, None] * jnp.ones((1, width), dtype)

    four = radius_sq.astype(dtype)
    max_it = max_iter.astype(iter_dtype)

    def chunk(state):
        zx, zy, it, active = state

        def step(_, s):
            zx, zy, it, active = s
            zx2 = zx * zx
            zy2 = zy * zy
            escaped = (zx2 + zy2) > four
            hit_max = it >= max_it
            cont = active & ~escaped & ~hit_max
            nzy = 2.0 * zx * zy + cy
            nzx = zx2 - zy2 + cx
            zx = jnp.where(cont, nzx, zx)
            zy = jnp.where(cont, nzy, zy)
            it = it + cont.astype(iter_dtype)
            active = cont
            return zx, zy, it, active

        return jax.lax.fori_loop(0, _INNER_STEPS, step, state)

    def cond(state):
        return jnp.any(state[3])

    zx0 = cx
    zy0 = cy
    it0 = jnp.zeros((height, width), iter_dtype)
    active0 = jnp.ones((height, width), bool)
    _, _, iters, _ = jax.lax.while_loop(cond, chunk, (zx0, zy0, it0, active0))
    return iters


def escape_jax(params: PlainParams, width: int, height: int, max_iter: int,
               dtype=jnp.float64, escape_radius_sq: float = 4.0,
               y0: int = 0):
    """Lockstep masked escape iteration over the full image.

    escape_radius_sq: 4 for plain renders (Fractal.cpp:2168); pass 256
    to mirror the perturbation renderers' escape test for comparisons.
    y0: row offset for tile-band renders — cy is computed as
    max_y - (y0+y)*dy so bands are bit-identical to the whole image."""
    iter_dtype = _iter_dtype(max_iter)
    dtype = jnp.dtype(dtype)
    return _escape_jax_impl(
        jnp.asarray(params.min_x, dtype), jnp.asarray(params.max_y, dtype),
        jnp.asarray(params.dx, dtype), jnp.asarray(params.dy, dtype),
        jnp.asarray(max_iter, iter_dtype),
        jnp.asarray(escape_radius_sq, dtype),
        width, height, dtype, iter_dtype, y0=y0)
