"""Perturbation delta-iteration kernels with Zhuoran rebasing.

Per-pixel semantics (SURVEY.md A.1; reference CPU loop
``Fractal.cpp:2645-2675``, GPU mirror ``FractalSharkGpuLib/LAKernel.cuh``):

    dz ← dz·(2·Z[j] + dz) + dc ;  j += 1
    z  = Z[j] + dz
    escaped  when |z|² > 256          (iteration count = current count)
    rebase   when |z|² < |dz|² or j == maxRefIteration:
             dz ← z ; j ← 0

Pixel deltas: dc = (dx·x - centerX, -dy·y - centerY) with
centerX = refX - minX, centerY = refY - maxY (``Fractal.cpp:2235-2237``).

Variants: native float (f32/f64) and HDR (float+exp) for zooms past the
native exponent range.  The orbit array lives as two flat device arrays
(values are O(1), so plain floats); per-pixel dynamic indexing becomes
an XLA gather.  Liveness is counter-derived (no bool carries).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from fractalshark_tpu.core.highprecision import HighPrecision
from fractalshark_tpu.core.pointzoom import PointZoomBBConverter
from fractalshark_tpu.ops import hdrfloat as hdr
from fractalshark_tpu.ops.hdrfloat import HDR, HDRComplex

_INNER_STEPS = 8


# --------------------------------------------------------------------------
# Pixel delta (dc) construction
# --------------------------------------------------------------------------


def delta_params(ptz: PointZoomBBConverter, ref_x: HighPrecision,
                 ref_y: HighPrecision, width: int, height: int,
                 antialiasing: int = 1):
    """High-precision dx, dy, centerX, centerY for the delta grid.
    width/height are the full (AA-scaled) render dimensions."""
    dx = (ptz.max_x - ptz.min_x) / HighPrecision(width)
    dy = (ptz.max_y - ptz.min_y) / HighPrecision(height)
    center_x = ref_x - ptz.min_x
    center_y = ref_y - ptz.max_y
    return dx, dy, center_x, center_y


def _dc_grids_float(dx, dy, cx_off, cy_off, width, height, dtype):
    """dc grids in native float (f64/f32): dcx = x*dx - centerX,
    dcy = -y*dy - centerY."""
    fdx = dtype(float(dx))
    fdy = dtype(float(dy))
    fcx = dtype(float(cx_off))
    fcy = dtype(float(cy_off))
    xs = np.arange(width, dtype=dtype)
    ys = np.arange(height, dtype=dtype)
    dcx = xs[None, :] * fdx - fcx
    dcy = -ys[:, None] * fdy - fcy
    return (jnp.broadcast_to(jnp.asarray(dcx), (height, width)),
            jnp.broadcast_to(jnp.asarray(dcy), (height, width)))


@functools.partial(jax.jit, static_argnames=("width", "height", "dtn"))
def _dc_grids_hdr_impl(dxm, dxe, dym, dye, cxm, cxe, cym, cye,
                       width, height, dtn):
    # ONE executable for the whole grid build: op-by-op eager dispatch
    # costs ~0.4-1.3 s PER DISTINCT OP on first use in a process
    # (remote executable loading), so ~10 eager ops here were ~5-10 s
    # of every cold render
    jdt = jnp.dtype(dtn)
    shape = (height, width)
    xs = jnp.arange(width, dtype=jdt)
    ys = jnp.arange(height, dtype=jdt)
    x_dx = HDR(jnp.broadcast_to(xs[None, :] * dxm, shape),
               jnp.full(shape, dxe, jnp.int32))
    y_dy = HDR(jnp.broadcast_to(ys[:, None] * dym, shape),
               jnp.full(shape, dye, jnp.int32))
    cx_h = HDR(jnp.full(shape, cxm, jdt), jnp.full(shape, cxe, jnp.int32))
    cy_h = HDR(jnp.full(shape, cym, jdt), jnp.full(shape, cye, jnp.int32))
    dcx = hdr.reduce(hdr.sub(hdr.reduce(x_dx), cx_h))
    dcy = hdr.reduce(hdr.sub(hdr.negate(hdr.reduce(y_dy)), cy_h))
    return hdr.complex_from_hdr(dcx, dcy)


def _dc_grids_hdr(dx, dy, cx_off, cy_off, width, height, dtype):
    """dc grids as an HDRComplex (shared exponent), exact at any zoom."""
    def hp_to_hdr_arrays(hp):
        m, e = hp.mantissa_exp2()
        return dtype(m), np.int32(e)

    dxm, dxe = hp_to_hdr_arrays(dx)
    dym, dye = hp_to_hdr_arrays(dy)
    cxm, cxe = hp_to_hdr_arrays(cx_off)
    cym, cye = hp_to_hdr_arrays(cy_off)
    return _dc_grids_hdr_impl(dxm, dxe, dym, dye, cxm, cxe, cym, cye,
                              width, height, np.dtype(dtype).name)


# --------------------------------------------------------------------------
# Native-float kernel (f64 golden path; f32 shallow)
# --------------------------------------------------------------------------


@functools.partial(jax.jit, static_argnames=("max_iter",))
def _perturb_float_impl(orbit_x, orbit_y, dcx, dcy, max_iter, max_ref,
                        start_j):
    shape = dcx.shape
    n = jnp.int32(max_iter)

    def step(_, s):
        k, dzx, dzy, j, it = s
        live = (it == k) & (k < n)
        zx = orbit_x[j]
        zy = orbit_y[j]
        # dz = (2Z + dz) * dz + dc
        tx = 2.0 * zx + dzx
        ty = 2.0 * zy + dzy
        ndzx = tx * dzx - ty * dzy + dcx
        ndzy = tx * dzy + ty * dzx + dcy
        j1 = j + 1
        zfx = orbit_x[j1] + ndzx
        zfy = orbit_y[j1] + ndzy
        nsq = zfx * zfx + zfy * zfy
        dsq = ndzx * ndzx + ndzy * ndzy
        esc = nsq > 256.0
        reb = (nsq < dsq) | (j1 >= max_ref)
        upd = live & ~esc
        dzx = jnp.where(upd, jnp.where(reb, zfx, ndzx), dzx)
        dzy = jnp.where(upd, jnp.where(reb, zfy, ndzy), dzy)
        j = jnp.where(upd, jnp.where(reb, 0, j1), j)
        it = it + upd.astype(jnp.int32)
        return k + 1, dzx, dzy, j, it

    def cond(s):
        k, it = s[0], s[4]
        return jnp.logical_and(k < n,
                               jnp.max((it == k).astype(jnp.int32)) > 0)

    def chunk(s):
        return jax.lax.fori_loop(jnp.int32(0), jnp.int32(_INNER_STEPS),
                                 step, s)

    init = (jnp.int32(0), jnp.zeros_like(dcx), jnp.zeros_like(dcy),
            jnp.broadcast_to(start_j, shape).astype(jnp.int32),
            jnp.zeros(shape, jnp.int32))
    _, _, _, _, iters = jax.lax.while_loop(cond, chunk, init)
    return iters.astype(jnp.uint32)


def perturb_render_float(results, ptz: PointZoomBBConverter,
                         width: int, height: int, max_iter: int,
                         dtype=np.float64):
    """Full perturbation render (native float deltas)."""
    ox, oy = results.device_orbit_jax(dtype)
    dx, dy, cxo, cyo = delta_params(ptz, results.center_x, results.center_y,
                                    width, height)
    dcx, dcy = _dc_grids_float(dx, dy, cxo, cyo, width, height, dtype)
    return _perturb_float_impl(jnp.asarray(ox), jnp.asarray(oy),
                               dcx, dcy, int(max_iter),
                               jnp.int32(results.max_ref_iteration()),
                               jnp.int32(0))


# --------------------------------------------------------------------------
# HDR kernel (deep zoom: |dc| far below native float range)
# --------------------------------------------------------------------------


@functools.partial(jax.jit, static_argnames=("max_iter",))
def _perturb_hdr_impl(orbit_x, orbit_y, dc_re, dc_im, dc_e, max_iter,
                      max_ref):
    shape = dc_re.shape
    dtype = dc_re.dtype
    n = jnp.int32(max_iter)
    dc = HDRComplex(dc_re, dc_im, dc_e)
    two56 = HDR(jnp.full(shape, 1.0, dtype), jnp.full(shape, 8, jnp.int32))

    def step(_, s):
        k, dzr, dzi, dze, j, it = s
        live = (it == k) & (k < n)
        dz = HDRComplex(dzr, dzi, dze)
        zj = HDRComplex(orbit_x[j], orbit_y[j], jnp.zeros_like(dze))
        # dz = (2Z + dz)·dz + dc, reduced (Fractal.cpp:2648-2654)
        t = hdr.complex_add(hdr.complex_mul_pow2(zj, 1), dz)
        ndz = hdr.reduce_complex(
            hdr.complex_add(hdr.complex_mul(t, dz), dc))
        j1 = j + 1
        zf = hdr.reduce_complex(hdr.complex_add(
            HDRComplex(orbit_x[j1], orbit_y[j1], jnp.zeros_like(dze)), ndz))
        nsq = hdr.reduce(hdr.norm_squared(zf))
        dsq = hdr.reduce(hdr.norm_squared(ndz))
        esc = hdr.gt_reduced(nsq, two56)
        reb = hdr.lt_reduced(nsq, dsq) | (j1 >= max_ref)
        upd = live & ~esc
        dzr = jnp.where(upd, jnp.where(reb, zf.re, ndz.re), dzr)
        dzi = jnp.where(upd, jnp.where(reb, zf.im, ndz.im), dzi)
        dze = jnp.where(upd, jnp.where(reb, zf.e, ndz.e), dze)
        j = jnp.where(upd, jnp.where(reb, 0, j1), j)
        it = it + upd.astype(jnp.int32)
        return k + 1, dzr, dzi, dze, j, it

    def cond(s):
        k, it = s[0], s[5]
        return jnp.logical_and(k < n,
                               jnp.max((it == k).astype(jnp.int32)) > 0)

    def chunk(s):
        return jax.lax.fori_loop(jnp.int32(0), jnp.int32(_INNER_STEPS),
                                 step, s)

    zero = hdr.complex_zero(shape, dtype)
    init = (jnp.int32(0), zero.re, zero.im, zero.e,
            jnp.zeros(shape, jnp.int32), jnp.zeros(shape, jnp.int32))
    _, _, _, _, _, iters = jax.lax.while_loop(cond, chunk, init)
    return iters.astype(jnp.uint32)


def perturb_render_hdr(results, ptz: PointZoomBBConverter,
                       width: int, height: int, max_iter: int,
                       sub_dtype=np.float32):
    ox, oy = results.device_orbit_jax(sub_dtype)
    dx, dy, cxo, cyo = delta_params(ptz, results.center_x, results.center_y,
                                    width, height)
    dc = _dc_grids_hdr(dx, dy, cxo, cyo, width, height, sub_dtype)
    return _perturb_hdr_impl(jnp.asarray(ox), jnp.asarray(oy),
                             dc.re, dc.im, dc.e, int(max_iter),
                             jnp.int32(results.max_ref_iteration()))
