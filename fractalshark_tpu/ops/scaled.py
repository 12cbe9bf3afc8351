"""Scaled (f32) perturbation with glitch detection and selective
re-render.

The reference's scaled kernels (``FractalSharkGpuLib/ScaledKernels.cuh``)
run float/2×32 deltas against a double orbit and mark orbit entries
"Bad" where float underflow corrupts the recurrence; pixels touching a
bad entry re-render at higher precision (SURVEY.md A.8,
``RefOrbitCalc.cpp:553-560,1930-1940``).

Structure: one wide f32 pass tracking a per-pixel glitch
flag (OR of bad[j] over visited entries), then a second masked pass in
HDR for the glitched set only. No per-pixel rescaling machinery: the
second pass IS the higher-precision path, and masked lockstep means
the clean pixels cost nothing there.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from fractalshark_tpu.core.pointzoom import PointZoomBBConverter
from fractalshark_tpu.ops import perturb

FLOAT_MIN_NORMAL = 1.1754944e-38  # RefOrbitCalc.cpp:472
GLITCH_EPS = 1e-7                  # RefOrbitCalc.cpp:474


def bad_flags(orbit_x: np.ndarray, orbit_y: np.ndarray) -> np.ndarray:
    """PerturbExtras::Bad flags per orbit entry: set when |zx|, |zy| or
    |z|²·1e-7 underflows the f32 minimum normal (A.8)."""
    ax = np.abs(orbit_x)
    ay = np.abs(orbit_y)
    norm = (orbit_x * orbit_x + orbit_y * orbit_y) * GLITCH_EPS
    bad = (ax <= FLOAT_MIN_NORMAL) | (ay <= FLOAT_MIN_NORMAL) | \
        (norm <= FLOAT_MIN_NORMAL)
    # the zero seed entry is never iterated against directly post-rebase
    bad = bad.copy()
    bad[0] = False
    return bad


@functools.partial(jax.jit, static_argnames=("max_iter",))
def _perturb_f32_glitch_impl(orbit_x, orbit_y, bad, dcx, dcy, max_iter,
                             max_ref):
    shape = dcx.shape
    n = jnp.int32(max_iter)

    def step(_, s):
        k, dzx, dzy, j, it, glitch = s
        live = (it == k) & (k < n)
        zx = orbit_x[j]
        zy = orbit_y[j]
        glitch = glitch | (live & bad[j])
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
        return k + 1, dzx, dzy, j, it, glitch

    def cond(s):
        k, it = s[0], s[4]
        return jnp.logical_and(k < n,
                               jnp.max((it == k).astype(jnp.int32)) > 0)

    def chunk(s):
        return jax.lax.fori_loop(jnp.int32(0), jnp.int32(8), step, s)

    init = (jnp.int32(0), jnp.zeros_like(dcx), jnp.zeros_like(dcy),
            jnp.zeros(shape, jnp.int32), jnp.zeros(shape, jnp.int32),
            jnp.zeros(shape, bool))
    _, _, _, _, iters, glitch = jax.lax.while_loop(cond, chunk, init)
    return iters.astype(jnp.uint32), glitch


def perturb_render_scaled(results, ptz: PointZoomBBConverter,
                          width: int, height: int, max_iter: int,
                          return_stats: bool = False):
    """Two-pass scaled render: f32 + glitch tracking, HDR repair pass."""
    ox64, oy64 = results.device_orbit(np.float64)
    bad = bad_flags(ox64, oy64)
    dx, dy, cxo, cyo = perturb.delta_params(
        ptz, results.center_x, results.center_y, width, height)
    dcx, dcy = perturb._dc_grids_float(dx, dy, cxo, cyo, width, height,
                                       np.float32)
    iters32, glitch = _perturb_f32_glitch_impl(
        jnp.asarray(ox64.astype(np.float32)),
        jnp.asarray(oy64.astype(np.float32)),
        jnp.asarray(bad), dcx, dcy, int(max_iter),
        jnp.int32(results.max_ref_iteration()))
    glitch_np = np.asarray(glitch)
    n_glitched = int(glitch_np.sum())
    out = np.asarray(iters32)
    if n_glitched:
        # repair pass: HDR render, then take glitched pixels from it
        hdr_iters = np.asarray(perturb.perturb_render_hdr(
            results, ptz, width, height, max_iter,
            sub_dtype=np.float64))
        out = np.where(glitch_np, hdr_iters, out)
    if return_stats:
        return jnp.asarray(out), {"glitched_pixels": n_glitched,
                                  "bad_entries": int(bad.sum())}
    return jnp.asarray(out)
