"""Gather-based RC perturbation tail: jump to each pixel's orbit
position in the compressed reference orbit.

Runtime decompression (the reference decompresses inside the
per-pixel kernel, ``FractalSharkGpuLib/Perturb.cuh:8-120``): the
device holds only the anchor table of a ``CompressedOrbit``, never the
uncompressed orbit.  Each pixel jumps straight to its own position —
one vectorized ``searchsorted`` finds the last anchor ≤ its start
position, a short *catch-up* phase replays the low-precision recurrence
across the anchor gap (average span = compression ratio), and the
perturbation tail then runs with one packed anchor-probe gather per
step.  Cost is proportional to PER-PIXEL WORK, independent of orbit
length, so the same tail serves a View #30 orbit (period 669,773) and a
View #27 orbit (period 28,311,731,137 —
``Notes/FractalShark-06-RefOrbit.tex:740-747``).

Reconstruction runs in true f64 — identical values to
``CompressedOrbit.decompress()`` (the host shadow) — so a render
through this tail is bit-identical to the one-kernel LA machine on the
decompressed orbit (tests/test_rc_tail.py).

The perturbation arithmetic (HDR with f32 or f64 mantissas, escape at
256, rebase on |z| < |dz| or orbit end) follows the reference tail loop
(``FractalSharkGpuLib/Perturb.cuh``).  The tail starts either from fresh
pixels (a plain RC perturbation render) or from an LA-phase handoff
(``init_state``, two-phase LAv2).
"""

from __future__ import annotations

import functools
import time

import jax
import jax.numpy as jnp
import numpy as np

from fractalshark_tpu.core.pointzoom import PointZoomBBConverter
from fractalshark_tpu.ops import hdrfloat as hdr
from fractalshark_tpu.ops.hdrfloat import HDRComplex
from fractalshark_tpu.ops.la_kernel import (chunk_ladder, default_chunk_steps,
                                            next_rung)
from fractalshark_tpu.ops.perturb import _dc_grids_hdr, delta_params


def _pack_anchors(compressed) -> np.ndarray:
    """[M, 3] f64: (x, y, orbit index).  The index rides as f64 — exact
    for any real orbit (2^53 >> the 28.3e9 View #27 period) — so the
    per-step pos+1 probe is ONE gather instead of three."""
    ax = np.asarray(compressed.anchors_x, np.float64)
    ay = np.asarray(compressed.anchors_y, np.float64)
    ai = np.asarray(compressed.anchor_index, np.float64)
    return np.ascontiguousarray(np.stack([ax, ay, ai], axis=1))


def _orbit_value_at(compressed, idx: int) -> tuple[float, float]:
    """Z[idx] reconstructed from the anchor set: last anchor ≤ idx, then
    the f64 low-precision recurrence forward (exact when every entry is
    an anchor; within compression-span error bounds otherwise,
    PerturbationResultsHelpers.h:51-161).  Cached per (orbit, idx): the
    handoff init evaluates it every frame."""
    cache = getattr(compressed, "_zat_cache", None)
    if cache is None:
        cache = {}
        try:
            compressed._zat_cache = cache
        except AttributeError:
            cache = None
    if cache is not None and idx in cache:
        return cache[idx]
    ai = compressed.anchor_index
    k = int(np.searchsorted(ai, idx, side="right")) - 1
    zx = float(compressed.anchors_x[k])
    zy = float(compressed.anchors_y[k])
    for _ in range(idx - int(ai[k])):
        zx, zy = (zx * zx - zy * zy + compressed.cx_low,
                  2.0 * zx * zy + compressed.cy_low)
    if cache is not None:
        cache[idx] = (zx, zy)
    return zx, zy


@jax.jit
def _init_state(packed, dzr, dzi, dze, it, jw, dn, zx_mr, zy_mr,
                max_iter, max_ref):
    """Start state → gather-tail state, one executable.  jwait ==
    max_ref is the LA machine's WRAP position — rebase there
    (dz ← Z[max_ref] + dz, position 0) without consuming an iteration.
    The mantissa dtype follows ``zx_mr``."""
    dt = zx_mr.dtype
    dzr = dzr.astype(dt)
    dzi = dzi.astype(dt)
    dze = dze.astype(jnp.int32)
    it = it.astype(jnp.int64)
    jw = jw.astype(jnp.int64)
    dn = dn.astype(jnp.int32)
    shape = jw.shape

    wrap = (jw >= max_ref) & (dn == 0)
    zmr = HDRComplex(jnp.full(shape, zx_mr, dt),
                     jnp.full(shape, zy_mr, dt),
                     jnp.zeros(shape, jnp.int32))
    zf = hdr.reduce_complex(hdr.complex_add(
        zmr, HDRComplex(dzr, dzi, dze)))
    dzr = jnp.where(wrap, zf.re, dzr)
    dzi = jnp.where(wrap, zf.im, dzi)
    dze = jnp.where(wrap, zf.e, dze)
    pos = jnp.where(wrap, jnp.int64(0),
                    jnp.clip(jw, 0, jnp.maximum(max_ref - 1, 0)))

    # last anchor ≤ pos, then the catch-up distance across the gap
    aidx = packed[:, 2]
    aptr = (jnp.searchsorted(aidx, pos.astype(jnp.float64),
                             side="right") - 1).astype(jnp.int32)
    aptr = jnp.maximum(aptr, 0)
    g = packed[aptr]
    zx = g[..., 0]
    zy = g[..., 1]
    catch = (pos - g[..., 2].astype(jnp.int64)).astype(jnp.int32)

    rem = jnp.maximum(max_iter - it, 0)
    done = jnp.where((dn > 0) | (rem == 0), jnp.int32(1), jnp.int32(0))
    return dzr, dzi, dze, rem, pos, done, aptr, zx, zy, catch


@functools.partial(jax.jit, static_argnames=("chunk_steps",))
def _tail_impl(packed, dcr, dci, dce, state, cx64, cy64, a0x, a0y,
               max_ref, chunk_steps):
    """Budget-bounded resumable dispatch of the gather-tail state
    machine (same relaunch pattern as ``la_kernel._lav2_impl``)."""
    n_anchor = packed.shape[0]
    dt = dcr.dtype
    dc = HDRComplex(dcr, dci, dce)

    def cond(c):
        # carry layout: (k, dzr, dzi, dze, rem, pos, done, aptr, ...)
        k = c[0]
        done = c[6]
        not_done = jnp.min(done) < 1
        if chunk_steps:
            return jnp.logical_and(k < chunk_steps, not_done)
        return not_done

    def body(c):
        (k, dzr, dzi, dze, rem, pos, done, aptr, zx, zy, catch) = c
        live = done < 1
        catching = live & (catch > 0)
        stepping = live & (catch == 0)

        # shared low-precision recurrence from the current (zx, zy) —
        # the catch-up advance AND the step's Z[pos+1] candidate
        rx = zx * zx - zy * zy + cx64
        ry = 2.0 * zx * zy + cy64

        # ---- perturbation step (HDR) ----
        probe = jnp.clip(aptr + 1, 0, n_anchor - 1)
        g = packed[probe]                       # ONE gather: (H, W, 3)
        hit = stepping & (g[..., 2] == (pos + 1).astype(jnp.float64))
        znx = jnp.where(hit, g[..., 0], rx)
        zny = jnp.where(hit, g[..., 1], ry)

        shape = dzr.shape
        dz = HDRComplex(dzr, dzi, dze)
        zj = HDRComplex(zx.astype(dt), zy.astype(dt),
                        jnp.zeros(shape, jnp.int32))
        t = hdr.complex_add(hdr.complex_mul_pow2(zj, 1), dz)
        ndz = hdr.reduce_complex(
            hdr.complex_add(hdr.complex_mul(t, dz), dc))
        zf = hdr.reduce_complex(hdr.complex_add(
            HDRComplex(znx.astype(dt), zny.astype(dt),
                       jnp.zeros(shape, jnp.int32)), ndz))
        nsq = hdr.norm_squared(zf)
        dsq = hdr.norm_squared(ndz)
        esc = hdr.gt_pow2_unreduced(nsq, 8)
        at_wrap = (pos + 1) >= max_ref
        reb = hdr.lt_unreduced(nsq, dsq) | at_wrap

        esc_px = stepping & esc
        upd = stepping & ~esc
        reb_px = upd & reb
        adv = upd & ~reb

        dzr = jnp.where(upd, jnp.where(reb, zf.re, ndz.re), dzr)
        dzi = jnp.where(upd, jnp.where(reb, zf.im, ndz.im), dzi)
        dze = jnp.where(upd, jnp.where(reb, zf.e, ndz.e), dze)
        rem = jnp.where(upd, rem - 1, rem)
        exhausted = upd & (rem == 0)
        done = jnp.where(esc_px | exhausted, jnp.int32(1), done)

        pos = jnp.where(adv, pos + 1, jnp.where(reb_px, 0, pos))
        # reconstruction advance: catch-up replays the recurrence;
        # a stepped pixel moves to Z[pos+1]; a rebase restarts at
        # anchor 0 (orbit position 0 is always stored)
        zx = jnp.where(catching | adv, jnp.where(catching, rx, znx),
                       jnp.where(reb_px, a0x, zx))
        zy = jnp.where(catching | adv, jnp.where(catching, ry, zny),
                       jnp.where(reb_px, a0y, zy))
        aptr = jnp.where(adv, aptr + hit.astype(jnp.int32),
                         jnp.where(reb_px, 0, aptr))
        catch = jnp.where(catching, catch - 1,
                          jnp.where(reb_px, 0, catch))
        return (k + 1, dzr, dzi, dze, rem, pos, done, aptr, zx, zy,
                catch)

    k_fin, *out = jax.lax.while_loop(
        cond, body, (jnp.int32(0),) + tuple(state))
    all_done = jnp.min(out[5]) > 0
    return tuple(out), all_done, k_fin


def rc_tail_gather(compressed, center_x, center_y,
                   ptz: PointZoomBBConverter,
                   width: int, height: int, max_iter: int,
                   init_state: dict | None = None,
                   chunk_steps: int | None = None,
                   abort_monitor=None, sub_dtype=np.float32):
    """Perturbation render from a ``CompressedOrbit``.  ``init_state``
    is None for fresh pixels (dz = 0 at orbit position 0, no iterations
    spent), or an LA-phase handoff: 'dzr','dzi','dze' (HDR delta),
    'it' (completed iterations), 'jwait' (orbit position to resume at),
    'done' — all [height, width].  Returns per-pixel iteration counts
    (uint32, or uint64 for budgets >= 2^31)."""
    if len(compressed.anchors_x) == 0:
        raise ValueError("compressed orbit has no anchors")
    assert int(compressed.anchor_index[0]) == 0, \
        "anchor 0 must be orbit position 0 (rebase target)"
    sub = np.dtype(sub_dtype).type
    packed = jnp.asarray(_pack_anchors(compressed))
    max_ref = int(compressed.total_count) - 1

    dx, dy, cxo, cyo = delta_params(ptz, center_x, center_y,
                                    width, height)
    dc = _dc_grids_hdr(dx, dy, cxo, cyo, width, height, sub)

    if init_state is None:
        # fresh pixels start at position 0: no wrap rebase to prepare
        zx_mr = zy_mr = 0.0
        zero = np.zeros((height, width), sub)
        init_state = {"dzr": zero, "dzi": zero,
                      "dze": np.full((height, width), hdr.MIN_BIG_EXPONENT,
                                     np.int32),
                      "it": np.zeros((height, width), np.int64),
                      "jwait": np.zeros((height, width), np.int64),
                      "done": np.zeros((height, width), np.int32)}
    else:
        zx_mr, zy_mr = _orbit_value_at(compressed, max_ref)
    state = _init_state(
        packed, init_state["dzr"], init_state["dzi"], init_state["dze"],
        init_state["it"], init_state["jwait"], init_state["done"],
        sub(zx_mr), sub(zy_mr), jnp.int64(max_iter), jnp.int64(max_ref))

    if chunk_steps is None:
        chunk_steps = default_chunk_steps(width, height)
    args = (packed, dc.re, dc.im, dc.e)
    consts = (jnp.float64(compressed.cx_low),
              jnp.float64(compressed.cy_low),
              jnp.float64(compressed.anchors_x[0]),
              jnp.float64(compressed.anchors_y[0]),
              jnp.int64(max_ref))
    ladder = chunk_ladder(int(chunk_steps))
    rung = 0
    t0 = time.perf_counter()
    state, all_done, _ = _tail_impl(*args, state, *consts,
                                    chunk_steps=ladder[0])
    while not bool(all_done):
        if abort_monitor is not None and abort_monitor.aborted():
            break
        rung = next_rung(rung, time.perf_counter() - t0, len(ladder))
        t0 = time.perf_counter()
        state, all_done, _ = _tail_impl(*args, state, *consts,
                                        chunk_steps=ladder[rung])
    rem = np.asarray(state[3]).astype(np.int64)
    it = np.int64(max_iter) - rem
    if max_iter < (1 << 31):
        return jnp.asarray(it.astype(np.uint32))
    return jnp.asarray(it.astype(np.uint64))
