"""LAv2 per-pixel kernel: AT head-skip → LA stage stepping → perturbation
tail with rebasing.

Vectorized re-design of the flagship deep-zoom kernel
(``FractalSharkGpuLib/LAKernel.cuh:7-180``; CPU mirror
``Fractal.cpp:2530-2680``). The per-pixel control flow (walk stages
coarse→fine, step LA nodes while usable, drop a stage on unusable,
rebase when |z| < |dz|, finish with plain perturbation) becomes a single
masked while-loop over a per-pixel state machine:

    stage s ∈ [stage_count-1 .. 0]: LA stepping; s = -1: tail
    j = node offset within the stage (sentinel -1 = "just entered
    stage, take j from ref_iter"); ref_iter = node/orbit index handed
    to the next stage on exit.

LA node data is gathered per pixel from flat (mantissa, exp) arrays —
the device analogue of GPU_LAReference.
"""

from __future__ import annotations

import functools
import time

import jax
import jax.numpy as jnp
import numpy as np

from fractalshark_tpu.core.pointzoom import PointZoomBBConverter
from fractalshark_tpu.ops import hdrfloat as hdr
from fractalshark_tpu.ops.hdrfloat import HDR, HDRComplex
from fractalshark_tpu.ops.perturb import _dc_grids_hdr, delta_params


def _gather_complex(m, e, idx) -> HDRComplex:
    return HDRComplex(m[idx, 0], m[idx, 1], e[idx])


def _gather_hdr(m, e, idx) -> HDR:
    return HDR(m[idx], e[idx])


# Per-node LA data is packed into ONE [N, 16] array so the hot loop
# pays a single gather per body step instead of ~12 (each gather from a
# device-memory table is latency-bound).  Integer columns are bitcast
# (f32) or exactly converted (f64).  Column layout:
#   0-2  Ref   (re, im, exp)         9  LAThreshold mantissa
#   3-5  ZCoeff                     10  LAThreshold exp
#   6-8  CCoeff                     11  step_length
#  13-15 Ref[node+1]                12  next_stage_la_index
_PACK_COLS = 16


def _pack_nodes(arrs, sub_dtype):
    n = arrs["ref_e"].shape[0]
    f32 = np.dtype(sub_dtype) == np.float32

    def ibits(a):
        a = np.ascontiguousarray(a.astype(np.int32))
        return a.view(np.float32) if f32 else a.astype(np.float64)

    P = np.empty((n, _PACK_COLS), sub_dtype)
    P[:, 0] = arrs["ref_m"][:, 0]
    P[:, 1] = arrs["ref_m"][:, 1]
    P[:, 2] = ibits(arrs["ref_e"])
    P[:, 3] = arrs["zc_m"][:, 0]
    P[:, 4] = arrs["zc_m"][:, 1]
    P[:, 5] = ibits(arrs["zc_e"])
    P[:, 6] = arrs["cc_m"][:, 0]
    P[:, 7] = arrs["cc_m"][:, 1]
    P[:, 8] = ibits(arrs["cc_e"])
    P[:, 9] = arrs["thr_m"]
    P[:, 10] = ibits(arrs["thr_e"])
    P[:, 11] = ibits(arrs["step_length"].astype(np.int64))
    P[:, 12] = ibits(arrs["next_stage_la_index"])
    # Ref[min(node+1, n-1)] folded into the same row: saves the second
    # complex gather in the LA step
    P[:-1, 13:16] = P[1:, 0:3]
    P[-1, 13:16] = P[-1, 0:3]
    return P


def _pack_orbit(ox, oy, max_ref):
    n = len(ox)
    m = min(n, max_ref + 1)
    OP = np.empty((m, 4), ox.dtype)
    OP[:, 0] = ox[:m]
    OP[:, 1] = oy[:m]
    OP[:m - 1, 2] = ox[1:m]
    OP[:m - 1, 3] = oy[1:m]
    OP[m - 1, 2] = ox[m - 1]
    OP[m - 1, 3] = oy[m - 1]
    return OP


@functools.partial(jax.jit, static_argnames=("max_iter", "la_only",
                                             "chunk_steps", "force_wide"))
def _lav2_impl(orbit_packed, dc_re, dc_im, dc_e,
               packed, side64, thrc_m, thrc_e,
               stage_la_index, stage_macro,
               at_args, max_ref, stage_count, at_step,
               max_iter, la_only, chunk_steps=0, resume_state=None,
               force_wide=False):
    """`stage_count` and `at_step` are TRACED i32 scalars, so views
    whose tables share shapes share one executable.  `stage_cap` =
    len(stage_la_index) bounds the stage walk; live stages occupy
    [0, stage_count) and `s` starts at stage_count-1."""
    shape = dc_re.shape
    dtype = dc_re.dtype
    n_nodes = packed.shape[0]
    stage_cap = int(stage_la_index.shape[0])

    if dtype == jnp.float32:
        def ibits(col):
            return jax.lax.bitcast_convert_type(col, jnp.int32)
    else:
        def ibits(col):
            return col.astype(jnp.int32)
    # iteration counters AND orbit positions: i32 when the budget
    # allows (half the bytes per carried array); budgets >= 2^31 use the
    # 64-bit path.  ref_iter shares it_t: LA skips keep it <= the
    # budget (within_budget gates every step, rebases reset to 0), so
    # positions can only exceed 2^31 when the budget does — the
    # View #27 class (period ~28e9, 10^15-iteration budgets) runs
    # everything through the i64 variant.
    it_t = (jnp.int64 if max_iter >= (1 << 31) or force_wide
            else jnp.int32)
    n = it_t(max_iter)
    dc = HDRComplex(dc_re, dc_im, dc_e)
    dc_cheb = hdr.reduce(hdr.chebychev_norm(dc))
    two56 = HDR(jnp.full(shape, 1.0, dtype), jnp.full(shape, 8, jnp.int32))

    # ---------------- stage validity, precomputed per pixel ------------
    # invalid iff |dc| >= LAThresholdC of the stage's first node
    # (GPU_LAReference.h:243-255)
    stage_valid = []
    for s in range(stage_cap):
        idx0 = stage_la_index[s]
        thrc0 = HDR(jnp.broadcast_to(thrc_m[idx0], shape),
                    jnp.broadcast_to(thrc_e[idx0], shape))
        stage_valid.append(hdr.lt_reduced(dc_cheb, thrc0))
    if stage_cap:
        stage_valid_arr = jnp.stack(stage_valid)  # [S, H, W]
    else:
        stage_valid_arr = jnp.zeros((1,) + shape, bool)

    # ---------------- AT head skip (ATInfo.h:157-188) ------------------
    it0 = jnp.zeros(shape, it_t)
    dz0 = hdr.complex_zero(shape, dtype)
    if at_args is not None and resume_state is None:
        (at_thrc, at_sqr_esc, at_refc, at_cc, at_invzc) = at_args

        def bc_c(v):
            return HDRComplex(jnp.full(shape, v[0], dtype),
                              jnp.full(shape, v[1], dtype),
                              jnp.full(shape, v[2], jnp.int32))

        def bc_s(v):
            return HDR(jnp.full(shape, v[0], dtype),
                       jnp.full(shape, v[1], jnp.int32))

        at_ok = hdr.lte_reduced(dc_cheb, bc_s(at_thrc))
        c_at = hdr.reduce_complex(hdr.complex_add(
            hdr.complex_mul(dc, bc_c(at_cc)), bc_c(at_refc)))
        # traced at_step: guard the degenerate 0 (AT absent but the
        # executable compiled with the AT path) — no macro-steps run
        at_step_t = jnp.maximum(at_step, 1).astype(it_t)
        at_max_it = jnp.where(at_step > 0,
                              it_t(max_iter) // at_step_t, it_t(0))
        sqr_esc = bc_s(at_sqr_esc)

        def at_cond(s):
            i, _, _, _, active = s
            return jnp.logical_and(i < at_max_it,
                                   jnp.max(active.astype(jnp.int32)) > 0)

        def at_body(s):
            i, zr, zi, ze, active = s
            z = HDRComplex(zr, zi, ze)
            nsq = hdr.reduce(hdr.norm_squared(z))
            esc = hdr.gt_reduced(nsq, sqr_esc)
            cont = active & ~esc
            nz = hdr.reduce_complex(hdr.complex_add(hdr.complex_sqr(z), c_at))
            zr = jnp.where(cont, nz.re, zr)
            zi = jnp.where(cont, nz.im, zi)
            ze = jnp.where(cont, nz.e, ze)
            return i + 1, zr, zi, ze, cont

        z0 = hdr.complex_zero(shape, dtype)
        steps_taken = jnp.zeros(shape, jnp.int32)

        # count steps per pixel: a pixel's step count = number of body
        # iterations while it stayed active
        def at_body_counting(s):
            i, zr, zi, ze, active, cnt = s
            i2, zr2, zi2, ze2, cont = at_body((i, zr, zi, ze, active))
            return i2, zr2, zi2, ze2, cont, cnt + cont.astype(jnp.int32)

        def at_cond_counting(s):
            return at_cond((s[0], s[1], s[2], s[3], s[4]))

        _, zr, zi, ze, _, cnt = jax.lax.while_loop(
            at_cond_counting, at_body_counting,
            (it_t(0), z0.re, z0.im, z0.e, at_ok, steps_taken))
        zend = HDRComplex(zr, zi, ze)
        dz_at = hdr.reduce_complex(hdr.complex_mul(zend, bc_c(at_invzc)))
        it0 = jnp.where(at_ok, cnt.astype(it_t) * at_step_t, it0)
        dz0 = HDRComplex(jnp.where(at_ok, dz_at.re, dz0.re),
                         jnp.where(at_ok, dz_at.im, dz0.im),
                         jnp.where(at_ok, dz_at.e, dz0.e))

    # ---------------- main state machine --------------------------------
    if resume_state is None:
        s0 = jnp.broadcast_to((stage_count - 1).astype(jnp.int32), shape)
        j0 = jnp.full(shape, 0, jnp.int32)   # top stage entered with j=0
        ref0 = jnp.zeros(shape, it_t)
        done0 = it0 >= n
        init_state = (s0, j0, ref0, dz0.re, dz0.im, dz0.e, it0, done0)
    else:
        init_state = resume_state

    def cond(st):
        k, inner = st
        not_done = jnp.max((~inner[-1]).astype(jnp.int32)) > 0
        if chunk_steps:
            return jnp.logical_and(k < chunk_steps, not_done)
        return not_done

    def body_inner(st):
        (s, j, ref_iter, dzr, dzi, dze, it, done) = st
        dz = HDRComplex(dzr, dzi, dze)
        live = ~done
        in_la = live & (s >= 0)
        in_tail = live & (s < 0)

        # ---------------- LA branch -----------------------------------
        s_idx = jnp.clip(s, 0, max(stage_cap - 1, 0))
        la_index = stage_la_index[s_idx]
        macro = stage_macro[s_idx]
        valid = jnp.take_along_axis(
            stage_valid_arr, s_idx[None, ...], axis=0)[0] if stage_cap \
            else jnp.zeros(shape, bool)
        entering = j < 0
        # ref_iter while in LA is a node index (< n_nodes, i32-safe);
        # only the FINAL stage-0 exit writes an orbit position into it
        j_eff = jnp.where(entering, ref_iter.astype(jnp.int32), j)
        node = jnp.clip(la_index + j_eff, 0, n_nodes - 1)

        g = packed[node]                       # ONE gather: (H, W, 16)
        ref = HDRComplex(g[..., 0], g[..., 1], ibits(g[..., 2]))
        thr = HDR(g[..., 9], ibits(g[..., 10]))
        if side64 is not None:
            # 64-bit budgets: step lengths AND next-stage indices can
            # exceed 2^31 (top stages of period-billions tables; stage-0
            # next indices are orbit positions up to the period itself —
            # View #27 class) — the packed columns' 32-bit bitcasts
            # would wrap negative (ADVICE r2 #2), so both ride one
            # int64 side table (one extra gather, 64-bit path only)
            sg = side64[node]
            l = sg[..., 0]
            nsi_w = sg[..., 1]
        else:
            l = ibits(g[..., 11]).astype(it_t)
            nsi_w = ibits(g[..., 12])
        # newdz = dz*(2*Ref + dz)   (LAInfoDeep::Prepare)
        t = hdr.complex_add(hdr.complex_mul_pow2(ref, 1), dz)
        newdz = hdr.reduce_complex(hdr.complex_mul(t, dz))
        within_budget = (it + l) <= n
        prepared_ok = hdr.lt_reduced(
            hdr.reduce(hdr.chebychev_norm(newdz)), thr)
        usable = within_budget & prepared_ok

        # stage drop: invalid stage, or unusable node
        drop_invalid = in_la & ~valid
        drop_unusable = in_la & valid & ~usable
        do_step = in_la & valid & usable

        # on unusable: ref_iter = node's NextStageLAIndex
        ref_iter = jnp.where(drop_unusable, nsi_w.astype(it_t), ref_iter)
        s = jnp.where(drop_invalid | drop_unusable, s - 1, s)
        j = jnp.where(drop_invalid | drop_unusable, -1, j)

        # LA step: dz' = newdz*ZCoeff + dc*CCoeff ; z = Ref[node+1] + dz'
        zc = HDRComplex(g[..., 3], g[..., 4], ibits(g[..., 5]))
        cc = HDRComplex(g[..., 6], g[..., 7], ibits(g[..., 8]))
        dz_ev = hdr.reduce_complex(hdr.complex_add(
            hdr.complex_mul(newdz, zc), hdr.complex_mul(dc, cc)))
        refp1 = HDRComplex(g[..., 13], g[..., 14], ibits(g[..., 15]))
        z_full = hdr.reduce_complex(hdr.complex_add(refp1, dz_ev))
        j_next = j_eff + 1
        reb = hdr.lt_reduced(hdr.reduce(hdr.chebychev_norm(z_full)),
                             hdr.reduce(hdr.chebychev_norm(dz_ev))) | \
            (j_next >= macro)
        dz_la = HDRComplex(jnp.where(reb, z_full.re, dz_ev.re),
                           jnp.where(reb, z_full.im, dz_ev.im),
                           jnp.where(reb, z_full.e, dz_ev.e))
        j_la = jnp.where(reb, 0, j_next)
        it_la = it + l

        # ---------------- tail branch ----------------------------------
        oj = jnp.clip(ref_iter, 0, max_ref)
        og = orbit_packed[oj]                  # ONE gather: (H, W, 4)
        zj = HDRComplex(og[..., 0], og[..., 1],
                        jnp.zeros(shape, jnp.int32))
        t2 = hdr.complex_add(hdr.complex_mul_pow2(zj, 1), dz)
        ndz = hdr.reduce_complex(
            hdr.complex_add(hdr.complex_mul(t2, dz), dc))
        zf = hdr.reduce_complex(hdr.complex_add(
            HDRComplex(og[..., 2], og[..., 3],
                       jnp.zeros(shape, jnp.int32)), ndz))
        nsq = hdr.reduce(hdr.norm_squared(zf))
        dsq = hdr.reduce(hdr.norm_squared(ndz))
        esc = hdr.gt_reduced(nsq, two56)
        treb = hdr.lt_reduced(nsq, dsq) | ((ref_iter + 1) >= max_ref)
        tail_upd = in_tail & ~esc
        dz_tail = HDRComplex(jnp.where(treb, zf.re, ndz.re),
                             jnp.where(treb, zf.im, ndz.im),
                             jnp.where(treb, zf.e, ndz.e))
        ref_tail = jnp.where(treb, 0, ref_iter + 1)

        # ---------------- merge ----------------------------------------
        dzr = jnp.where(do_step, dz_la.re,
                        jnp.where(tail_upd, dz_tail.re, dzr))
        dzi = jnp.where(do_step, dz_la.im,
                        jnp.where(tail_upd, dz_tail.im, dzi))
        dze = jnp.where(do_step, dz_la.e,
                        jnp.where(tail_upd, dz_tail.e, dze))
        j = jnp.where(do_step, j_la, j)
        ref_iter = jnp.where(tail_upd, ref_tail, ref_iter)
        it = jnp.where(do_step, it_la,
                       jnp.where(tail_upd, it + 1, it))

        done = done | (in_tail & esc) | (it >= n)
        if la_only:
            # LAO mode: no perturbation tail — a pixel finishing LA is done
            done = done | (live & (s < 0))
        return s, j, ref_iter, dzr, dzi, dze, it, done

    def body(st):
        k, inner = st
        return k + 1, body_inner(inner)

    k_fin, out = jax.lax.while_loop(cond, body,
                                    (jnp.int32(0), init_state))
    all_done = jnp.min(out[-1].astype(jnp.int32)) > 0
    return out, all_done, k_fin


# written by la_perturb_render after every render (module-level on
# purpose: the hot-path return signature stays state-only)
last_run_stats: dict = {}


def default_chunk_steps(width: int, height: int) -> int:
    """Default body steps per dispatch, inversely proportional to the
    pixel count so one dispatch stays bounded (seconds, not minutes) and
    the host gets regular abort points.  The constant was sized for an
    earlier accelerator; not measured on the H100."""
    return max(64, (1 << 25) // max(1, width * height))


def chunk_ladder(chunk_steps: int) -> tuple:
    """STATIC chunk-size ladder (each rung its own cached compile)."""
    return (int(chunk_steps), int(chunk_steps) * 4,
            int(chunk_steps) * 16) if chunk_steps else (0,)


def next_rung(rung: int, dispatch_s: float, n_rungs: int) -> int:
    """Escalate after a fast dispatch, de-escalate after a slow one, so
    relaunch round trips stop dominating a frame while a single dispatch
    stays bounded.  The 0.8 s / 4 s thresholds are not measured on the
    H100."""
    if dispatch_s < 0.8 and rung < n_rungs - 1:
        return rung + 1
    if dispatch_s > 4.0 and rung > 0:
        return rung - 1
    return rung


def la_perturb_render(results, la, ptz: PointZoomBBConverter,
                      width: int, height: int, max_iter: int,
                      sub_dtype=np.float32, la_only: bool = False,
                      chunk_steps: int | None = None,
                      abort_monitor=None, return_state: bool = False,
                      force_wide: bool = False):
    """Full LAv2 render: AT skip → LA stages → perturbation tail.

    The state machine runs in bounded *chunks* of body steps with host
    relaunches between them (the reference's chunked cooperative-kernel
    relaunch, ``RefOrbitCalc.cpp:2205-2233``): a single unbounded
    dispatch can run for minutes on deep views and trip device
    watchdogs; chunking also gives the abort points the server and the
    render pool rely on.  ``chunk_steps=0`` runs one undivided
    dispatch."""
    arrs = la.device_arrays(sub_dtype)
    ox, oy = results.device_orbit(sub_dtype)
    dx, dy, cxo, cyo = delta_params(ptz, results.center_x,
                                    results.center_y, width, height)
    dc = _dc_grids_hdr(dx, dy, cxo, cyo, width, height, sub_dtype)

    at_args = None
    if la.use_at and la.at is not None:
        at = la.at

        def c3(z):
            return (np.asarray(z.m.real, sub_dtype),
                    np.asarray(z.m.imag, sub_dtype),
                    np.int32(z.e))

        def s2(v):
            return (np.asarray(v.m, sub_dtype), np.int32(v.e))

        at_args = (s2(at.threshold_c), s2(at.sqr_escape_radius),
                   c3(at.ref_c), c3(at.ccoeff), c3(at.inv_zcoeff))
        at_step = int(at.step_length)
    else:
        at_step = 0

    if chunk_steps is None:
        chunk_steps = default_chunk_steps(width, height)
    max_ref = results.max_ref_iteration()

    # generation-keyed device cache: the packed node/orbit tables are
    # uploaded once per (la, dtype) and live as long as the LA table
    # (PerturbResultsCollection analogue)
    cache = getattr(la, "_packed_cache", None)
    if cache is None:
        cache = la._packed_cache = {}
    key = np.dtype(sub_dtype).name
    if key not in cache:
        cache[key] = (
            jnp.asarray(_pack_nodes(arrs, sub_dtype)),
            jnp.asarray(_pack_orbit(np.asarray(ox), np.asarray(oy),
                                    int(max_ref))),
            jnp.asarray(arrs["thrc_m"]),
            jnp.asarray(arrs["thrc_e"]),
            jnp.asarray(arrs["stage_la_index"]),
            jnp.asarray(arrs["stage_macro_it_count"]))
    (packed_dev, orbit_dev, thrcm_dev, thrce_dev, sli_dev,
     smic_dev) = cache[key]
    # 64-bit budgets: side int64 [step_length, next_stage_la_index]
    # table (the packed columns wrap at 2^31; ADVICE r2 #2 — and
    # stage-0 next indices are orbit positions up to the period)
    side64_dev = None
    # wide also when the ORBIT is long (ref positions exceed i32 even
    # under a small per-pixel budget — View #27-class probes)
    wide = (int(max_iter) >= (1 << 31) or int(max_ref) >= (1 << 31)
            or force_wide)
    if wide:
        k64 = "side64"
        if k64 not in cache:
            cache[k64] = jnp.asarray(np.stack(
                [arrs["step_length"].astype(np.int64),
                 arrs["next_stage_la_index"].astype(np.int64)],
                axis=1))
        side64_dev = cache[k64]
    args = (
        orbit_dev,
        dc.re, dc.im, dc.e,
        packed_dev, side64_dev,
        thrcm_dev, thrce_dev, sli_dev, smic_dev,
        at_args,
        (jnp.int64 if wide else jnp.int32)(max_ref),
        jnp.int32(int(arrs["stage_count"])),
        jnp.int32(at_step))
    kw = dict(max_iter=int(max_iter), la_only=bool(la_only),
              chunk_steps=int(chunk_steps), force_wide=bool(wide))
    # STATIC chunk-size ladder (each rung its own cached compile): the
    # base rung bounds a cold dispatch; escalate after MEASURING a fast
    # one (next_rung)
    ladder = chunk_ladder(chunk_steps)
    rung = 0
    dispatches = 1
    full_steps = 0
    t0 = time.perf_counter()
    state, all_done, k_fin = _lav2_impl(*args, **kw)
    while not bool(all_done):
        if abort_monitor is not None and abort_monitor.aborted():
            break
        # a non-final dispatch ran its FULL chunk budget (cond stops at
        # k == chunk_steps), so steps are known host-side — only the
        # final partial count needs its k_fin readback (below, once)
        full_steps += int(kw["chunk_steps"])
        rung = next_rung(rung, time.perf_counter() - t0, len(ladder))
        kw["chunk_steps"] = int(ladder[rung])
        t0 = time.perf_counter()
        state, all_done, k_fin = _lav2_impl(*args, **kw,
                                            resume_state=state)
        dispatches += 1
    # perf forensics for drivers/benches: lockstep body steps are the
    # whole phase-1 cost model (one packed gather each), so the step
    # count IS the workload (DESIGN ch.17)
    last_run_stats["body_steps"] = full_steps + int(k_fin)
    last_run_stats["dispatches"] = dispatches
    if return_state:
        return state
    iters = state[6]
    return iters.astype(jnp.uint64 if max_iter >= (1 << 31)
                        else jnp.uint32)
