"""Feature Finder: periodic-point (minibrot) detection + Newton–Raphson
/ Halley refinement at high precision.

Rebuild of ``FractalSharkLib/FeatureFinder.{h,cpp}`` (interface
``FeatureFinder.h:48-249``) and the high-precision orbit evaluator
``MpirOrbitEval.h:18-43`` (``EvaluateCriticalOrbitAndDerivs``):

* Phase A — candidate period: the dzdc periodicity test on the orbit of
  the view center (same math as ``PeriodicityChecker.h:46-76``).
* Phase B — refinement: Newton (c ← c − z_p/dzdc) or Halley (using the
  second derivative d2) on the critical orbit, at full precision, until
  the relative step falls below 2^-RelStepTol (2^-40 default,
  ``FeatureFinder.h:58``) — iterated with precision-doubling behavior.
* Checkpoint/resume of the refinement state (NRCheckpointData,
  ``FeatureFinder.h:25-39``).

The inner orbit evaluation is the same fixed-point big-int loop as the
host reference orbit; the device NTT pipeline can drop in
(the reference's NRInnerLoopBackend selects MPIR-MT vs GPU the same
way).
"""

from __future__ import annotations

import json
import math
import os
import time
from dataclasses import dataclass, field

from fractalshark_tpu.core.highprecision import HighPrecision
from fractalshark_tpu.core.hdr_host import HD
from fractalshark_tpu.core.pointzoom import PointZoomBBConverter

REL_STEP_TOL_BITS = 40  # FeatureFinder.h:58 (2^-40)


@dataclass
class FeatureSummary:
    """Found-feature record (FeatureSummary.h)."""
    center_x: HighPrecision
    center_y: HighPrecision
    period: int
    size_estimate: HD            # ~ minibrot scale
    residual_exp2: int           # log2 |z_period| at the nucleus
    nr_iterations: int
    wall_s: float
    diagnostics: dict = field(default_factory=dict)

    def zoom_factor(self) -> HighPrecision:
        """Zoom that frames the feature (a few× its size)."""
        e = -self.size_estimate.e + 4
        return HighPrecision.from_mant_exp(1, e, prec=64)


def evaluate_critical_orbit_and_derivs(cx: HighPrecision,
                                       cy: HighPrecision,
                                       period: int,
                                       prec: int,
                                       with_d2: bool = False,
                                       with_zcoeff: bool = False):
    """Iterate z ← z² + c from z = c for `period − 1` updates, tracking
    dzdc (and optionally d2 for Halley), all at `prec` bits fixed point.

    Returns (z, dzdc[, d2]) as (sign-int fixed-point) HighPrecision
    pairs. Matches EvaluateCriticalOrbitAndDerivsST
    (MpirOrbitEval.cpp): dzdc' = 2·z·dzdc + 1, d2' = 2·(dzdc² + z·d2),
    both updated BEFORE z (using current z).
    """
    F = prec + 16
    half = 1 << (F - 1)

    def to_fx(hp):
        sh = hp.exp + F
        if sh >= 0:
            return hp.mant << sh
        h2 = 1 << (-sh - 1)
        return (hp.mant + h2) >> (-sh) if hp.mant >= 0 else \
            -((-hp.mant + h2) >> (-sh))

    def m(a, b):
        return (a * b + half) >> F

    cxi = to_fx(cx)
    cyi = to_fx(cy)
    zx, zy = cxi, cyi
    dx_, dy_ = 1 << F, 0          # dzdc = 1
    d2x, d2y = 0, 0
    zcx, zcy = 1 << F, 0          # zcoeff = prod 2*z_i (cycle multiplier)

    one = 1 << F
    for _ in range(period - 1):
        if with_zcoeff:
            # zcoeff' = zcoeff * 2 z (same pre-update z as dzdc)
            nzcx = 2 * (m(zcx, zx) - m(zcy, zy))
            nzcy = 2 * (m(zcx, zy) + m(zcy, zx))
            zcx, zcy = nzcx, nzcy
        if with_d2:
            # d2' = 2 (dzdc² + z·d2)
            t1x = m(dx_, dx_) - m(dy_, dy_)
            t1y = 2 * m(dx_, dy_)
            t2x = m(zx, d2x) - m(zy, d2y)
            t2y = m(zx, d2y) + m(zy, d2x)
            d2x = 2 * (t1x + t2x)
            d2y = 2 * (t1y + t2y)
        # dzdc' = 2 z dzdc + 1
        ndx = 2 * (m(zx, dx_) - m(zy, dy_)) + one
        ndy = 2 * (m(zx, dy_) + m(zy, dx_))
        dx_, dy_ = ndx, ndy
        # z ← z² + c
        zx, zy = m(zx, zx) - m(zy, zy) + cxi, 2 * m(zx, zy) + cyi

    def fx_to_hp(v):
        return HighPrecision.from_mant_exp(v, -F, prec=prec)

    out = (fx_to_hp(zx), fx_to_hp(zy), fx_to_hp(dx_), fx_to_hp(dy_))
    if with_d2:
        out += (fx_to_hp(d2x), fx_to_hp(d2y))
    if with_zcoeff:
        out += (fx_to_hp(zcx), fx_to_hp(zcy))
    return out


def _cdiv(ax, ay, bx, by):
    """High-precision complex division (ax+i·ay)/(bx+i·by)."""
    den = bx * bx + by * by
    return (ax * bx + ay * by) / den, (ay * bx - ax * by) / den


@dataclass
class NRCheckpoint:
    """Serializable refinement state (NRCheckpointData,
    FeatureFinder.h:25-39)."""
    cx: str
    cy: str
    period: int
    step_index: int
    prec: int

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.__dict__, f)

    @staticmethod
    def load(path: str) -> "NRCheckpoint":
        with open(path) as f:
            return NRCheckpoint(**json.load(f))


def refine_periodic_point(cx: HighPrecision, cy: HighPrecision,
                          period: int, prec: int,
                          max_steps: int = 64,
                          method: str = "newton",
                          checkpoint_path: str | None = None,
                          start_step: int = 0,
                          backend: str = "host"):
    """Phase-B refinement (RefinePeriodicPoint_WithMPF,
    FeatureFinder.h:237): drive z_period(c) → 0.

    backend: "host" (fixed-point big ints) or "device" (the NTT
    pipeline's NR mode — the NRInnerLoopBackend GPU analogue,
    FeatureFinder.h NRInnerLoopBackend)."""
    t0 = time.perf_counter()
    cx = cx.with_precision(prec)
    cy = cy.with_precision(prec)
    steps = start_step
    last_step_exp = 0
    for _ in range(start_step, max_steps):
        use_d2 = method == "halley" and backend == "host"
        if backend == "device":
            from fractalshark_tpu.ops.bignum.orbit import \
                evaluate_critical_orbit_and_derivs_device
            ev = evaluate_critical_orbit_and_derivs_device(
                cx, cy, period, prec)
        else:
            ev = evaluate_critical_orbit_and_derivs(cx, cy, period, prec,
                                                    with_d2=use_d2)
        zx, zy, dx_, dy_ = ev[:4]
        if method == "halley" and len(ev) == 6:
            d2x, d2y = ev[4], ev[5]
            # Halley: step = z·dz / (dz² − z·d2/2)
            num_x = zx * dx_ - zy * dy_
            num_y = zx * dy_ + zy * dx_
            dz2x = dx_ * dx_ - dy_ * dy_
            dz2y = dx_ * dy_ * 2
            zd2x = (zx * d2x - zy * d2y).mul_pow2(-1)
            zd2y = (zx * d2y + zy * d2x).mul_pow2(-1)
            den_x = dz2x - zd2x
            den_y = dz2y - zd2y
            sx, sy = _cdiv(num_x, num_y, den_x, den_y)
        else:
            sx, sy = _cdiv(zx, zy, dx_, dy_)
        cx = cx - sx
        cy = cy - sy
        steps += 1
        if checkpoint_path:
            NRCheckpoint(cx=cx.to_string(), cy=cy.to_string(),
                         period=period, step_index=steps,
                         prec=prec).save(checkpoint_path)
        mags = [v.exponent2() for v in (sx, sy) if not v.is_zero()]
        step_mag = max(mags) if mags else -(10 ** 9)
        c_mag = max(cx.exponent2(), cy.exponent2())
        last_step_exp = step_mag
        # converged: |step| < |c|·2^-RelStepTol, or step below precision
        if (sx.is_zero() and sy.is_zero()) or \
                step_mag < c_mag - REL_STEP_TOL_BITS - prec // 2:
            break
    # residual + intrinsic size from the final derivatives: the
    # Imagina formula radius = 4 / |zcoeff * dzdc| with zcoeff the
    # cycle multiplier prod 2*z_i (ComputeIntrinsicRadius_HP,
    # FeatureFinder.cpp:1715-1740)
    zx, zy, dx_, dy_, zcx, zcy = evaluate_critical_orbit_and_derivs(
        cx, cy, period, prec, with_zcoeff=True)
    res_exp = max(zx.exponent2() if not zx.is_zero() else -prec,
                  zy.exponent2() if not zy.is_zero() else -prec)
    wr = zcx * dx_ - zcy * dy_
    wi = zcx * dy_ + zcy * dx_
    wmag = HD.from_hp((wr * wr + wi * wi).sqrt())
    size = HD(4.0, 0) * HD(1.0 / wmag.m, -wmag.e) if wmag.m else HD.zero()
    return FeatureSummary(
        center_x=cx, center_y=cy, period=period,
        size_estimate=size.reduce(), residual_exp2=res_exp,
        nr_iterations=steps, wall_s=time.perf_counter() - t0,
        diagnostics={"last_step_exp2": last_step_exp, "method": method})


def find_period_candidate(cx: HighPrecision, cy: HighPrecision,
                          radius: HighPrecision, max_period: int,
                          prec: int | None = None) -> int:
    """Phase A: the dzdc periodicity test along the orbit of (cx, cy)
    (Evaluate_FindPeriod, FeatureFinder.h:155; same math as the
    reference-orbit PeriodicityChecker). Returns 0 if none found."""
    from fractalshark_tpu.engine.reforbit import compute_reference_orbit
    prec = prec or max(cx.prec, cy.prec)
    res = compute_reference_orbit(cx, cy, max_period, radius,
                                  periodicity=True, precision_bits=prec)
    return res.period


def find_periodic_point(ptz: PointZoomBBConverter, max_period: int,
                        method: str = "newton",
                        checkpoint_path: str | None = None
                        ) -> FeatureSummary | None:
    """End-to-end feature find at the view center
    (Fractal::TryFindPeriodicPoint flow, SURVEY.md §3.4)."""
    from fractalshark_tpu.core.precision import precision_from_view
    prec = precision_from_view(ptz) + 64
    cx = ptz.pt_x.with_precision(prec)
    cy = ptz.pt_y.with_precision(prec)
    period = find_period_candidate(cx, cy, ptz.radius, max_period, prec)
    if period == 0:
        return None
    # the orbit's zero seed entry inflates the count by 1
    period = max(1, period - 1)
    return refine_periodic_point(cx, cy, period, prec, method=method,
                                 checkpoint_path=checkpoint_path)


def _pt_scan(results, dcx: float, dcy: float, rad, budget: int,
             n0: int = 0, dzx: float = 0.0, dzy: float = 0.0,
             j: int = 0, dzdc_x=None, dzdc_y=None) -> int:
    """Inner PT periodicity scan from an arbitrary starting state
    (iteration n0, delta (dzx, dzy) at orbit index j, dzdc carried in
    host-HDR). Returns the detected entry count or 0."""
    from fractalshark_tpu.core.hdr_host import HD
    ox, oy = results.orbit_plain()
    max_ref = results.max_ref_iteration()
    dzdc_x = HD.from_float(1.0) if dzdc_x is None else dzdc_x
    dzdc_y = HD.zero() if dzdc_y is None else dzdc_y
    for n in range(n0 + 1, budget + 1):
        tx = 2.0 * ox[j] + dzx
        ty = 2.0 * oy[j] + dzy
        ndzx = tx * dzx - ty * dzy + dcx
        ndzy = tx * dzy + ty * dzx + dcy
        j += 1
        zx = ox[j] + ndzx
        zy = oy[j] + ndzy
        azx = HD.from_float(abs(zx))
        azy = HD.from_float(abs(zy))
        n2 = azy if azx.lt(azy) else azx
        r0 = dzdc_y.abs() if dzdc_x.abs().lt(dzdc_y.abs())             else dzdc_x.abs()
        n3 = (rad * r0).mul_pow2(1)
        if n2.lt(n3):
            return n + 1              # entry-count convention
        if zx * zx + zy * zy > 256.0:
            return 0
        ndx = (dzdc_x.mul_float(zx) -
               dzdc_y.mul_float(zy)).mul_pow2(1) + HD.from_float(1.0)
        ndy = (dzdc_y.mul_float(zx) +
               dzdc_x.mul_float(zy)).mul_pow2(1)
        dzdc_x, dzdc_y = ndx, ndy
        if (zx * zx + zy * zy) < (ndzx * ndzx + ndzy * ndzy) or                 j >= max_ref:
            dzx, dzy = zx, zy
            j = 0
        else:
            dzx, dzy = ndzx, ndzy
    return 0


def find_period_candidate_la(results, la, cx: HighPrecision,
                             cy: HighPrecision,
                             radius: HighPrecision,
                             max_period: int) -> int:
    """Phase-A period detection via LA-ACCELERATED perturbation — the
    reference's third evaluator policy (FeatureFinderMode::LA,
    FeatureFinder.h:48-249): walk the stage-0 LA table, skipping
    step_length iterations per node while the periodicity test provably
    CANNOT fire inside the span (the candidate magnitude stays >=
    node.MinMag - LAThreshold, the firing bound needs
    2*radius*|dzdc|), and drop to the exact per-iteration PT evaluator
    the moment a span could contain the closest approach.  Finds the
    same period as the PT policy in O(#LA nodes) instead of O(period)
    work away from minima.

    dzdc across an LA skip follows the chain rule of the LA map
    z_{n+l} = Z_{n+l} + ZCoeff*dz(2Ref+dz) + CCoeff*dc:
    dzdc' = ZCoeff*(2Ref + 2dz)*dzdc + CCoeff."""
    from fractalshark_tpu.core.hdr_host import HD, HDC
    if la is None or not la.is_valid or la.stage_count < 1:
        dcx = float(cx - results.center_x)
        dcy = float(cy - results.center_y)
        rad = HD.from_hp(radius)
        budget = min(max_period, 2 * results.max_ref_iteration() + 2)
        return _pt_scan(results, dcx, dcy, rad, budget)
    dcx = float(cx - results.center_x)
    dcy = float(cy - results.center_y)
    dc = HDC.from_complex(complex(dcx, dcy))
    rad = HD.from_hp(radius)
    max_ref = results.max_ref_iteration()
    budget = min(max_period, 2 * max_ref + 2)

    s0 = la.stage_la_index[0]
    macro = la.stage_macro_it_count[0]
    nodes = la.las
    dz = HDC.from_complex(0.0)
    dzdc = HDC.from_complex(1.0)
    n = 0           # completed candidate iterations
    jn = 0          # stage-0 node index == macro position
    pos = 0         # orbit index of node jn
    while n < budget:
        node = nodes[s0 + jn]
        l = node.step_length
        # usability (LAInfoDeep::Prepare)
        newdz = (node.ref.mul_float(2.0) + dz) * dz
        usable = newdz.cheb().lt(node.la_threshold) and             dc.cheb().lt(node.la_threshold_c)
        # can the periodicity test fire inside this span?
        # |z_cand| >= MinMag - LAThreshold along the span; the bound is
        # 2*radius*|dzdc| with |dzdc'| <= |ZCoeff|*(2|Ref|+2|dz|)*|dzdc|
        # + |CCoeff| (margin 4x for slack)
        safe = False
        if usable:
            floor_mag = node.min_mag - node.la_threshold
            grow = node.zcoeff.cheb() * (
                node.ref.cheb() + dz.cheb()).mul_pow2(1)
            dzdc_end = grow * dzdc.cheb() + node.ccoeff.cheb()
            dmax = dzdc_end if dzdc.cheb().lt(dzdc_end) else dzdc.cheb()
            bound = (rad * dmax).mul_pow2(3)     # 2x test, 4x margin
            safe = bound.lt(floor_mag) and n + l <= budget
        if not safe:
            # exact evaluator from here on (minima live here)
            from fractalshark_tpu.core.hdr_host import HD as _HD
            dzf = dz.to_complex()
            return _pt_scan(results, dcx, dcy, rad, budget, n0=n,
                            dzx=dzf.real, dzy=dzf.imag, j=pos,
                            dzdc_x=_HD(dzdc.m.real, dzdc.e).reduce(),
                            dzdc_y=_HD(dzdc.m.imag, dzdc.e).reduce())
        # LA step (render-kernel semantics) + dzdc chain rule
        dzdc = node.zcoeff * (node.ref.mul_pow2(1) + dz.mul_pow2(1))             * dzdc + node.ccoeff
        dz_next = newdz * node.zcoeff + dc * node.ccoeff
        n += l
        jn += 1
        pos += l
        z_full = _node_ref(nodes, s0, jn, la, results, pos) + dz_next
        if z_full.cheb().lt(dz_next.cheb()) or jn >= macro:
            dz = z_full
            jn = 0
            pos = 0
        else:
            dz = dz_next
    return 0


def _node_ref(nodes, s0, jn, la, results, pos):
    """Reference value at the END of a stage-0 skip: node jn's Ref if
    in range, else the orbit value at the absolute position."""
    from fractalshark_tpu.core.hdr_host import HDC
    macro = la.stage_macro_it_count[0]
    if jn < macro and s0 + jn < len(nodes):
        return nodes[s0 + jn].ref
    i = min(pos, len(results.orbit_x) - 1)
    return HDC.from_complex(results.get_complex(i))


def find_period_candidate_pt(results, cx: HighPrecision,
                             cy: HighPrecision,
                             radius: HighPrecision,
                             max_period: int) -> int:
    """Phase-A period detection via PERTURBATION against an existing
    reference orbit (the reference's PT evaluator policy,
    FeatureFinderMode::PT — FeatureFinderOrchestrator.cpp:503): the
    candidate orbit is z_n = Z_n + δ_n with the f64 delta recurrence
    δ ← δ(2Z+δ) + dc and Zhuoran rebasing, dzdc tracked in host-HDR.
    O(period) float work per probe instead of O(period) big-float
    work — this is what makes 12×12 grid scans affordable.
    Returns the detected entry count (period + 1 convention of the
    direct path) or 0."""
    from fractalshark_tpu.core.hdr_host import HD
    ox, oy = results.orbit_plain()
    max_ref = results.max_ref_iteration()
    dcx = float(cx - results.center_x)
    dcy = float(cy - results.center_y)
    rad = HD.from_hp(radius)
    dzdc_x = HD.from_float(1.0)
    dzdc_y = HD.zero()
    dzx, dzy = 0.0, 0.0
    j = 0
    budget = min(max_period, 2 * max_ref + 2)
    for n in range(1, budget + 1):
        # dz ← dz(2Z + dz) + dc
        tx = 2.0 * ox[j] + dzx
        ty = 2.0 * oy[j] + dzy
        ndzx = tx * dzx - ty * dzy + dcx
        ndzy = tx * dzy + ty * dzx + dcy
        j += 1
        zx = ox[j] + ndzx
        zy = oy[j] + ndzy
        # periodicity test (PeriodicityChecker.h:46-76 semantics)
        azx = HD.from_float(abs(zx))
        azy = HD.from_float(abs(zy))
        n2 = azy if azx.lt(azy) else azx
        r0 = dzdc_y.abs() if dzdc_x.abs().lt(dzdc_y.abs()) \
            else dzdc_x.abs()
        n3 = (rad * r0).mul_pow2(1)
        if n2.lt(n3):
            return n + 1              # entry-count convention
        if zx * zx + zy * zy > 256.0:
            return 0
        ndx = (dzdc_x.mul_float(zx) -
               dzdc_y.mul_float(zy)).mul_pow2(1) + HD.from_float(1.0)
        ndy = (dzdc_y.mul_float(zx) +
               dzdc_x.mul_float(zy)).mul_pow2(1)
        dzdc_x, dzdc_y = ndx, ndy
        # Zhuoran rebase
        if (zx * zx + zy * zy) < (ndzx * ndzx + ndzy * ndzy) or \
                j >= max_ref:
            dzx, dzy = zx, zy
            j = 0
        else:
            dzx, dzy = ndzx, ndzy
    return 0


def find_periodic_points_scan(ptz: PointZoomBBConverter,
                              max_period: int,
                              grid: tuple[int, int] = (12, 12),
                              method: str = "newton",
                              backend: str = "host",
                              mode: str = "direct"
                              ) -> list[FeatureSummary]:
    """Grid-scan feature find: run the single-point finder at the
    center of each cell of an NX×NY grid over the current view,
    collecting every feature found (the reference's
    DirectScan/PTScan/LAScan modes, FeatureFinderOrchestrator.cpp:537:
    cell centers at (2g+1)/(2N) screen fractions, candidate radius =
    view half-height / 12).

    mode: "direct" evaluates each candidate with a full-precision
    orbit; "pt" builds ONE reference orbit at the view center and
    probes every cell with the f64 perturbation evaluator
    (find_period_candidate_pt) — the FeatureFinderMode::PT policy;
    "la" additionally builds an LA table and probes with the
    LA-accelerated evaluator (find_period_candidate_la) — the
    FeatureFinderMode::LA policy."""
    from fractalshark_tpu.core.precision import precision_from_view
    nx, ny = grid
    prec = precision_from_view(ptz) + 64
    span_x = ptz.max_x - ptz.min_x
    span_y = ptz.max_y - ptz.min_y
    radius = (span_y / HighPrecision(2)) / HighPrecision(12)
    results = None
    la = None
    if mode in ("pt", "la"):
        from fractalshark_tpu.engine.reforbit import \
            compute_reference_orbit
        results = compute_reference_orbit(
            ptz.pt_x.with_precision(prec), ptz.pt_y.with_precision(prec),
            max_period, radius, periodicity=False, precision_bits=prec)
    if mode == "la":
        from fractalshark_tpu.core.hdr_host import HD
        from fractalshark_tpu.engine.la_reference import LAReferenceHost
        la = LAReferenceHost.generate_auto(
            results.orbit_x, results.orbit_y, HD.from_hp(radius))
    found: list[FeatureSummary] = []
    for gy in range(ny):
        fy = HighPrecision(2 * gy + 1) / HighPrecision(2 * ny)
        cy = (ptz.max_y - span_y * fy).with_precision(prec)
        for gx in range(nx):
            fx = HighPrecision(2 * gx + 1) / HighPrecision(2 * nx)
            cx = (ptz.min_x + span_x * fx).with_precision(prec)
            if mode == "la":
                period = find_period_candidate_la(results, la, cx, cy,
                                                  radius, max_period)
            elif mode == "pt":
                period = find_period_candidate_pt(results, cx, cy,
                                                  radius, max_period)
            else:
                period = find_period_candidate(cx, cy, radius,
                                               max_period, prec)
            if period == 0:
                continue
            try:
                fs = refine_periodic_point(cx, cy, max(1, period - 1),
                                           prec, method=method,
                                           backend=backend)
            except Exception:
                continue
            found.append(fs)
    return found


def resume_refinement(checkpoint_path: str, max_steps: int = 64,
                      method: str = "newton") -> FeatureSummary:
    ck = NRCheckpoint.load(checkpoint_path)
    return refine_periodic_point(
        HighPrecision(ck.cx, prec=ck.prec),
        HighPrecision(ck.cy, prec=ck.prec),
        ck.period, ck.prec, max_steps=max_steps, method=method,
        checkpoint_path=checkpoint_path, start_step=ck.step_index)
