"""Gather-based RC tail (ops/rc_tail.py) differential tests.

The gather tail reconstructs reference values in true f64 — the same
values as ``CompressedOrbit.decompress()`` — so a two-phase render
through it must be BIT-IDENTICAL to the one-kernel LA machine on the
decompressed orbit (which consumes f32(decompressed f64)).
"""

import numpy as np
import pytest

from fractalshark_tpu.core.hdr_host import HD
from fractalshark_tpu.core.pointzoom import PointZoomBBConverter
from fractalshark_tpu.engine import native_la as NL
from fractalshark_tpu.engine.la_reference import LAParameters
from fractalshark_tpu.engine.perturbation_results import (
    CompressedOrbit, PerturbationResults)
from fractalshark_tpu.engine.reforbit import RefOrbitCalc
from fractalshark_tpu.ops import la_kernel
from fractalshark_tpu.ops.rc_tail import rc_tail_gather

pytestmark = pytest.mark.skipif(not NL.available(),
                                reason="native toolchain missing")

ORBIT_LEN = 2048
BUDGET = 12_000           # wraps the truncated orbit several times
SIZE = 16


@pytest.fixture(scope="module")
def mini():
    ptz = PointZoomBBConverter(
        pt_x="-0.743643887037158704752191506114774",
        pt_y="0.131825904205311970493132056385139",
        zoom_factor="1e13", prec=512).square_aspect_ratio(SIZE, SIZE)
    calc = RefOrbitCalc()
    res = calc.get_and_create_useful_results(ptz, 50_000)
    res_t = PerturbationResults(
        center_x=res.center_x, center_y=res.center_y,
        orbit_x=res.orbit_x[:ORBIT_LEN], orbit_y=res.orbit_y[:ORBIT_LEN],
        max_radius=res.max_radius, period=0, escaped_at=0,
        max_iterations=ORBIT_LEN, precision_bits=res.precision_bits)
    comp = CompressedOrbit.from_uncompressed(res_t, error_exp=20)
    params = LAParameters(period_divisor=8, low_bound=1)
    la = NL.generate_native_rc(comp, HD.from_hp(res_t.max_radius),
                               params=params)
    assert la is not None and la.is_valid
    return ptz, res_t, comp, la


def _handoff(res_t, la, ptz, comp):
    state = la_kernel.la_perturb_render(
        _rc_results(res_t, comp), la, ptz, SIZE, SIZE, BUDGET,
        sub_dtype=np.float32, la_only=True, return_state=True)
    _, _, ref_iter, dzr, dzi, dze, it, _ = state
    it64 = np.asarray(it).astype(np.int64)
    return {"dzr": np.asarray(dzr), "dzi": np.asarray(dzi),
            "dze": np.asarray(dze), "it": it64,
            "jwait": np.asarray(ref_iter).astype(np.int64),
            "done": (it64 >= BUDGET).astype(np.int32)}


def _rc_results(res_t, comp):
    dx, dy = comp.decompress()
    return PerturbationResults(
        center_x=res_t.center_x, center_y=res_t.center_y,
        orbit_x=dx, orbit_y=dy, max_radius=res_t.max_radius,
        period=0, escaped_at=0, max_iterations=ORBIT_LEN,
        precision_bits=res_t.precision_bits)


def test_gather_tail_matches_one_kernel_machine(mini):
    """Gather tail after the LA phase == the one-kernel full LAv2 on
    the decompressed orbit: both consume f32(decompressed-f64) values,
    so the grids must be bit-identical."""
    ptz, res_t, comp, la = mini
    res_rc = _rc_results(res_t, comp)
    full = np.asarray(la_kernel.la_perturb_render(
        res_rc, la, ptz, SIZE, SIZE, BUDGET, sub_dtype=np.float32))

    init = _handoff(res_t, la, ptz, comp)
    out = np.asarray(rc_tail_gather(
        comp, res_t.center_x, res_t.center_y, ptz, SIZE, SIZE, BUDGET,
        init_state=init))
    np.testing.assert_array_equal(out, full)
    o = out.astype(np.int64)
    assert o.max() >= 2 * ORBIT_LEN  # the tail really wrapped the orbit


def test_gather_tail_identity_anchors_match_one_kernel(mini):
    """ratio-1 anchors: every orbit position is stored, so the tail
    reads the uncompressed values — the grid equals the one-kernel
    machine on the (truncated) uncompressed orbit."""
    ptz, res_t, comp, la = mini
    ident = CompressedOrbit.identity(res_t)
    full = np.asarray(la_kernel.la_perturb_render(
        res_t, la, ptz, SIZE, SIZE, BUDGET, sub_dtype=np.float32))
    state = la_kernel.la_perturb_render(
        res_t, la, ptz, SIZE, SIZE, BUDGET, sub_dtype=np.float32,
        la_only=True, return_state=True)
    _, _, ref_iter, dzr, dzi, dze, it, _ = state
    it64 = np.asarray(it).astype(np.int64)
    init = {"dzr": np.asarray(dzr), "dzi": np.asarray(dzi),
            "dze": np.asarray(dze), "it": it64,
            "jwait": np.asarray(ref_iter).astype(np.int64),
            "done": (it64 >= BUDGET).astype(np.int32)}
    out = np.asarray(rc_tail_gather(
        ident, res_t.center_x, res_t.center_y, ptz, SIZE, SIZE, BUDGET,
        init_state=init))
    np.testing.assert_array_equal(out, full)


def test_two_phase_render_gather_tail_plumbing(mini):
    """two_phase_render routes phase 2 through rc_tail_gather and
    matches the one-kernel machine — the exact composition
    tools/view27_render.py runs at period-28B scale."""
    from fractalshark_tpu.engine.renderers import two_phase_render

    ptz, res_t, comp, la = mini
    res_rc = _rc_results(res_t, comp)
    full = np.asarray(la_kernel.la_perturb_render(
        res_rc, la, ptz, SIZE, SIZE, BUDGET, sub_dtype=np.float32))
    out = np.asarray(two_phase_render(
        res_rc, la, ptz, SIZE, SIZE, BUDGET, comp=comp))
    np.testing.assert_array_equal(out, full)


def test_gather_tail_chunked_matches_one_dispatch(mini):
    """The wrapping tail suspended every 32 steps == one dispatch."""
    ptz, res_t, comp, la = mini
    init = _handoff(res_t, la, ptz, comp)
    one = np.asarray(rc_tail_gather(
        comp, res_t.center_x, res_t.center_y, ptz, SIZE, SIZE, BUDGET,
        init_state=dict(init), chunk_steps=0))
    many = np.asarray(rc_tail_gather(
        comp, res_t.center_x, res_t.center_y, ptz, SIZE, SIZE, BUDGET,
        init_state=init, chunk_steps=32))
    np.testing.assert_array_equal(many, one)


def test_gather_tail_rejects_empty_orbit(mini):
    ptz, res_t, comp, la = mini
    empty = CompressedOrbit(
        anchors_x=comp.anchors_x[:0], anchors_y=comp.anchors_y[:0],
        anchor_index=comp.anchor_index[:0], total_count=0,
        cx_low=comp.cx_low, cy_low=comp.cy_low, error_exp=comp.error_exp)
    with pytest.raises(ValueError):
        rc_tail_gather(empty, res_t.center_x, res_t.center_y, ptz, SIZE,
                       SIZE, BUDGET)


def test_gather_tail_budget_exhaustion(mini):
    """Pixels that exhaust the budget mid-tail report exactly max_iter
    (the capped-pixel convention shared with the sweep path)."""
    ptz, res_t, comp, la = mini
    small = 2200   # just past one orbit length: most pixels cap
    state = la_kernel.la_perturb_render(
        _rc_results(res_t, comp), la, ptz, SIZE, SIZE, small,
        sub_dtype=np.float32, la_only=True, return_state=True)
    _, _, ref_iter, dzr, dzi, dze, it, _ = state
    it64 = np.asarray(it).astype(np.int64)
    init = {"dzr": np.asarray(dzr), "dzi": np.asarray(dzi),
            "dze": np.asarray(dze), "it": it64,
            "jwait": np.asarray(ref_iter).astype(np.int64),
            "done": (it64 >= small).astype(np.int32)}
    out = np.asarray(rc_tail_gather(
        comp, res_t.center_x, res_t.center_y, ptz, SIZE, SIZE, small,
        init_state=init)).astype(np.int64)
    assert out.max() == small
    assert out.min() > 0
