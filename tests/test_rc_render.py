"""Runtime-decompression renders: the gather tail (ops/rc_tail.py) from
fresh pixels and from an LA handoff, against the XLA perturbation
kernel and the one-kernel LAv2 machine, and the engine's RC routes
(which must never upload the uncompressed orbit)."""

import numpy as np
import pytest

from fractalshark_tpu.core.hdr_host import HD
from fractalshark_tpu.core.pointzoom import PointZoomBBConverter
from fractalshark_tpu.engine.la_reference import LAReferenceHost
from fractalshark_tpu.engine.perturbation_results import (
    CompressedOrbit, PerturbationResults, VirtualResults)
from fractalshark_tpu.engine.reforbit import RefOrbitCalc
from fractalshark_tpu.ops import la_kernel, perturb
from fractalshark_tpu.ops.rc_tail import rc_tail_gather

DEEP = dict(pt_x="-0.743643887037158704752191506114774",
            pt_y="0.131825904205311970493132056385139",
            zoom_factor="1e8", prec=512)


@pytest.fixture(scope="module")
def deep():
    ptz = PointZoomBBConverter(**DEEP).square_aspect_ratio(64, 64)
    res = RefOrbitCalc().get_and_create_useful_results(ptz, 2000)
    la = LAReferenceHost.generate(res.orbit_x, res.orbit_y,
                                  HD.from_hp(res.max_radius))
    assert la.is_valid
    return ptz, res, la


def _rc(comp, res, ptz, w, h, n, **kw):
    return np.asarray(rc_tail_gather(comp, res.center_x, res.center_y,
                                     ptz, w, h, n, **kw))


def _handoff(res, la, ptz, w, h, n):
    _, _, ref_iter, dzr, dzi, dze, it, _ = la_kernel.la_perturb_render(
        res, la, ptz, w, h, n, sub_dtype=np.float32, la_only=True,
        return_state=True)
    it = np.asarray(it).astype(np.int64)
    return {"dzr": np.asarray(dzr), "dzi": np.asarray(dzi),
            "dze": np.asarray(dze), "it": it,
            "jwait": np.asarray(ref_iter).astype(np.int64),
            "done": (it >= n).astype(np.int32)}


@pytest.mark.parametrize("w,h,n", [(64, 64, 2000), (50, 37, 1000),
                                   (32, 32, 1800)])
def test_rc_fresh_matches_xla_bit_exact(deep, w, h, n):
    """Identity anchors from fresh pixels == the XLA HDR perturbation
    kernel on the uncompressed orbit (incl. non-square, odd dims)."""
    ptz, res, _ = deep
    got = _rc(CompressedOrbit.identity(res), res, ptz, w, h, n)
    want = np.asarray(perturb.perturb_render_hdr(
        res, ptz, w, h, n, sub_dtype=np.float32))
    np.testing.assert_array_equal(got, want)


def test_rc_fresh_f64_mantissas_match_xla(deep):
    """HDR with f64 mantissas from fresh pixels == the XLA kernel at
    sub_dtype f64 (identity anchors: exact reference values)."""
    ptz, res, _ = deep
    got = _rc(CompressedOrbit.identity(res), res, ptz, 32, 32, 1800,
              sub_dtype=np.float64)
    want = np.asarray(perturb.perturb_render_hdr(
        res, ptz, 32, 32, 1800, sub_dtype=np.float64))
    np.testing.assert_array_equal(got, want)


def test_compressed_orbit_cached_per_threshold(deep):
    from fractalshark_tpu.engine.renderers import compressed_orbit
    _, res, _ = deep
    a = compressed_orbit(res, 20)
    assert compressed_orbit(res, 20) is a
    b = compressed_orbit(res, 8)
    assert b is not a and len(b.anchors_x) < len(a.anchors_x)


def test_rc_default_threshold_exact(deep):
    """At the reference default error exponent (20) the f64
    reconstruction is f32-exact: the RC render equals the uncompressed
    render."""
    ptz, res, _ = deep
    comp = CompressedOrbit.from_uncompressed(res, error_exp=20)
    assert comp.compression_ratio() > 1.5, "want real compression"
    got = _rc(comp, res, ptz, 48, 48, 1800)
    want = np.asarray(perturb.perturb_render_hdr(
        res, ptz, 48, 48, 1800, sub_dtype=np.float32))
    np.testing.assert_array_equal(got, want)


def test_rc_coarse_threshold_matches_decompressed(deep):
    """A coarse threshold (long recomputed spans): the tail reads exactly
    the values ``decompress()`` produces, so it equals the XLA kernel on
    the decompressed orbit."""
    ptz, res, _ = deep
    comp = CompressedOrbit.from_uncompressed(res, error_exp=8)
    dx, dy = comp.decompress()
    dec = PerturbationResults(
        center_x=res.center_x, center_y=res.center_y, orbit_x=dx,
        orbit_y=dy, max_radius=res.max_radius, period=res.period,
        escaped_at=res.escaped_at, max_iterations=res.max_iterations,
        precision_bits=res.precision_bits)
    got = _rc(comp, res, ptz, 48, 48, 1800)
    want = np.asarray(perturb.perturb_render_hdr(
        dec, ptz, 48, 48, 1800, sub_dtype=np.float32))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("chunk_steps", [7, 64])
def test_rc_chunked_relaunch_bit_exact(deep, chunk_steps):
    """Small dispatch budgets force many relaunches through the resumable
    state; the grid must not change."""
    ptz, res, _ = deep
    comp = CompressedOrbit.from_uncompressed(res, error_exp=20)
    one = _rc(comp, res, ptz, 32, 32, 1500, chunk_steps=0)
    many = _rc(comp, res, ptz, 32, 32, 1500, chunk_steps=chunk_steps)
    np.testing.assert_array_equal(many, one)


def test_lav2_rc_two_phase_matches_full(deep):
    """LA phase to tail entry, then the tail from the compressed orbit:
    reproduces the one-kernel FULL LAv2 render at the default error
    exponent."""
    ptz, res, la = deep
    n = 1800
    full = np.asarray(la_kernel.la_perturb_render(
        res, la, ptz, 32, 32, n, sub_dtype=np.float32))
    comp = CompressedOrbit.from_uncompressed(res, error_exp=20)
    rc = _rc(comp, res, ptz, 32, 32, n,
             init_state=_handoff(res, la, ptz, 32, 32, n))
    assert (rc == full).mean() >= 0.995


def test_identity_two_phase_matches_full_exactly(deep):
    """Identity anchors (every entry stored) make the tail an exact
    evaluator: two-phase == the one-kernel machine pixel for pixel."""
    ptz, res, la = deep
    n = 1800
    full = np.asarray(la_kernel.la_perturb_render(
        res, la, ptz, 32, 32, n, sub_dtype=np.float32))
    two = _rc(CompressedOrbit.identity(res), res, ptz, 32, 32, n,
              init_state=_handoff(res, la, ptz, 32, 32, n))
    np.testing.assert_array_equal(two, full)


def test_abort_monitor_semantics(deep):
    """A live (non-aborted) monitor must NOT stop the render (the
    .aborted attribute is a METHOD — regression for truthiness bugs); a
    pre-aborted monitor stops between dispatches."""
    from fractalshark_tpu.utils.aux import AbortMonitor

    ptz, res, _ = deep
    comp = CompressedOrbit.identity(res)
    mon = AbortMonitor()
    try:
        ref = _rc(comp, res, ptz, 32, 32, 1200, chunk_steps=0)
        full = _rc(comp, res, ptz, 32, 32, 1200, chunk_steps=8,
                   abort_monitor=mon)
        np.testing.assert_array_equal(full, ref)
        mon.flag.set()
        partial = _rc(comp, res, ptz, 32, 32, 1200, chunk_steps=8,
                      abort_monitor=mon)
        assert partial.sum() < ref.sum()
    finally:
        mon.close()


def _escaping_view():
    """Every pixel escapes within ~40 iterations (center well outside
    the set) — a >2^31 budget exercises the 64-bit paths without ever
    running 2^31 steps."""
    ptz = PointZoomBBConverter(pt_x="0.8", pt_y="0.5",
                               zoom_factor="100", prec=128)
    res = RefOrbitCalc().get_and_create_useful_results(ptz, 1000)
    return ptz, res


def test_rc_64bit_budget_matches_32bit():
    """A >2^31 budget: identical per-pixel counts to a small-budget
    render on an everywhere-escaping view, returned as uint64."""
    ptz, res = _escaping_view()
    comp = CompressedOrbit.from_uncompressed(res, error_exp=20)
    small = _rc(comp, res, ptz, 24, 16, 1900)
    got = _rc(comp, res, ptz, 24, 16, (1 << 31) + 7)
    assert got.dtype == np.uint64
    assert (small < 1900).all()
    np.testing.assert_array_equal(got.astype(np.int64),
                                  small.astype(np.int64))


def test_rc_orbit_positions_beyond_2_31():
    """A compressed orbit whose TOTAL COUNT exceeds 2^31 entries (View
    #27 class): int64 positions address it without overflow; every
    pixel escapes within the live prefix, so counts equal the plain
    short-orbit render."""
    ptz, res = _escaping_view()
    ident = CompressedOrbit.identity(res)
    comp = CompressedOrbit(
        anchors_x=ident.anchors_x, anchors_y=ident.anchors_y,
        anchor_index=ident.anchor_index, total_count=(1 << 31) + 4096,
        cx_low=ident.cx_low, cy_low=ident.cy_low,
        error_exp=ident.error_exp)
    got = _rc(comp, res, ptz, 16, 24, 1700)
    want = np.asarray(perturb.perturb_render_hdr(
        res, ptz, 16, 24, 1700, sub_dtype=np.float32))
    assert (want < 1700).all(), "view must escape everywhere"
    np.testing.assert_array_equal(got.astype(np.int64),
                                  want.astype(np.int64))


@pytest.mark.parametrize("rung,dt,want", [
    (0, 0.1, 1),     # fast -> escalate
    (2, 0.1, 2),     # clamp at the top
    (1, 2.0, 1),     # mid-range -> hold
    (2, 9.0, 1),     # slow -> de-escalate
    (0, 9.0, 0),     # clamp at the bottom
])
def test_dispatch_ladder(rung, dt, want):
    assert la_kernel.chunk_ladder(128) == (128, 512, 2048)
    assert la_kernel.chunk_ladder(0) == (0,)
    assert la_kernel.next_rung(rung, dt, 3) == want


def test_virtual_results_two_phase_matches_real(deep):
    """VirtualResults (CompressedOrbit-only input — the View #27 class
    where the uncompressed orbit never exists): the la_only LA phase
    never touches the orbit arrays, so phase-1 state from the 1-row
    dummy orbit equals the real-results state, and the tail from that
    handoff equals the one-kernel FULL LAv2 render."""
    from fractalshark_tpu.engine.renderers import two_phase_render

    ptz, res, la = deep
    n = 1800
    ident = CompressedOrbit.identity(res)
    virt = VirtualResults.from_compressed(ident, res.center_x,
                                          res.center_y)
    kw = dict(sub_dtype=np.float32, la_only=True, return_state=True)
    sr = la_kernel.la_perturb_render(res, la, ptz, 24, 24, n, **kw)
    la2 = LAReferenceHost.generate(res.orbit_x, res.orbit_y,
                                   HD.from_hp(res.max_radius))
    sv = la_kernel.la_perturb_render(virt, la2, ptz, 24, 24, n, **kw)
    for i, (a, b) in enumerate(zip(sr, sv)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b),
                                      err_msg=f"state[{i}]")
    full = np.asarray(la_kernel.la_perturb_render(
        res, la, ptz, 24, 24, n, sub_dtype=np.float32))
    two = np.asarray(two_phase_render(virt, la2, ptz, 24, 24, n,
                                      comp=ident))
    np.testing.assert_array_equal(two, full)


@pytest.mark.parametrize("rc_name,plain_name,error_exp", [
    ("GpuHDRx32PerturbedRCLAv2", "GpuHDRx32PerturbedLAv2", 20),
    ("GpuHDRx32PerturbedRCLAv2PO", "GpuHDRx32PerturbedLAv2PO", 20),
    ("GpuHDRx32PerturbedRCLAv2LAO", "GpuHDRx32PerturbedLAv2LAO", 20),
    ("GpuHDRx64PerturbedRCLAv2", "GpuHDRx64PerturbedLAv2", 40),
    ("Gpu1x32PerturbedRCLAv2", "Gpu1x32PerturbedLAv2", 20),
    ("Gpu2x32PerturbedRCLAv2", "Gpu2x32PerturbedLAv2", 20),
    ("Cpu32PerturbedRCBLAV2HDR", "Cpu32PerturbedBLAV2HDR", 20),
])
def test_rc_algorithms_render_from_compressed_orbit(monkeypatch, rc_name,
                                                    plain_name, error_exp):
    """Every RC algorithm renders from the compressed orbit: no device
    upload of the uncompressed orbit happens, and the image matches the
    non-RC algorithm.  f64-mantissa variants need a finer compression
    threshold than the default 20 (10^-20 on squared values only keeps
    ~33 bits, below f64 precision)."""
    from fractalshark_tpu.engine.fractal import Fractal

    ptz = PointZoomBBConverter(**DEEP)
    plain = Fractal(24, 24, view=ptz, algorithm=plain_name,
                    num_iterations=1500)
    want = np.asarray(plain.calc_fractal())
    rc = Fractal(24, 24, view=ptz, algorithm=rc_name, num_iterations=1500,
                 compression_error_exp=error_exp)
    rc._orbit_cache = plain._orbit_cache      # same orbit, host-side

    def no_upload(*a, **k):
        raise AssertionError("uncompressed orbit uploaded")

    monkeypatch.setattr(PerturbationResults, "device_orbit", no_upload)
    monkeypatch.setattr(PerturbationResults, "device_orbit_jax",
                        no_upload)
    got = np.asarray(rc.calc_fractal())
    assert rc.benchmark.extra["kernel"].startswith(("rc", "lav2-rc"))
    assert got.dtype == want.dtype
    assert (got == want).mean() >= 0.995
