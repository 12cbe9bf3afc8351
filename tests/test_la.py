"""LAv2 tests: table construction invariants + render agreement with
the perturbation-only path (the reference pins LAv2 correctness the
same way: CrummyTest renders views across algorithm pairs)."""

import numpy as np
import pytest

from fractalshark_tpu.core.hdr_host import HD, HDC
from fractalshark_tpu.core.pointzoom import PointZoomBBConverter
from fractalshark_tpu.engine.la_reference import (LAParameters,
                                                  LAReferenceHost,
                                                  _composite, _new_node,
                                                  _step)
from fractalshark_tpu.engine.reforbit import RefOrbitCalc
from fractalshark_tpu.ops import la_kernel, perturb


@pytest.fixture(scope="module")
def deep_view():
    ptz = PointZoomBBConverter(
        pt_x="-0.743643887037158704752191506114774",
        pt_y="0.131825904205311970493132056385139",
        zoom_factor="1e8", prec=512).square_aspect_ratio(32, 32)
    calc = RefOrbitCalc()
    res = calc.get_and_create_useful_results(ptz, 3000)
    la = LAReferenceHost.generate(res.orbit_x, res.orbit_y,
                                  HD.from_hp(res.max_radius))
    return ptz, res, la


def test_node_step_algebra():
    """Step: ZCoeff *= 2z, CCoeff = 2z·CCoeff + 1 (LAInfoDeep.h:230-239),
    thresholds shrink monotonically."""
    p = LAParameters()
    z1 = HDC.from_complex(0.5 + 0.25j)
    node = _new_node(p, HDC.zero())
    n1, _ = _step(p, node, z1)
    # ZCoeff = 2*z1*1
    np.testing.assert_allclose(
        abs(n1.zcoeff.to_complex() - 2 * (0.5 + 0.25j)), 0, atol=1e-15)
    # CCoeff = 2*z1*1 + 1
    np.testing.assert_allclose(
        abs(n1.ccoeff.to_complex() - (2 * (0.5 + 0.25j) + 1)), 0, atol=1e-15)
    z2 = HDC.from_complex(-0.3 + 0.7j)
    n2, _ = _step(p, n1, z2)
    np.testing.assert_allclose(
        abs(n2.zcoeff.to_complex() -
            2 * (-0.3 + 0.7j) * n1.zcoeff.to_complex()), 0, atol=1e-14)
    assert not n1.la_threshold.lt(n2.la_threshold)  # n2.thr <= n1.thr


def test_composite_equals_stepping():
    """Composite(A, B) must equal stepping A through B's covered orbit
    points for the ZCoeff chain: ZCoeff_AB = ZCoeff_A' * ZCoeff_B."""
    p = LAParameters()
    orbit = [0.4 + 0.1j, -0.2 + 0.5j, 0.3 - 0.6j, 0.1 + 0.2j]
    # node A covers orbit[1] (built at orbit[0], stepped through orbit[1])
    a = _new_node(p, HDC.from_complex(orbit[0]))
    a, _ = _step(p, a, HDC.from_complex(orbit[1]))
    a.step_length = 2
    # node B at orbit[2]... stepped through orbit[3]
    b = _new_node(p, HDC.from_complex(orbit[2]))
    b, _ = _step(p, b, HDC.from_complex(orbit[3]))
    b.step_length = 2
    ab, _ = _composite(p, a, b)
    # step A through orbit[2], orbit[3] manually
    a2, _ = _step(p, a, HDC.from_complex(orbit[2]))
    a3, _ = _step(p, a2, HDC.from_complex(orbit[3]))
    np.testing.assert_allclose(
        abs(ab.zcoeff.to_complex() - a3.zcoeff.to_complex()), 0,
        atol=1e-13 * abs(a3.zcoeff.to_complex()))
    np.testing.assert_allclose(
        abs(ab.ccoeff.to_complex() - a3.ccoeff.to_complex()), 0,
        atol=1e-13 * abs(a3.ccoeff.to_complex()))


def test_la_table_invariants(deep_view):
    _, res, la = deep_view
    assert la.is_valid
    assert la.stage_count >= 1
    max_ref = res.count_orbit_entries() - 1
    # stage 0 step lengths partition [0, max_ref]
    idx0 = la.stage_la_index[0]
    count0 = la.stage_macro_it_count[0]
    total = sum(la.las[idx0 + k].step_length for k in range(count0))
    assert total == max_ref
    # each higher stage also partitions the orbit
    for s in range(1, la.stage_count):
        idx = la.stage_la_index[s]
        cnt = la.stage_macro_it_count[s]
        total = sum(la.las[idx + k].step_length for k in range(cnt))
        assert total == max_ref, (s, total, max_ref)
        # and has fewer nodes than the stage below
        assert cnt < la.stage_macro_it_count[s - 1]


def test_la_render_matches_perturbation_exactly(deep_view):
    ptz, res, la = deep_view
    pert = np.asarray(perturb.perturb_render_hdr(
        res, ptz, 32, 32, 3000, sub_dtype=np.float64))
    lav = np.asarray(la_kernel.la_perturb_render(
        res, la, ptz, 32, 32, 3000, sub_dtype=np.float64))
    assert (lav == pert).mean() > 0.97


def test_la_render_f32(deep_view):
    """f32 vs f64 LA renders: the reference treats 32-bit LA as a
    DIFFERENT render algorithm with per-pixel tolerance (HDRx32 vs
    HDRx64 rows, RenderAlgorithm.h) — near the escape boundary a
    last-ulp threshold flip legitimately cascades into whole-iteration
    differences.  Pin the measured behavior tightly: ≥88% of pixels
    bit-equal (measured 90.0%), median difference exactly 0, and
    budget-capped (non-escaping) pixels agree on cappedness."""
    ptz, res, la = deep_view
    lav32 = np.asarray(la_kernel.la_perturb_render(
        res, la, ptz, 32, 32, 3000, sub_dtype=np.float32)
        ).astype(np.int64)
    lav64 = np.asarray(la_kernel.la_perturb_render(
        res, la, ptz, 32, 32, 3000, sub_dtype=np.float64)
        ).astype(np.int64)
    d = np.abs(lav32 - lav64)
    assert (d == 0).mean() > 0.88
    assert np.median(d) == 0
    # pixels that exhaust the budget must do so in both precisions
    np.testing.assert_array_equal(lav32 == 3000, lav64 == 3000)


def test_lao_mode(deep_view):
    """LA-only mode renders (no perturbation tail) — counts are close
    to the full render where LA covers the escape, lower elsewhere."""
    ptz, res, la = deep_view
    full = np.asarray(la_kernel.la_perturb_render(
        res, la, ptz, 32, 32, 3000, sub_dtype=np.float64))
    lao = np.asarray(la_kernel.la_perturb_render(
        res, la, ptz, 32, 32, 3000, sub_dtype=np.float64, la_only=True))
    assert (lao <= full).all()
    assert lao.max() > 0


def test_engine_lav2_end_to_end():
    from fractalshark_tpu.engine.fractal import Fractal
    ptz = PointZoomBBConverter(
        pt_x="-0.743643887037158704752191506114774",
        pt_y="0.131825904205311970493132056385139",
        zoom_factor="1e8", prec=512)
    f = Fractal(width=24, height=24, view=ptz,
                algorithm="GpuHDRx32PerturbedLAv2",
                num_iterations=2500, backend="cpu")
    iters = np.asarray(f.calc_fractal())
    assert iters.shape == (24, 24)
    assert f.benchmark.la_generation_s > 0
    assert iters.max() > 800


def test_native_la_builder_bit_exact():
    """native/la_build.cpp vs the Python oracle: identical tables
    (same differential strategy as the reference's HpSharkFloatTest —
    the C++ production path must match the portable oracle exactly)."""
    from fractalshark_tpu.engine import native_la
    if not native_la.available():
        import pytest
        pytest.skip("native toolchain unavailable")
    ptz = PointZoomBBConverter(
        pt_x="-0.743643887037158704752191506114774",
        pt_y="0.131825904205311970493132056385139",
        zoom_factor="1e8", prec=512)
    from fractalshark_tpu.engine.reforbit import compute_reference_orbit
    res = compute_reference_orbit(
        ptz.pt_x.with_precision(512), ptz.pt_y.with_precision(512),
        20000, ptz.radius, periodicity=True, precision_bits=512)
    rad = HD.from_hp(res.max_radius)
    la_n = native_la.generate_native(res.orbit_x, res.orbit_y, rad)
    la_p = LAReferenceHost.generate(res.orbit_x, res.orbit_y, rad)
    assert la_n is not None and la_p.is_valid
    assert la_n.stage_count == la_p.stage_count
    assert la_n.use_at == la_p.use_at
    an = la_n.device_arrays(np.float64)
    ap = la_p.device_arrays(np.float64)
    for k in ("ref_m", "ref_e", "zc_m", "zc_e", "cc_m", "cc_e",
              "thr_m", "thr_e", "thrc_m", "thrc_e", "step_length",
              "next_stage_la_index", "stage_la_index",
              "stage_macro_it_count"):
        np.testing.assert_array_equal(np.asarray(an[k]),
                                      np.asarray(ap[k]), err_msg=k)
    if la_p.use_at:
        assert la_n.at.step_length == la_p.at.step_length
        assert la_n.at.zcoeff.m == la_p.at.zcoeff.m
        assert la_n.at.zcoeff.e == la_p.at.zcoeff.e


def test_chunked_relaunch_bit_exact(deep_view):
    """Bounded-dispatch relaunch (the reference's chunked kernel
    relaunch, RefOrbitCalc.cpp:2205-2233) must be invisible to the
    result: tiny chunks == single launch."""
    ptz, res, la = deep_view
    one = np.asarray(la_kernel.la_perturb_render(
        res, la, ptz, 32, 32, 3000, sub_dtype=np.float32))
    chunked = np.asarray(la_kernel.la_perturb_render(
        res, la, ptz, 32, 32, 3000, sub_dtype=np.float32,
        chunk_steps=37))
    np.testing.assert_array_equal(one, chunked)


def test_hdr_orbit_exponents_reach_la_nodes():
    """Sub-f64 orbit dips ship as (mantissa, exp); the LA builders must
    carry the exponents into node Refs instead of seeing zeros (the
    View #30 failure: every stage-boundary ref underflowed to 0 and a
    spuriously-usable AT consumed the whole budget). Native and Python
    builders must agree on the exponent-carrying orbit."""
    from fractalshark_tpu.engine import native_la
    ptz = PointZoomBBConverter(
        pt_x="-0.743643887037158704752191506114774",
        pt_y="0.131825904205311970493132056385139",
        zoom_factor="1e8", prec=512)
    from fractalshark_tpu.engine.reforbit import compute_reference_orbit
    res = compute_reference_orbit(
        ptz.pt_x.with_precision(512), ptz.pt_y.with_precision(512),
        4000, ptz.radius, periodicity=True, precision_bits=512)
    n = res.count_orbit_entries()
    # synthesize dips: every 500th entry becomes mantissa*2^-3000
    ox = res.orbit_x.copy()
    oy = res.orbit_y.copy()
    oe = np.zeros(n, np.int32)
    for i in range(250, n - 2, 500):
        oe[i] = -3000
    rad = HD.from_hp(res.max_radius)
    la_p = LAReferenceHost.generate(ox, oy, rad, orbit_e=oe)
    assert la_p.is_valid
    # some node must carry a deep-exponent ref
    deep = [nd for nd in la_p.las if nd.ref.e < -1000]
    assert deep, "no node picked up the dip exponents"
    if native_la.available():
        la_n = native_la.generate_native(ox, oy, rad, orbit_e=oe)
        assert la_n is not None
        an = la_n.device_arrays(np.float64)
        ap = la_p.device_arrays(np.float64)
        np.testing.assert_array_equal(an["ref_e"], ap["ref_e"])
        np.testing.assert_array_equal(an["ref_m"], ap["ref_m"])


def test_at_requires_full_period_window(deep_view):
    """The AT engages only when its window covers (essentially) the
    whole orbit — a sub-period window's z'^2+c' model cannot represent
    the per-window amplification of dc (View #30 regression)."""
    ptz, res, la = deep_view
    if la.use_at:
        idx = la.stage_la_index[-1]
        assert la.las[idx].step_length * 2 > res.max_ref_iteration()


def test_native_mt_la_builder_bit_identical():
    """MT stage-0 LA builder (CreateLAFromOrbitMT analogue): worker
    threads sync onto self-synchronizing node boundaries and build
    segments independently; the merged table must equal the
    single-thread build EXACTLY (FS_LA_MT forces the thread count —
    this container has 1 CPU, so the parallelism is correctness-tested
    here and pays off on real multi-core hosts)."""
    import os

    from fractalshark_tpu.engine import native_la as NL
    if not NL.available():
        pytest.skip("native toolchain unavailable")

    from fractalshark_tpu.core.highprecision import HighPrecision
    from fractalshark_tpu.engine.reforbit import compute_reference_orbit

    cx = HighPrecision("-0.743643887037158704752191506114774", prec=320)
    cy = HighPrecision("0.131825904205311970493132056385139", prec=320)
    res = compute_reference_orbit(cx, cy, 250000,
                                  HighPrecision("1e-24", prec=64),
                                  periodicity=True, precision_bits=320)
    rad = HD.from_hp(res.max_radius)

    def build(threads):
        os.environ["FS_LA_MT"] = str(threads)
        try:
            return NL.generate_native(res.orbit_x, res.orbit_y, rad,
                                      orbit_e=res.orbit_e)
        finally:
            del os.environ["FS_LA_MT"]

    st = build(1)
    assert st is not None
    for t in (2, 3, 5):
        mt = build(t)
        a = st.device_arrays(np.float32)
        b = mt.device_arrays(np.float32)
        assert a["stage_count"] == b["stage_count"], t
        for key in ("ref_m", "ref_e", "zc_m", "zc_e", "cc_m", "cc_e",
                    "thr_m", "thr_e", "step_length",
                    "next_stage_la_index", "stage_la_index",
                    "stage_macro_it_count"):
            np.testing.assert_array_equal(np.asarray(a[key]),
                                          np.asarray(b[key]),
                                          err_msg=f"{key} @T={t}")


def test_low_bound_composes_deeper_stages():
    """p.low_bound < 64 keeps composing stages past the reference's
    fixed lowBound (LAReference.h:56) down to the terminal whole-orbit
    stage.  Deep budgets wrap the orbit inside the LA machine — one
    wrap walks the TOP stage's nodes — so the terminal 1-node stage
    divides per-wrap macro-step counts by the top stage's size (the
    View #27 enabler: 10^15-iteration budgets = tens of thousands of
    wraps/pixel).  Native and Python builders must agree bit-exactly
    at the non-default bound."""
    from fractalshark_tpu.engine import native_la
    # synthetic non-escaping, non-periodic orbit: the period==0
    # NthRoot branch gives a large stage 0, so intermediate stages
    # exist between the default bound and the terminal stage
    rng = np.random.default_rng(7)
    n = 50001
    mag = rng.uniform(0.3, 1.8, n)
    ang = rng.uniform(0, 2 * np.pi, n)
    ox = mag * np.cos(ang)
    oy = mag * np.sin(ang)
    ox[0] = 0.0
    oy[0] = 0.0
    rad = HD.from_float(1e-30)
    p1 = LAParameters(low_bound=1)
    la64 = LAReferenceHost.generate(ox, oy, rad)
    la1 = LAReferenceHost.generate(ox, oy, rad, params=p1)
    assert la1.is_valid and la64.is_valid
    assert la1.stage_count > la64.stage_count
    assert la64.stage_macro_it_count[la64.stage_count - 1] > 1
    # terminal whole-orbit stage reached
    assert la1.stage_macro_it_count[la1.stage_count - 1] == 1
    top = la1.las[la1.stage_la_index[la1.stage_count - 1]]
    assert top.step_length == n - 1
    # the deep table is a strict extension: the la64 stages are shared
    n64 = la64.stage_la_index[la64.stage_count - 1]
    a64 = la64.device_arrays(np.float64)
    a1 = la1.device_arrays(np.float64)
    for k in ("ref_m", "ref_e", "zc_m", "zc_e", "step_length"):
        np.testing.assert_array_equal(np.asarray(a1[k])[:n64],
                                      np.asarray(a64[k])[:n64],
                                      err_msg=k)
    if native_la.available():
        lan = native_la.generate_native(ox, oy, rad, params=p1)
        assert lan is not None
        assert lan.stage_count == la1.stage_count
        an = lan.device_arrays(np.float64)
        for k in ("ref_m", "ref_e", "zc_m", "zc_e", "cc_m", "cc_e",
                  "thr_m", "thr_e", "thrc_m", "thrc_e", "step_length",
                  "next_stage_la_index", "stage_la_index",
                  "stage_macro_it_count"):
            np.testing.assert_array_equal(np.asarray(an[k]),
                                          np.asarray(a1[k]), err_msg=k)


def test_la_wide_path_bit_identical(deep_view):
    """The 64-bit LA machine variant (int64 budgets, int64 ref
    positions, [step_length, next_stage_la_index] side table — the
    View #27 class: period ~28e9, 10^15 budgets) must render bit-
    identically to the int32 path on a small view (force_wide compiles
    the wide executable without a >2^31 budget)."""
    ptz, res, la = deep_view
    a = np.asarray(la_kernel.la_perturb_render(
        res, la, ptz, 32, 32, 3000, sub_dtype=np.float32))
    b = np.asarray(la_kernel.la_perturb_render(
        res, la, ptz, 32, 32, 3000, sub_dtype=np.float32,
        force_wide=True))
    np.testing.assert_array_equal(a.astype(np.int64), b.astype(np.int64))


def test_device_stage_window_parameter():
    """fractal.la_parameters.device_stage_window windows the device
    table through get_or_build_la (a MaxPerf-style lever) and
    caches full + windowed tables separately."""
    from fractalshark_tpu.engine import native_la
    from fractalshark_tpu.engine.la_reference import get_or_build_la
    if not native_la.available():
        pytest.skip("native builder required for stage_window")

    ptz = PointZoomBBConverter(
        pt_x="-0.743643887037158704752191506114774",
        pt_y="0.131825904205311970493132056385139",
        zoom_factor="1e13", prec=512).square_aspect_ratio(16, 16)
    calc = RefOrbitCalc()
    res = calc.get_and_create_useful_results(ptz, 60_000)

    class _F:
        la_parameters = None
    full = get_or_build_la(_F(), res)
    assert full is not None and full.stage_count > 1

    class _FW:
        la_parameters = LAParameters(device_stage_window=1)
    win = get_or_build_la(_FW(), res)
    ref = full.stage_window(1)
    assert win.stage_count == ref.stage_count == full.stage_count - 1
    assert len(win.las) == len(ref.las) < len(full.las)
    np.testing.assert_array_equal(win.las, ref.las)
    # cached: second call returns the same object, full table untouched
    assert get_or_build_la(_FW(), res) is win
    assert get_or_build_la(_F(), res) is full
