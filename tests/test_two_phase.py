"""Two-phase LAv2 (LA machine to tail entry, then the gather tail) vs
the one-kernel XLA LAv2 machine: the handoff state and the finished
grid must be bit-identical."""

import numpy as np
import pytest

from fractalshark_tpu.core.hdr_host import HD
from fractalshark_tpu.core.pointzoom import PointZoomBBConverter
from fractalshark_tpu.engine.la_reference import LAReferenceHost
from fractalshark_tpu.engine.reforbit import RefOrbitCalc
from fractalshark_tpu.engine.renderers import two_phase_render
from fractalshark_tpu.ops import la_kernel

CENTER = dict(pt_x="-0.743643887037158704752191506114774",
              pt_y="0.131825904205311970493132056385139",
              zoom_factor="1e8", prec=512)


@pytest.fixture(scope="module")
def deep():
    ptz = PointZoomBBConverter(**CENTER).square_aspect_ratio(32, 32)
    res = RefOrbitCalc().get_and_create_useful_results(ptz, 2000)
    la = LAReferenceHost.generate(res.orbit_x, res.orbit_y,
                                  HD.from_hp(res.max_radius))
    assert la.is_valid
    return res, la


def test_handoff_chunked_matches_one_dispatch(deep):
    """Phase 1 suspended every 2 body steps and resumed from its state
    exports the same handoff as one undivided dispatch."""
    res, la = deep
    ptz = PointZoomBBConverter(**CENTER).square_aspect_ratio(32, 32)
    kw = dict(sub_dtype=np.float32, la_only=True, return_state=True)
    one = la_kernel.la_perturb_render(res, la, ptz, 32, 32, 1500,
                                      chunk_steps=0, **kw)
    many = la_kernel.la_perturb_render(res, la, ptz, 32, 32, 1500,
                                       chunk_steps=2, **kw)
    assert la_kernel.last_run_stats["dispatches"] > 1
    for i, (a, b) in enumerate(zip(one, many)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b),
                                      err_msg=f"state[{i}]")


@pytest.mark.parametrize("w,h,n", [(32, 32, 1800), (32, 32, 1200),
                                   (50, 37, 1200)])
def test_two_phase_matches_one_kernel(deep, w, h, n):
    res, la = deep
    ptz = PointZoomBBConverter(**CENTER).square_aspect_ratio(w, h)
    full = np.asarray(la_kernel.la_perturb_render(
        res, la, ptz, w, h, n, sub_dtype=np.float32))
    two = np.asarray(two_phase_render(res, la, ptz, w, h, n))
    np.testing.assert_array_equal(two, full)


def test_two_phase_f64_mantissas_match_one_kernel(deep):
    """HDR with f64 mantissas through both phases == the one-kernel
    machine at sub_dtype f64."""
    res, la = deep
    ptz = PointZoomBBConverter(**CENTER).square_aspect_ratio(32, 32)
    full = np.asarray(la_kernel.la_perturb_render(
        res, la, ptz, 32, 32, 1800, sub_dtype=np.float64))
    two = np.asarray(two_phase_render(res, la, ptz, 32, 32, 1800,
                                      sub_dtype=np.float64))
    np.testing.assert_array_equal(two, full)
