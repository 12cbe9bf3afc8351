"""Mini View-#27 endurance pipeline, end to end at test scale.

The View #27 class (period ~28e9, 10^15-iteration budgets —
``Notes/FractalShark-06-RefOrbit.tex:740-747``) composes three stages
whose drivers live in tools/: a compressed reference orbit
(run_view27.py), a deep-budget LA table built THROUGH the compressed
store with ``LAParameters(period_divisor=8, low_bound=1)`` +
npz persistence (view27_la.py), and a ``VirtualResults`` two-phase
render against a budget many times the orbit length (view27_render.py)
— the uncompressed orbit never exists anywhere.

This test runs that exact composition on a truncated deep orbit small
enough for the CPU, and checks the result pixel-identical
against the one-kernel FULL LAv2 render on the decompressed orbit with
the same table (the RC reconstruction is exact by construction, so the
two paths must agree bit for bit).
"""

import numpy as np
import pytest

from fractalshark_tpu.core.hdr_host import HD
from fractalshark_tpu.core.pointzoom import PointZoomBBConverter
from fractalshark_tpu.engine import native_la as NL
from fractalshark_tpu.engine.la_reference import LAParameters
from fractalshark_tpu.engine.perturbation_results import (
    CompressedOrbit, PerturbationResults, VirtualResults)
from fractalshark_tpu.engine.reforbit import RefOrbitCalc

pytestmark = pytest.mark.skipif(not NL.available(),
                                reason="native toolchain missing")

ORBIT_LEN = 2048          # pixels here escape at ~2100-10400 iters,
BUDGET = 12_000           # i.e. 1-5 wraps of the truncated orbit each
SIZE = 16


@pytest.fixture(scope="module")
def mini(tmp_path_factory):
    ptz = PointZoomBBConverter(
        pt_x="-0.743643887037158704752191506114774",
        pt_y="0.131825904205311970493132056385139",
        zoom_factor="1e13", prec=512).square_aspect_ratio(SIZE, SIZE)
    calc = RefOrbitCalc()
    res = calc.get_and_create_useful_results(ptz, 50_000)
    # truncate so small budgets wrap the orbit several times
    res_t = PerturbationResults(
        center_x=res.center_x, center_y=res.center_y,
        orbit_x=res.orbit_x[:ORBIT_LEN], orbit_y=res.orbit_y[:ORBIT_LEN],
        max_radius=res.max_radius, period=0, escaped_at=0,
        max_iterations=ORBIT_LEN, precision_bits=res.precision_bits)
    comp = CompressedOrbit.from_uncompressed(res_t, error_exp=20)
    return ptz, res_t, comp, tmp_path_factory.mktemp("v27")


def test_mini_view27_pipeline(mini):
    from fractalshark_tpu.engine.native_la import LAReferenceArrays
    from fractalshark_tpu.engine.renderers import two_phase_render
    from fractalshark_tpu.ops import la_kernel

    ptz, res_t, comp, tmp = mini
    assert comp.compression_ratio() > 1.5

    # stage 2: deep-budget LA build straight from the compressed store
    params = LAParameters(period_divisor=8, low_bound=1)
    la = NL.generate_native_rc(comp, HD.from_hp(res_t.max_radius),
                               params=params)
    assert la is not None and la.is_valid
    # low_bound=1 must compose down to a terminal whole-orbit stage so
    # each per-pixel wrap costs ~one macro step (view27_la.py contract)
    top = la.stage_count - 1
    top_nodes = len(la.las) - la.stage_la_index[top]
    assert top_nodes <= 2

    # npz persistence round trip (the view27_la -> view27_render handoff)
    path = str(tmp / "mini_la.npz")
    la.save_npz(path)
    la2 = LAReferenceArrays.load_npz(path)
    for k, v in la._arrays.items():
        np.testing.assert_array_equal(v, la2._arrays[k], err_msg=k)
    assert la2.stage_la_index == la.stage_la_index
    assert la2.stage_macro_it_count == la.stage_macro_it_count
    assert la2.use_at == la.use_at

    # stage 3: VirtualResults two-phase render — orbit arrays never used
    virt = VirtualResults.from_compressed(comp, res_t.center_x,
                                          res_t.center_y)
    two = np.asarray(two_phase_render(virt, la2, ptz, SIZE, SIZE,
                                      BUDGET, comp=comp))

    # oracle: one-kernel FULL LAv2 on the decompressed orbit, same table
    dx, dy = comp.decompress()
    res_rc = PerturbationResults(
        center_x=res_t.center_x, center_y=res_t.center_y,
        orbit_x=dx, orbit_y=dy, max_radius=res_t.max_radius,
        period=0, escaped_at=0, max_iterations=ORBIT_LEN,
        precision_bits=res_t.precision_bits)
    full = np.asarray(la_kernel.la_perturb_render(
        res_rc, la, ptz, SIZE, SIZE, BUDGET, sub_dtype=np.float32))

    np.testing.assert_array_equal(two, full)
    o = two.astype(np.int64)
    assert o.max() >= 2 * ORBIT_LEN  # budget really wrapped the orbit


def test_memmap_dir_build_and_stage_window(mini):
    """The View #27-scale build path: marshalling into disk-backed
    memmaps (generate_native_rc_streamed(memmap_dir=...)) must be
    value-identical to the in-RAM build; the directory format must
    round-trip; and a stage_window(1) table (the smaller device table
    — the full 426M-node View #27 table is ~37 GB) must produce the same two-phase render as the full table."""
    from fractalshark_tpu.engine.native_la import LAReferenceArrays
    from fractalshark_tpu.engine.renderers import two_phase_render

    ptz, res_t, comp, tmp = mini
    params = LAParameters(period_divisor=8, low_bound=1)
    rad = HD.from_hp(res_t.max_radius)
    ram = NL.generate_native_rc(comp, rad, params=params)

    d = tmp / "la_dir"
    d.mkdir()
    mm, info = NL.generate_native_rc_streamed(comp, rad, params=params,
                                              memmap_dir=str(d))
    assert mm is not None and info["cnt"] == len(ram.las)
    for k, v in ram._arrays.items():
        np.testing.assert_array_equal(v, mm._arrays[k], err_msg=k)
    assert isinstance(mm._arrays["ref_m"].base, np.memmap)

    # directory round trip (view27_la -> view27_render handoff, dir form)
    mm.save_meta_npz(str(d))
    ld = LAReferenceArrays.load_dir(str(d))
    for k, v in ram._arrays.items():
        np.testing.assert_array_equal(v, ld._arrays[k], err_msg=k)
    assert ld.stage_la_index == ram.stage_la_index
    assert ld.stage_macro_it_count == ram.stage_macro_it_count
    assert ld.stage_count == ram.stage_count
    assert ld.use_at == ram.use_at
    if ram.use_at:
        assert ld.at.step_length == ram.at.step_length

    assert ram.stage_count >= 2  # the window test needs a stage to drop
    win = ld.stage_window(1)
    assert win.stage_count == ram.stage_count - 1
    assert len(win.las) == len(ram.las) - ram.stage_la_index[1]

    # EXACT remap property: a stage-0 node's own next_stage_la_index
    # IS its orbit start position (la_build.cpp stage-0 walk records
    # the previous detection point at each push), and each stage tiles
    # its period contiguously from 0 — so the step-length prefix sum
    # the remap uses must reproduce those recorded positions for every
    # LIVE node (terminal marker nodes are never stepped)
    s0 = np.asarray(ram._arrays["step_length"][:ram.stage_la_index[1]],
                    np.int64)
    pos = np.concatenate([np.zeros(1, np.int64), np.cumsum(s0)])
    nsi_orig = np.asarray(
        ram._arrays["next_stage_la_index"][:ram.stage_la_index[1]])
    live0 = ram.stage_macro_it_count[0]
    np.testing.assert_array_equal(pos[:live0], nsi_orig[:live0])
    # and the windowed lowest stage's remapped next-indices are exactly
    # the dropped stage's node positions at the recorded offsets
    end0 = (win.stage_la_index[1] if win.stage_count > 1
            else len(win.las))
    nsi_old = np.asarray(
        ram._arrays["next_stage_la_index"][ram.stage_la_index[1]:
                                           ram.stage_la_index[1] + end0],
        np.int64)
    nsi_new = np.asarray(win._arrays["next_stage_la_index"][:end0])
    np.testing.assert_array_equal(nsi_new, pos[nsi_old])

    # render comparison: the window moves each pixel's one-time tail
    # handoff earlier (micro-steps where the full table macro-stepped),
    # so the f32 rounding PATH differs — chaotic boundary pixels may
    # legitimately land on different dwell counts (the same inherent
    # sensitivity as LA-vs-direct; reference renders accept it too).
    # Interior/most pixels must agree exactly.
    virt = VirtualResults.from_compressed(comp, res_t.center_x,
                                          res_t.center_y)
    full = np.asarray(two_phase_render(virt, ld, ptz, SIZE, SIZE,
                                       BUDGET, comp=comp))
    wout = np.asarray(two_phase_render(virt, win, ptz, SIZE, SIZE,
                                       BUDGET, comp=comp))
    same = wout == full
    assert same.mean() > 0.7, f"only {same.mean():.0%} pixels identical"
    assert np.median(np.abs(wout.astype(np.int64)
                            - full.astype(np.int64))) == 0
    assert wout.min() > 0
