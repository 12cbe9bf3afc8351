"""Plain escape-time renderer tests.

Strategy mirrors the reference (SURVEY.md §4a): a slow trusted oracle
(direct Python loop, same math as Fractal.cpp:2139-2183) checks small
images exactly; a golden CRC pins a larger render.
"""

import zlib

import jax.numpy as jnp
import numpy as np
import pytest

from fractalshark_tpu.core.views import get_view_preset
from fractalshark_tpu.ops import escape


def oracle_escape(params, width, height, max_iter):
    """Direct f64 loop — trusted oracle."""
    out = np.zeros((height, width), np.uint32)
    for y in range(height):
        cy = params.max_y - y * params.dy
        for x in range(width):
            cx = params.min_x + x * params.dx
            zx, zy = cx, cy
            i = 0
            while i < max_iter:
                zx2 = zx * zx
                zy2 = zy * zy
                if zx2 + zy2 > 4.0:
                    break
                zy = 2.0 * zx * zy + cy
                zx = zx2 - zy2 + cx
                i += 1
            out[y, x] = i
    return out


@pytest.fixture(scope="module")
def view0_params():
    v = get_view_preset(0)
    ptz = v.ptz.square_aspect_ratio(64, 64)
    return escape.PlainParams.from_view(ptz, 64, 64)


def test_escape_jax_matches_oracle(view0_params):
    got = np.asarray(escape.escape_jax(view0_params, 64, 64, 100,
                                       dtype=jnp.float64))
    want = oracle_escape(view0_params, 64, 64, 100)
    np.testing.assert_array_equal(got, want)


def test_escape_nonsquare_and_padding(view0_params):
    # odd, non-square dims: the lockstep grid has no tile padding
    got = np.asarray(escape.escape_jax(view0_params, 57, 43, 64,
                                       dtype=jnp.float64))
    want = oracle_escape(view0_params, 57, 43, 64)
    np.testing.assert_array_equal(got, want)


def test_escape_golden_crc():
    """256×256 view-0 render @256 iters, f64: CRC-pinned.

    Regenerate with FRACTALSHARK_UPDATE_GOLDENS=1 (see
    tests/update_goldens.py) if the escape semantics intentionally change.
    """
    v = get_view_preset(0)
    ptz = v.ptz.square_aspect_ratio(256, 256)
    params = escape.PlainParams.from_view(ptz, 256, 256)
    iters = np.asarray(escape.escape_jax(params, 256, 256, 256,
                                         dtype=jnp.float64))
    crc = zlib.crc32(iters.astype("<u4").tobytes())
    import os
    if os.environ.get("FRACTALSHARK_UPDATE_GOLDENS") == "1":
        print(f"GOLDEN escape_view0_256: {crc}")
    assert crc == GOLDEN_ESCAPE_VIEW0_256


def test_max_iter_zero_pixels():
    v = get_view_preset(0)
    ptz = v.ptz.square_aspect_ratio(16, 16)
    params = escape.PlainParams.from_view(ptz, 16, 16)
    # corner pixels are outside radius 2 ⇒ iteration count 0
    iters = np.asarray(escape.escape_jax(params, 16, 16, 50))
    assert iters[0, 0] == 0
    # interior pixel (center) never escapes ⇒ full budget
    assert iters[8, 8] == 50


def test_iter_dtype_u64():
    # budgets ≥ 2^32 use uint64 iteration counters (IterTypeEnum::Bits64).
    # Use an all-escaping view so the masked loop terminates immediately.
    big = 1 << 33
    p2 = escape.PlainParams(min_x=10.0, max_y=10.0, dx=0.1, dy=0.1)
    it2 = escape.escape_jax(p2, 8, 8, big)
    assert it2.dtype == jnp.uint64
    assert (np.asarray(it2) == 0).all()


GOLDEN_ESCAPE_VIEW0_256 = 3586676062


@pytest.mark.parametrize("y0,rows", [(0, 16), (16, 16), (40, 24)])
def test_escape_band_matches_full_image(view0_params, y0, rows):
    """A tile-band render (row offset y0) is bit-identical to the same
    rows of the whole-image render."""
    full = np.asarray(escape.escape_jax(view0_params, 64, 64, 100,
                                        dtype=jnp.float64))
    band = np.asarray(escape.escape_jax(view0_params, 64, rows, 100,
                                        dtype=jnp.float64, y0=y0))
    np.testing.assert_array_equal(band, full[y0:y0 + rows])
