"""What decides the GPU route, tested on the CPU: AUTO's family choice
by platform, the compile-cache placement, the contraction-proof
double-float split, and the trace reduction's busy/idle arithmetic.
The ``gpu``-marked cases run the same checks on the card."""

import os
import subprocess
import sys
from fractions import Fraction

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from fractalshark_tpu.core.algorithms import auto_select
from fractalshark_tpu.core.pointzoom import PointZoomBBConverter
from fractalshark_tpu.engine.fractal import Fractal
from fractalshark_tpu.ops import dblflt
from fractalshark_tpu.utils.profiling import busy_and_window


@pytest.mark.parametrize("zoom_exp2,gpu_name,cpu_name", [
    (5, "Gpu1x32", "Cpu64"),
    (30, "Gpu1x64", "Cpu64"),
    (120, "Gpu1x64PerturbedLAv2", "Cpu64PerturbedBLAV2HDR"),
    (900, "GpuHDRx32PerturbedLAv2", "Cpu32PerturbedBLAV2HDR"),
])
def test_auto_family_by_platform(zoom_exp2, gpu_name, cpu_name):
    assert auto_select(zoom_exp2, has_accelerator=True).name == gpu_name
    assert auto_select(zoom_exp2, has_accelerator=False).name == cpu_name


@pytest.mark.parametrize("backend,want", [("gpu", "Gpu1x32"),
                                          ("cpu", "Cpu64")])
def test_fractal_auto_resolves_by_backend(backend, want):
    """Any platform but the CPU takes the accelerated families."""
    f = Fractal(64, 64, view=0, algorithm="AUTO", backend=backend)
    assert f.resolve_algorithm().name == want


@pytest.mark.parametrize("env", [None, "custom"])
def test_compile_cache_placement(tmp_path, env):
    """JAX_COMPILATION_CACHE_DIR wins when set; otherwise the cache is
    .jax_cache at the root of the checkout."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    e = dict(os.environ)
    e.pop("JAX_COMPILATION_CACHE_DIR", None)
    want = os.path.join(root, ".jax_cache")
    if env is not None:
        want = str(tmp_path / env)
        e["JAX_COMPILATION_CACHE_DIR"] = want
    out = subprocess.run(
        [sys.executable, "-c",
         "import jax, fractalshark_tpu; "
         "print(jax.config.jax_compilation_cache_dir); "
         "print(fractalshark_tpu.compile_cache_dir())"],
        env=e, cwd=root, capture_output=True, text=True, check=True)
    assert out.stdout.split() == [want, want]


def _operands(dtype, seed, n=600):
    rng = np.random.default_rng(seed)
    er = 20 if dtype == np.float32 else 200     # products stay normal
    a = (rng.standard_normal(n) * np.exp2(rng.integers(-er, er, n)))
    b = (rng.standard_normal(n) * np.exp2(rng.integers(-er, er, n)))
    a[:4] = [1.0, -1.0, 3.0, np.finfo(dtype).eps]    # edge cases
    return a.astype(dtype), b.astype(dtype)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_split_and_two_prod_exact(dtype, seed):
    """split: hi + lo == a exactly, hi within half the significand;
    two_prod: p + err == a·b exactly (fractions.Fraction oracle)."""
    a, b = _operands(dtype, seed)
    hi, lo = (np.asarray(v) for v in dblflt.split(jnp.asarray(a)))
    keep = 12 if dtype == np.float32 else 26
    for x, h, lw in zip(a, hi, lo):
        assert Fraction(float(x)) == Fraction(float(h)) + Fraction(float(lw))
        m, _ = np.frexp(h)
        assert float(m * 2.0 ** keep).is_integer()
        assert abs(float(lw)) <= abs(float(x)) * 2.0 ** -keep
    p, e = jax.jit(dblflt.two_prod)(jnp.asarray(a), jnp.asarray(b))
    for x, y, u, v in zip(a, b, np.asarray(p), np.asarray(e)):
        assert Fraction(float(x)) * Fraction(float(y)) == \
            Fraction(float(u)) + Fraction(float(v))


@pytest.mark.parametrize("spans,busy,window", [
    ([], 0.0, 0.0),
    ([(0, 10), (20, 30)], 20.0, 30.0),
    ([(0, 10), (5, 12), (11, 20), (30, 31)], 21.0, 31.0),
])
def test_trace_busy_and_window(spans, busy, window):
    assert busy_and_window(spans) == (busy, window)


@pytest.mark.gpu
def test_card_auto_and_direct_render(gpu):
    """On the card AUTO takes Gpu1x32 and the render matches the CPU's
    escape_jax on all but a few threshold pixels (FMA contraction;
    chip_smoke.py states the bound)."""
    from fractalshark_tpu.ops import escape
    f = Fractal(256, 256, view=0, algorithm="AUTO", num_iterations=512)
    assert f.resolve_algorithm().name == "Gpu1x32"
    card = np.asarray(f.calc_fractal())
    params = escape.PlainParams.from_view(f.ptz, 256, 256)
    with jax.default_device(jax.devices("cpu")[0]):
        ref = np.asarray(escape.escape_jax(params, 256, 256, 512,
                                           dtype=jnp.float32))
    assert (card != ref).mean() <= 2e-3


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_card_two_prod_exact(gpu, dtype):
    a, b = _operands(dtype, 7)
    with jax.default_device(gpu):
        p, e = jax.jit(dblflt.two_prod)(jnp.asarray(a), jnp.asarray(b))
    for x, y, u, v in zip(a, b, np.asarray(p), np.asarray(e)):
        assert Fraction(float(x)) * Fraction(float(y)) == \
            Fraction(float(u)) + Fraction(float(v))


@pytest.mark.gpu
@pytest.mark.parametrize("alg", ["Gpu2x32", "Gpu4x32"])
def test_card_double_float_render_matches_cpu(gpu, alg):
    ptz = PointZoomBBConverter(
        pt_x="-0.743643887037158704752191506114774",
        pt_y="0.131825904205311970493132056385139",
        zoom_factor="1e10", prec=256)
    out = {}
    for name, dev in (("card", gpu), ("cpu", jax.devices("cpu")[0])):
        with jax.default_device(dev):
            f = Fractal(16, 16, view=ptz, algorithm=alg, num_iterations=500)
            out[name] = np.asarray(f.calc_fractal())
    np.testing.assert_array_equal(out["card"], out["cpu"])
