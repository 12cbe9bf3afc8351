"""The GPU-facing entry points, tested on the CPU: the smoke script and
the benchmark refuse to run without a GPU, the CLI reports the kernel
route it took, the orbit cache counts its hits, and the trace reduction
picks the kernel lines of a device plane."""

import json
import os
import shutil
import subprocess
import sys
import types

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run_smoke(cwd):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["JAX_PLATFORMS"] = "cpu"
    return subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd,
                          env=env, capture_output=True, text=True,
                          timeout=300)


def test_chip_smoke_refuses_cpu():
    r = _run_smoke(ROOT)
    assert r.returncode != 0
    assert '"ok": true' not in r.stdout
    assert "no GPU" in r.stderr


def test_chip_smoke_alone_fails(tmp_path):
    """Without the package beside it the script fails, printing no
    result line."""
    shutil.copy(os.path.join(ROOT, "chip_smoke.py"), tmp_path)
    r = _run_smoke(str(tmp_path))
    assert r.returncode != 0
    assert '"ok": true' not in r.stdout


def test_bench_refuses_cpu():
    sys.path.insert(0, ROOT)
    try:
        import bench
    finally:
        sys.path.remove(ROOT)
    with pytest.raises(SystemExit, match="no GPU"):
        bench._device()


@pytest.mark.parametrize("alg,kernel", [
    ("GpuHDRx32PerturbedLAv2", "lav2"),
    ("GpuHDRx32PerturbedLAv2LAO", "lav2-lao"),
    ("GpuHDRx32PerturbedRCLAv2", "lav2-rc"),
    ("GpuHDRx32PerturbedRCLAv2PO", "rc"),
])
def test_cli_stats_report_kernel_route(capsys, alg, kernel):
    from fractalshark_tpu.cli import main
    assert main(["--center-x", "-0.743643887037158704752191506114774",
                 "--center-y", "0.131825904205311970493132056385139",
                 "--zoom", "1e8", "--width", "16", "--height", "16",
                 "--iterations", "600", "--stats",
                 "--render-algorithm", alg]) == 0
    stats = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert stats["kernel"] == kernel
    assert stats["algorithm"] == alg


def test_orbit_cache_counts_hits():
    from fractalshark_tpu.core.pointzoom import PointZoomBBConverter
    from fractalshark_tpu.engine.reforbit import RefOrbitCalc
    ptz = PointZoomBBConverter(
        pt_x="-0.743643887037158704752191506114774",
        pt_y="0.131825904205311970493132056385139", zoom_factor="1e8",
        prec=256).square_aspect_ratio(16, 16)
    calc = RefOrbitCalc()
    calc.get_and_create_useful_results(ptz, 600)
    assert calc.hits == 0 and not calc.last_details["cache_hit"]
    calc.get_and_create_useful_results(ptz, 600)
    assert calc.hits == 1 and calc.last_details["cache_hit"]


def _plane(*names):
    return types.SimpleNamespace(lines=[types.SimpleNamespace(name=n)
                                        for n in names])


@pytest.mark.parametrize("names,want", [
    (["Stream #13(Compute)", "Stream #18(MemcpyD2H)", "XLA Modules",
      "XLA Ops"], ["Stream #13(Compute)", "Stream #18(MemcpyD2H)"]),
    (["XLA Modules", "XLA Ops", "Kernels"], ["Kernels"]),
])
def test_trace_kernel_lines(names, want):
    from fractalshark_tpu.utils.profiling import _kernel_lines
    assert [ln.name for ln in _kernel_lines(_plane(*names))] == want


def test_cpu_trace_has_no_device_plane():
    import jax.numpy as jnp

    from fractalshark_tpu.utils.profiling import device_time_ms
    r = device_time_ms(lambda: (jnp.ones((64, 64)) * 2).block_until_ready())
    assert r["events"] == 0 and r["total_ms"] == 0.0
    assert "no kernel events" in r["error"]
