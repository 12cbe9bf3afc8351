"""fractalshark_tpu — a deep-zoom Mandelbrot rendering framework on JAX.

A ground-up rebuild of the capability set of FractalShark (reference:
mattsaccount364/FractalShark), a C++/CUDA renderer for one NVIDIA GPU:

* escape-time rendering across dtype-parameterized algorithm families
  (f32 / f64 / 2x32 double-float / HDR float+exponent), expressed as
  branch-free masked JAX kernels over the pixel grid;
* perturbation theory (one high-precision reference orbit + per-pixel
  low-precision delta orbits) with Zhuoran rebasing;
* linear approximation (LAv2) iteration skipping;
* a high-precision big-float pipeline (16-bit digit arrays, NTT
  multiply) for computing reference orbits on-device;
* multi-device scale-out via `jax.sharding` meshes (pixel-row data
  parallelism, limb-sharded reference orbits).

Host orchestration is Python; compute runs under `jax.jit`.
"""

import os

import jax

# Deep zoom fundamentally requires float64 on the host/CPU path (golden
# tests are pinned at f64, matching the reference's Cpu64 algorithms).
if os.environ.get("FRACTALSHARK_NO_X64", "0") != "1":
    jax.config.update("jax_enable_x64", True)


def compile_cache_dir() -> str:
    """Where the persistent compilation cache lives: the directory in
    ``JAX_COMPILATION_CACHE_DIR`` when set, else ``.jax_cache`` at the
    root of this checkout (a fixed path, so later processes hit it)."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    return os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), ".jax_cache")


jax.config.update("jax_compilation_cache_dir", compile_cache_dir())
jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)

__version__ = "0.1.0"

from fractalshark_tpu.core.highprecision import HighPrecision  # noqa: E402
from fractalshark_tpu.core.pointzoom import PointZoomBBConverter  # noqa: E402

__all__ = [
    "HighPrecision",
    "PointZoomBBConverter",
    "__version__",
]
