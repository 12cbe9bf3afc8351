"""The central engine: view state, algorithm dispatch, render orchestration.

Analogue of the reference ``class Fractal``
(``FractalSharkLib/Fractal.h:56-525``): owns the high-precision view
(PointZoomBBConverter), iteration budget, algorithm selection, palette,
and dispatches renders to the kernel families.  The 60-way dispatch
switch (``Fractal.cpp:1199-1530``) becomes a small family×dtype table.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field

import functools
import jax
import jax.numpy as jnp
import numpy as np

from fractalshark_tpu.core.algorithms import (
    Family, RenderAlgorithm, auto_select, get_algorithm)
from fractalshark_tpu.core.highprecision import HighPrecision
from fractalshark_tpu.core.palette import FractalPalette
from fractalshark_tpu.core.pointzoom import PointZoomBBConverter
from fractalshark_tpu.core.precision import precision_from_view
from fractalshark_tpu.core.views import get_view_preset
from fractalshark_tpu.ops import escape
from fractalshark_tpu.ops.coloring import (color_from_iters, iteration_stats,
                                           rgba16_to_rgba8)
from fractalshark_tpu.io.png import write_png


@dataclass
class BenchmarkData:
    """Phase timers (reference BenchmarkData.h:28-46)."""
    overall_s: float = 0.0
    per_pixel_s: float = 0.0
    ref_orbit_s: float = 0.0
    la_generation_s: float = 0.0
    extra: dict = field(default_factory=dict)


class Fractal:
    def __init__(self, width: int = 1024, height: int = 1024,
                 view: int | PointZoomBBConverter = 0,
                 algorithm: str = "AUTO",
                 num_iterations: int | None = None,
                 antialiasing: int = 1,
                 backend: str | None = None,
                 compression_error_exp: int = 20):
        self.width = width
        self.height = height
        self.antialiasing = antialiasing
        # SimpleCompression error exponent (10^-exp/2 relative bound;
        # reference default 20 — DefaultCompressionErrorExp)
        self.compression_error_exp = compression_error_exp
        # optional AbortMonitor: chunked kernels poll it between
        # bounded dispatches (AbortMonitor.h:7-35 semantics)
        self.abort_monitor = None
        self.la_parameters = None  # None = LAParameters defaults
        self.palette = FractalPalette()
        self.backend = backend or jax.default_backend()
        self.algorithm_name = algorithm
        self.num_iterations = 256
        self.benchmark = BenchmarkData()
        self._iters_cache = None  # last rendered iteration buffer (device)
        self._orbit_cache = None  # RefOrbitCache, created lazily
        if isinstance(view, PointZoomBBConverter):
            self.ptz = view.square_aspect_ratio(width, height)
        else:
            self.set_view_preset(view)
        if num_iterations is not None:
            # an explicit budget overrides the preset's default
            self.num_iterations = num_iterations

    # ----------------------------------------------------------- navigation

    def set_view_preset(self, index: int) -> None:
        preset = get_view_preset(index)
        self.ptz = preset.ptz.square_aspect_ratio(self.width, self.height)
        self.num_iterations = preset.num_iterations
        if preset.antialiasing > 1:
            self.antialiasing = preset.antialiasing
        self._iters_cache = None

    def set_view(self, ptz: PointZoomBBConverter,
                 square_aspect: bool = True) -> None:
        self.ptz = (ptz.square_aspect_ratio(self.width, self.height)
                    if square_aspect else ptz)
        self._iters_cache = None

    def zoom(self, scale: float) -> None:
        self.ptz = self.ptz.zoomed_at_center(scale)
        self._iters_cache = None

    def zoom_at(self, screen_x: float, screen_y: float, scale: float) -> None:
        cx = self.ptz.x_screen_to_calc(screen_x, self.width)
        cy = self.ptz.y_screen_to_calc(screen_y, self.height)
        self.ptz = self.ptz.zoomed_toward_point(cx, cy, scale)
        self._iters_cache = None

    def pan(self, dx_frac: float, dy_frac: float) -> None:
        """Pan by a fraction of the current extent."""
        ex = self.ptz.max_x - self.ptz.min_x
        ey = self.ptz.max_y - self.ptz.min_y
        self.ptz = self.ptz.panned(ex * HighPrecision(dx_frac),
                                   ey * HighPrecision(dy_frac))
        self._iters_cache = None

    def resize(self, width: int, height: int) -> None:
        self.width, self.height = width, height
        self.ptz = self.ptz.square_aspect_ratio(width, height)
        self._iters_cache = None

    # --------------------------------------------------------- feature find

    def try_find_periodic_point(self, max_period: int | None = None,
                                method: str = "newton",
                                checkpoint_path: str | None = None):
        """Find + refine a minibrot near the view center
        (Fractal::TryFindPeriodicPoint, Fractal.cpp:1847)."""
        from fractalshark_tpu.engine.feature_finder import \
            find_periodic_point
        return find_periodic_point(
            self.ptz, max_period or min(self.num_iterations, 1_000_000),
            method=method, checkpoint_path=checkpoint_path)

    def zoom_to_feature(self, feature, frame_scale: float = 8.0) -> None:
        """Recenter on a found feature, framed a few× its size."""
        size = feature.size_estimate
        zoom = HighPrecision.from_mant_exp(
            int(frame_scale * 16), -size.e - 4, prec=64)
        self.set_view(PointZoomBBConverter(
            pt_x=feature.center_x, pt_y=feature.center_y,
            zoom_factor=zoom))

    # ------------------------------------------------------------ algorithm

    def resolve_algorithm(self) -> RenderAlgorithm:
        alg = get_algorithm(self.algorithm_name)
        if alg.family is Family.AUTO:
            radius_exp = abs(self.ptz.radius.exponent2())
            alg = auto_select(radius_exp,
                              has_accelerator=self.backend != "cpu")
        return alg

    def required_precision(self, requires_reuse: bool = False) -> int:
        return precision_from_view(self.ptz, requires_reuse)

    # --------------------------------------------------------------- render

    def calc_fractal(self) -> jnp.ndarray:
        """Compute the iteration buffer [H*aa, W*aa] on device.

        Dispatch mirrors Fractal::CalcFractalTypedIter
        (Fractal.cpp:1199-1530), collapsed to family×dtype.
        """
        alg = self.resolve_algorithm()
        t0 = time.perf_counter()
        if alg.family is Family.DIRECT:
            iters = self._calc_direct(alg)
        elif alg.is_perturbed:
            iters = self._calc_perturbed(alg)
        else:
            raise NotImplementedError(f"family {alg.family}")
        iters.block_until_ready()
        self.benchmark.per_pixel_s = time.perf_counter() - t0
        self._iters_cache = iters
        return iters

    def _render_dims(self) -> tuple[int, int]:
        return (self.width * self.antialiasing,
                self.height * self.antialiasing)

    def _calc_direct(self, alg: RenderAlgorithm) -> jnp.ndarray:
        w, h = self._render_dims()
        params = escape.PlainParams.from_view(
            self.ptz, self.width, self.height, self.antialiasing)
        n = self.num_iterations
        if alg.dtype in ("f32", "f64"):
            dt = jnp.float32 if alg.dtype == "f32" else jnp.float64
            return escape.escape_jax(params, w, h, n, dtype=dt)
        if alg.dtype in ("2x32", "2x64"):
            from fractalshark_tpu.ops import dblflt
            # pass the high-precision view: (hi, lo) splits must be exact
            return dblflt.escape_df(self.ptz, w, h, n, variant=alg.dtype)
        if alg.dtype in ("4x32", "4x64"):
            # true renormalizing QD (ops/quadd.py) — the reference's
            # GQF/GQD class; the compensated QF path remains as the
            # faster lower-precision alternative
            from fractalshark_tpu.ops import quadd
            return quadd.escape_qd(self.ptz, w, h, n, variant=alg.dtype)
        if alg.dtype in ("hdr32", "hdr64"):
            from fractalshark_tpu.ops import hdr_escape
            return hdr_escape.escape_hdr(
                self.ptz, w, h, n,
                sub_dtype=jnp.float32 if alg.dtype == "hdr32" else jnp.float64)
        if alg.dtype == "hp":
            return self._calc_cpu_high()
        raise NotImplementedError(f"direct dtype {alg.dtype}")

    def _calc_cpu_high(self) -> jnp.ndarray:
        """CpuHigh: full arbitrary-precision per-pixel iteration on host.
        Educational/oracle path (tiny images only)."""
        w, h = self._render_dims()
        prec = self.required_precision()
        out = np.zeros((h, w), np.uint64)
        four = HighPrecision(4, prec=prec)
        dx = self.ptz.delta_x(self.width, self.antialiasing)
        dy = self.ptz.delta_y(self.height, self.antialiasing)
        for y in range(h):
            cy = self.ptz.max_y - dy * HighPrecision(y)
            for x in range(w):
                cx = self.ptz.min_x + dx * HighPrecision(x)
                zx, zy = cx, cy
                i = 0
                n = self.num_iterations
                while i < n:
                    zx2 = zx * zx
                    zy2 = zy * zy
                    if zx2 + zy2 > four:
                        break
                    zy = zx * zy * 2 + cy
                    zx = zx2 - zy2 + cx
                    i += 1
                out[y, x] = i
        return jnp.asarray(out)

    def _calc_perturbed(self, alg: RenderAlgorithm) -> jnp.ndarray:
        from fractalshark_tpu.engine.renderers import calc_perturbed
        return calc_perturbed(self, alg)

    # --------------------------------------------------------------- output

    def color(self, iters=None) -> jnp.ndarray:
        """Map the iteration buffer to RGBA16 [H, W, 4]."""
        if iters is None:
            iters = (self._iters_cache if self._iters_cache is not None
                     else self.calc_fractal())
        pal = np.roll(self.palette.current(), -self.palette.rotation, axis=0)
        return color_from_iters(
            iters, jnp.asarray(pal),
            jnp.asarray(self.num_iterations, jnp.uint64),
            jnp.asarray(self.palette.aux_depth, jnp.uint32),
            antialiasing=self.antialiasing)

    def stats(self, iters=None) -> dict:
        if iters is None:
            iters = (self._iters_cache if self._iters_cache is not None
                     else self.calc_fractal())
        return {k: int(v) for k, v in iteration_stats(iters).items()}

    def render(self) -> jnp.ndarray:
        t0 = time.perf_counter()
        fused = self._render_fused_direct()
        if fused is not None:
            iters, rgba = fused
            self._iters_cache = iters
        else:
            iters = self.calc_fractal()
            rgba = self.color(iters)
        rgba.block_until_ready()
        self.benchmark.overall_s = time.perf_counter() - t0
        return rgba

    def _render_fused_direct(self):
        """ONE device dispatch for direct escape renders: iterate +
        color in the same jit program (the reference similarly runs its
        reductions/AA in the render stream, ReductionKernels.cuh).
        Returns (iters, rgba) or None when not applicable."""
        alg = self.resolve_algorithm()
        if alg.family is not Family.DIRECT or \
                alg.dtype not in ("f32", "f64") or \
                self.num_iterations >= (1 << 31):
            return None
        w, h = self._render_dims()
        params = escape.PlainParams.from_view(
            self.ptz, self.width, self.height, self.antialiasing)
        pal = np.roll(self.palette.current(), -self.palette.rotation,
                      axis=0)
        dt = jnp.float32 if alg.dtype == "f32" else jnp.float64
        t0 = time.perf_counter()
        iters, rgba = _fused_escape_color(
            jnp.asarray([params.min_x, params.max_y, params.dx,
                         params.dy], jnp.float64),
            jnp.asarray(pal),
            jnp.asarray(self.num_iterations, jnp.uint64),
            jnp.asarray(self.palette.aux_depth, jnp.uint32),
            w, h, int(self.num_iterations), dt.dtype.name,
            self.antialiasing)
        self.benchmark.per_pixel_s = time.perf_counter() - t0
        return iters, rgba

    # (fused direct path uses module-level _fused_escape_color below)

    def save_png(self, path: str, bit_depth: int = 8) -> None:
        rgba = np.asarray(self.render())
        if bit_depth == 8:
            write_png(path, rgba16_to_rgba8(rgba))
        else:
            write_png(path, rgba)

    # -------------------------------------------------------- orbit persist

    def save_ref_orbit(self, path: str, compression: str = "simple") -> None:
        """Persist the last-used reference orbit
        (Fractal::SaveRefOrbit, Fractal.h:231-240). `compression`:
        "none" | "simple" | "max" (own format, Zhuoran/CompressMax) |
        "imagina" (.im binary). The error exponent comes from
        ``self.compression_error_exp`` (CLI --compression-error-exp-low,
        reference default 20)."""
        from fractalshark_tpu.engine.renderers import get_orbit_calc
        calc = get_orbit_calc(self)
        if not calc.cache:
            raise RuntimeError("no reference orbit computed yet")
        results = calc.cache[-1]
        if compression == "imagina":
            from fractalshark_tpu.io.imagina import save_orbit_im
            save_orbit_im(path, results, comp=results.compress(
                self.compression_error_exp))
        else:
            results.save(path, compression=compression,
                         error_exp=self.compression_error_exp)

    def load_ref_orbit(self, path: str, imagina: bool | None = None):
        """Load an orbit (and adopt its recommended view/iterations —
        RecommendedSettings, RefOrbitCalc.cpp:3483)."""
        from fractalshark_tpu.engine.renderers import get_orbit_calc
        if imagina is None:
            imagina = path.endswith(".im")
        if imagina:
            from fractalshark_tpu.io.imagina import (OrbitParameterPack,
                                                     load_orbit_im)
            f = load_orbit_im(path)
            results = f.results
            if results is None:
                raise ValueError("location-only .im file: no orbit data")
            pack = OrbitParameterPack(f)
            self.set_view(pack.view())
            self.num_iterations = min(f.iteration_limit, 1 << 62)
            # RecommendedSettings: re-derive the algorithm (and 32/64-
            # bit iteration type) for the loaded orbit's depth — only
            # when the user left the choice on AUTO (an explicit
            # algorithm wins, like the reference's menu selection)
            from fractalshark_tpu.core.algorithms import Family, \
                get_algorithm
            if get_algorithm(self.algorithm_name).family is Family.AUTO:
                self.algorithm_name = pack.recommended_algorithm(
                    has_accelerator=self.backend != "cpu").name
        else:
            from fractalshark_tpu.engine.perturbation_results import \
                PerturbationResults
            results = PerturbationResults.load(path)
        calc = get_orbit_calc(self)
        with calc.lock:
            calc.cache.append(results)
        return results

    @staticmethod
    def diff_ref_orbits(a, b, count: int | None = None) -> dict:
        """Numeric comparison of two orbits (Fractal::DiffRefOrbits,
        Fractal.h:232-235)."""
        n = count or min(a.count_orbit_entries(), b.count_orbit_entries())
        dx = np.abs(a.orbit_x[:n] - b.orbit_x[:n])
        dy = np.abs(a.orbit_y[:n] - b.orbit_y[:n])
        return {
            "compared": n,
            "max_abs_dx": float(dx.max()) if n else 0.0,
            "max_abs_dy": float(dy.max()) if n else 0.0,
            "first_diff": int(np.argmax((dx > 0) | (dy > 0))) if
            ((dx > 0) | (dy > 0)).any() else -1,
            "period_match": a.period == b.period,
        }

    def save_iters_as_text(self, path: str) -> None:
        """Dump the iteration buffer as text (Fractal::SaveItersAsText)."""
        iters = (self._iters_cache if self._iters_cache is not None
                 else self.calc_fractal())
        np.savetxt(path, np.asarray(iters), fmt="%d")

    def render_to_console(self, max_width: int = 100, ansi: bool = True) -> str:
        """ASCII/ANSI console render (reference RenderToConsole.cpp)."""
        iters = np.asarray(self.calc_fractal())
        h, w = iters.shape
        step = max(1, w // max_width)
        small = iters[::step * 2, ::step]  # chars are ~2x tall
        n = self.num_iterations
        glyphs = " .:-=+*#%@"
        lines = []
        for row in small:
            if ansi:
                cells = []
                for v in row:
                    if v >= n:
                        cells.append("\x1b[40m \x1b[0m")
                    else:
                        hue = int(v) % 6
                        cells.append(f"\x1b[4{hue + 1}m \x1b[0m")
                lines.append("".join(cells))
            else:
                lines.append("".join(
                    glyphs[min(int(v) * (len(glyphs) - 1) // max(1, n),
                               len(glyphs) - 1)] if v < n else " "
                    for v in row))
        return "\n".join(lines)


@functools.partial(jax.jit, static_argnames=("w", "h", "max_iter",
                                             "dtype_name", "aa"))
def _fused_escape_color(scal, pal, n_iter_u64, aux_depth, w, h,
                        max_iter, dtype_name, aa):
    """iterate + color as ONE compiled program (single dispatch)."""
    dt = jnp.dtype(dtype_name)
    p = escape.PlainParams(min_x=scal[0], max_y=scal[1],
                           dx=scal[2], dy=scal[3])
    iters = escape.escape_jax(p, w, h, max_iter, dtype=dt)
    rgba = color_from_iters(iters, pal, n_iter_u64, aux_depth,
                            antialiasing=aa)
    return iters, rgba
