"""Perturbed-render orchestration: orbit acquisition → delta kernels.

The analogue of the reference's CalcGpuPerturbationFractal* /
CalcCpuPerturbationFractal* family (``Fractal.cpp:2230-2790``): fetch or
compute a reference orbit (cached), build the per-pixel delta grid, run
the dtype-appropriate delta kernel.  LAv2 algorithms run {AT skip → LA
stepping → perturbation tail}; PO mode is the pure perturbation tail.
RC ("runtime decompression") algorithms render from the compressed
orbit and never upload the uncompressed one.
"""

from __future__ import annotations

import time

import numpy as np

from fractalshark_tpu.core.algorithms import Family, LAMode, RenderAlgorithm
from fractalshark_tpu.engine.reforbit import RefOrbitCalc
from fractalshark_tpu.ops import perturb


def get_orbit_calc(fractal) -> RefOrbitCalc:
    if fractal._orbit_cache is None:
        fractal._orbit_cache = RefOrbitCalc()
    return fractal._orbit_cache


def calc_perturbed(fractal, alg: RenderAlgorithm):
    w, h = fractal._render_dims()
    calc = get_orbit_calc(fractal)

    t0 = time.perf_counter()
    results = calc.get_and_create_useful_results(
        fractal.ptz, fractal.num_iterations)
    fractal.benchmark.ref_orbit_s = time.perf_counter() - t0
    fractal.benchmark.extra.update(calc.last_details)

    use_la = (alg.family is Family.PERTURB_LAV2 and
              alg.la_mode in (LAMode.FULL, LAMode.LAO))
    la = None
    if use_la:
        from fractalshark_tpu.engine.la_reference import get_or_build_la
        t0 = time.perf_counter()
        la = get_or_build_la(fractal, results)
        fractal.benchmark.la_generation_s = time.perf_counter() - t0
    sub = np.float32 if alg.dtype in ("f32", "hdr32", "2x32",
                                      "hdr2x32") else np.float64

    if alg.runtime_decompression:
        return rc_render(fractal, results, alg, la, w, h, sub)

    if la is not None:
        if alg.la_mode is LAMode.LAO:
            from fractalshark_tpu.ops import la_kernel
            fractal.benchmark.extra["kernel"] = "lav2-lao"
            return la_kernel.la_perturb_render(
                results, la, fractal.ptz, w, h, fractal.num_iterations,
                sub_dtype=sub, la_only=True,
                abort_monitor=fractal.abort_monitor)
        # two-phase measured faster than the one-kernel machine at the
        # 1024² and 2048² View #6 renders on an H100 (PERF.md)
        fractal.benchmark.extra["kernel"] = "lav2"
        return two_phase_render(results, la, fractal.ptz, w, h,
                                fractal.num_iterations,
                                abort_monitor=fractal.abort_monitor,
                                sub_dtype=sub)

    if alg.family is Family.PERTURB_SCALED:
        from fractalshark_tpu.ops import scaled
        iters, stats = scaled.perturb_render_scaled(
            results, fractal.ptz, w, h, fractal.num_iterations,
            return_stats=True)
        fractal.benchmark.extra.update(stats)
        return iters

    if alg.family is Family.PERTURB_BLA:
        from fractalshark_tpu.engine.bla import get_or_build_bla
        from fractalshark_tpu.ops import bla_kernel
        t0 = time.perf_counter()
        bla = get_or_build_bla(results)
        fractal.benchmark.extra["bla_build_s"] = time.perf_counter() - t0
        sub = np.float32 if alg.dtype in ("f32", "hdr32") else np.float64
        return bla_kernel.bla_perturb_render(
            results, bla, fractal.ptz, w, h, fractal.num_iterations,
            sub_dtype=sub)

    if alg.dtype in ("f32", "f64"):
        dt = np.float32 if alg.dtype == "f32" else np.float64
        return perturb.perturb_render_float(
            results, fractal.ptz, w, h, fractal.num_iterations, dtype=dt)
    if alg.dtype in ("hdr2x32", "2x32"):
        # double-float mantissa + HDR exponent (~48 bits): the depth
        # band where f32 glitches but f64 throughput is poor
        # (reference HDRx2x32 kernels, GPU_Render.cu)
        from fractalshark_tpu.ops.hdr_df import perturb_render_hdr_df
        fractal.benchmark.extra["kernel"] = "hdr-df"
        return perturb_render_hdr_df(
            results, fractal.ptz, w, h, fractal.num_iterations)

    if alg.dtype in ("hdr32", "hdr64"):
        return perturb.perturb_render_hdr(
            results, fractal.ptz, w, h, fractal.num_iterations,
            sub_dtype=sub)
    raise NotImplementedError(f"perturbed dtype {alg.dtype}")


def compressed_orbit(results, error_exp: int):
    """The SimpleCompression form of ``results`` at ``error_exp``,
    cached on the results object (one compression per orbit)."""
    from fractalshark_tpu.engine.perturbation_results import \
        CompressedOrbit
    cache = results.extra.setdefault("compressed_orbit", {})
    if error_exp not in cache:
        cache[error_exp] = CompressedOrbit.from_uncompressed(
            results, error_exp=error_exp)
    return cache[error_exp]


def rc_render(fractal, results, alg: RenderAlgorithm, la, w, h, sub):
    """Runtime-decompression render: the device only ever holds the
    compressed orbit's anchors (the reference decompresses inside the
    render kernel, Perturb.cuh:8-120).  LA stepping runs on a
    ``VirtualResults`` stand-in (its tail branch never reads the orbit);
    the perturbation tail reconstructs reference values from the anchors
    (ops/rc_tail.py).  Without an LA table the tail starts from fresh
    pixels."""
    from fractalshark_tpu.engine.perturbation_results import \
        VirtualResults
    from fractalshark_tpu.ops import la_kernel
    from fractalshark_tpu.ops.rc_tail import rc_tail_gather

    comp = compressed_orbit(results, fractal.compression_error_exp)
    fractal.benchmark.extra["compression_ratio"] = round(
        comp.compression_ratio(), 2)
    n = fractal.num_iterations
    if la is None:
        fractal.benchmark.extra["kernel"] = "rc"
        return rc_tail_gather(
            comp, results.center_x, results.center_y, fractal.ptz, w, h, n,
            abort_monitor=fractal.abort_monitor, sub_dtype=sub)
    virt = VirtualResults.from_compressed(comp, results.center_x,
                                          results.center_y)
    if alg.la_mode is LAMode.LAO:
        fractal.benchmark.extra["kernel"] = "lav2-rc-lao"
        return la_kernel.la_perturb_render(
            virt, la, fractal.ptz, w, h, n, sub_dtype=sub, la_only=True,
            abort_monitor=fractal.abort_monitor)
    fractal.benchmark.extra["kernel"] = "lav2-rc"
    return two_phase_render(virt, la, fractal.ptz, w, h, n, comp=comp,
                            abort_monitor=fractal.abort_monitor,
                            sub_dtype=sub)


def two_phase_render(results, la, ptz, w, h, n, *, comp=None,
                     abort_monitor=None, sub_dtype=np.float32):
    """Two-phase LAv2 deep render: phase 1 runs the LA machine to tail
    entry (la_only + state export); phase 2 finishes every pixel in the
    gather tail from its per-pixel orbit position (ops/rc_tail.py).
    ``comp`` is the compressed orbit the tail reads (default: identity
    anchors of ``results``, i.e. an exact evaluator of the uncompressed
    orbit).  ``results`` may be a ``VirtualResults``: phase 1 never reads
    the orbit."""
    import jax.numpy as jnp

    from fractalshark_tpu.engine.perturbation_results import \
        CompressedOrbit
    from fractalshark_tpu.ops import la_kernel
    from fractalshark_tpu.ops.rc_tail import rc_tail_gather

    if comp is None:
        comp = results.extra.get("identity_compressed")
        if comp is None:
            comp = CompressedOrbit.identity(results)
            results.extra["identity_compressed"] = comp
    state = la_kernel.la_perturb_render(
        results, la, ptz, w, h, n, sub_dtype=sub_dtype,
        la_only=True, return_state=True, abort_monitor=abort_monitor)
    _, _, ref_iter, dzr, dzi, dze, it, _ = state
    init = {"dzr": dzr, "dzi": dzi, "dze": dze, "it": it,
            "jwait": ref_iter, "done": (it >= n).astype(jnp.int32)}
    return rc_tail_gather(
        comp, results.center_x, results.center_y, ptz, w, h, n,
        init_state=init, abort_monitor=abort_monitor, sub_dtype=sub_dtype)
