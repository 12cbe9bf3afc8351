"""Smoke test of the renderer on one NVIDIA GPU, through the entry points
a user calls (``Fractal``, ``fractalshark_tpu.cli.main``,
``server.RenderServer``), at the sizes users render.

    python chip_smoke.py            # phases 1-6 on one GPU
    python chip_smoke.py --view30   # View #30 end to end (one GPU)
    python chip_smoke.py --four     # the four-GPU mesh path only

Every phase prints its numbers on lines of its own.  The last line of
standard output is one JSON object,
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}``,
printed only when every phase passed.  The script exits non-zero, and
prints no such line, when a phase fails, when JAX finds no GPU, or when
the ``fractalshark_tpu`` package is not importable.

Comparisons, and why each tolerance is what it is:

* integer paths are exact: NTT digits and the device reference orbit
  (against Python-int arithmetic), the orbit period, the mesh-sharded
  orbit and render (against the single-GPU run); the session's stored
  f64 orbit, which rounds the top digits on its own, agrees with the
  host Python-int orbit to 1e-14;
* float renders run in f32/HDR-f32 and are compared with the same
  algorithm on the CPU backend of the same process.  XLA's GPU backend
  contracts multiply-adds into FMAs (as nvcc does for the reference's
  CUDA kernels) and the CPU backend rounds them separately, so a pixel
  near an escape or rebase threshold can take another iteration count.
  Bounds: at most ``PIXEL_TOL`` of the pixels differ and the iteration
  sums differ by at most ``SUM_TOL`` (relative).  On an H100 the f32
  View #0 render at 1024² differs on 0.106% of its pixels and by 2.9e-5
  in iteration sum: chaotic boundary pixels of a 512-iteration f32
  escape, above the 0.1% first guess, hence 0.2%;
* deep LAv2 renders with f32 HDR mantissas: the minor component of a
  shared-exponent complex reaches the denormal range, which XLA's CPU
  runtime flushes to zero and its GPU backend keeps.  On View #6 at
  128² the two runs then differ on ~90% of the pixels by ~100 of
  ~800,000 iterations (iteration sums 1.3e-4 apart), so only the sum is
  bounded, by ``DENORMAL_SUM_TOL``; the same renders with f64
  mantissas, which stay clear of denormals, are held to the pixel
  bounds above;
* double-float renders: Gpu4x32 equals the arbitrary-precision oracle;
  Gpu2x32 (~48 bits) may differ from it on chaotic pixels, but no more
  on the card than on the CPU plus ``DF_MARGIN``.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import subprocess
import sys
import tempfile
import threading
import time

PIXEL_TOL = 2e-3
REL_TOL = 1e-4
SUM_TOL = 1e-4
DENORMAL_SUM_TOL = 2e-4
DF_MARGIN = 0.02

# View #30 facts (the image, not the hardware): its reference orbit's
# period at 16384 limbs and the 512x512 LAv2 iteration sum.
VIEW30_PERIOD = 669_773
VIEW30_ITER_SUM = 351_206_692_131


def log(msg: str) -> None:
    print(msg, flush=True)


class PhaseError(RuntimeError):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise PhaseError(msg)


def compare_float(name: str, got, want, denormal_sensitive=False) -> None:
    """Float-render comparison under PIXEL_TOL / REL_TOL / SUM_TOL, or,
    for a render whose card and CPU runs differ in denormal handling,
    under DENORMAL_SUM_TOL on the iteration sum alone."""
    import numpy as np
    got = np.asarray(got).astype(np.int64)
    want = np.asarray(want).astype(np.int64)
    check(got.shape == want.shape, f"{name}: shape {got.shape} != "
          f"{want.shape}")
    d = np.abs(got - want)
    exact = float((d != 0).mean())
    diff = float((d > REL_TOL * np.maximum(want, 1)).mean())
    s_got, s_want = int(got.sum()), int(want.sum())
    rel = abs(s_got - s_want) / max(1, s_want)
    log(f"  {name}: pixels differing {exact:.6%} (by more than "
        f"{REL_TOL:g} relative: {diff:.6%}), iter_sum card {s_got} vs "
        f"cpu {s_want} (rel {rel:.3e})")
    if denormal_sensitive:
        check(rel <= DENORMAL_SUM_TOL,
              f"{name}: iter_sum differs by {rel:.3e}")
        return
    check(diff <= PIXEL_TOL, f"{name}: {diff:.4%} of pixels differ")
    check(rel <= SUM_TOL, f"{name}: iter_sum differs by {rel:.3e}")


def cli_stats(argv, orbit_calc=None) -> dict:
    """Run ``cli.main(argv + ['--stats'])`` in-process; returns the stats
    JSON it printed, with the wall time around the call."""
    from fractalshark_tpu import cli
    out = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        rc = cli.main(list(argv) + ["--stats"], orbit_calc=orbit_calc)
    wall = time.perf_counter() - t0
    check(rc == 0, f"cli {argv} returned {rc}")
    stats = json.loads(out.getvalue().strip().splitlines()[-1])
    stats["call_s"] = wall
    return stats


def cli_iters(argv, orbit_calc, device):
    """The iteration grid of a CLI-equivalent render on ``device``."""
    import jax
    import numpy as np
    from fractalshark_tpu.engine.fractal import Fractal
    opts = dict(zip(argv[::2], argv[1::2]))
    with jax.default_device(device):
        f = Fractal(width=int(opts["--width"]), height=int(opts["--height"]),
                    algorithm=opts["--render-algorithm"])
        f.set_view_preset(int(opts["--view"]))
        f._orbit_cache = orbit_calc
        return np.asarray(f.calc_fractal())


# ------------------------------------------------------------------ phases


def phase_report():
    import jax
    import fractalshark_tpu
    from fractalshark_tpu.engine import native_orbit
    devs = jax.devices()
    log(f"[1] jax {jax.__version__}, devices: "
        + ", ".join(f"{d} ({d.device_kind})" for d in devs))
    check(devs[0].platform == "gpu", f"no GPU: platform {devs[0].platform}")
    log(f"[1] compile cache: {jax.config.jax_compilation_cache_dir} "
        f"(package default {fractalshark_tpu.compile_cache_dir()})")
    log(f"[1] host orbit backend: "
        f"{'native' if native_orbit.available() else 'python'}")
    return devs


def phase_direct(cpu):
    import jax
    import jax.numpy as jnp
    from fractalshark_tpu.engine.fractal import Fractal
    from fractalshark_tpu.ops import escape
    f = Fractal(width=4096, height=4096, view=0, algorithm="AUTO",
                num_iterations=512)
    alg = f.resolve_algorithm().name
    log(f"[2] AUTO resolved to {alg}")
    check(alg == "Gpu1x32", f"AUTO resolved to {alg}, not Gpu1x32")
    for run in ("cold", "warm"):
        t0 = time.perf_counter()
        f.render()
        dt = time.perf_counter() - t0
        log(f"[2] View #0 4096^2 512 it render ({run}): {dt:.4f} s, "
            f"{4096 * 4096 / dt / 1e6:.1f} Mpix/s")
    g = Fractal(width=1024, height=1024, view=0, algorithm="AUTO",
                num_iterations=512)
    card = g.calc_fractal()
    params = escape.PlainParams.from_view(g.ptz, 1024, 1024)
    with jax.default_device(cpu):
        ref = escape.escape_jax(params, 1024, 1024, 512, dtype=jnp.float32)
    compare_float("View #0 1024^2 Gpu1x32 vs escape_jax on cpu", card, ref)


def phase_double_float(cpu):
    """Error-free transforms under the GPU compiler: two_prod exact on
    the card, and the double-float renders against the host
    arbitrary-precision oracle (CpuHigh) on 256 pixels."""
    from fractions import Fraction
    import jax
    import jax.numpy as jnp
    import numpy as np
    from fractalshark_tpu.core.pointzoom import PointZoomBBConverter
    from fractalshark_tpu.engine.fractal import Fractal
    from fractalshark_tpu.ops import dblflt
    rng = np.random.default_rng(1)
    for dt, er in ((np.float32, 20), (np.float64, 200)):
        a = (rng.standard_normal(4096)
             * np.exp2(rng.integers(-er, er, 4096))).astype(dt)
        b = (rng.standard_normal(4096)
             * np.exp2(rng.integers(-er, er, 4096))).astype(dt)
        p, e = jax.jit(dblflt.two_prod)(jnp.asarray(a), jnp.asarray(b))
        bad = sum(Fraction(float(x)) * Fraction(float(y))
                  != Fraction(float(u)) + Fraction(float(v))
                  for x, y, u, v in zip(a, b, np.asarray(p), np.asarray(e)))
        log(f"[2] two_prod {np.dtype(dt).name} on the card: {bad} of "
            f"4096 products not error-free")
        check(bad == 0, f"two_prod {np.dtype(dt).name} not exact on GPU")
    ptz = PointZoomBBConverter(
        pt_x="-0.743643887037158704752191506114774",
        pt_y="0.131825904205311970493132056385139",
        zoom_factor="1e10", prec=256)

    def iters(alg, device):
        with jax.default_device(device):
            f = Fractal(16, 16, view=ptz, algorithm=alg,
                        num_iterations=500)
            return np.asarray(f.calc_fractal()).astype(np.int64)

    oracle = iters("CpuHigh", cpu)
    for alg in ("Gpu2x32", "Gpu4x32"):
        card, host = iters(alg, jax.devices()[0]), iters(alg, cpu)
        e_card = float((card != oracle).mean())
        e_host = float((host != oracle).mean())
        log(f"[2] {alg} 16^2 at 1e10: card differs from CpuHigh on "
            f"{e_card:.2%} of pixels, the cpu run on {e_host:.2%}")
        if alg == "Gpu4x32":
            check(e_card == 0.0, "Gpu4x32 on the card != CpuHigh")
        check(e_card <= e_host + DF_MARGIN, f"{alg} drifts on the card")


def phase_deep(cpu, gpu):
    from fractalshark_tpu.engine.reforbit import RefOrbitCalc
    from fractalshark_tpu.utils.profiling import device_time_ms
    calc = RefOrbitCalc()
    lav2 = ["--view", "6", "--width", "1024", "--height", "1024",
            "--render-algorithm", "GpuHDRx32PerturbedLAv2"]
    prof = {}

    def render():
        prof["stats"] = cli_stats(lav2, calc)

    # a later frame can still compile a rung of the dispatch ladder, so
    # the trace is taken on the third frame
    for run in ("cold", "warm", "traced"):
        if run == "traced":
            tr = device_time_ms(render)
        else:
            render()
        s = prof["stats"]
        log(f"[3] View #6 1024^2 {s['algorithm']} ({run}): wall "
            f"{s['wall_s']} s, iter_sum {s['iter_sum']}, "
            f"kernel {s['kernel']}")
    log(f"[6] profiler around the traced render: device busy "
        f"{tr['busy_ms']:.1f} ms of {tr['window_ms']:.1f} ms window "
        f"(idle share {tr['idle_share']:.3f}), kernel time "
        f"{tr['total_ms']:.1f} ms in {tr['events']} kernel events")
    for name, ms in tr["top"][:8]:
        log(f"[6]   {ms:9.2f} ms  {name[:100]}")
    check(tr["total_ms"] > 0 and tr["events"] > 0,
          f"profiler found no GPU kernels: {tr.get('error')}")
    check(any(not n.startswith(("jit_", "jit(")) for n, _ in tr["top"]),
          "profiler rollup filter left only module events")
    rc = ["--view", "6", "--width", "512", "--height", "512",
          "--render-algorithm", "GpuHDRx32PerturbedRCLAv2"]
    for run in ("cold", "warm", "warm"):
        s = cli_stats(rc, calc)
        log(f"[3] View #6 512^2 {s['algorithm']} ({run}): wall "
            f"{s['wall_s']} s, iter_sum {s['iter_sum']}, "
            f"kernel {s['kernel']}")
    check(s["kernel"] == "lav2-rc", f"RC route is {s['kernel']}")
    cpu_calc = RefOrbitCalc()      # host orbit + LA tables of the cpu run
    for alg in ("GpuHDRx64PerturbedLAv2", "GpuHDRx64PerturbedRCLAv2",
                "GpuHDRx32PerturbedLAv2", "GpuHDRx32PerturbedRCLAv2"):
        small = ["--view", "6", "--width", "128", "--height", "128",
                 "--render-algorithm", alg]
        card = cli_iters(small, calc, gpu)
        ref = cli_iters(small, cpu_calc, cpu)
        compare_float(f"View #6 128^2 {alg} card vs cpu", card, ref,
                      denormal_sensitive="HDRx32" in alg)


def phase_orbit():
    import jax
    import jax.numpy as jnp
    import numpy as np
    from fractalshark_tpu.core.highprecision import HighPrecision
    from fractalshark_tpu.core.views import get_view_preset
    from fractalshark_tpu.engine.reforbit import compute_reference_orbit
    from fractalshark_tpu.ops.bignum import fixedpoint as FP
    from fractalshark_tpu.ops.bignum.orbit import (TpuOrbitSession,
                                                   orbit_chunk)
    from fractalshark_tpu.utils.profiling import device_time_ms
    limbs, steps = 16384, 2048
    spec = FP.FixedSpec.for_limbs(limbs)
    prec = spec.frac_bits - 20
    v30 = get_view_preset(30).ptz
    cx = v30.pt_x.with_precision(prec)
    cy = v30.pt_y.with_precision(prec)
    scx, dcx = FP.hp_to_digits(cx, spec)
    scy, dcy = FP.hp_to_digits(cy, spec)
    c = (jnp.int32(scx), jnp.asarray(dcx), jnp.int32(scy), jnp.asarray(dcy))
    dz0 = (jnp.float64(1.0), jnp.float64(0.0), jnp.int32(0))
    consts = (jnp.float64(1.0), jnp.int32(-40),
              jnp.float64(float(cx)), jnp.float64(float(cy)))
    # exactness: 32 iterations of z <- z^2 + c from z = c against Python
    # ints with the device's rounding (round half up at 16·F bits)
    st, _ = orbit_chunk(*c, *dz0, *c, *consts, spec=spec, steps=32)
    F = spec.frac_digits
    half, shift = 1 << (16 * F - 1), 16 * F

    def rhu(v):
        t = v + half
        return (1 if t >= 0 else -1) * (abs(t) >> shift)

    ci_x = scx * FP.digits_to_int(dcx)
    ci_y = scy * FP.digits_to_int(dcy)
    x, y = ci_x, ci_y
    for _ in range(32):
        x, y = rhu(x * x - y * y + (ci_x << shift)), \
            rhu(2 * x * y + (ci_y << shift))
    got_x = int(np.asarray(st[0])) * FP.digits_to_int(np.asarray(st[1]))
    got_y = int(np.asarray(st[2])) * FP.digits_to_int(np.asarray(st[3]))
    check(got_x == x and got_y == y,
          "device orbit digits differ from Python ints after 32 steps")
    log(f"[4] {limbs}-limb device orbit: 32 iterations bit-identical to "
        f"Python-int arithmetic on the View #30 center")
    # the orbit the session stores (f64 shadows of the digits) against
    # the host Python-int orbit, as tests/test_device_orbit_session.py
    # does at small sizes: the shadows round the top digits separately,
    # so they agree to 1e-14, not bit for bit
    rad = HighPrecision("1e-40", prec=64)
    dev = TpuOrbitSession(spec=spec, center_x=cx, center_y=cy,
                          max_radius=rad, chunk_steps=32).run(
                              32, periodicity=False)
    host = compute_reference_orbit(cx, cy, 32, rad, periodicity=False,
                                   precision_bits=spec.frac_bits)
    err = max(float(np.abs(dev.orbit_x - host.orbit_x).max()),
              float(np.abs(dev.orbit_y - host.orbit_y).max()))
    log(f"[4] session orbit vs reforbit.compute_reference_orbit, 33 "
        f"entries: max |diff| {err:.3e}")
    check(len(dev.orbit_x) == len(host.orbit_x) == 33 and err <= 1e-14,
          "session orbit strays from the Python-int orbit")
    sess = TpuOrbitSession(spec=spec, center_x=cx, center_y=cy,
                           max_radius=rad, chunk_steps=256)
    for run in ("cold", "warm"):
        t0 = time.perf_counter()
        res = sess.run(steps, periodicity=False)
        dt = time.perf_counter() - t0
        check(res.count_orbit_entries() == steps + 1, "session length")
        log(f"[4] session {steps} it ({run}): {dt:.3f} s, "
            f"{dt / steps * 1e3:.4f} ms/iter")
    tr = device_time_ms(lambda: sess.run(steps, periodicity=False))
    log(f"[4] device time {tr['total_ms'] / steps:.4f} ms/iter in "
        f"{tr['events'] / steps:.1f} kernels/iter, idle share "
        f"{tr['idle_share']:.3f}")
    for name, ms in tr["top"][:8]:
        log(f"[4]   {ms / steps * 1e3:8.2f} us/iter  {name[:100]}")
    check(tr["total_ms"] > 0, "no device kernels in the orbit trace")
    jax.block_until_ready(st)


def phase_server():
    from fractalshark_tpu import server as srv
    sock = os.path.join(tempfile.mkdtemp(prefix="fs_smoke_"), "s.sock")
    rs = srv.RenderServer(sock)
    ready = threading.Event()
    t = threading.Thread(target=rs.serve_forever,
                         kwargs={"ready_cb": lambda _: ready.set()},
                         daemon=True)
    t.start()
    check(ready.wait(60), "server did not start")
    try:
        reqs = [["--view", "0", "--width", "1024", "--height", "1024"],
                ["--view", "6", "--width", "512", "--height", "512",
                 "--render-algorithm", "GpuHDRx32PerturbedLAv2"],
                ["--view", "6", "--width", "512", "--height", "512",
                 "--render-algorithm", "GpuHDRx32PerturbedLAv2"]]
        hits = []
        for k, argv in enumerate(reqs, 1):
            t0 = time.perf_counter()
            r = srv.request({"argv": argv + ["--stats"]}, sock)
            dt = time.perf_counter() - t0
            check(r.get("rc") == 0, f"request {k} rc {r.get('rc')}: "
                  f"{r.get('stderr', '')[-400:]}")
            st = json.loads(r["stdout"].strip().splitlines()[-1])
            hits.append(srv.request({"op": "stats"}, sock)
                        ["orbit_cache_hits"])
            log(f"[5] request {k} {' '.join(argv)}: client {dt:.3f} s, "
                f"server {r['wall_s']} s, iter_sum {st['iter_sum']}, "
                f"orbit cache hits {hits[-1]}")
        check(hits[2] == hits[1] + 1,
              f"third request missed the orbit cache (hits {hits})")
    finally:
        srv.request({"op": "shutdown"}, sock, timeout=60)
        t.join(60)


def phase_view30():
    """Device orbit at 16384 limbs → LA build → 512² LAv2 render."""
    import numpy as np
    from fractalshark_tpu.engine.fractal import Fractal
    from fractalshark_tpu.engine.renderers import get_orbit_calc
    f = Fractal(width=512, height=512, view=30,
                algorithm="GpuHDRx32PerturbedLAv2")
    get_orbit_calc(f).orbit_backend = "device"
    t0 = time.perf_counter()
    iters = np.asarray(f.calc_fractal()).astype(np.int64)
    total = time.perf_counter() - t0
    b = f.benchmark
    period = b.extra.get("period")
    log(f"[v30] orbit {b.ref_orbit_s:.1f} s (period {period}, "
        f"{b.extra.get('orbit_len')} entries), LA build "
        f"{b.la_generation_s:.1f} s, render "
        f"{total - b.ref_orbit_s - b.la_generation_s:.1f} s, total "
        f"{total:.1f} s, kernel {b.extra.get('kernel')}")
    check(period == VIEW30_PERIOD, f"period {period} != {VIEW30_PERIOD}")
    s = int(iters.sum())
    rel = abs(s - VIEW30_ITER_SUM) / VIEW30_ITER_SUM
    log(f"[v30] iter_sum {s} vs {VIEW30_ITER_SUM} (rel {rel:.3e}), "
        f"min {iters.min()}, max {iters.max()}")
    check(rel <= SUM_TOL, f"View #30 iter_sum off by {rel:.3e}")


def phase_four():
    import jax
    import jax.numpy as jnp
    import numpy as np
    from fractalshark_tpu.core.pointzoom import PointZoomBBConverter
    from fractalshark_tpu.core.views import get_view_preset
    from fractalshark_tpu.engine.reforbit import RefOrbitCalc
    from fractalshark_tpu.ops import perturb
    from fractalshark_tpu.ops.bignum import fixedpoint as FP
    from fractalshark_tpu.ops.bignum.orbit import orbit_chunk
    from fractalshark_tpu.parallel import render as pr
    from fractalshark_tpu.parallel.ntt_sharded import make_limb_mesh
    devs = jax.devices()[:4]
    check(len(devs) == 4 and all(d.platform == "gpu" for d in devs),
          f"need four GPUs, have {jax.devices()}")
    size, budget = 2048, 3000
    ptz = PointZoomBBConverter(
        pt_x="-0.743643887037158704752191506114774",
        pt_y="0.131825904205311970493132056385139",
        zoom_factor="1e8", prec=512).square_aspect_ratio(size, size)
    res = RefOrbitCalc().get_and_create_useful_results(ptz, budget)
    mesh = pr.make_mesh(devs)
    for run in ("cold", "warm"):
        t0 = time.perf_counter()
        iters = pr.sharded_perturb_render_hdr(res, ptz, size, size, budget,
                                              mesh)
        iters.block_until_ready()
        t4 = time.perf_counter() - t0
    dset = sorted(str(d) for d in iters.sharding.device_set)
    log(f"[4gpu] sharded render {size}^2 on {dset}: {t4:.3f} s (warm)")
    check(len(set(dset)) == 4, f"render on {dset}, not four GPUs")
    with jax.default_device(devs[0]):
        for run in ("cold", "warm"):
            t0 = time.perf_counter()
            one = perturb.perturb_render_hdr(res, ptz, size, size, budget)
            one.block_until_ready()
            t1 = time.perf_counter() - t0
    log(f"[4gpu] single-GPU render {size}^2: {t1:.3f} s (warm)")
    check(np.array_equal(np.asarray(iters), np.asarray(one)),
          "sharded render differs from the single-GPU render")
    log("[4gpu] sharded render bit-identical to single GPU")

    spec = FP.FixedSpec.for_limbs(16384)
    prec = spec.frac_bits - 20
    v30 = get_view_preset(30).ptz
    cx = v30.pt_x.with_precision(prec)
    cy = v30.pt_y.with_precision(prec)
    scx, dcx = FP.hp_to_digits(cx, spec)
    scy, dcy = FP.hp_to_digits(cy, spec)
    c = (jnp.int32(scx), jnp.asarray(dcx), jnp.int32(scy), jnp.asarray(dcy))
    dz0 = (jnp.float64(1.0), jnp.float64(0.0), jnp.int32(0))
    consts = (jnp.float64(1.0), jnp.int32(-40),
              jnp.float64(float(cx)), jnp.float64(float(cy)))
    lmesh = make_limb_mesh(devs)
    steps = 64
    outs = {}
    for name, m in (("mesh", lmesh), ("single", None)):
        for run in ("cold", "warm"):
            t0 = time.perf_counter()
            st, packed = orbit_chunk(*c, *dz0, *c, *consts, spec=spec,
                                     steps=steps, mesh=m)
            jax.block_until_ready(st)
            dt = time.perf_counter() - t0
        outs[name] = [np.asarray(a) for a in st] + [np.asarray(packed)]
        log(f"[4gpu] orbit_chunk {spec.digits // 2} limbs {steps} steps "
            f"({name}): "
            f"{dt / steps * 1e3:.4f} ms/iter (warm)")
    same = all(np.array_equal(a, b)
               for a, b in zip(outs["mesh"], outs["single"]))
    check(same, "limb-sharded orbit differs from single GPU")
    log(f"[4gpu] limb-sharded orbit bit-identical over {steps} steps "
        f"(mesh {sorted(str(d) for d in lmesh.devices.flat)})")


def card_line() -> str:
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, timeout=60, check=True)
    return r.stdout.strip()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--view30", action="store_true",
                    help="run View #30 end to end instead of phases 2-6")
    ap.add_argument("--four", action="store_true",
                    help="run only the four-GPU mesh path")
    args = ap.parse_args(argv)
    try:
        import fractalshark_tpu  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: the fractalshark_tpu package is missing: {e}",
              file=sys.stderr)
        return 2
    import jax
    t_start = time.perf_counter()
    try:
        devs = phase_report()
        log(f"[1] card: {card_line()}")
        cpu = jax.devices("cpu")[0]
        if args.four:
            phase_four()
        elif args.view30:
            phase_view30()
        else:
            phase_direct(cpu)
            phase_double_float(cpu)
            phase_deep(cpu, devs[0])
            phase_orbit()
            phase_server()
    except PhaseError as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1
    log(f"[done] {time.perf_counter() - t_start:.1f} s in all")
    devs = jax.devices()
    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind,
        "count": len(devs)}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
