"""Benchmark driver: prints ONE JSON line of measurements on the GPU.

Headline: plain escape-time throughput (Mpix/s) on View #0, 4096², 512
iterations, f32 (the reference's direct-kernel baseline is 1 Gpix/s,
BASELINE.md).  The ``extra`` dict carries the companion measurements:

* perturb_mpix_s       — HDR-f32 perturbation render, 1e8 deep view
* deep_la_*            — View #6 orbit → LA build → LAv2 render (256²)
* deep_poster_*        — the same at 2048²
* ntt_ms_per_iter      — device orbit iteration at 16384 limbs
* orbit_session_*      — the production orbit session at 16384 limbs
* ntt32768_*           — orbit iteration at 32768 limbs (View #32)
* ntt_sharded_*        — the limb-sharded orbit step on a 1-device mesh
* native_orbit_it_s    — C++/GMP host orbit rate

Sizes do not depend on the backend, and the run fails when JAX finds no
GPU.  Every line carries ``device``: platform, device_kind, device count,
and the card's name and power limit from nvidia-smi.  Each part is
fault-isolated (its error lands in ``extra``) and the line is re-printed
after every part, so the last line is always complete.
"""

import json
import subprocess
import sys
import time


def _device() -> dict:
    import jax
    devs = jax.devices()
    if devs[0].platform != "gpu":
        raise SystemExit(f"bench: no GPU (platform {devs[0].platform})")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    return {"platform": devs[0].platform, "kind": devs[0].device_kind,
            "count": len(devs), "card": smi.stdout.strip().splitlines()[0]}


def _best(fn, reps=3):
    """Best wall time of ``reps`` calls after one warm-up call."""
    fn()
    best = None
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        dt = time.perf_counter() - t0
        best = dt if best is None else min(best, dt)
    return best


def _headline(extra):
    import jax.numpy as jnp
    import numpy as np

    from fractalshark_tpu.core.views import get_view_preset
    from fractalshark_tpu.ops import escape

    size, max_iter = 4096, 512
    ptz = get_view_preset(0).ptz.square_aspect_ratio(size, size)
    p = escape.PlainParams.from_view(ptz, size, size)

    def run():
        out = escape.escape_jax(p, size, size, max_iter, dtype=jnp.float32)
        return int(np.asarray(out[-1, -1]))

    dt = _best(run)
    extra["headline_wall_s"] = dt
    mpix_s = size * size / dt / 1e6
    return {"metric": f"escape_f32_view0_{size}x{size}_{max_iter}it",
            "value": mpix_s, "unit": "Mpix/s",
            "vs_baseline": mpix_s / 1000.0}


def _deep_view(size):
    from fractalshark_tpu.core.pointzoom import PointZoomBBConverter
    return PointZoomBBConverter(
        pt_x="-0.743643887037158704752191506114774",
        pt_y="0.131825904205311970493132056385139",
        zoom_factor="1e8", prec=512).square_aspect_ratio(size, size)


def _perturb(extra):
    import numpy as np

    from fractalshark_tpu.engine.reforbit import RefOrbitCalc
    from fractalshark_tpu.ops import perturb

    size, budget = 512, 3000
    ptz = _deep_view(size)
    calc = RefOrbitCalc()
    t0 = time.perf_counter()
    res = calc.get_and_create_useful_results(ptz, budget)
    extra["ref_orbit_s"] = time.perf_counter() - t0
    extra["ref_orbit_backend"] = calc.last_details.get("backend")
    dt = _best(lambda: np.asarray(perturb.perturb_render_hdr(
        res, ptz, size, size, budget, sub_dtype=np.float32)))
    extra["perturb_mpix_s"] = size * size / dt / 1e6


def _deep_la(extra, size=256, prefix="deep"):
    """View #6 (zoom ~1e136, HDR required): orbit → LA build → LAv2
    render through the engine's route, end to end."""
    import numpy as np

    from fractalshark_tpu.engine.fractal import Fractal
    from fractalshark_tpu.engine.la_reference import get_or_build_la
    from fractalshark_tpu.engine.renderers import calc_perturbed
    from fractalshark_tpu.core.algorithms import get_algorithm

    f = Fractal(size, size, view=6, algorithm="GpuHDRx32PerturbedLAv2")
    alg = get_algorithm(f.algorithm_name)
    out = np.asarray(calc_perturbed(f, alg))
    extra[f"{prefix}_orbit_s"] = f.benchmark.ref_orbit_s
    extra[f"{prefix}_orbit_len"] = f.benchmark.extra.get("orbit_len")
    extra[f"{prefix}_la_build_s"] = f.benchmark.la_generation_s
    results = f._orbit_cache.cache[-1]
    get_or_build_la(f, results)
    dt = _best(lambda: np.asarray(calc_perturbed(f, alg)), reps=2)
    extra[f"{prefix}_la_render_s"] = dt
    extra[f"{prefix}_la_mpix_s"] = size * size / dt / 1e6
    extra[f"{prefix}_iter_sum"] = int(out.astype(np.int64).sum())
    extra[f"{prefix}_kernel"] = f.benchmark.extra.get("kernel")


def _deep_poster(extra):
    _deep_la(extra, size=2048, prefix="deep_poster")


def _orbit_args(limbs, view, guard):
    import jax.numpy as jnp

    from fractalshark_tpu.core.views import get_view_preset
    from fractalshark_tpu.ops.bignum import fixedpoint as FP

    spec = FP.FixedSpec.for_limbs(limbs)
    prec = spec.frac_bits - guard
    ptz = get_view_preset(view).ptz
    cx = ptz.pt_x.with_precision(prec)
    cy = ptz.pt_y.with_precision(prec)
    scx, dcx = FP.hp_to_digits(cx, spec)
    scy, dcy = FP.hp_to_digits(cy, spec)
    c = (jnp.int32(scx), jnp.asarray(dcx), jnp.int32(scy), jnp.asarray(dcy))
    dz0 = (jnp.float64(1.0), jnp.float64(0.0), jnp.int32(0))
    consts = (jnp.float64(1.0), jnp.int32(-40),
              jnp.float64(float(cx)), jnp.float64(float(cy)))
    return spec, c + dz0 + c + consts


def _orbit_rate(extra, prefix, limbs, view, guard, steps, mesh=None):
    """Wall and device ms per iteration of one orbit_chunk dispatch."""
    import numpy as np

    from fractalshark_tpu.ops.bignum.orbit import orbit_chunk
    from fractalshark_tpu.utils.profiling import device_time_ms

    spec, args = _orbit_args(limbs, view, guard)

    def run():
        _, packed = orbit_chunk(*args, spec=spec, steps=steps, mesh=mesh)
        np.asarray(packed)

    extra[f"{prefix}_ms_per_iter"] = _best(run) / steps * 1e3
    tr = device_time_ms(run)
    extra[f"{prefix}_device_ms_per_iter"] = tr["total_ms"] / steps
    extra[f"{prefix}_kernels_per_iter"] = tr["events"] / steps
    extra[f"{prefix}_idle_share"] = tr["idle_share"]


def _ntt(extra):
    # 16384 limbs = the View #30 operand (zoom 1.367e114514,
    # Notes/FractalShark-07-GpuArithmetic.tex:28), on its real center
    _orbit_rate(extra, "ntt", 16384, 30, 20, 256)


def _ntt32768(extra):
    # View #32 scale (zoom 1.6e244240, the reference's deepest render,
    # Notes/FractalShark-07-GpuArithmetic.tex:33-40)
    _orbit_rate(extra, "ntt32768", 32768, 32, 64, 32)


def _ntt_sharded(extra):
    """Mesh-wired orbit iteration (limb-sharded multiply + CRT/carry
    tail, parallel/orbit_sharded.py) on a 1-device mesh: the sharded
    program's overhead against the single-device path."""
    import jax

    from fractalshark_tpu.parallel.orbit_sharded import make_limb_mesh

    _orbit_rate(extra, "ntt_sharded", 16384, 30, 20, 64,
                mesh=make_limb_mesh(jax.devices()[:1]))


def _orbit_session(extra):
    """The production orbit session (pipelined chunk dispatch, packed
    readback) at 16384 limbs on the View #30 center."""
    from fractalshark_tpu.core.highprecision import HighPrecision
    from fractalshark_tpu.core.views import get_view_preset
    from fractalshark_tpu.ops.bignum import fixedpoint as FP
    from fractalshark_tpu.ops.bignum.orbit import TpuOrbitSession
    from fractalshark_tpu.utils.profiling import device_time_ms

    limbs, steps = 16384, 2048
    spec = FP.FixedSpec.for_limbs(limbs)
    prec = spec.frac_bits - 20
    v30 = get_view_preset(30).ptz
    sess = TpuOrbitSession(spec=spec,
                           center_x=v30.pt_x.with_precision(prec),
                           center_y=v30.pt_y.with_precision(prec),
                           max_radius=HighPrecision("1e-40", prec=64),
                           chunk_steps=steps)
    n_it = steps * 4
    dt = _best(lambda: sess.run(n_it, periodicity=False), reps=2)
    extra["orbit_session_ms_per_iter"] = dt / n_it * 1e3
    extra["orbit_session_chunk_steps"] = steps
    tr = device_time_ms(lambda: sess.run(steps, periodicity=False))
    extra["orbit_session_device_ms_per_iter"] = tr["total_ms"] / steps
    extra["orbit_session_idle_share"] = tr["idle_share"]


def _native(extra):
    from fractalshark_tpu.core.precision import precision_from_view
    from fractalshark_tpu.core.views import get_view_preset
    from fractalshark_tpu.engine import native_orbit as NO

    if not NO.available():
        extra["native_orbit"] = "unavailable"
        return
    ptz = get_view_preset(5).ptz.square_aspect_ratio(64, 64)
    prec = precision_from_view(ptz) + 32
    t0 = time.perf_counter()
    res = NO.compute_reference_orbit_native(
        ptz.pt_x.with_precision(prec), ptz.pt_y.with_precision(prec),
        200000, ptz.radius, precision_bits=prec)
    dt = time.perf_counter() - t0
    extra["native_orbit_prec_bits"] = prec
    extra["native_orbit_it_s"] = res.count_orbit_entries() / dt


PARTS = [("native", _native), ("perturb", _perturb), ("deep_la", _deep_la),
         ("ntt", _ntt), ("orbit_session", _orbit_session),
         ("ntt_sharded", _ntt_sharded), ("deep_poster", _deep_poster),
         ("ntt32768", _ntt32768)]


def main() -> int:
    device = _device()
    extra = {}
    headline = _headline(extra)

    def emit():
        print(json.dumps(dict(headline, device=device, extra=extra)),
              flush=True)

    emit()
    for name, fn in PARTS:
        try:
            fn(extra)
        except Exception as e:  # noqa: BLE001 — one part, not the line
            extra[f"{name}_error"] = repr(e)[:200]
        emit()
    return 0


if __name__ == "__main__":
    sys.exit(main())
