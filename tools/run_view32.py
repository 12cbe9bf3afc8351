"""View #32 end-to-end attempt on a single device (the reference's
deepest demonstrated render: zoom 1.6e244240, 32768-limb NTT + add/sub
pipeline at full scale — Notes/FractalShark-07-GpuArithmetic.tex:33-40;
the reference reports no period or wall time, only "renders
successfully" on an RTX 5090).

Computes the View #32 reference orbit on device (32768 limbs,
periodicity ON) up to a probe cap; if the period (or escape) lands
inside the cap, builds the LA table and renders the frame through the
two-phase LAv2 pipeline.  If the cap is hit first, the measured it/s
and the projected wall for plausible periods are reported honestly.

Run from the repo root:
    python -c "exec(open('tools/run_view32.py').read())"
Env overrides (defaults in parens; artifacts live under the persistent
<repo>/.v32cache — /tmp does not survive machine re-provisioning):
  V32_DIR     artifact dir                  (<cwd>/.v32cache)
  V32_MAX_IT  orbit probe cap in iterations (4_000_000)
  V32_CHUNK   device scan chunk steps       (1024)
  V32_SIZE    render frame side in pixels   (256)
  V32_BUDGET  per-pixel budget              (preset's 5,806,285,824)
  V32_CK_EVERY  checkpoint cadence, seconds (600)

The orbit session checkpoints its exact device digit state under
V32_DIR/view32_orbit.* — re-running resumes bit-exactly, and raising
V32_MAX_IT on a cap_hit run continues from the cap instead of
recomputing (the probe runs for hours).
"""

import json
import os
import time

import numpy as np

DIR = os.environ.get("V32_DIR", os.path.join(os.getcwd(), ".v32cache"))
os.makedirs(DIR, exist_ok=True)
OUT = os.path.join(DIR, "view32_progress.json")
MAX_IT = int(os.environ.get("V32_MAX_IT", "4000000"))
CHUNK = int(os.environ.get("V32_CHUNK", "1024"))
SIZE = int(os.environ.get("V32_SIZE", "256"))

state = {"phase": "init", "t0": time.time(), "max_it": MAX_IT,
         "chunk": CHUNK}


def save():
    state["elapsed_s"] = round(time.time() - state["t0"], 1)
    with open(OUT, "w") as f:
        json.dump(state, f)


save()

from fractalshark_tpu.core.views import get_view_preset  # noqa: E402
from fractalshark_tpu.ops.bignum.orbit import (  # noqa: E402
    compute_reference_orbit_device)

v = get_view_preset(32)
ptz = v.ptz.square_aspect_ratio(SIZE, SIZE)
BUDGET = int(os.environ.get("V32_BUDGET", str(v.num_iterations)))
state.update(phase="orbit", zoom=str(ptz.zoom_factor)[:24],
             prec_bits=max(ptz.pt_x.prec, ptz.pt_y.prec), size=SIZE,
             budget=BUDGET)
save()

_base = [None]   # first done_it seen: it/s over THIS run's new work


def _progress(done_it, max_it, elapsed):
    if _base[0] is None:
        _base[0] = done_it
    state.update(orbit_done_it=done_it,
                 orbit_it_per_s=int((done_it - _base[0])
                                    / max(1e-9, elapsed)))
    save()


CK = os.path.join(DIR, "view32_orbit")
state["resumed"] = os.path.exists(CK + ".state.npz")
save()
t0 = time.perf_counter()
res = compute_reference_orbit_device(
    ptz.pt_x, ptz.pt_y, MAX_IT, ptz.radius, limbs32=32768,
    periodicity=True, chunk_steps=CHUNK, progress_cb=_progress,
    checkpoint_path=CK,
    checkpoint_every_s=float(os.environ.get("V32_CK_EVERY", "600")))
orbit_s = time.perf_counter() - t0
state.update(phase="orbit_done", orbit_s=round(orbit_s, 1),
             orbit_len=res.count_orbit_entries(), period=res.period,
             escaped_at=res.escaped_at,
             it_per_s=int(res.count_orbit_entries() / orbit_s),
             ms_per_iter=round(orbit_s / max(1, res.count_orbit_entries())
                               * 1e3, 4),
             session_timers=res.extra.get("session_timers"),
             use_hdr_orbit=bool(res.orbit_e is not None))
save()
np.save(os.path.join(DIR, "view32_orbit_x.npy"), res.orbit_x)
np.save(os.path.join(DIR, "view32_orbit_y.npy"), res.orbit_y)
if res.orbit_e is not None:
    np.save(os.path.join(DIR, "view32_orbit_e.npy"), res.orbit_e)
save()

if res.period == 0 and res.escaped_at == 0:
    # probe cap hit: report the projection, not a render
    state["phase"] = "cap_hit"
    state["projected_s_per_Mit"] = round(
        1e6 * orbit_s / max(1, res.count_orbit_entries()), 1)
    save()
    print(json.dumps(state))
    raise SystemExit(0)

from fractalshark_tpu.core.hdr_host import HD  # noqa: E402
from fractalshark_tpu.engine.la_reference import LAReferenceHost  # noqa: E402

state["phase"] = "la_build"
save()
t0 = time.perf_counter()
la = LAReferenceHost.generate_auto(res.orbit_x, res.orbit_y,
                                   HD.from_hp(res.max_radius),
                                   orbit_e=res.orbit_e)
state.update(la_build_s=round(time.perf_counter() - t0, 1),
             la_valid=bool(la.is_valid), la_stages=int(la.stage_count))
save()

if la.is_valid:
    from fractalshark_tpu.engine.renderers import two_phase_render  # noqa: E402
    state["phase"] = "render"
    save()
    t0 = time.perf_counter()
    out = two_phase_render(res, la, ptz, SIZE, SIZE, BUDGET)
    o = np.asarray(out)
    render_s = time.perf_counter() - t0
    state.update(phase="done", render_s=round(render_s, 1),
                 iter_min=int(o.min()), iter_max=int(o.max()),
                 iter_sum=int(o.astype(np.int64).sum()),
                 capped_px=int((o.astype(np.int64) >= BUDGET).sum()),
                 total_s=round(time.time() - state["t0"], 1))
    save()
    np.save(os.path.join(DIR, "view32_iters.npy"), o.astype(np.int64))
else:
    state["phase"] = "done_no_la"
    save()
print(json.dumps(state))
