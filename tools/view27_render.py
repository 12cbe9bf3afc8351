"""View #27 endurance render: the full two-phase LAv2 pipeline at the
reference's hardest-known-render class (period ~28e9 reference orbit,
5e13-iteration budget — Notes/FractalShark-06-RefOrbit.tex:740-747).

Consumes the artifacts of the two prior stages:
  tools/run_view27.py  -> /tmp/view27_orbit.* (compressed orbit store)
  tools/view27_la.py   -> /tmp/view27_la.npz  (deep LA table,
                          low_bound=1: terminal whole-orbit stage + AT)

Phase 1 runs the 64-bit LA machine (AT head skip covers the budget in
~budget/period macro steps; whole-orbit LA node per wrap) against a
VirtualResults — the ~453 GB uncompressed orbit never exists anywhere.
Phase 2 runs the gather RC tail from the anchors (ops/rc_tail.py).

Run from the repo root:
    python -c "exec(open('tools/view27_render.py').read())"
Env overrides (defaults in parens; point them under a persistent dir):
  V27_CK          orbit store prefix        (/tmp/view27_orbit)
  V27_OUT         progress json INPUT from run_view27.py
                  (/tmp/view27_progress.json)
  V27_LA_DIR      LA table directory INPUT: la_<key>.npy memmaps +
                  la_meta.npz from view27_la.py (/tmp/view27_la_dir)
  V27_RENDER_OUT  this tool's status-json OUTPUT (/tmp/view27_render.json)
  V27_ITERS_NPY   the rendered iteration grid (/tmp/view27_iters.npy)
  V27_SIZE        frame side in pixels      (64)
  V27_BUDGET      per-pixel iteration budget (the view preset's 5e13)
  V27_NODE_CAP    max device-table node count; stages below the cap are
                  dropped via LAReferenceArrays.stage_window (70e6 ~
                  6 GB of device memory, sized for a 16 GB device; the
                  full 426.6M-node table is ~37 GB, which with the
                  8.7 GB anchor table fits an 80 GB H100 — not
                  measured on the H100)
"""

import json
import os
import time

import numpy as np

CK = os.environ.get("V27_CK", "/tmp/view27_orbit")
LA_DIR = os.environ.get("V27_LA_DIR", "/tmp/view27_la_dir")
OUT = os.environ.get("V27_RENDER_OUT", "/tmp/view27_render.json")
PROG = os.environ.get("V27_OUT", "/tmp/view27_progress.json")
SIZE = int(os.environ.get("V27_SIZE", "64"))
NODE_CAP = int(float(os.environ.get("V27_NODE_CAP", "70e6")))

from fractalshark_tpu.core.precision import precision_from_view  # noqa: E402
from fractalshark_tpu.core.views import get_view_preset        # noqa: E402
from fractalshark_tpu.engine.native_la import LAReferenceArrays  # noqa: E402
from fractalshark_tpu.engine.perturbation_results import (     # noqa: E402
    CompressedOrbit, VirtualResults)
from fractalshark_tpu.engine.renderers import two_phase_render  # noqa: E402
from fractalshark_tpu.utils.growable import GrowableArray      # noqa: E402

state = {"phase": "load", "t0": time.time()}


def save():
    state["elapsed_s"] = round(time.time() - state["t0"], 1)
    with open(OUT, "w") as f:
        json.dump(state, f)


save()

with open(PROG) as f:
    prog = json.load(f)
assert prog.get("phase") == "done" and prog.get("period", 0) > 0, prog
period = int(prog["period"])

v = get_view_preset(27)
ptz = v.ptz.square_aspect_ratio(SIZE, SIZE)
BUDGET = int(os.environ.get("V27_BUDGET", str(v.num_iterations)))
prec = precision_from_view(ptz) + 32
cx = ptz.pt_x.with_precision(prec)
cy = ptz.pt_y.with_precision(prec)

gx = GrowableArray.open_existing(CK + ".ax")
gy = GrowableArray.open_existing(CK + ".ay")
gi = GrowableArray.open_existing(CK + ".ai")
n = min(len(gx), len(gy), len(gi))
comp = CompressedOrbit(
    anchors_x=np.asarray(gx.view()[:n], np.float64),
    anchors_y=np.asarray(gy.view()[:n], np.float64),
    anchor_index=np.asarray(gi.view()[:n], np.int64),
    total_count=period, cx_low=float(ptz.pt_x), cy_low=float(ptz.pt_y),
    error_exp=int(v.compression_error_exp_low or 20))

la = LAReferenceArrays.load_dir(LA_DIR)
n_nodes_full = len(la.las)
# stage-window the device table to the node cap: drop the lowest
# stage(s) until the node count fits (each drop only moves the
# one-time tail handoff earlier by at most one macro step of the
# dropped stage — noise against the 5e13 budget)
idx = list(la.stage_la_index) + [n_nodes_full]
min_stage = 0
while (n_nodes_full - idx[min_stage] > NODE_CAP
       and min_stage < la.stage_count - 1):
    min_stage += 1
la_dev = la.stage_window(min_stage)
state.update(phase="render", period=period, n_anchors=n,
             ratio=round(period / max(1, n), 1), budget=BUDGET,
             size=SIZE, n_nodes=n_nodes_full,
             min_stage=min_stage, n_nodes_windowed=len(la_dev.las),
             stages=int(la.stage_count),
             use_at=bool(la.use_at),
             at_step=int(la.at.step_length) if la.use_at else 0)
save()

virt = VirtualResults.from_compressed(comp, cx, cy)
t0 = time.perf_counter()
out = two_phase_render(virt, la_dev, ptz, SIZE, SIZE, BUDGET, comp=comp)
o = np.asarray(out)
dt = time.perf_counter() - t0
state.update(phase="done", render_s=round(dt, 1),
             iter_min=int(o.min()), iter_max=int(o.max()),
             iter_sum=int(o.astype(np.int64).sum()),
             capped_px=int((o.astype(np.int64) >= BUDGET).sum()),
             total_s=round(time.time() - state["t0"], 1))
save()
np.save(os.environ.get("V27_ITERS_NPY", "/tmp/view27_iters.npy"),
        o.astype(np.int64))
print(json.dumps(state))
