"""Device-time measurement via ``jax.profiler`` traces.

Wall-clock around a render includes host work, transfers and compiles;
the profiler's device events are the kernel-time signal (reference
analogue: GPU-side ``BenchmarkTimer``, ``BenchmarkTimer.h:45``).  This
helper runs a callable under ``jax.profiler.start_trace`` and reduces
the dumped ``.xplane.pb`` with ``jax.profiler.ProfileData``:

* kernel events are the events on a device plane's CUDA stream lines
  ("Stream #…"); module and op rollup lines ("XLA Modules", "XLA Ops")
  nest those kernels and are not counted;
* ``total_ms`` sums kernel durations, ``busy_ms`` is the union of their
  intervals, ``window_ms`` spans the first kernel start to the last
  kernel end, and ``idle_share = 1 - busy_ms / window_ms``.
"""

from __future__ import annotations

import glob
import os
import shutil
import tempfile
from collections import defaultdict

# lines of a device plane that nest kernel events (rollups), never
# counted as kernels
_ROLLUP_LINES = ("XLA Modules", "XLA Ops", "XLA TraceMe", "Steps",
                 "Launch Stats", "Source", "Framework")


def _kernel_lines(plane):
    """Lines of one device plane that carry kernel executions: CUDA
    stream lines when the plane has them, else every non-rollup line."""
    lines = list(plane.lines)
    streams = [ln for ln in lines if ln.name.startswith("Stream")]
    if streams:
        return streams
    return [ln for ln in lines if not ln.name.startswith(_ROLLUP_LINES)]


def busy_and_window(spans) -> tuple[float, float]:
    """(union length of the [start, end) intervals, first start to last
    end) — the device's busy time and the window it is measured in."""
    if not spans:
        return 0.0, 0.0
    spans = sorted(spans)
    busy = 0.0
    cur_s, cur_e = spans[0]
    for s, e in spans[1:]:
        if s > cur_e:
            busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    busy += cur_e - cur_s
    return busy, max(e for _, e in spans) - spans[0][0]


def reduce_trace(path: str) -> dict:
    """Kernel time, busy time and idle share from one ``.xplane.pb``."""
    from jax.profiler import ProfileData

    pd = ProfileData.from_file(path)
    agg: dict = defaultdict(float)
    spans = []
    for plane in pd.planes:
        if not plane.name.startswith("/device:"):
            continue
        for ln in _kernel_lines(plane):
            for ev in ln.events:
                agg[ev.name] += ev.duration_ns / 1e6
                spans.append((ev.start_ns, ev.start_ns + ev.duration_ns))
    busy, window = busy_and_window(spans)
    out = {"total_ms": sum(agg.values()), "busy_ms": busy / 1e6,
           "window_ms": window / 1e6,
           "idle_share": (1.0 - busy / window) if window else 0.0,
           "events": len(spans),
           "top": sorted(agg.items(), key=lambda kv: -kv[1])}
    if not spans:
        out["error"] = "no kernel events on a device plane"
    return out


def device_time_ms(fn, *, trace_dir: str | None = None,
                   keep: bool = False) -> dict:
    """Run ``fn()`` once under a profiler trace and reduce it
    (``reduce_trace``).  ``fn`` must block on its outputs (e.g.
    ``np.asarray(out)``) so the kernels land inside the trace."""
    import jax

    tdir = trace_dir or tempfile.mkdtemp(prefix="fs_trace_")
    try:
        jax.profiler.start_trace(tdir)
        try:
            fn()
        finally:
            jax.profiler.stop_trace()
        files = glob.glob(os.path.join(tdir, "**", "*.xplane.pb"),
                          recursive=True)
        if not files:
            return {"total_ms": 0.0, "busy_ms": 0.0, "window_ms": 0.0,
                    "idle_share": 0.0, "events": 0, "top": [],
                    "error": "no trace file"}
        return reduce_trace(max(files, key=os.path.getmtime))
    finally:
        if not keep and trace_dir is None:
            shutil.rmtree(tdir, ignore_errors=True)
