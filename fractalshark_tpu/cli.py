"""Headless command-line renderer.

Flag surface mirrors the reference CLI
(``FractalSharkCli/main.cpp:37-91``): choose an algorithm, a view source
(builtin preset / locations file / center+zoom), iteration and AA
overrides, and PNG and/or console output.

Usage examples:
    python -m fractalshark_tpu.cli --view 0 --render-algorithm Cpu64 \
        --width 512 --height 512 --output-png out.png
    python -m fractalshark_tpu.cli --center-x -0.75 --center-y 0.0 \
        --zoom 2e3 --iterations 4096 --console-output ascii
"""

from __future__ import annotations

import argparse
import json
import sys
import time


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="fractalshark-tpu",
        description="Deep-zoom Mandelbrot renderer on JAX")
    p.add_argument("--render-algorithm", default="AUTO",
                   help="algorithm name (reference-compatible, e.g. Cpu64, "
                        "Tpu1x32, TpuHDRx32PerturbedLAv2, AUTO)")
    p.add_argument("--view", type=int, default=None,
                   help="builtin view preset index (0..32)")
    p.add_argument("--locations-file", default=None,
                   help="saved-locations text file")
    p.add_argument("--location-index", type=int, default=0)
    p.add_argument("--center-x", default=None, help="center real coordinate")
    p.add_argument("--center-y", default=None, help="center imag coordinate")
    p.add_argument("--zoom", default=None, help="zoom factor (decimal string)")
    p.add_argument("--iterations", type=int, default=None)
    p.add_argument("--antialiasing", type=int, default=None, choices=[1, 2, 3, 4])
    p.add_argument("--width", type=int, default=1024)
    p.add_argument("--height", type=int, default=1024)
    p.add_argument("--output-png", default=None)
    p.add_argument("--png-bit-depth", type=int, default=8, choices=[8, 16])
    p.add_argument("--console-output", default="none",
                   choices=["none", "ascii", "ansi"])
    p.add_argument("--palette", default="Default",
                   help="Basic|Default|Patriotic|Summer|Random")
    p.add_argument("--palette-depth", type=int, default=8)
    p.add_argument("--compression-error-exp-low", type=int, default=None)
    p.add_argument("--la-preset", default=None,
                   choices=["max-accuracy", "max-perf", "min-memory"],
                   help="LA table tuning preset (LAParameters.h:11)")
    p.add_argument("--la-stage-window", type=int, default=None,
                   metavar="K",
                   help="drop the K finest LA stages from the device "
                        "table; straggler pixels finish in the "
                        "perturbation tail (deep-render perf lever)")
    p.add_argument("--perturbation-alg", default="Auto",
                   choices=["Auto", "ST", "MT", "Native", "GPU", "TPU"],
                   help="reference-orbit backend (reference flag parity: "
                        "Auto picks native C++ when available; GPU = "
                        "on-device NTT pipeline, TPU an alias of GPU; "
                        "ST/MT = Python host)")
    p.add_argument("--commit-cap-bytes", type=int, default=None,
                   help="soft memory budget for planned device buffers")
    p.add_argument("--stats", action="store_true",
                   help="print iteration min/max/sum and timings as JSON")
    p.add_argument("--save-location", default=None,
                   help="append the rendered view to a locations file")
    p.add_argument("--interactive", action="store_true",
                   help="ANSI console REPL driven by the command catalog "
                        "(hotkeys: h for help)")
    p.add_argument("--feature-find", action="store_true",
                   help="find+refine a periodic point (minibrot) at the "
                        "view center; prints a JSON summary")
    p.add_argument("--feature-scan", default=None, metavar="NXxNY",
                   help="grid-scan the view for periodic points "
                        "(e.g. 12x12); prints JSON summaries")
    p.add_argument("--feature-mode", default="direct",
                   choices=["direct", "pt", "la"],
                   help="Phase-A evaluator policy for --feature-scan "
                        "(FeatureFinderMode Direct/PT/LA)")
    p.add_argument("--feature-max-period", type=int, default=None)
    p.add_argument("--serve", action="store_true",
                   help="run as a persistent render service on a unix "
                        "socket: one process keeps the jax executable "
                        "cache + reference-orbit cache warm across "
                        "renders (reference analogue: the GUI's warm "
                        "renderer pool, RenderThreadPool.h:144-165)")
    p.add_argument("--client", action="store_true",
                   help="forward this render to a running --serve "
                        "process instead of rendering in-process")
    p.add_argument("--socket", default=None,
                   help="unix socket path for --serve/--client "
                        "(default $FRACTALSHARK_SOCK or "
                        "fractalshark_tpu.sock in the temp directory)")
    p.add_argument("--warm", default=None, metavar="V1,V2",
                   help="with --serve: render these view presets once "
                        "at startup so later requests hit warm "
                        "executables")
    p.add_argument("--shutdown-server", action="store_true",
                   help="ask the --serve process to exit")
    return p


def interactive_loop(f) -> int:
    """Console front-end over the portable command catalog — the
    headless sibling of the reference GUIs (both route through the same
    shared handlers)."""
    from fractalshark_tpu.core.commands import (PortableCommandHandlers,
                                                find_command_for_key)

    handlers = PortableCommandHandlers(f)
    print(f.render_to_console(ansi=True))
    print("command keys: h=help z/Z=zoom b=back a=autozoom f=feature "
          "i/I=iters s=save png u=menu x=exit")
    while True:
        try:
            line = input("> ").strip()
        except EOFError:
            return 0
        if not line:
            continue
        key = line[0]
        if key == "u":
            from fractalshark_tpu.core.menu import render_text
            print(render_text(handlers))
            continue
        cmd = find_command_for_key(key.lower(), shift=key.isupper())
        alive = handlers.dispatch(cmd)
        for m in handlers.messages:
            print(m)
        handlers.messages.clear()
        if not alive:
            return 0
        if cmd:
            print(f.render_to_console(ansi=True))
            print(f"zoom 2^{f.ptz.zoom_factor.exponent2()} "
                  f"iters {f.num_iterations} "
                  f"alg {f.resolve_algorithm().name}")


def _strip_transport_flags(argv: list[str]) -> list[str]:
    """Remove --client/--socket/--serve tokens so the forwarded argv is a
    plain render request."""
    out, skip = [], False
    for tok in argv:
        if skip:
            skip = False
            continue
        if tok in ("--client", "--serve", "--shutdown-server"):
            continue
        if tok == "--socket":
            skip = True
            continue
        if tok.startswith("--socket="):
            continue
        out.append(tok)
    return out


def main(argv=None, orbit_calc=None) -> int:
    import sys as _sys
    raw_argv = list(_sys.argv[1:] if argv is None else argv)
    args = build_parser().parse_args(raw_argv)

    if args.serve or args.client or args.shutdown_server:
        from fractalshark_tpu import server as srv
        sock = args.socket or srv.DEFAULT_SOCKET
        if args.shutdown_server:
            resp = srv.request({"op": "shutdown"}, sock, timeout=30.0)
            print(json.dumps(resp))
            return 0 if resp.get("ok") else 1
        if args.client:
            return srv.run_client(_strip_transport_flags(raw_argv), sock)
        s = srv.RenderServer(sock)

        def _ready(rs):
            import os
            print(json.dumps({"serving": rs.socket_path,
                              "pid": os.getpid()}), flush=True)
            for tok in (args.warm or "").split(","):
                if not tok.strip():
                    continue
                r = rs.handle({"argv": ["--view", tok.strip(),
                                        "--width", "256",
                                        "--height", "256", "--stats"]})
                print(json.dumps({"warmed": tok.strip(),
                                  "wall_s": r.get("wall_s")}), flush=True)
        return s.serve_forever(ready_cb=_ready)

    from fractalshark_tpu.engine.fractal import Fractal
    from fractalshark_tpu.core.algorithms import get_algorithm
    from fractalshark_tpu.core.highprecision import HighPrecision
    from fractalshark_tpu.core.pointzoom import PointZoomBBConverter

    try:
        get_algorithm(args.render_algorithm)
    except KeyError as e:
        print(f"error: {e.args[0]}", file=sys.stderr)
        return 2

    f = Fractal(width=args.width, height=args.height,
                algorithm=args.render_algorithm,
                compression_error_exp=(
                    args.compression_error_exp_low
                    if args.compression_error_exp_low is not None else 20))
    if args.la_preset is not None or args.la_stage_window is not None:
        from fractalshark_tpu.engine.la_reference import LAParameters
        base = {"max-accuracy": LAParameters.max_accuracy,
                "max-perf": LAParameters.max_perf,
                "min-memory": LAParameters.min_memory}[
                    args.la_preset or "max-accuracy"]()
        if args.la_stage_window is not None:
            base.device_stage_window = args.la_stage_window
        f.la_parameters = base
    if orbit_calc is not None:
        # server mode: all requests share one RefOrbitCalc so a repeat
        # view is an orbit-cache hit, not a recompute
        f._orbit_cache = orbit_calc

    if args.locations_file:
        from fractalshark_tpu.io.saved_location import load_locations
        locs = load_locations(args.locations_file)
        if not (0 <= args.location_index < len(locs)):
            print(f"error: location index {args.location_index} out of range "
                  f"({len(locs)} locations)", file=sys.stderr)
            return 2
        loc = locs[args.location_index]
        f.set_view(loc.to_view())
        f.num_iterations = loc.num_iterations
        f.antialiasing = loc.antialiasing
    elif args.center_x is not None:
        if args.center_y is None or args.zoom is None:
            print("error: --center-x requires --center-y and --zoom",
                  file=sys.stderr)
            return 2
        zoom = HighPrecision(args.zoom, prec=64)
        prec = max(64, abs(zoom.exponent2()) + 192)
        f.set_view(PointZoomBBConverter(
            pt_x=HighPrecision(args.center_x, prec=prec),
            pt_y=HighPrecision(args.center_y, prec=prec),
            zoom_factor=HighPrecision(args.zoom, prec=prec)))
    else:
        try:
            f.set_view_preset(args.view if args.view is not None else 0)
        except KeyError:
            from fractalshark_tpu.core.views import num_views
            print(f"error: no such view preset {args.view} "
                  f"(valid: 0..{num_views() - 1})", file=sys.stderr)
            return 2

    if args.iterations is not None:
        f.num_iterations = args.iterations
    if args.antialiasing is not None:
        f.antialiasing = args.antialiasing
    f.palette.use_palette_type(args.palette)
    f.palette.use_depth(args.palette_depth)

    if args.perturbation_alg != "Auto":
        from fractalshark_tpu.engine.renderers import get_orbit_calc
        backend = {"ST": "host", "MT": "host", "Native": "native",
                   "GPU": "device", "TPU": "device"}[args.perturbation_alg]
        get_orbit_calc(f).orbit_backend = backend
    if args.commit_cap_bytes:
        from fractalshark_tpu.utils.aux import MemoryBudget
        budget = MemoryBudget(args.commit_cap_bytes)
        budget.reserve(f.width * f.height * f.antialiasing ** 2 * 4)
        # orbit cache evicts against the same cap (OptimizeMemory)
        get_orbit_calc(f).memory_budget = budget

    if args.interactive:
        return interactive_loop(f)

    if args.feature_find or args.feature_scan:
        import json as _json

        def _summary(fs):
            return {"center_x": fs.center_x.to_string(40),
                    "center_y": fs.center_y.to_string(40),
                    "period": fs.period,
                    "size_exp2": int(fs.size_estimate.e),
                    "residual_exp2": fs.residual_exp2,
                    "nr_iterations": fs.nr_iterations}

        max_period = (args.feature_max_period or
                      min(f.num_iterations, 1_000_000))
        if args.feature_scan:
            from fractalshark_tpu.engine.feature_finder import \
                find_periodic_points_scan
            try:
                nx, ny = (int(v) for v in
                          args.feature_scan.lower().split("x"))
            except ValueError:
                print(f"error: --feature-scan expects NXxNY, got "
                      f"{args.feature_scan!r}", file=sys.stderr)
                return 2
            feats = find_periodic_points_scan(
                f.ptz, max_period, grid=(nx, ny),
                mode=args.feature_mode)
            print(_json.dumps({"found": len(feats),
                               "features": [_summary(x) for x in feats]}))
        else:
            fs = f.try_find_periodic_point(max_period=max_period)
            print(_json.dumps(_summary(fs) if fs else None))
        return 0

    t0 = time.perf_counter()
    if args.output_png:
        f.save_png(args.output_png, bit_depth=args.png_bit_depth)
        print(f"wrote {args.output_png}")
    if args.console_output != "none":
        print(f.render_to_console(ansi=(args.console_output == "ansi")))
    if not args.output_png and args.console_output == "none":
        f.calc_fractal()
    elapsed = time.perf_counter() - t0

    if args.stats:
        stats = f.stats()
        print(json.dumps({
            "algorithm": f.resolve_algorithm().name,
            "width": f.width, "height": f.height,
            "iterations_budget": f.num_iterations,
            "iter_min": stats["min"], "iter_max": stats["max"],
            "iter_sum": stats["sum"],
            "wall_s": round(elapsed, 4),
            "per_pixel_s": round(f.benchmark.per_pixel_s, 4),
            "backend": f.backend,
            "kernel": f.benchmark.extra.get("kernel"),
        }))

    if args.save_location:
        from fractalshark_tpu.io.saved_location import (SavedLocation,
                                                        serialize)
        loc = SavedLocation(
            width=f.width, height=f.height,
            min_x=f.ptz.min_x, min_y=f.ptz.min_y,
            max_x=f.ptz.max_x, max_y=f.ptz.max_y,
            num_iterations=f.num_iterations,
            antialiasing=f.antialiasing,
            description="fractalshark-tpu")
        with open(args.save_location, "a") as fh:
            fh.write(serialize(loc) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
