"""Persistent render service: a long-lived process serving CLI renders.

The reference is a long-lived GUI whose render pool keeps warm renderer
threads between frames (``FractalSharkLib/RenderThreadPool.h:144-165``);
a one-shot CLI process instead pays JAX start-up, device
initialization and executable compiles or cache loads before the first
pixel.  This module is the headless equivalent of the warm pool: one
process owns the jax runtime, the in-process executable cache, and a
shared reference-orbit cache, and renders arrive as CLI argv lines over
a unix-domain socket.

Protocol (one JSON object per line, newline-terminated, both ways):
    {"argv": ["--view", "0", ...]}     -> run cli.main(argv) in-process
    {"op": "ping"}                     -> {"ok": true, ...stats}
    {"op": "stats"}                    -> request count + orbit cache
    {"op": "shutdown"}                 -> reply then exit the serve loop
Reply: {"rc": int, "stdout": str, "stderr": str, "wall_s": float}

Requests are handled sequentially: renders serialize on the single
device anyway, and sequential handling keeps the orbit cache free of
locking subtleties (the RefOrbitCalc lock still guards its own list).
"""

from __future__ import annotations

import contextlib
import io
import json
import os
import socket
import tempfile
import time

DEFAULT_SOCKET = os.environ.get(
    "FRACTALSHARK_SOCK",
    os.path.join(tempfile.gettempdir(), "fractalshark_tpu.sock"))


class RenderServer:
    """Owns the socket and the warm state shared across requests."""

    def __init__(self, socket_path: str = DEFAULT_SOCKET):
        from fractalshark_tpu.engine.reforbit import RefOrbitCalc
        self.socket_path = socket_path
        self.orbit_calc = RefOrbitCalc()   # shared across all requests
        self.requests = 0
        self.started = time.time()

    # -- request handling ------------------------------------------------
    def handle(self, req: dict) -> dict:
        if req.get("op") == "ping":
            return {"ok": True, "pid": os.getpid(),
                    "uptime_s": round(time.time() - self.started, 1)}
        if req.get("op") == "stats":
            return {"ok": True, "requests": self.requests,
                    "orbit_cache_len": len(self.orbit_calc.cache),
                    "orbit_cache_hits": self.orbit_calc.hits,
                    "uptime_s": round(time.time() - self.started, 1)}
        if req.get("op") == "shutdown":
            return {"ok": True, "shutdown": True}
        argv = req.get("argv")
        if not isinstance(argv, list):
            return {"rc": 2, "stdout": "",
                    "stderr": "bad request: expected {'argv': [...]}"}
        from fractalshark_tpu import cli
        self.requests += 1
        out, err = io.StringIO(), io.StringIO()
        t0 = time.perf_counter()
        try:
            with contextlib.redirect_stdout(out), \
                    contextlib.redirect_stderr(err):
                rc = cli.main(argv, orbit_calc=self.orbit_calc)
        except SystemExit as e:        # argparse error paths
            rc = int(e.code or 0)
        except Exception as e:  # noqa: BLE001 — server must survive
            err.write(f"server: render raised {e!r}\n")
            rc = 1
        return {"rc": rc, "stdout": out.getvalue(),
                "stderr": err.getvalue(),
                "wall_s": round(time.perf_counter() - t0, 4)}

    # -- serve loop --------------------------------------------------------
    def serve_forever(self, ready_cb=None) -> int:
        try:
            os.unlink(self.socket_path)
        except FileNotFoundError:
            pass
        srv = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        try:
            srv.bind(self.socket_path)
            srv.listen(8)
            if ready_cb is not None:
                ready_cb(self)
            while True:
                conn, _ = srv.accept()
                with conn:
                    f = conn.makefile("rwb")
                    line = f.readline()
                    if not line:
                        continue
                    try:
                        req = json.loads(line)
                    except json.JSONDecodeError as e:
                        req, resp = {}, {"rc": 2, "stdout": "",
                                         "stderr": f"bad json: {e}"}
                    else:
                        resp = self.handle(req)
                    f.write(json.dumps(resp).encode() + b"\n")
                    f.flush()
                    if resp.get("shutdown"):
                        return 0
        finally:
            srv.close()
            try:
                os.unlink(self.socket_path)
            except FileNotFoundError:
                pass


def request(req: dict, socket_path: str = DEFAULT_SOCKET,
            timeout: float = 3600.0) -> dict:
    """Send one request to a running server and return its reply."""
    c = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
    c.settimeout(timeout)
    try:
        c.connect(socket_path)
        f = c.makefile("rwb")
        f.write(json.dumps(req).encode() + b"\n")
        f.flush()
        line = f.readline()
    finally:
        c.close()
    if not line:
        raise ConnectionError("server closed the connection")
    return json.loads(line)


def server_alive(socket_path: str = DEFAULT_SOCKET) -> bool:
    if not os.path.exists(socket_path):
        return False
    try:
        return bool(request({"op": "ping"}, socket_path,
                            timeout=5.0).get("ok"))
    except OSError:
        return False


def run_client(argv: list[str], socket_path: str = DEFAULT_SOCKET) -> int:
    """Forward a CLI argv to the server; mirror its stdout/stderr/rc."""
    import sys
    resp = request({"argv": argv}, socket_path)
    if resp.get("stdout"):
        sys.stdout.write(resp["stdout"])
    if resp.get("stderr"):
        sys.stderr.write(resp["stderr"])
    return int(resp.get("rc", 1))
