"""Persistent render service tests (VERDICT r3 #4): the warm-pool
analogue of the reference GUI's long-lived renderer threads
(RenderThreadPool.h:144-165) — one process serves many CLI renders over
a unix socket, sharing the executable cache and the reference-orbit
cache across requests."""

import json
import threading
import time

import pytest

from fractalshark_tpu import server as srv
from fractalshark_tpu.cli import _strip_transport_flags, main


@pytest.fixture
def live_server(tmp_path):
    sock = str(tmp_path / "fsk.sock")
    s = srv.RenderServer(sock)
    ready = threading.Event()
    t = threading.Thread(
        target=s.serve_forever,
        kwargs={"ready_cb": lambda _s: ready.set()}, daemon=True)
    t.start()
    assert ready.wait(10.0)
    yield s, sock
    try:
        srv.request({"op": "shutdown"}, sock, timeout=10.0)
    except OSError:
        pass
    t.join(timeout=10.0)


def test_ping_stats_and_shutdown(tmp_path):
    sock = str(tmp_path / "fsk.sock")
    s = srv.RenderServer(sock)
    ready = threading.Event()
    t = threading.Thread(
        target=s.serve_forever,
        kwargs={"ready_cb": lambda _s: ready.set()}, daemon=True)
    t.start()
    assert ready.wait(10.0)
    assert srv.server_alive(sock)
    st = srv.request({"op": "stats"}, sock)
    assert st["ok"] and st["requests"] == 0
    resp = srv.request({"op": "shutdown"}, sock)
    assert resp.get("shutdown")
    t.join(timeout=10.0)
    assert not t.is_alive()
    assert not srv.server_alive(sock)


def test_render_through_server(live_server, tmp_path, capsys):
    s, sock = live_server
    png = tmp_path / "v0.png"
    rc = srv.run_client(["--view", "0", "--render-algorithm", "Cpu64",
                         "--width", "32", "--height", "32",
                         "--iterations", "64", "--stats",
                         "--output-png", str(png)], sock)
    assert rc == 0
    out = capsys.readouterr().out
    assert '"iter_sum"' in out and png.exists()
    # identical render in-process for a correctness cross-check
    main(["--view", "0", "--render-algorithm", "Cpu64",
          "--width", "32", "--height", "32", "--iterations", "64",
          "--stats"])
    direct = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    via = json.loads([ln for ln in out.splitlines()
                      if ln.startswith("{")][-1])
    assert via["iter_sum"] == direct["iter_sum"]


def test_orbit_cache_shared_across_requests(live_server):
    s, sock = live_server
    req = ["--center-x", "-0.743643887037158704752191506114774",
           "--center-y", "0.131825904205311970493132056385139",
           "--zoom", "1e8", "--width", "16", "--height", "16",
           "--iterations", "600", "--stats",
           "--render-algorithm", "Cpu64PerturbedBLA"]
    r1 = srv.request({"argv": req}, sock)
    assert r1["rc"] == 0, r1["stderr"]
    st = srv.request({"op": "stats"}, sock)
    n_orbits = st["orbit_cache_len"]
    assert n_orbits >= 1          # deep view computed a reference orbit
    r2 = srv.request({"argv": req}, sock)
    assert r2["rc"] == 0, r2["stderr"]
    st2 = srv.request({"op": "stats"}, sock)
    # the repeat render hit the shared cache instead of recomputing
    assert st2["orbit_cache_len"] == n_orbits
    assert st2["orbit_cache_hits"] == st["orbit_cache_hits"] + 1
    assert st2["requests"] == 2
    s1 = json.loads(r1["stdout"].strip().splitlines()[-1])
    s2 = json.loads(r2["stdout"].strip().splitlines()[-1])
    assert s1["iter_sum"] == s2["iter_sum"]


def test_server_survives_bad_requests(live_server):
    s, sock = live_server
    r = srv.request({"argv": "not-a-list"}, sock)
    assert r["rc"] == 2
    r = srv.request({"argv": ["--view", "99999"]}, sock)
    assert r["rc"] == 2
    assert srv.server_alive(sock)


def test_strip_transport_flags():
    argv = ["--client", "--socket", "/x/y.sock", "--view", "3",
            "--socket=/z.sock", "--serve", "--width", "8"]
    assert _strip_transport_flags(argv) == ["--view", "3", "--width", "8"]


def test_cli_client_and_shutdown_flags(live_server, capsys):
    _, sock = live_server
    rc = main(["--client", "--socket", sock, "--view", "0",
               "--render-algorithm", "Cpu64", "--width", "16",
               "--height", "16", "--iterations", "32", "--stats"])
    assert rc == 0
    assert '"iter_sum"' in capsys.readouterr().out
    rc = main(["--shutdown-server", "--socket", sock])
    assert rc == 0
    time.sleep(0.1)
    assert not srv.server_alive(sock)
