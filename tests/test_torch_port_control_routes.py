"""The port's 16 control routes against the JAX server's, on the CPU.

The same config and the same request sequence go to a JAX server (its
aiohttp app through ``aiohttp.test_utils``, as ``tests/test_server.py``
drives it) and to a port server (real sockets): every answer's status
code and JSON key set must be equal (the worker and managed-process
entries' keys too).  The config routes must leave byte-equal config
files.  ``cluster/interrupt`` and ``cluster/clear_memory`` go from both
masters to two port workers.  Every route ``panel.html`` calls is in the
port's route table, and ``cli workers``, ``status`` and ``devices``
print the JAX commands' keys.

Managed workers are a sleeping process here (no worker server); the
manager's own tests launch a real one.  Every request has its own
timeout."""

import asyncio
import json
import os
import pathlib
import re
import sys
import threading
import urllib.error
import urllib.request

import pytest
from aiohttp.test_utils import TestClient, TestServer

from comfyui_distributed_tpu import cli as jcli
from comfyui_distributed_tpu.runtime import interrupt as jitr
from comfyui_distributed_tpu.server.app import ServerState as JaxState
from comfyui_distributed_tpu.server.app import build_app
from comfyui_distributed_tpu.utils import logging as jlogging
from comfyui_distributed_tpu_torch import cli as tcli
from comfyui_distributed_tpu_torch.runtime import interrupt as titr
from comfyui_distributed_tpu_torch.server import app as tapp
from comfyui_distributed_tpu_torch.utils import config as cfg_mod
from comfyui_distributed_tpu_torch.utils import log as tlog

ROOT = pathlib.Path(__file__).resolve().parents[1]
SLEEPER = [sys.executable, "-c", "import time; time.sleep(60)"]
REQUEST_S = 60           # one request's own bound


@pytest.fixture(autouse=True)
def clean(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)    # managed-worker logs: ./logs/workers
    monkeypatch.setenv("DTPU_DEFAULT_FAMILY", "tiny")
    yield
    titr.clear_interrupt()
    jitr.clear_interrupt()
    jlogging.set_debug(False)
    tlog.set_debug(False)


def body_shape(body):
    """What the comparison holds: a dict's keys, and one level down the
    keys of dict values that are entries (a worker's, a device's)."""
    if not isinstance(body, dict):
        return type(body).__name__
    return {k: sorted(v) if isinstance(v, dict) and k not in (
        "workers", "freed_bytes", "cleared", "axes", "jobs") else None
        for k, v in body.items()}


# --- the two servers behind one call signature ---------------------------------

def port_server(cfg_path, **kw):
    st = tapp.ServerState(config_path=str(cfg_path), device="cpu",
                          start_exec_thread=False, **kw)
    srv = tapp.make_server(st, "127.0.0.1", 0)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    return st, srv, f"http://127.0.0.1:{st.port}"


def port_call(url, method, path, payload=None):
    """(status, JSON body or (content type, bytes))."""
    data = None if payload is None else json.dumps(payload).encode()
    req = urllib.request.Request(url + path, data=data, method=method,
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=REQUEST_S) as r:
            status, raw, ctype = r.status, r.read(), r.headers["Content-Type"]
    except urllib.error.HTTPError as e:
        status, raw, ctype = e.code, e.read(), e.headers["Content-Type"]
    if ctype.startswith("application/json"):
        return status, json.loads(raw)
    return status, (ctype.split(";")[0], raw)


def run_jax(cfg_path, sequence, prepare=None):
    """Each (method, path, payload) of ``sequence`` on a JAX server;
    (status, body) for each."""
    async def go():
        state = JaxState(config_path=str(cfg_path),
                         input_dir=str(cfg_path.parent / "jin"),
                         output_dir=str(cfg_path.parent / "jout"),
                         start_exec_thread=False)
        if prepare is not None:
            prepare(state)
        client = TestClient(TestServer(build_app(state)))
        await client.start_server()
        out = []
        try:
            for method, path, payload in sequence:
                if callable(path):
                    path()          # a step between requests
                    continue
                kw = {} if payload is None else {"json": payload}
                r = await asyncio.wait_for(
                    client.request(method, path, **kw), REQUEST_S)
                ctype = r.headers.get("Content-Type", "")
                if ctype.startswith("application/json"):
                    out.append((r.status, await r.json()))
                else:
                    out.append((r.status, (ctype.split(";")[0],
                                           await r.read())))
        finally:
            await client.close()
            state.manager.cleanup_all()
        return out
    return asyncio.run(go())


def run_port(cfg_path, sequence, prepare=None):
    st, srv, url = port_server(cfg_path)
    if prepare is not None:
        prepare(st)
    try:
        out = []
        for method, path, payload in sequence:
            if callable(path):
                path()
                continue
            out.append(port_call(url, method, path, payload))
        return out
    finally:
        st.manager.cleanup_all()
        srv.shutdown()
        srv.server_close()


def sleeper_manager(state):
    state.manager.build_launch_command = lambda w: list(SLEEPER)


def set_env(key, value):
    def step():
        if value is None:
            os.environ.pop(key, None)
        else:
            os.environ[key] = value
    return ("", step, None)


# --- route by route -------------------------------------------------------------

SEQUENCE = [
    ("POST", "/distributed/launch_worker", {"id": "w1"}),        # 404
    ("POST", "/distributed/config/update_worker",
     {"id": "w1", "name": "one", "port": 1, "enabled": False}),
    ("POST", "/distributed/config/update_setting",
     {"key": "stop_workers_on_master_exit", "value": False}),
    ("POST", "/distributed/launch_worker", {"id": "w1"}),        # 200
    ("POST", "/distributed/launch_worker", {"id": "w1"}),        # 409
    ("GET", "/distributed/managed_workers", None),
    ("POST", "/distributed/worker/clear_launching", {"id": "w1"}),
    ("GET", "/distributed/managed_workers", None),
    ("GET", "/distributed/worker_log?id=w1", None),
    ("GET", "/distributed/worker_log?id=w1&bytes=16", None),
    ("GET", "/distributed/worker_log?id=nope", None),              # 404
    ("POST", "/distributed/stop_worker", {"id": "w1"}),
    ("POST", "/distributed/stop_worker", {"id": "w1"}),          # 404
    ("POST", "/interrupt", {}),
    ("POST", "/distributed/cluster/interrupt", {}),
    ("POST", "/distributed/clear_memory", {}),
    ("POST", "/distributed/cluster/clear_memory", {}),
    ("POST", "/distributed/config/update_setting", {"value": 1}),  # 400
    ("POST", "/distributed/config/update_master", {"host": "1.2.3.4"}),
    ("GET", "/distributed/network_info", None),
    ("GET", "/distributed/status", None),
    ("GET", "/distributed/workers_status", None),
    ("POST", "/distributed/metrics/reset", {}),
    set_env("DTPU_METRICS_RESET", "0"),
    ("POST", "/distributed/metrics/reset", {}),                  # 403
    set_env("DTPU_METRICS_RESET", None),
    ("GET", "/panel", None),
]


def test_every_route_answers_as_the_jax_server_does(tmp_path):
    jax_out = run_jax(tmp_path / "j" / "cfg.json", SEQUENCE,
                      prepare=sleeper_manager)
    port_out = run_port(tmp_path / "t" / "cfg.json", SEQUENCE,
                        prepare=sleeper_manager)
    requests = [r for r in SEQUENCE if not callable(r[1])]
    assert len(jax_out) == len(port_out) == len(requests)
    for (method, path, _), (js, jb), (ts, tb) in zip(requests, jax_out,
                                                     port_out):
        assert (method, path, ts) == (method, path, js), (jb, tb)
        if isinstance(jb, tuple):                   # the panel
            assert tb[0] == jb[0] == "text/html"
            continue
        assert body_shape(tb) == body_shape(jb), (method, path, jb, tb)
    statuses = [s for s, _ in port_out]
    assert statuses == [404, 200, 200, 200, 409, 200, 200, 200, 200, 200,
                        404, 200, 404, 200, 200, 200, 200, 400, 200, 200,
                        200, 200, 200, 403, 200]
    managed = [b for (_, p, _), (_, b) in zip(requests, port_out)
               if p == "/distributed/managed_workers"]
    assert managed[0]["w1"]["launching"] is True
    assert managed[1]["w1"]["launching"] is False
    logs = [b["log"] for (_, p, _), (_, b) in zip(requests, port_out)
            if p.startswith("/distributed/worker_log?id=w1")]
    assert "=== session" in logs[0] and logs[1] == logs[0][-16:]
    status = next(b for (_, p, _), (_, b) in zip(requests, port_out)
                  if p == "/distributed/status")
    jstatus = next(b for (_, p, _), (_, b) in zip(requests, jax_out)
                   if p == "/distributed/status")
    # the JAX tests' CPU backend shows several host devices
    assert {tuple(sorted(d)) for d in status["devices"]} \
        == {tuple(sorted(d)) for d in jstatus["devices"]}
    assert status["platform"] == jstatus["platform"] == "cpu"


def test_the_config_routes_leave_byte_equal_files(tmp_path):
    """An explicit null deletes a field, an absent key leaves it."""
    sequence = [
        ("POST", "/distributed/config/update_master",
         {"host": "1.2.3.4", "port": 8288, "extra_args": "--x 1"}),
        ("POST", "/distributed/config/update_master", {"host": None}),
        ("POST", "/distributed/config/update_master", {"port": 9000}),
        ("POST", "/distributed/config/update_setting",
         {"key": "debug", "value": True}),
        ("POST", "/distributed/config/update_setting",
         {"key": "custom", "value": [1, {"a": None}]}),
        ("POST", "/distributed/config/update_setting", {"key": "gone"}),
    ]
    jpath, tpath = tmp_path / "j" / "cfg.json", tmp_path / "t" / "cfg.json"
    jout = run_jax(jpath, sequence)
    tout = run_port(tpath, sequence)
    assert [s for s, _ in jout] == [s for s, _ in tout] == [200] * 6
    assert tpath.read_bytes() == jpath.read_bytes()
    cfg = json.loads(tpath.read_text())
    # the null deleted the host; the next load fills the default again
    assert cfg["master"] == {"host": None, "port": 9000,
                             "extra_args": "--x 1"}
    assert cfg["settings"]["gone"] is None and cfg["settings"]["debug"]
    # the setting turns on the debug tier in both packages
    assert tlog.debug_enabled() and jlogging.debug_enabled()


def test_cluster_interrupt_and_clear_memory_reach_two_port_workers(tmp_path):
    workers = [port_server(tmp_path / f"w{i}" / "cfg.json", is_worker=True)
               for i in range(2)]
    try:
        def prepare(path):
            cfg_mod.mutate_config(lambda c: [cfg_mod.upsert_worker(c, {
                "id": f"w{i}", "host": "127.0.0.1", "port": st.port,
                "enabled": True}) for i, (st, _, _) in enumerate(workers)],
                str(path))
            return path

        sequence = [("POST", "/distributed/cluster/interrupt", {}),
                    ("POST", "/distributed/cluster/clear_memory", {})]
        jout = run_jax(prepare(tmp_path / "j" / "cfg.json"), sequence)
        tout = run_port(prepare(tmp_path / "t" / "cfg.json"), sequence)
        for (js, jb), (ts, tb) in zip(jout, tout):
            assert js == ts == 200 and body_shape(tb) == body_shape(jb)
            assert tb["workers"] == jb["workers"] == {"w0": 200, "w1": 200}
        assert titr.is_interrupted()          # the master's own flag too
        freed = tout[1][1]["freed_bytes"]
        assert set(freed) == set(jout[1][1]["freed_bytes"]) \
            == {"master", "w0", "w1"}
        assert tout[1][1]["freed_bytes_total"] == sum(freed.values())
    finally:
        for st, srv, _ in workers:
            srv.shutdown()
            srv.server_close()


def test_a_worker_that_is_down_is_reported_not_raised(tmp_path):
    path = tmp_path / "cfg.json"
    cfg_mod.mutate_config(lambda c: cfg_mod.upsert_worker(c, {
        "id": "w9", "port": 9, "enabled": True}), str(path))
    (status, body), = run_port(path, [
        ("POST", "/distributed/cluster/interrupt", {})])
    assert status == 200 and isinstance(body["workers"]["w9"], str)


def test_metrics_reset_zeroes_the_counters_and_keeps_the_history(tmp_path):
    st, srv, url = port_server(tmp_path / "cfg.json")
    try:
        st.bump(prompts_executed=3, wire_decode_s=1.5)
        st._history["p"] = {"status": "success"}
        tapp.cluster_mod.COUNTERS.bump("cluster_hedges", 2)
        status, body = port_call(url, "POST", "/distributed/metrics/reset", {})
        assert status == 200 and body["cleared"]["cluster_counters"] >= 1
        m = port_call(url, "GET", "/distributed/metrics")[1]
        assert m["prompts_executed"] == 0 and m["wire_decode_s"] == 0.0
        assert m["cluster_counters"] == {}
        assert "p" in port_call(url, "GET", "/history")[1]
    finally:
        srv.shutdown()
        srv.server_close()


def test_every_route_the_panel_calls_is_served(tmp_path):
    page = (ROOT / "comfyui_distributed_tpu_torch" / "server"
            / "panel.html").read_text()
    called = set(re.findall(r"(/distributed/[a-z_/]+[a-z_]|/interrupt)\b",
                            page))
    # the worker cards build "/distributed/" + kind + "_worker"
    called |= {f"/distributed/{k}_worker" for k in ("launch", "stop")}
    called.discard("/distributed/")
    st = tapp.ServerState(config_path=str(tmp_path / "cfg.json"),
                          device="cpu", start_exec_thread=False)
    served = {path for _, path in tapp.routes(st)}
    assert len(called) >= 15 and called <= served, called - served
    assert ("GET", "/panel") in tapp.routes(st)


# --- the CLI --------------------------------------------------------------------

def test_cli_workers_status_and_devices_print_the_jax_keys(tmp_path, capsys):
    path = str(tmp_path / "cfg.json")
    cfg_mod.mutate_config(lambda c: (
        cfg_mod.upsert_worker(c, {"id": "w1", "port": 9, "enabled": True}),
        cfg_mod.upsert_worker(c, {"id": "w2", "port": 10})), path)
    assert jcli.main(["workers", "--config", path]) == 0
    jw = json.loads(capsys.readouterr().out)
    assert tcli.main(["workers", "--config", path]) == 0
    tw = json.loads(capsys.readouterr().out)
    assert set(tw) == set(jw) and tw["master"] == jw["master"]
    assert [sorted(w) for w in tw["workers"]] \
        == [sorted(w) for w in jw["workers"]]
    assert [(w["health"], w["enabled"]) for w in tw["workers"]] \
        == [("offline", True), ("disabled", False)]

    assert jcli.main(["devices"]) == 0
    jd = json.loads(capsys.readouterr().out)
    assert tcli.main(["devices"]) == 0
    td = json.loads(capsys.readouterr().out)
    assert set(jd) <= set(td)
    assert (td["count"], td["platform"]) == (0, "none")   # no card here

    (_, jstatus), = run_jax(tmp_path / "j" / "cfg.json",
                            [("GET", "/distributed/status", None)])
    st, srv, url = port_server(tmp_path / "t" / "cfg.json")
    try:
        assert tcli.main(["status", "--url", url]) == 0
        assert set(json.loads(capsys.readouterr().out)) == set(jstatus)
    finally:
        srv.shutdown()
        srv.server_close()
