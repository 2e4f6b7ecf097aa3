"""The port's observability routes and traces through its own servers,
on the CPU at the tiny family's size.

- A torch master and a torch worker, servers in this process over real
  sockets, give ONE trace tree with no orphan root for a txt2img fan-out
  and for an upscale fan-out whose second worker dies before sending
  its tile (the master reassigns it); the worker's job span hangs under
  the master's ``dispatch`` span.
- A torch master with the JAX package's own ``cli worker`` (a
  subprocess, warmed with one request first: it compiles cold) gives
  one tree too, and the names the torch worker's part of the same
  prompt carries are among the JAX worker's.
- Every span name the port emits is one the JAX package emits for the
  same prompt: a name of its critical-path categories (``hedge`` and
  ``reassign`` among them) or a node's ``class_type``.
- The routes' bodies have the JAX package's keys; ``metrics/reset``
  clears the aggregates (and with ``include_traces`` the recorder) and
  answers 403 under ``DTPU_METRICS_RESET=0``.
- Tracing off (``DTPU_TRACE=0``'s switch) records nothing, and the
  images with tracing on and off are equal to the bit.
- ``profile/start|stop|status`` on the CPU activity.
- ``cli trace``, ``why`` and ``analyze`` against a live server and
  against its capture directory."""

import copy
import json
import os
import pathlib
import re
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

from comfyui_distributed_tpu.utils import trace_analysis as jan
from comfyui_distributed_tpu_torch import cli as tcli
from comfyui_distributed_tpu_torch.models import registry as treg
from comfyui_distributed_tpu_torch.runtime import cluster as tcl
from comfyui_distributed_tpu_torch.server.app import ServerState, make_server
from comfyui_distributed_tpu_torch.utils import constants as TC
from comfyui_distributed_tpu_torch.utils import net
from comfyui_distributed_tpu_torch.utils import trace as ttr
from comfyui_distributed_tpu_torch.utils import trace_analysis as tan
from comfyui_distributed_tpu_torch.utils import trace_export as tex
from comfyui_distributed_tpu_torch.utils.image import decode_png

ROOT = pathlib.Path(__file__).resolve().parents[1]
DEADLINE_S = 120
# the span names the JAX package emits besides its node spans
JAX_SPAN_NAMES = set(jan.CATEGORY_OF) | {"hedge"}


def _txt2img(seed=7, size=64, save=True):
    doc = json.loads((ROOT / "workflows" / "distributed-txt2img.json")
                     .read_text())
    doc["5"]["inputs"].update(width=size, height=size)
    doc["3"]["inputs"]["steps"] = 2
    doc["13"]["inputs"]["seed"] = seed
    if save:
        doc["9"]["class_type"] = "SaveImage"
    return doc


def _upscale(seed=7):
    """A 16 px input scaled to 64 px: 4 tiles of 32, the master [0, 1],
    w0 [2], w1 [3]."""
    return {
        "7": {"class_type": "CheckpointLoaderSimple",
              "inputs": {"ckpt_name": "tiny.safetensors"}},
        "5": {"class_type": "CLIPTextEncode",
              "inputs": {"text": "a map", "clip": ["7", 1]}},
        "6": {"class_type": "CLIPTextEncode",
              "inputs": {"text": "", "clip": ["7", 1]}},
        "10": {"class_type": "LoadImage",
               "inputs": {"image": "__observability_card__.png"}},
        "11": {"class_type": "ImageScale",
               "inputs": {"image": ["10", 0], "upscale_method": "bilinear",
                          "width": 64, "height": 64, "crop": "disabled"}},
        "2": {"class_type": "UltimateSDUpscaleDistributed",
              "inputs": {"upscaled_image": ["11", 0], "model": ["7", 0],
                         "positive": ["5", 0], "negative": ["6", 0],
                         "vae": ["7", 2], "seed": seed, "steps": 1,
                         "cfg": 2.0, "sampler_name": "euler",
                         "scheduler": "normal", "denoise": 0.4,
                         "tile_width": 32, "tile_height": 32,
                         "padding": 8, "mask_blur": 2,
                         "force_uniform_tiles": True}},
        "3": {"class_type": "SaveImage", "inputs": {"images": ["2", 0]}},
    }


def _serve(state):
    srv = make_server(state, "127.0.0.1", 0)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    return srv, f"http://127.0.0.1:{state.port}"


@pytest.fixture(autouse=True)
def env(monkeypatch, tmp_path):
    monkeypatch.setenv(treg.FAMILY_ENV, "tiny")
    monkeypatch.setenv(TC.LEASE_ENV, "2.0")
    monkeypatch.setenv(TC.SUSPECT_PROBES_ENV, "1")
    monkeypatch.setenv(TC.HEDGE_ENV, "0")
    monkeypatch.setenv(TC.TRACE_EXPORT_DIR_ENV, str(tmp_path / "capture"))
    monkeypatch.delenv(TC.ANALYSIS_BASELINE_ENV, raising=False)
    net.reset_wire_cache()
    was = ttr.tracing_enabled()
    ttr.set_tracing(True)
    yield
    ttr.set_tracing(was)
    treg.clear_pipeline_cache()


class Fleet:
    """A torch master and its ``workers``, torch servers in this process
    each with its own dirs, heartbeating; ``external``: more workers
    outside it, name -> port."""

    def __init__(self, root, workers=("w0",), external=None):
        self.root = root
        self.servers, self.states, self.urls, self.beats = {}, {}, {}, {}
        cfg = []
        for name in workers:
            st = self._state(name, True)
            cfg.append({"id": name, "name": name, "host": "127.0.0.1",
                        "port": st.port, "enabled": True})
        for name, port in (external or {}).items():
            cfg.append({"id": name, "name": name, "host": "127.0.0.1",
                        "port": port, "enabled": True})
        (root / "master").mkdir()
        (root / "master" / "cfg.json").write_text(json.dumps(
            {"workers": cfg, "master": {"host": "127.0.0.1"}}))
        self._state("master", False)
        for name in workers:
            hb = self.beats[name] = tcl.HeartbeatSender(
                self.urls["master"], name, port=self.states[name].port)
            assert hb.beat_once()
            hb.start()

    def _state(self, name, is_worker):
        d = self.root / name
        (d / "input").mkdir(parents=True, exist_ok=True)
        st = ServerState(config_path=str(d / "cfg.json"), is_worker=is_worker,
                         input_dir=str(d / "input"),
                         output_dir=str(d / "output"), device="cpu")
        self.servers[name], self.urls[name] = _serve(st)
        self.states[name] = st
        return st

    @property
    def url(self):
        return self.urls["master"]

    def run(self, doc, kill=None):
        resp = net.post_json(self.url + "/prompt",
                             {"prompt": doc, "client_id": "obs"})
        if kill is not None:
            self.kill(kill)
        return resp, wait_history(self.url, resp["prompt_id"])

    def kill(self, name):
        self.beats[name].stop()
        self.servers[name].shutdown()
        self.servers[name].server_close()

    def stop(self):
        for hb in self.beats.values():
            hb.stop()
        for name, srv in self.servers.items():
            srv.shutdown()
            srv.server_close()


def wait_history(url, pid):
    deadline = time.time() + DEADLINE_S
    while pid not in net.get_json(url + "/history"):
        assert time.time() < deadline, "no history"
        time.sleep(0.05)
    return net.get_json(url + "/history")[pid]


def get_trace(url, pid):
    """The committed trace (it lands just after the history entry)."""
    deadline = time.time() + 30
    while True:
        try:
            return net.get_json(f"{url}/distributed/trace/{pid}")
        except urllib.error.HTTPError as e:
            assert e.code == 404 and time.time() < deadline
            time.sleep(0.05)


def one_tree(rec):
    """Checks one trace id, one root (the master's job) and no orphan;
    returns spans by name and a descendant test."""
    spans = rec["spans"]
    by_id = {s["span_id"]: s for s in spans}
    assert {s["trace_id"] for s in spans} == {rec["trace_id"]}
    assert [r["span_id"] for r in rec["tree"]] == [rec["root_span_id"]]
    root = by_id[rec["root_span_id"]]
    assert root["name"] == "job" and root["attrs"]["role"] == "master"
    assert all(s["parent_id"] in by_id for s in spans if s is not root)
    by_name = {}
    for s in spans:
        by_name.setdefault(s["name"], []).append(s)

    def under(s, anc):
        while s is not None:
            if s.get("parent_id") == anc["span_id"]:
                return True
            s = by_id.get(s.get("parent_id"))
        return False
    return by_name, under


def assert_jax_names(rec, doc):
    types = {n["class_type"] for n in doc.values() if isinstance(n, dict)}
    extra = {s["name"] for s in rec["spans"]} - JAX_SPAN_NAMES - types
    assert not extra, extra


def test_txt2img_fanout_is_one_trace_tree(tmp_path):
    fleet = Fleet(tmp_path)
    try:
        doc = _txt2img()
        resp, entry = fleet.run(copy.deepcopy(doc))
        assert resp["workers"] == ["w0"] and entry["status"] == "success"
        rec = get_trace(fleet.url, resp["prompt_id"])
        by, under = one_tree(rec)
        root = by["job"][0] if by["job"][0]["attrs"]["role"] == "master" \
            else by["job"][1]
        for name in ("preflight", "dispatch", "queue_wait", "execute",
                     "finalize", "KSampler", "collect", "receive_image"):
            assert any(under(s, root) for s in by[name]), name
        (dispatch,) = by["dispatch"]
        assert dispatch["attrs"]["worker"] == "w0"
        (wjob,) = [s for s in by["job"] if s["attrs"]["role"] == "worker"]
        assert wjob["parent_id"] == dispatch["span_id"]
        for name in ("queue_wait", "execute", "KSampler", "encode",
                     "upload"):
            assert any(under(s, wjob) for s in by[name]), name
        assert_jax_names(rec, doc)
        m = net.get_json(fleet.url + "/distributed/metrics")
        assert m["tracing"]["dropped_spans"] == 0
        assert m["tracing"]["export"]["exported"] >= 1
        assert m["pipeline"]["stages"]["job_e2e"]["count"] >= 1
        # the capture file holds the trace as committed; the in-process
        # worker's last spans (its job and finalize end after its last
        # upload) join the recorder's record after the commit, as the
        # JAX package's do in one process
        cap = tex.load_trace(os.environ[TC.TRACE_EXPORT_DIR_ENV],
                             prompt_id=resp["prompt_id"])
        ids = {s["span_id"] for s in cap["spans"]}
        late = [s for s in rec["spans"] if s["span_id"] not in ids]
        assert ids <= {s["span_id"] for s in rec["spans"]}
        assert all(s is wjob or under(s, wjob) for s in late), late
    finally:
        fleet.stop()


def test_upscale_with_a_killed_worker_is_one_trace_tree(tmp_path):
    card = np.random.default_rng(0).uniform(size=(1, 16, 16, 3))
    from comfyui_distributed_tpu_torch.utils.image import encode_png
    fleet = Fleet(tmp_path, workers=("w0", "w1"))
    try:
        for name in ("master", "w0", "w1"):
            (tmp_path / name / "input" / "__observability_card__.png") \
                .write_bytes(encode_png(card.astype(np.float32)))
        fleet.states["w1"].fault_inject = {"drop_tiles_after": 0}
        doc = _upscale()
        resp, entry = fleet.run(copy.deepcopy(doc), kill="w1")
        assert sorted(resp["workers"]) == ["w0", "w1"]
        assert entry["status"] == "success"
        rec = get_trace(fleet.url, resp["prompt_id"])
        by, under = one_tree(rec)
        assert len(by["dispatch"]) == 2 and by["reassign"], sorted(by)
        assert len(by["receive_tile"]) >= 2
        for s in by["reassign"]:
            assert s["attrs"]["lost"] == "w1"
        (collect,) = by["collect"]
        assert all(under(s, collect) for s in by["reassign"])
        assert_jax_names(rec, doc)
        for name in ("d2h", "encode", "upload"):
            assert by[name], name
    finally:
        fleet.stop()


def _prom(text):
    """Every line is HELP, TYPE or a sample; histograms cumulative."""
    sample = re.compile(r'^[a-zA-Z_:][a-zA-Z0-9_:]*(\{.*\})? \S+'
                        r'( # \{[^}]*\} \S+ \S+)?$')
    out = {}
    for ln in text.splitlines():
        if ln.startswith(("# HELP ", "# TYPE ")):
            continue
        assert sample.match(ln), ln
        out[ln.rsplit(" # ", 1)[0].rsplit(" ", 1)[0]] = \
            float(ln.rsplit(" # ", 1)[0].rsplit(" ", 1)[1])
    return out


def _get(url):
    with urllib.request.urlopen(url, timeout=10) as r:
        return r.status, r.headers.get("Content-Type"), r.read().decode()


def _post(url, body):
    req = urllib.request.Request(url, data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=10) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def test_routes_bodies_and_the_reset(tmp_path, monkeypatch):
    fleet = Fleet(tmp_path)
    try:
        url = fleet.url
        # the aggregates are process-wide: the in-process worker's
        # prompts land in them beside the master's
        assert _post(url + "/distributed/metrics/reset", {})[0] == 200
        resp, _ = fleet.run(_txt2img())
        get_trace(url, resp["prompt_id"])
        m = net.get_json(url + "/distributed/metrics")
        w = net.get_json(fleet.urls["w0"] + "/distributed/metrics")
        for key in ("phases", "nodes", "tracing", "pipeline", "cluster",
                    "analysis", "durability", "resources", "transfers"):
            assert key in m, key
        assert "cluster_counters" not in m
        assert set(m["pipeline"]) >= {"stages", "counters", "gauges"}
        assert set(m["cluster"]) >= {"workers", "ledger", "policy",
                                     "hedge_armed"}
        assert "KSampler" in m["nodes"] and "skew" in m["analysis"]
        # the next heartbeat brings a clock sample again after the reset
        deadline = time.time() + 10
        while "w0" not in net.get_json(
                url + "/distributed/metrics")["analysis"]["skew"]:
            assert time.time() < deadline
            time.sleep(0.1)
        status, ctype, text = _get(url + "/distributed/metrics.prom")
        assert status == 200 and ctype.startswith("text/plain")
        prom = _prom(text)
        assert prom['dtpu_stage_seconds_count{stage="job_e2e"}'] \
            == m["prompts_executed"] + w["prompts_executed"] == 2
        assert prom["dtpu_prompts_executed_total"] == m["prompts_executed"]
        assert 'dtpu_clock_skew_seconds{worker_id="w0"}' in prom
        idx = net.get_json(url + "/distributed/traces")
        assert set(idx) == {"traces", "ring_max", "tracing_enabled"}
        assert resp["prompt_id"] in [t["prompt_id"] for t in idx["traces"]]
        with pytest.raises(urllib.error.HTTPError) as e:
            net.get_json(url + "/distributed/trace/nope")
        assert e.value.code == 404
        an = net.get_json(url + "/distributed/analysis")
        assert set(an) == set(jan.analyze_records([])) | {
            "hedging_latency_ema_s", "live", "skew"}
        assert an["n_traces"] >= 1
        res = net.get_json(url + "/distributed/resource")
        assert set(res) == {"resources", "monitor"}
        assert res["resources"]["source"] == "host_rss"
        fl = net.get_json(url + "/distributed/cluster/metrics")
        assert set(fl["participants"]) == {"master", "w0"}
        assert not fl["participants"]["w0"]["stale"]
        _, _, ctext = _get(url + "/distributed/cluster/metrics.prom")
        cprom = _prom(ctext)
        assert cprom["dtpu_res_participants"] == 2
        assert 'dtpu_res_host_rss_bytes{worker_id="w0"}' in cprom
        # the reset: aggregates, then the recorder on request
        status, body = _post(url + "/distributed/metrics/reset", {})
        assert status == 200 and body["cleared"]["stages"] >= 1
        assert body["cleared"]["skew_estimates"] == 1
        m2 = net.get_json(url + "/distributed/metrics")
        assert m2["pipeline"]["stages"] == {} and m2["phases"] == {}
        assert m2["nodes"] == {} and m2["transfers"] == {}
        assert m2["prompts_executed"] == 0
        assert net.get_json(url + "/distributed/traces")["traces"]
        status, body = _post(url + "/distributed/metrics/reset",
                             {"include_traces": True})
        assert body["cleared"]["traces"] is True
        assert net.get_json(url + "/distributed/traces")["traces"] == []
        monkeypatch.setenv(TC.METRICS_RESET_ENV, "0")
        status, body = _post(url + "/distributed/metrics/reset", {})
        assert status == 403 and "disabled" in body["error"]
    finally:
        fleet.stop()


def test_tracing_off_records_nothing_and_changes_no_image(tmp_path):
    st = ServerState(config_path=str(tmp_path / "cfg.json"), device="cpu",
                     input_dir=str(tmp_path), output_dir=str(tmp_path / "o"))
    srv, url = _serve(st)
    try:
        images = []
        for on in (True, False, True, False):
            ttr.set_tracing(on)
            pid = net.post_json(url + "/prompt", {
                "prompt": _txt2img(save=True)})["prompt_id"]
            assert wait_history(url, pid)["status"] == "success"
            out = sorted((tmp_path / "o").glob("*.png"))[-1]
            images.append(decode_png(out.read_bytes()))
            if on:
                get_trace(url, pid)
            else:
                with pytest.raises(urllib.error.HTTPError):
                    net.get_json(f"{url}/distributed/trace/{pid}")
        for im in images[1:]:
            assert np.array_equal(im, images[0])
        assert net.get_json(url + "/distributed/traces")[
            "tracing_enabled"] is False
    finally:
        srv.shutdown()
        srv.server_close()


def test_profile_routes_on_the_cpu(tmp_path):
    st = ServerState(config_path=str(tmp_path / "cfg.json"), device="cpu",
                     start_exec_thread=False)
    srv, url = _serve(st)
    try:
        assert net.get_json(url + "/distributed/profile/status") \
            == {"running": False, "dir": None}
        status, body = _post(url + "/distributed/profile/stop", {})
        assert status == 409
        status, body = _post(url + "/distributed/profile/start",
                             {"dir": str(tmp_path / "prof")})
        assert status == 200 and body["dir"] == str(tmp_path / "prof")
        assert _post(url + "/distributed/profile/start", {})[0] == 409
        assert net.get_json(url + "/distributed/profile/status")["running"]
        status, body = _post(url + "/distributed/profile/stop", {})
        assert status == 200
        with open(body["file"]) as f:
            assert json.load(f)["traceEvents"]
        assert not net.get_json(url + "/distributed/profile/status")[
            "running"]
    finally:
        srv.shutdown()
        srv.server_close()


def test_cli_trace_why_analyze_live_and_from_captures(tmp_path, capsys):
    fleet = Fleet(tmp_path)
    try:
        url = fleet.url
        pids = [fleet.run(_txt2img(seed=s))[0]["prompt_id"]
                for s in (1, 2)]
        rec = get_trace(url, pids[-1])
        capdir = os.environ[TC.TRACE_EXPORT_DIR_ENV]
        capsys.readouterr()
        # trace: the index and one tree, live and from the captures
        assert tcli.main(["trace", "--url", url]) == 0
        out = capsys.readouterr().out
        assert all(p in out for p in pids)
        cap = tex.load_trace(capdir, prompt_id=pids[-1])
        for src, want in ((["--url", url], rec),
                          (["--export-dir", capdir], cap)):
            assert tcli.main(["trace", pids[-1], *src]) == 0
            out = capsys.readouterr().out
            assert out.startswith(f"trace {rec['trace_id']}") \
                and "dispatch" in out and "KSampler" in out
            assert tcli.main(["trace", pids[-1], *src, "--perfetto"]) == 0
            doc = json.loads(capsys.readouterr().out)
            assert {e["args"]["span_id"] for e in doc["traceEvents"]
                    if e["ph"] in ("X", "i")} \
                == {s["span_id"] for s in want["spans"]}
            assert tcli.main(["why", pids[-1], *src, "--json"]) == 0
            bd = json.loads(capsys.readouterr().out)
            assert bd == json.loads(json.dumps(tan.critical_path(want)))
            assert abs(sum(bd["categories"].values()) + bd["unattributed_s"]
                       - bd["e2e_s"]) < 1e-5
            assert tcli.main(["why", pids[-1], *src]) == 0
            assert "critical path:" in capsys.readouterr().out
        assert tcli.main(["trace", "--export-dir", capdir]) == 0
        out = capsys.readouterr().out
        assert all(p in out for p in pids)
        assert tcli.main(["trace", "nope", "--export-dir", capdir]) == 1
        # analyze: live, from the captures, a baseline and a diff
        assert tcli.main(["analyze", "--url", url, "--json"]) == 0
        live = json.loads(capsys.readouterr().out)
        assert live["n_traces"] >= 2 and "skew" in live
        base = tmp_path / "base.json"
        assert tcli.main(["analyze", "--export-dir", capdir,
                          "--baseline-out", str(base)]) == 0
        assert "traces analysed" in capsys.readouterr().out
        assert json.loads(base.read_text())["kind"] \
            == "dtpu_analysis_baseline"
        assert tcli.main(["analyze", "--diff", capdir, capdir,
                          "--seed", "3"]) == 0
        assert "verdict: clean" in capsys.readouterr().out
    finally:
        fleet.stop()


# --- a torch master with the JAX package's worker --------------------------------

def _jax_worker(root):
    port = net.find_free_port()
    d = root / "j0"
    (d / "input").mkdir(parents=True)
    env = {**os.environ, "DTPU_DEFAULT_FAMILY": "tiny",
           "PYTHONPATH": str(ROOT), "JAX_PLATFORMS": "cpu",
           "XLA_FLAGS": "--xla_force_host_platform_device_count=1",
           "DTPU_COMPILE_CACHE_DIR": "off"}
    env.pop(TC.TRACE_EXPORT_DIR_ENV, None)
    log = open(d / "log.txt", "w")
    proc = subprocess.Popen(
        [sys.executable, "-m", "comfyui_distributed_tpu.cli", "worker",
         "--host", "127.0.0.1", "--port", str(port),
         "--config", str(d / "cfg.json")], cwd=str(d), env=env,
        stdout=log, stderr=subprocess.STDOUT)
    deadline = time.time() + 120
    while True:
        assert proc.poll() is None, (d / "log.txt").read_text()[-3000:]
        try:
            net.get_json(f"http://127.0.0.1:{port}/prompt", timeout=2)
            return proc, log, port
        except OSError:
            assert time.time() < deadline
            time.sleep(0.3)


def test_torch_master_with_a_jax_worker_is_one_trace_tree(tmp_path,
                                                          monkeypatch):
    # the JAX worker does not heartbeat here: a lease longer than its
    # cold first request keeps it alive between the preflights
    monkeypatch.setenv(TC.LEASE_ENV, "60")
    proc, log, port = _jax_worker(tmp_path)
    fleet = None
    try:
        fleet = Fleet(tmp_path, workers=(), external={"j0": port})
        # warm: the JAX worker compiles cold and may miss the first
        # request's collector window; the request under test waits until
        # the warm one has left its queue
        fleet.run(_txt2img(seed=1, size=32))
        deadline = time.time() + DEADLINE_S
        while net.get_json(f"http://127.0.0.1:{port}/prompt")[
                "exec_info"]["queue_remaining"]:
            assert time.time() < deadline
            time.sleep(0.2)
        doc = _txt2img(seed=2, size=32)
        resp, entry = fleet.run(copy.deepcopy(doc))
        assert resp["workers"] == ["j0"] and entry["status"] == "success"
        assert entry["images"] == 2, entry
        rec = get_trace(fleet.url, resp["prompt_id"])
        by, under = one_tree(rec)
        (dispatch,) = by["dispatch"]
        (wjob,) = [s for s in by["job"] if s["attrs"]["role"] == "worker"]
        assert wjob["parent_id"] == dispatch["span_id"]
        jax_worker = {s["name"] for s in rec["spans"] if under(s, dispatch)}
        assert {"execute", "KSampler", "upload"} <= jax_worker
        assert_jax_names(rec, doc)
    finally:
        if fleet is not None:
            fleet.stop()
        proc.terminate()
        try:
            proc.wait(timeout=10)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()
        log.close()
    # the torch worker's part of the same prompt: names among the JAX's
    fleet = Fleet(tmp_path / "torch")
    try:
        resp, _ = fleet.run(copy.deepcopy(doc))
        rec = get_trace(fleet.url, resp["prompt_id"])
        by, under = one_tree(rec)
        (dispatch,) = by["dispatch"]
        # what the worker had when it shipped its spans (in one process
        # the recorder also sees the spans it opens after its upload)
        shipped_at = max(s["end_s"] for s in by["upload"])
        torch_worker = {s["name"] for s in rec["spans"]
                        if under(s, dispatch) and s["start_s"] <= shipped_at}
        assert torch_worker <= jax_worker, torch_worker - jax_worker
    finally:
        fleet.stop()
