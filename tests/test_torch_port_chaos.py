"""The port's chaos harness (``comfyui_distributed_tpu_torch/utils/
chaos.py`` and its hooks in ``utils/net.py``, ``server/app.py`` and
``runtime/cluster.py``) against the JAX package's.

- The same spec and seed and the same sequence of ``client_edge``,
  ``server_edge``, ``corrupt`` and ``heartbeat_frozen`` calls, drawn
  with numpy from a seed, give equal results in both packages: equal
  drops, delays and statuses, equal corrupted bytes of unchanged
  length, and equal ``chaos_*`` counter deltas and snapshots.
- The JAX package's ``TestChaosInjectors`` cases and
  ``TestTransportBackoff::test_chaos_drop_is_retried``
  (``tests/test_overload.py``) run on the port.
- On the port's servers: a 503 on a scoped route and none on another;
  a corrupted upload answered with a 500 and delivered clean on its
  retry, the fan-out's images equal to the bit to runs without chaos;
  a frozen heartbeat ageing a live worker's lease to dead.
"""

import contextlib
import io
import json
import pathlib
import threading
import time
import urllib.request
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np
import pytest

from comfyui_distributed_tpu.utils import chaos as jchaos
from comfyui_distributed_tpu.utils import trace as jtrace
from comfyui_distributed_tpu_torch import cli as tcli
from comfyui_distributed_tpu_torch.models import registry as treg
from comfyui_distributed_tpu_torch.ops.base import OpContext
from comfyui_distributed_tpu_torch.runtime import cluster as tcl
from comfyui_distributed_tpu_torch.runtime import reuse
from comfyui_distributed_tpu_torch.server.app import ServerState, make_server
from comfyui_distributed_tpu_torch.utils import chaos as tchaos
from comfyui_distributed_tpu_torch.utils import constants as C
from comfyui_distributed_tpu_torch.utils import net
from comfyui_distributed_tpu_torch.utils import trace as ttrace
from comfyui_distributed_tpu_torch.utils.image import (decode_png,
                                                       encode_tensor,
                                                       to_uint8)
from comfyui_distributed_tpu_torch.workflow import WorkflowExecutor

ROOT = pathlib.Path(__file__).resolve().parents[1]
KINDS = ("drop", "delay", "5xx", "corrupt", "heartbeat_frozen")
EXACT = 1e-6
DRILL_S = 120
# a seed whose rolls fault the first upload by a 503, then by a
# corruption, and deliver it on the third attempt (5xx and corrupt at
# 50%, the draws of one random.Random)
FAULT_SEED = 55


@pytest.fixture(autouse=True)
def no_leaked_chaos(monkeypatch):
    monkeypatch.delenv(C.CHAOS_ENV, raising=False)
    monkeypatch.delenv(C.CHAOS_SEED_ENV, raising=False)
    tchaos.get_chaos()
    jchaos.get_chaos()
    tchaos.set_chaos(None)
    jchaos.set_chaos(None)
    yield
    tchaos.set_chaos(None)
    jchaos.set_chaos(None)


def _counts(counters):
    return {k: counters.get(f"chaos_{k}") for k in KINDS}


def _calls(mod, cm, script):
    out = []
    for kind, arg in script:
        if kind == "client":
            try:
                out.append(("delay", cm.client_edge(arg, what="upload")))
            except mod.ChaosDropError as e:
                out.append(("drop", str(e)))
        elif kind == "server":
            out.append(("server", cm.server_edge(arg)))
        elif kind == "corrupt":
            got = cm.corrupt(arg, what="upload")
            assert len(got) == len(arg)
            out.append(("corrupt", got))
        else:
            out.append(("frozen", cm.heartbeat_frozen(arg)))
    return out


SPECS = {
    "everything": {"drop_pct": 20, "delay_pct": 15, "delay_s": 0.05,
                   "http_5xx_pct": 30, "corrupt_pct": 40, "seed": 7,
                   "freeze_heartbeats": ["w1"]},
    "server_side": {"http_5xx_pct": 50, "corrupt_pct": 50,
                    "routes": ["/distributed/job_complete"],
                    "seed": FAULT_SEED},
    "client_side": {"drop_pct": 60, "delay_pct": 60, "seed": 11},
    "freeze_all": {"freeze_heartbeats": True, "corrupt_pct": 100,
                   "seed": 3},
    "idle": {},
}


@pytest.mark.parametrize("name", sorted(SPECS))
def test_rolls_and_bytes_equal_the_jax_harness(name):
    rng = np.random.default_rng(sum(map(ord, name)))
    paths = ["/prompt", "/history", "/distributed/job_complete",
             "/distributed/tile_complete", "/distributed/heartbeat",
             "/distributed/metrics"]
    script = []
    for _ in range(200):
        kind = str(rng.choice(["client", "server", "corrupt", "frozen"]))
        if kind == "client":
            script.append((kind, f"http://m:{int(rng.integers(1, 9))}/x"))
        elif kind == "server":
            script.append((kind, str(rng.choice(paths))))
        elif kind == "corrupt":
            n = int(rng.integers(0, 64))
            script.append((kind, rng.integers(0, 256, n,
                                              dtype=np.uint8).tobytes()))
        else:
            script.append((kind, str(rng.choice(["w0", "w1", "w2"]))))
    spec = SPECS[name]
    j0, t0 = _counts(jtrace.GLOBAL_COUNTERS), _counts(ttrace.GLOBAL_COUNTERS)
    jm, tm = jchaos.ChaosMonkey(spec), tchaos.ChaosMonkey(spec)
    assert tm.active == jm.active
    jout, tout = _calls(jchaos, jm, script), _calls(tchaos, tm, script)
    assert tout == jout
    jd = {k: jtrace.GLOBAL_COUNTERS.get(f"chaos_{k}") - v
          for k, v in j0.items()}
    td = {k: ttrace.GLOBAL_COUNTERS.get(f"chaos_{k}") - v
          for k, v in t0.items()}
    assert td == jd
    js, ts = jm.snapshot(), tm.snapshot()
    assert sorted(ts) == sorted(js)
    assert {k: v for k, v in ts.items() if k != "injected"} \
        == {k: v for k, v in js.items() if k != "injected"}
    if name != "idle":
        assert sum(td.values()) > 0


def test_the_seed_comes_from_the_environment_as_in_the_jax_harness(
        monkeypatch):
    monkeypatch.setenv(C.CHAOS_SEED_ENV, "99")
    spec = {"drop_pct": 50}
    jm, tm = jchaos.ChaosMonkey(spec), tchaos.ChaosMonkey(spec)
    assert _calls(tchaos, tm, [("client", "u")] * 40) \
        == _calls(jchaos, jm, [("client", "u")] * 40)


def test_the_drill_seed_faults_one_upload_by_5xx_then_corruption():
    """The schedule phase 21 of ``chip_smoke.py`` relies on: the first
    upload's first attempt 503, its second corrupted, its third
    delivered; each of the first six delivered within the retries (the
    seventh is not: a drill sends fewer)."""
    cm = tchaos.ChaosMonkey(SPECS["server_side"])
    uploads = []
    for _ in range(7):
        seq = []
        for _attempt in range(C.SEND_MAX_RETRIES):
            status, _ = cm.server_edge("/distributed/job_complete")
            if status is not None:
                seq.append(status)
                continue
            if cm.corrupt(b"x" * 64) != b"x" * 64:
                seq.append("corrupt")
                continue
            seq.append("ok")
            break
        uploads.append(seq)
    assert uploads[0] == [503, "corrupt", "ok"]
    assert all(u[-1] == "ok" for u in uploads[:6])
    assert uploads[6][-1] != "ok"


# --- the JAX package's TestChaosInjectors cases on the port -------------------

def test_deterministic_with_seed():
    a = tchaos.ChaosMonkey({"drop_pct": 30, "seed": 5})
    b = tchaos.ChaosMonkey({"drop_pct": 30, "seed": 5})

    def rolls(cm):
        out = []
        for _ in range(20):
            try:
                cm.client_edge("u")
                out.append(False)
            except tchaos.ChaosDropError:
                out.append(True)
        return out
    assert rolls(a) == rolls(b)
    assert any(rolls(tchaos.ChaosMonkey({"drop_pct": 30, "seed": 5})))


def test_drop_delay_and_5xx():
    cm = tchaos.ChaosMonkey({"drop_pct": 100})
    with pytest.raises(tchaos.ChaosDropError):
        cm.client_edge("http://x")
    cm = tchaos.ChaosMonkey({"delay_pct": 100, "delay_s": 0.7})
    assert cm.client_edge("http://x") == 0.7
    cm = tchaos.ChaosMonkey({"http_5xx_pct": 100, "routes": ["/prompt"]})
    assert cm.server_edge("/prompt")[0] == 503
    assert cm.server_edge("/history")[0] is None   # route-scoped


def test_corrupt_flips_bytes_not_length():
    cm = tchaos.ChaosMonkey({"corrupt_pct": 100})
    data = bytes(range(64))
    out = cm.corrupt(data)
    assert len(out) == len(data) and out != data
    cm = tchaos.ChaosMonkey({})
    assert cm.corrupt(data) == data


def test_freeze_heartbeats_blocks_beat_once():
    tchaos.set_chaos({"freeze_heartbeats": ["w-frozen"]})
    hb = tcl.HeartbeatSender("http://127.0.0.1:1", "w-frozen", interval=999)
    assert hb.beat_once() is False       # no socket touched
    other = tcl.HeartbeatSender("http://127.0.0.1:1", "w-live",
                                interval=999, port=1)
    # not frozen: it really tries the (dead) master and fails there
    assert other.beat_once(timeout=0.2) is False


def test_env_arming_and_programmatic_override(monkeypatch):
    monkeypatch.setenv(C.CHAOS_ENV, '{"drop_pct": 100}')
    assert tchaos.get_chaos().active
    monkeypatch.delenv(C.CHAOS_ENV)
    assert not tchaos.get_chaos().active
    tchaos.set_chaos({"delay_pct": 100})
    assert tchaos.get_chaos().active
    tchaos.set_chaos(None)
    assert not tchaos.get_chaos().active
    monkeypatch.setenv(C.CHAOS_ENV, "not json")
    assert not tchaos.get_chaos().active


def _serve(state):
    srv = make_server(state, "127.0.0.1", 0)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    return srv, f"http://127.0.0.1:{state.port}"


@pytest.fixture
def master(tmp_path):
    st = ServerState(config_path=str(tmp_path / "cfg.json"), device="cpu",
                     input_dir=str(tmp_path), output_dir=str(tmp_path),
                     start_exec_thread=False)
    srv, url = _serve(st)
    yield st, url
    srv.shutdown()
    srv.server_close()


def test_server_hook_injects_5xx_on_a_scoped_route(master):
    st, url = master
    tchaos.set_chaos({"http_5xx_pct": 100, "routes": ["/history"]})
    code, body, _ = net.request_json("GET", url + "/history", timeout=10)
    assert code == 503 and "chaos" in body["error"]
    # other routes pass
    code, _, _ = net.request_json("GET", url + "/distributed/queue_status",
                                  timeout=10)
    assert code == 200
    m = net.get_json(url + "/distributed/metrics")
    assert m["chaos"]["injected"].get("5xx", 0) >= 1
    assert m["chaos"]["active"] is True
    tchaos.set_chaos(None)
    assert net.request_json("GET", url + "/history", timeout=10)[0] == 200


def test_server_hook_delays_a_scoped_route(master):
    st, url = master
    tchaos.set_chaos({"delay_pct": 100, "delay_s": 0.3,
                      "routes": ["/history"]})
    t0 = time.perf_counter()
    assert net.request_json("GET", url + "/history", timeout=10)[0] == 200
    assert time.perf_counter() - t0 >= 0.3
    t0 = time.perf_counter()
    net.get_json(url + "/distributed/queue_status")
    assert time.perf_counter() - t0 < 0.3


def _form(mj, tensor, idem="w0:0:0"):
    form = net.FormData()
    form.add_field("multi_job_id", mj)
    form.add_field("worker_id", "w0")
    form.add_field("image_index", "0")
    form.add_field("idem_key", idem)
    form.add_field("is_last", "true")
    form.add_field("image", encode_tensor(tensor), filename="img_0.npy",
                   content_type=C.TENSOR_WIRE_CONTENT_TYPE)
    return form


def test_a_corrupted_upload_is_a_500_and_its_retry_lands_once(master):
    st, url = master
    mj = "chaos_job"
    st.jobs.prepare_job(mj)
    img = np.random.default_rng(0).random((1, 8, 8, 3), dtype=np.float32)
    tchaos.set_chaos({"corrupt_pct": 100, "routes": []})
    form = _form(mj, img)
    req = urllib.request.Request(url + "/distributed/job_complete",
                                 data=form.encode(), headers={
                                     "Content-Type": form.content_type})
    with pytest.raises(urllib.error.HTTPError) as e:
        urllib.request.urlopen(req, timeout=10)
    assert e.value.code == 500
    assert "upload decode failed" in json.loads(e.value.read())["error"]
    # the retry loop delivers it once the corruption misses
    tchaos.set_chaos({"corrupt_pct": 50, "seed": 1})
    net.post_form_with_retry(url + "/distributed/job_complete",
                             lambda: _form(mj, img), timeout=10)
    net.post_form_with_retry(url + "/distributed/job_complete",
                             lambda: _form(mj, img), timeout=10)
    m = net.get_json(url + "/distributed/metrics")
    assert m["chaos"]["injected"]["corrupt"] >= 1
    # the second delivery is acknowledged by its key, not queued again
    q = st.jobs.get_queue(mj)
    item = q.get_nowait()
    assert q.empty()
    np.testing.assert_array_equal(item["tensor"], img)


class _Ok(BaseHTTPRequestHandler):
    def do_POST(self):
        self.rfile.read(int(self.headers.get("Content-Length") or 0))
        self.server.hits += 1
        data = b'{"status": "ok"}'
        self.send_response(200)
        self.send_header("Content-Length", str(len(data)))
        self.end_headers()
        self.wfile.write(data)

    def log_message(self, *a):
        pass


def test_chaos_drop_is_retried(monkeypatch):
    monkeypatch.setattr(net, "backoff_delays",
                        lambda n, rng=None: [0.0] * max(n - 1, 0))
    srv = ThreadingHTTPServer(("127.0.0.1", 0), _Ok)
    srv.hits = 0
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    url = f"http://127.0.0.1:{srv.server_address[1]}/up"
    try:
        # every edge dropped: the send exhausts its retries
        tchaos.set_chaos({"drop_pct": 100})
        with pytest.raises(tchaos.ChaosDropError):
            net.post_form_with_retry(url, net.FormData, timeout=5,
                                     max_retries=3, what="test")
        assert srv.hits == 0           # nothing reached the wire
        tchaos.set_chaos(None)
        net.post_form_with_retry(url, net.FormData, timeout=5, what="test")
        assert srv.hits == 1
        # a dropped first attempt is retried and lands
        tchaos.set_chaos({"drop_pct": 50, "seed": 1})   # drop, then pass
        drops0 = ttrace.GLOBAL_COUNTERS.get("chaos_drop")
        net.post_form_with_retry(url, net.FormData, timeout=5, what="test")
        assert srv.hits == 2
        assert ttrace.GLOBAL_COUNTERS.get("chaos_drop") > drops0
    finally:
        srv.shutdown()
        srv.server_close()


def test_a_frozen_heartbeat_ages_a_live_workers_lease_to_dead(
        master, monkeypatch):
    st, url = master
    st.cluster.lease_s = 0.6
    hb = tcl.HeartbeatSender(url, "w0", interval=0.1, port=1)
    assert hb.beat_once()
    hb.start()
    try:
        time.sleep(0.3)
        assert st.cluster.state("w0") == tcl.HEALTHY
        tchaos.set_chaos({"freeze_heartbeats": ["w0"]})
        deadline = time.time() + 5
        while st.cluster.state("w0") != tcl.DEAD:
            assert time.time() < deadline, st.cluster.snapshot()
            time.sleep(0.05)
        assert hb._thread.is_alive()        # the sender lives on
        assert ttrace.GLOBAL_COUNTERS.get("chaos_heartbeat_frozen") > 0
        tchaos.set_chaos(None)
        deadline = time.time() + 5
        while st.cluster.state("w0") != tcl.HEALTHY:
            assert time.time() < deadline
            time.sleep(0.05)
    finally:
        hb.stop()


# --- a fan-out under chaos -------------------------------------------------------------

def _txt2img(seed):
    doc = json.loads((ROOT / "workflows" / "distributed-txt2img.json")
                     .read_text())
    doc["5"]["inputs"].update(width=64, height=64)
    doc["3"]["inputs"]["steps"] = 2
    doc["13"]["inputs"]["seed"] = seed
    doc["9"]["class_type"] = "SaveImage"
    return doc


def _png_diff(path, ref):
    got = decode_png(path.read_bytes())[0]
    want = to_uint8(ref).astype(np.float32) / 255.0
    assert got.shape == want.shape
    return float(np.abs(got - want).max())


def test_a_fanout_under_5xx_and_corruption_gives_the_clean_images(
        tmp_path, monkeypatch):
    """A master and a worker in this process, the worker's upload to
    ``/distributed/job_complete`` answered 503 and then 500 (a
    corrupted payload) before it lands: the prompt succeeds, the image
    counts once, and both images equal in-process runs without chaos
    to the bit."""
    monkeypatch.setenv(treg.FAMILY_ENV, "tiny")
    monkeypatch.setenv(C.CACHE_ENV, "0")
    monkeypatch.setattr(net, "backoff_delays",
                        lambda n, rng=None: [0.05] * max(n - 1, 0))
    net.reset_wire_cache()
    reuse.get_reuse().clear()
    seed = 777
    refs = [WorkflowExecutor(OpContext(device="cpu")).execute(
        _txt2img(seed + k)).image_batch[0] for k in range(2)]
    wst = ServerState(config_path=str(tmp_path / "w" / "cfg.json"),
                      is_worker=True, device="cpu",
                      input_dir=str(tmp_path / "w" / "in"),
                      output_dir=str(tmp_path / "w" / "out"))
    wsrv, wurl = _serve(wst)
    (tmp_path / "m").mkdir()
    (tmp_path / "m" / "cfg.json").write_text(json.dumps({"workers": [
        {"id": "w0", "name": "w0", "host": "127.0.0.1", "port": wst.port,
         "enabled": True}]}))
    mst = ServerState(config_path=str(tmp_path / "m" / "cfg.json"),
                      device="cpu", input_dir=str(tmp_path / "m" / "in"),
                      output_dir=str(tmp_path / "m" / "out"))
    msrv, murl = _serve(mst)
    tchaos.set_chaos(SPECS["server_side"])
    c0 = _counts(ttrace.GLOBAL_COUNTERS)
    try:
        resp = net.post_json(murl + "/prompt", {"prompt": _txt2img(seed)})
        assert resp["workers"] == ["w0"], resp
        deadline = time.time() + DRILL_S
        while resp["prompt_id"] not in net.get_json(murl + "/history"):
            assert time.time() < deadline, "no history"
            time.sleep(0.1)
        entry = net.get_json(murl + "/history")[resp["prompt_id"]]
        assert entry["status"] == "success" and entry["images"] == 2, entry
        m = net.get_json(murl + "/distributed/metrics")
        assert m["images_received"] == 1
        got = {k: ttrace.GLOBAL_COUNTERS.get(f"chaos_{k}") - v
               for k, v in c0.items()}
        assert got["5xx"] == 1 and got["corrupt"] == 1, got
        files = sorted((tmp_path / "m" / "out").glob("*.png"))
        assert len(files) == 2
        for f, ref in zip(files, refs):
            assert _png_diff(f, ref) <= EXACT, f
        # cli fleet names the armed spec
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            assert tcli.main(["fleet", "--url", murl]) == 0
        assert "CHAOS ARMED" in buf.getvalue()
    finally:
        tchaos.set_chaos(None)
        for srv in (msrv, wsrv):
            srv.shutdown()
            srv.server_close()
        treg.clear_pipeline_cache()
