"""A port master that dies mid-job, on the CPU: the write-ahead log in
the server (``runtime/durable.py`` wired into ``server/app.py``).

- the server state's recovery: a restarted master resumes its queued
  prompts under their original ids, not the finished ones, and logs
  nothing twice; without ``DTPU_WAL_DIR`` there is no durable master;
  a second master is refused while the lease lives;
- the three routes: ``/distributed/durability``, ``/distributed/
  takeover`` (409 while another master's lease lives, a forced one
  fences the old master's log) and a worker's ``/distributed/rehome``
  (its heartbeat follows the new master);
- the JAX package's two acceptance tests (``tests/test_durable.py::
  TestFailoverAcceptance``), in this process with the port's servers
  on loopback sockets, the tiny family and a 2 s master lease: a
  master A and workers w0 and w1 run a tiled upscale (64 px, tile 32,
  4 tiles: A [0, 1], w0 [2], w1 [3]); w1 stalls, and once the other
  three tiles are in A and w1 are killed.  (1) A standby B takes over
  when A's lease expires, resumes the prompt under its id, re-homes
  w0, blends the three stored tiles and redispatches only tile 3 to
  w0.  Its image must equal A's no-failure run to the bit, as the JAX
  test asserts: tile 3 is refined alone there as here.  (2) A master
  restarted with A's owner id takes the lease at once and does the
  same.  Its image must equal the port's in-process run with the tiles
  in the same batches to the bit, and the JAX executor's within one
  8-bit step (its 2e-3 in floats moves an 8-bit value by at most one).

A killed master's process acts no more; here its state lives on in the
process, so the kill also stops its server, its health poller and its
log, and makes its registry's lease endless so its drain never acts on
a death (it fails at its next log append instead)."""

import copy
import json
import os
import threading
import time

import numpy as np
import pytest

from comfyui_distributed_tpu_torch.models import registry as treg
from comfyui_distributed_tpu_torch.ops import tiled_upscale as tup
from comfyui_distributed_tpu_torch.ops.base import OpContext
from comfyui_distributed_tpu_torch.runtime import cluster as cl
from comfyui_distributed_tpu_torch.runtime import durable as dur
from comfyui_distributed_tpu_torch.server.app import ServerState, make_server
from comfyui_distributed_tpu_torch.utils import constants as C
from comfyui_distributed_tpu_torch.utils import trace as ttrace
from comfyui_distributed_tpu_torch.utils import net
from comfyui_distributed_tpu_torch.utils.image import decode_png, to_uint8
from comfyui_distributed_tpu_torch.workflow import WorkflowExecutor

EXACT = 1e-6
ONE_STEP = 1.0 / 255 + 1e-6
DRILL_S = 120            # a drill's own limit


def _serve(state):
    srv = make_server(state, "127.0.0.1", 0)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    return srv, f"http://127.0.0.1:{state.port}"


def _state(tmp_path, **kw):
    return ServerState(config_path=str(tmp_path / "cfg.json"), device="cpu",
                       input_dir=str(tmp_path), output_dir=str(tmp_path),
                       start_exec_thread=False, **kw)


@pytest.fixture
def wal(tmp_path, monkeypatch):
    d = str(tmp_path / "wal")
    monkeypatch.setenv(C.WAL_DIR_ENV, d)
    return d


# --- the server state's recovery ---------------------------------------------------

def test_queue_recovered_with_original_pids(tmp_path, wal):
    st = _state(tmp_path)
    assert st.durable is not None and st.durable.epoch == 1
    p1 = st.enqueue_prompt({"1": {"class_type": "X"}}, {}, "c1")
    p2 = st.enqueue_prompt({"2": {"class_type": "Y"}}, {}, "c2")
    st.durable.simulate_crash()

    st2 = _state(tmp_path)
    assert st2.durable is not None and st2.durable.epoch == 2
    assert st2.resume_recovered() == 2
    with st2._cond:
        assert [it["id"] for it in st2._queue] == [p1, p2]
    # a second resume does nothing, and the resumed prompts were not
    # logged again
    assert st2.resume_recovered() == 0
    replayed, _ = dur.replay(wal)
    assert sorted(replayed.prompts) == sorted([p1, p2])
    assert replayed.counts["enqueue"] == 2
    assert replayed.prompts[p1]["client_id"] == "c1"
    st2.durable.close()


def test_completed_prompts_not_resumed(tmp_path, wal):
    st = _state(tmp_path)
    pid = st.enqueue_prompt({"1": {"class_type": "NoSuchOp"}}, {}, "c")
    with st._cond:
        item = st._queue.pop(0)
    st._execute(item)    # fails alone, and its end is logged
    assert st._history[pid]["status"] == "error"
    assert dur.replay(wal)[0].counts["exec_done"] == 1
    st.durable.simulate_crash()
    st2 = _state(tmp_path)
    assert st2.resume_recovered() == 0
    st2.durable.close()


def test_no_wal_dir_means_no_durable(tmp_path, monkeypatch):
    monkeypatch.delenv(C.WAL_DIR_ENV, raising=False)
    st = _state(tmp_path)
    assert st.durable is None
    st.enqueue_prompt({"1": {}}, {}, "c")     # and nothing breaks
    assert st.resume_recovered() == 0
    srv, url = _serve(st)
    try:
        assert net.get_json(url + "/distributed/durability") \
            == {"enabled": False}
        assert net.get_json(url + "/distributed/metrics")["durability"] \
            == {"enabled": False}
        with pytest.raises(RuntimeError, match="409"):
            net.post_json(url + "/distributed/takeover", {})
    finally:
        srv.shutdown()
        srv.server_close()


def test_a_second_master_is_refused_while_the_lease_lives(tmp_path, wal,
                                                          monkeypatch):
    st = _state(tmp_path)
    monkeypatch.setenv(C.WAL_OWNER_ENV, "another")
    with pytest.raises(RuntimeError, match="held by 'master'"):
        _state(tmp_path)
    st.durable.close()


def test_a_worker_has_no_durable_master(tmp_path, wal):
    assert _state(tmp_path, is_worker=True).durable is None


# --- the routes ------------------------------------------------------------------------

def test_durability_routes_of_an_active_master(tmp_path, wal):
    st = _state(tmp_path)
    srv, url = _serve(st)
    try:
        body = net.get_json(url + "/distributed/durability")
        assert body["enabled"] and body["role"] == "active"
        assert body["epoch"] == 1 and body["lease"]["held"]
        assert body["wal"]["records_appended"] == 0
        assert body["owner"] == "master"
        out = net.post_json(url + "/distributed/takeover", {})
        assert out["note"] == "already active"
        assert net.get_json(url + "/distributed/metrics")[
            "durability"]["epoch"] == 1
    finally:
        srv.shutdown()
        srv.server_close()
        st.durable.close()


def test_takeover_answers_409_while_the_lease_lives(tmp_path, wal,
                                                    monkeypatch):
    monkeypatch.setattr(C, "WAL_FENCE_CHECK_S", 0.0)
    a = _state(tmp_path)
    monkeypatch.setenv(C.STANDBY_ENV, "1")
    b = _state(tmp_path)
    srv, url = _serve(b)
    try:
        assert b.durable.stats()["role"] == "standby"
        with pytest.raises(RuntimeError, match="409"):
            net.post_json(url + "/distributed/takeover", {})
        # an operator's forced takeover fences the live master's log
        out = net.post_json(url + "/distributed/takeover", {"force": True})
        assert out["epoch"] == 2 and b.durable.takeovers == 1
        assert net.get_json(url + "/distributed/durability")["role"] \
            == "active"
        with pytest.raises(dur.FencedError):
            a.enqueue_prompt({"1": {}}, {}, "late")
    finally:
        srv.shutdown()
        srv.server_close()
        a.durable.simulate_crash()
        b.durable.close()


def test_rehome_retargets_heartbeat(tmp_path, monkeypatch):
    monkeypatch.delenv(C.MASTER_URL_ENV, raising=False)
    monkeypatch.delenv(C.WORKER_ID_ENV, raising=False)
    st = _state(tmp_path, is_worker=True)
    master = _state(tmp_path / "m")
    srv_m, url_m = _serve(master)
    st.heartbeat = cl.HeartbeatSender("http://127.0.0.1:1", "w0",
                                      interval=3600)
    srv, url = _serve(st)
    try:
        body = net.post_json(url + "/distributed/rehome",
                             {"master_url": url_m + "/", "worker_id": "w0"})
        assert body["master_url"] == url_m and body["registered"]
        assert st.heartbeat.master_url == url_m
        assert os.environ[C.MASTER_URL_ENV] == url_m
        # registered at the new master at once
        assert master.cluster.state("w0") == cl.HEALTHY
        with pytest.raises(RuntimeError, match="400"):
            net.post_json(url + "/distributed/rehome", {})
    finally:
        for s in (srv, srv_m):
            s.shutdown()
            s.server_close()
        os.environ.pop(C.MASTER_URL_ENV, None)
        os.environ.pop(C.WORKER_ID_ENV, None)


# --- the acceptance tests: a master killed mid tiled upscale ---------------------------

def _upscale_prompt(seed):
    """A missing file's 512 px test card scaled to 64 px: 4 tiles of 32,
    A [0, 1], w0 [2], w1 [3]; saved, so the blends compare."""
    return {
        "7": {"class_type": "CheckpointLoaderSimple",
              "inputs": {"ckpt_name": "tiny.safetensors"}},
        "5": {"class_type": "CLIPTextEncode",
              "inputs": {"text": "a map", "clip": ["7", 1]}},
        "6": {"class_type": "CLIPTextEncode",
              "inputs": {"text": "", "clip": ["7", 1]}},
        "10": {"class_type": "LoadImage",
               "inputs": {"image": "__durable_card__.png"}},
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
        "8": {"class_type": "SaveImage",
              "inputs": {"images": ["2", 0], "filename_prefix": "durable"}},
    }


class DurableCluster:
    """Masters and two workers (w0, w1) in this process, each a server
    over real sockets with its own directories; the masters share one
    config and one log directory, the workers heartbeat their master."""

    def __init__(self, root):
        self.root = root
        self.states, self.servers, self.urls = {}, {}, {}
        cfg_workers = []
        for name in ("w0", "w1"):
            st = self._state(name, is_worker=True)
            cfg_workers.append({"id": name, "host": "127.0.0.1",
                                "port": st.port, "enabled": True})
        self.cfg_path = str(root / "cfg.json")
        with open(self.cfg_path, "w") as f:
            json.dump({"workers": cfg_workers,
                       "master": {"host": "127.0.0.1"}, "settings": {}}, f)

    def _state(self, name, is_worker):
        d = self.root / name
        st = ServerState(config_path=str(d / "cfg.json") if is_worker
                         else self.cfg_path, is_worker=is_worker,
                         input_dir=str(d / "input"),
                         output_dir=str(d / "output"), device="cpu")
        self.servers[name], self.urls[name] = _serve(st)
        self.states[name] = st
        return st

    def master(self, name, monkeypatch, standby=False):
        """A master as ``serve`` starts one: bound first, then its health
        poller, then (unless a standby) the resume of what its log
        holds."""
        with monkeypatch.context() as m:
            if standby:
                m.setenv(C.STANDBY_ENV, "1")
            st = self._state(name, is_worker=False)
        st.health.interval = 0.5
        st.health.poll_once()
        st.health.start()
        return st, st.resume_recovered()

    def heartbeat_to(self, master):
        for name in ("w0", "w1"):
            hb = self.states[name].heartbeat = cl.HeartbeatSender(
                self.urls[master], name, port=self.states[name].port)
            assert hb.beat_once()
            hb.start()

    def kill(self, name):
        st = self.states[name]
        if st.durable is not None:
            st.durable.simulate_crash()
            st.cluster.lease_s = float("inf")
        st.health.stop()
        if st.heartbeat is not None:
            st.heartbeat.stop()
        self.servers[name].shutdown()
        self.servers[name].server_close()

    def output(self, name):
        d = self.root / name / "output"
        return sorted(d.glob("*.png")) if d.exists() else []

    def post_until_three_tiles_in(self, master, seed):
        """POST the upscale with w1 stalled; the prompt id once the
        master's log holds every tile but w1's, each with its payload
        stored.  The ledger (``/distributed/cluster``) marks a unit done
        before its payload and its check-in record are on disk, so a kill
        timed by the ledger alone can fall between the two and leave
        that tile to be refined again."""
        self.states["w1"].fault_inject = {"stall_s": DRILL_S}
        url = self.urls[master]
        resp = net.post_json(url + "/prompt", {
            "prompt": _upscale_prompt(seed), "client_id": "acc"})
        assert sorted(resp["workers"]) == ["w0", "w1"], resp
        deadline = time.monotonic() + DRILL_S
        while time.monotonic() < deadline:
            replayed, _ = dur.replay(os.environ[C.WAL_DIR_ENV])
            if any(j["kind"] == "tile" and sum(
                    1 for u in j["units"].values()
                    if u["done"] and u["spilled"]) >= 3
                   for j in replayed.jobs.values()):
                return resp["prompt_id"]
            time.sleep(0.05)
        raise AssertionError("the log never held 3 of 4 tiles")

    def wait_history(self, name, pid):
        deadline = time.monotonic() + DRILL_S
        while time.monotonic() < deadline:
            hist = net.get_json(self.urls[name] + "/history")
            if pid in hist:
                return hist[pid]
            time.sleep(0.1)
        raise AssertionError(f"prompt {pid} never finished on {name}")

    def tile_job(self, name):
        snap = net.get_json(self.urls[name] + "/distributed/cluster")
        return [j for j in snap["ledger"]["completed_jobs"]
                if j["kind"] == "tile"][-1], snap

    def stop(self):
        for name, st in self.states.items():
            if st.durable is not None:
                st.durable.simulate_crash()
            st.health.stop()
            if st.heartbeat is not None:
                st.heartbeat.stop()
        for srv in self.servers.values():
            srv.shutdown()
            srv.server_close()


@pytest.fixture
def acceptance_env(tmp_path, monkeypatch):
    monkeypatch.setenv(treg.FAMILY_ENV, "tiny")
    monkeypatch.setenv(C.WAL_DIR_ENV, str(tmp_path / "wal"))
    monkeypatch.setenv(C.MASTER_LEASE_ENV, "2.0")
    monkeypatch.setenv(C.LEASE_ENV, "4.0")
    monkeypatch.setenv(C.FAULT_POLICY_ENV, "reassign")
    monkeypatch.setenv(C.HEDGE_ENV, "0")
    # the drills rerun one upscale: the reuse plane's tile tier would
    # settle the master's tiles from the earlier run
    monkeypatch.setenv(C.CACHE_ENV, "0")
    net.reset_wire_cache()
    yield
    treg.clear_pipeline_cache()


def _pixels(path):
    return decode_png(path.read_bytes())[0]


def test_standby_election_finishes_job_bit_identical(tmp_path, monkeypatch,
                                                     acceptance_env):
    clu = DurableCluster(tmp_path)
    try:
        a, _ = clu.master("A", monkeypatch)
        assert a.durable is not None and a.durable.epoch == 1
        clu.heartbeat_to("A")
        # the run without a failure, at the same seed
        resp = net.post_json(clu.urls["A"] + "/prompt", {
            "prompt": _upscale_prompt(11), "client_id": "base"})
        assert clu.wait_history("A", resp["prompt_id"])["status"] \
            == "success"
        (base,) = clu.output("A")

        b, _ = clu.master("B", monkeypatch, standby=True)
        assert b.durable.standby and b.durable.wal is None
        pid = clu.post_until_three_tiles_in("A", 11)
        takeovers0 = ttrace.GLOBAL_COUNTERS.get("master_takeovers")
        clu.kill("A")
        clu.kill("w1")

        hist = clu.wait_history("B", pid)
        assert hist["status"] == "success", hist
        job, snap = clu.tile_job("B")
        assert job["done_units"] == job["total_units"] == 4
        assert job["pending_units"] == [] and job["recovered"] is True
        # only w1's tile was refined again
        assert job["preloaded_units"] == 3
        assert job["reassigned_units"] >= 1
        info = net.get_json(clu.urls["B"] + "/distributed/durability")
        assert info["epoch"] == 2 and info["takeovers"] == 1
        assert info["recovery"]["resumed"]
        assert ttrace.GLOBAL_COUNTERS.get("master_takeovers") == takeovers0 + 1
        (img,) = clu.output("B")
        np.testing.assert_array_equal(_pixels(img), _pixels(base))
        # w0 heartbeats its new master
        assert clu.states["w0"].heartbeat.master_url == clu.urls["B"]
        assert snap["workers"]["w0"]["state"] == cl.HEALTHY
        # the log verifies, with A's epoch and B's
        report = dur.verify(str(tmp_path / "wal"))
        assert report["ok"] and report["lease"]["epoch"] == 2
        assert {s["epoch"] for s in report["segments"]} == {1, 2}
    finally:
        clu.stop()


def test_restart_only_master_resumes_unfinished_units(tmp_path, monkeypatch,
                                                      acceptance_env):
    doc = _upscale_prompt(21)
    # the port in one process, its tiles in the failover's batches: A
    # [0, 1], w0 [2], then w0 [3] after the redispatch
    whole = tup.UltimateSDUpscaleDistributed._refine_tiles

    def in_failover_batches(self, ctx, pipe, image, all_tiles, indices, *a):
        out = {}
        for part in ([0, 1], [2], [3]):
            out.update(whole(self, ctx, pipe, image, all_tiles, part, *a))
        return out

    with monkeypatch.context() as m:
        m.setattr(tup.UltimateSDUpscaleDistributed, "_refine_tiles",
                  in_failover_batches)
        ref = WorkflowExecutor(OpContext(device="cpu")).execute(
            copy.deepcopy(doc)).image_batch[0]
    from comfyui_distributed_tpu.ops.base import OpContext as JaxOpContext
    from comfyui_distributed_tpu.runtime import reuse as jreuse
    from comfyui_distributed_tpu.workflow import WorkflowExecutor as JaxExec
    jreuse.get_reuse().clear()
    jax_res = JaxExec(JaxOpContext()).execute(copy.deepcopy(doc))
    jax_res.wait_host()
    jax_ref = np.asarray(jax_res.image_batch[0])

    clu = DurableCluster(tmp_path)
    try:
        a, _ = clu.master("A", monkeypatch)
        clu.heartbeat_to("A")
        pid = clu.post_until_three_tiles_in("A", 21)
        clu.kill("A")
        clu.kill("w1")
        dups0 = ttrace.GLOBAL_COUNTERS.get("cluster_duplicate_checkins")

        # a restart in place: A's owner id takes the live lease at once
        m2, resumed = clu.master("A2", monkeypatch)
        assert m2.durable.epoch == 2 and resumed == 1
        hist = clu.wait_history("A2", pid)
        assert hist["status"] == "success", hist
        job, _ = clu.tile_job("A2")
        assert job["done_units"] == job["total_units"] == 4
        assert job["recovered"] and job["preloaded_units"] == 3
        assert job["reassigned_units"] >= 1
        assert ttrace.GLOBAL_COUNTERS.get("cluster_duplicate_checkins") == dups0
        metrics = net.get_json(clu.urls["A2"] + "/distributed/metrics")
        assert metrics["tiles_received"] == 1       # tile 3 alone, from w0
        (img,) = clu.output("A2")
        got = _pixels(img)
        want = to_uint8(ref).astype(np.float32) / 255.0
        assert float(np.abs(got - want).max()) <= EXACT
        want_jax = to_uint8(jax_ref).astype(np.float32) / 255.0
        assert float(np.abs(got - want_jax).max()) <= ONE_STEP
    finally:
        clu.stop()
