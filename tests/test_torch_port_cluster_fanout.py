"""The port's control plane wired into its fan-out, on the CPU.

- the routes (``/distributed/register``, ``/heartbeat``, ``/cluster``)
  and ``cli cluster``; the JAX package's ``HeartbeatSender`` renewing a
  lease on a torch master and the port's on a JAX master (pure HTTP);
- the registry-aware preflight, the redispatcher that follows the unit,
  the queue layer's idempotency;
- the ledger-driven drains of both collectors with fed queues and a
  stand-in refine (no model): a dead owner's units recovered, ``fail``
  raising, ``partial`` keeping today's partial result, a hedge's first
  completion winning, and no ledger keeping today's drain;
- the pipelined uploads against a master that answers slowly;
- two drills on the tiny family with a torch master and two torch
  workers, each a server in this process over real sockets, leases of
  2 s: ``w1`` killed mid tiled upscale (64 px, tile 32, 4 tiles, 1
  step; its server and heartbeat stop and it sends none of its tiles),
  and ``w1`` killed right after an image fan-out's dispatch (it never
  runs its share).

The drills' images are the master's SaveImage files, 8-bit PNGs, held
against 8-bit references.  The upscale must equal (1e-6) the port's own
no-fault run in one process with its tiles refined in the drill's
batches (tiles 0-1 on the master, 2 on w0, then 3 on w0 after the
redispatch): tile i takes seed + i wherever it runs.  Against the JAX
executor the port holds 2e-3 in floats, which moves an 8-bit value by
at most one step, so the bound there is one step (1/255).  The image
fan-out's three images must equal the port's in-process runs at seeds
s, s + 1 and s + 2 (1e-6): the redispatched slice keeps its seed."""

import asyncio
import copy
import json
import pathlib
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np
import pytest
import torch

from comfyui_distributed_tpu_torch import cli as tcli
from comfyui_distributed_tpu_torch.models import registry as treg
from comfyui_distributed_tpu_torch.ops import tiling
from comfyui_distributed_tpu_torch.ops import distributed as tdist
from comfyui_distributed_tpu_torch.ops import tiled_upscale as tup
from comfyui_distributed_tpu_torch.ops.base import OpContext
from comfyui_distributed_tpu_torch.runtime import cluster as cl
from comfyui_distributed_tpu_torch.runtime import reuse
from comfyui_distributed_tpu_torch.runtime.jobs import JobStore
from comfyui_distributed_tpu_torch.server.app import ServerState, make_server
from comfyui_distributed_tpu_torch.utils import constants as C
from comfyui_distributed_tpu_torch.utils import net
from comfyui_distributed_tpu_torch.utils import trace as ttrace
from comfyui_distributed_tpu_torch.utils.image import (decode_png,
                                                       decode_tensor,
                                                       save_png,
                                                       to_uint8)
from comfyui_distributed_tpu_torch.workflow import WorkflowExecutor
from comfyui_distributed_tpu_torch.workflow import dispatcher as dsp
from comfyui_distributed_tpu_torch.workflow import orchestrate as orch
from comfyui_distributed_tpu_torch.workflow.graph import parse_workflow

ROOT = pathlib.Path(__file__).resolve().parents[1]
EXACT = 1e-6
ONE_STEP = 1.0 / 255 + 1e-6
SEED = 123456789
DRILL_S = 120            # a drill's own limit


def _serve(state):
    srv = make_server(state, "127.0.0.1", 0)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    return srv, f"http://127.0.0.1:{state.port}"


@pytest.fixture
def torch_master(tmp_path):
    st = ServerState(config_path=str(tmp_path / "cfg.json"), device="cpu",
                     input_dir=str(tmp_path), output_dir=str(tmp_path),
                     start_exec_thread=False)
    srv, url = _serve(st)
    yield st, url
    srv.shutdown()
    srv.server_close()


# --- routes, heartbeats and cli cluster --------------------------------------

def test_register_heartbeat_and_cluster_routes(torch_master, capsys):
    st, url = torch_master
    body = net.post_json(url + "/distributed/register",
                         {"worker_id": "ext0", "port": 9999})
    assert body["status"] == "ok" and body["state"] == cl.HEALTHY
    assert body["worker_id"] == "ext0" and body["lease_s"] \
        == st.cluster.lease_s and "master_time" in body
    assert net.post_json(url + "/distributed/heartbeat",
                         {"id": "ext1"})["state"] == cl.HEALTHY
    snap = net.get_json(url + "/distributed/cluster")
    assert set(snap) == {"lease_s", "suspect_probes", "workers",
                         "transitions", "ledger", "policy", "hedge"}
    assert snap["workers"]["ext0"]["state"] == cl.HEALTHY
    # the host defaults to the sender's address
    assert snap["workers"]["ext0"]["host"] == "127.0.0.1"
    assert snap["workers"]["ext0"]["port"] == 9999
    assert snap["policy"] in C.FAULT_POLICIES
    assert set(snap["hedge"]) == {"armed", "min_progress_pct", "factor"}
    assert snap["ledger"] == {"active_jobs": {}, "completed_jobs": []}
    for route in ("/distributed/register", "/distributed/heartbeat"):
        with pytest.raises(RuntimeError, match="400"):
            net.post_json(url + route, {})
    assert "counters" in net.get_json(url + "/distributed/metrics")["pipeline"]
    assert tcli.main(["cluster", "--url", url]) == 0
    out = capsys.readouterr().out
    assert "ext0" in out and "healthy" in out and "policy=" in out
    assert tcli.main(["cluster", "--url", url, "--json"]) == 0
    assert json.loads(capsys.readouterr().out)["workers"]["ext1"]


def test_a_reenabled_worker_is_probed_not_skipped_as_dead(tmp_path,
                                                         monkeypatch):
    """A worker disabled until its lease ran out reads dead; enabling it
    again through the config route starts its record over, so the
    preflight probes it instead of skipping it (and deleting it drops
    the record)."""
    monkeypatch.setenv(C.LEASE_ENV, "0.2")
    st = ServerState(config_path=str(tmp_path / "cfg.json"), device="cpu",
                     input_dir=str(tmp_path), output_dir=str(tmp_path),
                     start_exec_thread=False)
    srv, url = _serve(st)
    try:
        port = st.port
        net.post_json(url + "/distributed/heartbeat",
                      {"worker_id": "w5", "port": port})
        time.sleep(0.3)
        assert st.cluster.state("w5") == cl.DEAD
        worker = {"id": "w5", "host": "127.0.0.1", "port": port,
                  "enabled": True}
        assert dsp.preflight_check([worker], registry=st.cluster) == []
        net.post_json(url + "/distributed/config/update_worker", worker)
        assert "w5" not in st.cluster.snapshot()["workers"]
        assert dsp.preflight_check([worker], registry=st.cluster) \
            == [worker]
        net.post_json(url + "/distributed/config/delete_worker",
                      {"id": "w5"})
        assert "w5" not in st.cluster.snapshot()["workers"]
    finally:
        srv.shutdown()
        srv.server_close()


def test_jax_heartbeat_sender_renews_a_lease_on_a_torch_master(
        torch_master, monkeypatch):
    from comfyui_distributed_tpu.runtime import cluster as jcl
    monkeypatch.setenv("DTPU_RESOURCE", "0")    # no device probe: pure HTTP
    st, url = torch_master
    hb = jcl.HeartbeatSender(url, "hb0", interval=999, port=8290)
    assert hb.beat_once() and hb.beats_sent == 1
    assert st.cluster.state("hb0") == cl.HEALTHY
    assert st.cluster.snapshot()["workers"]["hb0"]["port"] == 8290


def test_torch_heartbeat_sender_renews_a_lease_on_a_jax_master(tmp_path):
    from aiohttp.test_utils import TestClient, TestServer

    from comfyui_distributed_tpu.runtime import cluster as jcl
    from comfyui_distributed_tpu.server.app import ServerState as JaxState
    from comfyui_distributed_tpu.server.app import build_app

    async def go():
        state = JaxState(config_path=str(tmp_path / "c.json"),
                         start_exec_thread=False)
        client = TestClient(TestServer(build_app(state)))
        await client.start_server()
        try:
            url = f"http://127.0.0.1:{client.server.port}"
            hb = cl.HeartbeatSender(url, "t0", interval=999, port=8291)
            ok = await asyncio.get_running_loop().run_in_executor(
                None, hb.beat_once)
            assert ok and hb.beats_sent == 1
            assert state.cluster.state("t0") == jcl.HEALTHY
            assert state.cluster.snapshot()["workers"]["t0"]["port"] == 8291
            # a master that is down: a failed beat, not an exception
            dead = cl.HeartbeatSender("http://127.0.0.1:9", "t0")
            assert not await asyncio.get_running_loop().run_in_executor(
                None, dead.beat_once)
        finally:
            await client.close()

    asyncio.run(go())


def test_heartbeat_thread_starts_only_with_both_variables(monkeypatch,
                                                          torch_master):
    st, url = torch_master
    monkeypatch.delenv(C.MASTER_URL_ENV, raising=False)
    monkeypatch.setenv(C.WORKER_ID_ENV, "w9")
    assert cl.maybe_start_heartbeat(port=1) is None
    monkeypatch.setenv(C.MASTER_URL_ENV, url)
    monkeypatch.setenv(C.LEASE_ENV, "0.3")
    hb = cl.maybe_start_heartbeat(port=1234)
    try:
        assert abs(hb.interval - 0.1) < 1e-9
        deadline = time.time() + 10
        while st.cluster.state("w9") != cl.HEALTHY:
            assert time.time() < deadline
            time.sleep(0.05)
        assert st.cluster.snapshot()["workers"]["w9"]["port"] == 1234
    finally:
        hb.stop()


def test_health_poller_feeds_the_registry_as_the_jax_package(torch_master,
                                                              tmp_path):
    """One poll of a config with a live worker, a dead address and a
    disabled worker, through both packages' pollers: the same statuses
    and the same registry states."""
    from comfyui_distributed_tpu.runtime import cluster as jcl
    from comfyui_distributed_tpu.runtime.health import HealthPoller as JPoll

    from comfyui_distributed_tpu_torch.runtime.health import HealthPoller
    _, url = torch_master
    port = int(url.rsplit(":", 1)[1])
    cfg = tmp_path / "poll.json"
    cfg.write_text(json.dumps({"workers": [
        {"id": "up", "host": "127.0.0.1", "port": port, "enabled": True},
        {"id": "down", "host": "127.0.0.1", "port": 9, "enabled": True},
        {"id": "off", "host": "127.0.0.1", "port": port,
         "enabled": False}]}))
    out = {}
    for name, poller_cls, reg in (
            ("jax", JPoll, jcl.ClusterRegistry(lease_s=30, suspect_probes=1)),
            ("torch", HealthPoller,
             cl.ClusterRegistry(lease_s=30, suspect_probes=1))):
        snap = poller_cls(config_path=str(cfg), registry=reg).poll_once()
        out[name] = ({w: (st["status"], st["queue_remaining"],
                          st["enabled"]) for w, st in snap.items()},
                     {w: reg.state(w) for w in ("up", "down", "off")})
    assert out["torch"] == out["jax"]
    assert out["torch"][0]["up"] == ("online", 0, True)
    assert out["torch"][1] == {"up": cl.HEALTHY, "down": cl.UNKNOWN,
                               "off": cl.UNKNOWN}


# --- preflight, redispatcher identity, queue idempotency ---------------------

class _Probed(BaseHTTPRequestHandler):
    def do_GET(self):
        self.server.hits += 1
        data = b'{"exec_info": {"queue_remaining": 0}}'
        self.send_response(200)
        self.send_header("Content-Length", str(len(data)))
        self.end_headers()
        self.wfile.write(data)

    def log_message(self, *a):
        pass


def test_preflight_skips_a_dead_worker_without_a_probe():
    """A registry-DEAD worker is dropped though its socket answers: the
    died-between-jobs case a probe alone cannot catch."""
    servers = []
    for _ in range(2):
        s = ThreadingHTTPServer(("127.0.0.1", 0), _Probed)
        s.hits = 0
        threading.Thread(target=s.serve_forever, daemon=True).start()
        servers.append(s)
    try:
        workers = [{"id": wid, "host": "127.0.0.1",
                    "port": s.server_address[1], "enabled": True}
                   for wid, s in zip(("wdead", "wok"), servers)]
        reg = cl.ClusterRegistry(lease_s=0.05, suspect_probes=1)
        reg.observe_probe("wdead", True)
        time.sleep(0.1)
        assert reg.state("wdead") == cl.DEAD
        alive = dsp.preflight_check(workers, registry=reg)
        assert [w["id"] for w in alive] == ["wok"]
        assert [s.hits for s in servers] == [0, 1]
        # the probe fed the registry
        assert reg.state("wok") == cl.HEALTHY
        # without a registry both answer
        assert len(dsp.preflight_check(workers)) == 2
    finally:
        for s in servers:
            s.shutdown()
            s.server_close()


def test_image_redispatch_follows_the_unit_not_its_current_owner(
        monkeypatch):
    """wA's slice moved to wB, then wB died: the redispatch must render
    unit wA's slice (wA's positional identity) on the healthy wC."""
    graph = parse_workflow(
        {"1": {"class_type": "DistributedCollector", "inputs": {}}})
    enabled = ["wA", "wB", "wC"]
    alive = [{"id": w, "host": "127.0.0.1", "port": 1} for w in enabled]
    reg = cl.ClusterRegistry(lease_s=60.0, suspect_probes=1)
    reg.observe_probe("wA", False)
    reg.observe_probe("wC", True)
    led = cl.WorkLedger()
    led.create_job("jimg", {w: w for w in enabled}, kind="image")
    sent = []
    monkeypatch.setattr(dsp, "dispatch_to_worker",
                        lambda worker, wgraph, client_id=None,
                        extra_data=None: sent.append((worker["id"], wgraph)))
    orch._register_redispatchers(graph, {"1": "jimg"}, enabled, alive,
                                 "http://m", "c", None, reg, led)
    led.check_in("jimg", "wB", "wB")
    led.check_in("jimg", "wC", "wC")
    led.reassign("jimg", ["wA"], "wB")
    assert led.redispatch("jimg", ["wA"], "wB") is True
    target, wgraph = sent[-1]
    assert target == "wC"
    col = next(n for n in wgraph.nodes.values()
               if n.class_type == "DistributedCollector")
    assert col.hidden["worker_id"] == "worker_0"
    assert col.hidden["dispatch_attempt"] == 3
    assert led.owners_of_pending("jimg") == {"wA": "wC"}
    # nothing pending for a unit already done: no dispatch
    assert led.redispatch("jimg", ["wB"], "wB") is False
    assert len(sent) == 1


def test_tile_redispatch_sends_the_exact_units_and_skips_hedged(
        monkeypatch):
    doc = json.loads((ROOT / "workflows" / "distributed-upscale.json")
                     .read_text())
    graph = parse_workflow(doc)
    (nid,) = graph.find_by_type(*dsp.UPSCALER_TYPES)
    enabled = ["w0", "w1"]
    alive = [{"id": w, "host": "127.0.0.1", "port": 1} for w in enabled]
    reg = cl.ClusterRegistry(lease_s=60.0)
    reg.observe_probe("w0", True)
    led = cl.WorkLedger()
    led.create_job("jt", {0: "master", 1: "w0", 2: "w1", 3: "w1"})
    sent = []
    monkeypatch.setattr(dsp, "dispatch_to_worker",
                        lambda worker, wgraph, client_id=None,
                        extra_data=None: sent.append((worker["id"], wgraph)))
    orch._register_redispatchers(graph, {nid: "jt"}, enabled, alive,
                                 "http://m", "c", None, reg, led)
    led.mark_hedged("jt", [3])
    assert led.redispatch("jt", [2, 3], "w1") is True
    target, wgraph = sent[-1]
    node = wgraph.nodes[nid]
    assert target == "w0" and json.loads(node.hidden["tile_indices"]) \
        == [2, 3]
    assert node.hidden["dispatch_attempt"] == 3
    assert node.hidden["worker_id"] == "w0"
    # the hedged unit stays with its owner; the other moved
    assert led.owners_of_pending("jt") == {0: "master", 1: "w0", 2: "w0",
                                           3: "w1"}
    # no healthy target besides the lost owner: nothing sent
    assert led.redispatch("jt", [1], "w0") is False
    assert len(sent) == 1


def test_job_store_acknowledges_a_replay_without_queueing_it():
    js = JobStore()
    js.prepare_tile_job("j")
    item = {"tile_idx": 3, "worker_id": "w0"}
    assert js.put_tile("j", item, idem_key="w0:3:0")
    assert js.put_tile("j", item, idem_key="w0:3:0")    # the retried POST
    assert js.put_tile("j", item, idem_key="w0:3:1")    # a new attempt
    assert js.get_tile_queue("j").qsize() == 2
    js.remove_tile_queue("j")                           # keys go with it
    js.prepare_tile_job("j")
    assert js.put_tile("j", item, idem_key="w0:3:0")
    assert js.get_tile_queue("j").qsize() == 1
    js.prepare_job("i")
    for key in ("w:0:0", "w:0:0", None, None):          # keyless pass
        assert js.put_result("i", {"worker_id": "w"}, idem_key=key)
    assert js.get_queue("i").qsize() == 3


# --- ledger-driven drains with fed queues ------------------------------------

def _ctx(ledger=None, registry=None):
    return OpContext(device="cpu", job_store=JobStore(), ledger=ledger,
                     cluster=registry)


def _tile_item(idx, wid, is_last=False):
    return {"tile_idx": idx, "worker_id": wid, "is_last": is_last,
            "x": 0, "y": 0, "extracted_width": 1, "extracted_height": 1,
            "padding": 0, "tensor": np.zeros((1, 1, 1, 3), np.float32)}


def _refine(calls):
    def refine(units):
        calls.extend(units)
        return {u: torch.full((2, 2, 3), float(u)) for u in units}
    return refine


@pytest.fixture
def knobs(monkeypatch):
    def set_(policy="reassign", hedge="0", **env):
        monkeypatch.setenv(C.FAULT_POLICY_ENV, policy)
        monkeypatch.setenv(C.HEDGE_ENV, hedge)
        for k, v in env.items():
            monkeypatch.setenv(k, str(v))
    return set_


def test_tile_drain_refines_a_dead_owners_units_on_the_master(knobs):
    knobs()
    ledger = cl.WorkLedger()
    registry = cl.ClusterRegistry(lease_s=0.2, suspect_probes=1)
    registry.observe_probe("w0", True)
    registry.observe_probe("w1", True)
    ctx = _ctx(ledger, registry)
    mj = "job_reassign"
    ledger.create_job(mj, {0: "master", 1: "w0", 2: "w1", 3: "w1"})
    ledger.check_in(mj, 0, "master")
    ctx.job_store.prepare_tile_job(mj)
    ctx.job_store.put_tile(mj, _tile_item(1, "w0", is_last=True))
    calls = []
    t0 = time.monotonic()
    collected = tup.UltimateSDUpscaleDistributed()._collect_tiles(
        ctx, mj, 2, refine_window=_refine(calls))
    assert sorted(calls) == [2, 3]
    assert set(collected) == {1, 2, 3}
    assert float(collected[3]["window_tensor"][0, 0, 0]) == 3.0
    assert ledger.pending(mj) == []
    # recovery came from the lease, not from the drain's deadline
    assert time.monotonic() - t0 < C.TILE_COLLECTION_TIMEOUT / 2
    assert ledger.finish_job(mj)["reassigned_units"] == 2
    assert registry.state("w1") == cl.DEAD


def test_tile_drain_policy_fail_raises_on_a_dead_owner(knobs):
    knobs(policy="fail")
    ledger = cl.WorkLedger()
    registry = cl.ClusterRegistry(lease_s=0.1, suspect_probes=1)
    registry.observe_probe("w0", True)
    ctx = _ctx(ledger, registry)
    ledger.create_job("job_fail", {0: "w0"})
    ctx.job_store.prepare_tile_job("job_fail")
    with pytest.raises(cl.ClusterFaultError, match="w0"):
        tup.UltimateSDUpscaleDistributed()._collect_tiles(
            ctx, "job_fail", 1, refine_window=_refine([]))
    ledger.finish_job("job_fail")


def test_tile_drain_policy_partial_keeps_what_arrived(knobs, monkeypatch):
    """partial: no recovery; the drain waits out the no-progress timeout
    and returns what arrived, the lost unit left pending."""
    knobs(policy="partial")
    monkeypatch.setattr(C, "TILE_WAIT_TIMEOUT", 0.3)
    ledger = cl.WorkLedger()
    registry = cl.ClusterRegistry(lease_s=0.05, suspect_probes=1)
    registry.observe_probe("w0", True)
    ctx = _ctx(ledger, registry)
    mj = "job_partial"
    ledger.create_job(mj, {0: "w0", 1: "w1"})
    ctx.job_store.prepare_tile_job(mj)
    ctx.job_store.put_tile(mj, _tile_item(0, "w0", is_last=True))
    calls = []
    collected = tup.UltimateSDUpscaleDistributed()._collect_tiles(
        ctx, mj, 2, refine_window=_refine(calls))
    assert set(collected) == {0} and calls == []
    assert ledger.pending(mj) == [1]
    ledger.finish_job(mj)


def test_tile_drain_hedge_first_completion_wins(knobs):
    """A straggler's units are refined on the master once the job is
    past the progress gate; its late tiles then lose."""
    knobs(hedge="1", **{C.HEDGE_PCT_ENV: 25, C.HEDGE_FACTOR_ENV: 0.1,
                        C.HEDGE_MIN_WAIT_ENV: 0.05})
    ledger = cl.WorkLedger()
    registry = cl.ClusterRegistry(lease_s=60.0, suspect_probes=9)
    registry.observe_probe("w0", True)
    ctx = _ctx(ledger, registry)
    mj = "job_hedge"
    ledger.create_job(mj, {0: "master", 1: "master", 2: "w0", 3: "w0"})
    ledger.check_in(mj, 0, "master")
    time.sleep(0.05)
    ledger.check_in(mj, 1, "master")
    ctx.job_store.prepare_tile_job(mj)
    wins0 = ttrace.GLOBAL_COUNTERS.get("cluster_hedge_wins")
    dups0 = ttrace.GLOBAL_COUNTERS.get("cluster_duplicate_checkins")
    collected = tup.UltimateSDUpscaleDistributed()._collect_tiles(
        ctx, mj, 1, refine_window=_refine([]))
    assert set(collected) == {2, 3}
    assert all("window_tensor" in collected[u] for u in (2, 3))
    assert ledger.pending(mj) == []
    assert ttrace.GLOBAL_COUNTERS.get("cluster_hedge_wins") == wins0 + 2
    # the straggler's late tile is dropped at the ledger
    assert not ledger.check_in(mj, 2, "w0")
    assert ttrace.GLOBAL_COUNTERS.get("cluster_duplicate_checkins") == dups0 + 1
    assert ledger.finish_job(mj)["hedged_units"] == 2


def test_tile_drain_without_a_ledger_is_todays_drain(knobs):
    knobs()
    ctx = _ctx()
    ctx.job_store.prepare_tile_job("legacy")
    for idx, last in ((0, False), (1, True)):
        ctx.job_store.put_tile("legacy", _tile_item(idx, "w0", last))
    collected = tup.UltimateSDUpscaleDistributed()._collect_tiles(
        ctx, "legacy", 1)
    assert set(collected) == {0, 1}


def _image_item(label, index, last, value):
    return {"worker_id": label, "image_index": index, "is_last": last,
            "tensor": np.full((1, 2, 2, 3), value, np.float32)}


def _image_run(ctx, mj, workers):
    master = torch.zeros((1, 2, 2, 3))
    out = tdist.DistributedCollector()._collect_http(
        ctx, master, mj, json.dumps(workers))
    return [float(x) for x in out.data[:, 0, 0, 0]]


def test_image_drain_redispatches_a_dead_owners_slice(knobs):
    """w1's lease expires: its slice goes to the redispatcher, whose
    replacement posts as w1's positional label; the batch is complete
    and ordered as without the fault."""
    knobs()
    ledger = cl.WorkLedger()
    registry = cl.ClusterRegistry(lease_s=0.2, suspect_probes=1)
    registry.observe_probe("w0", True)
    registry.observe_probe("w1", True)
    ctx = _ctx(ledger, registry)
    mj = "img_redo"
    ctx.job_store.prepare_job(mj)
    ctx.job_store.put_result(mj, _image_item("worker_0", 0, True, 1.0))
    calls = []

    def redispatcher(units, lost):
        calls.append((list(units), lost))
        ctx.job_store.put_result(mj, _image_item("worker_1", 0, True, 2.0),
                                 idem_key="worker_1:0:2")
        return True

    ledger.set_redispatcher(mj, redispatcher)
    got = _image_run(ctx, mj, ["w0", "w1"])
    assert got == [0.0, 1.0, 2.0]
    assert calls == [(["w1"], "w1")]
    summary = ledger.snapshot()["completed_jobs"][-1]
    assert summary["done_units"] == summary["total_units"] == 2
    assert not ctx.job_store.has_job(mj)


def test_image_drain_policy_fail_raises_on_a_dead_owner(knobs):
    knobs(policy="fail")
    ledger = cl.WorkLedger()
    registry = cl.ClusterRegistry(lease_s=0.1, suspect_probes=1)
    registry.observe_probe("w0", True)
    ctx = _ctx(ledger, registry)
    ctx.job_store.prepare_job("img_fail")
    ledger.set_redispatcher("img_fail", lambda u, o: pytest.fail(
        "fail must not recover"))
    with pytest.raises(cl.ClusterFaultError, match="w0"):
        _image_run(ctx, "img_fail", ["w0"])
    assert ledger.snapshot()["completed_jobs"][-1]["pending_units"] \
        == ["w0"]


def test_image_drain_policy_partial_keeps_the_partial_batch(knobs,
                                                            monkeypatch):
    knobs(policy="partial")
    monkeypatch.setattr(C, "WORKER_JOB_TIMEOUT", 0.3)
    ledger = cl.WorkLedger()
    registry = cl.ClusterRegistry(lease_s=0.05, suspect_probes=1)
    registry.observe_probe("w1", True)
    ctx = _ctx(ledger, registry)
    ctx.job_store.prepare_job("img_partial")
    ctx.job_store.put_result("img_partial",
                             _image_item("worker_0", 0, True, 1.0))
    ledger.set_redispatcher("img_partial", lambda u, o: pytest.fail(
        "partial must not recover"))
    assert _image_run(ctx, "img_partial", ["w0", "w1"]) == [0.0, 1.0]
    assert ledger.snapshot()["completed_jobs"][-1]["pending_units"] \
        == ["w1"]


def test_image_drain_without_a_ledger_is_todays_drain(knobs):
    knobs()
    ctx = _ctx()
    ctx.job_store.prepare_job("img_legacy")
    for item in (_image_item("worker_1", 0, True, 2.0),
                 _image_item("worker_0", 0, False, 1.0),
                 _image_item("worker_0", 1, True, 1.5)):
        ctx.job_store.put_result("img_legacy", item)
    assert _image_run(ctx, "img_legacy", ["w0", "w1"]) \
        == [0.0, 1.0, 1.5, 2.0]


# --- pipelined uploads -------------------------------------------------------

class _SlowMaster(BaseHTTPRequestHandler):
    """Answers each upload 0.3 s after it arrived and records its form:
    (path, [(name, text or bytes)], arrival, answer)."""

    def do_GET(self):
        data = json.dumps({"formats": [C.TENSOR_WIRE_CONTENT_TYPE],
                           "tensor_codecs": ["zlib"]}).encode()
        self.send_response(200)
        self.send_header("Content-Length", str(len(data)))
        self.end_headers()
        self.wfile.write(data)

    def do_POST(self):
        t0 = time.perf_counter()
        body = self.rfile.read(int(self.headers["Content-Length"]))
        form = net.parse_multipart(body, self.headers["Content-Type"])
        time.sleep(0.3)
        fields = [(k, p.data if p.filename else p.text)
                  for k, p in form.items()]
        self.server.forms.append((self.path, fields, t0,
                                  time.perf_counter()))
        self.send_response(200)
        self.send_header("Content-Length", "2")
        self.end_headers()
        self.wfile.write(b"{}")

    def log_message(self, *a):
        pass


@pytest.fixture
def slow_master():
    s = ThreadingHTTPServer(("127.0.0.1", 0), _SlowMaster)
    s.forms = []
    threading.Thread(target=s.serve_forever, daemon=True).start()
    net.reset_wire_cache()
    yield s, f"http://127.0.0.1:{s.server_address[1]}"
    s.shutdown()
    s.server_close()
    net.reset_wire_cache()


def _record_encodes(monkeypatch, module):
    starts = []
    real = module.wire_payload

    def wire_payload(*a, **kw):
        starts.append(time.perf_counter())
        return real(*a, **kw)

    monkeypatch.setattr(module, "wire_payload", wire_payload)
    return starts


def test_image_uploads_encode_the_next_image_during_a_post(slow_master,
                                                           monkeypatch):
    server, url = slow_master
    starts = _record_encodes(monkeypatch, tdist)
    arr = np.random.default_rng(3).uniform(size=(3, 6, 5, 3)).astype(
        np.float32)
    spent = tdist.DistributedCollector()._send_to_master(
        arr, "exec_1_9", url, "worker_1", attempt=2)
    forms = server.forms
    assert [f[0] for f in forms] == ["/distributed/job_complete"] * 3
    for i in range(1, 3):
        # image i's encode started while POST i - 1 was unanswered
        assert starts[i] < forms[i - 1][3], (starts, forms)
    for i, (_, fields, _, _) in enumerate(forms):
        assert [k for k, _ in fields] == [
            "multi_job_id", "worker_id", "image_index", "idem_key",
            "is_last", "image"]
        assert dict(fields[:5]) == {
            "multi_job_id": "exec_1_9", "worker_id": "worker_1",
            "image_index": str(i), "idem_key": f"worker_1:{i}:2",
            "is_last": "true" if i == 2 else "false"}
        np.testing.assert_array_equal(decode_tensor(fields[5][1]),
                                      arr[i:i + 1])
    assert set(spent) == {"wire_encode", "wire_post"}
    assert spent["wire_post"] >= 0.9


def _tile_setup():
    p = dict(tile_w=32, tile_h=32, padding=8, mask_blur=2)
    all_tiles = tiling.calculate_tiles(64, 64, 32, 32)
    gen = torch.Generator().manual_seed(5)
    windows = {i: torch.rand((48, 48, 3), generator=gen) for i in range(4)}
    return p, all_tiles, windows


def test_tile_uploads_encode_the_next_tile_during_a_post(slow_master,
                                                         monkeypatch):
    server, url = slow_master
    starts = _record_encodes(monkeypatch, tup)
    p, all_tiles, windows = _tile_setup()
    op = tup.UltimateSDUpscaleDistributed()
    op._send_tiles(windows, [1, 2, 3], all_tiles, p, "exec_2_2", url, "w1",
                   (64, 64), attempt=1)
    forms = server.forms
    assert [f[0] for f in forms] == ["/distributed/tile_complete"] * 3
    for k in range(1, 3):
        assert starts[k] < forms[k - 1][3], (starts, forms)
    for k, (idx, (_, fields, _, _)) in enumerate(zip([1, 2, 3], forms)):
        tile, (x1, y1, x2, y2) = op._window_to_extracted(
            windows[idx], all_tiles[idx], p, (64, 64))
        assert [name for name, _ in fields] == [
            "multi_job_id", "worker_id", "tile_idx", "x", "y",
            "extracted_width", "extracted_height", "padding", "idem_key",
            "is_last", "tile"]
        assert dict(fields[:10]) == {
            "multi_job_id": "exec_2_2", "worker_id": "w1",
            "tile_idx": str(idx), "x": str(x1), "y": str(y1),
            "extracted_width": str(x2 - x1),
            "extracted_height": str(y2 - y1), "padding": "8",
            "idem_key": f"w1:{idx}:1",
            "is_last": "true" if k == 2 else "false"}
        np.testing.assert_array_equal(decode_tensor(fields[10][1]),
                                      tile[None].numpy())


def test_tile_uploads_honour_the_fault_injection(slow_master):
    server, url = slow_master
    p, all_tiles, windows = _tile_setup()
    t0 = time.perf_counter()
    tup.UltimateSDUpscaleDistributed()._send_tiles(
        windows, [0, 1, 2], all_tiles, p, "j", url, "w1", (64, 64),
        fault_inject={"stall_s": 0.2, "drop_tiles_after": 1})
    assert len(server.forms) == 1
    assert server.forms[0][2] - t0 >= 0.2
    assert dict(server.forms[0][1])["is_last"] == "false"


# --- drills: a torch master and two torch workers, w1 killed -----------------

def _upscale_prompt(seed=7):
    """A missing file's 512 px test card scaled to 64 px: 4 tiles of 32,
    master [0, 1], w0 [2], w1 [3]."""
    return {
        "7": {"class_type": "CheckpointLoaderSimple",
              "inputs": {"ckpt_name": "tiny.safetensors"}},
        "5": {"class_type": "CLIPTextEncode",
              "inputs": {"text": "a map", "clip": ["7", 1]}},
        "6": {"class_type": "CLIPTextEncode",
              "inputs": {"text": "", "clip": ["7", 1]}},
        "10": {"class_type": "LoadImage",
               "inputs": {"image": "__cluster_card__.png"}},
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


def _txt2img(seed=SEED):
    doc = json.loads((ROOT / "workflows" / "distributed-txt2img.json")
                     .read_text())
    doc["5"]["inputs"].update(width=64, height=64)
    doc["3"]["inputs"]["steps"] = 2
    doc["13"]["inputs"]["seed"] = seed
    doc["9"]["class_type"] = "SaveImage"
    return doc


class Drill:
    """A torch master and two torch workers in this process, each a
    server over real sockets with its own directories; the workers
    renew their leases by heartbeat and the master polls their health."""

    def __init__(self, root, w1_runs=True):
        self.root = root
        self.servers, self.states, self.urls, self.beats = {}, {}, {}, {}
        cfg_workers = []
        for name in ("w0", "w1"):
            st = self._state(name, is_worker=True,
                             start_exec_thread=name == "w0" or w1_runs)
            cfg_workers.append({"id": name, "name": name,
                                "host": "127.0.0.1", "port": st.port,
                                "enabled": True})
        (root / "master").mkdir()
        (root / "master" / "cfg.json").write_text(json.dumps(
            {"workers": cfg_workers, "master": {"host": "127.0.0.1"}}))
        master = self._state("master", is_worker=False)
        master.health.interval = 0.2
        master.health.start()
        for name in ("w0", "w1"):
            hb = self.beats[name] = cl.HeartbeatSender(
                self.urls["master"], name, port=self.states[name].port)
            assert hb.beat_once()
            hb.start()
        assert master.cluster.healthy_ids() == ["w0", "w1"]

    def _state(self, name, is_worker, start_exec_thread=True):
        d = self.root / name
        st = ServerState(config_path=str(d / "cfg.json"), is_worker=is_worker,
                         input_dir=str(d / "input"),
                         output_dir=str(d / "output"), device="cpu",
                         start_exec_thread=start_exec_thread)
        self.servers[name], self.urls[name] = _serve(st)
        self.states[name] = st
        return st

    @property
    def master(self):
        return self.states["master"]

    def kill(self, name):
        """The worker's heartbeat and server stop, as a killed process's
        would."""
        self.beats[name].stop()
        self.servers[name].shutdown()
        self.servers[name].server_close()

    def run(self, doc, kill="w1"):
        """POST ``doc`` to the master, ``kill(kill)`` (None: no one) as
        soon as /prompt returns (the dispatch has landed), wait for the
        history; returns (response, history entry, /distributed/cluster,
        new PNGs)."""
        url = self.urls["master"]
        out = self.root / "master" / "output"
        before = set(out.glob("*.png")) if out.exists() else set()
        resp = net.post_json(url + "/prompt", {"prompt": doc,
                                               "client_id": "drill"})
        if kill is not None:
            self.kill(kill)
        deadline = time.time() + DRILL_S
        while resp["prompt_id"] not in net.get_json(url + "/history"):
            assert time.time() < deadline, "no history"
            time.sleep(0.1)
        entry = net.get_json(url + "/history")[resp["prompt_id"]]
        return resp, entry, net.get_json(url + "/distributed/cluster"), \
            sorted(set(out.glob("*.png")) - before)

    def stop(self):
        self.master.health.stop()
        for hb in self.beats.values():
            hb.stop()
        for srv in self.servers.values():
            srv.shutdown()
            srv.server_close()


@pytest.fixture
def drill_env(monkeypatch):
    monkeypatch.setenv(treg.FAMILY_ENV, "tiny")
    monkeypatch.setenv(C.LEASE_ENV, "2.0")
    monkeypatch.setenv(C.SUSPECT_PROBES_ENV, "1")
    monkeypatch.setenv(C.FAULT_POLICY_ENV, "reassign")
    monkeypatch.setenv(C.HEDGE_ENV, "0")    # the lease path alone
    # the drills rerun one upscale: the reuse plane's tile tier would
    # settle the master's tiles from the earlier run
    monkeypatch.setenv(C.CACHE_ENV, "0")
    net.reset_wire_cache()
    yield
    treg.clear_pipeline_cache()


def _png_diff(path, ref):
    got = decode_png(path.read_bytes())[0]
    want = to_uint8(ref).astype(np.float32) / 255.0
    assert got.shape == want.shape
    return float(np.abs(got - want).max())


def _jax_upscale(doc):
    from comfyui_distributed_tpu.ops.base import OpContext as JaxOpContext
    from comfyui_distributed_tpu.workflow import \
        WorkflowExecutor as JaxExecutor
    res = JaxExecutor(JaxOpContext()).execute(copy.deepcopy(doc))
    res.wait_host()
    return res.image_batch[0]


def test_drill_kill_w1_mid_tiled_upscale(tmp_path, drill_env):
    """w1 refines tile 3 and dies before sending it; its lease expires,
    the master redispatches [3] to w0 and every tile checks in once."""
    doc = _upscale_prompt()
    assert tiling.partition_tiles(4, 2) == [[0, 1], [2], [3]]
    # the port's own run in one process, its tiles in the drill's batches
    whole = tup.UltimateSDUpscaleDistributed._refine_tiles

    def in_drill_batches(self, ctx, pipe, image, all_tiles, indices, *a):
        out = {}
        for part in ([0, 1], [2], [3]):
            out.update(whole(self, ctx, pipe, image, all_tiles, part, *a))
        return out

    monkey = pytest.MonkeyPatch()
    monkey.setattr(tup.UltimateSDUpscaleDistributed, "_refine_tiles",
                   in_drill_batches)
    try:
        ref = WorkflowExecutor(OpContext(device="cpu")).execute(
            copy.deepcopy(doc)).image_batch[0]
    finally:
        monkey.undo()
    jax_ref = _jax_upscale(doc)
    drill = Drill(tmp_path)
    try:
        drill.states["w1"].fault_inject = {"drop_tiles_after": 0}
        dups0 = ttrace.GLOBAL_COUNTERS.get("cluster_duplicate_checkins")
        resp, entry, snap, files = drill.run(doc)
        assert sorted(resp["workers"]) == ["w0", "w1"], resp
        assert entry["status"] == "success" and entry["images"] == 1, entry
        (job,) = [j for j in snap["ledger"]["completed_jobs"]
                  if j["kind"] == "tile"]
        assert job["done_units"] == job["total_units"] == 4
        assert job["pending_units"] == [] and job["reassigned_units"] >= 1
        assert snap["workers"]["w1"]["state"] == cl.DEAD
        assert snap["workers"]["w0"]["state"] == cl.HEALTHY
        assert ttrace.GLOBAL_COUNTERS.get("cluster_duplicate_checkins") == dups0
        (f,) = files
        assert _png_diff(f, ref) <= EXACT
        assert _png_diff(f, jax_ref) <= ONE_STEP
    finally:
        drill.stop()


def test_drill_kill_w1_after_an_image_fanout_dispatch(tmp_path, drill_env):
    """w1 accepts its share and never runs it; its lease expires and the
    master redispatches its seed slice to w0 under w1's identity."""
    refs = [WorkflowExecutor(OpContext(device="cpu")).execute(
        _txt2img(SEED + k)).image_batch[0] for k in range(3)]
    drill = Drill(tmp_path, w1_runs=False)
    try:
        m0 = net.get_json(drill.urls["master"] + "/distributed/metrics")
        resp, entry, snap, files = drill.run(_txt2img())
        assert sorted(resp["workers"]) == ["w0", "w1"], resp
        assert entry["status"] == "success" and entry["images"] == 3, entry
        (job,) = [j for j in snap["ledger"]["completed_jobs"]
                  if j["kind"] == "image"]
        assert job["done_units"] == job["total_units"] == 2
        assert job["pending_units"] == [] and job["reassigned_units"] == 1
        assert snap["workers"]["w1"]["state"] == cl.DEAD
        m1 = net.get_json(drill.urls["master"] + "/distributed/metrics")
        assert m1["images_received"] - m0["images_received"] == 2
        assert m1["pipeline"]["counters"]["cluster_redispatches"] \
            > m0["pipeline"]["counters"].get("cluster_redispatches", 0)
        assert len(files) == 3
        for f, ref in zip(files, refs):
            assert _png_diff(f, ref) <= EXACT, f
        # a wrong seed is far off
        assert _png_diff(files[2], refs[1]) > 0.1
    finally:
        drill.stop()


def test_fanout_upscale_with_the_tile_tier(tmp_path, drill_env,
                                           monkeypatch):
    """The fan-out upscale with the reuse plane on, its default (no
    worker killed).  The master stores its own and the workers' refined
    tiles; a re-run checks every tile in to the ledger as ``cache``
    before any work, drops the workers' sends of them, ends its drain
    and equals the first run to the bit.  A source changed inside tiles
    0 and 3 refines only those, each where its owner is (the master,
    w1), and equals a ``DTPU_CACHE=0`` fan-out of it to the bit outside
    their windows and within one 8-bit step inside (tile 0 is refined
    alone, not in a batch of two)."""
    monkeypatch.delenv(C.CACHE_ENV)
    reuse.reset_reuse()
    rng = np.random.default_rng(31)
    src = rng.uniform(size=(64, 64, 3)).astype(np.float32)
    changed = src.copy()
    changed[2:6, 2:6] = 1.0 - changed[2:6, 2:6]      # tile 0's core
    changed[58:62, 58:62] = 1.0 - changed[58:62, 58:62]  # tile 3's
    tiles = tiling.calculate_tiles(64, 64, 32, 32)
    regions = [tiling.extraction_region(*t, 32, 32, 8, 64, 64)
               for t in tiles]
    dirty = [i for i, (x1, y1, x2, y2) in enumerate(regions)
             if not np.array_equal(src[y1:y2, x1:x2],
                                   changed[y1:y2, x1:x2])]
    assert dirty == [0, 3]

    def doc(image):
        out = _upscale_prompt()
        out["10"]["inputs"]["image"] = image
        return out

    drill = Drill(tmp_path)
    for name in ("master", "w0", "w1"):
        d = tmp_path / name / "input"
        d.mkdir(parents=True, exist_ok=True)
        save_png(str(d / "a.png"), src)
        save_png(str(d / "b.png"), changed)
    checkins = []
    ledger = drill.master.ledger
    real = ledger.check_in

    def spy(job_id, unit, worker_id, *a, **kw):
        won = real(job_id, unit, worker_id, *a, **kw)
        checkins.append((str(job_id), int(unit), str(worker_id), won))
        return won

    monkeypatch.setattr(ledger, "check_in", spy)

    def run(image):
        del checkins[:]
        skipped0 = ttrace.GLOBAL_COUNTERS.get("tiles_skipped")
        resp, entry, snap, files = drill.run(doc(image), kill=None)
        assert sorted(resp["workers"]) == ["w0", "w1"], resp
        assert entry["status"] == "success", entry
        job = next(j for j in reversed(snap["ledger"]["completed_jobs"])
                   if j["kind"] == "tile")
        assert job["done_units"] == job["total_units"] == 4
        assert job["pending_units"] == [], job
        winners = {u: w for jid, u, w, won in checkins
                   if won and jid == job["job_id"]}
        (f,) = files
        return (winners, ttrace.GLOBAL_COUNTERS.get("tiles_skipped")
                - skipped0, decode_png(f.read_bytes())[0])

    try:
        winners, skipped, first = run("a.png")
        assert winners == {0: "master", 1: "master", 2: "w0", 3: "w1"}
        assert skipped == 0
        winners, skipped, again = run("a.png")
        assert winners == {i: "cache" for i in range(4)} and skipped == 4
        np.testing.assert_array_equal(again, first)
        winners, skipped, got = run("b.png")
        assert winners == {0: "master", 1: "cache", 2: "cache", 3: "w1"}
        assert skipped == 2
        monkeypatch.setenv(C.CACHE_ENV, "0")
        winners, skipped, want = run("b.png")
        assert winners == {0: "master", 1: "master", 2: "w0", 3: "w1"}
        assert skipped == 0
    finally:
        drill.stop()
        reuse.reset_reuse()
    outside = np.ones(got.shape[:2], bool)
    for i in dirty:
        x1, y1, x2, y2 = regions[i]
        outside[y1:y2, x1:x2] = False
    assert outside.any()
    np.testing.assert_array_equal(got[outside], want[outside])
    assert float(np.abs(got - want).max()) <= ONE_STEP
    assert np.abs(got - first).max() > 0.1
