"""The port's elastic fleet (``comfyui_distributed_tpu_torch/runtime/
autoscale.py``, the retiring state of ``runtime/cluster.py``, the
``/distributed/fleet`` route, ``cli top`` and ``cli fleet``) against the
JAX package's.

- Both packages' ``FleetAutoscaler`` run on one scripted sequence of
  inputs (the master's and the workers' queue depths, utilization, the
  parked backlog, the paid burn rate, a shard stub's peer depth, live
  peers and actuator flag), each with a registry of its own package on
  its own copy of one fake clock, and must return equal samples, equal
  decisions (action, reason, worker, queue per participant, time),
  equal counters and equal registry states at every step.
- The JAX package's ``TestAutoscalerHysteresis`` cases
  (``tests/test_overload.py``) run on the port's classes.
- On the port's servers: the fleet route's keys on an armed master, an
  unarmed one, a worker and the router against the JAX package's; the
  preflight skipping a retiring worker without a probe; ``cli top`` and
  ``cli fleet`` printing the JAX package's text for the same JSON; and a
  master with ``DTPU_AUTOSCALE=1`` that spawns a real ``cli worker
  --device cpu`` through the default spawner, hands it a share of a
  tiny fan-out and retires it, its process tree gone.
"""

import asyncio
import contextlib
import io
import json
import pathlib
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np
import pytest
from aiohttp.test_utils import TestClient, TestServer

from comfyui_distributed_tpu import cli as jcli
from comfyui_distributed_tpu.runtime import autoscale as jauto
from comfyui_distributed_tpu.runtime import cluster as jcl
from comfyui_distributed_tpu.server.app import ServerState as JaxState
from comfyui_distributed_tpu.server.app import build_app
from comfyui_distributed_tpu.utils import trace as jtrace
from comfyui_distributed_tpu_torch import cli as tcli
from comfyui_distributed_tpu_torch.models import registry as treg
from comfyui_distributed_tpu_torch.ops.base import OpContext
from comfyui_distributed_tpu_torch.runtime import autoscale as tauto
from comfyui_distributed_tpu_torch.runtime import cluster as tcl
from comfyui_distributed_tpu_torch.runtime import reuse
from comfyui_distributed_tpu_torch.runtime import shard as shard_mod
from comfyui_distributed_tpu_torch.server.app import ServerState, make_server
from comfyui_distributed_tpu_torch.utils import config as cfg_mod
from comfyui_distributed_tpu_torch.utils import constants as C
from comfyui_distributed_tpu_torch.utils import net
from comfyui_distributed_tpu_torch.utils import process as tproc
from comfyui_distributed_tpu_torch.utils import trace as ttrace
from comfyui_distributed_tpu_torch.utils.image import decode_png, to_uint8
from comfyui_distributed_tpu_torch.workflow import WorkflowExecutor
from comfyui_distributed_tpu_torch.workflow import dispatcher as dsp

ROOT = pathlib.Path(__file__).resolve().parents[1]
COUNTERS = ("autoscale_up", "autoscale_down", "autoscale_flaps",
            "autoscale_retired")
SPAWN_S = 90       # the real worker's drill, each wait's own limit
EXACT = 1e-6


class FakeClock:
    """A clock that moves only when the case steps it."""

    def __init__(self):
        self.mono = 500.0
        self.wall = 1.7e9

    def time(self):
        return self.wall

    def monotonic(self):
        return self.mono

    def step(self, s):
        self.mono += s
        self.wall += s


class ShardStub:
    """The three readers the autoscaler asks of a sharded master."""

    def __init__(self):
        self.peer_q, self.peers, self.actuator = 0, 0, True

    def peer_queue_depth(self):
        return self.peer_q

    def live_peer_masters(self):
        return self.peers

    def is_autoscale_actuator(self):
        return self.actuator


class Side:
    """One package's autoscaler, registry and fake clock, driven by the
    script's current inputs."""

    def __init__(self, auto, cl, counters, kw, lease_s, shard, slo):
        self.cl, self.counters = cl, counters
        self.clock = FakeClock()
        self.reg = cl.ClusterRegistry(lease_s=lease_s, clock=self.clock)
        self.now = {}
        self.spawned, self.retired = [], []
        self.before = {n: counters.get(n) for n in COUNTERS}
        self.shard = ShardStub() if shard else None
        self.scaler = auto.FleetAutoscaler(
            registry=self.reg,
            queue_depth_fn=lambda: self.now["master_q"],
            util_fn=lambda: self.now["util"],
            spawner=self.spawn, retirer=self.retire,
            worker_queue_fn=lambda wid: self.now["wq"].get(
                wid, self.now["wq_default"]),
            shard=self.shard,
            parked_backlog_fn=lambda: self.now["parked"],
            slo_burn_fn=(lambda: self.now["burn"]) if slo else None,
            clock=self.clock, **kw)

    def spawn(self):
        wid = f"auto{len(self.spawned)}"
        self.spawned.append(wid)
        self.reg.register(wid, info={"host": "h", "port": 1}, alive=True)
        return wid

    def retire(self, wid):
        self.retired.append(wid)
        return True

    def step(self, inputs):
        self.clock.step(inputs["dt"])
        self.now = inputs
        if self.shard is not None:
            self.shard.peer_q = inputs["peer_q"]
            self.shard.peers = inputs["peers"]
            self.shard.actuator = inputs["actuator"]
        # live workers renew their leases unless the script stalls them
        for wid in self.spawned:
            if wid not in inputs["silent"] \
                    and self.reg.state(wid) != self.cl.DEAD \
                    and wid in self.reg.snapshot()["workers"]:
                self.reg.heartbeat(wid)
        out = self.scaler.sample_once()
        return {"sample": out,
                "states": {w: v["state"] for w, v in
                           self.reg.snapshot()["workers"].items()},
                "counters": {n: self.counters.get(n) - self.before[n]
                             for n in COUNTERS}}


def _inputs(**over):
    base = {"dt": 1.0, "master_q": 0, "wq": {}, "wq_default": 0,
            "util": None, "parked": 0, "burn": None, "peer_q": 0,
            "peers": 0, "actuator": True, "silent": ()}
    return {**base, **over}


def _script_burst_then_idle():
    return ({"window": 3, "cooldown_s": 5.0, "max_workers": 3}, 60.0,
            [_inputs(master_q=20) for _ in range(16)]
            + [_inputs(master_q=2) for _ in range(6)]
            + [_inputs() for _ in range(30)])


def _script_oscillating():
    return ({"window": 3, "cooldown_s": 0.0}, 60.0,
            [_inputs(master_q=100 if i % 2 == 0 else 0) for i in range(30)])


def _script_utilization():
    return ({"window": 2, "cooldown_s": 3.0, "max_workers": 2}, 60.0,
            [_inputs(master_q=1, util=0.95) for _ in range(12)]
            + [_inputs(util=0.5) for _ in range(5)]
            + [_inputs(util=0.1) for _ in range(20)])


def _script_parked():
    return ({"window": 2, "cooldown_s": 2.0, "max_workers": 2}, 60.0,
            [_inputs(parked=12) for _ in range(10)]
            + [_inputs() for _ in range(20)])


def _script_slo_burn():
    return ({"window": 2, "cooldown_s": 2.0, "max_workers": 2}, 60.0,
            [_inputs(burn=2.5) for _ in range(10)]
            + [_inputs(burn=0.2) for _ in range(20)])


def _script_shard():
    steps = [_inputs(master_q=3, peer_q=12, peers=1,
                     actuator=i >= 4) for i in range(12)]
    steps += [_inputs(peer_q=0, peers=1, actuator=(i % 5 != 0))
              for i in range(24)]
    return ({"window": 2, "cooldown_s": 2.0, "max_workers": 3}, 60.0,
            steps)


def _script_draining_queue():
    """A retiring worker whose queue reads busy, then unknown, then
    empty: it is reaped only on the empty reading."""
    steps = [_inputs(master_q=30) for _ in range(4)]
    steps += [_inputs(wq={"auto0": 3}) for _ in range(6)]
    steps += [_inputs(wq={"auto0": None}, wq_default=None)
              for _ in range(3)]
    steps += [_inputs() for _ in range(6)]
    return ({"window": 2, "cooldown_s": 1.0, "max_workers": 1,
             "drain_s": 100.0}, 60.0, steps)


def _script_forced():
    """The queue never drains: the drain deadline forces the stop and
    the record is kept; a silent worker ages to DEAD."""
    steps = [_inputs(master_q=50) for _ in range(3)]
    steps += [_inputs(master_q=0, wq_default=7) for _ in range(8)]
    steps += [_inputs(master_q=0, wq_default=7, silent=("auto0",))
              for _ in range(6)]
    return ({"window": 1, "cooldown_s": 0.0, "max_workers": 1,
             "drain_s": 3.0, "down_queue": 200.0}, 4.0, steps)


def _script_random():
    rng = np.random.default_rng(20250117)
    steps = []
    for _ in range(120):
        steps.append(_inputs(
            dt=float(rng.choice([0.5, 1.0, 2.0])),
            master_q=int(rng.integers(0, 14)),
            wq_default=int(rng.integers(0, 3)),
            util=None if rng.random() < 0.3 else float(rng.random()),
            parked=int(rng.integers(0, 3)),
            burn=None if rng.random() < 0.5 else float(rng.random() * 2),
            peer_q=int(rng.integers(0, 5)), peers=int(rng.integers(0, 2)),
            actuator=bool(rng.random() < 0.8)))
    return ({"window": 2, "cooldown_s": 2.0, "max_workers": 3,
             "drain_s": 4.0}, 60.0, steps)


SCRIPTS = {
    "burst_then_idle": (_script_burst_then_idle, False, False),
    "oscillating": (_script_oscillating, False, False),
    "utilization": (_script_utilization, False, False),
    "parked_backlog": (_script_parked, False, False),
    "slo_burn": (_script_slo_burn, False, True),
    "shard_actuator": (_script_shard, True, False),
    "draining_queue": (_script_draining_queue, False, False),
    "forced_retirement": (_script_forced, False, False),
    "random": (_script_random, True, True),
}


@pytest.mark.parametrize("name", sorted(SCRIPTS))
def test_decisions_equal_the_jax_autoscalers(name):
    make, shard, slo = SCRIPTS[name]
    kw, lease_s, steps = make()
    kw = {"min_workers": 0, "max_workers": 3, "up_queue": 4.0,
          "down_queue": 1.0, "up_util": 0.85, "down_util": 0.30,
          "interval_s": 0.05, "drain_s": 5.0, **kw}
    jside = Side(jauto, jcl, jtrace.GLOBAL_COUNTERS, kw, lease_s, shard, slo)
    tside = Side(tauto, tcl, ttrace.GLOBAL_COUNTERS, kw, lease_s, shard, slo)
    for i, inputs in enumerate(steps):
        j, t = jside.step(inputs), tside.step(inputs)
        assert t == j, f"step {i}: {t} != {j}"
    js, ts = jside.scaler.snapshot(), tside.scaler.snapshot()
    assert sorted(ts) == sorted(js)
    assert ts == js
    assert tside.spawned == jside.spawned
    assert tside.retired == jside.retired
    # the scripts do scale: each but the oscillating one acts
    if name != "oscillating":
        assert ts["scale_ups"] >= 1, ts


# --- the JAX package's hysteresis cases on the port ---------------------------

def make_scaler(**kw):
    reg = tcl.ClusterRegistry(lease_s=60.0)
    spawned, retired = [], []

    def spawner():
        wid = f"auto{len(spawned)}"
        spawned.append(wid)
        reg.register(wid, info={"host": "h", "port": 1}, alive=True)
        return wid

    def retirer(wid):
        retired.append(wid)
        return True

    depth = {"v": 0}
    kw.setdefault("min_workers", 0)
    kw.setdefault("max_workers", 3)
    kw.setdefault("up_queue", 4.0)
    kw.setdefault("down_queue", 1.0)
    kw.setdefault("window", 3)
    kw.setdefault("cooldown_s", 10.0)
    kw.setdefault("interval_s", 0.05)
    kw.setdefault("drain_s", 5.0)
    sc = tauto.FleetAutoscaler(
        registry=reg, queue_depth_fn=lambda: depth["v"],
        spawner=spawner, retirer=retirer,
        worker_queue_fn=lambda wid: 0, **kw)
    return sc, reg, depth, spawned, retired


def _case_sustained_window():
    sc, reg, depth, spawned, _ = make_scaler()
    depth["v"] = 100
    sc.sample_once(0.0)
    sc.sample_once(1.0)
    assert not spawned          # 2 samples < a window of 3
    sc.sample_once(2.0)
    assert spawned == ["auto0"]


def _case_dip_resets_the_streak():
    sc, reg, depth, spawned, _ = make_scaler()
    depth["v"] = 100
    sc.sample_once(0.0)
    sc.sample_once(1.0)
    depth["v"] = 0              # one calm sample resets the streak
    sc.sample_once(2.0)
    depth["v"] = 100
    sc.sample_once(3.0)
    sc.sample_once(4.0)
    assert not spawned
    sc.sample_once(5.0)
    assert len(spawned) == 1


def _case_oscillation_never_flaps():
    sc, reg, depth, spawned, retired = make_scaler(cooldown_s=0.0)
    for i in range(30):
        depth["v"] = 100 if i % 2 == 0 else 0
        sc.sample_once(float(i))
    assert spawned == [] and retired == []
    assert sc.flaps == 0


def _case_cooldown_blocks_consecutive_actions():
    sc, reg, depth, spawned, _ = make_scaler(cooldown_s=10.0)
    depth["v"] = 100
    for i in range(3):
        sc.sample_once(float(i))
    assert len(spawned) == 1
    for i in range(3, 9):       # still over the bar, inside the cooldown
        sc.sample_once(float(i))
    assert len(spawned) == 1
    for i in range(13, 17):     # the cooldown over: a second spawn
        sc.sample_once(float(i))
    assert len(spawned) == 2


def _case_drain_then_retire_and_forget():
    sc, reg, depth, spawned, retired = make_scaler(cooldown_s=0.0)
    depth["v"] = 100
    for i in range(3):
        sc.sample_once(float(i))
    assert spawned == ["auto0"]
    depth["v"] = 0
    for i in range(10, 14):
        sc.sample_once(float(i))
    assert retired == ["auto0"]
    assert reg.snapshot()["workers"].get("auto0") is None   # forgotten
    assert sc.scale_downs == 1


def _case_retiring_worker_is_not_dispatchable():
    reg = tcl.ClusterRegistry(lease_s=60.0)
    reg.register("w0", info={}, alive=True)
    assert reg.state("w0") == tcl.HEALTHY
    assert reg.set_retiring("w0")
    assert reg.state("w0") == tcl.RETIRING
    assert reg.snapshot()["workers"]["w0"]["retiring"] is True
    assert "w0" not in reg.healthy_ids()
    reg.set_retiring("w0", False)
    assert reg.state("w0") == tcl.HEALTHY
    assert not reg.set_retiring("nobody")


def _case_forced_retirement_keeps_the_record():
    reg = tcl.ClusterRegistry(lease_s=0.1)
    retired = []
    sc = tauto.FleetAutoscaler(
        registry=reg, queue_depth_fn=lambda: 100,
        spawner=lambda: (reg.register("autoX", alive=True)
                         and None) or "autoX",
        retirer=lambda wid: retired.append(wid) or True,
        worker_queue_fn=lambda wid: 7,   # never drains
        min_workers=0, max_workers=1, up_queue=4.0,
        down_queue=200.0,                # "under" at once
        window=1, cooldown_s=0.0, interval_s=0.05, drain_s=1.0)
    sc.sample_once(0.0)                  # spawns autoX
    sc.sample_once(1.0)                  # marks it retiring
    assert reg.state("autoX") == tcl.RETIRING
    sc.sample_once(3.0)                  # the deadline passed: forced
    assert retired == ["autoX"]
    # the record is kept; the expired lease reads DEAD, which the
    # drains' recovery keys on
    time.sleep(0.15)
    assert reg.state("autoX") == tcl.DEAD


def _case_reversal_inside_the_flap_window_counts():
    sc, reg, depth, spawned, retired = make_scaler(
        cooldown_s=0.0, window=1, flap_window_s=100.0)
    depth["v"] = 100
    sc.sample_once(0.0)
    assert spawned
    depth["v"] = 0
    sc.sample_once(1.0)          # an immediate reversal: a flap
    assert sc.flaps == 1


HYSTERESIS = {
    "sustained_window": _case_sustained_window,
    "dip_resets_the_streak": _case_dip_resets_the_streak,
    "oscillation_never_flaps": _case_oscillation_never_flaps,
    "cooldown_blocks_consecutive_actions":
        _case_cooldown_blocks_consecutive_actions,
    "drain_then_retire_and_forget": _case_drain_then_retire_and_forget,
    "retiring_worker_is_not_dispatchable":
        _case_retiring_worker_is_not_dispatchable,
    "forced_retirement_keeps_the_record":
        _case_forced_retirement_keeps_the_record,
    "reversal_inside_the_flap_window_counts":
        _case_reversal_inside_the_flap_window_counts,
}


@pytest.mark.parametrize("case", sorted(HYSTERESIS))
def test_autoscaler_hysteresis(case):
    HYSTERESIS[case]()


def test_a_starting_worker_counts_as_live_until_it_registers():
    """The port's ``pending_fn``: a spawned worker whose cold start
    outlasts its lease is counted as a participant, so the loop does not
    spawn it again; it stops counting once the registry holds it."""
    reg = tcl.ClusterRegistry(lease_s=60.0)
    spawned = []
    starting = {"n": 0}

    def spawner():
        spawned.append(f"auto{len(spawned)}")
        starting["n"] += 1
        return spawned[-1]

    sc = tauto.FleetAutoscaler(
        registry=reg, queue_depth_fn=lambda: 8, spawner=spawner,
        retirer=lambda w: True, window=1, cooldown_s=0.0, max_workers=1,
        up_queue=2.0, pending_fn=lambda: starting["n"])
    out = sc.sample_once(0.0)
    assert out["action"] == "up" and spawned == ["auto0"]
    for t in range(1, 6):
        out = sc.sample_once(float(t))
        assert out["action"] is None, out
        assert out["live_workers"] == 1 and out["pending_workers"] == 1
        assert out["queue_per_participant"] == 4.0
    starting["n"] = 0
    reg.register("auto0", alive=True)
    out = sc.sample_once(6.0)
    assert out["live_workers"] == 1 and "pending_workers" not in out
    assert spawned == ["auto0"] and sc.scale_ups == 1


def test_armed_only_by_the_variable(monkeypatch):
    monkeypatch.delenv(C.AUTOSCALE_ENV, raising=False)
    assert tauto.autoscale_armed() is jauto.autoscale_armed() is False
    for raw in ("1", "true", "on", "0", "off", "yes"):
        monkeypatch.setenv(C.AUTOSCALE_ENV, raw)
        assert tauto.autoscale_armed() == jauto.autoscale_armed()


def test_env_knobs_read_as_the_jax_package(monkeypatch):
    for name, value in ((C.AUTOSCALE_MIN_ENV, "1"),
                        (C.AUTOSCALE_MAX_ENV, "2"),
                        (C.AUTOSCALE_UP_QUEUE_ENV, "2"),
                        (C.AUTOSCALE_DOWN_QUEUE_ENV, "0.5"),
                        (C.AUTOSCALE_WINDOW_ENV, "2"),
                        (C.AUTOSCALE_COOLDOWN_ENV, "3"),
                        (C.AUTOSCALE_INTERVAL_ENV, "0.5"),
                        (C.AUTOSCALE_DRAIN_ENV, "bad")):
        monkeypatch.setenv(name, value)
    t = tauto.FleetAutoscaler(registry=None, queue_depth_fn=lambda: 0)
    j = jauto.FleetAutoscaler(registry=None, queue_depth_fn=lambda: 0)
    ts, js = t.snapshot(), j.snapshot()
    assert ts == js
    assert (t.flap_window_s, t.drain_s) == (j.flap_window_s, j.drain_s) \
        == (6.0, C.AUTOSCALE_DRAIN_DEFAULT)


# --- the server's readers -------------------------------------------------------

def test_install_wires_the_servers_readers(tmp_path, monkeypatch):
    """``install`` arms only under ``DTPU_AUTOSCALE=1``, reads the
    server's queue depth, the parked backlog and, under
    ``DTPU_AUTOSCALE_SLO=1`` with a spec, the paid fast burn rate."""
    monkeypatch.setenv(C.SLO_SPEC_ENV, "paid:p95<2s")
    st = ServerState(config_path=str(tmp_path / "cfg.json"), device="cpu",
                     input_dir=str(tmp_path), output_dir=str(tmp_path),
                     start_exec_thread=False)
    monkeypatch.delenv(C.AUTOSCALE_ENV, raising=False)
    assert tauto.install(st) is None
    monkeypatch.setenv(C.AUTOSCALE_ENV, "1")
    monkeypatch.setenv(C.AUTOSCALE_SLO_ENV, "1")
    monkeypatch.setenv(C.AUTOSCALE_INTERVAL_ENV, "60")

    class Parked:
        def parked_count(self):
            return 3

    st.cb = Parked()
    sc = tauto.install(st)
    try:
        assert sc.snapshot()["running"] is True
        assert sc.registry is st.cluster and sc.shard is None
        assert sc.queue_depth_fn == st.queue_remaining
        assert sc.parked_backlog_fn() == 3
        assert sc.slo_burn_fn() == st.slo.burn_rate("paid", "fast")
        sig = sc.fleet_signal()
        assert sig["parked_backlog"] == 3 and sig["queue_depth"] == 3
        assert sig["slo_burn"] == 0.0
    finally:
        sc.stop()
    assert sc.snapshot()["running"] is False


def test_drain_stops_the_autoscaler(tmp_path):
    st = ServerState(config_path=str(tmp_path / "cfg.json"), device="cpu",
                     input_dir=str(tmp_path), output_dir=str(tmp_path),
                     start_exec_thread=False)
    st.autoscaler = tauto.FleetAutoscaler(
        registry=st.cluster, queue_depth_fn=st.queue_remaining,
        interval_s=0.05)
    st.autoscaler.start()
    assert st.autoscaler.snapshot()["running"]
    assert st.drain(timeout=1.0)
    assert st.autoscaler.snapshot()["running"] is False


def test_batch_executor_reads_the_parked_backlog():
    from comfyui_distributed_tpu_torch.workflow import batch_executor as bx

    class Store:
        def count(self):
            return 5

    ex = bx.ContinuousBatchExecutor.__new__(bx.ContinuousBatchExecutor)
    ex.parked = Store()
    assert ex.parked_count() == 5


# --- the preflight and the fleet route ---------------------------------------------

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


def test_preflight_skips_a_retiring_worker_without_a_probe():
    servers = []
    for _ in range(2):
        s = ThreadingHTTPServer(("127.0.0.1", 0), _Probed)
        s.hits = 0
        threading.Thread(target=s.serve_forever, daemon=True).start()
        servers.append(s)
    try:
        workers = [{"id": wid, "host": "127.0.0.1",
                    "port": s.server_address[1], "enabled": True}
                   for wid, s in zip(("wret", "wok"), servers)]
        reg = tcl.ClusterRegistry(lease_s=60.0)
        for w in workers:
            reg.register(w["id"], alive=True)
        reg.set_retiring("wret")
        alive = dsp.preflight_check(workers, registry=reg)
        assert [w["id"] for w in alive] == ["wok"]
        assert [s.hits for s in servers] == [0, 1]
        assert reg.state("wret") == tcl.RETIRING
    finally:
        for s in servers:
            s.shutdown()
            s.server_close()


def _serve(state):
    srv = make_server(state, "127.0.0.1", 0)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    return srv, f"http://127.0.0.1:{state.port}"


def _armed(auto, cl, state):
    """An autoscaler of ``auto``'s package on ``state``, not started, with
    one decision in its ring."""
    def spawner():
        state.cluster.register("auto_a", info={"host": "h", "port": 1},
                               alive=True)
        return "auto_a"

    sc = auto.FleetAutoscaler(
        registry=state.cluster, queue_depth_fn=lambda: 9,
        util_fn=lambda: 0.5, spawner=spawner, retirer=lambda w: True,
        window=1, cooldown_s=0.0, max_workers=2)
    sc.sample_once(0.0)
    return sc


def _shape(d):
    """Keys all the way down, the workers' ids, rings and lists left
    out."""
    if not isinstance(d, dict):
        return type(d).__name__ if d is None or isinstance(
            d, (bool, str)) else "value"
    return {k: ("map" if k in ("workers", "per_class", "queued_by_class",
                               "injected", "weights", "shed_thresholds")
                else _shape(v)) for k, v in d.items()}


def _jax_fleet(tmp_path, prepare, is_worker=False):
    async def go():
        state = JaxState(config_path=str(tmp_path / "jcfg.json"),
                         input_dir=str(tmp_path / "jin"),
                         output_dir=str(tmp_path / "jout"),
                         is_worker=is_worker, start_exec_thread=False)
        if prepare is not None:
            state.autoscaler = prepare(state)
        client = TestClient(TestServer(build_app(state)))
        await client.start_server()
        try:
            r = await client.get("/distributed/fleet")
            assert r.status == 200
            return await r.json()
        finally:
            await client.close()
            state.manager.cleanup_all()
    return asyncio.run(go())


def _port_fleet(tmp_path, prepare, is_worker=False):
    st = ServerState(config_path=str(tmp_path / "tcfg.json"), device="cpu",
                     input_dir=str(tmp_path / "tin"),
                     output_dir=str(tmp_path / "tout"),
                     is_worker=is_worker, start_exec_thread=False)
    if prepare is not None:
        st.autoscaler = prepare(st)
    srv, url = _serve(st)
    try:
        return net.get_json(url + "/distributed/fleet")
    finally:
        srv.shutdown()
        srv.server_close()


@pytest.mark.parametrize("role", ["armed_master", "unarmed_master",
                                  "worker"])
def test_fleet_route_has_the_jax_packages_keys(tmp_path, role, monkeypatch):
    monkeypatch.setenv(C.AUTOSCALE_ENV, "1" if role == "worker" else "0")
    armed = role == "armed_master"
    j = _jax_fleet(tmp_path, (lambda s: _armed(jauto, jcl, s))
                   if armed else None, is_worker=role == "worker")
    t = _port_fleet(tmp_path, (lambda s: _armed(tauto, tcl, s))
                    if armed else None, is_worker=role == "worker")
    assert _shape(t) == _shape(j)
    assert set(t["workers"]) == set(j["workers"])
    if armed:
        assert [d["action"] for d in t["autoscale"]["decisions"]] == ["up"]
        assert t["autoscale"]["decisions"][0]["reason"] == \
            j["autoscale"]["decisions"][0]["reason"]
        assert t["autoscale"]["signal"] == j["autoscale"]["signal"]
        assert t["workers"]["auto_a"]["state"] == "healthy"
        assert set(t["workers"]["auto_a"]) == set(j["workers"]["auto_a"])
    else:
        assert t["autoscale"] == j["autoscale"] == {
            "enabled": False, "armed_env": role == "worker",
            "signal": None}


def test_metrics_and_prometheus_carry_the_fleet(tmp_path, monkeypatch):
    monkeypatch.setenv(C.AUTOSCALE_ENV, "0")
    st = ServerState(config_path=str(tmp_path / "cfg.json"), device="cpu",
                     input_dir=str(tmp_path), output_dir=str(tmp_path),
                     start_exec_thread=False)
    srv, url = _serve(st)
    try:
        m = net.get_json(url + "/distributed/metrics")
        assert m["autoscale"] == {"enabled": False}
        assert m["chaos"]["active"] is False
        prom = _text(url + "/distributed/metrics.prom")
        assert "dtpu_autoscale_scale_ups_total" not in prom
        assert 'dtpu_cluster_workers{state="retiring"} 0' in prom
        st.autoscaler = _armed(tauto, tcl, st)
        st.cluster.set_retiring("auto_a")
        m = net.get_json(url + "/distributed/metrics")
        assert m["autoscale"]["scale_ups"] == 1
        prom = _text(url + "/distributed/metrics.prom")
        assert "dtpu_autoscale_scale_ups_total 1" in prom
        assert "dtpu_autoscale_scale_downs_total 0" in prom
        assert "dtpu_autoscale_flaps_total 0" in prom
        assert "dtpu_autoscale_retiring 0" in prom
        assert 'dtpu_cluster_workers{state="retiring"} 1' in prom
    finally:
        srv.shutdown()
        srv.server_close()


def _text(url):
    import urllib.request
    with urllib.request.urlopen(url, timeout=10) as r:
        return r.read().decode()


def test_router_merges_the_fleet_as_the_jax_router(tmp_path, monkeypatch):
    """Both packages' routers over the same two sharded port masters
    (one armed) give the same merged view."""
    from comfyui_distributed_tpu.runtime import shard as jshard
    ports = [net.find_free_port() for _ in range(2)]
    urls = [f"http://127.0.0.1:{p}" for p in ports]
    monkeypatch.setenv(C.SHARD_PEERS_ENV, ",".join(
        f"m{i}={u}" for i, u in enumerate(urls)))
    monkeypatch.setenv(C.SHARD_WAL_ROOT_ENV, str(tmp_path / "wal"))
    states, servers = [], []
    for i in range(2):
        with monkeypatch.context() as m:
            m.setenv(C.SHARD_ID_ENV, f"m{i}")
            st = ServerState(config_path=str(tmp_path / f"m{i}.json"),
                             device="cpu", input_dir=str(tmp_path),
                             output_dir=str(tmp_path),
                             start_exec_thread=False)
        srv = make_server(st, "127.0.0.1", ports[i])
        threading.Thread(target=srv.serve_forever, daemon=True).start()
        states.append(st)
        servers.append(srv)
    states[0].autoscaler = _armed(tauto, tcl, states[0])
    rsrv = shard_mod.make_router_server(urls, "127.0.0.1", 0)
    threading.Thread(target=rsrv.serve_forever, daemon=True).start()
    try:
        t = net.get_json(f"http://127.0.0.1:{rsrv.server_address[1]}"
                         "/distributed/fleet")

        async def jax_router():
            client = TestClient(TestServer(jshard.build_router_app(urls)))
            await client.start_server()
            try:
                r = await client.get("/distributed/fleet")
                return await r.json()
            finally:
                await client.close()
        j = asyncio.run(jax_router())
        assert t["shards"] == j["shards"] == ["m0", "m1"]
        assert set(t) == set(j) == {"autoscale", "admission", "workers",
                                    "shards"}
        for k in ("enabled", "scale_ups", "scale_downs", "flaps"):
            assert t["autoscale"][k] == j["autoscale"][k]
        assert t["autoscale"]["scale_ups"] == 1
        assert set(t["autoscale"]["shards"]) == {"m0", "m1"}
        assert set(t["admission"]) == set(j["admission"])
        assert t["admission"]["per_class"] == j["admission"]["per_class"]
        assert set(t["workers"]) == set(j["workers"]) == {"m0/auto_a"}
    finally:
        rsrv.shutdown()
        rsrv.server_close()
        for st, srv in zip(states, servers):
            if st.durable is not None:
                st.durable.simulate_crash()
            st.shard.stop()
            srv.shutdown()
            srv.server_close()


# --- cli top and cli fleet ----------------------------------------------------------

class _Fixed(BaseHTTPRequestHandler):
    def do_GET(self):
        data = json.dumps(self.server.bodies[self.path]).encode()
        self.send_response(200)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(data)))
        self.end_headers()
        self.wfile.write(data)

    def log_message(self, *a):
        pass


TOP_BODY = {"participants": {
    "master": {"state": "self", "age_s": 0.0, "resources": {
        "device_bytes_in_use": 7.2e9, "device_peak_bytes": 1.1e10,
        "host_rss_bytes": 3.1e9, "utilization": 0.93, "queue_depth": 4,
        "source": "memory_stats"}},
    "auto_1_1": {"state": "healthy", "age_s": 1.25, "resources": {
        "device_bytes_in_use": 7.0e9, "device_peak_bytes": None,
        "host_rss_bytes": 2.9e9, "utilization": None, "queue_depth": 1,
        "source": "memory_stats"}},
    "w9": {"state": "dead", "age_s": None, "resources": None,
           "stale": True}}, "ttl_s": 10.0}

FLEET_ON = {
    "autoscale": {
        "enabled": True, "running": True, "window": 2, "cooldown_s": 3.0,
        "thresholds": {"up_queue_per_participant": 2.0,
                       "down_queue_per_participant": 0.5,
                       "up_utilization": 0.85, "down_utilization": 0.3},
        "bounds": {"min_workers": 0, "max_workers": 1},
        "scale_ups": 1, "scale_downs": 1, "flaps": 0,
        "retiring": ["auto_1_1"],
        "decisions": [
            {"action": "up", "reason": "queue/participant 8.00 > 2",
             "worker_id": "auto_1_1"},
            {"action": "down", "reason": "queue/participant 0.00 < 0.5 "
                                         "(drain via lease non-renewal)",
             "worker_id": "auto_1_1"}],
        "signal": {"queue_depth": 0, "queue_per_participant": 0.0,
                   "utilization": 0.12, "live_workers": 1}},
    "admission": {"classes": ["paid", "free", "batch"],
                  "default_class": "paid",
                  "weights": {"paid": 6.0, "free": 3.0, "batch": 1.0},
                  "shed_thresholds": {"paid": 1.0}, "drain_rate_per_s": 0.4,
                  "per_class": {"paid": {"admitted": 8, "completed": 8,
                                         "shed_overload": 0,
                                         "shed_rate": 0}},
                  "queued_by_class": {"paid": 0}},
    "workers": {},
    "chaos": {"active": True, "http_5xx_pct": 50.0,
              "injected": {"5xx": 2, "corrupt": 2}}}

FLEET_OFF = {"autoscale": {"enabled": False, "armed_env": True,
                           "signal": None},
             "admission": {}, "workers": {}, "chaos": {"active": False}}


@pytest.mark.parametrize("cmd,body", [
    ("top", TOP_BODY), ("top", {"participants": {}}),
    ("fleet", FLEET_ON), ("fleet", FLEET_OFF),
    ("fleet", {**FLEET_OFF, "autoscale": {"enabled": False,
                                          "armed_env": False}})])
@pytest.mark.parametrize("as_json", [False, True])
def test_cli_top_and_fleet_print_the_jax_packages_text(cmd, body, as_json):
    path = "/distributed/cluster/metrics" if cmd == "top" \
        else "/distributed/fleet"
    srv = ThreadingHTTPServer(("127.0.0.1", 0), _Fixed)
    srv.bodies = {path: body}
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    url = f"http://127.0.0.1:{srv.server_address[1]}"
    argv = [cmd, "--url", url] + (["--json"] if as_json else [])
    try:
        outs = []
        for main in (jcli.main, tcli.main):
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                assert main(argv) == 0
            outs.append(buf.getvalue())
    finally:
        srv.shutdown()
        srv.server_close()
    assert outs[1] == outs[0]
    assert outs[1].strip()


# --- a real worker spawned, given a share and retired -----------------------------------

def _txt2img(seed):
    doc = json.loads((ROOT / "workflows" / "distributed-txt2img.json")
                     .read_text())
    doc["5"]["inputs"].update(width=64, height=64)
    doc["3"]["inputs"]["steps"] = 2
    doc["13"]["inputs"]["seed"] = seed
    doc["9"]["class_type"] = "SaveImage"
    return doc


def _wait(pred, what, limit=SPAWN_S):
    deadline = time.time() + limit
    while not pred():
        assert time.time() < deadline, f"timed out waiting for {what}"
        time.sleep(0.1)


def _png_diff(path, ref):
    got = decode_png(path.read_bytes())[0]
    want = to_uint8(ref).astype(np.float32) / 255.0
    assert got.shape == want.shape
    return float(np.abs(got - want).max())


def test_a_master_spawns_a_real_worker_gives_it_a_share_and_retires_it(
        tmp_path, monkeypatch):
    """``DTPU_AUTOSCALE=1``: two prompts held in the queue scale up; the
    default spawner launches ``cli worker --device cpu`` through the
    process manager, which registers by heartbeat; a fan-out then gives
    it a share (its image equal to an in-process run at seed + 1); once
    the queue empties it is retired, forgotten and gone from the
    config, and no process of its tree is left."""
    monkeypatch.chdir(tmp_path)       # the worker's logs and directories
    monkeypatch.setenv("PYTHONPATH", str(ROOT))
    monkeypatch.setenv(treg.FAMILY_ENV, "tiny")
    monkeypatch.setenv(C.CACHE_ENV, "0")
    monkeypatch.setenv(C.COALESCE_ENV, "0")
    for name, value in ((C.AUTOSCALE_ENV, "1"),
                        (C.AUTOSCALE_INTERVAL_ENV, "0.2"),
                        (C.AUTOSCALE_WINDOW_ENV, "2"),
                        (C.AUTOSCALE_UP_QUEUE_ENV, "1.5"),
                        (C.AUTOSCALE_DOWN_QUEUE_ENV, "0.5"),
                        (C.AUTOSCALE_COOLDOWN_ENV, "0.5"),
                        (C.AUTOSCALE_MIN_ENV, "0"),
                        (C.AUTOSCALE_MAX_ENV, "1")):
        monkeypatch.setenv(name, value)
    reuse.get_reuse().clear()
    seed = 4242
    refs = [WorkflowExecutor(OpContext(device="cpu")).execute(
        _txt2img(seed + k)).image_batch[0] for k in range(2)]
    cfg_path = str(tmp_path / "cfg.json")
    st = ServerState(config_path=cfg_path, device="cpu",
                     input_dir=str(tmp_path / "min"),
                     output_dir=str(tmp_path / "mout"))
    st._exec_gate.clear()              # hold the queue
    srv, url = _serve(st)
    # the spawned worker heartbeats the config's master
    cfg_mod.mutate_config(lambda c: cfg_mod.update_master(
        c, host="127.0.0.1", port=st.port), cfg_path)
    st.manager.log_dir = str(tmp_path / "logs")
    st.health.interval = 0.2
    st.health.start()
    st.autoscaler = tauto.install(st)
    # the process-wide resource monitor may hold another test's reading
    st.autoscaler.util_fn = None
    try:
        plain = {"1": {"class_type": "EmptyLatentImage",
                       "inputs": {"width": 32, "height": 32,
                                  "batch_size": 1}}}
        for _ in range(2):
            net.post_json(url + "/prompt", {"prompt": plain})

        def spawned():
            return st.autoscaler.snapshot()["scale_ups"] == 1
        _wait(spawned, "the scale-up")
        (wid,) = st.autoscaler.snapshot()["spawned"]
        assert wid.startswith("auto_")
        cfg = cfg_mod.load_config(cfg_path)
        (entry,) = [w for w in cfg["workers"] if w["id"] == wid]
        assert entry["enabled"] and "--device cpu" in entry["extra_args"]
        managed = st.manager.get_managed_workers()[wid]
        tree_root = managed["pid"]

        def ready():
            return st.manager.get_managed_workers()[wid]["launching"] \
                is False and st.cluster.state(wid) == tcl.HEALTHY
        _wait(ready, "the spawned worker's first contact")
        tree = tproc._descendants(tree_root) + [tree_root]
        assert len(tree) >= 2          # the monitor and the worker
        m0 = net.get_json(url + "/distributed/metrics")
        out = tmp_path / "mout"
        resp = net.post_json(url + "/prompt", {"prompt": _txt2img(seed)})
        assert resp["workers"] == [wid], resp
        st._exec_gate.set()            # the master runs its queue
        pid = resp["prompt_id"]
        _wait(lambda: pid in net.get_json(url + "/history"), "the history")
        h = net.get_json(url + "/history")[pid]
        assert h["status"] == "success" and h["images"] == 2, h
        m1 = net.get_json(url + "/distributed/metrics")
        assert m1["images_received"] - m0["images_received"] == 1
        files = sorted(out.glob("*.png"))
        assert len(files) == 2
        for f, ref in zip(files, refs):
            assert _png_diff(f, ref) <= EXACT, f

        def retired():
            s = st.autoscaler.snapshot()
            return s["scale_downs"] == 1 and not s["retiring"] \
                and not s["spawned"]
        _wait(retired, "the retirement")
        snap = st.autoscaler.snapshot()
        assert [d["action"] for d in snap["decisions"]] == ["up", "down"]
        assert snap["flaps"] == 0
        assert wid not in st.cluster.snapshot()["workers"]   # forgotten
        assert wid not in [w["id"] for w in
                           cfg_mod.load_config(cfg_path).get("workers", [])]
        assert wid not in st.manager.get_managed_workers()
        assert not any(tproc.is_process_alive(p) for p in tree)
        fleet = net.get_json(url + "/distributed/fleet")
        assert fleet["autoscale"]["scale_ups"] == 1
        assert fleet["autoscale"]["scale_downs"] == 1
    finally:
        st.autoscaler.stop()
        st.health.stop()
        st.manager.cleanup_all()
        srv.shutdown()
        srv.server_close()
        treg.clear_pipeline_cache()
