"""The resource view and the clock-skew estimate: the port's
``utils/resource.py`` and the registry's skew and resource feeds in
``runtime/cluster.py`` against the JAX package's.

- The min-filter skew estimator: the same ``sent_at`` offsets (a true
  offset plus a non-negative uplink delay, from a numpy seed) fed to
  both registries on one fake clock give equal estimates, snapshots
  and resets.
- ``update_resources``/``resource_snapshots`` equal on the same clock.
- ``resource_prom_families`` and ``render_prom_families`` equal on the
  same snapshots (the device part from a host-only sample), with and
  without ages, and a malformed value costs its row alone.
- The ring and the monitor: ``RingTimeseries`` statistics equal, the
  monitor's utilization estimate from the ``compute`` stage the same
  in both, ``fleet_sample`` while a monitor is starting.
- The heartbeat carries ``resources`` and, last, ``sent_at``."""

import json
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np
import pytest

from comfyui_distributed_tpu.runtime import cluster as jcl
from comfyui_distributed_tpu.utils import resource as jres
from comfyui_distributed_tpu.utils import trace as jtr
from comfyui_distributed_tpu_torch.runtime import cluster as tcl
from comfyui_distributed_tpu_torch.utils import constants as TC
from comfyui_distributed_tpu_torch.utils import resource as tres
from comfyui_distributed_tpu_torch.utils import trace as ttr


class FakeClock:
    def __init__(self):
        self.t = 1000.0

    def monotonic(self):
        return self.t

    def time(self):
        return 1.7e9 + self.t


def _registries():
    """Both packages' registries, each on its own copy of a fake clock
    stepped together."""
    jc, tc = FakeClock(), FakeClock()
    return (jcl.ClusterRegistry(lease_s=5.0, clock=jc), jc,
            tcl.ClusterRegistry(lease_s=5.0, clock=tc), tc)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_skew_min_filter_matches(seed):
    rng = np.random.default_rng(seed)
    jr, jc, tr, tc = _registries()
    for reg in (jr, tr):
        reg.register("w0", alive=True)
        reg.register("w1", alive=True)
    true = {"w0": float(rng.normal(0, 0.5)), "w1": float(rng.normal(0, 2))}
    for _ in range(40):
        wid = ["w0", "w1"][int(rng.integers(2))]
        sample = true[wid] + float(rng.exponential(0.02))
        for reg in (jr, tr):
            reg.update_skew(wid, sample)
        # a phantom id and a bad value change nothing
        for reg in (jr, tr):
            reg.update_skew("ghost", 1.0)
            reg.update_skew(wid, "nope")
        step = float(rng.uniform(0, 0.5))
        jc.t += step
        tc.t += step
        assert tr.skew(wid) == jr.skew(wid)
        assert tr.skew_snapshot() == jr.skew_snapshot()
    # the estimate is the window's least-delayed sample: at or above the
    # true offset, close to it
    for wid, off in true.items():
        assert off <= tr.skew(wid) < off + 0.05
    assert max(v["samples"] for v in tr.skew_snapshot().values()) \
        == TC.SKEW_SAMPLES_KEPT
    assert tr.skew("ghost") == jr.skew("ghost") == 0.0
    assert tr.reset_skew() == jr.reset_skew() == 2
    assert tr.skew_snapshot() == jr.skew_snapshot() == {}


def test_resource_snapshots_match():
    jr, jc, tr, tc = _registries()
    for reg in (jr, tr):
        reg.register("w0", info={"host": "127.0.0.1", "port": 9},
                     alive=True)
        reg.register("w1", info={"host": "10.0.0.2", "port": 8},
                     alive=False)
        reg.update_resources("w0", {"device_bytes_in_use": 5,
                                    "t": 1.0})
        reg.update_resources("ghost", {"x": 1})
        reg.update_resources("w1", "not a dict")
    for clock in (jc, tc):
        clock.t += 2.5
    assert tr.resource_snapshots() == jr.resource_snapshots()
    assert tr.resource_snapshots()["w0"]["age_s"] == 2.5
    for clock in (jc, tc):
        clock.t += 10.0     # w0's lease runs out
    assert tr.resource_snapshots() == jr.resource_snapshots()
    assert tr.resource_snapshots()["w0"]["state"] == tcl.DEAD


def _snap(rng, source="host_rss"):
    return {"t": 1.7e9, "device_bytes_in_use": int(rng.integers(1, 1e10)),
            "device_peak_bytes": int(rng.integers(1, 1e10)),
            "device_bytes_limit": None,
            "host_rss_bytes": int(rng.integers(1, 1e9)),
            "utilization": float(rng.uniform()),
            "queue_depth": int(rng.integers(0, 5)), "cache_bytes": 0,
            "source": source}


@pytest.mark.parametrize("seed", [3, 4])
def test_resource_prom_families_match(seed):
    rng = np.random.default_rng(seed)
    host = tres._host_only_snapshot()
    assert host["source"] == "host_rss" and host["utilization"] is None
    snaps = {"master": host, "w0": _snap(rng), "w1": None,
             "w2": {**_snap(rng), "host_rss_bytes": "n/a",
                    "utilization": None}}
    ages = {"master": 0.0, "w0": float(rng.uniform(0, 9)), "w1": None,
            "w2": 3.14159}
    for a in (None, ages):
        t = tres.resource_prom_families(snaps, ages=a)
        j = jres.resource_prom_families(snaps, ages=a)
        assert t == j
        assert ttr.render_prom_families(t) == jtr.render_prom_families(j)
    # the unlabelled per-process form
    assert tres.resource_prom_families({"": host}) \
        == jres.resource_prom_families({"": host})
    assert all(not labels for _, _, _, samples in
               tres.resource_prom_families({"": host})
               for labels, _ in samples)


@pytest.mark.parametrize("seed", [5])
def test_ring_timeseries_matches(seed):
    rng = np.random.default_rng(seed)
    t, j = tres.RingTimeseries("x", 7), jres.RingTimeseries("x", 7)
    assert t.stats() == j.stats()
    for k in range(20):
        v = float(rng.normal())
        t.append(k, v)
        j.append(k, v)
        assert t.stats() == j.stats() and t.last() == j.last()
    assert t.values() == j.values() and len(t) == len(j) == 7
    assert t.total_samples == j.total_samples == 20


def test_monitor_utilization_matches_the_jax_definition(monkeypatch):
    """The compute stage's seconds over the sample interval, in both."""
    for mod in (jtr, ttr):
        monkeypatch.setattr(mod, "GLOBAL_STAGES", mod.PhaseStats())
    tm = tres.ResourceMonitor(interval=1.0, ring=8, device="cpu",
                              queue_depth_fn=lambda: 2)
    jm = jres.ResourceMonitor(interval=1.0, ring=8,
                              queue_depth_fn=lambda: 2)
    now = [100.0]
    for mod in (tres, jres):
        monkeypatch.setattr(mod.time, "monotonic", lambda: now[0])
    assert tm.sample_once()["utilization"] is None
    assert jm.sample_once()["utilization"] is None
    for dt, busy in ((2.0, 0.5), (4.0, 3.0), (1.0, 5.0)):
        now[0] += dt
        ttr.GLOBAL_STAGES.record("compute", busy)
        jtr.GLOBAL_STAGES.record("compute", busy)
        a, b = tm.sample_once(), jm.sample_once()
        assert a["utilization"] == b["utilization"] \
            == min(busy / dt, 1.0)
        assert a["queue_depth"] == b["queue_depth"] == 2
    snap = tm.snapshot()
    assert snap["n_samples"] == 4 and snap["series"]["utilization"]["n"] == 3
    assert set(snap) == set(jm.snapshot())
    assert tm.latest()["source"] == "host_rss"


def test_device_memory_snapshot_on_the_cpu():
    snap = tres.device_memory_snapshot("cpu")
    assert snap["source"] == "host_rss" and snap["n_devices"] == 0
    assert snap["bytes_in_use"] > 0 \
        and snap["peak_bytes_in_use"] >= snap["bytes_in_use"]
    assert set(snap) == set(jres.device_memory_snapshot())


def test_fleet_sample_while_the_monitor_starts(monkeypatch):
    mon = tres.ResourceMonitor(interval=60.0, device="cpu")
    monkeypatch.setattr(tres, "_MONITOR", mon)
    # no thread and no sample yet: one is taken now
    assert tres.fleet_sample("cpu")["source"] == "host_rss"
    assert mon.n_samples == 1
    mon2 = tres.ResourceMonitor(interval=60.0, device="cpu")
    monkeypatch.setattr(tres, "_MONITOR", mon2)
    monkeypatch.setattr(type(mon2), "running", property(lambda s: True))
    # a thread that has not sampled yet: the host-only sample
    snap = tres.fleet_sample("cpu")
    assert snap["utilization"] is None and mon2.n_samples == 0


def test_install_monitor_honours_the_switch(monkeypatch):
    monkeypatch.setenv(TC.RESOURCE_ENV, "0")
    assert tres.install_monitor(device="cpu") is None


class _Master(BaseHTTPRequestHandler):
    bodies = []

    def do_POST(self):
        n = int(self.headers["Content-Length"])
        type(self).bodies.append(json.loads(self.rfile.read(n)))
        self.send_response(200)
        self.send_header("Content-Length", "2")
        self.end_headers()
        self.wfile.write(b"{}")

    def log_message(self, *a):
        pass


def test_the_heartbeat_carries_resources_and_its_clock(monkeypatch):
    monkeypatch.delenv(TC.RESOURCE_ENV, raising=False)
    srv = ThreadingHTTPServer(("127.0.0.1", 0), _Master)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    try:
        hb = tcl.HeartbeatSender(f"http://127.0.0.1:{srv.server_port}",
                                 "w0", port=7)
        t0 = time.time()
        assert hb.beat_once()
        body = _Master.bodies[-1]
        assert list(body) == ["worker_id", "port", "resources", "sent_at"]
        assert t0 <= body["sent_at"] <= time.time()
        assert set(body["resources"]) == set(tres._host_only_snapshot())
        monkeypatch.setenv(TC.RESOURCE_ENV, "0")
        assert hb.beat_once()
        assert "resources" not in _Master.bodies[-1]
    finally:
        srv.shutdown()
        srv.server_close()
