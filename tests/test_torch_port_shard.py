"""Sharded masters of the port (``runtime/shard.py`` and its wiring in
``server/app.py``, ``runtime/jobs.py`` and ``runtime/cluster.py``), on
the CPU.

Mirrors ``tests/test_shard.py``'s ``TestHashRing``,
``TestShardManagerUnit``, the admission-rate split of
``TestFederatedSignals``, ``TestIdemScoping``, ``TestForwarding``,
``TestTakeover``, ``TestRouter`` and ``TestKillMasterMidUpscale``, with
the port's masters and workers on loopback sockets in this process.
The parity tests hold the port's ring against the JAX package's (owner
and successor of 10,000 keys over 3 members at the default vnodes) and
merge a gossip payload made by either package's ``ShardManager`` in the
other's.  The kill test's blend must equal the no-kill run's to the bit.

A killed master's process acts no more; here its state lives on in the
process, so ``Fleet.kill`` also stops its server, its threads and its
log, makes its registry's lease endless (its drain never acts on a
death) and backdates its master lease, so the test does not wait a lease
out."""

import contextlib
import io
import itertools
import json
import os
import threading
import time

import numpy as np
import pytest

from comfyui_distributed_tpu.runtime import shard as jshard
from comfyui_distributed_tpu_torch import cli
from comfyui_distributed_tpu_torch.models import registry as treg
from comfyui_distributed_tpu_torch.runtime import cluster as cl
from comfyui_distributed_tpu_torch.runtime import durable as dur
from comfyui_distributed_tpu_torch.runtime import shard as shard_mod
from comfyui_distributed_tpu_torch.runtime.jobs import JobStore
from comfyui_distributed_tpu_torch.server.app import (
    QueueFullError,
    ServerState,
    make_server,
)
from comfyui_distributed_tpu_torch.utils import constants as C
from comfyui_distributed_tpu_torch.utils import net
from comfyui_distributed_tpu_torch.utils.image import decode_png
from comfyui_distributed_tpu_torch.workflow import scheduler as sched
from tests.test_torch_port_failover import _upscale_prompt

LIMIT_S = 120


# --- the ring ----------------------------------------------------------------

class TestHashRing:
    def test_deterministic_placement(self):
        a = shard_mod.HashRing({"m0": "", "m1": "", "m2": ""}, vnodes=64)
        b = shard_mod.HashRing({"m2": "", "m0": "", "m1": ""}, vnodes=64)
        keys = [f"p_{i}" for i in range(500)]
        assert [a.owner(k) for k in keys] == [b.owner(k) for k in keys]
        assert {a.owner(k) for k in keys} == {"m0", "m1", "m2"}

    def test_leave_moves_only_the_leavers_keys(self):
        full = shard_mod.HashRing({"m0": "", "m1": "", "m2": ""},
                                  vnodes=128)
        rest = shard_mod.HashRing({"m0": "", "m1": ""}, vnodes=128)
        for k in (f"p_{i}" for i in range(2000)):
            if full.owner(k) != "m2":
                assert rest.owner(k) == full.owner(k)

    def test_join_moves_about_one_over_n(self):
        n3 = shard_mod.HashRing({"m0": "", "m1": "", "m2": ""},
                                vnodes=128)
        n4 = shard_mod.HashRing({"m0": "", "m1": "", "m2": "", "m3": ""},
                                vnodes=128)
        keys = [f"p_{i}" for i in range(4000)]
        moved = [k for k in keys if n3.owner(k) != n4.owner(k)]
        assert all(n4.owner(k) == "m3" for k in moved)
        assert len(keys) * 0.10 <= len(moved) <= len(keys) * 0.40

    def test_successor_deterministic_and_excludes_dead(self):
        r = shard_mod.HashRing({"m0": "", "m1": "", "m2": ""}, vnodes=64)
        s = r.successor("m1")
        assert s in ("m0", "m2") and s == r.successor("m1")
        assert shard_mod.HashRing({"m0": "", "m1": ""},
                                  vnodes=64).successor("m1") == "m0"
        assert shard_mod.HashRing({"m0": ""}, vnodes=4).successor(
            "m0") is None

    def test_parse_peers(self):
        assert shard_mod.parse_peers(
            "m0=http://a:1, m1=http://b:2/,,bad") == {
                "m0": "http://a:1", "m1": "http://b:2"}
        assert shard_mod.parse_peers("") == {}

    def test_shard_config(self, monkeypatch):
        monkeypatch.delenv(C.SHARD_ID_ENV, raising=False)
        assert shard_mod.shard_config() is None
        monkeypatch.setenv(C.SHARD_ID_ENV, "m1")
        monkeypatch.setenv(C.SHARD_PEERS_ENV, "m0=http://a:1")
        monkeypatch.setenv(C.SHARD_WAL_ROOT_ENV, "/w")
        assert shard_mod.shard_config() == jshard.shard_config() == {
            "id": "m1", "members": {"m0": "http://a:1", "m1": ""},
            "wal_root": "/w"}


def test_ring_placement_equals_the_jax_ring():
    members = {"m0": "", "m1": "", "m2": ""}
    port, ref = shard_mod.HashRing(members), jshard.HashRing(members)
    assert port.vnodes == ref.vnodes == C.SHARD_VNODES_DEFAULT
    rng = np.random.default_rng(0)
    keys = [f"p_{int(rng.integers(1 << 40))}_{i}" for i in range(10_000)]
    assert [port.owner(k) for k in keys] == [ref.owner(k) for k in keys]
    assert [port.successor(m) for m in members] \
        == [ref.successor(m) for m in members]
    assert port.successor("gone") == ref.successor("gone")


# --- one manager, no server ----------------------------------------------------

def _mgr(sid="m0", members=None, mod=shard_mod):
    return mod.ShardManager(None, sid, members or {"m0": "u0", "m1": "u1",
                                                   "m2": "u2"},
                            start_threads=False)


def _absorbed(mgr, dead, epoch=2):
    with mgr._lock:
        mgr._members.pop(dead)
        mgr._ring = type(mgr._ring)(mgr._members, None)
        mgr._ring_epoch = epoch
        mgr._absorbed[dead] = {"epoch": 2, "ring_epoch": epoch,
                               "resumed_prompts": 0, "recovered_jobs": 0,
                               "at": 0.0}


class TestShardManagerUnit:
    def test_local_pid_owned_by_self(self):
        mgr = _mgr("m1")
        ctr = itertools.count()
        assert all(mgr.owner_of(mgr.local_pid(ctr)) == "m1"
                   for _ in range(20))

    def test_merge_gossip_higher_epoch_wins(self):
        mgr = _mgr("m0")
        reply = mgr.merge_gossip({"from": "m1", "ring_epoch": 1,
                                  "members": {"m0": "u0", "m1": "u1",
                                              "m2": "u2"},
                                  "queue_remaining": 7})
        assert reply["from"] == "m0" and reply["ring_epoch"] == 1
        assert mgr.peer_queue_depth() == 7
        assert mgr.live_peer_masters() == 1
        mgr.merge_gossip({"from": "m1", "ring_epoch": 2,
                          "members": {"m0": "u0", "m1": "u1"},
                          "queue_remaining": 3})
        assert mgr.ring_epoch() == 2
        assert set(mgr.ring_snapshot()["members"]) == {"m0", "m1"}
        mgr.merge_gossip({"from": "m2", "ring_epoch": 1,
                          "members": {"m0": "u0", "m1": "u1", "m2": "u2"}})
        assert mgr.ring_epoch() == 2

    def test_merge_gossip_ring_without_self_means_deposed(self):
        mgr = _mgr("m0")
        mgr.merge_gossip({"from": "m1", "ring_epoch": 5,
                          "members": {"m1": "u1", "m2": "u2"}})
        assert mgr.ring_epoch() == 1
        assert "m0" in mgr.ring_snapshot()["members"]
        assert mgr.deposed and mgr.watch_once() == []
        assert mgr.snapshot()["deposed"] is True
        assert not mgr.is_autoscale_actuator()

    def test_equal_epoch_divergence_converges_by_intersection(self):
        a = _mgr("m0", {"m0": "u0", "m1": "u1", "m2": "u2", "m3": "u3"})
        with a._lock:
            a._members.pop("m1")
            a._ring = shard_mod.HashRing(a._members, None)
            a._ring_epoch = 2
        a.merge_gossip({"from": "m2", "ring_epoch": 2,
                        "members": {"m0": "u0", "m1": "u1", "m2": "u2"}})
        assert set(a.ring_snapshot()["members"]) == {"m0", "m2"}
        assert a.ring_epoch() == 2

    def test_higher_epoch_gossip_cannot_resurrect_absorbed_member(self):
        mgr = _mgr("m0")
        _absorbed(mgr, "m1")
        mgr.merge_gossip({"from": "m2", "ring_epoch": 3,
                          "members": {"m0": "u0", "m1": "u1", "m2": "u2"}})
        assert mgr.ring_epoch() == 3
        assert set(mgr.ring_snapshot()["members"]) == {"m0", "m2"}
        assert mgr.owned_shards() == ["m0", "m1"]

    def test_snapshot_shape(self):
        snap = _mgr("m2").snapshot()
        assert snap["enabled"] and snap["id"] == "m2"
        assert snap["owned"] == ["m2"]
        assert set(snap["members"]) == {"m0", "m1", "m2"}
        ring = _mgr("m2").ring_snapshot()
        assert ring["self"] == "m2" and ring["vnodes"] >= 1

    def test_admission_rate_splits_by_shard_count(self):
        kw = dict(rate={"paid": 10.0, "free": 0.0, "batch": 0.0},
                  burst={"paid": 1.0, "free": 1.0, "batch": 1.0})
        adm = sched.AdmissionController(**kw)
        adm.set_rate_scale(1.0 / 4)
        assert adm.admit("paid", "c1", 0, 100) is None
        assert next(iter(adm._buckets.values())).rate == pytest.approx(2.5)
        assert adm.snapshot()["rate_scale"] == pytest.approx(0.25)
        adm2 = sched.AdmissionController(**kw)
        assert adm2.admit("paid", "c1", 0, 100) is None
        assert next(iter(adm2._buckets.values())).rate == 10.0


def _gossip_scenarios():
    """(receiver id, receiver members, receiver setup, sender id, sender
    members, sender setup)."""
    three = {"m0": "u0", "m1": "u1", "m2": "u2"}
    four = {**three, "m3": "u3"}
    return [
        ("m0", three, None, "m1", three, None),
        ("m0", three, None, "m1", three, ("m2", 2)),
        ("m0", three, None, "m1", {"m1": "u1", "m2": "u2"},
         ("epoch", 5)),
        ("m0", four, ("m1", 2), "m2", four, ("m3", 2)),
        ("m0", three, ("m1", 2), "m2", three, ("epoch", 3)),
    ]


def _setup(mgr, how):
    if how is None:
        return
    if how[0] == "epoch":
        with mgr._lock:
            mgr._ring_epoch = how[1]
    else:
        _absorbed(mgr, how[0], how[1])


@pytest.mark.parametrize("case", range(len(_gossip_scenarios())))
@pytest.mark.parametrize("receiver", ["port", "jax"])
def test_gossip_payloads_cross_merge(case, receiver):
    rid, rmem, rhow, sid, smem, show = _gossip_scenarios()[case]
    mods = {"port": shard_mod, "jax": jshard}
    other = "jax" if receiver == "port" else "port"
    outs = []
    # the same merge, once with a same-package sender and once with the
    # other package's: the receiver ends in the same state
    for sender_pkg in (receiver, other):
        recv = _mgr(rid, dict(rmem), mods[receiver])
        _setup(recv, rhow)
        send = _mgr(sid, dict(smem), mods[sender_pkg])
        _setup(send, show)
        reply = recv.merge_gossip(send._gossip_payload())
        ring = recv.ring_snapshot()
        snap = recv.snapshot()
        outs.append((reply["ring_epoch"], sorted(reply["members"]),
                     ring["ring_epoch"], sorted(ring["members"]),
                     ring["owned"], snap["deposed"],
                     sorted(snap["members"])))
        # and the sender takes the reply back in its own package
        send.merge_gossip(reply)
        outs.append((send.ring_epoch(),
                     sorted(send.ring_snapshot()["members"]), send.deposed))
    assert outs[0] == outs[2] and outs[1] == outs[3]


# --- idempotency keys scoped by shard ---------------------------------------

class TestIdemScoping:
    @staticmethod
    def _put(store, job, key):
        return store.put_result(job, {"worker_id": "w", "tensor": None},
                                idem_key=key, require_existing=False)

    def test_absorbed_keys_dedupe_without_aliasing_ours(self):
        store = JobStore()
        store.set_scope("mA")
        store.merge_idem({"image": {"J": ["w:0:1"]}}, scope="mB")
        assert self._put(store, "J", "w:0:1")
        assert store.get_queue("J").qsize() == 0
        assert self._put(store, "J2", "w:0:1")
        assert store.get_queue("J2").qsize() == 1
        assert self._put(store, "J", "w:0:2")
        assert store.get_queue("J").qsize() == 1
        assert store.put_result("J", {"worker_id": "w", "tensor": None},
                                idem_key="w:0:2")
        assert store.get_queue("J").qsize() == 1

    def test_own_recovered_keys_reseed_under_own_scope(self):
        store = JobStore()
        store.set_scope("mA")
        store.attach_wal(None, {"image": {"J": ["k1"]},
                                "tile": {"T": ["t1"]}})
        assert self._put(store, "J", "k1")
        assert store.get_queue("J").qsize() == 0
        assert store.put_tile("T", {"worker_id": "w", "tile_idx": 0},
                              idem_key="t1", require_existing=False)
        assert store.get_tile_queue("T").qsize() == 0

    def test_unscoped_store_is_bit_compatible(self):
        store = JobStore()
        assert store._scoped("J", "k") == "k"
        store.merge_idem({"image": {"J": ["k"]}})
        assert store._seen["J"] == {"k"}


# --- masters on loopback sockets ---------------------------------------------

class Fleet:
    """N sharded masters on loopback ports with one log root; without
    execution threads unless asked (admission, forwarding and the logs
    need no model)."""

    def __init__(self, tmp_path, monkeypatch, n=2, exec_threads=False,
                 cfg_path=None):
        self.tmp = tmp_path
        ports = [net.find_free_port() for _ in range(n)]
        self.urls = [f"http://127.0.0.1:{p}" for p in ports]
        self.wal_root = str(tmp_path / "wal")
        monkeypatch.setenv(C.SHARD_PEERS_ENV, ",".join(
            f"m{i}={u}" for i, u in enumerate(self.urls)))
        monkeypatch.setenv(C.SHARD_WAL_ROOT_ENV, self.wal_root)
        self.states, self.servers = [], []
        for i in range(n):
            d = tmp_path / f"m{i}"
            with monkeypatch.context() as m:
                m.setenv(C.SHARD_ID_ENV, f"m{i}")
                st = ServerState(
                    config_path=cfg_path or str(d / "cfg.json"),
                    device="cpu", input_dir=str(d / "in"),
                    output_dir=str(d / "out"),
                    start_exec_thread=exec_threads)
            srv = make_server(st, "127.0.0.1", ports[i])
            threading.Thread(target=srv.serve_forever, daemon=True).start()
            self.states.append(st)
            self.servers.append(srv)
        self.dead = set()

    def pid_owned_by(self, shard_id, tag="k"):
        mgr = self.states[0].shard
        return next(f"{tag}{i}" for i in range(10_000)
                    if mgr.owner_of(f"{tag}{i}") == shard_id)

    def queued(self, i):
        with self.states[i]._cond:
            return [item["id"] for item in self.states[i]._queue]

    def kill(self, i):
        st = self.states[i]
        st.durable.simulate_crash()
        st.cluster.lease_s = float("inf")
        st.shard.stop()
        st.health.stop()
        self.servers[i].shutdown()
        self.servers[i].server_close()
        self.dead.add(i)
        lease = os.path.join(self.wal_root, f"m{i}", "master.lease")
        with open(lease) as f:
            rec = json.load(f)
        rec["expires_at"] = time.time() - 1.0
        with open(lease, "w") as f:
            json.dump(rec, f)

    def stop(self):
        for i, st in enumerate(self.states):
            if i in self.dead:
                continue
            if st.durable is not None and st.durable.wal is not None:
                st.durable.simulate_crash()
            st.shard.stop()
            st.health.stop()
            self.servers[i].shutdown()
            self.servers[i].server_close()


@pytest.fixture
def fleet(tmp_path, monkeypatch):
    made = []

    def make(n=2, **kw):
        fl = Fleet(tmp_path, monkeypatch, n, **kw)
        made.append(fl)
        return fl

    yield make
    for fl in made:
        fl.stop()


TINY = {"1": {"class_type": "EmptyLatentImage",
              "inputs": {"width": 32, "height": 32, "batch_size": 1}}}


def _post(url, body, headers=None):
    return net.request_json("POST", url + "/prompt", body, timeout=30,
                            headers=headers)


class TestForwarding:
    def test_misroute_forwarded_one_hop_lands_in_owner_wal(self, fleet):
        fl = fleet(2)
        pid = fl.pid_owned_by("m1")
        code, body, _ = _post(fl.urls[0], {"prompt": TINY, "client_id": "c",
                                           "prompt_id": pid})
        assert code == 200, body
        assert body["prompt_id"] == pid
        assert body["forwarded_from"] == "m0" and body["shard"] == "m1"
        assert fl.queued(1) == [pid] and fl.queued(0) == []
        # the admission is in the owner's log before the answer
        assert pid in dur.replay(os.path.join(fl.wal_root, "m1"))[0].prompts
        assert pid not in dur.replay(
            os.path.join(fl.wal_root, "m0"))[0].prompts
        assert fl.states[0].shard.forwards == 1
        # the owner's job span says where it came from
        span = fl.states[1]._queue[0]["span"]
        assert span.attrs["forwarded_from"] == "m0"
        assert span.attrs["shard"] == "m1" and span.attrs["ring_epoch"] == 1

    def test_forward_header_terminates_at_one_hop(self, fleet):
        fl = fleet(2)
        pid = fl.pid_owned_by("m1", tag="h")
        code, body, _ = _post(fl.urls[0], {"prompt": TINY, "client_id": "c",
                                           "prompt_id": pid},
                              headers={C.SHARD_FORWARD_HEADER: "m1"})
        assert code == 200, body
        assert "forwarded_from" not in body
        assert fl.queued(0) == [pid] and fl.states[0].shard.forwards == 0

    def test_forwarded_shed_keeps_retry_after_header(self, fleet):
        fl = fleet(2)
        pid = fl.pid_owned_by("m1", tag="s")
        fl.states[1].max_queue = 0
        code, body, hdrs = _post(fl.urls[0], {"prompt": TINY,
                                              "prompt_id": pid})
        assert code == 429, body
        assert int(hdrs["Retry-After"]) >= 1

    def test_unreachable_owner_is_taken_locally(self, fleet):
        fl = fleet(2)
        pid = fl.pid_owned_by("m1", tag="u")
        fl.servers[1].shutdown()
        fl.servers[1].server_close()
        fl.dead.add(1)
        code, body, _ = _post(fl.urls[0], {"prompt": TINY,
                                           "prompt_id": pid})
        assert code == 200 and body["prompt_id"] == pid
        assert fl.queued(0) == [pid]
        fl.states[1].durable.simulate_crash()
        fl.states[1].shard.stop()

    def test_direct_submission_generates_self_owned_pid(self, fleet):
        fl = fleet(2)
        for i in range(2):
            code, body, _ = _post(fl.urls[i], {"prompt": TINY})
            assert code == 200, body
            assert fl.states[i].shard.owner_of(body["prompt_id"]) == f"m{i}"
            assert fl.queued(i) == [body["prompt_id"]]

    def test_gossip_roundtrip_and_metrics_surfaces(self, fleet):
        fl = fleet(2)
        assert fl.states[0].shard.gossip_once() == 1
        assert fl.states[0].shard.live_peer_masters() == 1
        m = net.get_json(fl.urls[0] + "/distributed/metrics")
        assert m["shard"]["enabled"] and m["shard"]["id"] == "m0"
        assert m["shard"]["ring_epoch"] == 1
        assert m["admission"]["rate_scale"] == 0.5
        import urllib.request
        with urllib.request.urlopen(
                fl.urls[0] + "/distributed/metrics.prom") as r:
            prom = r.read().decode()
        assert 'dtpu_shard_owner{shard="m0"} 1' in prom
        assert "dtpu_ring_epoch 1" in prom
        ring = net.get_json(fl.urls[1] + "/distributed/ring")
        assert ring["self"] == "m1" and set(ring["members"]) == {"m0", "m1"}

    def test_each_shard_logs_under_its_own_dir(self, fleet):
        fl = fleet(2)
        for i, st in enumerate(fl.states):
            assert st.durable.dir == os.path.join(fl.wal_root, f"m{i}")
            assert st.durable.owner == f"m{i}" and st.durable.epoch == 1
            assert st.jobs._scope == f"m{i}"

    def test_unsharded_master_has_no_ring(self, tmp_path, monkeypatch):
        monkeypatch.delenv(C.SHARD_ID_ENV, raising=False)
        st = ServerState(config_path=str(tmp_path / "cfg.json"),
                         device="cpu", start_exec_thread=False)
        assert st.shard is None
        srv = make_server(st, "127.0.0.1", 0)
        threading.Thread(target=srv.serve_forever, daemon=True).start()
        try:
            url = f"http://127.0.0.1:{st.port}"
            assert net.get_json(url + "/distributed/ring") \
                == {"enabled": False}
            code, _, _ = net.request_json(
                "POST", url + "/distributed/ring/gossip", {})
            assert code == 409
        finally:
            srv.shutdown()
            srv.server_close()


class TestTakeover:
    def test_successor_absorbs_dead_shard(self, fleet):
        fl = fleet(3)
        succ = fl.states[0].shard._ring.successor("m1")
        pid = fl.pid_owned_by("m1", tag="t")
        assert _post(fl.urls[1], {"prompt": TINY,
                                  "prompt_id": pid})[0] == 200
        fl.kill(1)
        succ_i = int(succ[1:])
        non_succ = next(i for i in (0, 2) if i != succ_i)
        assert fl.states[non_succ].shard.watch_once() == []
        assert fl.states[non_succ].shard.ring_epoch() == 1
        assert fl.states[succ_i].shard.watch_once() == ["m1"]
        mgr = fl.states[succ_i].shard
        assert mgr.ring_epoch() == 2
        assert mgr.owned_shards() == [succ, "m1"]
        assert fl.queued(succ_i) == [pid]
        assert mgr.owner_of(pid) == succ
        import urllib.request
        with urllib.request.urlopen(
                fl.urls[succ_i] + "/distributed/metrics.prom") as r:
            prom = r.read().decode()
        assert 'dtpu_shard_owner{shard="m1"} 1' in prom
        assert "dtpu_shard_takeovers_total 1" in prom
        for sid in ("m0", "m1", "m2"):
            rep = dur.verify(os.path.join(fl.wal_root, sid))
            assert rep["ok"], (sid, rep)
        assert fl.states[succ_i].shard.watch_once() == []
        # the new ring reaches the non-successor by gossip
        assert mgr.gossip_once() == 1
        assert fl.states[non_succ].shard.ring_epoch() == 2

    def test_absorbed_prompt_relogged_in_survivor_wal(self, fleet):
        fl = fleet(2)
        pid = fl.pid_owned_by("m1", tag="w")
        assert _post(fl.urls[1], {"prompt": TINY,
                                  "prompt_id": pid})[0] == 200
        fl.kill(1)
        assert fl.states[0].shard.watch_once() == ["m1"]
        assert pid in dur.replay(os.path.join(fl.wal_root, "m0"))[0].prompts
        assert pid not in dur.replay(
            os.path.join(fl.wal_root, "m1"))[0].prompts
        fl.states[0].shard.renew_absorbed_leases()
        with pytest.raises(dur.LeaseHeldError):
            dur.MasterLease(os.path.join(fl.wal_root, "m1")).acquire(
                "m1", 2.0)
        assert fl.states[0].admission.rate_scale() == pytest.approx(1.0)

    def test_double_death_absorbed_by_the_survivor(self, fleet):
        fl = fleet(3)
        fl.kill(1)
        fl.kill(2)
        assert sorted(fl.states[0].shard.watch_once()) == ["m1", "m2"]
        mgr = fl.states[0].shard
        assert sorted(mgr.owned_shards()) == ["m0", "m1", "m2"]
        assert set(mgr.ring_snapshot()["members"]) == {"m0"}

    def test_lost_absorbed_lease_drops_ownership(self, fleet):
        fl = fleet(2)
        pid = fl.pid_owned_by("m1", tag="l")
        assert _post(fl.urls[1], {"prompt": TINY,
                                  "prompt_id": pid})[0] == 200
        fl.kill(1)
        mgr = fl.states[0].shard
        assert mgr.watch_once() == ["m1"]
        dur.MasterLease(os.path.join(fl.wal_root, "m1")).acquire(
            "m1", 30.0, force=True)
        mgr.renew_absorbed_leases()
        assert mgr.owned_shards() == ["m0"]
        assert mgr.snapshot()["pending_reenqueue"] == {}
        assert mgr.retry_absorbed_reenqueues() == 0

    def test_failed_reenqueue_retried_until_landed(self, fleet):
        fl = fleet(2)
        pid = fl.pid_owned_by("m1", tag="q")
        assert _post(fl.urls[1], {"prompt": TINY,
                                  "prompt_id": pid})[0] == 200
        fl.kill(1)
        surv = fl.states[0]

        def full(*a, **k):
            raise QueueFullError("queue full (test)")
        surv.enqueue_prompt = full
        try:
            assert surv.shard.watch_once() == ["m1"]
        finally:
            del surv.enqueue_prompt
        assert fl.queued(0) == []
        assert surv.shard.snapshot()["pending_reenqueue"] == {"m1": [pid]}
        assert pid in dur.replay(os.path.join(fl.wal_root, "m1"))[0].prompts
        assert surv.shard.retry_absorbed_reenqueues() == 1
        assert fl.queued(0) == [pid]
        assert surv.shard.snapshot()["pending_reenqueue"] == {}
        assert pid not in dur.replay(
            os.path.join(fl.wal_root, "m1"))[0].prompts
        assert dur.verify(os.path.join(fl.wal_root, "m1"))["ok"]
        assert surv.shard.retry_absorbed_reenqueues() == 0

    def test_drain_stops_the_watch(self, fleet):
        fl = fleet(2)
        fl.states[0].drain(timeout=0.1)
        assert fl.states[0].shard._stop.is_set()

    def test_prompt_cancelled_by_a_drain_runs_on_the_absorbing_peer(
            self, fleet):
        from comfyui_distributed_tpu_torch.runtime import interrupt
        fl = fleet(2, exec_threads=True)
        m1 = fl.states[1]
        release, runs = threading.Event(), []

        def execute(item):
            runs.append(item["id"])
            release.wait(30)

        m1._execute = execute
        first = fl.pid_owned_by("m1", tag="da")
        second = fl.pid_owned_by("m1", tag="db")
        for pid in (first, second):
            assert _post(fl.urls[1], {"prompt": TINY,
                                      "prompt_id": pid})[0] == 200
        deadline = time.monotonic() + 10
        while runs != [first]:
            assert time.monotonic() < deadline
            time.sleep(0.01)
        try:
            assert m1.drain(timeout=0.2) is False
            assert m1._history[second]["error"] \
                == "cancelled: server drain timeout"
        finally:
            release.set()
            interrupt.clear_interrupt()
        wal1 = os.path.join(fl.wal_root, "m1")
        assert second in dur.replay(wal1)[0].prompts
        fl.kill(1)
        m0 = fl.states[0]
        assert m0.shard.watch_once() == ["m1"]
        deadline = time.monotonic() + 20
        while second not in m0._history:
            assert time.monotonic() < deadline
            time.sleep(0.02)
        assert m0._history[second]["status"] == "success"
        assert second not in dur.replay(wal1)[0].prompts


class TestRouter:
    @staticmethod
    def _router(urls):
        srv = shard_mod.make_router_server(urls, "127.0.0.1", 0)
        threading.Thread(target=srv.serve_forever, daemon=True).start()
        return srv, f"http://127.0.0.1:{srv.server_address[1]}"

    def test_router_routes_by_hash_and_merges_views(self, fleet):
        fl = fleet(2)
        srv, rurl = self._router(fl.urls)
        try:
            ring = net.get_json(rurl + "/distributed/ring")
            assert ring["router"] is True
            assert set(ring["members"]) == {"m0", "m1"}
            pids = []
            for _ in range(12):
                code, body, _ = _post(rurl, {"prompt": TINY,
                                             "client_id": "c"})
                assert code == 200, body
                pids.append((body["prompt_id"], body["shard"]))
            mgr = fl.states[0].shard
            for pid, shard in pids:
                assert mgr.owner_of(pid) == shard
                assert pid in fl.queued(int(shard[1:]))
            assert len({s for _, s in pids}) == 2
            assert isinstance(net.get_json(rurl + "/history"), dict)
            parts = net.get_json(rurl + "/distributed/cluster/metrics")[
                "participants"]
            assert any(k.startswith("m0/") for k in parts)
            assert any(k.startswith("m1/") for k in parts)
            merged = net.get_json(rurl + "/distributed/cluster")
            assert merged["shards"] == ["m0", "m1"]
            admitted = sum(st.admission.snapshot()["per_class"]["paid"][
                "admitted"] for st in fl.states)
            assert admitted == 12 and srv.router.routed == 12
            # cli status at the router's URL renders the merged view
            out = io.StringIO()
            with contextlib.redirect_stdout(out):
                assert cli.main(["status", "--master", rurl]) == 0
            view = json.loads(out.getvalue())
            assert view["router"]["router"] is True
            assert view["shards"] == ["m0", "m1"]
        finally:
            srv.shutdown()
            srv.server_close()

    def test_router_relays_retry_after_on_shed(self, fleet):
        fl = fleet(2)
        for st in fl.states:
            st.max_queue = 0
        srv, rurl = self._router(fl.urls)
        try:
            code, body, hdrs = _post(rurl, {"prompt": TINY})
            assert code == 429, body
            assert int(hdrs["Retry-After"]) >= 1
        finally:
            srv.shutdown()
            srv.server_close()

    def test_router_without_masters_answers_503(self):
        srv, rurl = self._router(["http://127.0.0.1:9"])
        try:
            code, body, _ = _post(rurl, {"prompt": TINY})
            assert code == 503 and "no reachable master" in body["error"]
        finally:
            srv.shutdown()
            srv.server_close()


def test_worker_heartbeats_every_master(fleet, tmp_path, monkeypatch):
    """A worker with ``DTPU_MASTER_URLS`` holds one lease per master."""
    fl = fleet(2)
    monkeypatch.setenv(C.MASTER_URLS_ENV, ",".join(fl.urls))
    monkeypatch.setenv(C.WORKER_ID_ENV, "w9")
    hb = cl.maybe_start_heartbeat(port=1234)
    try:
        assert isinstance(hb, cl.MultiHeartbeatSender)
        assert hb.master_urls == sorted(fl.urls)
        assert hb.beat_once() == 2
        for st in fl.states:
            assert st.cluster.snapshot()["workers"]["w9"]["state"] \
                == cl.HEALTHY
        # a new master announcing itself adds a lease, keeps the others
        extra = fleet(1)
        assert hb.rehome(extra.urls[0])
        assert len(hb.master_urls) == 3
    finally:
        hb.stop()


# --- the kill drill -------------------------------------------------------------

def _wait_history(url, pid):
    deadline = time.monotonic() + LIMIT_S
    while time.monotonic() < deadline:
        hist = net.get_json(url + "/history")
        if pid in hist:
            return hist[pid]
        time.sleep(0.05)
    raise AssertionError(f"prompt {pid} never finished at {url}")


def _newest_png(d):
    pngs = sorted(d.glob("*.png"), key=os.path.getmtime)
    assert pngs, f"no PNG in {d}"
    return decode_png(pngs[-1].read_bytes())[0]


def test_kill_the_owning_master_mid_upscale_bit_identical(
        fleet, tmp_path, monkeypatch):
    """Three masters and two workers; the master that owns a 4-tile
    upscale (itself [0, 1], w0 [2], w1 [3]) dies once its log holds every
    tile but the stalled w1's.  Its ring successor absorbs the shard,
    blends the three stored tiles from the dead shard's store, has w0
    refine tile 3 alone, and the image equals the no-kill run's to the
    bit."""
    monkeypatch.setenv(treg.FAMILY_ENV, "tiny")
    monkeypatch.setenv(C.MASTER_LEASE_ENV, "2.0")
    monkeypatch.setenv(C.LEASE_ENV, "4.0")
    monkeypatch.setenv(C.FAULT_POLICY_ENV, "reassign")
    monkeypatch.setenv(C.HEDGE_ENV, "0")
    # the drill reruns one upscale: the reuse plane's tile tier would
    # settle the owner's tiles from the earlier run
    monkeypatch.setenv(C.CACHE_ENV, "0")
    # a re-homed worker writes its master into the environment
    monkeypatch.delenv(C.MASTER_URL_ENV, raising=False)
    monkeypatch.delenv(C.WORKER_ID_ENV, raising=False)
    net.reset_wire_cache()
    workers, wservers, cfg_workers = [], [], []
    for i in range(2):
        d = tmp_path / f"w{i}"
        st = ServerState(config_path=str(d / "cfg.json"), is_worker=True,
                         device="cpu", input_dir=str(d / "in"),
                         output_dir=str(d / "out"))
        srv = make_server(st, "127.0.0.1", 0)
        threading.Thread(target=srv.serve_forever, daemon=True).start()
        workers.append(st)
        wservers.append(srv)
        cfg_workers.append({"id": f"w{i}", "host": "127.0.0.1",
                            "port": st.port, "enabled": True})
    cfg = tmp_path / "cfg.json"
    cfg.write_text(json.dumps({"workers": cfg_workers,
                               "master": {"host": "127.0.0.1"},
                               "settings": {}}))
    try:
        fl = fleet(3, exec_threads=True, cfg_path=str(cfg))
        for st in fl.states:
            st.health.interval = 0.5
            st.health.poll_once()
            st.health.start()
        for i, w in enumerate(workers):
            w.heartbeat = cl.MultiHeartbeatSender(fl.urls, f"w{i}",
                                                  port=w.port)
            assert w.heartbeat.beat_once() == 3
            w.heartbeat.start()
        victim = 1
        succ = fl.states[0].shard._ring.successor("m1")
        succ_i = int(succ[1:])

        ref_pid = fl.pid_owned_by("m1", tag="ref")
        code, body, _ = _post(fl.urls[0], {"prompt": _upscale_prompt(31),
                                           "prompt_id": ref_pid})
        assert code == 200 and body["shard"] == "m1", body
        assert _wait_history(fl.urls[victim], ref_pid)["status"] \
            == "success"
        ref = _newest_png(tmp_path / "m1" / "out")

        workers[1].fault_inject = {"stall_s": LIMIT_S}
        pid = fl.pid_owned_by("m1", tag="kill")
        code, body, _ = _post(fl.urls[victim], {
            "prompt": _upscale_prompt(31), "prompt_id": pid})
        assert code == 200 and sorted(body["workers"]) == ["w0", "w1"]
        deadline = time.monotonic() + LIMIT_S
        wal1 = os.path.join(fl.wal_root, "m1")
        while True:
            held = {}
            for jid, j in dur.replay(wal1)[0].jobs.items():
                if j["kind"] == "tile":
                    held = {u for u, rec in j["units"].items()
                            if rec["done"] and rec["spilled"]}
            if len(held) >= 3:
                break
            assert time.monotonic() < deadline, "never 3 of 4 in the log"
            time.sleep(0.05)
        fl.kill(victim)

        hist = _wait_history(fl.urls[succ_i], pid)
        assert hist["status"] == "success", hist
        mgr = fl.states[succ_i].shard
        assert "m1" in mgr.owned_shards() and mgr.ring_epoch() >= 2
        snap = net.get_json(fl.urls[succ_i] + "/distributed/cluster")
        job = [j for j in snap["ledger"]["completed_jobs"]
               if j["kind"] == "tile"][-1]
        assert job["done_units"] == job["total_units"] == 4
        assert job["recovered"] is True and job["preloaded_units"] == 3
        assert job["reassigned_units"] >= 1
        assert np.array_equal(_newest_png(tmp_path / f"m{succ_i}" / "out"),
                              ref)
        for sid in ("m0", "m1", "m2"):
            rep = dur.verify(os.path.join(fl.wal_root, sid))
            assert rep["ok"], (sid, rep)
    finally:
        for st, srv in zip(workers, wservers):
            if st.heartbeat is not None:
                st.heartbeat.stop()
            srv.shutdown()
            srv.server_close()
        treg.clear_pipeline_cache()
