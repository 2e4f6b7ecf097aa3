"""The port's write-ahead log (``comfyui_distributed_tpu_torch/runtime/
durable.py``) on the CPU, and its parity with the JAX package's.

The JAX package's own tests of its log (``tests/test_durable.py``:
the record layer, every crash point, the lease and its fencing, the
unit store and the ledger's recovery, the idempotency keys across a
restart) run here on the port's module, each in well under a second.
Parity: the same appends through both packages' logs give the same
records but for their ``ts``; each package's ``replay`` of the other's
directory gives the same ``ReplayState.to_json()`` and ``verify`` the
same report (the lease's seconds left aside); a unit file written by
either reads back equal in the other, numpy against torch; and a ledger
of either package recovers the other's crashed job.
"""

import os
import time

import numpy as np
import pytest
import torch

from comfyui_distributed_tpu.runtime import cluster as jax_cl
from comfyui_distributed_tpu.runtime import durable as jax_dur
from comfyui_distributed_tpu_torch.runtime import cluster as cl
from comfyui_distributed_tpu_torch.runtime import durable as dur
from comfyui_distributed_tpu_torch.runtime.jobs import JobStore
from comfyui_distributed_tpu_torch.utils import constants as C
from comfyui_distributed_tpu_torch.utils import trace as ttrace


@pytest.fixture
def wal_dir(tmp_path):
    return str(tmp_path / "wal")


def mk_wal(wal_dir, owner="master", lease_s=60.0, mod=dur, **kw):
    lease = mod.MasterLease(wal_dir)
    epoch = lease.acquire(owner, lease_s)
    return mod.WriteAheadLog(wal_dir, epoch=epoch, lease=lease, **kw), lease


# every record type, as the master appends them
APPENDS = [
    ("enqueue", dict(pid="p1", prompt={"1": {"class_type": "X"}},
                     client_id="c", extra={"k": 1})),
    ("job_create", dict(job="j1", kind="tile",
                        owners={"0": "master", "1": "w0", "2": "w1"})),
    ("unit_checkin", dict(job="j1", unit="0", by="master", spilled=True)),
    ("unit_reassign", dict(job="j1", units=["2"], to="master")),
    ("unit_hedge", dict(job="j1", units=["1"], by="master")),
    ("idem", dict(scope="tile", job="j1", key="w0:1:0")),
    ("enqueue", dict(pid="p2", prompt={}, client_id="c")),
    ("exec_done", dict(pid="p2", status="ok")),
    ("job_create", dict(job="j2", kind="image", owners={"w0": "w0"})),
    ("idem", dict(scope="image", job="j2", key="worker_0:0:0")),
    ("job_finish", dict(job="j2")),
]


# --- the record and segment layer ----------------------------------------------

class TestWalCore:
    def test_roundtrip_all_record_types(self, wal_dir):
        wal, _ = mk_wal(wal_dir)
        for rtype, fields in APPENDS[:8]:
            wal.append(rtype, **fields)
        wal.close()
        st, info = dur.replay(wal_dir)
        assert list(st.prompts) == ["p1"]
        assert st.prompts["p1"]["prompt"] == {"1": {"class_type": "X"}}
        units = st.jobs["j1"]["units"]
        assert units["0"]["done"] and units["0"]["spilled"]
        assert not units["1"]["done"]
        assert units["2"]["owner"] == "master"   # the reassignment
        assert st.idem["tile"]["j1"] == ["w0:1:0"]
        assert info["records_replayed"] == 8 and not info["torn"]

    def test_job_finish_drops_job_and_idem(self, wal_dir):
        wal, _ = mk_wal(wal_dir)
        wal.append("job_create", job="j1", kind="image", owners={"w0": "w0"})
        wal.append("idem", scope="image", job="j1", key="k")
        wal.append("job_finish", job="j1")
        wal.close()
        st, _ = dur.replay(wal_dir)
        assert st.jobs == {} and st.idem["image"] == {}

    def test_torn_tail_tolerated_and_prior_records_survive(self, wal_dir):
        wal, lease = mk_wal(wal_dir)
        wal.append("enqueue", pid="p1", prompt={}, client_id="c")
        wal.close()
        wal2 = dur.WriteAheadLog(wal_dir, epoch=1, lease=lease)
        wal2.inject_crash("torn")
        with pytest.raises(dur.WalCrashedError):
            wal2.append("exec_done", pid="p1", status="ok")
        st, info = dur.replay(wal_dir)
        assert "p1" in st.prompts            # the torn record never applied
        assert info["torn"]
        report = dur.verify(wal_dir)
        assert report["ok"]                  # a torn tail is no corruption
        assert any(s["checksum"] == "torn-tail" for s in report["segments"])

    def test_midfile_corruption_flagged(self, wal_dir):
        wal, _ = mk_wal(wal_dir)
        for i in range(6):
            wal.append("idem", scope="tile", job="j", key=f"k{i}")
        wal.close()
        seg = dur.list_segments(wal_dir)[0][2]
        with open(seg, "rb") as f:
            data = f.read()
        with open(seg, "wb") as f:
            f.write(data[:20] + b"XX" + data[22:])
        report = dur.verify(wal_dir)
        assert not report["ok"]
        assert any("CORRUPT" in s["checksum"] for s in report["segments"])

    def test_rotation_snapshot_truncation_equivalence(self, wal_dir):
        wal, _ = mk_wal(wal_dir, segment_bytes=300)
        wal.append("job_create", job="j1", kind="tile",
                   owners={str(i): "master" for i in range(4)})
        for i in range(4):
            wal.append("unit_checkin", job="j1", unit=str(i), by="master",
                       spilled=False)
        for i in range(20):
            wal.append("idem", scope="tile", job="j1", key=f"k{i}")
        wal.close()
        segs = dur.list_segments(wal_dir)
        snaps = dur.list_snapshots(wal_dir)
        assert snaps, "rotation never snapshotted"
        assert all((e, s) >= (snaps[-1][0], snaps[-1][1])
                   for e, s, _ in segs)
        st, _ = dur.replay(wal_dir)
        assert all(u["done"] for u in st.jobs["j1"]["units"].values())
        assert len(st.idem["tile"]["j1"]) == 20

    def test_sync_policies(self, wal_dir, monkeypatch):
        wal, _ = mk_wal(wal_dir, sync="off")
        wal.append("enqueue", pid="p", prompt={}, client_id="c")
        assert wal.stats()["unsynced_records"] == 1
        wal.sync()
        assert wal.stats()["unsynced_records"] == 0
        wal.close()
        wal2 = dur.WriteAheadLog(wal_dir, epoch=2, sync="always")
        wal2.append("enqueue", pid="p2", prompt={}, client_id="c")
        assert wal2.stats()["unsynced_records"] == 0
        wal2.close()
        # the environment's policies, as the JAX package reads them
        for raw, want in (("off", "off"), ("always", "always"),
                          ("0.5", 0.5), ("nonsense", "always")):
            monkeypatch.setenv(C.WAL_SYNC_ENV, raw)
            assert dur._sync_policy() == jax_dur._sync_policy() == want


class TestCrashPointMatrix:
    """A crash between append, fsync and answer at every transition:
    recovery converges with no unit lost and none doubled.  ``post_sync``:
    the record is durable and its answer lost; ``pre_append`` and
    ``torn``: the record is not durable (its caller never got an
    answer, so the work is done again)."""

    TRANSITIONS = [
        ("enqueue", dict(pid="px", prompt={"1": {}}, client_id="c")),
        ("job_create", dict(job="jx", kind="tile", owners={"0": "master"})),
        ("unit_checkin", dict(job="j1", unit="1", by="w0", spilled=False)),
        ("unit_reassign", dict(job="j1", units=["1"], to="master")),
        ("idem", dict(scope="tile", job="j1", key="kx")),
        ("exec_done", dict(pid="p0", status="ok")),
        ("job_finish", dict(job="j1")),
    ]

    def _base(self, wal):
        wal.append("enqueue", pid="p0", prompt={"1": {}}, client_id="c")
        wal.append("job_create", job="j1", kind="tile",
                   owners={"0": "master", "1": "w0"})
        wal.append("unit_checkin", job="j1", unit="0", by="master",
                   spilled=False)

    @pytest.mark.parametrize("point", ["pre_append", "torn", "post_sync"])
    def test_crash_at_every_transition(self, tmp_path, point):
        for k, (rtype, fields) in enumerate(self.TRANSITIONS):
            wal_dir = str(tmp_path / f"{point}_{k}")
            wal, _ = mk_wal(wal_dir)
            self._base(wal)
            wal.inject_crash(point, rtype)
            with pytest.raises(dur.WalCrashedError):
                wal.append(rtype, **fields)
            # every later append is refused, as by a dead process
            with pytest.raises(dur.WalCrashedError):
                wal.append("idem", scope="tile", job="j1", key="late")
            st, _ = dur.replay(wal_dir)
            if not (rtype == "exec_done" and point == "post_sync"):
                assert "p0" in st.prompts, (rtype, point)
            if rtype != "job_finish" or point != "post_sync":
                assert "j1" in st.jobs, (rtype, point)
                assert st.jobs["j1"]["units"]["0"]["done"]
            durable = point == "post_sync"
            if rtype == "unit_checkin":
                assert st.jobs["j1"]["units"]["1"]["done"] == durable
            if rtype == "enqueue":
                assert ("px" in st.prompts) == durable
            if rtype == "idem":
                assert ("kx" in st.idem["tile"].get("j1", [])) == durable
            if rtype == "job_finish":
                assert ("j1" not in st.jobs) == durable
            # replaying twice converges
            st2, _ = dur.replay(wal_dir)
            assert st2.to_json() == st.to_json(), (rtype, point)
            # and the JAX package replays the port's crashed log alike
            assert jax_dur.replay(wal_dir)[0].to_json() == st.to_json()

    def test_lost_ack_checkin_is_exactly_once_after_recovery(self, wal_dir):
        """post_sync at a check-in: the unit is done on disk; its caller,
        never answered, retries after recovery and the recovered ledger
        drops the redo."""
        wal, lease = mk_wal(wal_dir)
        wal.append("job_create", job="j1", kind="tile",
                   owners={"0": "master", "1": "w0"})
        wal.inject_crash("post_sync", "unit_checkin")
        with pytest.raises(dur.WalCrashedError):
            wal.append("unit_checkin", job="j1", unit="1", by="w0",
                       spilled=False)
        st, _ = dur.replay(wal_dir)
        led = cl.WorkLedger()
        wal2 = dur.WriteAheadLog(wal_dir, epoch=2, lease=lease, tracker=st)
        led.attach_wal(wal2, dur.UnitStore(wal_dir), dict(st.jobs))
        led.create_job("j1", {"0": "master", "1": "w0"}, kind="tile")
        # no payload was spilled: pending again, recomputed once
        assert sorted(led.pending("j1")) == ["0", "1"]
        assert led.check_in("j1", "1", "w0") is True
        assert led.check_in("j1", "1", "w0") is False   # the retried answer
        wal2.close()


# --- the lease and fencing ---------------------------------------------------------

class TestMasterLease:
    def test_acquire_renew_expire_epochs(self, wal_dir):
        lease = dur.MasterLease(wal_dir)
        e1 = lease.acquire("m", 0.3)
        assert e1 == 1 and lease.snapshot()["held"]
        assert lease.renew("m", e1, 0.3)
        with pytest.raises(dur.LeaseHeldError):
            lease.acquire("standby", 0.3)
        time.sleep(0.4)
        assert not lease.snapshot()["held"]
        e2 = lease.acquire("standby", 60.0)    # expired: allowed
        assert e2 == 2
        assert not lease.renew("m", e1, 0.3)   # the old holder lost it

    def test_same_owner_reclaims_live_lease(self, wal_dir):
        lease = dur.MasterLease(wal_dir)
        e1 = lease.acquire("m", 60.0)
        assert lease.acquire("m", 60.0) == e1 + 1   # a restart in place

    def test_stale_epoch_append_fenced(self, wal_dir, monkeypatch):
        monkeypatch.setattr(C, "WAL_FENCE_CHECK_S", 0.0)
        wal, lease = mk_wal(wal_dir, owner="m")
        wal.append("enqueue", pid="p", prompt={}, client_id="c")
        fenced0 = ttrace.GLOBAL_COUNTERS.get("wal_fenced")
        lease.acquire("standby", 60.0, force=True)   # the fencing event
        with pytest.raises(dur.FencedError):
            wal.append("enqueue", pid="p2", prompt={}, client_id="c")
        assert wal.fenced and ttrace.GLOBAL_COUNTERS.get("wal_fenced") == fenced0 + 1
        st, _ = dur.replay(wal_dir)
        assert "p2" not in st.prompts

    def test_each_package_honours_the_others_lease(self, wal_dir):
        lease = dur.MasterLease(wal_dir)
        assert lease.acquire("m", 60.0) == 1
        with pytest.raises(jax_dur.LeaseHeldError):
            jax_dur.MasterLease(wal_dir).acquire("standby", 60.0)
        assert jax_dur.MasterLease(wal_dir).acquire("m", 60.0) == 2
        with pytest.raises(dur.LeaseHeldError):
            lease.acquire("standby", 60.0)


# --- the unit store and the ledger's recovery --------------------------------------

class TestUnitStoreAndLedgerRecovery:
    def test_unit_store_roundtrip(self, wal_dir):
        us = dur.UnitStore(wal_dir)
        t = np.random.default_rng(0).random((5, 4, 3)).astype(np.float32)
        us.put("job/1", 3, [t], {"form": "window"})
        assert us.has("job/1", 3) and not us.has("job/1", 4)
        tensors, meta = us.get("job/1", 3)
        np.testing.assert_array_equal(tensors[0], t)
        assert meta == {"form": "window"}
        us.drop_job("job/1")
        assert not us.has("job/1", 3)

    def test_prune_drops_stranded_jobs_and_temporary_files(self, wal_dir):
        us = dur.UnitStore(wal_dir)
        for job in ("keep", "gone"):
            us.put(job, 0, [np.zeros((1,), np.float32)], {})
        tmp = us.path("keep", 1) + ".tmp.123"
        with open(tmp, "wb") as f:
            f.write(b"half")
        assert us.prune(["keep"]) == 1
        assert sorted(us.jobs()) == ["keep"] and not os.path.exists(tmp)

    def _recovered_ledger(self, wal_dir, spill_units=(0,)):
        """A ledger that lived, checked units in and crashed, and a
        second ledger recovered from its log."""
        wal, lease = mk_wal(wal_dir)
        us = dur.UnitStore(wal_dir)
        led = cl.WorkLedger()
        led.attach_wal(wal, us, {})
        led.create_job("j", {0: "master", 1: "w0", 2: "w1"}, kind="tile")
        spent = {}
        for u in spill_units:
            assert led.check_in(
                "j", u, "master",
                payload=([np.full((2, 2, 3), float(u), np.float32)],
                         {"form": "window"}), spent=spent)
        assert set(spent) == {"wal_spill", "wal_append"}
        wal.simulate_crash()
        st, _ = dur.replay(wal_dir)
        led2 = cl.WorkLedger()
        wal2 = dur.WriteAheadLog(wal_dir, epoch=2, lease=lease, tracker=st)
        led2.attach_wal(wal2, us, dict(st.jobs))
        led2.create_job("j", {0: "master", 1: "w0", 2: "w1"}, kind="tile")
        return led2

    def test_preloaded_done_units_not_pending(self, wal_dir):
        led2 = self._recovered_ledger(wal_dir, spill_units=(0, 1))
        assert led2.pending("j") == [2]
        payloads = led2.load_payloads("j")
        assert set(payloads) == {0, 1}
        tensors, meta = payloads[1]
        assert meta["form"] == "window" and tensors[0][0, 0, 0] == 1.0
        summary = led2.finish_job("j")
        assert summary["recovered"] and summary["preloaded_units"] == 2
        # the finish record is durable: the payloads are gone
        assert not dur.UnitStore(wal_dir).has("j", 0)

    def test_missing_payload_downgrades_to_pending(self, wal_dir):
        led2 = self._recovered_ledger(wal_dir, spill_units=(0, 1))
        us = dur.UnitStore(wal_dir)
        os.remove(us.path("j", 1))
        payloads = led2.load_payloads("j")
        assert set(payloads) == {0}
        assert sorted(led2.pending("j")) == [1, 2]

    def test_take_recovered_lost_groups_nonmaster_owners_once(self, wal_dir):
        led2 = self._recovered_ledger(wal_dir, spill_units=(0,))
        assert led2.take_recovered_lost("j") == {"w0": [1], "w1": [2]}
        assert led2.take_recovered_lost("j") == {}   # taken
        led2.create_job("j2", {0: "w0"}, kind="tile")
        assert led2.take_recovered_lost("j2") == {}  # not recovered

    def test_a_lazy_payload_is_made_only_for_a_winner_with_a_log(self,
                                                                 wal_dir):
        calls = []

        def payload():
            calls.append(1)
            return [np.zeros((1,), np.float32)], {"form": "window"}

        led = cl.WorkLedger()
        led.create_job("j", {0: "master"})
        assert led.check_in("j", 0, "master", payload=payload)
        assert calls == []                 # no log: nothing spilled
        wal, _ = mk_wal(wal_dir)
        led.attach_wal(wal, dur.UnitStore(wal_dir), {})
        led.create_job("k", {0: "master"})
        assert led.check_in("k", 0, "master", payload=payload)
        assert not led.check_in("k", 0, "w0", payload=payload)
        assert calls == [1] and dur.UnitStore(wal_dir).has("k", 0)
        wal.close()


# --- the idempotency keys across a restart -----------------------------------------

class TestIdemPersistence:
    def test_keys_survive_restart_and_replays_dropped(self, wal_dir):
        wal, lease = mk_wal(wal_dir)
        js = JobStore()
        js.attach_wal(wal)
        js.prepare_tile_job("j")
        item = {"worker_id": "w0", "tile_idx": 1, "tensor": 0}
        assert js.put_tile("j", item, idem_key="w0:1:0")
        wal.simulate_crash()        # the master dies after the answer
        st, _ = dur.replay(wal_dir)
        js2 = JobStore()
        wal2 = dur.WriteAheadLog(wal_dir, epoch=2, lease=lease, tracker=st)
        js2.attach_wal(wal2, st.idem)
        js2.prepare_tile_job("j")
        # the answered upload sent again to the new master: answered,
        # never queued
        assert js2.put_tile("j", item, idem_key="w0:1:0")
        q = js2.get_tile_queue("j")
        assert q.qsize() == 0
        assert js2.put_tile("j", item, idem_key="w0:1:1")   # a fresh key
        assert q.qsize() == 1
        wal2.close()

    def test_a_crashed_log_refuses_the_upload(self, wal_dir):
        wal, _ = mk_wal(wal_dir)
        js = JobStore()
        js.attach_wal(wal)
        js.prepare_job("j")
        wal.simulate_crash()
        with pytest.raises(dur.WalCrashedError):
            js.put_result("j", {"worker_id": "w0"}, idem_key="w0:0:0")
        assert js.get_queue("j").qsize() == 0


# --- parity with the JAX package -----------------------------------------------------

def _records(wal_dir, mod):
    out = []
    for _e, _s, path in mod.list_segments(wal_dir):
        recs, bad = mod.read_segment(path)
        assert bad is None
        out += recs
    return out


def _without_ts(recs):
    return [{k: v for k, v in r.items() if k != "ts"} for r in recs]


def _report(mod, wal_dir):
    rep = mod.verify(wal_dir)
    rep["lease"].pop("expires_in_s", None)
    return rep


@pytest.mark.parametrize("segment_bytes", [1 << 20, 400],
                         ids=["one_segment", "rotated"])
def test_the_same_appends_give_the_same_log_in_both_packages(
        tmp_path, segment_bytes):
    dirs = {}
    for name, mod in (("jax", jax_dur), ("torch", dur)):
        d = dirs[name] = str(tmp_path / name)
        wal, _ = mk_wal(d, mod=mod, segment_bytes=segment_bytes)
        for rtype, fields in APPENDS:
            wal.append(rtype, **fields)
        wal.close()
    assert _without_ts(_records(dirs["jax"], jax_dur)) \
        == _without_ts(_records(dirs["torch"], dur))
    assert [os.path.basename(p) for *_, p in jax_dur.list_segments(
        dirs["jax"])] == [os.path.basename(p) for *_, p in
                          dur.list_segments(dirs["torch"])]
    # each package replays and verifies the other's directory alike
    for d in dirs.values():
        assert jax_dur.replay(d)[0].to_json() == dur.replay(d)[0].to_json()
        assert _report(jax_dur, d) == _report(dur, d)
    assert dur.replay(dirs["jax"])[0].to_json() \
        == jax_dur.replay(dirs["torch"])[0].to_json()


def test_a_torn_tail_and_corruption_read_alike_in_both_packages(wal_dir):
    wal, lease = mk_wal(wal_dir)
    for rtype, fields in APPENDS[:5]:
        wal.append(rtype, **fields)
    wal.inject_crash("torn")
    with pytest.raises(dur.WalCrashedError):
        wal.append("exec_done", pid="p1", status="ok")
    assert _report(jax_dur, wal_dir) == _report(dur, wal_dir)
    assert _report(dur, wal_dir)["ok"]
    seg = dur.list_segments(wal_dir)[0][2]
    with open(seg, "rb") as f:
        data = f.read()
    with open(seg, "wb") as f:
        f.write(data[:30] + b"XX" + data[32:])
    assert _report(jax_dur, wal_dir) == _report(dur, wal_dir)
    assert not _report(dur, wal_dir)["ok"]


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_a_unit_file_reads_back_equal_in_the_other_package(wal_dir, writer):
    t = torch.rand((1, 40, 24, 3), generator=torch.Generator().manual_seed(3))
    meta = {"form": "tile", "x": 8, "y": 0, "extracted_width": 24,
            "extracted_height": 40, "padding": 8}
    (put_mod, get_mod) = (jax_dur, dur) if writer == "jax" else (dur, jax_dur)
    put_mod.UnitStore(wal_dir).put("exec_1_2", 5, [t.numpy()], meta)
    arrays, got_meta = get_mod.UnitStore(wal_dir).get("exec_1_2", 5)
    assert got_meta == meta
    assert torch.equal(torch.from_numpy(np.asarray(arrays[0])), t)
    with open(get_mod.UnitStore(wal_dir).path("exec_1_2", 5), "rb") as f:
        assert f.read(2) == b"PK"     # a zip (.npz) in both packages


@pytest.mark.parametrize("crashed,recovers", [("jax", "torch"),
                                              ("torch", "jax")])
def test_a_ledger_of_either_package_recovers_the_others_job(
        wal_dir, crashed, recovers):
    """A job whose ledger spilled two units and crashed, recovered by the
    other package's ledger from the same directory."""
    dmod = {"jax": jax_dur, "torch": dur}
    lmod = {"jax": jax_cl, "torch": cl}
    wal, lease = mk_wal(wal_dir, mod=dmod[crashed])
    led = lmod[crashed].WorkLedger()
    led.attach_wal(wal, dmod[crashed].UnitStore(wal_dir), {})
    owners = {0: "master", 1: "w0", 2: "w1"}
    led.create_job("j", owners, kind="tile")
    for u in (0, 1):
        assert led.check_in("j", u, "master" if u == 0 else "w0", payload=(
            [np.full((2, 2, 3), float(u), np.float32)], {"form": "window"}))
    wal.simulate_crash()
    st, _ = dmod[recovers].replay(wal_dir)
    led2 = lmod[recovers].WorkLedger()
    wal2 = dmod[recovers].WriteAheadLog(wal_dir, epoch=2, tracker=st)
    led2.attach_wal(wal2, dmod[recovers].UnitStore(wal_dir), dict(st.jobs))
    led2.create_job("j", owners, kind="tile")
    assert led2.pending("j") == [2]
    assert led2.take_recovered_lost("j") == {"w1": [2]}
    payloads = led2.load_payloads("j")
    assert {u: float(a[0][0, 0, 0]) for u, (a, _m) in payloads.items()} \
        == {0: 0.0, 1: 1.0}
    wal2.close()
