"""Admission, fair dequeue, deadline hedging and the graceful drain of
the port (``workflow/scheduler.py``, ``server/app.py``,
``runtime/cluster.py``), on the CPU.

The unit tests mirror ``tests/test_overload.py``'s ``TestTokenBucket``,
``TestAdmission``, ``TestFairDequeue``, ``TestServerRetryAfter`` (over
the port's servers on loopback sockets) and ``TestSloDeadlineHedging``.
The parity tests run the JAX package's ``AdmissionController`` and the
port's side by side on scripted sequences made from a numpy seed, on one
fake clock: the decisions, the ``retry_after_s`` and the fair order must
be equal, exactly.  The drain tests hold the port's own behaviour: a
prompt still queued at the timeout is cancelled, a draining server
answers 503, and ``cli serve`` drains and exits on SIGTERM."""

import os
import signal
import subprocess
import sys
import threading
import time

import numpy as np
import pytest

from comfyui_distributed_tpu.workflow import scheduler as jsched
from comfyui_distributed_tpu_torch.runtime import cluster as cl
from comfyui_distributed_tpu_torch.server.app import (
    DrainingError,
    ServerState,
    make_server,
)
from comfyui_distributed_tpu_torch.utils import constants as C
from comfyui_distributed_tpu_torch.utils import net
from comfyui_distributed_tpu_torch.workflow import orchestrate as orch
from comfyui_distributed_tpu_torch.workflow import scheduler as sched

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


class FakeClock:
    def __init__(self, t=100.0):
        self.t = float(t)

    def monotonic(self):
        return self.t

    def time(self):
        return 1.7e9 + self.t


def controller(mod=sched, **kw):
    kw.setdefault("weights", dict(C.TENANT_WEIGHTS_DEFAULT))
    kw.setdefault("shed", dict(C.TENANT_SHED_DEFAULT))
    kw.setdefault("rate", {cls: 0.0 for cls in C.TENANT_CLASSES})
    kw.setdefault("burst", {cls: 10.0 for cls in C.TENANT_CLASSES})
    return mod.AdmissionController(**kw)


# --- token buckets -----------------------------------------------------------

class TestTokenBucket:
    def test_burst_cap_then_refill(self):
        tb = sched.TokenBucket(rate=2.0, burst=3)
        now = 100.0
        assert [tb.try_take(now) for _ in range(5)] == \
            [True, True, True, False, False]
        # a second at 2 tokens/s refills two takes
        assert tb.try_take(now + 1.0) and tb.try_take(now + 1.0)
        assert not tb.try_take(now + 1.0)

    def test_zero_rate_is_unlimited(self):
        tb = sched.TokenBucket(rate=0.0, burst=1)
        assert all(tb.try_take() for _ in range(100))

    def test_seconds_until_token(self):
        tb = sched.TokenBucket(rate=4.0, burst=1)
        assert tb.try_take(5.0)
        assert 0.0 < tb.seconds_until_token(5.0) <= 0.25


# --- admission ---------------------------------------------------------------

class TestAdmission:
    def test_classify_default_is_highest_class(self):
        a = controller()
        assert a.classify(None) == "paid"
        assert a.classify("") == "paid"
        assert a.classify("nonsense") == "paid"
        assert a.classify("BATCH") == "batch"
        assert a.classify("free") == "free"

    def test_shed_ladder_batch_first_paid_never(self):
        a = controller()     # batch 0.5, free 0.85, paid 1.0
        assert a.admit("batch", "c", 5, 10)["reason"] == "overload"
        assert a.admit("free", "c", 5, 10) is None
        assert a.admit("paid", "c", 5, 10) is None
        assert a.admit("free", "c", 9, 10)["reason"] == "overload"
        assert a.admit("paid", "c", 9, 10) is None
        assert a.admit("paid", "c", 10, 10)["reason"] == "overload"

    def test_the_burst_ladder_at_max_queue_four(self):
        """The ladder of the card's burst: batch, batch, batch, free,
        free, free, paid into an empty queue of four."""
        a = controller()
        depth, out = 0, []
        for tenant in ("batch",) * 3 + ("free",) * 3 + ("paid",):
            rej = a.admit(tenant, "c", depth, 4)
            out.append("admit" if rej is None else rej["reason"])
            depth += rej is None
        assert out == ["admit", "admit", "overload", "admit", "admit",
                       "overload", "overload"]

    def test_token_bucket_rate_shed_carries_retry_after(self):
        a = controller(rate={"paid": 0.0, "free": 1.0, "batch": 0.0},
                       burst={"paid": 1.0, "free": 2.0, "batch": 1.0})
        assert a.admit("free", "alice", 0, 100) is None
        assert a.admit("free", "alice", 0, 100) is None
        rej = a.admit("free", "alice", 0, 100)
        assert rej["reason"] == "rate" and rej["retry_after_s"] >= 1.0
        # a bucket per client: bob is not charged for alice's flood
        assert a.admit("free", "bob", 0, 100) is None
        snap = a.snapshot()
        assert snap["per_class"]["free"]["shed_rate"] == 1
        assert snap["per_class"]["free"]["admitted"] == 3

    def test_counters_track_decisions(self):
        a = controller()
        a.admit("paid", "c", 0, 10)
        a.admit("batch", "c", 9, 10)
        a.on_complete("paid")
        per = a.snapshot()["per_class"]
        assert per["paid"] == {"admitted": 1, "shed_rate": 0,
                               "shed_overload": 0, "completed": 1}
        assert per["batch"]["shed_overload"] == 1

    def test_env_knobs(self, monkeypatch):
        monkeypatch.setenv(C.TENANT_WEIGHTS_ENV, "paid=2,free=1")
        monkeypatch.setenv(C.TENANT_SHED_ENV, "bad")
        monkeypatch.setenv(C.TENANT_RATE_ENV, "3")
        monkeypatch.setenv(C.TENANT_DEFAULT_CLASS_ENV, "free")
        a = sched.AdmissionController()
        assert a.weights == {"paid": 2.0, "free": 1.0, "batch": 1.0}
        assert a.shed == C.TENANT_SHED_DEFAULT
        assert a.rate == {cls: 3.0 for cls in C.TENANT_CLASSES}
        assert a.classify(None) == "free"


class TestFairDequeue:
    def test_stride_distribution_matches_weights(self):
        a = controller()
        picks = [a.next_class({"paid": 50, "free": 50, "batch": 50})
                 for _ in range(20)]
        assert (picks.count("paid"), picks.count("free"),
                picks.count("batch")) == (12, 6, 2)

    def test_idle_class_cannot_bank_credit(self):
        a = controller()
        for _ in range(50):
            assert a.next_class({"paid": 1}) == "paid"
        picks = [a.next_class({"paid": 5, "free": 5}) for _ in range(9)]
        assert picks.count("free") == 3 and picks.count("paid") == 6

    @staticmethod
    def _item(pid, tenant, sig=None):
        return {"id": pid, "tenant": tenant, "sig": sig}

    def test_the_burst_runs_in_stride_order(self):
        """The card's admitted burst, b1 b2 f1 f2 queued behind a running
        paid prompt, runs f1, b1, f2, b2."""
        a = controller()
        q = [self._item("u", "paid")]
        assert sched.pop_fair_group(q, a)[0]["id"] == "u"
        q = [self._item(p, t) for p, t in (("b1", "batch"), ("b2", "batch"),
                                          ("f1", "free"), ("f2", "free"))]
        order = [sched.pop_fair_group(q, a)[0]["id"] for _ in range(4)]
        assert order == ["f1", "b1", "f2", "b2"]

    def test_no_signature_pops_one_at_a_time(self):
        a = controller()
        q = [self._item(p, "paid") for p in "abc"]
        assert [g["id"] for g in sched.pop_fair_group(q, a, 8)] == ["a"]
        assert [i["id"] for i in q] == ["b", "c"]

    def test_single_class_is_contiguous_pop(self):
        a = controller()
        q = [self._item("a", "paid", "s1"), self._item("b", "paid", "s1"),
             self._item("c", "paid", "s2"), self._item("d", "paid", "s1")]
        assert [g["id"] for g in sched.pop_fair_group(q, a, 8)] == ["a", "b"]
        assert [i["id"] for i in q] == ["c", "d"]

    def test_fair_pop_keeps_per_class_fifo(self):
        a = controller(weights={"paid": 1.0, "free": 1.0, "batch": 1.0})
        q = [self._item("f1", "free", "x"), self._item("p1", "paid", "y"),
             self._item("f2", "free", "x"), self._item("p2", "paid", "y")]
        seen = []
        while q:
            seen.append([g["id"] for g in sched.pop_fair_group(q, a, 8)])
        flat = [pid for grp in seen for pid in grp]
        assert flat.index("f1") < flat.index("f2")
        assert flat.index("p1") < flat.index("p2")
        assert ["f1", "f2"] in seen or ["p1", "p2"] in seen


# --- parity with the JAX package ---------------------------------------------

def _admission_script(seed, n=400):
    """(dt, tenant, client, depth, max_queue, rate scale or None)."""
    rng = np.random.default_rng(seed)
    classes = list(C.TENANT_CLASSES) + ["", "bogus"]
    out = []
    for _ in range(n):
        out.append((float(rng.choice([0.0, 0.01, 0.1, 0.4, 1.5])),
                    classes[int(rng.integers(len(classes)))],
                    f"c{int(rng.integers(4))}",
                    int(rng.integers(0, 12)),
                    int(rng.choice([0, 4, 10])),
                    (None if rng.uniform() > 0.05
                     else float(rng.choice([1.0, 0.5, 1 / 3])))))
    return out


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_admission_decisions_equal_the_jax_package(seed):
    kw = dict(rate={"paid": 5.0, "free": 2.0, "batch": 0.5},
              burst={"paid": 4.0, "free": 2.0, "batch": 1.0})
    clock = FakeClock()
    port = controller(clock=clock, **kw)
    ref = controller(jsched, clock=clock, **kw)
    for dt, prio, client, depth, maxq, scale in _admission_script(seed):
        clock.t += dt
        if scale is not None:
            port.set_rate_scale(scale)
            ref.set_rate_scale(scale)
        t_port, t_ref = port.classify(prio), ref.classify(prio)
        assert t_port == t_ref
        assert port.admit(t_port, client, depth, maxq) \
            == ref.admit(t_ref, client, depth, maxq)
        if dt > 1.0:
            port.on_complete(t_port)
            ref.on_complete(t_ref)
    assert port.snapshot() == ref.snapshot()


@pytest.mark.parametrize("seed,coalesce_max", [(0, 1), (1, 1), (2, 3),
                                               (3, 8)])
def test_fair_order_equals_the_jax_package(seed, coalesce_max):
    rng = np.random.default_rng(seed)
    tenants = ["paid", "free", "batch", None]
    sigs = [None, "a", "b"] if coalesce_max > 1 else [None]
    port, ref = controller(), controller(jsched)
    q_port, q_ref, order_port, order_ref = [], [], [], []
    for i in range(300):
        # arrivals and pops interleave, so classes go idle and return
        for _ in range(int(rng.integers(0, 3))):
            item = {"id": f"p{i}_{len(q_port)}",
                    "tenant": tenants[int(rng.integers(4))],
                    "sig": sigs[int(rng.integers(len(sigs)))]}
            q_port.append(dict(item))
            q_ref.append(dict(item))
        if rng.uniform() < 0.6:
            order_port.append([g["id"] for g in sched.pop_fair_group(
                q_port, port, coalesce_max)])
            order_ref.append([g["id"] for g in jsched.pop_fair_group(
                q_ref, ref, coalesce_max)])
    assert order_port == order_ref
    assert [i["id"] for i in q_port] == [i["id"] for i in q_ref]


# --- the server over HTTP ------------------------------------------------------

def _prompt(seed):
    return {"1": {"class_type": "EmptyLatentImage",
                  "inputs": {"width": 8, "height": 8, "batch_size": 1,
                             "seed": seed}}}


def _share(seed):
    p = _prompt(seed)
    p["20"] = {"class_type": "DistributedCollector",
               "inputs": {"images": ["1", 0]},
               "hidden": {"multi_job_id": f"mj{seed}", "is_worker": True,
                          "enabled_worker_ids": "[]"}}
    return p


@pytest.fixture
def server(tmp_path):
    made = []

    def make(name="m", **kw):
        d = tmp_path / name
        kw.setdefault("start_exec_thread", False)
        st = ServerState(config_path=str(d / "cfg.json"), device="cpu",
                         input_dir=str(d / "input"),
                         output_dir=str(d / "output"), **kw)
        srv = make_server(st, "127.0.0.1", 0)
        threading.Thread(target=srv.serve_forever, daemon=True).start()
        made.append(srv)
        return st, f"http://127.0.0.1:{st.port}"

    yield make
    for srv in made:
        srv.shutdown()
        srv.server_close()


def _post(url, body):
    return net.request_json("POST", url + "/prompt", body, timeout=10)


class TestServerRetryAfter:
    def test_429_carries_retry_after_header(self, server, monkeypatch):
        monkeypatch.setenv(C.MAX_QUEUE_ENV, "2")
        st, url = server()
        for i in range(2):
            assert _post(url, {"prompt": _prompt(i),
                               "client_id": "c"})[0] == 200
        code, body, hdrs = _post(url, {"prompt": _prompt(9),
                                       "client_id": "c"})
        assert code == 429
        assert int(hdrs["Retry-After"]) == body["retry_after_s"] >= 1
        assert body["reason"] == "overload" and body["tenant"] == "paid"
        assert body["max_queue"] == 2

    def test_batch_shed_before_paid_over_http(self, server, monkeypatch):
        monkeypatch.setenv(C.MAX_QUEUE_ENV, "4")
        st, url = server()
        for i in range(2):
            assert _post(url, {"prompt": _prompt(i), "client_id": "c",
                               "priority": "paid"})[0] == 200
        code, body, hdrs = _post(url, {"prompt": _prompt(7),
                                       "client_id": "c",
                                       "priority": "batch"})
        assert code == 429 and "Retry-After" in hdrs
        assert body["tenant"] == "batch" and body["reason"] == "overload"
        assert _post(url, {"prompt": _prompt(8), "client_id": "c",
                           "priority": "paid"})[0] == 200
        m = net.get_json(url + "/distributed/metrics")
        assert m["admission"]["per_class"]["batch"]["shed_overload"] == 1
        assert m["admission"]["per_class"]["paid"]["admitted"] == 3
        assert m["admission"]["queued_by_class"]["paid"] == 3
        prom = net.request_json("GET", url + "/distributed/metrics.prom")
        assert prom[0] == 200
        # the priority rides extra_data, which the log would keep
        assert [i["extra_data"].get("priority") for i in st._queue] \
            == ["paid"] * 3

    def test_prometheus_tenant_families(self, server, monkeypatch):
        import urllib.request
        monkeypatch.setenv(C.MAX_QUEUE_ENV, "2")
        st, url = server()
        _post(url, {"prompt": _prompt(0), "priority": "free"})
        _post(url, {"prompt": _prompt(1), "priority": "batch"})
        with urllib.request.urlopen(url + "/distributed/metrics.prom") as r:
            text = r.read().decode()
        assert 'dtpu_tenant_queued{tenant="free"} 1' in text
        assert ('dtpu_tenant_shed_total{reason="overload",tenant="batch"} 1'
                in text)
        assert "dtpu_queue_capacity 2" in text

    def test_dispatched_share_bypasses_worker_admission(self, server,
                                                        monkeypatch):
        """A share a master dispatched belongs to an admitted job: the
        worker never sheds it, only the hard cap applies."""
        monkeypatch.setenv(C.MAX_QUEUE_ENV, "4")
        st, url = server("w", is_worker=True)
        for i in range(2):
            assert _post(url, {"prompt": _prompt(i),
                               "client_id": "c"})[0] == 200
        assert _post(url, {"prompt": _prompt(7), "client_id": "c",
                           "priority": "batch"})[0] == 429
        code, body, _ = _post(url, {"prompt": _share(8), "client_id": "c",
                                    "priority": "batch"})
        assert code == 200, body
        assert _post(url, {"prompt": _share(9), "client_id": "c"})[0] == 200
        code, body, _ = _post(url, {"prompt": _share(10), "client_id": "c"})
        assert code == 429 and "queue full" in body["error"]
        per = st.admission.snapshot()["per_class"]
        assert per["batch"]["shed_overload"] == 1
        assert per["batch"]["admitted"] == 0

    def test_fan_out_shed_never_reaches_the_workers(self, server,
                                                    monkeypatch):
        """A fan-out that will be shed is answered 429 before anything is
        dispatched."""
        monkeypatch.setenv(C.MAX_QUEUE_ENV, "2")
        st, url = server()
        st._queue.append({"id": "x", "tenant": "paid"})
        called = []
        monkeypatch.setattr(st, "orchestration_config",
                            lambda prompt: {"workers": [], "master": {}})
        monkeypatch.setattr(st, "_fan_out",
                            lambda *a, **k: called.append(a) or (200, {}))
        code, body, hdrs = _post(url, {"prompt": _prompt(0),
                                       "priority": "batch"})
        assert code == 429 and body["tenant"] == "batch" and not called
        assert _post(url, {"prompt": _prompt(1)})[0] == 200 and called


# --- deadline hedging ----------------------------------------------------------

class TestSloDeadlineHedging:
    @staticmethod
    def _job(ledger):
        ledger.create_job("j1", {0: "master", 1: "w0", 2: "w0"},
                          kind="tile")
        ledger.check_in("j1", 0, "master")   # the estimate exists now

    def test_no_deadline_keeps_min_progress_gate(self):
        ledger = cl.WorkLedger()
        self._job(ledger)
        assert ledger.overdue_units("j1", factor=0.0, min_wait_s=0.0) == {}

    def test_deadline_pressure_waives_gate_and_rekeys_threshold(self):
        clock = FakeClock()
        ledger = cl.WorkLedger(clock=clock)
        self._job(ledger)
        ledger.set_deadline("j1", clock.t + 0.01)
        clock.t += C.SLO_MIN_WAIT_S + 0.05
        overdue = ledger.overdue_units("j1", factor=1000.0,
                                       min_progress_pct=50.0,
                                       min_wait_s=1000.0)
        assert overdue == {1: "w0", 2: "w0"}
        snap = ledger.snapshot()["active_jobs"]["j1"]
        assert snap["slo_deadline_remaining_s"] == round(-0.29, 3)

    def test_bar_is_a_fraction_of_the_budget_left(self):
        """With 30 s left the bar is 7.5 s of silence: 7 s hedges nothing,
        8 s hedges both of w0's units."""
        clock = FakeClock()
        ledger = cl.WorkLedger(clock=clock)
        ledger.create_job("j1", {0: "master", 1: "w0", 2: "w0"})
        ledger.check_in("j1", 0, "master")
        ledger.set_deadline("j1", clock.t + 37.0)
        clock.t += 7.0
        assert ledger.overdue_units("j1", min_wait_s=600.0) == {}
        clock.t += 1.0       # 29 s left: bar 7.25 s, silent 8 s
        assert ledger.overdue_units("j1", min_wait_s=600.0) \
            == {1: "w0", 2: "w0"}

    def test_comfortable_budget_does_not_loosen_policy(self):
        ledger = cl.WorkLedger()
        self._job(ledger)
        ledger.set_deadline("j1", time.monotonic() + 3600.0)
        assert ledger.overdue_units("j1", factor=1000.0,
                                    min_progress_pct=50.0,
                                    min_wait_s=1000.0) == {}

    def test_finish_job_clears_deadline(self):
        ledger = cl.WorkLedger()
        self._job(ledger)
        ledger.set_deadline("j1", time.monotonic() + 1.0)
        assert ledger.deadline("j1") is not None
        ledger.check_in("j1", 1, "w0")
        ledger.check_in("j1", 2, "w0")
        ledger.finish_job("j1")
        assert ledger.deadline("j1") is None

    def test_hedging_equals_the_jax_ledger(self):
        """Both packages' ledgers on one fake clock give the same hedge
        candidates as the budget runs down."""
        from comfyui_distributed_tpu.runtime import cluster as jcl
        clock = FakeClock()
        ledgers = [cl.WorkLedger(clock=clock), jcl.WorkLedger(clock=clock)]
        for led in ledgers:
            led.create_job("j", {0: "master", 1: "w0", 2: "w1", 3: "w1"})
            led.check_in("j", 0, "master")
            led.set_deadline("j", clock.t + 20.0)
        for step in range(12):
            clock.t += 0.9
            if step == 4:
                for led in ledgers:
                    led.check_in("j", 1, "w0")
            got = [led.overdue_units("j", factor=3.0, min_progress_pct=50.0,
                                     min_wait_s=600.0) for led in ledgers]
            assert got[0] == got[1]
            assert ledgers[0].snapshot()["active_jobs"]["j"][
                "slo_deadline_remaining_s"] == ledgers[1].snapshot()[
                "active_jobs"]["j"]["slo_deadline_remaining_s"]

    def test_slo_rides_the_fanout_into_the_ledger(self, monkeypatch):
        worker = {"id": "w0", "host": "127.0.0.1", "port": 1,
                  "enabled": True}
        monkeypatch.setattr(orch.dsp, "preflight_check",
                            lambda workers, registry=None: list(workers))
        monkeypatch.setattr(orch.dsp, "dispatch_to_worker",
                            lambda w, g, client_id=None, extra_data=None:
                            {"prompt_id": "wp"})
        monkeypatch.setattr(orch.dsp, "make_job_id_map",
                            lambda graph: {"2": "job_slo"})

        class FakeJobs:
            def prepare_job(self, mj):
                pass

            def prepare_tile_job(self, mj):
                pass

        graph = {"1": {"class_type": "EmptyLatentImage",
                       "inputs": {"width": 8, "height": 8,
                                  "batch_size": 1}},
                 "2": {"class_type": "DistributedCollector",
                       "inputs": {"images": ["1", 0]}}}
        ledger = cl.WorkLedger()
        t0 = time.monotonic()
        out = orch.run_distributed(
            graph, "http://127.0.0.1:1", lambda g: "pid", [worker],
            job_store=FakeJobs(), extra_data={"slo_s": 30.0}, ledger=ledger)
        assert out["workers"] == ["w0"]
        assert 25.0 < ledger.deadline("job_slo") - t0 <= 30.5

    def test_post_prompt_stamps_slo_and_priority(self, server):
        st, url = server()
        assert _post(url, {"prompt": _prompt(0), "slo_s": "12",
                           "priority": "free"})[0] == 200
        assert st._queue[0]["extra_data"] == {"slo_s": 12.0,
                                              "priority": "free"}
        assert st._queue[0]["tenant"] == "free"


# --- the graceful drain -------------------------------------------------------

def _blocking_state(server, release):
    """A server whose execution thread holds each prompt until
    ``release`` is set."""
    st, url = server(start_exec_thread=True)
    runs = []

    def execute(item):
        runs.append(item["id"])
        release.wait(30)

    st._execute = execute
    return st, url, runs


def _wait(pred, limit=10.0):
    deadline = time.monotonic() + limit
    while not pred():
        assert time.monotonic() < deadline
        time.sleep(0.01)


def test_drain_cancels_what_is_queued_at_the_timeout(server):
    release = threading.Event()
    st, url, runs = _blocking_state(server, release)
    first = st.enqueue_prompt(_prompt(0))
    second = st.enqueue_prompt(_prompt(1))
    _wait(lambda: runs == [first])
    try:
        t0 = time.monotonic()
        assert st.drain(timeout=0.3) is False
        assert 0.3 <= time.monotonic() - t0 < 5.0
        assert st._history[second] == {
            "status": "error", "error": "cancelled: server drain timeout",
            "finished_at": st._history[second]["finished_at"]}
        assert st.metrics["prompts_failed"] == 1 and not st._queue
        from comfyui_distributed_tpu_torch.runtime import interrupt
        assert interrupt.is_interrupted()
    finally:
        release.set()
        from comfyui_distributed_tpu_torch.runtime import interrupt
        interrupt.clear_interrupt()


def test_draining_server_answers_503(server):
    release = threading.Event()
    st, url, runs = _blocking_state(server, release)
    first = st.enqueue_prompt(_prompt(0))
    _wait(lambda: runs == [first])
    done = []
    t = threading.Thread(target=lambda: done.append(st.drain(timeout=20)))
    t.start()
    _wait(lambda: st._draining)
    code, body, _ = _post(url, {"prompt": _prompt(1)})
    assert code == 503 and "draining" in body["error"]
    with pytest.raises(DrainingError):
        st.enqueue_prompt(_prompt(2))
    # the running prompt still finishes inside the bound
    release.set()
    t.join(10)
    assert done == [True]


def test_drain_runs_the_queue_before_it_returns(server):
    release = threading.Event()
    st, url, runs = _blocking_state(server, release)
    pids = [st.enqueue_prompt(_prompt(i)) for i in range(3)]
    _wait(lambda: runs == pids[:1])
    threading.Timer(0.2, release.set).start()
    assert st.drain(timeout=20) is True
    assert runs == pids and not st._queue


def test_drain_leaves_cancelled_admissions_open_for_a_restart(
        server, tmp_path, monkeypatch):
    from comfyui_distributed_tpu_torch.runtime import durable as dur
    from comfyui_distributed_tpu_torch.runtime import interrupt
    wal = str(tmp_path / "wal")
    monkeypatch.setenv(C.WAL_DIR_ENV, wal)
    release = threading.Event()
    st, url, runs = _blocking_state(server, release)
    runnable = [{"1": {"class_type": "EmptyLatentImage",
                       "inputs": {"width": 8 * n, "height": 8,
                                  "batch_size": 1}}} for n in (1, 2)]
    first = st.enqueue_prompt(runnable[0])
    second = st.enqueue_prompt(runnable[1])
    _wait(lambda: runs == [first])
    try:
        assert st.drain(timeout=0.2) is False
        assert st._history[second]["error"] \
            == "cancelled: server drain timeout"
    finally:
        release.set()
        interrupt.clear_interrupt()
    st.durable.close()
    # the cancelled prompt's admission is still open in the log ...
    assert second in dur.replay(wal)[0].prompts
    # ... so the restarted master runs it under its id
    st2, _ = server("m2", start_exec_thread=True)
    try:
        assert st2.resume_recovered() == 2
        _wait(lambda: second in st2._history)
        assert st2._history[second]["status"] == "success"
        _wait(lambda: not dur.replay(wal)[0].prompts)
    finally:
        st2.durable.close()


def test_admission_logged_outside_the_queue_lock_before_its_run(
        server, tmp_path, monkeypatch):
    from comfyui_distributed_tpu_torch.runtime import durable as dur
    wal = str(tmp_path / "wal")
    monkeypatch.setenv(C.WAL_DIR_ENV, wal)
    release = threading.Event()
    release.set()
    st, url, runs = _blocking_state(server, release)
    in_append, go_on = threading.Event(), threading.Event()
    log_enqueue = st.durable.log_enqueue

    def slow_append(*a):
        in_append.set()
        assert go_on.wait(10)
        log_enqueue(*a)

    st.durable.log_enqueue = slow_append
    pids = []
    t = threading.Thread(target=lambda: pids.append(
        st.enqueue_prompt(_prompt(0))))
    t.start()
    try:
        assert in_append.wait(10)
        # the queue lock is free while the record is written: readers
        # answer at once, and the popped prompt waits for its record
        got = []
        reader = threading.Thread(
            target=lambda: got.append(st.queue_remaining()))
        reader.start()
        reader.join(2)
        assert got == [1]
        time.sleep(0.2)
        assert runs == [] and not pids
    finally:
        go_on.set()
        t.join(10)
    _wait(lambda: runs == pids)
    assert pids[0] in dur.replay(wal)[0].prompts
    st.durable.close()


def test_unlogged_admission_is_refused_and_never_runs(
        server, tmp_path, monkeypatch):
    monkeypatch.setenv(C.WAL_DIR_ENV, str(tmp_path / "wal"))
    release = threading.Event()
    release.set()
    st, url, runs = _blocking_state(server, release)

    def broken(*a):
        raise OSError("disk gone")

    st.durable.log_enqueue = broken
    code, body, _ = _post(url, {"prompt": _prompt(0)})
    assert code == 400 and "disk gone" in body["error"]
    time.sleep(0.2)
    with st._cond:
        assert runs == [] and not st._queue and not st._running
    st.durable.close()


def test_cli_serve_drains_and_exits_on_sigterm(tmp_path):
    port = net.find_free_port()
    env = {**os.environ, "DTPU_DEFAULT_FAMILY": "tiny",
           C.DRAIN_TIMEOUT_ENV: "5", C.RESOURCE_ENV: "0"}
    proc = subprocess.Popen(
        [sys.executable, "-m", "comfyui_distributed_tpu_torch.cli", "serve",
         "--host", "127.0.0.1", "--port", str(port), "--device", "cpu",
         "--config", str(tmp_path / "cfg.json"),
         "--input-dir", str(tmp_path / "in"),
         "--output-dir", str(tmp_path / "out")],
        cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True)
    try:
        url = f"http://127.0.0.1:{port}"
        deadline = time.monotonic() + 60
        while True:
            try:
                net.get_json(url + "/prompt", timeout=1)
                break
            except OSError:
                assert time.monotonic() < deadline and proc.poll() is None
                time.sleep(0.2)
        proc.send_signal(signal.SIGTERM)
        out, _ = proc.communicate(timeout=30)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    assert proc.returncode == 0, out
    assert "draining" in out and "drained in" in out
