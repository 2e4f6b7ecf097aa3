"""The port's control plane (``comfyui_distributed_tpu_torch/runtime/
cluster.py``) against the JAX package's, call for call.

Each case drives the same sequence of calls through
``comfyui_distributed_tpu.runtime.cluster`` and the port's module, each
on its own copy of one fake clock that the sequence steps, and records
every return value, every snapshot and every counter the calls move;
the two records must be equal.  The JAX package counts in
``utils/trace.GLOBAL_COUNTERS``, the port in its own
``utils/trace.GLOBAL_COUNTERS``; both are read as differences over the
case.  The JAX ledger's ``redispatch``
is a coroutine and the port's a plain call: the case awaits the one and
calls the other with callbacks of the same result."""

import asyncio
import inspect

import pytest

from comfyui_distributed_tpu.runtime import cluster as jcl
from comfyui_distributed_tpu.utils import constants as JC
from comfyui_distributed_tpu.utils import trace as jtrace
from comfyui_distributed_tpu_torch.runtime import cluster as tcl
from comfyui_distributed_tpu_torch.utils import clock as tclock
from comfyui_distributed_tpu_torch.utils import constants as TC
from comfyui_distributed_tpu_torch.utils import trace as ttrace

COUNTER_NAMES = (
    "cluster_healthy_transitions", "cluster_suspect_transitions",
    "cluster_dead_transitions", "cluster_unknown_transitions",
    "cluster_duplicate_checkins", "cluster_hedge_wins",
    "cluster_hedge_losses", "cluster_reassigned_units", "cluster_hedges",
    "cluster_redispatches")


class FakeClock(tclock.Clock):
    """A clock that moves only when the case steps it."""

    def __init__(self, t0=1000.0):
        self.mono = t0
        self.wall = 1.7e9

    def time(self):
        return self.wall

    def monotonic(self):
        return self.mono

    def step(self, s):
        self.mono += s
        self.wall += s


class Side:
    """One package's module, clock and counter reader for a case."""

    def __init__(self, mod, counters):
        self.cl = mod
        self.clock = FakeClock()
        self._counters = counters
        self._before = {n: counters.get(n) for n in COUNTER_NAMES}

    def registry(self, **kw):
        return self.cl.ClusterRegistry(clock=self.clock, **kw)

    def ledger(self):
        return self.cl.WorkLedger(clock=self.clock)

    def redispatch(self, led, job, units, lost):
        out = led.redispatch(job, units, lost)
        return asyncio.run(out) if inspect.isawaitable(out) else out

    def callback(self, fn):
        """``fn`` as the package's redispatcher: a coroutine function
        for the JAX ledger, a plain one for the port's."""
        if self.cl is jcl:
            async def cb(units, lost):
                return fn(units, lost)
            return cb
        return fn

    def counters(self):
        return {n: self._counters.get(n) - self._before[n]
                for n in COUNTER_NAMES}


def case_lease_expiry(s):
    reg = s.registry(lease_s=15.0, suspect_probes=2)
    out = [reg.observe_probe("w0", True), reg.state("w0")]
    s.clock.step(14.9)
    out.append(reg.state("w0"))
    s.clock.step(0.2)
    out += [reg.state("w0"), reg.snapshot()]
    # contact brings a dead worker back: a restarted worker re-earns it
    out += [reg.heartbeat("w0"), reg.state("w0"), reg.healthy_ids()]
    return out


def case_suspect_after_failed_probes(s):
    reg = s.registry(lease_s=30.0, suspect_probes=2)
    out = [reg.observe_probe("w0", True)]
    reg.observe_probe("w0", False)
    out.append(reg.state("w0"))          # one failure < the threshold
    s.clock.step(1.0)
    reg.observe_probe("w0", False)
    out += [reg.state("w0"), reg.healthy_ids(), reg.snapshot()]
    reg.observe_probe("w0", True)
    out += [reg.state("w0"), reg.snapshot()]
    return out


def case_unknown_until_contact(s):
    reg = s.registry(lease_s=0.05, suspect_probes=1)
    reg.seed_from_config([{"id": "w0", "enabled": True, "port": 1,
                           "name": "a"},
                          {"id": "off", "enabled": False, "port": 2}])
    s.clock.step(10.0)
    out = [reg.state("w0"), reg.state("off"), reg.snapshot()]
    reg.observe_probe("w0", True, info={"queue_remaining": 3})
    out += [reg.state("w0"), reg.snapshot()]
    s.clock.step(0.1)
    out += [reg.state("w0"), reg.forget("w0"), reg.forget("w0"),
            reg.snapshot()]
    return out


def case_touch_renews_known_ids_only(s):
    reg = s.registry(lease_s=2.0)
    reg.touch("worker_0")                # a positional wire label
    out = [reg.snapshot()]
    out.append(reg.register("w1", info={"host": "h", "port": 5}))
    s.clock.step(1.5)
    reg.touch("w1")
    s.clock.step(1.5)
    out += [reg.state("w1"), reg.snapshot()]
    out.append(reg.register("w2", alive=False))
    reg.touch("w2")
    out += [reg.state("w2"), reg.snapshot()]
    return out


def case_transitions_ring(s):
    reg = s.registry(lease_s=1.0, suspect_probes=1)
    for i in range(40):
        reg.observe_probe(f"w{i % 3}", i % 4 != 0)
        s.clock.step(0.7 if i % 5 else 1.3)
        reg.state(f"w{(i + 1) % 3}")
    snap = reg.snapshot()
    return [snap, len(snap["transitions"])]


def case_exactly_once_check_in(s):
    led = s.ledger()
    led.create_job("j", {0: "master", 1: "w0"})
    out = [led.check_in("j", 0, "master"),
           led.check_in("j", 0, "master"),    # a retried POST
           led.check_in("j", 0, "w0"),        # a hedge's loser
           led.pending("j"), led.progress("j"),
           led.check_in("nope", 5, "x"),      # no such job: opt-in
           led.check_in("j", 7, "w0")]        # a unit never planned
    s.clock.step(2.5)
    out += [led.check_in("j", 1, "w0"), led.latency_estimate("j"),
            led.pending("j"), led.snapshot()]
    return out


def case_reassign_skips_done_units(s):
    led = s.ledger()
    led.create_job("j", {0: "w0", 1: "w0", 2: "w1"})
    led.check_in("j", 0, "w0")
    out = [led.reassign("j", [0, 1], "master"),
           led.pending("j", owner="master"), led.attempts("j", 1),
           led.attempts("j", 0), led.owners_of_pending("j"),
           led.reassign("nope", [1], "master"), led.snapshot()]
    return out


def case_first_hedge_completion_wins(s):
    led = s.ledger()
    led.create_job("j", {0: "w0", 1: "w0"})
    out = [led.mark_hedged("j", [0, 1], "master"),
           led.mark_hedged("j", [0], "master"),   # already hedged
           led.is_hedged("j", 0), led.attempts("j", 0),
           led.owners_of_pending("j", skip_hedged=True)]
    s.clock.step(0.5)
    # unit 0: the hedge lands first and wins; unit 1: the owner does
    out += [led.check_in("j", 0, "master"), led.check_in("j", 0, "w0"),
            led.check_in("j", 1, "w0"), led.check_in("j", 1, "master"),
            led.finish_job("j")]
    return out


def case_overdue_gated_on_progress_and_latency(s):
    led = s.ledger()
    led.create_job("j", {i: ("master" if i < 2 else "w0")
                         for i in range(4)})
    out = [led.overdue_units("j", factor=0.0, min_progress_pct=0.0,
                             min_wait_s=0.0)]      # no estimate yet
    s.clock.step(1.0)
    led.check_in("j", 0, "master")
    s.clock.step(0.5)
    led.check_in("j", 1, "master")
    out += [led.latency_estimate("j"),
            led.overdue_units("j", factor=0.0, min_progress_pct=75.0,
                              min_wait_s=0.0),     # 50% < 75%
            led.overdue_units("j", factor=0.0, min_progress_pct=50.0,
                              min_wait_s=30.0),    # the wait floor
            led.overdue_units("j", factor=3.0, min_progress_pct=50.0,
                              min_wait_s=0.0)]
    s.clock.step(0.02)
    out.append(led.overdue_units("j", factor=0.0, min_progress_pct=50.0,
                                 min_wait_s=0.0))
    s.clock.step(5.0)
    out.append(led.overdue_units("j", factor=3.0, min_progress_pct=50.0,
                                 min_wait_s=2.0))
    led.mark_hedged("j", [2])
    out.append(led.overdue_units("j", factor=3.0, min_progress_pct=50.0,
                                 min_wait_s=2.0))
    return out


def case_overdue_reads_the_environment(s):
    led = s.ledger()
    led.create_job("j", {0: "master", 1: "w1"})
    s.clock.step(0.4)
    led.check_in("j", 0, "master")
    s.clock.step(1.0)
    return [s.cl.hedge_pct(), s.cl.hedge_factor(), s.cl.hedge_min_wait(),
            s.cl.hedge_armed(), s.cl.fault_policy(),
            led.overdue_units("j")]


def case_unmark_hedged(s):
    led = s.ledger()
    led.create_job("j", {0: "w0", 1: "w0"})
    out = [led.mark_hedged("j", [0]),
           led.owners_of_pending("j", skip_hedged=True)]
    led.unmark_hedged("j", [0, 1])
    out += [led.owners_of_pending("j", skip_hedged=True),
            led.attempts("j", 0), led.mark_hedged("j", [0]),
            led.snapshot()]
    led.check_in("j", 0, "w0")
    led.unmark_hedged("j", [0])          # done: stays counted
    out += [led.snapshot(), led.finish_job("j")]
    return out


def case_finish_summary(s):
    led = s.ledger()
    led.create_job("j", {0: "w0", 1: "w1"}, kind="image")
    s.clock.step(0.25)
    led.check_in("j", 0, "w0")
    led.reassign("j", [1], "master")
    s.clock.step(1.25)
    out = [led.finish_job("j"), led.has_job("j"), led.finish_job("j"),
           led.pending("j"), led.progress("j"), led.snapshot()]
    for i in range(40):                  # the summary ring is bounded
        led.create_job(f"k{i}", {0: "master"})
        led.finish_job(f"k{i}")
    snap = led.snapshot()
    return out + [len(snap["completed_jobs"]),
                  snap["completed_jobs"][0]["job_id"]]


def case_redispatch_callback(s):
    led = s.ledger()
    led.create_job("j", {0: "w0"})
    calls = []

    def ok(units, lost):
        calls.append((list(units), lost))
        return True

    def boom(units, lost):
        raise RuntimeError("no route")

    out = [led.has_redispatcher("j"), s.redispatch(led, "j", [0], "w0")]
    led.set_redispatcher("j", s.callback(ok))
    out += [led.has_redispatcher("j"), s.redispatch(led, "j", [0], "w0"),
            list(calls)]
    # a raising redispatcher gives False, never an exception
    led.set_redispatcher("j", s.callback(boom))
    out.append(s.redispatch(led, "j", [0], "w0"))
    led.finish_job("j")
    out.append(led.has_redispatcher("j"))
    for i in range(520):                 # a bounded map
        led.set_redispatcher(f"x{i}", s.callback(ok))
    out += [led.has_redispatcher("x0"), led.has_redispatcher("x519")]
    return out


def case_heartbeat_registers_unknown(s):
    reg = s.registry(lease_s=3.0, suspect_probes=1)
    out = [reg.heartbeat("ext0", info={"port": 9999, "host": "h"}),
           reg.register("ext1", info={"name": "n"}, alive=False),
           reg.snapshot()]
    s.clock.step(3.5)
    out += [reg.healthy_ids(), reg.heartbeat("ext0"), reg.healthy_ids(),
            reg.snapshot()]
    return out


CASES = {name[len("case_"):]: fn for name, fn in sorted(globals().items())
         if name.startswith("case_")}


@pytest.mark.parametrize("name", sorted(CASES))
def test_port_matches_the_jax_control_plane(name, monkeypatch):
    for env in (JC.HEDGE_ENV, JC.HEDGE_PCT_ENV, JC.HEDGE_FACTOR_ENV,
                JC.HEDGE_MIN_WAIT_ENV, JC.FAULT_POLICY_ENV, JC.LEASE_ENV,
                JC.SUSPECT_PROBES_ENV):
        monkeypatch.delenv(env, raising=False)
    if name == "overdue_reads_the_environment":
        monkeypatch.setenv(JC.HEDGE_PCT_ENV, "40")
        monkeypatch.setenv(JC.HEDGE_FACTOR_ENV, "2.5")
        monkeypatch.setenv(JC.HEDGE_MIN_WAIT_ENV, "0.75")
        monkeypatch.setenv(JC.FAULT_POLICY_ENV, "Partial")
    jax_side = Side(jcl, jtrace.GLOBAL_COUNTERS)
    jax_out = CASES[name](jax_side)
    jax_counts = jax_side.counters()
    port_side = Side(tcl, ttrace.GLOBAL_COUNTERS)
    port_out = CASES[name](port_side)
    assert port_out == jax_out
    assert port_side.counters() == jax_counts


def test_constants_match_the_jax_package():
    names = ("LEASE_ENV", "LEASE_DEFAULT", "SUSPECT_PROBES_ENV",
             "SUSPECT_PROBES_DEFAULT", "FAULT_POLICY_ENV",
             "FAULT_POLICY_DEFAULT", "FAULT_POLICIES", "HEDGE_ENV",
             "HEDGE_PCT_ENV", "HEDGE_PCT_DEFAULT", "HEDGE_FACTOR_ENV",
             "HEDGE_FACTOR_DEFAULT", "HEDGE_MIN_WAIT_ENV",
             "HEDGE_MIN_WAIT_DEFAULT", "CLUSTER_POLL_S",
             "HEARTBEAT_FRACTION", "CLUSTER_TRANSITIONS_KEPT",
             "LEDGER_COMPLETED_KEPT", "MASTER_URL_ENV", "WORKER_ID_ENV",
             "FAULT_INJECT_ENV", "WORKER_CHECK_INTERVAL")
    assert {n: getattr(TC, n) for n in names} \
        == {n: getattr(JC, n) for n in names}


@pytest.mark.parametrize("raw", ['{"stall_s": 20}', '{"drop_tiles_after": 0}',
                                 "[1, 2]", "not json", ""])
def test_fault_injection_parses_as_the_jax_package(raw):
    assert tcl.fault_injection(raw) == jcl.fault_injection(raw)


def test_states_and_the_fault_error_match_the_jax_package():
    assert issubclass(tcl.ClusterFaultError, RuntimeError)
    assert (tcl.HEALTHY, tcl.SUSPECT, tcl.DEAD, tcl.UNKNOWN) \
        == (jcl.HEALTHY, jcl.SUSPECT, jcl.DEAD, jcl.UNKNOWN)
