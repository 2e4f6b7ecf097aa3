"""The port's tracing module (``comfyui_distributed_tpu_torch/utils/
trace.py``) against the JAX package's ``utils/trace.py``.

The same samples, drawn from a numpy seed, go into both packages'
``LatencyHistogram``, ``PhaseStats`` and ``CounterStats``: their
snapshots must be equal (floats within 1e-12).  Both packages'
Prometheus text must be byte-equal family by family over the families
both emit; the JAX package's own families are the jit-trace and
XLA-compile counters (``JAX_ONLY_FAMILIES``).  Each package's
``traceparent`` parses in the other, and both refuse the same malformed
headers.  The flight recorder's eviction, ingest dedupe, provisional
replacement and span cap, and ``build_span_tree``, give equal results
on the same span dicts.  The device profile runs on ``torch.profiler``:
its start, stop and status, and a failed stop that clears the state."""

import json
import os
import pathlib
import subprocess
import sys
import threading

import numpy as np
import pytest

from comfyui_distributed_tpu.utils import trace as jtr
from comfyui_distributed_tpu_torch.utils import constants as TC
from comfyui_distributed_tpu_torch.utils import log as tlog
from comfyui_distributed_tpu_torch.utils import trace as ttr

ROOT = pathlib.Path(__file__).resolve().parents[1]
FLOAT_TOL = 1e-12
# families the JAX package emits and the port has no counterpart for
JAX_ONLY_FAMILIES = {"dtpu_jit_traces_total", "dtpu_xla_compiles_total"}


def _close(a, b):
    """Equal dicts/lists, floats within FLOAT_TOL."""
    if isinstance(a, dict):
        return isinstance(b, dict) and a.keys() == b.keys() and all(
            _close(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return isinstance(b, (list, tuple)) and len(a) == len(b) and all(
            _close(x, y) for x, y in zip(a, b))
    if isinstance(a, float) or isinstance(b, float):
        return a == b or abs(float(a) - float(b)) <= FLOAT_TOL
    return a == b


def _samples(seed, n=400):
    rng = np.random.default_rng(seed)
    # spread over every bucket and past the last (the overflow)
    return [float(x) for x in np.exp(rng.uniform(np.log(2e-4),
                                                 np.log(120.0), n))]


@pytest.fixture
def fresh(monkeypatch):
    """Fresh aggregates and recorders in both packages for the test."""
    for mod in (jtr, ttr):
        monkeypatch.setattr(mod, "GLOBAL_PHASES", mod.PhaseStats())
        monkeypatch.setattr(mod, "GLOBAL_STAGES", mod.PhaseStats())
        monkeypatch.setattr(mod, "GLOBAL_NODES", mod.PhaseStats())
        monkeypatch.setattr(mod, "GLOBAL_COUNTERS", mod.CounterStats())
        monkeypatch.setattr(mod, "GLOBAL_GAUGES", mod.GaugeStats())
        monkeypatch.setattr(mod, "GLOBAL_TRANSFERS", mod.TransferStats())
        monkeypatch.setattr(mod, "GLOBAL_TRACES",
                            mod.FlightRecorder(max_traces=8))
    yield


# --- histograms, stats and the Prometheus text ---------------------------------

@pytest.mark.parametrize("seed", [0, 1, 2])
def test_latency_histogram_matches(seed):
    j, t = jtr.LatencyHistogram(), ttr.LatencyHistogram()
    assert t.bounds == j.bounds == TC.HISTOGRAM_BUCKETS_S
    for x in _samples(seed):
        j.record(x)
        t.record(x)
    assert _close(t.snapshot(), j.snapshot())
    assert _close(t.cumulative(), j.cumulative())
    for q in (0.0, 0.1, 0.5, 0.9, 0.95, 0.99, 1.0):
        assert abs(t.percentile(q) - j.percentile(q)) <= FLOAT_TOL


def test_empty_histogram_and_negative_samples_match():
    j, t = jtr.LatencyHistogram(), ttr.LatencyHistogram()
    assert _close(t.snapshot(), j.snapshot())
    j.record(-1.0)
    t.record(-1.0)
    assert _close(t.snapshot(), j.snapshot())


@pytest.mark.parametrize("seed", [3, 4])
def test_phase_and_counter_stats_match(seed):
    rng = np.random.default_rng(seed)
    names = ["ksampler", "vae_decode", "tile_blend", "collect"]
    jp, tp = jtr.PhaseStats(), ttr.PhaseStats()
    jc, tc = jtr.CounterStats(), ttr.CounterStats()
    for x in _samples(seed, 200):
        name = names[int(rng.integers(len(names)))]
        jp.record(name, x)
        tp.record(name, x)
        k = int(rng.integers(1, 5))
        jc.bump(name, k)
        tc.bump(name, k)
    assert _close(tp.snapshot(), jp.snapshot())
    assert tc.snapshot() == jc.snapshot()
    assert tc.get("collect") == jc.get("collect")
    tp.reset()
    tc.reset()
    assert tp.snapshot() == {} and tc.snapshot() == {}


def _families(text):
    """Prometheus text -> {family: its lines, in order}."""
    out, cur = {}, None
    for ln in text.splitlines():
        if ln.startswith("# HELP "):
            cur = ln.split()[2]
            out[cur] = [ln]
        else:
            out[cur].append(ln)
    return out


def _feed(mod, seed):
    rng = np.random.default_rng(seed)
    for x in _samples(seed, 120):
        mod.GLOBAL_STAGES.record(["compute", "encode", "queue_wait"][
            int(rng.integers(3))], x)
        mod.GLOBAL_PHASES.record(["tile_blend", "vae_decode"][
            int(rng.integers(2))], x)
        mod.GLOBAL_NODES.record(["KSampler", "VAEDecode", "SaveImage"][
            int(rng.integers(3))], x)
    for k in range(7):
        mod.GLOBAL_COUNTERS.bump(f"event_{k % 3}", int(rng.integers(1, 9)))
    with mod.node_scope("7"):
        mod.record_transfer("d2h", 4096)
        mod.record_transfer("h2d", 1000)
    mod.record_transfer("d2h", 17)


@pytest.mark.parametrize("seed", [5, 6])
def test_prometheus_text_matches_family_by_family(fresh, seed):
    for mod in (jtr, ttr):
        _feed(mod, seed)
        mod.GLOBAL_TRACES.commit("p1", "t" * 32, root_span_id=None)
    extra = [("dtpu_queue_remaining", "gauge", "Prompts queued.",
              [({}, 3)]),
             ("dtpu_cluster_workers", "gauge", "By \"state\"\\n.",
              [({"state": "healthy"}, 2), ({"state": 'a"b\\c'}, 0.5)])]
    j = _families(jtr.prometheus_text(extra=extra))
    t = _families(ttr.prometheus_text(extra=extra))
    assert set(j) - set(t) == JAX_ONLY_FAMILIES
    assert set(t) <= set(j)
    for fam in t:
        assert t[fam] == j[fam], fam
    assert ttr.render_prom_families(extra) \
        == jtr.render_prom_families(extra)
    assert ttr.counters_snapshot() == {
        "transfers": jtr.counters_snapshot()["transfers"]}
    assert ttr.GLOBAL_TRANSFERS.total("d2h") == 4113


def test_histogram_exemplars_render_alike(fresh):
    for mod in (jtr, ttr):
        mod.GLOBAL_STAGES.record("job_e2e", 0.3, trace_id="ab" * 16)
    jt = [ln for ln in jtr.prometheus_text().splitlines() if " # {" in ln]
    tt = [ln for ln in ttr.prometheus_text().splitlines() if " # {" in ln]
    assert len(jt) == len(tt) == 1
    # the exemplar's wall-clock stamp differs; the rest is the same
    assert jt[0].rsplit(" ", 1)[0] == tt[0].rsplit(" ", 1)[0]


def test_reset_aggregate_metrics_matches(fresh):
    for mod in (jtr, ttr):
        _feed(mod, 7)
    assert ttr.reset_aggregate_metrics() == jtr.reset_aggregate_metrics()
    assert ttr.GLOBAL_PHASES.snapshot() == {} \
        and ttr.GLOBAL_TRANSFERS.snapshot() == {}


# --- traceparent ------------------------------------------------------------------

def test_traceparent_crosses_the_packages():
    for a, b in ((jtr, ttr), (ttr, jtr)):
        sp = a.Span("dispatch")
        header = a.format_traceparent(sp)
        assert b.parse_traceparent(header) == (sp.trace_id, sp.span_id)
        assert b.parse_traceparent(header) == a.parse_traceparent(header)


@pytest.mark.parametrize("header", [
    None, "", "00", "00-abc-def-01", "00-" + "0" * 32 + "-" + "1" * 16 + "-01",
    "00-" + "1" * 32 + "-" + "0" * 16 + "-01",
    "00-" + "g" * 32 + "-" + "1" * 16 + "-01",
    "00-" + "1" * 31 + "-" + "1" * 16 + "-01",
    "00-" + "1" * 32 + "-" + "1" * 17 + "-01",
    "00-" + "1" * 32 + "-" + "1" * 16])
def test_malformed_traceparents_are_refused_by_both(header):
    assert jtr.parse_traceparent(header) is None
    assert ttr.parse_traceparent(header) is None


def test_traceparent_headers_follow_the_current_span():
    assert ttr.traceparent_headers() == {}
    root = ttr.start_span("job")
    with ttr.use_span(root):
        with ttr.span("dispatch") as sp:
            h = ttr.traceparent_headers()
            assert h == {TC.TRACEPARENT_HEADER: ttr.format_traceparent(sp)}
            assert jtr.parse_traceparent(h["traceparent"]) \
                == (root.trace_id, sp.span_id)
    root.end()


# --- span context ------------------------------------------------------------------

def test_span_context_crosses_a_thread():
    root = ttr.start_span("job", attrs={"prompt_id": "p_t"})
    with ttr.use_span(root):
        captured = ttr.capture_span_context()
        seen = {}

        def work():
            with ttr.use_span(captured), ttr.span("encode") as sp:
                seen["span"] = sp
                seen["ids"] = ttr.current_trace_ids()
        th = threading.Thread(target=work)
        th.start()
        th.join()
    root.end()
    assert seen["span"].parent_id == root.span_id
    assert seen["ids"]["prompt_id"] == "p_t"
    assert seen["ids"]["trace_id"] == root.trace_id


def test_tracing_off_is_a_no_op(monkeypatch):
    was = ttr.tracing_enabled()
    ttr.set_tracing(False)
    try:
        assert ttr.start_span("job") is None
        with ttr.use_span(None), ttr.span("execute") as sp:
            assert sp is None
        assert ttr.event_span("queue_wait", 0.0, 1.0,
                              trace_id="a" * 32) is None
        assert ttr.traceparent_headers() == {}
        # the aggregates still record
        ttr.GLOBAL_STAGES.reset()
        with ttr.stage("encode"):
            pass
        assert ttr.GLOBAL_STAGES.snapshot()["encode"]["count"] == 1
    finally:
        ttr.set_tracing(was)


@pytest.mark.parametrize("value,enabled", [("0", False), ("off", False),
                                           ("false", False), ("1", True),
                                           (None, True)])
def test_dtpu_trace_sets_the_start_value(value, enabled):
    """``DTPU_TRACE`` (the JAX package's name) is read at import."""
    env = {k: v for k, v in os.environ.items() if k != TC.TRACE_ENV}
    if value is not None:
        env[TC.TRACE_ENV] = value
    code = ("from comfyui_distributed_tpu_torch.utils import trace\n"
            "print(trace.tracing_enabled(), trace.start_span('job') "
            "is not None)")
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=60)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == [str(enabled)] * 2
    assert TC.TRACE_ENV == jtr.C.TRACE_ENV == "DTPU_TRACE"


# --- the flight recorder ----------------------------------------------------------

def _span(rng, trace_id, parent=None, name="s", start=None):
    sid = "%016x" % int(rng.integers(1, 2 ** 62))
    st = float(start if start is not None else rng.uniform(0, 10))
    return {"trace_id": trace_id, "span_id": sid, "parent_id": parent,
            "name": name, "start_s": round(st, 6),
            "end_s": round(st + 1.0, 6), "duration_s": 1.0,
            "status": "ok"}


def _strip(rec):
    """A recorder record without its wall-clock stamp."""
    if rec is None:
        return None
    return {k: v for k, v in rec.items() if k != "finished_at"}


def _ops(seed):
    """One sequence of recorder operations from ``seed``."""
    rng = np.random.default_rng(seed)
    ops = []
    tids = ["%032x" % int(rng.integers(1, 2 ** 62)) for _ in range(6)]
    for k, tid in enumerate(tids):
        root = _span(rng, tid, name="job")
        kids = [_span(rng, tid, parent=root["span_id"],
                      name=f"n{i}") for i in range(int(rng.integers(1, 7)))]
        ops.append(("add", tid, root))
        ops.append(("ingest", [*kids, {"bad": 1}, "junk"]))
        # a provisional version of a child, then its final one again
        prov = {**kids[0], "end_s": kids[0]["end_s"] + 5,
                "provisional": True}
        ops.append(("ingest", [prov]))
        ops.append(("ingest", [kids[0]]))
        ops.append(("commit", f"p{k}", tid, root["span_id"]))
        # a late arrival after the commit
        ops.append(("add", tid, _span(rng, tid, parent=root["span_id"],
                                      name="late")))
    # one trace committed twice under two prompt ids (loopback)
    ops.append(("commit", "p_again", tids[-1], None))
    return ops, tids


def _apply(mod, ops, max_traces=4, max_spans=5):
    rec = mod.FlightRecorder(max_traces=max_traces, max_spans=max_spans)
    for op in ops:
        if op[0] == "add":
            rec.add(op[1], dict(op[2]))
        elif op[0] == "ingest":
            rec.ingest([dict(d) if isinstance(d, dict) else d
                        for d in op[1]])
        else:
            rec.commit(op[1], op[2], root_span_id=op[3], duration_s=1.5)
    return rec


@pytest.mark.parametrize("seed", [10, 11, 12])
def test_flight_recorder_matches(monkeypatch, seed):
    # the commit taps (capture files, analyzer) are off in both
    monkeypatch.delenv(TC.TRACE_EXPORT_DIR_ENV, raising=False)
    monkeypatch.delenv(TC.ANALYSIS_BASELINE_ENV, raising=False)
    ops, tids = _ops(seed)
    j, t = _apply(jtr, ops), _apply(ttr, ops)
    assert t.size() == j.size() == 4
    assert t.eviction_count() == j.eviction_count() == 3
    assert t.dropped_spans == j.dropped_spans
    strip = [{k: v for k, v in r.items() if k != "finished_at"}
             for r in t.index()]
    assert strip == [{k: v for k, v in r.items() if k != "finished_at"}
                     for r in j.index()]
    for pid in [f"p{k}" for k in range(6)] + ["p_again"]:
        assert _strip(t.get(pid)) == _strip(j.get(pid)), pid
    for tid in tids:
        assert t.export(tid) == j.export(tid)
        assert t.breakdown(tid) == j.breakdown(tid)
    assert [_strip(r) for r in t.records()] \
        == [_strip(r) for r in j.records()]
    t.reset()
    assert t.size() == 0 and t.dropped_spans == 0


def test_open_spans_export_provisionally_in_both(monkeypatch):
    for mod in (jtr, ttr):
        rec = mod.FlightRecorder(max_traces=4)
        monkeypatch.setattr(mod, "GLOBAL_TRACES", rec)
        root = mod.start_span("job")
        with mod.use_span(root):
            with mod.span("encode"):
                pass
            with mod.span("execute"):
                out = rec.export(root.trace_id)
        root.end()
        assert sorted((s["name"], bool(s.get("provisional")))
                      for s in out) == [("encode", False),
                                        ("execute", True), ("job", True)]
        assert [s["name"] for s in rec.export(root.trace_id)] \
            == ["encode", "execute", "job"]


@pytest.mark.parametrize("seed", [20, 21])
def test_build_span_tree_matches(seed):
    rng = np.random.default_rng(seed)
    tid = "c" * 32
    spans = [_span(rng, tid, name="root")]
    for i in range(12):
        parent = spans[int(rng.integers(len(spans)))]["span_id"]
        spans.append(_span(rng, tid, parent=parent, name=f"s{i}"))
    spans.append(_span(rng, tid, parent="f" * 16, name="orphan"))
    rng.shuffle(spans)
    assert json.dumps(ttr.build_span_tree(spans)) \
        == json.dumps(jtr.build_span_tree(spans))
    assert sorted(r["name"] for r in ttr.build_span_tree(spans)) \
        == ["orphan", "root"]


def test_event_span_matches_in_shape(fresh):
    for mod in (jtr, ttr):
        root = mod.start_span("job")
        d = mod.event_span("queue_wait", 1.0, 1.25, parent=root,
                           attrs={"job": "j"})
        assert {k: v for k, v in d.items() if k != "span_id"} == {
            "trace_id": root.trace_id, "parent_id": root.span_id,
            "name": "queue_wait", "start_s": 1.0, "end_s": 1.25,
            "duration_s": 0.25, "status": "ok", "attrs": {"job": "j"}}
        root.end()


# --- log lines and the Timer ------------------------------------------------------

def test_json_log_lines_carry_the_trace_ids(capsys):
    was = tlog.json_logs_enabled()
    tlog.set_json_logs(True)
    try:
        root = ttr.start_span("job", attrs={"prompt_id": "p_json"})
        with ttr.use_span(root):
            tlog.log("hello")
        root.end()
        tlog.log("outside")
    finally:
        tlog.set_json_logs(was)
    lines = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()]
    assert lines[0]["msg"] == "hello" and lines[0]["level"] == "info"
    assert lines[0]["trace_id"] == root.trace_id
    assert lines[0]["prompt_id"] == "p_json"
    assert lines[1]["msg"] == "outside" and "trace_id" not in lines[1]
    tlog.log("plain")
    assert capsys.readouterr().out == "dtpu-torch plain\n"


def test_timer_feeds_the_phases(fresh):
    with tlog.Timer("vae_decode") as t:
        pass
    snap = ttr.GLOBAL_PHASES.snapshot()["vae_decode"]
    assert snap["count"] == 1 and abs(snap["total_s"] - t.elapsed_s) < 1e-9


# --- the device profile on torch.profiler ---------------------------------------

def test_profile_start_stop_status(tmp_path):
    assert ttr.trace_status() == {"running": False, "dir": None}
    d = ttr.start_device_trace(str(tmp_path / "p"))
    try:
        with pytest.raises(RuntimeError, match="already running"):
            ttr.start_device_trace(str(tmp_path / "q"))
        assert ttr.trace_status() == {"running": True, "dir": d}
        # CPU work on another thread lands in the profile
        import torch
        th = threading.Thread(target=lambda: torch.ones(64, 64) @ torch.ones(
            64, 64))
        th.start()
        th.join()
    finally:
        assert ttr.stop_device_trace() == d
    assert ttr.trace_status()["running"] is False
    with open(tmp_path / "p" / ttr.TRACE_FILE) as f:
        events = json.load(f)["traceEvents"]
    assert events
    with pytest.raises(RuntimeError, match="no trace running"):
        ttr.stop_device_trace()


def test_a_failed_stop_clears_the_state(tmp_path, monkeypatch):
    ttr.start_device_trace(str(tmp_path / "p"))

    def boom(self, timeout=600.0):
        raise RuntimeError("profiler stop failed: disk full")
    run = ttr._trace_run
    monkeypatch.setattr(type(run), "finish", boom)
    with pytest.raises(RuntimeError, match="disk full"):
        ttr.stop_device_trace()
    assert ttr.trace_status() == {"running": False, "dir": None}
    monkeypatch.undo()
    run.finish()            # the profiler thread ends
    d = ttr.start_device_trace(str(tmp_path / "again"))
    assert ttr.stop_device_trace() == d
