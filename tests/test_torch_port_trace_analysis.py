"""Capture files and critical-path analysis: the port's
``utils/trace_export.py`` and ``utils/trace_analysis.py`` against the
JAX package's.

Records are made from a numpy seed: a fan-out's span forest (a master
job root, its queue wait, preflight and dispatch, a worker's job under
the dispatch with its stages, the master's execute, collect and
finalize), with durations drawn per record.  The JAX package's exporter
writes them to one capture directory and the port's to another; each
package reads the other's (schema 1), and ``load_trace``,
``load_forest`` and ``to_perfetto`` give equal results on both sides.
``critical_path``, ``aggregate``, ``straggler_scorecard``,
``diff_breakdowns`` (the same seed), ``profile_from_breakdowns``,
``detect_anomalies``, ``analyze_records`` and the live analyzer must
give equal results (floats within 1e-12) on the records loaded from one
capture directory.  Rotation and retention leave the same segment files
with the same bytes."""

import json
import os

import numpy as np
import pytest

from comfyui_distributed_tpu.utils import trace_analysis as jan
from comfyui_distributed_tpu.utils import trace_export as jex
from comfyui_distributed_tpu_torch.utils import constants as TC
from comfyui_distributed_tpu_torch.utils import trace_analysis as tan
from comfyui_distributed_tpu_torch.utils import trace_export as tex

FLOAT_TOL = 1e-12


def _close(a, b):
    if isinstance(a, dict):
        return isinstance(b, dict) and a.keys() == b.keys() and all(
            _close(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return isinstance(b, (list, tuple)) and len(a) == len(b) and all(
            _close(x, y) for x, y in zip(a, b))
    if isinstance(a, float) or isinstance(b, float):
        return a == b or abs(float(a) - float(b)) <= FLOAT_TOL
    return a == b


def _sid(rng):
    return "%016x" % int(rng.integers(1, 2 ** 62))


def _record(rng, k, slow_worker=None):
    """One fan-out's committed record: a master root over preflight,
    dispatch (the worker's job under it, the worker's execute, a node and
    its encode/d2h/upload stages), queue_wait, execute with a node and
    collect, finalize, plus a receive event and an unmapped span."""
    tid = "%032x" % int(rng.integers(1, 2 ** 62))
    t0 = 1.7e9 + k * 100.0 + float(rng.uniform(0, 1))
    spans = []

    def add(name, start, dur, parent, **attrs):
        d = {"trace_id": tid, "span_id": _sid(rng),
             "parent_id": parent["span_id"] if parent else None,
             "name": name, "start_s": round(start, 6),
             "end_s": round(start + dur, 6), "duration_s": round(dur, 6),
             "status": "ok"}
        if attrs:
            d["attrs"] = attrs
        spans.append(d)
        return d

    worker = ["w0", "w1", "w2"][k % 3]
    scale = 3.0 if worker == slow_worker else 1.0
    e2e = float(rng.uniform(4.0, 6.0))
    root = add("job", t0, e2e, None, role="master", fanout=True,
               tenant=["paid", "free"][k % 3 == 0], prompt_id=f"p{k}")
    pf = float(rng.uniform(0.01, 0.05))
    add("preflight", t0 + 0.001, pf, root, n_workers=1)
    disp = add("dispatch", t0 + pf + 0.002, float(rng.uniform(0.01, 0.03)),
               root, worker=worker)
    wjob = add("job", disp["start_s"] + 0.005, e2e * 0.6, disp,
               role="worker")
    wexe = add("execute", wjob["start_s"] + 0.01, e2e * 0.55, wjob)
    wcomp = float(rng.uniform(1.0, 2.0)) * scale / 3.0
    add("compute", wexe["start_s"] + 0.02, wcomp, wexe, worker=worker)
    node = add("UltimateSDUpscaleDistributed", wexe["start_s"] + 0.01,
               e2e * 0.5, wexe, node="2")
    for i in range(int(rng.integers(1, 4))):
        s = node["start_s"] + 0.5 + i * 0.3
        add("d2h", s, 0.01, node)
        add("encode", s + 0.01, float(rng.uniform(0.05, 0.1)), node)
        up = add("upload", s + 0.12, float(rng.uniform(0.02, 0.05)), node)
        add("receive_tile", up["start_s"] + 0.005, 0.003, up,
            worker=worker, tile_idx=i)
    qw = float(rng.uniform(0.0, 0.2))
    add("queue_wait", t0 + 0.05, qw, root)
    exe = add("execute", t0 + 0.05 + qw, e2e - 0.3 - qw, root)
    add("UpscaleModelLoader", exe["start_s"] + 0.01, 0.2, exe, node="14")
    col = add("collect", exe["start_s"] + 1.0, float(rng.uniform(1, 2)),
              exe, job=f"exec_{k}", n_workers=1)
    add("reassign", col["start_s"] + 0.1, 0.3, col, job=f"exec_{k}",
        units=2, lost=worker, to="master")
    add("finalize", t0 + e2e - 0.2, 0.1, root)
    add("slo_breach", t0 + e2e, 0.0, root, threshold_s=1.0)
    return {"prompt_id": f"p{k}", "trace_id": tid, "status": "ok",
            "root_span_id": root["span_id"], "duration_s": round(e2e, 6),
            "finished_at": t0 + e2e, "spans": spans}


def _records(seed, n=12, slow_worker=None):
    rng = np.random.default_rng(seed)
    return [_record(rng, k, slow_worker) for k in range(n)]


@pytest.fixture
def captures(tmp_path, monkeypatch):
    """The same records through the JAX exporter (dir "jax") and the
    port's (dir "port")."""
    monkeypatch.delenv(TC.TRACE_EXPORT_DIR_ENV, raising=False)
    recs = _records(0)

    def write(mod, d):
        exp = mod.TraceExporter(str(d), segment_bytes=20_000,
                                retain_bytes=10 ** 9)
        for r in recs:
            assert exp.export(r)
        exp.close()
        return exp.stats()
    return recs, {"jax": (tmp_path / "jax", write(jex, tmp_path / "jax")),
                  "port": (tmp_path / "port", write(tex, tmp_path / "port"))}


# --- capture files -------------------------------------------------------------------

def test_capture_files_are_the_same_bytes(captures):
    recs, dirs = captures
    (jd, js), (td, ts) = dirs["jax"], dirs["port"]
    assert {k: v for k, v in ts.items() if k != "dir"} \
        == {k: v for k, v in js.items() if k != "dir"}
    jn = [os.path.basename(p) for p in jex.segment_paths(str(jd))]
    tn = [os.path.basename(p) for p in tex.segment_paths(str(td))]
    assert tn == jn and len(tn) > 1   # rotated
    for name in tn:
        assert (td / name).read_bytes() == (jd / name).read_bytes()


@pytest.mark.parametrize("reader,writer", [("port", "jax"), ("jax", "port")])
def test_each_package_reads_the_others_directory(captures, reader, writer):
    recs, dirs = captures
    d = str(dirs[writer][0])
    rmod, omod = (tex, jex) if reader == "port" else (jex, tex)
    stats_r, stats_o = {}, {}
    got = list(rmod.iter_records(d, stats=stats_r))
    assert got == list(omod.iter_records(d, stats=stats_o))
    assert stats_r == stats_o == {"records": len(recs), "torn_lines": 0,
                                  "unknown_schema": 0, "io_errors": 0}
    assert [{k: v for k, v in r.items() if k != "schema"} for r in got] \
        == recs
    for r in recs[::3]:
        a = rmod.load_trace(d, prompt_id=r["prompt_id"])
        assert a == omod.load_trace(d, prompt_id=r["prompt_id"])
        assert a == rmod.load_trace(d, trace_id=r["trace_id"])
        assert json.dumps(rmod.load_forest(a)) \
            == json.dumps(omod.load_forest(a))
        assert rmod.to_perfetto(a) == omod.to_perfetto(a)
    assert rmod.load_trace(d, prompt_id="nope") is None


def test_torn_lines_and_other_schemas_are_skipped_alike(tmp_path):
    d = tmp_path / "c"
    d.mkdir()
    rec = _records(1, 1)[0]
    (d / f"{TC.TRACE_EXPORT_PREFIX}00000000.jsonl").write_text(
        json.dumps({"schema": 1, **rec}) + "\n"
        + json.dumps({"schema": 2, **rec}) + "\n" + '{"schema": 1, "pro')
    (d / "notes.txt").write_text("not a segment")
    for mod in (tex, jex):
        st = {}
        assert len(list(mod.iter_records(str(d), stats=st))) == 1
        assert st == {"records": 1, "torn_lines": 1, "unknown_schema": 1,
                      "io_errors": 0}


def test_retention_deletes_the_same_oldest_segments(tmp_path):
    recs = _records(2, 20)
    out = {}
    for name, mod in (("jax", jex), ("port", tex)):
        exp = mod.TraceExporter(str(tmp_path / name), segment_bytes=8_000,
                                retain_bytes=30_000)
        for r in recs:
            exp.export(r)
        exp.close()
        out[name] = ([os.path.basename(p) for p in
                      mod.segment_paths(str(tmp_path / name))],
                     {k: v for k, v in exp.stats().items() if k != "dir"})
    assert out["port"] == out["jax"]
    assert out["port"][1]["retired_segments"] > 0


def test_exporter_follows_the_environment(tmp_path, monkeypatch):
    monkeypatch.setenv(TC.TRACE_EXPORT_DIR_ENV, str(tmp_path / "env"))
    rec = _records(3, 1)[0]
    tex.on_commit(rec)
    assert tex.stats()["exported"] == 1
    tex.reset_counters()
    assert tex.stats()["exported"] == 0
    assert jex.load_trace(str(tmp_path / "env"),
                          prompt_id=rec["prompt_id"])["spans"] \
        == rec["spans"]
    monkeypatch.delenv(TC.TRACE_EXPORT_DIR_ENV)
    assert tex.stats() == {"enabled": False}


# --- critical-path analysis ------------------------------------------------------------

def _loaded(captures):
    return list(tex.iter_records(str(captures[1]["jax"][0])))


def _strip(bds):
    return [{k: v for k, v in bd.items() if k != "_rec"} for bd in bds]


def test_constants_match_the_jax_package():
    from comfyui_distributed_tpu.utils import constants as JC
    for name in ("TRACE_ENV", "TRACE_RING_ENV", "TRACE_RING_DEFAULT",
                 "TRACE_MAX_SPANS", "TRACEPARENT_HEADER", "SLOW_JOB_ENV",
                 "LOG_JSON_ENV", "HISTOGRAM_BUCKETS_S",
                 "TRACE_EXPORT_DIR_ENV", "TRACE_EXPORT_SEGMENT_ENV",
                 "TRACE_EXPORT_SEGMENT_DEFAULT", "TRACE_EXPORT_RETAIN_ENV",
                 "TRACE_EXPORT_RETAIN_DEFAULT", "TRACE_EXPORT_SCHEMA",
                 "TRACE_EXPORT_PREFIX", "TRACE_EVICT_LOG_EVERY",
                 "TRACE_EXPORT_DROP_LOG_EVERY", "RESOURCE_ENV",
                 "RES_INTERVAL_ENV", "RES_INTERVAL_DEFAULT", "RES_RING_ENV",
                 "RES_RING_DEFAULT", "RES_FED_TTL_ENV", "RES_FED_TTL_DEFAULT",
                 "ANALYSIS_BASELINE_ENV", "ANALYSIS_ANOMALY_PCT_ENV",
                 "ANALYSIS_ANOMALY_PCT_DEFAULT", "ANALYSIS_STRAGGLER_X_ENV",
                 "ANALYSIS_STRAGGLER_X_DEFAULT", "ANALYSIS_MAX_TRACES_ENV",
                 "ANALYSIS_MAX_TRACES_DEFAULT", "SKEW_CORRECTION_ENV",
                 "SKEW_SAMPLES_KEPT", "TRACE_ATTR_WHITELIST",
                 "METRICS_RESET_ENV"):
        assert getattr(TC, name) == getattr(JC, name), name
    assert tan.CATEGORIES == jan.CATEGORIES
    assert tan.CATEGORY_OF == jan.CATEGORY_OF


def test_critical_path_matches_and_sums_to_the_root(captures):
    for rec in _loaded(captures):
        t, j = tan.critical_path(rec), jan.critical_path(rec)
        assert _close(t, j)
        root = next(s for s in rec["spans"]
                    if s["span_id"] == rec["root_span_id"])
        assert abs(sum(t["categories"].values()) + t["unattributed_s"]
                   - root["duration_s"]) < 1e-5
        assert t["negative_edges"] == 0


def test_critical_path_of_edge_records_matches():
    recs = [{"prompt_id": "e", "trace_id": "t", "spans": []},
            {"prompt_id": "r", "trace_id": "t", "spans": [
                {"span_id": "a", "name": "x", "start_s": 1.0, "end_s": 2.0,
                 "duration_s": 1.0},
                {"span_id": "b", "parent_id": "a", "name": "encode",
                 "start_s": 0.5, "end_s": 1.5, "duration_s": 1.0}]}]
    for rec in recs:
        assert _close(tan.critical_path(rec), jan.critical_path(rec))


@pytest.mark.parametrize("group_by", ["tenant", "signature", "worker"])
def test_aggregate_matches(captures, group_by):
    recs = _loaded(captures)
    t = tan.aggregate(tan.collect_breakdowns(recs), group_by=group_by)
    j = jan.aggregate(jan.collect_breakdowns(recs), group_by=group_by)
    assert _close(t, j) and t


def test_straggler_scorecard_matches():
    recs = _records(4, 16, slow_worker="w1")
    t = tan.straggler_scorecard(tan.collect_breakdowns(recs),
                                threshold_x=1.5)
    j = jan.straggler_scorecard(jan.collect_breakdowns(recs),
                                threshold_x=1.5)
    assert _close(t, j)
    assert t["workers"]["w1"]["straggler"] \
        and not t["workers"]["w0"]["straggler"]


@pytest.mark.parametrize("seed", [0, 7])
def test_diff_breakdowns_matches_with_the_same_seed(seed):
    a = _records(5, 10)
    b = _records(6, 10, slow_worker="w0")
    for rec in b:   # a slower blend in B
        for s in rec["spans"]:
            if s["name"] == "collect":
                s["end_s"] = round(s["end_s"] + 1.0, 6)
                s["duration_s"] = round(s["duration_s"] + 1.0, 6)
    t = tan.diff_breakdowns(tan.collect_breakdowns(a),
                            tan.collect_breakdowns(b), seed=seed,
                            n_resamples=200)
    j = jan.diff_breakdowns(jan.collect_breakdowns(a),
                            jan.collect_breakdowns(b), seed=seed,
                            n_resamples=200)
    assert _close(t, j)
    assert "blend" in t["flagged"] and t["regressed"]


def test_profiles_baselines_and_anomalies_match(captures, tmp_path):
    recs = _loaded(captures)
    tb, jb = tan.collect_breakdowns(recs), jan.collect_breakdowns(recs)
    assert _close(_strip(tb), _strip(jb))
    tp, jp = tan.profile_from_breakdowns(tb), jan.profile_from_breakdowns(jb)
    assert _close(tp, jp)
    tan.save_baseline(tp, str(tmp_path / "t.json"))
    jan.save_baseline(jp, str(tmp_path / "j.json"))
    assert (tmp_path / "t.json").read_text() \
        == (tmp_path / "j.json").read_text()
    base = jan.load_baseline(str(tmp_path / "t.json"))
    assert tan.load_baseline(str(tmp_path / "j.json")) == base
    # a halved baseline makes every category an anomaly; a new category
    # against a baseline that lacks it flags past its share of e2e
    half = {**base, "categories": {k: v / 3 for k, v in
                                   base["categories"].items()
                                   if k != "upload"}}
    for bd_t, bd_j in zip(tb, jb):
        for tol in (None, 10.0, 500.0):
            assert _close(tan.detect_anomalies(bd_t, half, tol),
                          jan.detect_anomalies(bd_j, half, tol))
    assert tan.detect_anomalies(tb[0], half, 10.0)


def test_analyze_records_matches(captures):
    recs = _loaded(captures)
    t, j = tan.analyze_records(recs), jan.analyze_records(recs)
    assert _close(t, j)
    assert t["n_traces"] == len(recs)


def test_the_live_analyzer_matches(captures, tmp_path, monkeypatch):
    recs = _loaded(captures)
    prof = jan.profile_from_breakdowns(jan.collect_breakdowns(recs[:4]))
    prof["categories"] = {k: v * 0.5 for k, v in prof["categories"].items()}
    jan.save_baseline(prof, str(tmp_path / "base.json"))
    monkeypatch.setenv(TC.ANALYSIS_BASELINE_ENV, str(tmp_path / "base.json"))
    t, j = tan.LiveAnalyzer(), jan.LiveAnalyzer()
    assert t.armed() and j.armed()
    for rec in recs:
        t.on_commit(rec)
        j.on_commit(rec)
    assert _close(t.snapshot(), j.snapshot())
    assert t.total() == j.total() > 0
    t.reset()
    assert t.total() == 0
    monkeypatch.delenv(TC.ANALYSIS_BASELINE_ENV)
    assert not t.armed()
    assert t.snapshot()["armed"] is False
