"""The port's SLO burn-rate engine (``utils/slo.py``) and its surfaces in
the server, on the CPU.

``TestSloSpec`` and ``TestSloEngine`` mirror those of
``tests/test_capture_plane.py``.  The parity tests hand the JAX
package's ``utils/slo.py`` and the port's the same spec and the same
samples, made from a numpy seed: the parsed objectives (``to_dict``) and
``evaluate()`` must be equal to the float.  The server tests run prompts
through a port server (a trivial graph that succeeds, one that fails)
and read ``/distributed/slo``, the ``slo`` block of the metrics, the
Prometheus gauges, the ``slo_breach`` span, the reset and ``cli slo``."""

import io
import json
import threading
import time
from contextlib import redirect_stdout

import numpy as np
import pytest

from comfyui_distributed_tpu.utils import slo as jslo
from comfyui_distributed_tpu_torch import cli
from comfyui_distributed_tpu_torch.server.app import ServerState, make_server
from comfyui_distributed_tpu_torch.utils import constants as C
from comfyui_distributed_tpu_torch.utils import net
from comfyui_distributed_tpu_torch.utils import slo as slo_mod
from comfyui_distributed_tpu_torch.utils import trace as tr


class TestSloSpec:
    def test_parse_grammar(self):
        spec = slo_mod.parse_slo_spec(
            "paid:p95<2s,completion>0.999;free:p99<500ms")
        assert set(spec) == {"paid", "free"}
        lat, comp = spec["paid"]
        assert lat.kind == "latency" and lat.quantile == 0.95
        assert lat.threshold_s == 2.0
        assert abs(lat.budget_frac - 0.05) < 1e-9
        assert comp.kind == "completion" and comp.min_ratio == 0.999
        assert abs(comp.budget_frac - 0.001) < 1e-9
        assert spec["free"][0].threshold_s == 0.5

    def test_malformed_clauses_skipped_not_fatal(self):
        spec = slo_mod.parse_slo_spec(
            "paid:p95<2s;bogus;free:pXX<1s,completion>0.99;:p95<1s")
        assert set(spec) == {"paid", "free"}
        assert [o.raw for o in spec["free"]] == ["completion>0.99"]
        assert slo_mod.parse_slo_spec(None) == {}
        assert slo_mod.parse_slo_spec("") == {}

    def test_out_of_range_objectives_rejected(self):
        assert slo_mod.parse_slo_spec("a:p0<1s") == {}
        assert slo_mod.parse_slo_spec("a:completion>1.0") == {}
        assert slo_mod.parse_slo_spec("a:p95<0s") == {}


class TestSloEngine:
    @staticmethod
    def _engine(spec="paid:p95<1s,completion>0.99"):
        return slo_mod.SLOEngine(slo_mod.parse_slo_spec(spec),
                                 fast_s=10.0, slow_s=100.0)

    def test_burn_rate_math_latency(self):
        eng = self._engine()
        for i in range(20):         # 2 of 20 slow: 10% bad on a 5% budget
            eng.record("paid", 2.0 if i < 2 else 0.1, True, now=1000.0)
        assert abs(eng.burn_rate("paid", "fast", now=1000.0) - 2.0) < 1e-9

    def test_burn_rate_math_completion(self):
        eng = self._engine("paid:completion>0.9")
        for i in range(10):         # 2 of 10 failed: 20% on a 10% budget
            eng.record("paid", 0.1, i >= 2, now=1000.0)
        assert abs(eng.burn_rate("paid", "fast", now=1000.0) - 2.0) < 1e-9

    def test_every_sample_bad_burns_one_over_the_budget(self):
        """The card's drill: every paid request over p95<0.1s burns 20,
        the completion objective 0, the free class 0."""
        eng = slo_mod.SLOEngine(slo_mod.parse_slo_spec(
            "paid:p95<0.1s,completion>0.99;free:p95<60s"))
        for d in (4.2, 6.0, 5.5):
            eng.record("paid", d, True, now=50.0)
        for d in (1.1, 0.9):
            eng.record("free", d, True, now=50.0)
        snap = eng.evaluate(now=50.0)
        fast = snap["tenants"]["paid"]["windows"]["fast"]
        assert fast["burn_rates"] == {"p95<0.1s": 20.0,
                                      "completion>0.99": 0.0}
        assert snap["tenants"]["free"]["windows"]["fast"]["burn_rate"] == 0

    def test_window_pruning_decays_burn(self):
        eng = self._engine()
        for _ in range(10):
            eng.record("paid", 5.0, True, now=1000.0)
        assert eng.burn_rate("paid", "fast", now=1000.0) > 1.0
        assert eng.burn_rate("paid", "fast", now=1011.0) == 0.0
        assert eng.burn_rate("paid", "slow", now=1011.0) > 1.0

    def test_evaluate_shape_and_budget(self):
        eng = self._engine()
        for _ in range(4):
            eng.record("paid", 5.0, True, now=1000.0)
        snap = eng.evaluate(now=1000.0)
        assert snap["enabled"] is True
        t = snap["tenants"]["paid"]
        assert [o["raw"] for o in t["objectives"]] \
            == ["p95<1s", "completion>0.99"]
        fast = t["windows"]["fast"]
        assert fast["count"] == 4 and fast["ok_ratio"] == 1.0
        assert fast["burn_rate"] == fast["burn_rates"]["p95<1s"] > 1.0
        assert t["budget_remaining"] == 0.0
        eng.record("mystery", 0.1, True, now=1000.0)
        assert eng.evaluate(now=1000.0)["tenants"]["mystery"][
            "objectives"] == []

    def test_latency_threshold_is_tightest(self):
        eng = self._engine("paid:p95<2s,p99<5s,completion>0.9")
        assert eng.latency_threshold("paid") == 2.0
        assert eng.latency_threshold("free") is None

    def test_disarmed_engine_is_noop(self):
        eng = slo_mod.SLOEngine({})
        assert not eng.enabled
        eng.record("paid", 9.0, False)
        assert eng.evaluate()["tenants"] == {}
        assert eng.burn_rate("paid") == 0.0
        assert eng.prom_families() == []

    def test_prom_families_and_reset(self):
        eng = self._engine()
        eng.record("paid", 5.0, True, now=1000.0)
        fams = eng.prom_families()
        assert [f[0] for f in fams] == ["dtpu_slo_burn_rate",
                                        "dtpu_slo_budget_remaining"]
        assert {tuple(sorted(lbl.items())) for lbl, _ in fams[0][3]} \
            == {(("tenant", "paid"), ("window", "fast")),
                (("tenant", "paid"), ("window", "slow"))}
        eng.reset()
        assert eng.evaluate(now=1000.0)["tenants"]["paid"]["windows"][
            "fast"]["count"] == 0

    def test_from_env(self, monkeypatch):
        monkeypatch.setenv(C.SLO_SPEC_ENV, "paid:p95<2s")
        monkeypatch.setenv(C.SLO_FAST_WINDOW_ENV, "7")
        monkeypatch.setenv(C.SLO_SLOW_WINDOW_ENV, "70")
        eng = slo_mod.SLOEngine.from_env()
        assert eng.enabled and eng.fast_s == 7.0 and eng.slow_s == 70.0

    def test_autoscale_arming(self, monkeypatch):
        monkeypatch.delenv(C.AUTOSCALE_SLO_ENV, raising=False)
        assert not slo_mod.autoscale_slo_armed()
        monkeypatch.setenv(C.AUTOSCALE_SLO_ENV, "1")
        assert slo_mod.autoscale_slo_armed()


# --- parity with the JAX package ---------------------------------------------

SPECS = ["paid:p95<2s,completion>0.999;free:p99<500ms",
         "paid:p95<0.1s,completion>0.99;free:p95<60s",
         "batch:p50<1.5,p90<3s;paid:completion>0.9;bogus;free:pXX<1s",
         "a:p99.9<250ms,completion>0.5;b:completion>0.95"]


@pytest.mark.parametrize("spec", SPECS)
def test_spec_parses_to_the_jax_objectives(spec):
    port, ref = slo_mod.parse_slo_spec(spec), jslo.parse_slo_spec(spec)
    assert {c: [o.to_dict() for o in objs] for c, objs in port.items()} \
        == {c: [o.to_dict() for o in objs] for c, objs in ref.items()}
    assert {c: slo_mod.SLOEngine(port).latency_threshold(c) for c in port} \
        == {c: jslo.SLOEngine(ref).latency_threshold(c) for c in ref}


@pytest.mark.parametrize("seed,spec", [(0, SPECS[0]), (1, SPECS[1]),
                                       (2, SPECS[2]), (3, SPECS[3])])
def test_evaluate_equals_the_jax_engine(seed, spec):
    rng = np.random.default_rng(seed)
    port = slo_mod.SLOEngine(slo_mod.parse_slo_spec(spec), fast_s=30.0,
                             slow_s=300.0)
    ref = jslo.SLOEngine(jslo.parse_slo_spec(spec), fast_s=30.0,
                         slow_s=300.0)
    tenants = ["paid", "free", "batch", "a", "b", "other"]
    now = 1000.0
    for i in range(600):
        now += float(rng.exponential(0.8))
        t = tenants[int(rng.integers(len(tenants)))]
        dur = float(rng.lognormal(-0.5, 1.2))
        ok = bool(rng.uniform() > 0.05)
        port.record(t, dur, ok, now=now)
        ref.record(t, dur, ok, now=now)
        if i % 97 == 0:
            assert port.evaluate(now=now) == ref.evaluate(now=now)
    for later in (now, now + 45.0, now + 400.0):
        assert port.evaluate(now=later) == ref.evaluate(now=later)
        for t in tenants:
            for w in ("fast", "slow"):
                assert port.burn_rate(t, w, now=later) \
                    == ref.burn_rate(t, w, now=later)


# --- the server's surfaces ------------------------------------------------------

OK_PROMPT = {"1": {"class_type": "EmptyLatentImage",
                   "inputs": {"width": 8, "height": 8, "batch_size": 1}}}
BAD_PROMPT = {"1": {"class_type": "NoSuchOp"}}


@pytest.fixture
def slo_server(tmp_path, monkeypatch):
    # a 10 us bar no prompt can meet: admission to its finalize alone
    # takes longer
    monkeypatch.setenv(C.SLO_SPEC_ENV,
                       "paid:p95<0.01ms,completion>0.5;free:p95<60s")
    tr.GLOBAL_TRACES.reset()
    st = ServerState(config_path=str(tmp_path / "cfg.json"), device="cpu",
                     input_dir=str(tmp_path / "in"),
                     output_dir=str(tmp_path / "out"))
    srv = make_server(st, "127.0.0.1", 0)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    yield st, f"http://127.0.0.1:{st.port}"
    srv.shutdown()
    srv.server_close()


def _run(url, prompt, **kw):
    pid = net.post_json(url + "/prompt", {"prompt": prompt, **kw})[
        "prompt_id"]
    deadline = time.monotonic() + 30
    while time.monotonic() < deadline:
        hist = net.get_json(url + "/history")
        if pid in hist:
            return pid, hist[pid]
        time.sleep(0.02)
    raise AssertionError(f"{pid} never finished")


def test_slo_route_metrics_breach_and_reset(slo_server):
    st, url = slo_server
    pid, h = _run(url, OK_PROMPT)
    assert h["status"] == "success" and h["tenant"] == "paid"
    # a failed prompt counts against the completion objective
    _run(url, BAD_PROMPT)
    free_pid, h = _run(url, OK_PROMPT, priority="free")
    assert h["tenant"] == "free"

    slo = net.get_json(url + "/distributed/slo")
    assert slo["enabled"] is True
    paid = slo["tenants"]["paid"]["windows"]["fast"]
    assert paid["count"] == 2 and paid["ok_ratio"] == 0.5
    # every paid sample is over 10 us: 1.0 bad on a 0.05 budget
    assert paid["burn_rates"] == {"p95<0.01ms": 20.0,
                                  "completion>0.5": 1.0}
    assert slo["tenants"]["free"]["windows"]["fast"]["burn_rate"] == 0.0
    assert net.get_json(url + "/distributed/metrics")["slo"]["tenants"][
        "paid"]["windows"]["fast"]["count"] == 2

    rec = tr.GLOBAL_TRACES.get(pid)
    breach = [s for s in rec["spans"] if s["name"] == "slo_breach"]
    assert len(breach) == 1
    assert breach[0]["attrs"] == {"tenant": "paid", "threshold_s": 1e-05}
    root = [s for s in rec["spans"] if s["name"] == "job"][0]
    assert root["attrs"]["tenant"] == "paid"
    assert not [s for s in tr.GLOBAL_TRACES.get(free_pid)["spans"]
                if s["name"] == "slo_breach"]

    import urllib.request
    with urllib.request.urlopen(url + "/distributed/metrics.prom") as r:
        text = r.read().decode()
    assert "# TYPE dtpu_slo_burn_rate gauge" in text
    assert 'dtpu_slo_burn_rate{tenant="paid",window="fast"} 20' in text
    assert 'dtpu_slo_budget_remaining{tenant="paid"} 0' in text
    assert 'dtpu_tenant_completed_total{tenant="paid"} 1' in text

    out = io.StringIO()
    with redirect_stdout(out):
        assert cli.main(["slo", "--url", url]) == 0
    text = out.getvalue()
    assert "paid: p95<0.01ms, completion>0.5" in text
    assert "burn=20.00  BURNING" in text
    out = io.StringIO()
    with redirect_stdout(out):
        assert cli.main(["slo", "--url", url, "--json"]) == 0
    assert json.loads(out.getvalue()) == net.get_json(
        url + "/distributed/slo")

    cleared = net.post_json(url + "/distributed/metrics/reset", {})[
        "cleared"]
    assert cleared["slo_windows"] is True
    assert net.get_json(url + "/distributed/slo")["tenants"]["paid"][
        "windows"]["fast"]["count"] == 0


def test_slo_off_by_default(tmp_path, monkeypatch):
    monkeypatch.delenv(C.SLO_SPEC_ENV, raising=False)
    st = ServerState(config_path=str(tmp_path / "cfg.json"), device="cpu",
                     start_exec_thread=False)
    assert st.slo.evaluate()["enabled"] is False
    out = io.StringIO()
    srv = make_server(st, "127.0.0.1", 0)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    try:
        with redirect_stdout(out):
            assert cli.main(["slo", "--url",
                             f"http://127.0.0.1:{st.port}"]) == 0
    finally:
        srv.shutdown()
        srv.server_close()
    assert "slo engine off" in out.getvalue()
