"""The port server's default dispatch model (``server/app.py``,
``utils/net.py``), on the CPU, as the JAX package's
``tests/test_pipeline.py`` holds its own: a burst of signature-equal
prompts coalesces into one dispatch, mixed signatures keep each client's
order, a failure hits only its group, the drain waits for the host pool,
and the finalize of one group overlaps the next group's run.  The
switches (``DTPU_COALESCE``, ``DTPU_OVERLAP``) default on and turn off
as in the JAX package."""

import os
import threading
import time

import numpy as np
import pytest

from comfyui_distributed_tpu.runtime import reuse as jreuse
from comfyui_distributed_tpu_torch.models import registry as treg
from comfyui_distributed_tpu_torch.ops import basic
from comfyui_distributed_tpu_torch.ops.base import OpContext
from comfyui_distributed_tpu_torch.runtime import reuse
from comfyui_distributed_tpu_torch.server.app import ServerState
from comfyui_distributed_tpu_torch.utils import constants as C
from comfyui_distributed_tpu_torch.utils import trace as trace_mod
from comfyui_distributed_tpu_torch.utils.net import HostIOPool
from comfyui_distributed_tpu_torch.workflow.executor import WorkflowExecutor

from test_torch_port_coalesce import make_prompt


@pytest.fixture(autouse=True)
def tiny_and_fresh(monkeypatch):
    """The tiny family, empty reuse planes, and the tiers off: these
    tests count dispatches, which a replay would skip."""
    monkeypatch.setenv("DTPU_DEFAULT_FAMILY", "tiny")
    monkeypatch.setenv(C.CACHE_ENV, "0")
    reuse.reset_reuse()
    jreuse.reset_reuse()
    yield
    treg.clear_pipeline_cache()
    reuse.reset_reuse()


@pytest.fixture
def state(tmp_path):
    made = []

    def make(**kw):
        st = ServerState(config_path=str(tmp_path / "cfg.json"),
                         input_dir=str(tmp_path / "in"),
                         output_dir=str(tmp_path / "out"), device="cpu",
                         **kw)
        made.append(st)
        return st

    yield make
    for st in made:
        st.drain(10)


def wait_history(st, pids, timeout=120):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if all(p in st._history for p in pids):
            return {p: st._history[p] for p in pids}
        time.sleep(0.01)
    raise AssertionError(f"prompts never finished: "
                         f"{[p for p in pids if p not in st._history]}")


def staged_burst(st, prompts, client="c"):
    """Queue a burst behind the held execution gate, so one pop sees it
    whole."""
    st._exec_gate.clear()
    try:
        return [st.enqueue_prompt(p, client_id=client) for p in prompts]
    finally:
        st._exec_gate.set()


def test_switches_default_on_and_turn_off(state, monkeypatch):
    st = state(start_exec_thread=False)
    assert st.coalesce_enabled and st.overlap_enabled
    assert st.coalesce_max == C.COALESCE_MAX_DEFAULT == 8
    assert st.host_pool is not None
    monkeypatch.setenv(C.COALESCE_ENV, "0")
    monkeypatch.setenv(C.OVERLAP_ENV, "0")
    monkeypatch.setenv(C.COALESCE_MAX_ENV, "3")
    off = state(start_exec_thread=False)
    assert not off.coalesce_enabled and not off.overlap_enabled
    assert off.host_pool is None and off.coalesce_max == 3
    off.enqueue_prompt(make_prompt(1))
    assert off._queue[0]["sig"] is None
    assert state(start_exec_thread=False, coalesce=True,
                 overlap=True).coalesce_enabled


def test_burst_coalesces_into_one_dispatch(state):
    """Four signature-equal prompts: one run, each history entry
    ``coalesced: 4``, the counters and one prompt line's launches."""
    st = state()
    wait_history(st, [st.enqueue_prompt(make_prompt(0), client_id="w")])
    runs0 = trace_mod.GLOBAL_COUNTERS.get("exec_runs")
    batches0 = trace_mod.GLOBAL_COUNTERS.get("coalesced_batches")
    prompts0 = trace_mod.GLOBAL_COUNTERS.get("coalesced_prompts")
    pids = staged_burst(st, [make_prompt(100 + i) for i in range(4)])
    hist = wait_history(st, pids)
    assert trace_mod.GLOBAL_COUNTERS.get("exec_runs") - runs0 == 1
    assert trace_mod.GLOBAL_COUNTERS.get("coalesced_batches") \
        - batches0 == 1
    assert trace_mod.GLOBAL_COUNTERS.get("coalesced_prompts") \
        - prompts0 == 4
    for h in hist.values():
        assert h["status"] == "success"
        assert h["coalesced"] == 4 and h["images"] == 1
    assert st.metrics["prompts_executed"] == 5
    # a follower's trace names its head
    rec = trace_mod.GLOBAL_TRACES.get(pids[1])
    root = next(s for s in rec["spans"] if s["name"] == "job")
    assert root["attrs"]["coalesced_into"] == pids[0]
    assert st.drain(10)


def test_coalescing_off_runs_one_prompt_a_dispatch(state, monkeypatch):
    monkeypatch.setenv(C.COALESCE_ENV, "0")
    st = state()
    runs0 = trace_mod.GLOBAL_COUNTERS.get("exec_runs")
    hist = wait_history(st, staged_burst(
        st, [make_prompt(200 + i) for i in range(3)]))
    assert trace_mod.GLOBAL_COUNTERS.get("exec_runs") - runs0 == 3
    assert all("coalesced" not in h for h in hist.values())


def test_the_cap_splits_a_burst(state, monkeypatch):
    monkeypatch.setenv(C.COALESCE_MAX_ENV, "2")
    st = state()
    hist = wait_history(st, staged_burst(
        st, [make_prompt(300 + i) for i in range(3)]))
    assert sorted(h.get("coalesced", 1) for h in hist.values()) == [1, 2, 2]


def test_mixed_signatures_keep_client_order(state):
    """Only a contiguous run coalesces: a later compatible prompt never
    overtakes an incompatible one queued between."""
    st = state()
    wait_history(st, [st.enqueue_prompt(make_prompt(0), client_id="w")])
    a1, b, a2 = staged_burst(st, [make_prompt(1),
                                  make_prompt(2, text="dog"),
                                  make_prompt(3)])
    hist = wait_history(st, [a1, b, a2])
    assert all(h["status"] == "success" for h in hist.values())
    assert all("coalesced" not in h for h in hist.values())
    assert hist[a1]["finished_at"] <= hist[b]["finished_at"] \
        <= hist[a2]["finished_at"]
    assert hist[a1]["started_at"] <= hist[b]["started_at"] \
        <= hist[a2]["started_at"]


def test_failure_hits_only_its_group(state, monkeypatch):
    real = basic.KSampler.execute
    boom = {"on": True}

    def fake(self, ctx, *a, **kw):
        if boom["on"]:
            raise InterruptedError("execution interrupted (test)")
        return real(self, ctx, *a, **kw)

    monkeypatch.setattr(basic.KSampler, "execute", fake)
    st = state()
    hist = wait_history(st, staged_burst(
        st, [make_prompt(400 + i) for i in range(3)]))
    for h in hist.values():
        assert h["status"] == "error" and h["coalesced"] == 3
        assert "interrupted" in h["error"]
    assert st.metrics["prompts_failed"] == 3
    boom["on"] = False
    ok = wait_history(st, [st.enqueue_prompt(make_prompt(7))])
    assert list(ok.values())[0]["status"] == "success"


@pytest.mark.parametrize("overlap", [True, False])
def test_finalize_overlaps_the_next_run(state, monkeypatch, overlap):
    """With the overlap on, the second prompt starts while the first's
    slow PNG write is still running on the host pool; with it off, only
    after the first is settled."""
    real = basic.save_png
    gate = threading.Event()

    def slow_save(path, img, text=None):
        gate.wait(0.8)
        return real(path, img, text)

    monkeypatch.setattr(basic, "save_png", slow_save)
    st = state(overlap=overlap)
    first = st.enqueue_prompt(make_prompt(1, output="SaveImage"))
    second = st.enqueue_prompt(make_prompt(2, text="dog"))
    hist = wait_history(st, [first, second])
    assert hist[first]["status"] == hist[second]["status"] == "success"
    if overlap:
        assert hist[second]["started_at"] < hist[first]["finished_at"]
    else:
        assert hist[second]["started_at"] >= hist[first]["finished_at"]
    assert len(os.listdir(st.output_dir)) == 1


def test_a_warmup_waits_for_the_running_group(state, monkeypatch):
    """A warmup (``/distributed/warmup``, ``DTPU_WARMUP``) posted while
    a group runs starts only after that run's kernel counts and peak
    memory are read, so the group's prompt line counts its own work
    alone."""
    order, started, release = [], threading.Event(), threading.Event()
    real = basic.KSampler.execute

    def held(self, ctx, *a, **kw):
        started.set()
        release.wait(60)
        out = real(self, ctx, *a, **kw)
        order.append("run")
        return out

    real_warmup = treg.DiffusionPipeline.warmup

    def warmup(self, **kw):
        order.append("warmup")
        return real_warmup(self, **kw)

    monkeypatch.setattr(basic.KSampler, "execute", held)
    monkeypatch.setattr(treg.DiffusionPipeline, "warmup", warmup)
    st = state()
    pid = st.enqueue_prompt(make_prompt(5))
    assert started.wait(60)
    got = {}
    t = threading.Thread(target=lambda: got.update(st.warmup(
        "tiny.safetensors", height=32, width=32, steps=1)))
    t.start()
    time.sleep(0.3)
    assert order == []
    release.set()
    t.join(120)
    assert order == ["run", "warmup"]
    assert set(got) == {"clip_s", "sample_s", "vae_s", "total_s"}
    assert wait_history(st, [pid])[pid]["status"] == "success"


def test_drain_waits_for_the_host_pool(state):
    st = state()
    done = []
    st.host_pool.submit(lambda: (time.sleep(0.5), done.append(1)))
    t0 = time.monotonic()
    assert st.drain(10)
    assert done == [1] and time.monotonic() - t0 >= 0.4
    assert st.host_pool.pending == 0


def test_host_pool_bounds_its_pending_tasks():
    """Past ``max_pending`` a submit blocks until a slot frees; each
    task runs in the submitter's span context."""
    pool = HostIOPool(max_workers=1, max_pending=2)
    release = threading.Event()
    pool.submit(release.wait, 5)
    pool.submit(release.wait, 5)
    t = threading.Thread(target=pool.submit, args=(lambda: None,))
    t.start()
    time.sleep(0.2)
    assert t.is_alive() and pool.pending == 2
    release.set()
    t.join(5)
    assert not t.is_alive()
    deadline = time.monotonic() + 5
    while pool.pending:
        assert time.monotonic() < deadline
        time.sleep(0.01)
    sp = trace_mod.start_span("job")
    with trace_mod.use_span(sp):
        fut = pool.submit(trace_mod.current_span)
    assert fut.result(5) is sp
    pool.shutdown()


def test_deferred_output_equals_inline(tmp_path):
    """An executor run with a host pool gives, after ``wait_host``, the
    inline run's images and transfer counts."""
    prompt = make_prompt(9, batch=2)
    inline = WorkflowExecutor(OpContext(device="cpu")).execute(prompt)
    pool = HostIOPool()
    res = WorkflowExecutor(OpContext(device="cpu", host_pool=pool)) \
        .execute(make_prompt(9, batch=2))
    assert res.images == [] and len(res.image_futures) == 1
    res.wait_host()
    assert len(res.images) == 2
    for a, b in zip(res.images, inline.images):
        np.testing.assert_array_equal(a, b)
    assert res.transfers["3"]["d2h_bytes"] \
        == inline.transfers["3"]["d2h_bytes"] > 0
    pool.shutdown()


def test_the_finalize_thread_keeps_no_run_alive(state, monkeypatch):
    """After a failed run has been finalized on the finalize thread,
    nothing holds its outputs or its error's frames: clear_memory frees
    the pipeline (a job left in a loop variable kept it, and the card's
    memory, until the next job)."""
    import gc
    import weakref

    from comfyui_distributed_tpu_torch.server.app import routes

    st = state()
    wait_history(st, [st.enqueue_prompt(make_prompt(1))])

    def boom(self, ctx, *a, **kw):
        raise InterruptedError("execution interrupted (test)")

    monkeypatch.setattr(basic.VAEDecode, "execute", boom)
    pid = st.enqueue_prompt(make_prompt(2))
    assert wait_history(st, [pid])[pid]["status"] == "error"
    pipe = weakref.ref(treg.load_pipeline("tiny.safetensors", device="cpu"))
    deadline = time.monotonic() + 10
    while st._finalize_pending:
        assert time.monotonic() < deadline
        time.sleep(0.01)
    routes(st)[("POST", "/distributed/clear_memory")](b"{}", "", {})
    gc.collect()
    assert pipe() is None
