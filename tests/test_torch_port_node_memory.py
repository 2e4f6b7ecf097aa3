"""Per-node memory on the spans: the port's executor sets a node span's
``mem_peak_mb`` where the device's peak memory rose over the node, on
the same nodes and with the same values as the JAX executor given the
same memory readings, and a card-less run sets it from this process's
resident set as the JAX package does."""

import copy
import threading

import pytest

from comfyui_distributed_tpu.ops.base import OpContext as JaxOpContext
from comfyui_distributed_tpu.runtime import reuse as jreuse
from comfyui_distributed_tpu.utils import resource as jresource
from comfyui_distributed_tpu.utils import trace as jtrace
from comfyui_distributed_tpu.workflow import WorkflowExecutor as JaxExecutor
from comfyui_distributed_tpu_torch.models import registry as treg
from comfyui_distributed_tpu_torch.ops.base import OpContext
from comfyui_distributed_tpu_torch.runtime import reuse
from comfyui_distributed_tpu_torch.utils import resource
from comfyui_distributed_tpu_torch.utils import trace as trace_mod
from comfyui_distributed_tpu_torch.workflow.executor import WorkflowExecutor

from test_torch_port_batching import make_prompt


@pytest.fixture(autouse=True)
def tiny_and_fresh(monkeypatch):
    monkeypatch.setenv("DTPU_DEFAULT_FAMILY", "tiny")
    monkeypatch.delenv("DTPU_RESOURCE", raising=False)
    reuse.reset_reuse()
    jreuse.reset_reuse()
    yield
    treg.clear_pipeline_cache()
    reuse.reset_reuse()
    jreuse.reset_reuse()


def fake_memory(peaks):
    """Readings in the calling thread's call order: the peak from
    ``peaks`` (the last one repeats), in use half of it.  Other threads
    (a resource monitor another test started) read the first and take
    no turn."""
    calls = [0]
    me = threading.get_ident()

    def snapshot(*a, **kw):
        if threading.get_ident() != me:
            p = peaks[0]
        else:
            p = peaks[min(calls[0], len(peaks) - 1)]
            calls[0] += 1
        return {"bytes_in_use": p // 2, "peak_bytes_in_use": p,
                "bytes_limit": None, "n_devices": 0, "source": "fake"}
    return snapshot


def node_attrs(tr, run):
    """Run under a job span; each node span's attrs by node id."""
    sp = tr.start_span("job", attrs={"prompt_id": "mem"})
    with tr.use_span(sp):
        run()
    sp.end()
    tr.GLOBAL_TRACES.commit("mem", sp.trace_id, root_span_id=sp.span_id)
    return {s["attrs"]["node"]: s["attrs"]
            for s in tr.GLOBAL_TRACES.get("mem")["spans"]
            if "node" in s.get("attrs", {})}


def test_mem_peak_mb_equals_the_jax_executors(monkeypatch):
    prompt = make_prompt(5)
    # the start, then one reading a node (the JAX executor reads once
    # more at its end): rises over nodes 2, 3 and 5 of the six
    peaks = [1_000_000, 1_000_000, 3_500_000, 7_250_000, 7_250_000,
             9_000_000, 9_000_000, 9_000_000]
    monkeypatch.setattr(resource, "device_memory_snapshot",
                        fake_memory(peaks))
    port = node_attrs(trace_mod, lambda: WorkflowExecutor(OpContext(
        device="cpu")).execute(copy.deepcopy(prompt)))
    monkeypatch.setattr(jresource, "device_memory_snapshot",
                        fake_memory(peaks))
    jax = node_attrs(jtrace, lambda: JaxExecutor(JaxOpContext()).execute(
        copy.deepcopy(prompt)))
    got = {n: a.get("mem_peak_mb") for n, a in port.items()}
    want = {n: a.get("mem_peak_mb") for n, a in jax.items()}
    assert got == want
    assert sorted(v for v in got.values() if v) == [1.75, 2.5, 3.75]


def test_a_card_less_run_sets_it_from_the_resident_set(monkeypatch):
    """On the CPU the readings are this process's resident set: the
    first run's model fill raises its peak, so some node carries the
    field, and every value is the rise over its node."""
    assert resource.device_memory_snapshot("cpu")["source"] == "host_rss"
    treg.clear_pipeline_cache()
    seen = []
    real = resource.device_memory_snapshot
    me = threading.get_ident()

    def spy(*a, **kw):
        snap = real(*a, **kw)
        if threading.get_ident() == me:
            seen.append(snap["peak_bytes_in_use"])
        return snap
    monkeypatch.setattr(resource, "device_memory_snapshot", spy)
    attrs = node_attrs(trace_mod, lambda: WorkflowExecutor(OpContext(
        device="cpu")).execute(make_prompt(6, size=64)))
    rises = [round((b - a) / 1e6, 2) for a, b in zip(seen, seen[1:])
             if b > a]
    marked = [a["mem_peak_mb"] for a in attrs.values()
              if "mem_peak_mb" in a]
    assert sorted(marked) == sorted(rises)
    monkeypatch.setenv("DTPU_RESOURCE", "0")
    seen.clear()
    attrs = node_attrs(trace_mod, lambda: WorkflowExecutor(OpContext(
        device="cpu")).execute(make_prompt(6, size=64)))
    assert not seen and not any("mem_peak_mb" in a for a in attrs.values())
