"""Continuous batching of the port (``workflow/batch_executor.py``, the
step callables of ``models/samplers.py``, ``registry.denoise_step_fn``,
``scheduler.pop_cb_admit``, ``runtime/jobs.ParkedStore``) against the
JAX package's, on the CPU at the tiny family.

The screens (``quick_eligible``, ``validate_cb_env``) and the pops decide
as the JAX package's on every case.  A bucket's latents (a late joiner,
a parked and resumed row, euler and euler_ancestral) are within 2e-4 of
the JAX package's continuous-batching run.  Against the port's own
serial run a row is equal to the bit while its bucket steps at pad 1;
at a larger pad oneDNN's matrix products round by batch, so it is held
to ``CB_SELF_ATOL`` (measured: 4.0e-5 at most on these graphs), and
within one pad sequence a parked and resumed row equals its unparked
run to the bit."""

import copy
import glob
import json
import os
import time

import numpy as np
import pytest
import torch

from comfyui_distributed_tpu.ops.base import OpContext as JaxOpContext
from comfyui_distributed_tpu.runtime import reuse as jreuse
from comfyui_distributed_tpu.workflow import batch_executor as jcb
from comfyui_distributed_tpu.workflow import scheduler as jsched
from comfyui_distributed_tpu_torch.models import registry as treg
from comfyui_distributed_tpu_torch.models import samplers as smp
from comfyui_distributed_tpu_torch.ops.base import OpContext
from comfyui_distributed_tpu_torch.runtime import reuse
from comfyui_distributed_tpu_torch.runtime.jobs import ParkedStore
from comfyui_distributed_tpu_torch.server.app import ServerState, routes
from comfyui_distributed_tpu_torch.utils import constants as C
from comfyui_distributed_tpu_torch.utils import trace as trace_mod
from comfyui_distributed_tpu_torch.workflow import batch_executor as cb
from comfyui_distributed_tpu_torch.workflow import scheduler as sched
from comfyui_distributed_tpu_torch.workflow.executor import WorkflowExecutor

from test_torch_port_coalesce import png_text

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKFLOWS = sorted(glob.glob(os.path.join(ROOT, "workflows", "*.json")))
JAX_ATOL = 2e-4
# a row stepped at pad > 1 against its serial run at batch 1: oneDNN's
# products round by batch (measured max 4.0e-5 on these graphs)
CB_SELF_ATOL = 1e-4


@pytest.fixture(autouse=True)
def tiny_and_fresh(monkeypatch):
    monkeypatch.setenv("DTPU_DEFAULT_FAMILY", "tiny")
    for k in (C.CB_ENV, C.CB_PARK_ENV, C.CB_SLOTS_ENV, C.CB_PAD_BUCKETS_ENV,
              C.CB_PARK_MAX_ENV, C.CB_PARK_HBM_FRACTION_ENV, C.CACHE_ENV):
        monkeypatch.delenv(k, raising=False)
    reuse.reset_reuse()
    jreuse.reset_reuse()
    yield
    treg.clear_pipeline_cache()
    reuse.reset_reuse()
    jreuse.reset_reuse()


def make_prompt(seed, steps=2, size=32, text="cat", batch=1,
                sampler="euler", save=False):
    p = {
        "7": {"class_type": "CheckpointLoaderSimple",
              "inputs": {"ckpt_name": "tiny.safetensors"}},
        "5": {"class_type": "CLIPTextEncode",
              "inputs": {"text": text, "clip": ["7", 1]}},
        "6": {"class_type": "CLIPTextEncode",
              "inputs": {"text": "", "clip": ["7", 1]}},
        "9": {"class_type": "EmptyLatentImage",
              "inputs": {"width": size, "height": size,
                         "batch_size": batch}},
        "8": {"class_type": "KSampler",
              "inputs": {"model": ["7", 0], "positive": ["5", 0],
                         "negative": ["6", 0], "latent_image": ["9", 0],
                         "seed": seed, "steps": steps, "cfg": 2.0,
                         "sampler_name": sampler, "scheduler": "normal",
                         "denoise": 1.0}},
        "1": {"class_type": "VAEDecode",
              "inputs": {"samples": ["8", 0], "vae": ["7", 2]}},
        "3": {"class_type": "PreviewImage", "inputs": {"images": ["1", 0]}},
    }
    if save:
        p["3"] = {"class_type": "SaveImage",
                  "inputs": {"images": ["1", 0],
                             "filename_prefix": f"cb_{seed}"}}
    return p


def item(seed, cls="paid", steps=2, sampler="euler", cb_ok=True):
    p = make_prompt(seed, steps=steps, sampler=sampler)
    return {"id": f"i{seed}", "prompt": p,
            "sig": sched.coalesce_signature(p),
            "cb": cb_ok and cb.quick_eligible(p),
            "tenant": cls, "t_enq": time.perf_counter(), "span": None,
            "extra_data": {}}


def it_of(pid, prompt):
    return {"id": pid, "prompt": prompt,
            "sig": sched.coalesce_signature(prompt), "cb": True}


def serial_latent(prompt):
    res = WorkflowExecutor(OpContext(device="cpu")).execute(
        copy.deepcopy(prompt))
    return res.outputs["8"][0]["samples"].data.numpy()


def drain(bkt, done, rounds=16):
    """Step a bucket until it is empty; each retired row into ``done``."""
    for _ in range(rounds):
        if not bkt.n_active:
            return done
        bkt.step_once()
        for its, rows, _t in bkt.take_finished():
            arr = np.asarray(rows.cpu()) if isinstance(rows, torch.Tensor) \
                else np.asarray(rows)
            for j, it in enumerate(its):
                done[it["id"]] = arr[j * bkt.b:(j + 1) * bkt.b]
    raise AssertionError("bucket never drained")


def make_state(tmp_path, **kw):
    kw.setdefault("cb", True)
    return ServerState(config_path=str(tmp_path / "cfg.json"), device="cpu",
                       input_dir=str(tmp_path / "in"),
                       output_dir=str(tmp_path / "out"), **kw)


def wait_history(state, pids, timeout=180):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if all(p in state._history for p in pids):
            return {p: state._history[p] for p in pids}
        time.sleep(0.01)
    raise AssertionError(f"prompts never finished: "
                         f"{[p for p in pids if p not in state._history]}")


# --- eligibility and the knobs -------------------------------------------------

def _screen_cases():
    cases = {}
    for path in WORKFLOWS:
        with open(path, "r", encoding="utf-8") as f:
            cases[os.path.basename(path)] = json.load(f)
    cases["plain"] = make_prompt(1)
    cases["ancestral"] = make_prompt(1, sampler="euler_ancestral")
    cases["ddim"] = make_prompt(1, sampler="ddim")
    cases["heun"] = make_prompt(1, sampler="heun")
    two = make_prompt(1)
    two["80"] = dict(two["8"])
    cases["two_samplers"] = two
    share = make_prompt(1)
    share["99"] = {"class_type": "DistributedCollector",
                   "inputs": {"images": ["1", 0], "multi_job_id": "job"}}
    cases["dispatched_share"] = share
    for name, (k, v) in {"zero_steps": ("steps", 0),
                         "zero_denoise": ("denoise", 0.0),
                         "bad_seed": ("seed", "abc"),
                         "bad_steps": ("steps", None)}.items():
        p = make_prompt(1)
        p["8"]["inputs"][k] = v
        cases[name] = p
    no_latent = {k: v for k, v in make_prompt(1).items() if k != "9"}
    cases["no_empty_latent"] = no_latent
    return cases


SCREEN_CASES = _screen_cases()


def test_safe_samplers_are_the_extracted_steps_and_the_jax_packages():
    from comfyui_distributed_tpu.models import samplers as jsmp
    from comfyui_distributed_tpu.utils import constants as JC
    assert frozenset(C.CB_SAFE_SAMPLERS) == frozenset(smp.SAMPLER_STEPS) \
        == frozenset(jsmp.SAMPLER_STEPS) == frozenset(JC.CB_SAFE_SAMPLERS)
    for name in ("CB_SLOTS_DEFAULT", "CB_PAD_BUCKETS_DEFAULT",
                 "CB_MAX_BUCKETS_DEFAULT", "CB_ADMIT_WINDOW_DEFAULT",
                 "CB_PARK_MAX_DEFAULT", "CB_PARK_HBM_FRACTION_DEFAULT",
                 "CB_PREEMPT_ORDER", "CB_DECK_RING_DEFAULT", "CB_ENV",
                 "CB_PARK_ENV", "CB_SLOTS_ENV", "CB_PAD_BUCKETS_ENV"):
        assert getattr(C, name) == getattr(JC, name), name
    with pytest.raises(ValueError, match="no extracted step"):
        smp.get_sampler_step("heun")


@pytest.mark.parametrize("name", sorted(SCREEN_CASES))
def test_quick_eligible_equals_the_jax_packages(name):
    doc = SCREEN_CASES[name]
    assert cb.quick_eligible(doc) == jcb.quick_eligible(doc)
    if name in ("plain", "ancestral", "ddim"):
        assert cb.quick_eligible(doc)
    if name in ("heun", "two_samplers", "dispatched_share", "zero_steps",
                "zero_denoise", "bad_seed", "bad_steps", "no_empty_latent"):
        assert not cb.quick_eligible(doc)


VALIDATE_CASES = [
    {}, {C.CB_SLOTS_ENV: "8", C.CB_PARK_ENV: "1", C.CB_PARK_MAX_ENV: "0",
         C.CB_PARK_HBM_FRACTION_ENV: "0.85"},
    {C.CB_PARK_ENV: "off"}, {C.CB_SLOTS_ENV: " 2 "},
    {C.CB_SLOTS_ENV: "0"}, {C.CB_SLOTS_ENV: "two"},
    {C.CB_PARK_MAX_ENV: "-1"}, {C.CB_PARK_ENV: "maybe"},
    {C.CB_PARK_HBM_FRACTION_ENV: "1.5"},
    {C.CB_PARK_HBM_FRACTION_ENV: "0"},
    {C.CB_PARK_HBM_FRACTION_ENV: "lots"},
]


@pytest.mark.parametrize("env", VALIDATE_CASES,
                         ids=[json.dumps(e) for e in VALIDATE_CASES])
def test_validate_cb_env_equals_the_jax_packages(env):
    def outcome(fn):
        try:
            fn(dict(env))
            return None
        except ValueError as e:
            return str(e)
    got = outcome(cb.validate_cb_env)
    assert got == outcome(jcb.validate_cb_env)
    if got is not None:
        assert next(iter(env)) in got


def test_worker_launch_refuses_a_malformed_knob(tmp_path, monkeypatch):
    from comfyui_distributed_tpu_torch.runtime.manager import \
        WorkerProcessManager
    monkeypatch.setenv(C.CB_SLOTS_ENV, "zero")
    mgr = WorkerProcessManager(config_path=str(tmp_path / "cfg.json"))
    with pytest.raises(ValueError, match=C.CB_SLOTS_ENV):
        mgr.launch_worker({"id": "w0", "port": 1}, stop_on_master_exit=False)
    assert "w0" not in mgr.processes


# --- the pops ------------------------------------------------------------------

def _pop_both(make_queue, room_for, **kw):
    """The same queue popped by both packages: (kind, ids, left ids)."""
    out = []
    for mod in (sched, jsched):
        q = make_queue()
        adm = mod.AdmissionController(
            weights=kw.pop("weights", None) if mod is jsched else
            kw.get("weights"), rate={}, burst={}, shed={})
        kind, items = mod.pop_cb_admit(q, adm, room_for, **{
            k: v for k, v in kw.items() if k != "weights"})
        out.append((kind, [i["id"] for i in items], [i["id"] for i in q]))
    assert out[0] == out[1]
    return out[0]


def test_non_contiguous_same_signature_merge():
    got = _pop_both(lambda: [item(1, steps=3), item(2, steps=1),
                             item(3, steps=3)], lambda it: 4)
    assert got == ("cb", ["i1", "i3"], ["i2"])


def test_room_caps_the_sweep():
    got = _pop_both(lambda: [item(i) for i in range(5)], lambda it: 2)
    assert got[0] == "cb" and len(got[1]) == 2 and len(got[2]) == 3


def test_ineligible_head_pops_the_legacy_group():
    got = _pop_both(lambda: [item(i, cb_ok=False) for i in (1, 2, 3)],
                    lambda it: 0, legacy_max=8)
    assert got == ("fallback", ["i1", "i2", "i3"], [])


@pytest.mark.parametrize("room,fallback_ok", [(-1, True), (0, False)])
def test_full_or_busy_defers(room, fallback_ok):
    got = _pop_both(lambda: [item(1, cb_ok=room != 0)], lambda it: room,
                    fallback_ok=fallback_ok)
    assert got == ("defer", [], ["i1"])


def test_tenant_stride_ratios_survive_the_cb_pop():
    weights = {"paid": 6.0, "free": 3.0, "batch": 1.0}
    orders = []
    for mod in (sched, jsched):
        adm = mod.AdmissionController(weights=weights, rate={}, burst={},
                                      shed={})
        queue = [item(1000 + i * 3, cls=cls) for i in range(40)
                 for cls in ("paid", "free", "batch")]
        order = []
        for _ in range(60):
            kind, items = mod.pop_cb_admit(queue, adm, lambda it: 1)
            assert kind == "cb" and len(items) == 1
            order.append(items[0]["tenant"])
        orders.append(order)
    assert orders[0] == orders[1]
    assert [orders[0].count(c) for c in ("paid", "free", "batch")] \
        == [36, 18, 6]


def test_blocked_class_repeeks_the_next_class():
    def room(it):
        return -1 if it["tenant"] == "batch" else 1
    weights = {"batch": 6.0, "paid": 1.0, "free": 1.0}
    got = []
    for mod in (sched, jsched):
        adm = mod.AdmissionController(weights=weights, rate={}, burst={},
                                      shed={})
        q = [item(301, cls="batch"), item(302, cls="paid")]
        kind, items = mod.pop_cb_admit(q, adm, room)
        got.append((kind, [i["id"] for i in items], [i["id"] for i in q]))
    assert got[0] == got[1] == ("cb", ["i302"], ["i301"])


def test_all_classes_blocked_defers_without_a_stride_charge():
    adm = sched.AdmissionController(
        weights={"paid": 6.0, "free": 3.0, "batch": 1.0}, rate={},
        burst={}, shed={})
    queue = [item(311, cls="paid"), item(312, cls="batch")]
    before = dict(adm._pass)
    assert adm.peek_class({"paid": 1, "batch": 1}) == "paid"
    kind, items = sched.pop_cb_admit(queue, adm, lambda it: -1)
    assert kind == "defer" and not items and len(queue) == 2
    assert dict(adm._pass) == before


# --- the step callables and the serial samplers ---------------------------------

@pytest.mark.parametrize("name", ["euler", "ddim", "euler_ancestral"])
def test_serial_sampler_is_its_step_callable_row_by_row(name):
    """The serial loop is the step callable: run row by row with per-row
    vectors and rows at different steps, each row equals the serial
    loop's to the bit (an elementwise model, so batch plays no part)."""
    sig = np.asarray([14.6, 6.0, 2.1, 0.5, 0.0], np.float32)
    keys = np.asarray([[0, 7], [3, 9]], np.uint32)
    x0 = torch.from_numpy(np.random.default_rng(3).standard_normal(
        (2, 4, 4, 4)).astype(np.float32))

    def model(x, s, **kw):
        s = s.reshape(-1, 1, 1, 1) if isinstance(s, torch.Tensor) else s
        return torch.tanh(x) * 0.5 / (1.0 + s)

    serial = smp.get_sampler(name)(model, x0.clone(), sig, keys=keys)
    step = smp.get_sampler_step(name)
    # row 0 runs ahead of row 1 by one step
    x = x0.clone()
    pos = [0, 0]
    for t in range(len(sig)):
        live = [p < len(sig) - 1 and (b == 0 or t > 0)
                for b, p in enumerate(pos)]
        if not any(live):
            break
        s = np.asarray([sig[p] if lv else 1.0
                        for p, lv in zip(pos, live)], np.float32)
        sn = np.asarray([sig[p + 1] if lv else 1.0
                         for p, lv in zip(pos, live)], np.float32)
        new = step(model, x, s, sn, np.asarray(pos), keys)
        act = torch.tensor(live).reshape(-1, 1, 1, 1)
        x = torch.where(act, new, x)
        pos = [p + int(lv) for p, lv in zip(pos, live)]
    assert torch.equal(x, serial)


def test_per_row_sigma_denoiser_equals_the_scalar_one():
    from comfyui_distributed_tpu_torch.models import denoiser as tden
    from comfyui_distributed_tpu_torch.models import schedules as tsch
    seen = []

    def unet(x, ts, ctx, y):
        seen.append(ts.clone())
        return x * 0.25 + ts.reshape(-1, 1, 1, 1) * 1e-3
    for pred in ("eps", "v"):
        den = tden.make_denoiser(unet, tsch.make_discrete_schedule(), pred)
        x = torch.randn(3, 4, 4, 4)
        rows = den(x, torch.tensor([3.5, 3.5, 3.5]))
        one = den(x, 3.5)
        assert torch.equal(rows, one)
        mixed = den(x, torch.tensor([3.5, 1.0, 0.2]))
        for b, s in enumerate((3.5, 1.0, 0.2)):
            assert torch.equal(mixed[b:b + 1], den(x[b:b + 1], s))


# --- buckets -------------------------------------------------------------------

def _jax_bucket_run(prompts, park_after=None, pads=None):
    """The JAX package's bucket: prompt 0 steps once, then the others
    join (or, with ``park_after``, all join and slot 0 parks after that
    many steps and resumes once the rest finished); latents by id."""
    sig = jsched.coalesce_signature(prompts[0])
    its = [{"id": f"p{i}", "prompt": p, "sig": sig, "cb": True}
           for i, p in enumerate(prompts)]
    bkt = jcb._Bucket(sig, its[0], JaxOpContext(), max_slots=4)
    done = {}
    if park_after is None:
        bkt.admit(its[0])
        bkt.step_once()
        bkt.admit_many(its[1:])
        return drain(bkt, done)
    bkt.admit_many(its)
    for _ in range(park_after):
        bkt.step_once()
    recs = [jcb._ParkedRow(i, sig, 0, s, t, x, time.perf_counter())
            for i, s, t, x in bkt.park_slots([0])]
    drain(bkt, done)
    bkt.resume_parked(recs)
    return drain(bkt, done)


@pytest.mark.parametrize("sampler", ["euler", "euler_ancestral"])
def test_late_join_matches_serial_and_the_jax_package(sampler):
    """A prompt joining a running bucket: within 2e-4 of the JAX
    package's bucket, within the stated bound of its own serial run, and
    the first prompt's opening step (at pad 1) equal to the bit."""
    p1 = make_prompt(11, steps=3, sampler=sampler)
    p2 = make_prompt(22, steps=3, sampler=sampler)
    serial = {"p0": serial_latent(p1), "p1": serial_latent(p2)}
    sig = sched.coalesce_signature(p1)
    i1, i2 = it_of("p0", p1), it_of("p1", p2)
    bkt = cb._Bucket(sig, i1, OpContext(device="cpu"), max_slots=4)
    bkt.admit(i1)
    bkt.step_once()
    assert bkt.pad == 1
    solo = cb._Bucket(sig, i1, OpContext(device="cpu"), max_slots=1)
    solo.admit(dict(i1, id="solo"))
    one = drain(solo, {})["solo"]
    np.testing.assert_array_equal(one, serial["p0"])
    bkt.admit(i2)
    assert bkt.pad == 2
    done = drain(bkt, {})
    jdone = _jax_bucket_run([p1, p2])
    for pid in ("p0", "p1"):
        np.testing.assert_allclose(done[pid], serial[pid], rtol=0,
                                   atol=CB_SELF_ATOL)
        np.testing.assert_allclose(done[pid], jdone[pid], rtol=0,
                                   atol=JAX_ATOL)


def test_pad_grows_and_shrinks_along_the_set():
    p = make_prompt(1, steps=4)
    sig = sched.coalesce_signature(p)
    bkt = cb._Bucket(sig, it_of("x0", p), OpContext(device="cpu"),
                     max_slots=4)
    assert bkt.pads == [1, 2, 4] == jcb._pad_set(4)
    bkt.admit(it_of("x0", p))
    assert bkt.pad == 1
    for i in range(2):
        bkt.admit(it_of(f"x{i + 1}", make_prompt(10 + i, steps=4)))
    assert bkt.pad == 4 and bkt.n_active == 3 and bkt.x.shape[0] == 4
    while bkt.n_active:
        bkt.step_once()
        bkt.take_finished()
    assert bkt.pad == 1 and bkt.retires == 3 and bkt.pad_transitions == 3


@pytest.mark.parametrize("raw,slots,want", [
    ("1,2,4,8", 4, [1, 2, 4]), ("2", 4, [2, 4]), ("3,x,,9", 8, [3, 8]),
    ("1,2,4,8", 1, [1])])
def test_pad_set_equals_the_jax_packages(monkeypatch, raw, slots, want):
    monkeypatch.setenv(C.CB_PAD_BUCKETS_ENV, raw)
    assert cb._pad_set(slots) == jcb._pad_set(slots) == want


def test_one_step_callable_a_pad_in_steady_state():
    """Admit and retire churn over warmed pads builds no step callable:
    the bucket's ``retraces`` (the JAX package's counter, here the
    callables it built) stops at one a pad."""
    p = make_prompt(5, steps=2)
    sig = sched.coalesce_signature(p)
    bkt = cb._Bucket(sig, it_of("w", p), OpContext(device="cpu"),
                     max_slots=2)
    bkt.admit(it_of("w", p))
    drain(bkt, {})
    bkt.admit_many([it_of("w1", make_prompt(4)), it_of("w2",
                                                       make_prompt(6))])
    drain(bkt, {})
    warm = bkt.retraces
    assert warm == 2
    for i in range(3):
        bkt.admit(it_of(f"s{i}", make_prompt(100 + i)))
        bkt.step_once()
        bkt.take_finished()
    drain(bkt, {})
    assert bkt.retraces == warm


def test_tail_graph_and_nodes_equal_the_jax_packages():
    from comfyui_distributed_tpu.workflow.graph import parse_workflow as jp
    from comfyui_distributed_tpu_torch.workflow.graph import parse_workflow
    p = make_prompt(3, save=True)
    keep = cb.tail_nodes(parse_workflow(p), "8")
    assert keep == jcb.tail_nodes(jp(p), "8") == {"8", "1", "3", "7"}
    assert cb.build_tail_prompt(p, keep, "8") \
        == jcb.build_tail_prompt(p, keep, "8")


# --- the parked store ----------------------------------------------------------

def rec(pid, sig="A", rank=0, t_park=0.0):
    class R:
        pass
    r = R()
    r.pid, r.sig, r.rank, r.t_park = pid, sig, rank, t_park
    return r


def test_parked_store_overflow_and_room():
    st = ParkedStore(2)
    st.park([rec("a"), rec("b")])
    assert st.room() == 0 and st.count() == 2
    with pytest.raises(ValueError, match="overflow"):
        st.park([rec("c")])


def test_parked_store_refuses_a_double_park_whole():
    st = ParkedStore(4)
    st.park([rec("a")])
    with pytest.raises(ValueError, match="double-park"):
        st.park([rec("b"), rec("a")])
    assert st.count() == 1 and st.has("a") and not st.has("b")


def test_parked_store_orders_as_the_jax_packages():
    from comfyui_distributed_tpu.runtime.jobs import ParkedStore as JStore
    got = []
    for store in (ParkedStore(8), JStore(8)):
        store.park([rec("b1", rank=0, t_park=1.0),
                    rec("f1", rank=1, t_park=3.0, sig="B"),
                    rec("b2", rank=0, t_park=2.0),
                    rec("f2", rank=1, t_park=4.0)])
        order = store.sigs()
        first = [r.pid for r in store.pop_for("A", 2)]
        gone = [r.pid for r in store.pop_abandoned(lambda p: p == "f2")]
        got.append((order, first, gone, store.count(),
                    [r.pid for r in store.drain_all()], store.room()))
    assert got[0] == got[1]
    assert got[0][:3] == (["B", "A"], ["f2", "b1"], [])


def test_zero_capacity_store_is_inert():
    st = ParkedStore(0)
    assert st.room() == 0
    with pytest.raises(ValueError, match="overflow"):
        st.park([rec("a")])


# --- park and resume -------------------------------------------------------------

def _park(bkt, idx):
    return [cb._ParkedRow(i, bkt.sig, 0, s, t, x, time.perf_counter())
            for i, s, t, x in bkt.park_slots(idx)]


@pytest.mark.parametrize("sampler", ["euler", "euler_ancestral"])
def test_park_resume_equals_the_unparked_run_and_the_jax_package(
        monkeypatch, sampler):
    """One pad (2) throughout: a row parked after a step and resumed once
    its co-tenant finished equals the same prompt's unparked run at that
    pad to the bit; both are within 2e-4 of the JAX package's park and
    resume and within the stated bound of the serial runs."""
    monkeypatch.setenv(C.CB_PAD_BUCKETS_ENV, "2")
    p1 = make_prompt(31, steps=3, sampler=sampler)
    p2 = make_prompt(32, steps=3, sampler=sampler)
    sig = sched.coalesce_signature(p1)
    ctx = OpContext(device="cpu")
    ref_b = cb._Bucket(sig, it_of("p0", p1), ctx, max_slots=2)
    ref_b.admit_many([it_of("p0", p1), it_of("p1", p2)])
    ref = drain(ref_b, {})
    bkt = cb._Bucket(sig, it_of("p0", p1), ctx, max_slots=2)
    assert bkt.pads == [2]
    bkt.admit_many([it_of("p0", p1), it_of("p1", p2)])
    bkt.step_once()
    recs = _park(bkt, [0])
    assert recs[0].step == 1 and isinstance(recs[0].x_rows, np.ndarray)
    assert bkt.n_active == 1
    done = drain(bkt, {})
    bkt.resume_parked(recs)
    drain(bkt, done)
    for pid in ("p0", "p1"):
        np.testing.assert_array_equal(done[pid], ref[pid])
    jdone = _jax_bucket_run([p1, p2], park_after=1)
    serial = {"p0": serial_latent(p1), "p1": serial_latent(p2)}
    for pid in ("p0", "p1"):
        np.testing.assert_allclose(done[pid], jdone[pid], rtol=0,
                                   atol=JAX_ATOL)
        np.testing.assert_allclose(done[pid], serial[pid], rtol=0,
                                   atol=CB_SELF_ATOL)


def test_park_on_the_final_step_is_a_noop_resume():
    p = make_prompt(41, steps=2)
    sig = sched.coalesce_signature(p)
    bkt = cb._Bucket(sig, it_of("z", p), OpContext(device="cpu"),
                     max_slots=2)
    bkt.admit(it_of("z", p))
    bkt.step_once()
    bkt.step_once()
    recs = _park(bkt, [0])
    assert recs[0].step == bkt.n_steps and bkt.n_active == 0
    bkt.resume_parked(recs)
    (its, rows, _t0), = bkt.take_finished()
    assert its[0]["id"] == "z"
    np.testing.assert_array_equal(rows.numpy(), serial_latent(p))


def test_double_park_of_a_slot_is_refused():
    p = make_prompt(42, steps=3)
    sig = sched.coalesce_signature(p)
    bkt = cb._Bucket(sig, it_of("d", p), OpContext(device="cpu"),
                     max_slots=2)
    bkt.admit(it_of("d", p))
    with pytest.raises(ValueError, match="double-park"):
        bkt.park_slots([0, 0])
    with pytest.raises(ValueError, match="unknown slot"):
        bkt.park_slots([3])
    assert bkt.n_active == 1
    bkt.step_once()


# --- the executor's residency scheduling ----------------------------------------

def harness(tmp_path, monkeypatch, slots=2, park="1"):
    """An executor the test drives (never started) over a real state."""
    monkeypatch.setenv(C.CB_PARK_ENV, park)
    monkeypatch.setenv(C.CB_SLOTS_ENV, str(slots))
    st = make_state(tmp_path, cb=False)
    return st, cb.ContinuousBatchExecutor(st)


def test_room_for_counts_the_preemptible_lower_classes(tmp_path,
                                                       monkeypatch):
    st, ex = harness(tmp_path, monkeypatch)
    ex._admit_cb([item(201, cls="batch", steps=4)])
    ex._admit_cb([item(202, cls="free", steps=4)])
    assert next(iter(ex._buckets.values())).n_active == 2
    assert ex.room_for(item(203, cls="paid", steps=4)) == 2
    assert ex.room_for(item(204, cls="free", steps=4)) == 1
    assert ex.room_for(item(205, cls="batch", steps=4)) == -1
    assert ex.room_for(item(206, cls="paid", cb_ok=False)) == 0


def test_parking_off_keeps_a_full_bucket_full(tmp_path, monkeypatch):
    st, ex = harness(tmp_path, monkeypatch, park="0")
    assert ex.parked.room() == 0
    ex._admit_cb([item(211, cls="batch", steps=4),
                  item(212, cls="batch", steps=4)])
    assert ex.room_for(item(213, cls="paid", steps=4)) == -1


def test_a_paid_admit_parks_the_youngest_lowest_class(tmp_path,
                                                      monkeypatch):
    st, ex = harness(tmp_path, monkeypatch)
    ex._admit_cb([item(221, cls="batch", steps=6)])
    ex._admit_cb([item(222, cls="batch", steps=6)])
    ex._admit_cb([item(223, cls="paid", steps=6)])
    bkt = next(iter(ex._buckets.values()))
    assert {s.item["id"] for s in bkt.slots} == {"i221", "i223"}
    assert ex.parked.has("i222") and ex.parked.count() == 1
    snap = ex.snapshot()
    assert snap["parks"] == 1 and snap["preemptions"] == 1
    assert snap["parked"] == 1 and snap["park_enabled"] is True
    assert trace_mod.GLOBAL_GAUGES.get("cb_parked") == 1.0
    assert not ex.idle()


def test_a_preempted_row_resumes_and_matches_its_run(tmp_path,
                                                     monkeypatch):
    st, ex = harness(tmp_path, monkeypatch, slots=1)
    victim = item(231, cls="batch", steps=4)
    serial = serial_latent(victim["prompt"])
    ex._admit_cb([victim])
    bkt = next(iter(ex._buckets.values()))
    bkt.step_once()
    ex._admit_cb([item(232, cls="paid", steps=4)])
    assert ex.parked.has("i231")
    done = drain(bkt, {})
    assert "i232" in done
    assert ex._resume_boundary() is True and not ex.parked.has("i231")
    drain(bkt, done)
    # one slot: pad 1 throughout, so equal to the bit
    np.testing.assert_array_equal(done["i231"], serial)
    snap = ex.snapshot()
    assert snap["resumes"] == 1 and snap["parked"] == 0


def test_resume_order_is_free_before_batch(tmp_path, monkeypatch):
    st, ex = harness(tmp_path, monkeypatch)
    ex._admit_cb([item(241, cls="batch", steps=4)])
    ex._admit_cb([item(242, cls="free", steps=4)])
    bkt = next(iter(ex._buckets.values()))
    ex._park_out(bkt, [0, 1])
    assert bkt.n_active == 0 and ex.parked.count() == 2
    assert ex._resume_boundary() is True
    assert [s.item["id"] for s in bkt.slots] == ["i242", "i241"]


def test_memory_pressure_parks_and_gates_the_resume(tmp_path, monkeypatch):
    st, ex = harness(tmp_path, monkeypatch)
    ex._admit_cb([item(251, cls="batch", steps=4)])
    ex._admit_cb([item(252, cls="free", steps=4)])
    bkt = next(iter(ex._buckets.values()))
    # on the CPU the device has no limit: only slot pressure parks
    assert ex._mem_fraction() is None
    ex._mem_probe = lambda: {"bytes_in_use": 95, "bytes_limit": 100}
    ex._pressure_park()
    assert ex.parked.count() == 1 and ex.parked.has("i251")
    assert ex._resume_boundary() is False and ex.parked.count() == 1
    ex._mem_probe = lambda: {"bytes_in_use": 10, "bytes_limit": 100}
    assert ex._resume_boundary() is True
    assert ex.parked.count() == 0 and bkt.n_active == 2


def test_paid_rows_are_never_pressure_parked(tmp_path, monkeypatch):
    st, ex = harness(tmp_path, monkeypatch)
    ex._admit_cb([item(261, cls="paid", steps=4),
                  item(262, cls="paid", steps=4)])
    ex._mem_probe = lambda: {"bytes_in_use": 99, "bytes_limit": 100}
    ex._pressure_park()
    assert ex.parked.count() == 0


def test_an_abandoned_parked_row_is_freed_unresumed(tmp_path, monkeypatch):
    st, ex = harness(tmp_path, monkeypatch)
    ex._admit_cb([item(271, cls="batch", steps=4)])
    bkt = next(iter(ex._buckets.values()))
    ex._park_out(bkt, [0])
    reuse.PREVIEWS.abandon("i271")
    steps_before = bkt.steps_done
    assert ex._resume_boundary() is False
    assert ex.parked.count() == 0 and bkt.n_active == 0
    assert bkt.steps_done == steps_before
    assert wait_history(st, ["i271"], timeout=30)["i271"]["status"] \
        == "abandoned"
    assert ex.snapshot()["abandoned"] == 1


def test_an_all_parked_bucket_survives_eviction(tmp_path, monkeypatch):
    st, ex = harness(tmp_path, monkeypatch)
    ex._admit_cb([item(281, cls="batch", steps=4)])
    bkt = next(iter(ex._buckets.values()))
    ex._park_out(bkt, [0])
    ex._evict_idle_bucket()
    assert bkt.sig in ex._buckets
    assert ex._resume_boundary() is True and bkt.n_active == 1


def test_an_ineligible_signature_goes_to_the_fallback(tmp_path,
                                                      monkeypatch):
    """A prompt that passes the screen but not the bucket build is
    handed to the fallback, its signature barred from then on."""
    st, ex = harness(tmp_path, monkeypatch)
    it = item(291)
    orig = cb._Bucket.__init__

    def refuse(self, *a, **kw):
        raise cb.CBIneligible("masked latent")
    monkeypatch.setattr(cb._Bucket, "__init__", refuse)
    ex._admit_cb([it])
    monkeypatch.setattr(cb._Bucket, "__init__", orig)
    assert it["sig"] in ex._bad_sigs and ex.room_for(it) == 0
    assert ex._fallback_q.get_nowait() == [it]
    assert ex.snapshot()["fallbacks"] == 1


# --- the server ------------------------------------------------------------------

def test_interleaved_signatures_complete_and_merge(tmp_path):
    st = make_state(tmp_path)
    st._exec_gate.clear()
    pids = [st.enqueue_prompt(make_prompt(1, steps=3)),
            st.enqueue_prompt(make_prompt(2, steps=1)),
            st.enqueue_prompt(make_prompt(3, steps=3))]
    st._exec_gate.set()
    hist = wait_history(st, pids)
    assert all(h["status"] == "success" for h in hist.values())
    snap = st.cb.snapshot()
    assert snap["admits"] == 3 and snap["retires"] == 3
    assert snap["fallbacks"] == 0
    assert sorted(b["admits"] for b in snap["buckets"]) == [1, 2]
    assert st.drain(20) is True and st.cb._stop


def test_slot_exit_order_keeps_png_and_history_provenance(tmp_path):
    st = make_state(tmp_path)
    st._exec_gate.clear()
    pids = [st.enqueue_prompt(make_prompt(71, steps=4, save=True)),
            st.enqueue_prompt(make_prompt(72, steps=1, save=True))]
    st._exec_gate.set()
    hist = wait_history(st, pids)
    assert all(h["status"] == "success" and h["images"] == 1
               for h in hist.values())
    out = tmp_path / "out"
    seeds = {json.loads(png_text(out / n)["prompt"])["8"]["inputs"]["seed"]
             for n in os.listdir(out)}
    assert seeds == {71, 72}
    assert st.drain(20) is True


def test_server_images_match_serial_runs(tmp_path):
    """Two prompts of one signature through the server: each image within
    the stated bound of its serial run's (8-bit: at most one level)."""
    st = make_state(tmp_path)
    st._exec_gate.clear()
    prompts = [make_prompt(s, steps=3, save=True) for s in (81, 82)]
    pids = [st.enqueue_prompt(copy.deepcopy(p)) for p in prompts]
    st._exec_gate.set()
    wait_history(st, pids)
    assert st.drain(20) is True
    from comfyui_distributed_tpu_torch.utils.image import decode_png
    got = {}
    for n in os.listdir(tmp_path / "out"):
        path = tmp_path / "out" / n
        seed = json.loads(png_text(path)["prompt"])["8"]["inputs"]["seed"]
        got[seed] = decode_png(path.read_bytes())[0]
    for p in prompts:
        ref = WorkflowExecutor(OpContext(device="cpu")).execute(
            copy.deepcopy(p)).images
        want = np.round(np.clip(ref[0], 0, 1) * 255) / 255
        assert np.abs(got[p["8"]["inputs"]["seed"]] - want).max() \
            <= 1 / 255 + 1e-6


def test_ineligible_prompts_ride_the_fallback(tmp_path):
    st = make_state(tmp_path)
    st._exec_gate.clear()
    pids = [st.enqueue_prompt(make_prompt(7, steps=1)),
            st.enqueue_prompt(make_prompt(8, steps=1, sampler="heun"))]
    st._exec_gate.set()
    hist = wait_history(st, pids)
    assert all(h["status"] == "success" for h in hist.values())
    snap = st.cb.snapshot()
    assert snap["fallbacks"] == 1 and snap["admits"] == 1
    assert st.drain(20) is True


def test_metrics_surfaces_expose_batching(tmp_path, monkeypatch):
    monkeypatch.setenv(C.CB_PARK_ENV, "1")
    st = make_state(tmp_path)
    wait_history(st, [st.enqueue_prompt(make_prompt(9, steps=1))])
    table = routes(st)
    status, m = table[("GET", "/distributed/metrics")](b"", "", {})
    b = m["batching"]
    assert status == 200 and b["enabled"] is True
    jkeys = {"enabled", "max_slots", "max_buckets", "pad_buckets",
             "slots_active", "slots_free", "buckets", "park_enabled",
             "parked", "park_room", "deck", "deck_ring",
             "admit_to_first_step", "admits", "retires", "steps",
             "fallbacks", "retraces", "pad_transitions", "abandoned",
             "parks", "resumes", "preemptions"}
    assert jkeys <= set(b)
    assert b["park_enabled"] is True and b["steps"] == 1
    assert b["deck"][-1]["retires"] == 1
    assert b["admit_to_first_step"]["count"] == 1
    status, raw = table[("GET", "/distributed/metrics.prom")](b"", "", {})
    text = raw.data.decode()
    for fam in ('dtpu_batch_slots{state="active"}',
                'dtpu_batch_slots{state="free"}', "dtpu_cb_admits_total",
                "dtpu_cb_retires_total", "dtpu_cb_steps_total",
                "dtpu_cb_fallback_total", "dtpu_cb_bucket_retraces_total",
                "dtpu_cb_parked", "dtpu_cb_parks_total",
                "dtpu_cb_resumes_total", "dtpu_cb_preemptions_total"):
        assert fam in text, fam
    assert st.drain(20) is True


def test_cb_off_keeps_the_default_dispatch(tmp_path):
    st = make_state(tmp_path, cb=False)
    assert st.cb is None
    table = routes(st)
    assert table[("GET", "/distributed/metrics")](b"", "", {})[1][
        "batching"] == {"enabled": False}
    pid = st.enqueue_prompt(make_prompt(9, steps=1))
    assert wait_history(st, [pid])[pid]["status"] == "success"
    assert st.drain(20) is True


def test_the_drain_stops_the_executor(tmp_path):
    st = make_state(tmp_path)
    pid = st.enqueue_prompt(make_prompt(10, steps=2))
    assert st.drain(60) is True
    assert st._history[pid]["status"] == "success"
    assert st.cb._stop is True
    for t in st.cb._threads:
        t.join(5)
    assert not any(t.is_alive() for t in st.cb._threads) and st.cb.idle()
    with pytest.raises(Exception, match="draining"):
        st.enqueue_prompt(make_prompt(11))


def test_preview_frames_are_the_jax_packages(tmp_path, monkeypatch):
    """A watched prompt gets a frame every DTPU_PREVIEW_EVERY steps, each
    the JAX package's ``latent_preview_png`` of its bucket row (decoded:
    the two PNG writers differ in bytes, not pixels)."""
    import base64

    from comfyui_distributed_tpu_torch.utils.image import decode_png
    monkeypatch.setenv(C.PREVIEW_EVERY_ENV, "2")
    frames = []
    real = reuse.PREVIEWS.publish_latent

    def spy(pid, step, total, latent):
        frames.append((step, total, latent.cpu().numpy().copy()))
        return real(pid, step, total, latent)
    monkeypatch.setattr(reuse.PREVIEWS, "publish_latent", spy)
    st = make_state(tmp_path)
    st._exec_gate.clear()
    pid = st.enqueue_prompt(make_prompt(12, steps=4))
    q = reuse.PREVIEWS.subscribe(pid)
    try:
        st._exec_gate.set()
        wait_history(st, [pid])
        assert st.drain(20) is True
    finally:
        # the bus is process-wide: a queue left subscribed counts as a
        # preview client in every later test of the process
        reuse.PREVIEWS.unsubscribe(pid, q)
    events = []
    while not q.empty():
        events.append(q.get_nowait())
    previews = [e for e in events if e["type"] == "preview"]
    assert [e["step"] for e in previews] == [2, 4]
    assert [f[0] for f in frames] == [2, 4]
    assert all(e["total_steps"] == 4 for e in previews)
    from comfyui_distributed_tpu.utils.image import decode_png as jdecode
    for ev, (_, _, lat) in zip(previews, frames):
        np.testing.assert_array_equal(
            decode_png(base64.b64decode(ev["png_b64"])),
            jdecode(jreuse.latent_preview_png(lat)))
    assert events[-1]["type"] == "done"


def test_paid_preempts_a_running_batch_end_to_end(tmp_path, monkeypatch):
    monkeypatch.setenv(C.CB_PARK_ENV, "1")
    monkeypatch.setenv(C.CB_SLOTS_ENV, "1")
    st = make_state(tmp_path)
    # 20 steps: the batch prompt is still running when the paid one
    # reaches the next boundary
    pid_b = st.enqueue_prompt(make_prompt(91, steps=20), tenant="batch")
    deadline = time.monotonic() + 60
    while st.cb.snapshot()["admits"] < 1:
        assert time.monotonic() < deadline, "batch never admitted"
        time.sleep(0.002)
    pid_p = st.enqueue_prompt(make_prompt(92, steps=20), tenant="paid")
    hist = wait_history(st, [pid_b, pid_p])
    assert all(h["status"] == "success" for h in hist.values())
    snap = st.cb.snapshot()
    assert snap["parks"] >= 1 and snap["preemptions"] >= 1
    assert snap["resumes"] >= 1
    assert snap["parked"] == 0 and snap["retires"] == 2
    # the parked row's trace holds its cb_park span
    spans = trace_mod.GLOBAL_TRACES.get(pid_b)["spans"]
    assert any(s["name"] == "cb_park" for s in spans)
    assert hist[pid_p]["finished_at"] < hist[pid_b]["finished_at"]
    assert st.drain(20) is True


def test_cli_flightdeck_reads_the_deck(tmp_path, capsys, monkeypatch):
    import threading

    from comfyui_distributed_tpu_torch import cli
    from comfyui_distributed_tpu_torch.server.app import make_server
    st = make_state(tmp_path)
    srv = make_server(st, "127.0.0.1", 0)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    try:
        wait_history(st, [st.enqueue_prompt(make_prompt(13, steps=2))])
        url = f"http://127.0.0.1:{st.port}"
        capsys.readouterr()
        assert cli.main(["flightdeck", "--url", url, "--json"]) == 0
        body = json.loads(capsys.readouterr().out)
        assert body["steps"] == 2 and len(body["deck"]) == 2
        assert cli.main(["flightdeck", "--url", url, "--last", "1"]) == 0
        out = capsys.readouterr().out
        assert "flight deck: running=False admits=1 retires=1" in out
        assert "admit->first step: n=1" in out
        assert len([ln for ln in out.splitlines()
                    if ln.strip().startswith("1 ")]) == 1
    finally:
        st.drain(10)
        srv.shutdown()
        srv.server_close()


def test_concurrent_posts_under_a_short_switch_interval(tmp_path,
                                                        monkeypatch):
    """Six threads post twelve prompts of two signatures (one of them
    ineligible) while the interpreter switches threads every 10 us: every
    prompt succeeds once, and the executor's counters add up (admits +
    fallbacks = prompts, retires = admits, nothing left in a slot)."""
    import sys
    import threading
    monkeypatch.setenv(C.CB_SLOTS_ENV, "2")
    st = make_state(tmp_path)
    pids, lock = [], threading.Lock()

    def poster(k):
        for j in range(2):
            seed = 500 + 10 * k + j
            p = make_prompt(seed, steps=2,
                            sampler="heun" if seed % 3 == 0 else "euler")
            pid = st.enqueue_prompt(p, tenant=("paid", "batch")[j])
            with lock:
                pids.append(pid)
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=poster, args=(k,))
                   for k in range(6)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(60)
        assert not any(t.is_alive() for t in threads)
        hist = wait_history(st, list(pids), timeout=240)
    finally:
        sys.setswitchinterval(old)
    assert len(pids) == 12
    assert all(h["status"] == "success" for h in hist.values())
    snap = st.cb.snapshot()
    assert snap["admits"] + snap["fallbacks"] == 12
    assert snap["retires"] == snap["admits"] and snap["slots_active"] == 0
    assert st.drain(30) is True
