"""The port's fan-out control plane against the JAX package's: the
dispatcher's graph rewrites, the result queues, the cluster config, and
when the master's interceptor fans a prompt out."""

import asyncio
import copy
import json
import pathlib

import pytest

from comfyui_distributed_tpu.runtime.jobs import JobStore as JaxJobStore
from comfyui_distributed_tpu.utils import config as jcfg
from comfyui_distributed_tpu.workflow import dispatcher as jdsp
from comfyui_distributed_tpu.workflow.graph import (
    connected_component as jax_component)
from comfyui_distributed_tpu.workflow.graph import \
    parse_workflow as jax_parse
from comfyui_distributed_tpu_torch.runtime.jobs import JobStore
from comfyui_distributed_tpu_torch.server.app import (ServerState,
                                                      _master_jobs)
from comfyui_distributed_tpu_torch.utils import config as tcfg
from comfyui_distributed_tpu_torch.utils.net import find_free_port
from comfyui_distributed_tpu_torch.workflow import dispatcher as tdsp
from comfyui_distributed_tpu_torch.workflow.graph import (
    connected_component, parse_workflow)
from comfyui_distributed_tpu_torch.workflow.orchestrate import (
    find_image_references, is_dispatched_share)

ROOT = pathlib.Path(__file__).resolve().parents[1]
NAMES = ("txt2img", "img2img", "upscale")
IDS = ["w0", "w1", "w2"]
MASTER = "http://127.0.0.1:8288"


def _doc(name):
    return json.loads((ROOT / "workflows" / f"distributed-{name}.json")
                      .read_text())


def _with_collector_after_upscaler():
    """The upscale workflow with a DistributedCollector between the
    upscaler and the preview: the collector must pass through."""
    doc = _doc("upscale")
    doc["30"] = {"class_type": "DistributedCollector",
                 "inputs": {"images": ["2", 0]}}
    doc["9"]["inputs"]["images"] = ["30", 0]
    return doc


DOCS = {**{n: _doc(n) for n in NAMES},
        "collector_after_upscaler": _with_collector_after_upscaler()}


def _both(doc):
    return jax_parse(copy.deepcopy(doc)), parse_workflow(copy.deepcopy(doc))


@pytest.mark.parametrize("name", list(DOCS))
def test_parse_and_api_format_match_jax(name):
    j, t = _both(DOCS[name])
    assert t.to_api_format() == j.to_api_format()
    assert parse_workflow(t.to_api_format()).to_api_format() \
        == t.to_api_format()


@pytest.mark.parametrize("name", list(DOCS))
@pytest.mark.parametrize("participant", ["master", "worker"])
@pytest.mark.parametrize("index", [0, 1, 2])
def test_prepare_for_participant_matches_jax(name, participant, index):
    j, t = _both(DOCS[name])
    jm = jdsp.make_job_id_map(j, prefix="exec_1")
    tm = tdsp.make_job_id_map(t, prefix="exec_1")
    assert tm == jm
    want = jdsp.prepare_for_participant(j, participant, jm, IDS,
                                        master_url=MASTER,
                                        worker_index=index).to_api_format()
    got = tdsp.prepare_for_participant(t, participant, tm, IDS,
                                       master_url=MASTER,
                                       worker_index=index).to_api_format()
    assert got == want
    # hidden inputs survive the wire: the worker parses what was sent
    assert parse_workflow(json.loads(json.dumps(got))).to_api_format() \
        == got


@pytest.mark.parametrize("name", list(DOCS))
def test_prune_job_map_and_upstream_match_jax(name):
    j, t = _both(DOCS[name])
    assert tdsp.prune_for_worker(t).to_api_format() \
        == jdsp.prune_for_worker(j).to_api_format()
    assert tdsp.make_job_id_map(t, prefix="exec_7") \
        == jdsp.make_job_id_map(j, prefix="exec_7")
    for nid in t.nodes:
        for types in (tdsp.UPSCALER_TYPES, tdsp.COLLECTOR_TYPES,
                      ("CheckpointLoaderSimple",)):
            assert tdsp.has_upstream_type(t, nid, types) \
                == jdsp.has_upstream_type(j, nid, types), (nid, types)
    roots = t.find_by_type(*tdsp.DISTRIBUTED_TYPES)
    assert connected_component(t, roots) == jax_component(j, roots)


def test_collector_after_upscaler_passes_through():
    t = parse_workflow(copy.deepcopy(DOCS["collector_after_upscaler"]))
    jm = tdsp.make_job_id_map(t, prefix="exec_1")
    for part in ("master", "worker"):
        g = tdsp.prepare_for_participant(t, part, jm, ["w0"], MASTER)
        assert g.nodes["30"].hidden == {"pass_through": True}
        up = g.nodes["2"].hidden
        assert up["multi_job_id"] == "exec_1_2"
        assert up["enabled_worker_ids"] == '["w0"]'
        assert up.get("worker_id") == ("w0" if part == "worker" else None)


def test_worker_graph_of_txt2img_keeps_the_collector_component():
    t = parse_workflow(_doc("txt2img"))
    g = tdsp.prepare_for_participant(t, "worker",
                                     tdsp.make_job_id_map(t, "exec_1"),
                                     ["w0", "w1"], MASTER, worker_index=1)
    assert g.nodes["13"].hidden == {"is_worker": True,
                                    "worker_id": "worker_1"}
    assert g.nodes["14"].hidden == {
        "multi_job_id": "exec_1_14", "is_worker": True,
        "master_url": MASTER, "worker_id": "worker_1",
        "worker_batch_size": 1}
    assert is_dispatched_share(g.to_api_format())
    assert not is_dispatched_share(t.to_api_format())


def test_image_references():
    refs = find_image_references(parse_workflow(_doc("upscale")))
    assert refs == ["input.png"]
    assert find_image_references(parse_workflow(_doc("txt2img"))) == []


# --- JobStore ------------------------------------------------------------------


def _run_store(ops):
    """The same operations on the JAX store (through asyncio.run) and the
    port's; returns both outcome lists."""
    async def jax_side():
        s, out = JaxJobStore(), []
        for op, *args in ops:
            if op == "size":
                q = (s._jobs if args[0] == "image" else s._tile_jobs).get(
                    args[1])
                out.append(None if q is None else q.qsize())
            else:
                res = getattr(s, op)(*args[:-1], **args[-1])
                out.append(await res if asyncio.iscoroutine(res) else res)
        return out

    t, tout = JobStore(), []
    for op, *args in ops:
        if op == "size":
            q = (t._jobs if args[0] == "image" else t._tile_jobs).get(args[1])
            tout.append(None if q is None else q.qsize())
        else:
            tout.append(getattr(t, op)(*args[:-1], **args[-1]))
    jout = asyncio.run(jax_side())
    return [None if isinstance(v, asyncio.Queue) else v for v in jout], \
        [None if hasattr(v, "qsize") else v for v in tout]


ITEM = {"worker_id": "worker_0", "tensor": None}
SCENARIOS = {
    "unknown_job_refused": [
        ("put_result", "nope", ITEM, {}), ("put_tile", "nope", ITEM, {}),
        ("has_job", "nope", {}), ("has_tile_job", "nope", {})],
    "duplicate_idem_key_counted_once": [
        ("prepare_job", "a", {}),
        ("put_result", "a", ITEM, {"idem_key": "worker_0:0:0"}),
        ("put_result", "a", ITEM, {"idem_key": "worker_0:0:0"}),
        ("put_result", "a", ITEM, {"idem_key": "worker_0:0:1"}),
        ("put_result", "a", ITEM, {}), ("size", "image", "a")],
    "image_and_tile_queues_are_separate": [
        ("prepare_tile_job", "a", {}), ("put_result", "a", ITEM, {}),
        ("put_tile", "a", ITEM, {"idem_key": "w0:3:0"}),
        ("put_tile", "a", ITEM, {"idem_key": "w0:3:0"}),
        ("has_job", "a", {}), ("has_tile_job", "a", {}),
        ("size", "tile", "a"), ("size", "image", "a")],
    "removal": [
        ("prepare_job", "a", {}), ("prepare_tile_job", "b", {}),
        ("put_result", "a", ITEM, {"idem_key": "k"}),
        ("remove_job", "a", {}), ("remove_tile_queue", "b", {}),
        ("has_job", "a", {}), ("has_tile_job", "b", {}),
        ("put_result", "a", ITEM, {"idem_key": "k"}),
        ("put_tile", "b", ITEM, {}),
        ("put_result", "a", ITEM, {"require_existing": False,
                                   "idem_key": "k"}),
        ("size", "image", "a"), ("snapshot", {})],
}


@pytest.mark.parametrize("scenario", list(SCENARIOS))
def test_job_store_matches_jax(scenario):
    jout, tout = _run_store(SCENARIOS[scenario])
    assert tout == jout


def test_job_store_queue_hands_items_to_a_drain():
    s = JobStore()
    q = s.get_queue("a")
    assert s.put_result("a", {"n": 1}) and q.get(timeout=1) == {"n": 1}
    assert s.get_tile_queue("t") is s.get_tile_queue("t")


# --- cluster config ------------------------------------------------------------


def test_config_matches_jax(tmp_path, monkeypatch):
    path = str(tmp_path / "cfg.json")
    assert tcfg.load_config(path) == jcfg.load_config(path)
    ops = [{"id": "w0", "port": 9000, "enabled": True},
           {"id": "w1", "port": 9001},
           {"id": "w0", "name": "zero", "host": None}]
    t, j = tcfg.load_config(path), jcfg.load_config(path)
    for w in ops:
        assert tcfg.upsert_worker(t, dict(w)) == jcfg.upsert_worker(j, dict(w))
    assert t == j and tcfg.enabled_workers(t) == jcfg.enabled_workers(j)
    assert tcfg.delete_worker(t, "w1") and not tcfg.delete_worker(t, "w9")
    tcfg.update_setting(t, "debug", False)
    tcfg.save_config(t, path)
    assert jcfg.load_config(path) == t
    assert [p.name for p in tmp_path.iterdir()] == ["cfg.json"]
    (tmp_path / "bad.json").write_text("{not json")
    assert tcfg.load_config(str(tmp_path / "bad.json")) \
        == tcfg.get_default_config()
    monkeypatch.setenv(tcfg.CONFIG_ENV, path)
    assert tcfg.default_config_path() == path


# --- the interceptor -----------------------------------------------------------


def _state(tmp_path, workers, is_worker=False):
    path = str(tmp_path / "cfg.json")
    cfg = tcfg.get_default_config()
    cfg["workers"] = workers
    tcfg.save_config(cfg, path)
    st = ServerState(config_path=path, is_worker=is_worker, device="cpu",
                     input_dir=str(tmp_path), output_dir=str(tmp_path),
                     start_exec_thread=False)
    st.port = find_free_port()
    return st


LIVE = [{"id": "w0", "port": 1, "enabled": True}]


@pytest.mark.parametrize("case", ["no_enabled_worker", "no_distributed_node",
                                  "already_has_multi_job_id", "is_worker"])
def test_interceptor_does_not_fan_out(tmp_path, case):
    doc = _doc("txt2img")
    workers = LIVE
    if case == "no_enabled_worker":
        workers = [{"id": "w0", "port": 1, "enabled": False}]
    elif case == "no_distributed_node":
        del doc["14"]
        doc["9"]["inputs"]["images"] = ["8", 0]
        doc["3"]["inputs"]["seed"] = 5
        del doc["13"]
    elif case == "already_has_multi_job_id":
        doc["14"]["hidden"] = {"multi_job_id": "exec_1_14"}
    st = _state(tmp_path, workers, is_worker=case == "is_worker")
    assert st.orchestration_config(doc) is None
    status, body = st.post_prompt({"prompt": doc})
    assert status == 200 and "workers" not in body
    assert [it["prompt"] for it in st._queue] == [doc]


def test_interceptor_runs_master_only_when_the_worker_is_down(tmp_path):
    dead = [{"id": "w0", "host": "127.0.0.1", "port": find_free_port(),
             "enabled": True}]
    st = _state(tmp_path, dead)
    doc = _doc("txt2img")
    assert st.orchestration_config(doc) is not None
    status, body = st.post_prompt({"prompt": doc, "client_id": "t"})
    assert status == 200
    assert body["workers"] == [] and body["failed_workers"] == []
    (item,) = st._queue
    assert item["id"] == body["prompt_id"]
    # the master runs the graph as it came: no job ids, no queues
    assert not is_dispatched_share(item["prompt"])
    assert st.jobs.snapshot() == {"image_jobs": [], "tile_jobs": []}


def test_prepared_master_share_gets_its_tile_queue_at_prompt_time(tmp_path):
    st = _state(tmp_path, [])
    t = parse_workflow(_doc("upscale"))
    g = tdsp.prepare_for_participant(t, "master",
                                     tdsp.make_job_id_map(t, "exec_9"),
                                     ["w0"])
    status, _ = st.post_prompt({"prompt": g.to_api_format()})
    assert status == 200 and st.jobs.has_tile_job("exec_9_2")
    # the master's share names its tile job; a worker's names none
    assert list(_master_jobs(g.to_api_format())) == [("tile", "exec_9_2")]
    w = tdsp.prepare_for_participant(t, "worker",
                                     tdsp.make_job_id_map(t, "exec_9"),
                                     ["w0"], MASTER)
    assert list(_master_jobs(w.to_api_format())) == []
    assert st.post_prompt({"prompt": {}})[0] == 400
