"""The coalescing scheduler of the port (``workflow/scheduler.py``,
``ops/basic.py``, ``workflow/executor.py``) against the JAX package's, on
the CPU.

The keys (``coalesce_signature``, ``result_key``, ``subgraph_keys``) and
``build_coalesced``'s hidden overrides must equal the JAX package's
string for string, on every workflow of ``workflows/`` and on plain tiny
graphs (the ``None`` cases too).  A coalesced tiny group of three prompts
(two images each) must give each prompt its serial run's images within
2e-4 and the JAX package's coalesced run's within 2e-3 (the workflow
tolerance), and each saved PNG must carry its own prompt's seed."""

import copy
import glob
import json
import os
import struct

import numpy as np
import pytest
import torch

from comfyui_distributed_tpu.ops.base import OpContext as JaxOpContext
from comfyui_distributed_tpu.runtime import reuse as jreuse
from comfyui_distributed_tpu.workflow import WorkflowExecutor as JaxExecutor
from comfyui_distributed_tpu.workflow import scheduler as jsched
from comfyui_distributed_tpu.workflow.graph import \
    parse_workflow as jparse
from comfyui_distributed_tpu_torch.models import registry as treg
from comfyui_distributed_tpu_torch.ops import basic
from comfyui_distributed_tpu_torch.ops.base import OpContext, SeedValue
from comfyui_distributed_tpu_torch.runtime import reuse
from comfyui_distributed_tpu_torch.workflow import scheduler as sched
from comfyui_distributed_tpu_torch.workflow.executor import WorkflowExecutor
from comfyui_distributed_tpu_torch.workflow.graph import parse_workflow

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKFLOWS = sorted(glob.glob(os.path.join(ROOT, "workflows", "*.json")))
SERIAL_ATOL = 2e-4
WORKFLOW_ATOL = 2e-3


@pytest.fixture(autouse=True)
def fresh_planes():
    """Both packages' reuse planes are process-wide: every test starts
    with empty ones."""
    reuse.reset_reuse()
    jreuse.reset_reuse()
    yield
    reuse.reset_reuse()
    jreuse.reset_reuse()


@pytest.fixture
def tiny_family(monkeypatch):
    monkeypatch.setenv("DTPU_DEFAULT_FAMILY", "tiny")
    yield
    treg.clear_pipeline_cache()


def make_prompt(seed, steps=2, size=32, text="cat", batch=1,
                output="PreviewImage"):
    out = {"class_type": output, "inputs": {"images": ["1", 0]}}
    if output == "SaveImage":
        out["inputs"]["filename_prefix"] = "coal"
    return {
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
                         "sampler_name": "euler", "scheduler": "normal",
                         "denoise": 1.0}},
        "1": {"class_type": "VAEDecode",
              "inputs": {"samples": ["8", 0], "vae": ["7", 2]}},
        "3": out,
    }


def _plain_graphs():
    """Plain tiny graphs: coalescable ones, and each way to miss."""
    collector = make_prompt(1)
    collector["99"] = {"class_type": "DistributedCollector",
                       "inputs": {"images": ["1", 0]}}
    hidden = make_prompt(1)
    hidden["8"]["hidden"] = {"multi_job_id": "x"}
    no_latent = {k: v for k, v in make_prompt(1).items() if k != "9"}
    img2img = make_prompt(1)
    img2img["9"] = {"class_type": "VAEEncode",
                    "inputs": {"pixels": ["10", 0], "vae": ["7", 2]}}
    img2img["10"] = {"class_type": "LoadImage",
                     "inputs": {"image": "input.png"}}
    lora = make_prompt(4)
    lora["11"] = {"class_type": "LoraLoader",
                  "inputs": {"model": ["7", 0], "clip": ["7", 1],
                             "lora_name": "x.safetensors",
                             "strength_model": 1.0, "strength_clip": 0.5}}
    lora["5"]["inputs"]["clip"] = ["11", 1]
    lora["8"]["inputs"]["model"] = ["11", 0]
    return {"plain": make_prompt(1), "plain_seed": make_prompt(99),
            "plain_steps": make_prompt(1, steps=3),
            "plain_batch": make_prompt(1, batch=2),
            "plain_text": make_prompt(1, text="dog"),
            "save": make_prompt(1, output="SaveImage"),
            "collector": collector, "hidden": hidden,
            "no_latent": no_latent, "img2img": img2img, "lora": lora,
            "metadata": {**make_prompt(2), "__doc__": "a note"}}


def _docs():
    docs = {}
    for path in WORKFLOWS:
        with open(path, "r", encoding="utf-8") as f:
            docs[os.path.basename(path)] = json.load(f)
    docs.update(_plain_graphs())
    return docs


DOCS = _docs()


@pytest.mark.parametrize("name", sorted(DOCS))
def test_keys_equal_the_jax_packages(name, tmp_path):
    """The coalescing signature, the exact-hit key (with and without a
    shard scope) and every node's sub-graph key are the JAX package's
    strings, or None where they are None."""
    doc = DOCS[name]
    (tmp_path / "input.png").write_bytes(b"not really a png")
    assert sched.coalesce_signature(doc) == jsched.coalesce_signature(doc)
    for scope in (None, "m0:e3"):
        assert reuse.result_key(doc, str(tmp_path), "models", scope) \
            == jreuse.result_key(doc, str(tmp_path), "models", scope)
    for hidden in ({}, {"8": {"coalesced_seeds": [1, 2]}}):
        graphs = (parse_workflow(copy.deepcopy(doc)),
                  jparse(copy.deepcopy(doc)))
        if name == "no_latent":
            # a link to a missing node: both packages refuse the graph
            for mod, g in zip((reuse, jreuse), graphs):
                with pytest.raises(KeyError):
                    mod.subgraph_keys(g, hidden, str(tmp_path), "models")
            continue
        ours = reuse.subgraph_keys(graphs[0], hidden, str(tmp_path),
                                   "models")
        theirs = jreuse.subgraph_keys(graphs[1], hidden, str(tmp_path),
                                      "models")
        assert ours == theirs
        if name in ("plain", "img2img", "lora"):
            assert ours   # some nodes are addressable


def test_none_cases_and_seed_masking():
    """Seed-only differences share a signature; shape, text and batch
    split it; unsafe, hidden and source-less graphs never coalesce; a
    SaveImage graph coalesces but is never replayed."""
    g = _plain_graphs()
    sig = sched.coalesce_signature(g["plain"])
    assert sig is not None and sig == sched.coalesce_signature(
        g["plain_seed"])
    for other in ("plain_steps", "plain_batch", "plain_text"):
        assert sched.coalesce_signature(g[other]) not in (None, sig)
    for name in ("collector", "hidden", "no_latent", "img2img"):
        assert sched.coalesce_signature(g[name]) is None
    assert sched.coalesce_signature(g["save"]) is not None
    assert reuse.result_key(g["save"]) is None
    assert reuse.result_key(g["plain"]) != reuse.result_key(g["plain_seed"])
    assert all(sched.coalesce_signature(d) is None
               for n, d in DOCS.items() if n.endswith(".json"))


def test_build_coalesced_hidden_equals_the_jax_packages():
    prompts = [make_prompt(s) for s in (11, 22, 33)]
    graph, hidden = sched.build_coalesced(copy.deepcopy(prompts))
    jgraph, jhidden = jsched.build_coalesced(copy.deepcopy(prompts))
    assert hidden == jhidden == {"8": {"coalesced_seeds": [11, 22, 33]}}
    assert graph.to_api_format() == jgraph.to_api_format()
    assert sched.split_images(list(range(6)), 3) \
        == jsched.split_images(list(range(6)), 3) == [[0, 1], [2, 3], [4, 5]]
    # a count that does not divide goes to the first prompt
    assert sched.split_images(list(range(5)), 2) == [list(range(5)), []]


def test_noise_layout_is_prompt_major():
    """Prompt j's rows take seed j and fold-in indices 0..b-1, the
    ``(seed, index)`` pairs of its serial run."""
    class Pipe:
        device = torch.device("cpu")
        family = treg.get_family("tiny")
        schedule = None

    cond = basic.Conditioning(context=torch.zeros(1, 77, 8))
    lat = {"samples": basic.DeviceLatent(torch.zeros(6, 4, 4, 4)),
           "local_batch": 2}
    seed = SeedValue(5, per_prompt=np.asarray([11, 22, 33], np.uint64))
    prep = basic._prepare_sample_inputs(Pipe(), seed, lat, cond, cond)
    assert prep.seeds.tolist() == [11, 11, 22, 22, 33, 33]
    assert prep.sample_idx.tolist() == [0, 1, 0, 1, 0, 1]
    # a latent without local_batch keeps its batch positions
    plain = basic._prepare_sample_inputs(
        Pipe(), 7, {"samples": basic.DeviceLatent(torch.zeros(3, 4, 4, 4))},
        cond, cond)
    assert plain.seeds.tolist() == [7, 7, 7]
    assert plain.sample_idx.tolist() == [0, 1, 2]


def png_text(path):
    """The tEXt chunks of a PNG file."""
    with open(path, "rb") as f:
        data = f.read()
    out, pos = {}, 8
    while pos < len(data):
        n, tag = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + n]
        if tag == b"tEXt":
            k, v = body.split(b"\0", 1)
            out[k.decode("latin-1")] = v.decode("latin-1")
        pos += 12 + n
    return out


def refined(prompt, seed):
    """``prompt`` with a second KSampler (denoise 0.5, ``seed``) between
    its sampler and its decode."""
    out = copy.deepcopy(prompt)
    out["12"] = {"class_type": "KSampler",
                 "inputs": {**out["8"]["inputs"], "latent_image": ["8", 0],
                            "seed": seed, "denoise": 0.5}}
    out["1"]["inputs"]["samples"] = ["12", 0]
    return out


@pytest.mark.parametrize("samplers", [1, 2])
def test_coalesced_group_matches_serial_runs_and_the_jax_package(
        tiny_family, tmp_path, samplers):
    """Three prompts of two images each as one run of six rows: each
    prompt's images equal its serial run's within 2e-4 and the JAX
    package's coalesced run's within 2e-3; each saved PNG's ``prompt``
    chunk holds its own seeds.  With a second sampler, that sampler too
    restarts its fold-in indices with each prompt's rows."""
    seeds = [11, 22, 33]
    prompts = [make_prompt(s, batch=2, output="SaveImage") for s in seeds]
    if samplers == 2:
        prompts = [refined(p, s + 100) for p, s in zip(prompts, seeds)]
    serial = [WorkflowExecutor(OpContext(
        device="cpu", output_dir=str(tmp_path / f"serial{i}"))).execute(
        copy.deepcopy(p)).images for i, p in enumerate(prompts)]
    graph, hidden = sched.build_coalesced(copy.deepcopy(prompts))
    ctx = OpContext(device="cpu", output_dir=str(tmp_path / "merged"))
    ctx.coalesce = 3
    res = WorkflowExecutor(ctx).execute(graph, hidden=hidden)
    assert res.coalesced == 3
    chunks = sched.split_images(res.images, 3)
    assert [len(c) for c in chunks] == [2, 2, 2]
    for mine, theirs in zip(chunks, serial):
        for a, b in zip(mine, theirs):
            np.testing.assert_allclose(a, b, rtol=0, atol=SERIAL_ATOL)
    # the prompt-major layout: prompts differ, a prompt's two rows too
    assert np.abs(chunks[0][0] - chunks[1][0]).max() > 1e-3
    assert np.abs(chunks[0][0] - chunks[0][1]).max() > 1e-3
    jgraph, jhidden = jsched.build_coalesced(copy.deepcopy(prompts))
    jctx = JaxOpContext(output_dir=str(tmp_path / "jax"))
    jctx.coalesce = 3
    jres = JaxExecutor(jctx).execute(jgraph, hidden=jhidden)
    jres.wait_host()
    np.testing.assert_allclose(np.stack(res.images),
                               np.stack(jres.images), rtol=0,
                               atol=WORKFLOW_ATOL)
    saved = sorted(os.listdir(tmp_path / "merged"))
    assert len(saved) == 6
    samplers_ids = ["8", "12"][:samplers]
    got = [[json.loads(png_text(tmp_path / "merged" / f)["prompt"])
            [n]["inputs"]["seed"] for n in samplers_ids] for f in saved]
    assert got == [[s, s + 100][:samplers] for s in seeds for _ in (0, 1)]
    jsaved = sorted(os.listdir(tmp_path / "jax"))
    assert [[json.loads(png_text(tmp_path / "jax" / f)["prompt"])
             [n]["inputs"]["seed"] for n in samplers_ids]
            for f in jsaved] == got
