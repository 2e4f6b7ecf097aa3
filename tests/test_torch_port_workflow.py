"""The port's slice as a whole: ``workflows/distributed-txt2img.json``
through the JAX package's executor and the port's (``device="cpu"``),
the port's CLI, and the package's import and source hygiene."""

import copy
import json
import os
import pathlib
import re
import subprocess
import sys
import zlib

import numpy as np
import pytest
import torch

from comfyui_distributed_tpu.ops.base import OpContext as JaxOpContext
from comfyui_distributed_tpu.workflow import WorkflowExecutor as JaxExecutor
from comfyui_distributed_tpu_torch import cli
from comfyui_distributed_tpu_torch.models import registry as treg
from comfyui_distributed_tpu_torch.ops.base import OpContext, SeedValue
from comfyui_distributed_tpu_torch.ops.distributed import DistributedSeed
from comfyui_distributed_tpu_torch.utils.image import encode_png
from comfyui_distributed_tpu_torch.workflow import (WorkflowExecutor,
                                                    parse_workflow)

ROOT = pathlib.Path(__file__).resolve().parents[1]
PACKAGE = ROOT / "comfyui_distributed_tpu_torch"
WORKFLOW = ROOT / "workflows" / "distributed-txt2img.json"
# pixels in [0, 1]; measured 5e-6 between the two executors on the CPU
IMAGE_ATOL = 2e-3


def _tiny_doc(width=64, height=64, steps=4):
    doc = json.loads(WORKFLOW.read_text())
    doc["5"]["inputs"].update(width=width, height=height)
    doc["3"]["inputs"]["steps"] = steps
    return doc


@pytest.fixture
def tiny_family(monkeypatch):
    monkeypatch.setenv("DTPU_DEFAULT_FAMILY", "tiny")
    yield
    treg.clear_pipeline_cache()


def test_txt2img_matches_jax_executor(tiny_family):
    doc = _tiny_doc()
    ours = WorkflowExecutor(OpContext(device="cpu")).execute(
        copy.deepcopy(doc))
    ref = JaxExecutor(JaxOpContext()).execute(copy.deepcopy(doc))
    ref.wait_host()
    a, b = ours.image_batch, ref.image_batch
    assert a.shape == b.shape == (1, 16, 16, 3)
    assert np.isfinite(a).all() and a.std() > 0
    np.testing.assert_allclose(a, b, rtol=0, atol=IMAGE_ATOL)
    assert set(ours.timings) == set(doc) - {"__doc__"}


def test_seed_changes_the_image_and_repeats_exactly(tiny_family):
    doc = _tiny_doc(steps=2)
    run = WorkflowExecutor(OpContext(device="cpu"))
    first = run.execute(copy.deepcopy(doc)).image_batch
    again = run.execute(copy.deepcopy(doc)).image_batch
    doc["13"]["inputs"]["seed"] += 1
    other = run.execute(copy.deepcopy(doc)).image_batch
    np.testing.assert_array_equal(first, again)
    assert np.abs(first - other).max() > 1e-3


def _png_size(data: bytes):
    assert data[:8] == b"\x89PNG\r\n\x1a\n"
    w, h = int.from_bytes(data[16:20], "big"), int.from_bytes(data[20:24],
                                                              "big")
    return w, h


def test_cli_run_writes_pngs_and_summary(tiny_family, tmp_path, capsys):
    wf = tmp_path / "wf.json"
    wf.write_text(json.dumps(_tiny_doc(steps=2)))
    out = tmp_path / "out"
    assert cli.main(["run", str(wf), "--out", str(out), "--device",
                     "cpu"]) == 0
    summary = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert summary["images"] == 1 and summary["output_dir"] == str(out)
    assert set(summary["timings"]) == {"3", "4", "5", "6", "7", "8", "9",
                                       "13", "14"}
    assert _png_size((out / "run_00000.png").read_bytes()) == (16, 16)


def test_png_encoder_pixels():
    img = np.random.default_rng(0).uniform(size=(5, 7, 3)).astype(np.float32)
    data = encode_png(img)
    assert _png_size(data) == (7, 5)
    # one IDAT chunk: filter byte 0 then RGB rows
    start = data.index(b"IDAT") + 4
    length = int.from_bytes(data[start - 8:start - 4], "big")
    rows = np.frombuffer(zlib.decompress(data[start:start + length]),
                         np.uint8).reshape(5, 1 + 7 * 3)
    assert (rows[:, 0] == 0).all()
    np.testing.assert_array_equal(
        rows[:, 1:].reshape(5, 7, 3),
        np.clip(img * 255.0 + 0.5, 0, 255).astype(np.uint8))


def test_distributed_seed_offsets():
    ctx = OpContext(device="cpu")
    assert DistributedSeed().execute(ctx, 10) == (SeedValue(10, True),)
    assert DistributedSeed().execute(ctx, 10, is_worker=True,
                                     worker_id="worker_2") == \
        (SeedValue(13, False),)


def test_parser_refuses_what_is_not_ported():
    with pytest.raises(NotImplementedError):
        parse_workflow({"nodes": [], "links": []})
    doc = _tiny_doc()
    doc["3"]["inputs"]["sampler_name"] = "dpmpp_2m"
    graph = parse_workflow(copy.deepcopy(doc))
    assert graph.topo_order().index("4") < graph.topo_order().index("3")
    doc["3"]["class_type"] = "SamplerCustom"
    ctx = OpContext(device="cpu")
    with pytest.raises(KeyError, match="SamplerCustom"):
        WorkflowExecutor(ctx).execute(doc)
    assert not ctx.node_timings   # refused before any node ran


def _modules():
    return sorted(
        ".".join(p.relative_to(ROOT).with_suffix("").parts)
        .removesuffix(".__init__")
        for p in PACKAGE.rglob("*.py"))


def test_imports_load_no_jax_and_nothing_of_the_jax_package():
    """Every module of the port, the HTTP fan-out's, the CLIP-vision
    tower's, the worker manager's, the write-ahead log's and the
    observability plane's (traces, capture files, trace analysis,
    resources, the ``cli`` readers), admission's, the SLO engine's and
    the sharded masters' (``cli router`` and ``slo``) too, imports
    without JAX, the JAX
    package, Pillow or aiohttp (the card's machine has none of the last
    two), and the regional, split-loader and unCLIP ops register."""
    assert {"comfyui_distributed_tpu_torch.server.app",
            "comfyui_distributed_tpu_torch.cli",
            "comfyui_distributed_tpu_torch.workflow.orchestrate",
            "comfyui_distributed_tpu_torch.utils.net",
            "comfyui_distributed_tpu_torch.models.clip_vision",
            "comfyui_distributed_tpu_torch.runtime.manager",
            "comfyui_distributed_tpu_torch.runtime.monitor",
            "comfyui_distributed_tpu_torch.runtime.interrupt",
            "comfyui_distributed_tpu_torch.utils.process",
            "comfyui_distributed_tpu_torch.utils.resource",
            "comfyui_distributed_tpu_torch.runtime.durable",
            "comfyui_distributed_tpu_torch.utils.trace",
            "comfyui_distributed_tpu_torch.utils.trace_export",
            "comfyui_distributed_tpu_torch.utils.trace_analysis",
            "comfyui_distributed_tpu_torch.utils.log",
            "comfyui_distributed_tpu_torch.workflow.scheduler",
            "comfyui_distributed_tpu_torch.utils.slo",
            "comfyui_distributed_tpu_torch.runtime.shard"} \
        <= set(_modules())
    ops = ["ConditioningCombine", "ConditioningSetAreaPercentage",
           "ConditioningSetTimestepRange", "UNETLoader", "CLIPLoader",
           "VAELoader", "InstructPixToPixConditioning",
           "unCLIPCheckpointLoader", "CLIPVisionEncode",
           "unCLIPConditioning"]
    code = ("import importlib, sys\n"
            f"for m in {_modules()!r}:\n"
            "    importlib.import_module(m)\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'flax', 'comfyui_distributed_tpu', 'PIL', "
            "'aiohttp')]\n"
            "assert not bad, bad\n"
            "from comfyui_distributed_tpu_torch.ops.base import "
            "NODE_CLASS_MAPPINGS\n"
            f"missing = set({ops!r}) - set(NODE_CLASS_MAPPINGS)\n"
            "assert not missing, missing\n"
            # the cli's trace readers parse, and a commit's lazy taps
            # (capture files, analysis) load without JAX too
            "from comfyui_distributed_tpu_torch import cli\n"
            "for sub in ('trace', 'why', 'analyze', 'router', 'slo'):\n"
            "    assert cli.build_parser().parse_args("
            "[sub, 'p'] if sub == 'why' else [sub]).fn\n"
            "from comfyui_distributed_tpu_torch.utils import trace\n"
            "trace.GLOBAL_TRACES.commit('p', 'a' * 32)\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'flax', 'comfyui_distributed_tpu', 'PIL', "
            "'aiohttp')]\n"
            "assert not bad, bad\n"
            "print(len([m for m in sys.modules if m.startswith("
            "'comfyui_distributed_tpu_torch')]))\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert int(proc.stdout.split()[-1]) >= len(_modules())


FORBIDDEN = [r"scaled_dot_product_attention", r"torch\.compile",
             r"^\s*(import|from)\s+(jax|flax|jaxlib)\b",
             r"^\s*(import|from)\s+comfyui_distributed_tpu(?!_torch)\b",
             r"cudnn\w*attention",
             r"CUDAGraph|cuda\.graph",
             # the card's machine has no Pillow
             r"^\s*(import|from)\s+PIL\b",
             # nor aiohttp, and the cgi module is gone in Python 3.13
             r"^\s*(import|from)\s+(aiohttp|cgi)\b"]


@pytest.mark.parametrize("pattern", FORBIDDEN)
def test_source_has_no_forbidden_calls(pattern):
    hits = []
    for path in list(PACKAGE.rglob("*.py")) + list(PACKAGE.rglob("*.cu")):
        for i, line in enumerate(path.read_text().splitlines(), 1):
            code = line.split("#", 1)[0] if path.suffix == ".py" else line
            if re.search(pattern, code, re.IGNORECASE):
                hits.append(f"{path.relative_to(ROOT)}:{i}: {line.strip()}")
    assert not hits, hits


def test_ops_run_on_the_requested_device(tiny_family):
    """Every tensor of a CPU run stays on the CPU; nothing asks for a
    card (the kernel wrapper takes its plain version on CPU tensors)."""
    res = WorkflowExecutor(OpContext(device="cpu")).execute(
        copy.deepcopy(_tiny_doc(steps=1)))
    lat = res.outputs["3"][0]["samples"].data
    assert lat.device.type == "cpu" and lat.dtype == torch.float32
