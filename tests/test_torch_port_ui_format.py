"""UI-format workflows (``workflow/graph.py:parse_ui_format``) in the port
against the JAX package's parser, on the CPU.

Every API document of ``workflows/`` is rewritten as the UI document
ComfyUI's browser would save for it (:func:`to_ui`: nodes with
``widgets_values`` in each op's ``WIDGETS`` order, ``CONTROL`` slots
filled, and links), with a bypassed node (mode 4) spliced into one of
its links and a muted node (mode 2) hung off another.  Both packages
parse it to the same graph, which is the API document's own; the port
runs the tiny txt2img UI document to the API document's image to the
bit, and ``cli run`` takes a UI file.
"""

import copy
import json
import pathlib

import numpy as np
import pytest

from comfyui_distributed_tpu.workflow.graph import \
    parse_workflow as jax_parse
from comfyui_distributed_tpu_torch import cli
from comfyui_distributed_tpu_torch.models import registry as treg
from comfyui_distributed_tpu_torch.ops.base import (CONTROL,
                                                    NODE_CLASS_MAPPINGS,
                                                    OpContext)
from comfyui_distributed_tpu_torch.runtime import reuse as treuse
from comfyui_distributed_tpu_torch.utils.image import decode_png, to_uint8
from comfyui_distributed_tpu_torch.workflow import (WorkflowExecutor,
                                                    parse_workflow)

from test_torch_port_workflow import _tiny_doc

WORKFLOWS = sorted((pathlib.Path(__file__).resolve().parents[1]
                    / "workflows").glob("*.json"))
# a link's type by the input it feeds (what the bypass rule matches)
TYPES = {"model": "MODEL", "clip": "CLIP", "vae": "VAE",
         "positive": "CONDITIONING", "negative": "CONDITIONING",
         "conditioning": "CONDITIONING", "samples": "LATENT",
         "latent_image": "LATENT", "images": "IMAGE", "image": "IMAGE",
         "pixels": "IMAGE", "mask": "MASK", "seed": "INT"}


def _is_link(v):
    return isinstance(v, list) and len(v) == 2 and isinstance(v[1], int)


def to_ui(api, bypass=None, mute=None):
    """The UI document of an API one.  ``bypass``: (node id, input) -> an
    ImageInvert in mode 4 is spliced into that IMAGE link; ``mute``: a
    node id -> a SaveImage in mode 2 reads its output 0."""
    api = {k: copy.deepcopy(v) for k, v in api.items()
           if isinstance(v, dict) and "class_type" in v}
    extra = {}
    if bypass is not None:
        nid, inp = bypass
        extra["900"] = {"class_type": "ImageInvert", "mode": 4,
                        "inputs": {"image": api[nid]["inputs"][inp]}}
        api[nid]["inputs"][inp] = ["900", 0]
    if mute is not None:
        extra["901"] = {"class_type": "SaveImage", "mode": 2,
                        "inputs": {"images": [mute, 0]}}
    api.update(extra)
    links, nodes, out_types = [], [], {}
    for nid, node in api.items():
        for name, v in node["inputs"].items():
            if _is_link(v):
                out_types.setdefault((str(v[0]), v[1]),
                                     TYPES.get(name, "*"))
    for nid, node in api.items():
        cls = NODE_CLASS_MAPPINGS[node["class_type"]]
        inputs, widgets = [], []
        for name in cls.WIDGETS:
            v = node["inputs"].get(name, (cls.DEFAULTS or {}).get(name, 0))
            widgets.append("fixed" if name == CONTROL
                           else (cls.DEFAULTS or {}).get(name, 0)
                           if _is_link(v) else v)
        for slot, (name, v) in enumerate(node["inputs"].items()):
            if _is_link(v):
                lid = len(links) + 1
                ltype = out_types[(str(v[0]), v[1])]
                links.append([lid, int(v[0]), v[1], int(nid), slot, ltype])
                inputs.append({"name": name, "type": ltype, "link": lid})
        n_out = 1 + max([s for (src, s) in out_types if src == nid],
                        default=0)
        nodes.append({
            "id": int(nid), "type": node["class_type"],
            "mode": node.get("mode", 0), "inputs": inputs,
            "outputs": [{"type": out_types.get((nid, s), "*")}
                        for s in range(n_out)],
            "widgets_values": widgets})
    return {"last_node_id": max(int(k) for k in api), "nodes": nodes,
            "links": links, "version": 0.4}


def _decoder(api):
    """(node, input) of a VAEDecode's consumer, and the VAEDecode's id."""
    for nid, node in api.items():
        if isinstance(node, dict) and node.get("class_type") == "VAEDecode":
            for cid, c in api.items():
                if not isinstance(c, dict) or "inputs" not in c:
                    continue
                for name, v in c["inputs"].items():
                    if _is_link(v) and str(v[0]) == nid:
                        return (cid, name), nid
    return None, None


@pytest.mark.parametrize("path", WORKFLOWS, ids=[p.stem for p in WORKFLOWS])
def test_ui_document_parses_as_the_api_document_in_both_packages(path):
    api = json.loads(path.read_text())
    edge, decoder = _decoder(api)
    ui = to_ui(api, bypass=edge, mute=decoder)
    ours = parse_workflow(copy.deepcopy(ui)).to_api_format()
    assert ours == jax_parse(copy.deepcopy(ui)).to_api_format()
    assert ours == parse_workflow(copy.deepcopy(api)).to_api_format()
    assert "900" not in ours and "901" not in ours


def test_bypass_and_mute_edges_follow_the_jax_rule():
    """A bypassed node with no input of the output's type, two bypassed
    nodes in a loop and a muted source end their links in both
    packages; an unknown class keeps its widgets."""
    ui = {"nodes": [
        {"id": 1, "type": "EmptyImage", "mode": 2, "inputs": [],
         "outputs": [{"type": "IMAGE"}], "widgets_values": [8, 8, 1, 0]},
        {"id": 2, "type": "ImageInvert", "mode": 4,
         "inputs": [{"name": "image", "type": "IMAGE", "link": 1}],
         "outputs": [{"type": "IMAGE"}]},
        {"id": 3, "type": "ImageInvert", "mode": 0,
         "inputs": [{"name": "image", "type": "IMAGE", "link": 2}],
         "outputs": [{"type": "IMAGE"}]},
        {"id": 4, "type": "ImageInvert", "mode": 4,
         "inputs": [{"name": "image", "type": "IMAGE", "link": 4}],
         "outputs": [{"type": "IMAGE"}]},
        {"id": 5, "type": "ImageInvert", "mode": 4,
         "inputs": [{"name": "image", "type": "IMAGE", "link": 3}],
         "outputs": [{"type": "IMAGE"}]},
        {"id": 6, "type": "ImageInvert", "mode": 0,
         "inputs": [{"name": "image", "type": "IMAGE", "link": 5}],
         "outputs": [{"type": "IMAGE"}]},
        {"id": 7, "type": "ImageBlur", "mode": 4,
         "inputs": [{"name": "image", "type": "MASK", "link": 6}],
         "outputs": [{"type": "IMAGE"}]},
        {"id": 8, "type": "PreviewImage", "mode": 0,
         "inputs": [{"name": "images", "type": "IMAGE", "link": 7}],
         "outputs": []},
        {"id": 9, "type": "NotAnOp", "mode": 0, "inputs": [],
         "outputs": [], "widgets_values": [1, "x"]},
        {"id": 10, "type": "KSampler", "mode": 0, "inputs": [],
         "outputs": [], "widgets_values": {"seed": 3, "steps": 2}}],
        "links": [[1, 1, 0, 2, 0, "IMAGE"], [2, 2, 0, 3, 0, "IMAGE"],
                  [3, 4, 0, 5, 0, "IMAGE"], [4, 5, 0, 4, 0, "IMAGE"],
                  [5, 5, 0, 6, 0, "IMAGE"], [6, 6, 0, 7, 0, "IMAGE"],
                  [7, 7, 0, 8, 0, "IMAGE"]]}
    ours = parse_workflow(copy.deepcopy(ui)).to_api_format()
    assert ours == jax_parse(copy.deepcopy(ui)).to_api_format()
    assert set(ours) == {"3", "6", "8", "9", "10"}
    assert "image" not in ours["3"]["inputs"]       # muted source
    assert "image" not in ours["6"]["inputs"]       # bypass loop
    assert "images" not in ours["8"]["inputs"]      # no input of its type
    assert ours["9"]["inputs"] == {"__widgets__": [1, "x"]}
    assert ours["10"]["inputs"]["seed"] == 3


@pytest.fixture
def tiny(monkeypatch):
    monkeypatch.setenv("DTPU_DEFAULT_FAMILY", "tiny")
    treuse.reset_reuse()
    yield
    treg.clear_pipeline_cache()
    treuse.reset_reuse()


def test_ui_document_runs_to_the_api_image_and_through_cli_run(
        tiny, tmp_path):
    api = _tiny_doc(steps=3)
    ui = to_ui(api, bypass=("14", "images"), mute="8")
    want = WorkflowExecutor(OpContext(device="cpu")).execute(
        copy.deepcopy(api)).image_batch
    treuse.reset_reuse()
    got = WorkflowExecutor(OpContext(device="cpu")).execute(
        copy.deepcopy(ui)).image_batch
    assert want.std() > 0
    np.testing.assert_array_equal(got, want)
    wf = tmp_path / "ui.json"
    wf.write_text(json.dumps(ui))
    assert cli.main(["run", str(wf), "--out", str(tmp_path / "out"),
                     "--device", "cpu"]) == 0
    np.testing.assert_array_equal(
        to_uint8(decode_png((tmp_path / "out" / "run_00000.png")
                            .read_bytes())[0]), to_uint8(want[0]))
