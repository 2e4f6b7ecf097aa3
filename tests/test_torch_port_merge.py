"""The weight-space merges in the port (ModelMergeSimple, ModelMergeAdd,
ModelMergeSubtract, ModelMergeBlocks, CLIPMergeSimple, CLIPMergeAdd,
CLIPMergeSubtract in ``ops/basic.py``, the replacement weights of
``registry.derive_pipeline`` and ``registry.derived_cached``) against the
JAX package's ops on the same virtual weights of the tiny family, on
the CPU.

Merged weights agree within 1e-6 (``MERGE_TOL``: both sides compute
each weight in fp32 in the same order of operations); a ratio of 1 or 0
gives one model's weights to the bit; a second merge of the same pair is
the cached pipeline; two graphs (the four model merges chained, the
three CLIP merges chained) give the JAX executor's image within the tiny
workflows' 2e-3.
"""

import copy
import types

import numpy as np
import pytest
import torch

from comfyui_distributed_tpu.models import registry as jreg
from comfyui_distributed_tpu.ops.base import OpContext as JaxOpContext
from comfyui_distributed_tpu.ops.base import get_op as jax_get_op
from comfyui_distributed_tpu.runtime import reuse as jreuse
from comfyui_distributed_tpu.workflow import WorkflowExecutor as JaxExecutor
from comfyui_distributed_tpu_torch.models import registry as treg
from comfyui_distributed_tpu_torch.ops.base import OpContext, get_op
from comfyui_distributed_tpu_torch.ops.basic import merge_block_section
from comfyui_distributed_tpu_torch.runtime import reuse as treuse
from comfyui_distributed_tpu_torch.workflow import WorkflowExecutor

from test_torch_port_lora import jax_sd, torch_sd
from test_torch_port_workflow import IMAGE_ATOL

MERGE_TOL = dict(rtol=1e-6, atol=1e-6)
A, B = "tiny-merge-a.safetensors", "tiny-merge-b.safetensors"


@pytest.fixture(scope="module")
def loaded():
    """Both checkpoints in both packages, loaded once for the module."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("DTPU_DEFAULT_FAMILY", "tiny")
        yield ((jreg.load_pipeline(A), jreg.load_pipeline(B)),
               (treg.load_pipeline(A, device="cpu"),
                treg.load_pipeline(B, device="cpu")))
    jreg.clear_pipeline_cache()
    treg.clear_pipeline_cache()


@pytest.fixture
def pairs(loaded, monkeypatch):
    """((jax a, jax b), (port a, port b)); every merge, memo and reuse
    entry of a test is gone before the next."""
    monkeypatch.setenv("DTPU_DEFAULT_FAMILY", "tiny")
    treuse.reset_reuse()
    jreuse.reset_reuse()
    yield loaded
    jreg._derived_cache.clear()
    treg._derived_cache.clear()
    treuse.reset_reuse()
    jreuse.reset_reuse()


def assert_same(tsd, jsd, exact=False):
    assert set(tsd) == set(jsd)
    for k in tsd:
        want = np.asarray(jsd[k], np.float32)
        got = tsd[k].float().numpy()
        if exact:
            np.testing.assert_array_equal(got, want, err_msg=k)
        else:
            np.testing.assert_allclose(got, want, err_msg=k, **MERGE_TOL)


MODEL_CASES = [("ModelMergeSimple", {"ratio": 0.3}),
               ("ModelMergeAdd", {}),
               ("ModelMergeSubtract", {"multiplier": 0.7}),
               ("ModelMergeBlocks", {"input": 0.2, "middle": 0.5,
                                     "out": 0.9})]
CLIP_CASES = [("CLIPMergeSimple", {"ratio": 0.3}),
              ("CLIPMergeAdd", {}),
              ("CLIPMergeSubtract", {"multiplier": 0.7})]


@pytest.mark.parametrize("op,widgets", MODEL_CASES + CLIP_CASES,
                         ids=[c[0] for c in MODEL_CASES + CLIP_CASES])
def test_merged_weights_match_jax(pairs, op, widgets):
    (ja, jb), (ta, tb) = pairs
    unet = op.startswith("Model")
    (jm,) = jax_get_op(op).execute(JaxOpContext(), ja, jb, **widgets)
    (tm,) = get_op(op).execute(OpContext(device="cpu"), ta, tb, **widgets)
    assert_same(torch_sd(tm, unet, not unet), jax_sd(jm, unet, not unet))
    # the other half is the first pipeline's, shared
    if unet:
        assert all(x is y for x, y in zip(tm.clip_models, ta.clip_models))
        assert tm.vae is ta.vae
    else:
        assert tm.unet is ta.unet and tm.vae is ta.vae
    # the inputs are untouched
    assert_same(torch_sd(ta), jax_sd(ja), exact=True)


@pytest.mark.parametrize("ratio,which", [(1.0, 0), (0.0, 1)])
def test_ratio_one_and_zero_give_each_models_weights(pairs, ratio, which):
    _, (ta, tb) = pairs
    ctx = OpContext(device="cpu")
    (m,) = get_op("ModelMergeSimple").execute(ctx, ta, tb, ratio=ratio)
    (c,) = get_op("CLIPMergeSimple").execute(ctx, ta, tb, ratio=ratio)
    want = (ta, tb)[which]
    for got, ref in ((m.unet, want.unet),
                     (c.clip_models[0], want.clip_models[0])):
        for (n, p), (n2, q) in zip(got.named_parameters(),
                                   ref.named_parameters()):
            assert n == n2
            torch.testing.assert_close(p, q, rtol=0, atol=0)


def test_a_second_merge_of_the_pair_is_a_cache_hit(pairs, monkeypatch):
    from comfyui_distributed_tpu_torch.ops import basic
    _, (ta, tb) = pairs
    ctx = OpContext(device="cpu")
    (first,) = get_op("ModelMergeSimple").execute(ctx, ta, tb, ratio=0.4)
    assert treg.derived_cached(ta, f"merge:{tb.cache_token}:0.4") is first
    calls = []
    real = basic._merge_modules
    monkeypatch.setattr(basic, "_merge_modules",
                        lambda *a: calls.append(1) or real(*a))
    (again,) = get_op("ModelMergeSimple").execute(ctx, ta, tb, ratio=0.4)
    assert again is first and not calls
    (other,) = get_op("ModelMergeSimple").execute(ctx, ta, tb, ratio=0.5)
    assert other is not first and calls == [1]
    assert treg.derived_cached(tb, "merge:nothing") is None
    # the reuse plane's memo keys name the pipeline object: the merged
    # pipeline's encodes are its own
    plane = treuse.get_reuse()
    assert plane.model_salt(first) not in (plane.model_salt(ta),
                                          plane.model_salt(tb))
    assert plane.model_salt(again) == plane.model_salt(first)


def test_blocks_sections_follow_the_jax_packages_top_level_keys(pairs):
    """Every UNet weight takes ModelMergeBlocks' ratio of its JAX
    counterpart's section: with three distinct ratios, a weight's merged
    value names its section."""
    _, (ta, tb) = pairs
    (m,) = get_op("ModelMergeBlocks").execute(
        OpContext(device="cpu"), ta, tb, input=1.0, middle=0.0, out=0.5)
    a, b = dict(ta.unet.named_parameters()), dict(tb.unet.named_parameters())
    seen = set()
    for name, p in m.unet.named_parameters():
        section = merge_block_section(name)
        seen.add(section)
        r = {"input": 1.0, "middle": 0.0, "out": 0.5}[section]
        torch.testing.assert_close(p, a[name] * r + b[name] * (1 - r),
                                   rtol=0, atol=0)
    assert seen == {"input", "middle", "out"}
    # the head's norm is "out", a ResBlock's inner out_norm is not
    assert merge_block_section("out_norm.weight") == "out"
    assert merge_block_section("down_0_res_0.out_norm.weight") == "input"
    assert merge_block_section("mid_attn.proj_in.weight") == "middle"
    assert merge_block_section("label_fc1.weight") == "input"


def test_refusals_have_the_jax_packages_messages(pairs):
    _, (ta, tb) = pairs
    other = treg.load_pipeline("tiny-sdxl.safetensors",
                               family_name="tiny_sdxl", device="cpu")
    ctx = OpContext(device="cpu")
    for op in ("ModelMergeSimple", "ModelMergeAdd", "ModelMergeSubtract"):
        with pytest.raises(ValueError, match=f"{op}: UNet configs differ "
                           r"\(tiny vs tiny_sdxl\)"):
            get_op(op).execute(ctx, ta, other)
    with pytest.raises(ValueError,
                       match=r"^ModelMergeBlocks: UNet configs differ$"):
        get_op("ModelMergeBlocks").execute(ctx, ta, other)
    two_towers = types.SimpleNamespace(
        clip_models=tb.clip_models * 2, cache_token=-1)
    for op in ("CLIPMergeSimple", "CLIPMergeAdd", "CLIPMergeSubtract"):
        with pytest.raises(ValueError, match=f"{op}: tower counts differ"):
            get_op(op).execute(ctx, ta, two_towers)


def _merge_doc(kind):
    """A tiny txt2img graph on two checkpoints whose model (``kind`` =
    "model") or CLIP ("clip") goes through every merge op of its kind."""
    doc = {
        "1": {"class_type": "CheckpointLoaderSimple",
              "inputs": {"ckpt_name": A}},
        "2": {"class_type": "CheckpointLoaderSimple",
              "inputs": {"ckpt_name": B}},
        "5": {"class_type": "EmptyLatentImage",
              "inputs": {"width": 64, "height": 64, "batch_size": 1}},
        "3": {"class_type": "KSampler",
              "inputs": {"seed": 7, "steps": 3, "cfg": 6.0,
                         "sampler_name": "euler", "scheduler": "karras",
                         "denoise": 1.0, "model": ["1", 0],
                         "positive": ["6", 0], "negative": ["7", 0],
                         "latent_image": ["5", 0]}},
        "6": {"class_type": "CLIPTextEncode",
              "inputs": {"text": "a lighthouse", "clip": ["1", 1]}},
        "7": {"class_type": "CLIPTextEncode",
              "inputs": {"text": "blurry", "clip": ["1", 1]}},
        "8": {"class_type": "VAEDecode",
              "inputs": {"samples": ["3", 0], "vae": ["1", 2]}},
        "9": {"class_type": "PreviewImage", "inputs": {"images": ["8", 0]}},
    }
    if kind == "model":
        doc.update({
            "10": {"class_type": "ModelMergeSubtract",
                   "inputs": {"model1": ["1", 0], "model2": ["2", 0],
                              "multiplier": 0.7}},
            "11": {"class_type": "ModelMergeAdd",
                   "inputs": {"model1": ["10", 0], "model2": ["2", 0]}},
            "12": {"class_type": "ModelMergeBlocks",
                   "inputs": {"model1": ["11", 0], "model2": ["2", 0],
                              "input": 0.2, "middle": 0.5, "out": 0.8}},
            "13": {"class_type": "ModelMergeSimple",
                   "inputs": {"model1": ["12", 0], "model2": ["1", 0],
                              "ratio": 0.6}}})
        doc["3"]["inputs"]["model"] = ["13", 0]
    else:
        doc.update({
            "10": {"class_type": "CLIPMergeSubtract",
                   "inputs": {"clip1": ["1", 1], "clip2": ["2", 1],
                              "multiplier": 0.5}},
            "11": {"class_type": "CLIPMergeAdd",
                   "inputs": {"clip1": ["10", 0], "clip2": ["2", 1]}},
            "12": {"class_type": "CLIPMergeSimple",
                   "inputs": {"clip1": ["11", 0], "clip2": ["2", 1],
                              "ratio": 0.3}}})
        doc["6"]["inputs"]["clip"] = doc["7"]["inputs"]["clip"] = ["12", 0]
    return doc


@pytest.mark.parametrize("kind", ["model", "clip"])
def test_merge_graph_matches_the_jax_executor(pairs, kind):
    doc = _merge_doc(kind)
    ours = WorkflowExecutor(OpContext(device="cpu")).execute(
        copy.deepcopy(doc))
    ref = JaxExecutor(JaxOpContext()).execute(copy.deepcopy(doc))
    ref.wait_host()
    a, b = ours.image_batch, ref.image_batch
    assert a.shape == b.shape and np.isfinite(a).all() and a.std() > 0
    np.testing.assert_allclose(a, b, rtol=0, atol=IMAGE_ATOL)
    plain = copy.deepcopy(doc)
    plain["3"]["inputs"]["model"] = ["1", 0]
    plain["6"]["inputs"]["clip"] = plain["7"]["inputs"]["clip"] = ["1", 1]
    base = WorkflowExecutor(OpContext(device="cpu")).execute(plain)
    # the merge changed the image: a merged tower has its own encode memo
    assert np.abs(base.image_batch - a).max() > 1e-3
