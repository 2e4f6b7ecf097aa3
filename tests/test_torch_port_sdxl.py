"""``workflows/distributed-sdxl.json`` in the port against the JAX
package: CLIPTextEncodeSDXL (text_l through the first tower, text_g
through the second, the size scalars on the conditioning), the ADM
vector built from them, the ``tiny_sdxl`` family, and the whole workflow
shrunk as ``tests/test_workflow.py`` shrinks it, through both executors.

The SDXL split needs two towers, which ``tiny_sdxl`` lacks, so these
tests register a two-tower tiny family by one name in both packages: an
HF tower and an OpenCLIP tower (packed qkv, a pooled projection), and an
ADM head wide enough for the pooled output and all six size
embeddings."""

import copy
import dataclasses
import json
import pathlib

import numpy as np
import pytest
import torch

from comfyui_distributed_tpu.models import clip as jclip
from comfyui_distributed_tpu.models import registry as jreg
from comfyui_distributed_tpu.models import unet as junet
from comfyui_distributed_tpu.models import vae as jvae
from comfyui_distributed_tpu.ops import basic as jbasic
from comfyui_distributed_tpu.ops.base import Conditioning as JaxCond
from comfyui_distributed_tpu.ops.base import OpContext as JaxOpContext
from comfyui_distributed_tpu.ops.base import get_op as jax_get_op
from comfyui_distributed_tpu.workflow import WorkflowExecutor as JaxExecutor
from comfyui_distributed_tpu_torch.models import clip as tclip
from comfyui_distributed_tpu_torch.models import registry as treg
from comfyui_distributed_tpu_torch.models import unet as tunet
from comfyui_distributed_tpu_torch.models import vae as tvae
from comfyui_distributed_tpu_torch.ops import basic as tbasic
from comfyui_distributed_tpu_torch.ops.base import Conditioning, OpContext
from comfyui_distributed_tpu_torch.ops.base import get_op
from comfyui_distributed_tpu_torch.workflow import WorkflowExecutor

ROOT = pathlib.Path(__file__).resolve().parents[1]
WORKFLOW = ROOT / "workflows" / "distributed-sdxl.json"
NAME = "tiny_xl2"
CKPT = "sd_xl_base_1.0.safetensors"
TOL = dict(rtol=2e-4, atol=2e-4)
# pixels in [0, 1], the two executors on the same weights
IMAGE_ATOL = 2e-3
# pooled projection 48 + six 256-wide size embeddings
ADM = 48 + 6 * 256


def _two_tower(unet_mod, clip_mod, vae_mod, family_cls):
    return family_cls(
        name=NAME,
        unet=dataclasses.replace(unet_mod.TINY_CONFIG, context_dim=128,
                                 adm_in_channels=ADM),
        vae=vae_mod.TINY_VAE_CONFIG,
        clips=(clip_mod.TINY_CLIP_CONFIG,
               dataclasses.replace(clip_mod.TINY_CLIP_CONFIG,
                                   projection_dim=48, layout="openclip")))


@pytest.fixture
def two_tower(monkeypatch):
    monkeypatch.setitem(jreg.FAMILIES, NAME, _two_tower(
        junet, jclip, jvae, jreg.ModelFamily))
    monkeypatch.setitem(treg.FAMILIES, NAME, _two_tower(
        tunet, tclip, tvae, treg.ModelFamily))
    monkeypatch.setenv("DTPU_DEFAULT_FAMILY", NAME)
    jreg.clear_pipeline_cache()
    treg.clear_pipeline_cache()
    yield (jreg.load_pipeline(CKPT),
           treg.load_pipeline(CKPT, device="cpu"))
    jreg.clear_pipeline_cache()
    treg.clear_pipeline_cache()


def _shrunk():
    doc = json.loads(WORKFLOW.read_text())
    doc["2"]["inputs"].update(width=64, height=64, batch_size=1)
    doc["6"]["inputs"].update(steps=2)
    return doc


def test_tiny_sdxl_family_is_the_jax_packages():
    j, t = jreg.FAMILIES["tiny_sdxl"], treg.FAMILIES["tiny_sdxl"]
    assert t.unet.adm_in_channels == j.unet.adm_in_channels == 128
    for field in ("model_channels", "channel_mult", "num_res_blocks",
                  "transformer_depth", "context_dim"):
        assert getattr(t.unet, field) == getattr(j.unet, field), field
    assert [c.width for c in t.clips] == [c.width for c in j.clips]


def test_clip_text_encode_sdxl_matches_jax(two_tower):
    jpipe, tpipe = two_tower
    args = (1024, 768, 16, 8, 0, 0, "a lighthouse at dawn, (fog:1.2)",
            "sharp focus")
    (jc,) = jax_get_op("CLIPTextEncodeSDXL").execute(JaxOpContext(), jpipe,
                                                     *args)
    (tc,) = get_op("CLIPTextEncodeSDXL").execute(OpContext(device="cpu"),
                                                 tpipe, *args)
    assert tc.size_cond == tuple(jc.size_cond) == (768, 1024, 8, 16, 768,
                                                   1024)
    assert tc.context.shape == (1, 77, 128) and tc.pooled.shape == (1, 48)
    np.testing.assert_allclose(tc.context.numpy(), np.asarray(jc.context),
                               **TOL)
    np.testing.assert_allclose(tc.pooled.numpy(), np.asarray(jc.pooled),
                               **TOL)
    # text_l went through the first tower, text_g through the second
    lctx, _ = tpipe.encode_prompt([args[7]])
    gctx, gpooled = tpipe.encode_prompt([args[6]])
    np.testing.assert_array_equal(tc.context[..., :64], lctx[..., :64])
    np.testing.assert_array_equal(tc.context[..., 64:], gctx[..., 64:])
    np.testing.assert_array_equal(tc.pooled, gpooled)


@pytest.mark.parametrize("size_cond", [None, (1024, 1024, 0, 0, 1024, 1024),
                                       (768, 1344, 12, 20, 512, 896)])
def test_adm_vector_honours_the_size_scalars(two_tower, size_cond):
    """The ADM vector that _prepare_sample_inputs builds for the UNet:
    the conditioning's scalars when it has them, (H, W, 0, 0, H, W) of
    the latent when not; as the JAX package builds it."""
    jpipe, tpipe = two_tower
    ctx, pooled = tpipe.encode_prompt(["a cat"], texts_alt=["a dog"])
    tcond = Conditioning(context=ctx, pooled=pooled, size_cond=size_cond)
    jcond = JaxCond(context=ctx.numpy(), pooled=pooled.numpy(),
                    size_cond=size_cond)
    lat = np.zeros((1, 6, 10, 4), np.float32)
    ty = tbasic._prepare_sample_inputs(tpipe, 7, {"samples": lat}, tcond,
                                       tcond).y
    jy = jbasic._prepare_sample_inputs(JaxOpContext(), jpipe, 7,
                                       {"samples": lat}, jcond, jcond).y
    assert ty.shape == (1, ADM)
    # sin/cos of fp32 arguments up to 1344 rad: one ulp of the argument
    # is 1.2e-4 there
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **TOL)
    if size_cond is None:
        want = tbasic._sdxl_vector_cond(
            tpipe, Conditioning(ctx, pooled, (48, 80, 0, 0, 48, 80)), 1, 0,
            0)
        np.testing.assert_array_equal(ty, want)
    else:
        other = tbasic._prepare_sample_inputs(
            tpipe, 7, {"samples": lat},
            dataclasses.replace(tcond, size_cond=size_cond[:4]
                                + (512, 512)), tcond).y
        assert not torch.allclose(ty, other)


def test_sdxl_workflow_matches_the_jax_executor(two_tower):
    doc = _shrunk()
    ours = WorkflowExecutor(OpContext(device="cpu")).execute(
        copy.deepcopy(doc))
    ref = JaxExecutor(JaxOpContext()).execute(copy.deepcopy(doc))
    ref.wait_host()
    a, b = ours.image_batch, ref.image_batch
    assert a.shape == b.shape == (1, 16, 16, 3)
    assert np.isfinite(a).all() and a.std() > 0
    np.testing.assert_allclose(a, b, rtol=0, atol=IMAGE_ATOL)
    assert set(ours.timings) == set(doc) - {"__doc__"}


def test_sdxl_workflow_on_tiny_sdxl_runs_and_sizes_steer(monkeypatch):
    """The one-tower ``tiny_sdxl`` family runs the graph too, and its
    128-wide ADM head sees the declared height."""
    monkeypatch.setenv("DTPU_DEFAULT_FAMILY", "tiny_sdxl")
    treg.clear_pipeline_cache()
    try:
        doc = _shrunk()
        res = WorkflowExecutor(OpContext(device="cpu")).execute(
            copy.deepcopy(doc))
        assert res.image_batch.shape == (1, 16, 16, 3)
        assert np.isfinite(res.image_batch).all()
        pipe = treg.load_pipeline(CKPT, device="cpu")
        enc = get_op("CLIPTextEncodeSDXL")
        ctx = OpContext(device="cpu")
        (c1,) = enc.execute(ctx, pipe, 1024, 1024, 0, 0, 1024, 1024, "a",
                            "b")
        (c2,) = enc.execute(ctx, pipe, 256, 256, 0, 0, 256, 256, "a", "b")
        lat = {"samples": np.zeros((1, 8, 8, 4), np.float32)}
        y1 = tbasic._prepare_sample_inputs(pipe, 0, lat, c1, c1).y
        y2 = tbasic._prepare_sample_inputs(pipe, 0, lat, c2, c2).y
        assert y1.shape == (1, 128) and not torch.allclose(y1, y2)
    finally:
        treg.clear_pipeline_cache()
