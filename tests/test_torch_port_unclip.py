"""unCLIP in the port against the JAX package:
``workflows/distributed-unclip.json`` (unCLIPCheckpointLoader,
CLIPVisionEncode, unCLIPConditioning on the v-prediction ``sd21_unclip``
family), the CLIP-vision tower (``models/clip_vision.py``, its
preprocessing, its HF file layout), CLIPVisionLoader, the unCLIP ADM
vector and the SD2.1 families.

Both packages get the same numpy inputs and the same virtual weights.
Modules at fp32 agree within 2e-4; the unCLIP vector's noised embedding
is equal to the bit, its noise-level embedding within 2e-4 (XLA's and
torch's float32 sin, cos and exp differ in the last bits: up to 8.3e-6
at level 999, measured); the whole
workflow on ``tiny_unclip`` within 2e-3.  The vector's noise is drawn
from a generator keyed by the embedding's bytes, so the whole-workflow
comparison gives both executors the port's image embedding."""

import copy
import json
import pathlib
import types

import jax
import numpy as np
import pytest
import torch

from comfyui_distributed_tpu.models import clip as jclip
from comfyui_distributed_tpu.models import clip_vision as jcv
from comfyui_distributed_tpu.models import registry as jreg
from comfyui_distributed_tpu.models import schedules as jsch
from comfyui_distributed_tpu.models import unet as junet
from comfyui_distributed_tpu.ops import basic as jbasic
from comfyui_distributed_tpu.ops.base import Conditioning as JaxCond
from comfyui_distributed_tpu.ops.base import OpContext as JaxOpContext
from comfyui_distributed_tpu.runtime import reuse as jreuse
from comfyui_distributed_tpu.workflow import WorkflowExecutor as JaxExecutor
from comfyui_distributed_tpu_torch.models import checkpoints as tckpt
from comfyui_distributed_tpu_torch.models import clip as tclip
from comfyui_distributed_tpu_torch.models import clip_vision as tcv
from comfyui_distributed_tpu_torch.models import registry as treg
from comfyui_distributed_tpu_torch.models import schedules as tsch
from comfyui_distributed_tpu_torch.models import unet as tunet
from comfyui_distributed_tpu_torch.models.weights import (
    clip_vision_from_flax)
from comfyui_distributed_tpu_torch.ops import basic as tbasic
from comfyui_distributed_tpu_torch.ops.base import Conditioning, OpContext
from comfyui_distributed_tpu_torch.utils.image import save_png
from comfyui_distributed_tpu_torch.workflow import WorkflowExecutor

ROOT = pathlib.Path(__file__).resolve().parents[1]
UNCLIP = ROOT / "workflows" / "distributed-unclip.json"
TOL = dict(rtol=2e-4, atol=2e-4)
IMAGE_ATOL = 2e-3


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().cpu().numpy()
    return np.asarray(x, np.float32)


def _clear():
    jreg.clear_pipeline_cache()
    treg.clear_pipeline_cache()
    jreuse.get_reuse().clear()


@pytest.fixture
def fresh(monkeypatch):
    monkeypatch.setenv("DTPU_DEFAULT_FAMILY", "tiny_unclip")
    _clear()
    yield
    _clear()


# --- the families ---------------------------------------------------------------

@pytest.mark.parametrize("family", ["sd21", "sd21_base", "sd21_unclip",
                                    "tiny_unclip"])
def test_family_is_the_jax_packages(family):
    j, t = jreg.FAMILIES[family], treg.FAMILIES[family]
    for field in ("in_channels", "model_channels", "channel_mult",
                  "num_res_blocks", "transformer_depth", "context_dim",
                  "num_head_channels", "num_heads", "adm_in_channels",
                  "use_linear_in_transformer", "prediction_type"):
        assert getattr(t.unet, field) == getattr(j.unet, field), field
    assert t.adm_kind == j.adm_kind
    assert [(c.width, c.layers, c.heads, c.act, c.output_layer,
             c.projection_dim, c.layout) for c in t.clips] \
        == [(c.width, c.layers, c.heads, c.act, c.output_layer,
             c.projection_dim, c.layout) for c in j.clips]
    assert t.vae.downscale == j.vae.downscale


def test_open_clip_h_config_is_the_jax_packages():
    for field in ("width", "layers", "heads", "act", "output_layer",
                  "projection_dim", "layout", "vocab_size", "max_length"):
        assert getattr(tclip.OPEN_CLIP_H_CONFIG, field) \
            == getattr(jclip.OPEN_CLIP_H_CONFIG, field), field
    assert tunet.SD21_BASE_CONFIG.prediction_type == "eps"
    assert junet.SD21_BASE_CONFIG.prediction_type == "eps"


@pytest.mark.parametrize("name", ["sd21-unclip-h.ckpt",
                                  "v2-1_768-ema-pruned.safetensors",
                                  "v2-1_512-ema-pruned.safetensors",
                                  "tiny-unclip.ckpt"])
def test_detect_family_matches_jax(monkeypatch, name):
    monkeypatch.delenv("DTPU_DEFAULT_FAMILY", raising=False)
    fam = treg.detect_family(name)
    assert fam == jreg.detect_family(name)
    treg.get_family(fam)


def test_sd21_unet_attention_layout():
    """SD2.1 at 768^2: 16 transformer blocks of 64-wide heads, 5 at 320
    channels, 10 at 640 and 20 at 1280 (and in the middle), Linear
    projections: 32 attention launches a CFG model call."""
    with torch.device("meta"):
        unet = tunet.UNet(treg.FAMILIES["sd21_unclip"].unet)
    blocks = {name: m for name, m in unet.named_modules()
              if type(m).__name__ == "TransformerBlock"}
    assert len(blocks) == 16
    heads = sorted({(m.attn1.num_heads, m.attn1.head_dim,
                     m.attn2.num_heads, m.attn2.head_dim)
                    for m in blocks.values()})
    assert heads == [(5, 64, 5, 64), (10, 64, 10, 64), (20, 64, 20, 64)]


# --- the CLIP-vision tower --------------------------------------------------------

def _vision(name="concept.vision", config="tiny"):
    jt = jreg.load_clip_vision(name, config_name=config)
    tt = treg.load_clip_vision(name, config_name=config, device="cpu")
    return jt, tt


def test_vision_virtual_weights_equal_the_jax_packages(fresh):
    jt, tt = _vision()
    want = clip_vision_from_flax(tt.cfg, jax.tree_util.tree_map(
        np.asarray, jt.params))
    own = tt.model.state_dict()
    assert set(own) == set(want)
    for k, v in want.items():
        assert torch.equal(own[k], v), k
    assert tt.model.patch_embed.bias is None


@pytest.mark.parametrize("hw", [(40, 56), (72, 48), (64, 64), (20, 30)])
@pytest.mark.parametrize("crop", ["center", "none"])
def test_preprocess_matches_jax(hw, crop):
    """Bicubic on a non-square image (wider and taller), the crop offset,
    an upscale from below the tower's size, and the mean and std."""
    img = np.random.default_rng(sum(hw)).uniform(
        size=(2, *hw, 3)).astype(np.float32)
    j = jcv.preprocess(img, 64, crop)
    t = tcv.preprocess(torch.from_numpy(img), 64, crop)
    assert t.shape == (2, 64, 64, 3)
    np.testing.assert_allclose(_np(t), j, rtol=0, atol=1e-5)


@pytest.mark.parametrize("crop", ["center", "none"])
def test_vision_model_matches_jax(fresh, crop):
    jt, tt = _vision()
    img = np.random.default_rng(3).uniform(size=(2, 40, 56, 3)).astype(
        np.float32)
    jo = jt.encode(img, crop=crop)
    to = tt.encode(torch.from_numpy(img), crop=crop)
    for t, j in ((to.image_embeds, jo.image_embeds),
                 (to.last_hidden, jo.last_hidden),
                 (to.penultimate_hidden, jo.penultimate_hidden)):
        assert tuple(t.shape) == np.asarray(j).shape
        np.testing.assert_allclose(_np(t), np.asarray(j), **TOL)
    assert to.image_embeds.shape == (2, 32)


def test_vision_file_loads_in_both_packages(fresh, tmp_path):
    """The port writes the HF CLIPVisionModel layout; both packages read
    it back (from ``clip_vision/``) to the tower's weights."""
    _, tt = _vision("src.vision")
    (tmp_path / "clip_vision").mkdir()
    path = tmp_path / "clip_vision" / "tower.safetensors"
    tckpt.save_part(str(path), tt.model, "clip_vision", tt.cfg)
    sd = tckpt.load_state_dict(str(path))
    assert "vision_model.pre_layrnorm.weight" in sd
    assert "vision_model.embeddings.patch_embedding.bias" not in sd
    t2 = treg.load_clip_vision("tower.safetensors",
                               models_dir=str(tmp_path), config_name="tiny",
                               device="cpu")
    j2 = jreg.load_clip_vision("tower.safetensors",
                               models_dir=str(tmp_path), config_name="tiny")
    for k, v in tt.model.state_dict().items():
        assert torch.equal(t2.model.state_dict()[k], v), k
    want = clip_vision_from_flax(t2.cfg, jax.tree_util.tree_map(
        np.asarray, j2.params))
    for k, v in want.items():
        assert torch.equal(t2.model.state_dict()[k], v), k
    # without a named config a file's width picks ViT-H or ViT-L, and a
    # tiny tower fits neither
    with pytest.raises(ValueError, match="checkpoint shape"):
        treg.load_clip_vision("tower.safetensors", models_dir=str(tmp_path),
                              device="cpu")


# --- the unCLIP ADM vector ----------------------------------------------------------

@pytest.mark.parametrize("entries", [
    [(0.05, 1.0)], [(0.5, 1.0)], [(0.0, 0.7)], [(1.0, 1.0)], [(-0.2, 1.0)],
    [(0.05, 1.0), (0.3, 0.5)], []])
@pytest.mark.parametrize("family", ["tiny_unclip", "sd21_unclip"])
def test_unclip_vector_cond_matches_jax(fresh, family, entries):
    """Each embedding noised on the schedule with numpy noise keyed by its
    bytes and level (equal to the bit), its level's timestep embedding
    beside it (XLA's exp, sin and cos against torch's), scaled and
    summed; zeros without an embedding."""
    rng = np.random.default_rng(len(entries))
    fam = treg.FAMILIES[family]
    half = fam.unet.adm_in_channels // 2
    embeds = [rng.standard_normal((1, 32 if family == "tiny_unclip"
                                   else 1024)).astype(np.float32)
              for _ in entries]
    tpipe = types.SimpleNamespace(family=fam, device=torch.device("cpu"),
                                  schedule=tsch.make_discrete_schedule())
    jpipe = types.SimpleNamespace(family=jreg.FAMILIES[family],
                                  schedule=jsch.make_discrete_schedule())
    tcond = Conditioning(context=None, unclip=tuple(
        (torch.from_numpy(e), s, n) for e, (n, s) in zip(embeds, entries))
        or None)
    jcond = JaxCond(context=None, unclip=tuple(
        (e, s, n) for e, (n, s) in zip(embeds, entries)) or None)
    t = _np(tbasic._unclip_vector_cond(tpipe, tcond, 2))
    j = np.asarray(jbasic._unclip_vector_cond(jpipe, jcond, 2))
    assert t.shape == j.shape == (2, 2 * half)
    np.testing.assert_array_equal(t[:, :half], j[:, :half])
    np.testing.assert_allclose(t[:, half:], j[:, half:], **TOL)
    if not entries:
        assert not t.any()


def test_unclip_negative_gets_its_own_zero_vector(fresh):
    """A single entry a side on an unCLIP family: one ADM vector for each
    CFG block, the negative's zeros, not the positive's embedding."""
    jp = jreg.load_pipeline("sd21-unclip-h.ckpt")
    tp = treg.load_pipeline("sd21-unclip-h.ckpt", device="cpu")
    ctx = np.random.default_rng(1).standard_normal((1, 77, 64)).astype(
        np.float32)
    emb = np.random.default_rng(2).standard_normal((1, 32)).astype(
        np.float32)
    lat = {"samples": np.zeros((1, 8, 8, 4), np.float32)}
    t = tbasic._prepare_sample_inputs(
        tp, 3, lat, Conditioning(torch.from_numpy(ctx), unclip=(
            (torch.from_numpy(emb), 1.0, 0.05),)),
        Conditioning(torch.from_numpy(ctx)))
    j = jbasic._prepare_sample_inputs(
        JaxOpContext(), jp, 3, lat,
        JaxCond(context=ctx, unclip=((emb, 1.0, 0.05),)),
        JaxCond(context=ctx))
    assert isinstance(t.y, list) and len(t.y) == len(j.y) == 2
    for ty, jy in zip(t.y, j.y):
        np.testing.assert_allclose(_np(ty), np.asarray(jy), **TOL)
    assert not _np(t.y[1]).any() and _np(t.y[0]).any()


# --- the whole workflow --------------------------------------------------------------

def unclip_doc(noise_augmentation=0.05):
    """distributed-unclip.json at the tiny size, as tests/test_workflow.py
    runs it: 64^2, 2 dpmpp_2m steps."""
    doc = json.loads(UNCLIP.read_text())
    doc["7"]["inputs"].update(width=64, height=64)
    doc["9"]["inputs"]["steps"] = 2
    doc["6"]["inputs"]["noise_augmentation"] = noise_augmentation
    return doc


def _concept(tmp_path):
    save_png(str(tmp_path / "concept.png"), np.random.default_rng(4).uniform(
        size=(40, 56, 3)).astype(np.float32))


def test_unclip_workflow_matches_the_jax_executor(fresh, tmp_path,
                                                  monkeypatch):
    _concept(tmp_path)
    doc = unclip_doc()
    ours = WorkflowExecutor(OpContext(device="cpu",
                                      input_dir=str(tmp_path))).execute(
        copy.deepcopy(doc))
    out = ours.outputs["3"][0]
    # the JAX tower's embedding of the same image, within 2e-4
    jt = jreg.load_clip_vision("sd21-unclip-h.ckpt.vision",
                               config_name="tiny")
    from comfyui_distributed_tpu.ops.basic import as_image_array
    jimg = as_image_array(ours.outputs["2"][0].to_host())
    np.testing.assert_allclose(_np(out.image_embeds),
                               np.asarray(jt.encode(jimg).image_embeds),
                               **TOL)
    monkeypatch.setattr(
        jbasic.CLIPVisionEncode, "execute",
        lambda self, ctx, clip_vision, image, crop="center": (
            jcv.CLIPVisionOutput(image_embeds=_np(out.image_embeds)),))
    ref = JaxExecutor(JaxOpContext(input_dir=str(tmp_path))).execute(
        copy.deepcopy(doc))
    ref.wait_host()
    a, b = ours.image_batch, ref.image_batch
    assert a.shape == b.shape == (1, 16, 16, 3)
    assert np.isfinite(a).all() and a.std() > 0
    np.testing.assert_allclose(a, b, rtol=0, atol=IMAGE_ATOL)
    assert ours.outputs["1"][0].family.name == "tiny_unclip"
    assert ours.outputs["1"][3].cfg == tcv.TINY_VISION_CONFIG
    assert set(ours.timings) == set(doc) - {"__doc__"}


def test_unclip_image_follows_the_noise_augmentation(fresh, tmp_path):
    _concept(tmp_path)
    a, b = (WorkflowExecutor(OpContext(device="cpu",
                                       input_dir=str(tmp_path))).execute(
        unclip_doc(n)).image_batch for n in (0.05, 0.5))
    assert np.abs(a - b).max() > 1e-3


def test_unclip_conditioning_reaches_every_sibling():
    out = types.SimpleNamespace(image_embeds=torch.ones(1, 32))
    c = Conditioning(torch.zeros(1, 4, 8),
                     siblings=(Conditioning(torch.zeros(1, 4, 8)),))
    (got,) = tbasic.unCLIPConditioning().execute(
        OpContext(device="cpu"), c, out, strength=0.5,
        noise_augmentation=0.1)
    (got,) = tbasic.unCLIPConditioning().execute(
        OpContext(device="cpu"), got, out, strength=1.0)
    for e in (got, *got.siblings):
        assert [(s, n) for _, s, n in e.unclip] == [(0.5, 0.1), (1.0, 0.0)]
