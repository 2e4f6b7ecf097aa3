"""The split loaders and InstructPix2Pix in the port against the JAX
package: ``workflows/distributed-ip2p.json`` (UNETLoader of an 8-channel
``sd15_ip2p`` UNet, CLIPLoader, VAELoader, InstructPixToPixConditioning),
DualCLIPLoader, the loaders' virtual values and their lone files, and
the ``sd15_ip2p``/``tiny_ip2p`` families.

Both packages get the same numpy inputs and the same virtual weights.
Weights are equal to the bit, modules at fp32 agree within 2e-4, the
whole workflow on the tiny families within 2e-3."""

import copy
import dataclasses
import json
import pathlib

import jax
import numpy as np
import pytest
import torch

from comfyui_distributed_tpu.models import registry as jreg
from comfyui_distributed_tpu.ops.base import Conditioning as JaxCond
from comfyui_distributed_tpu.ops.base import OpContext as JaxOpContext
from comfyui_distributed_tpu.ops.base import get_op as jax_get_op
from comfyui_distributed_tpu.runtime import reuse as jreuse
from comfyui_distributed_tpu.workflow import WorkflowExecutor as JaxExecutor
from comfyui_distributed_tpu_torch.models import checkpoints as tckpt
from comfyui_distributed_tpu_torch.models import registry as treg
from comfyui_distributed_tpu_torch.models.weights import (
    state_dict_from_flax)
from comfyui_distributed_tpu_torch.ops.base import Conditioning, OpContext
from comfyui_distributed_tpu_torch.ops.base import get_op
from comfyui_distributed_tpu_torch.utils.image import save_png
from comfyui_distributed_tpu_torch.workflow import WorkflowExecutor

ROOT = pathlib.Path(__file__).resolve().parents[1]
IP2P = ROOT / "workflows" / "distributed-ip2p.json"
TOL = dict(rtol=2e-4, atol=2e-4)
IMAGE_ATOL = 2e-3


def _np(x):
    if hasattr(x, "to_host"):
        return x.to_host()
    if isinstance(x, torch.Tensor):
        return x.detach().float().cpu().numpy()
    return np.asarray(x, np.float32)


def _tree(t):
    return jax.tree_util.tree_map(np.asarray, t)


def _clear():
    jreg.clear_pipeline_cache()
    treg.clear_pipeline_cache()
    jreuse.get_reuse().clear()


@pytest.fixture
def fresh(monkeypatch):
    """No family override, every pipeline cache and the JAX reuse plane
    empty."""
    monkeypatch.delenv("DTPU_DEFAULT_FAMILY", raising=False)
    _clear()
    yield
    _clear()


def _equal_weights(module, tree):
    """The module's parameters equal the JAX tree, converted, to the
    bit."""
    want = state_dict_from_flax(module, _tree(tree))
    own = module.state_dict()
    assert set(own) == set(want)
    for k, v in want.items():
        assert torch.equal(own[k].float(), v), k


# --- the families --------------------------------------------------------------

@pytest.mark.parametrize("family", ["sd15_ip2p", "tiny_ip2p"])
def test_ip2p_family_is_the_jax_packages(family):
    j, t = jreg.FAMILIES[family], treg.FAMILIES[family]
    assert t.unet.in_channels == j.unet.in_channels == 8
    base = "sd15" if family == "sd15_ip2p" else "tiny"
    assert dataclasses.replace(t.unet, in_channels=4) \
        == treg.FAMILIES[base].unet
    assert t.vae == treg.FAMILIES[base].vae
    assert [c.width for c in t.clips] == [c.width for c in j.clips]
    name = "instruct-pix2pix-00-22000.safetensors" \
        if family == "sd15_ip2p" else "tiny-ip2p-unet.sft"
    assert treg.detect_family(name) == jreg.detect_family(name) == family


def test_clip_type_families_are_the_jax_packages():
    assert treg.CLIP_TYPE_FAMILIES == jreg.CLIP_TYPE_FAMILIES
    for fam in treg.CLIP_TYPE_FAMILIES.values():
        assert [c.width for c in treg.get_family(fam).clips] \
            == [c.width for c in jreg.FAMILIES[fam].clips]


# --- the split loaders' virtual values -----------------------------------------

def test_load_unet_virtual_weights_equal_the_jax_packages(fresh):
    """The UNet from the name's seed; the pipeline holds nothing else
    (the JAX package's unread towers are not built)."""
    name = "tiny-ip2p-unet.sft"
    jp = jreg.load_unet(name)
    tp = treg.load_unet(name, device="cpu")
    assert tp.family.name == jp.family.name == "tiny_ip2p"
    _equal_weights(tp.unet, jp.unet_params)
    assert tp.clip_models == [] and tp.vae is None
    with pytest.raises(ValueError, match="no text encoder"):
        tp.encode_prompt(["x"])
    with pytest.raises(ValueError, match="no VAE"):
        tp.vae_decode(torch.zeros(1, 4, 4, 4))
    assert treg.load_unet(name, device="cpu") is tp


@pytest.mark.parametrize("names,family", [
    (["tiny-clip.sft"], "tiny"), (["clip_l.sft", "clip_g.sft"], "tiny2")])
def test_load_clip_virtual_weights_equal_the_jax_packages(fresh,
                                                          monkeypatch,
                                                          names, family):
    """Tower i from the name's seed plus i; a CLIP wire has no UNet."""
    if family == "tiny2":
        two = dataclasses.replace(treg.FAMILIES["tiny"], name="tiny2",
                                  clips=treg.FAMILIES["tiny"].clips * 2)
        jtwo = dataclasses.replace(jreg.FAMILIES["tiny"], name="tiny2",
                                   clips=jreg.FAMILIES["tiny"].clips * 2)
        monkeypatch.setitem(treg.FAMILIES, "tiny2", two)
        monkeypatch.setitem(jreg.FAMILIES, "tiny2", jtwo)
    jp = jreg.load_clip(names, family_name=family)
    tp = treg.load_clip(names, family_name=family, device="cpu")
    assert len(tp.clip_models) == len(names)
    for m, tree in zip(tp.clip_models, jp.clip_params):
        _equal_weights(m, tree)
    got = tp.encode_prompt(["a winter scene"])
    want = jp.encode_prompt(["a winter scene"])
    for g, w in zip(got, want):
        np.testing.assert_allclose(_np(g), np.asarray(w), **TOL)
    assert tp.unet is None and tp.vae is None
    with pytest.raises(ValueError, match="no UNet"):
        tp.sample(torch.zeros(1, 4, 4, 4), got[0], got[0],
                  np.zeros(1, np.uint64), steps=1, cfg=1.0,
                  sampler_name="euler", scheduler="karras")
    with pytest.raises(ValueError, match="tower"):
        treg.load_clip(names + ["x"], family_name=family, device="cpu")


@pytest.mark.parametrize("name", ["tiny-vae.sft", "vae-ft-mse.safetensors"])
def test_load_vae_virtual_weights_equal_the_jax_packages(fresh, name):
    """The VAE from the name's seed; "tiny" in the name picks the tiny
    geometry (a real name would build SD's full VAE, so the second is
    held on ``tiny`` through the family override)."""
    fam = None if "tiny" in name else "tiny"
    jp = jreg.load_vae(name, family_name=fam)
    tp = treg.load_vae(name, family_name=fam, device="cpu")
    assert tp.family.name == jp.family.name == "tiny"
    _equal_weights(tp.vae, jp.vae_params)
    assert tp.unet is None and tp.clip_models == []
    img = np.random.default_rng(2).uniform(size=(1, 16, 16, 3)).astype(
        np.float32)
    np.testing.assert_allclose(_np(tp.vae_encode(torch.from_numpy(img))),
                               np.asarray(jp.vae_encode(img)), **TOL)


# --- lone files -----------------------------------------------------------------

@pytest.mark.parametrize("prefix", ["first_stage_model.", ""])
def test_vae_file_with_or_without_prefix(fresh, tmp_path, prefix):
    src = treg.load_vae("tiny-src-vae.sft", device="cpu")
    path = tmp_path / "my-tiny-vae.safetensors"
    tckpt.save_part(str(path), src.vae, "vae", src.family.vae, prefix)
    sd = tckpt.load_state_dict(str(path))
    assert all(k.startswith(prefix) for k in sd)
    tp = treg.load_vae(path.name, models_dir=str(tmp_path), device="cpu")
    jp = jreg.load_vae(path.name, models_dir=str(tmp_path))
    for k, v in src.vae.state_dict().items():
        assert torch.equal(tp.vae.state_dict()[k], v), k
    _equal_weights(tp.vae, jp.vae_params)


@pytest.mark.parametrize("sub,prefix", [
    ("", "model.diffusion_model."), ("unet", ""),
    ("diffusion_models", "model.diffusion_model.")])
def test_unet_file_with_or_without_prefix(fresh, tmp_path, sub, prefix):
    src = treg.load_unet("tiny-ip2p-src.sft", device="cpu")
    (tmp_path / sub).mkdir(exist_ok=True)
    name = "tiny-ip2p-file.safetensors"
    tckpt.save_part(str(tmp_path / sub / name), src.unet, "unet",
                    src.family.unet, prefix)
    tp = treg.load_unet(name, models_dir=str(tmp_path), device="cpu")
    jp = jreg.load_unet(name, models_dir=str(tmp_path))
    for k, v in src.unet.state_dict().items():
        assert torch.equal(tp.unet.state_dict()[k], v), k
    _equal_weights(tp.unet, jp.unet_params)


@pytest.mark.parametrize("sub,prefix", [
    ("clip", "cond_stage_model.transformer.text_model."),
    ("text_encoders", "text_model."), ("", "")])
def test_clip_file_under_each_prefix(fresh, tmp_path, sub, prefix):
    src = treg.load_clip(["tiny-src-clip.sft"], family_name="tiny",
                         device="cpu")
    (tmp_path / sub).mkdir(exist_ok=True)
    name = "my-clip.safetensors"
    tckpt.save_part(str(tmp_path / sub / name), src.clip_models[0], "clip",
                    src.family.clips[0], prefix)
    tp = treg.load_clip([name], models_dir=str(tmp_path),
                        family_name="tiny", device="cpu")
    jp = jreg.load_clip([name], models_dir=str(tmp_path),
                        family_name="tiny")
    for k, v in src.clip_models[0].state_dict().items():
        assert torch.equal(tp.clip_models[0].state_dict()[k], v), k
    _equal_weights(tp.clip_models[0], jp.clip_params[0])


# --- the ops --------------------------------------------------------------------

def test_clip_loader_types():
    ctx = OpContext(device="cpu")
    with pytest.raises(ValueError, match="unknown type"):
        get_op("CLIPLoader").execute(ctx, "a.sft", type="nope")
    with pytest.raises(ValueError, match="DualCLIPLoader"):
        get_op("CLIPLoader").execute(ctx, "a.sft", type="sdxl")
    with pytest.raises(ValueError, match="two-tower"):
        get_op("DualCLIPLoader").execute(ctx, "a.sft", "b.sft", type="sd1")


def test_instruct_pix2pix_conditioning_matches_jax(fresh):
    """The source encoded as both sides' concat channels, a zero latent of
    the source's size to sample from."""
    jv = jreg.load_vae("tiny-vae.sft")
    tv = treg.load_vae("tiny-vae.sft", device="cpu")
    img = np.random.default_rng(5).uniform(size=(1, 24, 32, 3)).astype(
        np.float32)
    ctx = np.random.default_rng(6).standard_normal((1, 77, 64)).astype(
        np.float32)
    tpos, tneg, tlat = get_op("InstructPixToPixConditioning").execute(
        OpContext(device="cpu"), Conditioning(torch.from_numpy(ctx)),
        Conditioning(torch.from_numpy(ctx)), tv, torch.from_numpy(img))
    jpos, jneg, jlat = jax_get_op("InstructPixToPixConditioning").execute(
        JaxOpContext(), JaxCond(context=ctx), JaxCond(context=ctx), jv, img)
    for t, j in ((tpos, jpos), (tneg, jneg)):
        assert t.concat_latent.shape == (1, 12, 16, 4)
        np.testing.assert_allclose(_np(t.concat_latent), j.concat_latent,
                                   **TOL)
    assert tpos.concat_latent is tneg.concat_latent
    np.testing.assert_array_equal(_np(tlat["samples"]),
                                  np.asarray(_np(jlat["samples"])))
    assert float(_np(tlat["samples"]).std()) == 0.0


# --- the whole workflow ----------------------------------------------------------

def ip2p_doc():
    """distributed-ip2p.json on tiny geometry, as tests/test_workflow.py
    runs it: the 8-channel tiny UNet by its name, the tiny text tower by
    CLIPLoader's type, the tiny VAE by its name; 2 steps."""
    doc = json.loads(IP2P.read_text())
    doc["2"]["inputs"]["unet_name"] = "tiny-ip2p-unet.sft"
    doc["3"]["inputs"].update(clip_name="tiny-clip.sft", type="tiny")
    doc["4"]["inputs"]["vae_name"] = "tiny-vae.sft"
    doc["9"]["inputs"]["steps"] = 2
    return doc


def _input(tmp_path):
    img = np.random.default_rng(1).uniform(size=(32, 40, 3)).astype(
        np.float32)
    save_png(str(tmp_path / "input.png"), img)


def test_ip2p_workflow_matches_the_jax_executor(fresh, tmp_path):
    _input(tmp_path)
    doc = ip2p_doc()
    ours = WorkflowExecutor(OpContext(device="cpu",
                                      input_dir=str(tmp_path))).execute(
        copy.deepcopy(doc))
    ref = JaxExecutor(JaxOpContext(input_dir=str(tmp_path))).execute(
        copy.deepcopy(doc))
    ref.wait_host()
    a, b = ours.image_batch, ref.image_batch
    assert a.shape == b.shape == (1, 32, 40, 3)
    assert np.isfinite(a).all() and a.std() > 0
    np.testing.assert_allclose(a, b, rtol=0, atol=IMAGE_ATOL)
    assert ours.outputs["2"][0].family.name == "tiny_ip2p"
    assert set(ours.timings) == set(doc) - {"__doc__"}


def test_ip2p_image_follows_the_source(fresh, tmp_path):
    """The source's latent steers every model call: zero concat channels
    give another latent."""
    _input(tmp_path)
    res = WorkflowExecutor(OpContext(device="cpu",
                                     input_dir=str(tmp_path))).execute(
        ip2p_doc())
    pos, neg, lat = res.outputs["8"]
    zero = [dataclasses.replace(c, concat_latent=torch.zeros_like(
        c.concat_latent)) for c in (pos, neg)]
    widgets = {k: v for k, v in ip2p_doc()["9"]["inputs"].items()
               if not isinstance(v, list)}
    (other,) = get_op("KSampler").execute(
        OpContext(device="cpu"), model=res.outputs["2"][0],
        seed=res.outputs["13"][0], positive=zero[0], negative=zero[1],
        latent_image=lat, **widgets)
    got = _np(res.outputs["9"][0]["samples"])
    assert np.abs(got - _np(other["samples"])).max() > 1e-3
