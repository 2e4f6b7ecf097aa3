"""The staged SDXL workflows in the port against the JAX package:
``workflows/distributed-sdxl-refiner.json`` (base -> refiner through two
KSamplerAdvanced windows) and ``workflows/distributed-hires-fix.json``
(LoraLoader, CLIPSetLastLayer, KSamplerAdvanced, LatentUpscale,
KSamplerAdvanced), with their ops, the ``sdxl_refiner`` family and its
single-file layout, and the token alignment of a longer positive.

The refiner workflow names two checkpoints, so the fixture maps each
name to a tiny stand-in of its own in both packages (``detect_family``
patched in both): the base to a two-tower family with an ADM head (an
HF tower and an OpenCLIP tower, both three layers deep and stopping at
the penultimate layer, as SDXL's do), the refiner to one OpenCLIP tower
under the refiner's declared checkpoint prefix and a pooled + 5 x 256
ADM.  Modules at fp32 agree within 2e-4, whole-workflow images within
2e-3."""

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
from comfyui_distributed_tpu.runtime import reuse as jreuse
from comfyui_distributed_tpu.workflow import WorkflowExecutor as JaxExecutor
from comfyui_distributed_tpu_torch.models import checkpoints as tckpt
from comfyui_distributed_tpu_torch.models import clip as tclip
from comfyui_distributed_tpu_torch.models import registry as treg
from comfyui_distributed_tpu_torch.models import unet as tunet
from comfyui_distributed_tpu_torch.models import vae as tvae
from comfyui_distributed_tpu_torch.ops import basic as tbasic
from comfyui_distributed_tpu_torch.ops.base import Conditioning, OpContext
from comfyui_distributed_tpu_torch.ops.base import get_op
from comfyui_distributed_tpu_torch.workflow import WorkflowExecutor

ROOT = pathlib.Path(__file__).resolve().parents[1]
REFINER_WF = ROOT / "workflows" / "distributed-sdxl-refiner.json"
HIRES_WF = ROOT / "workflows" / "distributed-hires-fix.json"
BASE = "tiny_xl_base"
REFINER = "tiny_xl_refiner"
BASE_CKPT = "sd_xl_base_1.0.safetensors"
REFINER_CKPT = "sd_xl_refiner_1.0.safetensors"
TOL = dict(rtol=2e-4, atol=2e-4)
IMAGE_ATOL = 2e-3
POOLED = 48


def stand_in(name, unet_mod, clip_mod, vae_mod, family_cls):
    """The tiny stand-in ``name`` built from one package's modules."""
    tower = dataclasses.replace(clip_mod.TINY_CLIP_CONFIG, layers=3,
                                output_layer=-2)
    bigg = dataclasses.replace(tower, projection_dim=POOLED,
                               layout="openclip")
    if name == BASE:
        return family_cls(
            name=BASE,
            unet=dataclasses.replace(unet_mod.TINY_CONFIG, context_dim=128,
                                     adm_in_channels=POOLED + 6 * 256),
            vae=vae_mod.TINY_VAE_CONFIG, clips=(tower, bigg))
    return family_cls(
        name=REFINER,
        unet=dataclasses.replace(unet_mod.TINY_CONFIG, context_dim=64,
                                 adm_in_channels=POOLED + 5 * 256),
        vae=vae_mod.TINY_VAE_CONFIG, clips=(bigg,),
        clip_prefixes=("conditioner.embedders.0.model.",))


def by_name(ckpt_name):
    return REFINER if "refiner" in ckpt_name.lower() else BASE


def clear_caches():
    """Every pipeline cache of both packages, and the JAX package's
    reuse plane: its encode memo keys a CLIPTextEncode* output on the
    graph's content (checkpoint name and text), not on the family the
    name resolved to, so a run of the same workflow under another
    family earlier in the process would hand the executor that
    family's conditionings."""
    jreg.clear_pipeline_cache()
    treg.clear_pipeline_cache()
    jreuse.get_reuse().clear()


def register_stand_ins(monkeypatch):
    """Both stand-ins in both registries, each checkpoint name routed to
    its own; every pipeline cache and the JAX reuse plane empty."""
    for name in (BASE, REFINER):
        monkeypatch.setitem(jreg.FAMILIES, name, stand_in(
            name, junet, jclip, jvae, jreg.ModelFamily))
        monkeypatch.setitem(treg.FAMILIES, name, stand_in(
            name, tunet, tclip, tvae, treg.ModelFamily))
    monkeypatch.delenv("DTPU_DEFAULT_FAMILY", raising=False)
    monkeypatch.setattr(jreg, "detect_family", by_name)
    monkeypatch.setattr(treg, "detect_family", by_name)
    clear_caches()


@pytest.fixture
def stand_ins(monkeypatch):
    register_stand_ins(monkeypatch)
    yield
    clear_caches()


def pipes(ckpt_name):
    return jreg.load_pipeline(ckpt_name), treg.load_pipeline(ckpt_name,
                                                             device="cpu")


def refiner_doc():
    doc = json.loads(REFINER_WF.read_text())
    doc["3"]["inputs"].update(width=64, height=64)
    doc["8"]["inputs"].update(steps=4, end_at_step=3)
    doc["9"]["inputs"].update(steps=4, start_at_step=3)
    return doc


def hires_doc():
    doc = json.loads(HIRES_WF.read_text())
    doc["5"]["inputs"].update(width=32, height=32)
    doc["3"]["inputs"].update(steps=2, end_at_step=1)
    doc["10"]["inputs"].update(width=64, height=64)
    doc["11"]["inputs"].update(steps=2, start_at_step=1)
    return doc


# --- the sdxl_refiner family ---------------------------------------------------

def test_refiner_family_is_the_jax_packages():
    j, t = jreg.FAMILIES["sdxl_refiner"], treg.FAMILIES["sdxl_refiner"]
    for field in ("model_channels", "channel_mult", "num_res_blocks",
                  "transformer_depth", "transformer_depth_middle",
                  "context_dim", "adm_in_channels", "num_head_channels",
                  "use_linear_in_transformer"):
        assert getattr(t.unet, field) == getattr(j.unet, field), field
    assert [(c.width, c.layers, c.output_layer, c.layout, c.projection_dim)
            for c in t.clips] == [(c.width, c.layers, c.output_layer,
                                   c.layout, c.projection_dim)
                                  for c in j.clips]
    assert t.clip_prefixes == j.clip_prefixes \
        == ("conditioner.embedders.0.model.",)
    assert tckpt._clip_prefixes(t) == list(t.clip_prefixes)
    assert treg.detect_family(REFINER_CKPT) == "sdxl_refiner"


def test_refiner_unet_attention_layout():
    """44 transformer blocks (16 down, 4 in the middle, 24 up), 12 heads
    at 768 channels (the 64^2 level of a 1024^2 image) and 24 at 1536
    (the 32^2 level and the 16^2 middle), D = 64 throughout: 88
    attention launches a CFG model call."""
    with torch.device("meta"):
        unet = tunet.UNet(treg.FAMILIES["sdxl_refiner"].unet)
    blocks = {name: m for name, m in unet.named_modules()
              if type(m).__name__ == "TransformerBlock"}
    assert len(blocks) == 44
    assert sum(n.startswith("down") for n in blocks) == 16
    assert sum(n.startswith("mid") for n in blocks) == 4
    assert sum(n.startswith("up") for n in blocks) == 24
    heads = {(n.split("_")[1], m.attn1.num_heads, m.attn1.head_dim,
              m.attn2.num_heads, m.attn2.head_dim)
             for n, m in blocks.items()}
    assert heads == {("1", 12, 64, 12, 64), ("2", 24, 64, 24, 64),
                     ("attn.blocks", 24, 64, 24, 64)}


# --- KSamplerAdvanced ---------------------------------------------------------

def _conds(tpipe):
    pos, pooled = tpipe.encode_prompt(["a lighthouse, volumetric light"])
    neg, npooled = tpipe.encode_prompt(["blurry"])
    t = (Conditioning(pos, pooled), Conditioning(neg, npooled))
    j = tuple(JaxCond(context=c.context.numpy(), pooled=c.pooled.numpy())
              for c in t)
    return t, j


def _advanced(get, ctx, pipe, pos, neg, latent, **widgets):
    w = dict(add_noise="enable", noise_seed=31, steps=4, cfg=5.0,
             sampler_name="euler", scheduler="karras", start_at_step=0,
             end_at_step=10000, return_with_leftover_noise="disable")
    w.update(widgets)
    (out,) = get("KSamplerAdvanced").execute(
        ctx, model=pipe, positive=pos, negative=neg, latent_image=latent,
        **w)
    return out


def _np(out):
    return np.asarray(out["samples"].to_host())


def _both(jpipe, tpipe, conds, latent, **widgets):
    (tp, tn), (jp, jn) = conds
    t = _advanced(get_op, OpContext(device="cpu"), tpipe, tp, tn,
                  {"samples": latent}, **widgets)
    j = _advanced(jax_get_op, JaxOpContext(), jpipe, jp, jn,
                  {"samples": latent}, **widgets)
    return _np(t), _np(j)


def _latent(seed=3, shape=(1, 8, 8, 4)):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def test_full_window_is_ksampler_and_matches_jax(stand_ins):
    jpipe, tpipe = pipes(BASE_CKPT)
    conds = _conds(tpipe)
    zeros = np.zeros((1, 8, 8, 4), np.float32)
    t, j = _both(jpipe, tpipe, conds, zeros)
    np.testing.assert_allclose(t, j, **TOL)
    (tp, tn), _ = conds
    (ks,) = get_op("KSampler").execute(
        OpContext(device="cpu"), model=tpipe, seed=31, steps=4, cfg=5.0,
        sampler_name="euler", scheduler="karras", positive=tp, negative=tn,
        latent_image={"samples": zeros})
    np.testing.assert_array_equal(t, ks["samples"].to_host())


@pytest.mark.parametrize("sampler", ["euler", "euler_ancestral"])
def test_split_window_hands_on_leftover_noise(stand_ins, sampler):
    """(0, 2) with leftover noise, then (2, 4) without adding noise, in
    each package; stage 2's fold-in indices count from its window's
    start (the ancestral sampler draws at each).  euler's split equals
    its whole run to the bit."""
    jpipe, tpipe = pipes(BASE_CKPT)
    conds = _conds(tpipe)
    zeros = np.zeros((1, 8, 8, 4), np.float32)
    first = dict(sampler_name=sampler, end_at_step=2,
                 return_with_leftover_noise="enable")
    t1, j1 = _both(jpipe, tpipe, conds, zeros, **first)
    np.testing.assert_allclose(t1, j1, **TOL)
    second = dict(sampler_name=sampler, add_noise="disable", start_at_step=2)
    t2 = _np(_advanced(get_op, OpContext(device="cpu"), tpipe, *conds[0],
                       {"samples": torch.from_numpy(t1)}, **second))
    j2 = _np(_advanced(jax_get_op, JaxOpContext(), jpipe, *conds[1],
                       {"samples": j1}, **second))
    np.testing.assert_allclose(t2, j2, **TOL)
    if sampler == "euler":
        whole = _np(_advanced(get_op, OpContext(device="cpu"), tpipe,
                              *conds[0], {"samples": zeros}))
        np.testing.assert_array_equal(t2, whole)


def test_force_full_denoise_zeroes_the_windows_last_sigma(stand_ins):
    jpipe, tpipe = pipes(BASE_CKPT)
    conds = _conds(tpipe)
    lat = _latent()
    t, j = _both(jpipe, tpipe, conds, lat, end_at_step=2,
                 return_with_leftover_noise="disable")
    np.testing.assert_allclose(t, j, **TOL)
    left, _ = _both(jpipe, tpipe, conds, lat, end_at_step=2,
                    return_with_leftover_noise="enable")
    assert not np.allclose(t, left)


@pytest.mark.parametrize("window", [(4, 10000), (3, 2)])
def test_degenerate_window_returns_the_latent(stand_ins, window):
    jpipe, tpipe = pipes(BASE_CKPT)
    conds = _conds(tpipe)
    lat = _latent()
    t, j = _both(jpipe, tpipe, conds, lat, start_at_step=window[0],
                 end_at_step=window[1])
    np.testing.assert_array_equal(t, lat)
    np.testing.assert_array_equal(j, lat)


def test_pipeline_window_noise_scales_by_the_windows_first_sigma(stand_ins):
    """add_noise on a window that starts late: the latent plus the
    initial noise times sigma_start, as the JAX pipeline adds it."""
    jpipe, tpipe = pipes(BASE_CKPT)
    (tp, tn), _ = _conds(tpipe)
    lat = torch.from_numpy(_latent())
    seeds = np.array([9], np.uint64)
    kw = dict(steps=6, cfg=4.0, sampler_name="euler", scheduler="normal",
              start_step=4, end_step=6)
    t = tpipe.sample(lat, tp.context, tn.context, seeds,
                     y=torch.zeros(1, POOLED + 6 * 256), **kw)
    j = jpipe.sample(lat.numpy(), tp.context.numpy(), tn.context.numpy(),
                     seeds, y=np.zeros((1, POOLED + 6 * 256), np.float32),
                     **kw)
    np.testing.assert_allclose(t.numpy(), np.asarray(j), **TOL)


# --- conditioning: the refiner encode, the ADM fallback, token lengths --------

def test_clip_text_encode_sdxl_refiner_matches_jax(stand_ins):
    jpipe, tpipe = pipes(REFINER_CKPT)
    args = dict(ascore=2.5, width=1024, height=768, text="a cat, (fog:1.2)")
    (jc,) = jax_get_op("CLIPTextEncodeSDXLRefiner").execute(
        JaxOpContext(), jpipe, **args)
    (tc,) = get_op("CLIPTextEncodeSDXLRefiner").execute(
        OpContext(device="cpu"), tpipe, **args)
    assert tc.size_cond == tuple(jc.size_cond) == (768, 1024, 0, 0, 2.5)
    assert tc.context.shape == (1, 77, 64) and tc.pooled.shape == (1, POOLED)
    np.testing.assert_allclose(tc.context.numpy(), np.asarray(jc.context),
                               **TOL)
    np.testing.assert_allclose(tc.pooled.numpy(), np.asarray(jc.pooled),
                               **TOL)
    lat = {"samples": np.zeros((1, 6, 10, 4), np.float32)}
    ty = tbasic._prepare_sample_inputs(tpipe, 7, lat, tc, tc).y
    jcond = JaxCond(context=tc.context.numpy(), pooled=tc.pooled.numpy(),
                    size_cond=tc.size_cond)
    jy = jbasic._prepare_sample_inputs(JaxOpContext(), jpipe, 7, lat, jcond,
                                       jcond).y
    assert ty.shape == (1, POOLED + 5 * 256)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **TOL)


@pytest.mark.parametrize("which", [REFINER_CKPT, BASE_CKPT])
def test_adm_fallback_without_size_scalars(stand_ins, which):
    """A plain CLIPTextEncode feeding the refiner: (H, W, 0, 0, 6.0), the
    fifth scalar the aesthetic score; on the base (H, W, 0, 0, H, W)."""
    jpipe, tpipe = pipes(which)
    (tc,) = get_op("CLIPTextEncode").execute(OpContext(device="cpu"), tpipe,
                                             text="a dog")
    lat = {"samples": np.zeros((1, 6, 10, 4), np.float32)}
    ty = tbasic._prepare_sample_inputs(tpipe, 7, lat, tc, tc).y
    jcond = JaxCond(context=tc.context.numpy(), pooled=tc.pooled.numpy())
    jy = jbasic._prepare_sample_inputs(JaxOpContext(), jpipe, 7, lat, jcond,
                                       jcond).y
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **TOL)
    scalars = (48, 80, 0, 0, 6.0) if which == REFINER_CKPT \
        else (48, 80, 0, 0, 48, 80)
    want = tbasic._sdxl_vector_cond(
        tpipe, Conditioning(tc.context, tc.pooled, scalars), 1, 0, 0)
    np.testing.assert_array_equal(ty, want)


@pytest.mark.parametrize("neg_tokens", [77, 100])
def test_conditionings_of_other_token_lengths_align_as_jax(stand_ins,
                                                            neg_tokens):
    """A 154-token positive (two 77-token chunks) against a 77-token
    negative repeats the negative whole (the lcm); against 100 tokens
    (lcm 7700 > 8 x 154) the shorter is zero-padded.  Sampled through
    KSampler in both packages."""
    jpipe, tpipe = pipes(BASE_CKPT)
    a, pooled = tpipe.encode_prompt(["a lighthouse"])
    b, _ = tpipe.encode_prompt(["volumetric light, dawn"])
    n, npooled = tpipe.encode_prompt(["blurry"])
    pos = torch.cat([a, b], dim=1)
    neg = torch.cat([n, n], dim=1)[:, :neg_tokens]
    if neg_tokens == 77:
        assert tbasic.cond_token_align([Conditioning(pos), Conditioning(
            neg)]) == 154
        np.testing.assert_array_equal(
            tbasic.align_cond_tokens(neg, 154), torch.cat([neg, neg], 1))
    else:
        assert tbasic.cond_token_align([Conditioning(pos), Conditioning(
            neg)]) == 154
        assert torch.equal(tbasic.align_cond_tokens(neg, 154)[:, 100:],
                           torch.zeros(1, 54, neg.shape[-1]))
    zeros = np.zeros((1, 8, 8, 4), np.float32)
    w = dict(seed=5, steps=2, cfg=5.0, sampler_name="euler",
             scheduler="karras", latent_image={"samples": zeros})
    (t,) = get_op("KSampler").execute(
        OpContext(device="cpu"), model=tpipe,
        positive=Conditioning(pos, pooled), negative=Conditioning(neg,
                                                                   npooled),
        **w)
    (j,) = jax_get_op("KSampler").execute(
        JaxOpContext(), model=jpipe,
        positive=JaxCond(context=pos.numpy(), pooled=pooled.numpy()),
        negative=JaxCond(context=neg.numpy(), pooled=npooled.numpy()), **w)
    np.testing.assert_allclose(t["samples"].to_host(),
                               np.asarray(j["samples"]), **TOL)


# --- CLIPSetLastLayer ---------------------------------------------------------

@pytest.mark.parametrize("stop", [-2, -1, -3])
def test_clip_set_last_layer(stand_ins, stop):
    """At the towers' own layer (-2, SDXL's, as the hires-fix sets it)
    the CLIP comes back as the same object; at -1 and -3 a derived
    pipeline (cached, the modules' weights shared) encodes as the JAX
    package's at that layer."""
    jpipe, tpipe = pipes(BASE_CKPT)
    op = get_op("CLIPSetLastLayer")
    (tclip_out,) = op.execute(OpContext(device="cpu"), tpipe,
                              stop_at_clip_layer=stop)
    (jclip_out,) = jax_get_op("CLIPSetLastLayer").execute(
        JaxOpContext(), jpipe, stop_at_clip_layer=stop)
    if stop == -2:
        assert tclip_out is tpipe and jclip_out is jpipe
        return
    assert tclip_out is not tpipe
    assert op.execute(OpContext(device="cpu"), tpipe,
                      stop_at_clip_layer=stop)[0] is tclip_out
    assert [c.output_layer for c in tclip_out.family.clips] == [stop, stop]
    assert tclip_out.unet is tpipe.unet and tclip_out.vae is tpipe.vae
    for a, b in zip(tclip_out.clip_models, tpipe.clip_models):
        assert a is not b and a.cfg.output_layer == stop
        assert all(p is q for p, q in zip(a.parameters(), b.parameters()))
    text = ["ornate clockwork city, golden hour"]
    tctx, tpooled = tclip_out.encode_prompt(text)
    jctx, jpooled = jclip_out.encode_prompt(text)
    np.testing.assert_allclose(tctx.numpy(), np.asarray(jctx), **TOL)
    np.testing.assert_allclose(tpooled.numpy(), np.asarray(jpooled), **TOL)
    assert not torch.allclose(tctx, tpipe.encode_prompt(text)[0])


# --- LatentUpscale ------------------------------------------------------------

@pytest.mark.parametrize("op,widgets", [
    ("LatentUpscale", dict(upscale_method="nearest-exact", width=120,
                           height=64, crop="disabled")),
    ("LatentUpscale", dict(upscale_method="bilinear", width=40, height=96,
                           crop="disabled")),
    ("LatentUpscale", dict(upscale_method="nearest-exact", width=0,
                           height=112, crop="disabled")),
    ("LatentUpscale", dict(upscale_method="bicubic", width=136, height=0,
                           crop="center")),
    ("LatentUpscale", dict(upscale_method="area", width=0, height=0,
                           crop="disabled")),
    ("LatentUpscale", dict(upscale_method="nearest-exact", width=128,
                           height=128, crop="center")),
    ("LatentUpscale", dict(upscale_method="bilinear", width=56, height=120,
                           crop="center")),
    ("LatentUpscaleBy", dict(upscale_method="nearest-exact", scale_by=1.5)),
    ("LatentUpscaleBy", dict(upscale_method="bislerp", scale_by=0.6)),
])
def test_latent_upscale_matches_jax(op, widgets):
    """On a [2, 7, 9, 4] latent: pixel widgets divided by 8, a 0 side
    following the aspect, 0/0 passing through, the centre crop."""
    lat = _latent(11, (2, 7, 9, 4))
    (t,) = get_op(op).execute(OpContext(device="cpu"), {"samples": lat},
                              **widgets)
    (j,) = jax_get_op(op).execute(JaxOpContext(), {"samples": lat},
                                  **widgets)
    want = np.asarray(j["samples"])
    got = t["samples"].to_host()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, **TOL)
    if widgets.get("width") == 0 and widgets.get("height") == 0:
        np.testing.assert_array_equal(got, lat)


# --- a refiner-layout single file ----------------------------------------------

def test_refiner_file_loads_its_bigg_tower_in_both_packages(stand_ins,
                                                           tmp_path):
    """The port writes the refiner stand-in as a single file: its tower
    goes under ``conditioner.embedders.0.model.``, every key feeds a
    parameter, and both packages' loaders read the file back to the
    virtual weights (the prompt encodes as before)."""
    _, tpipe = pipes(REFINER_CKPT)
    path = tmp_path / REFINER_CKPT
    tckpt.save_checkpoint(str(path), tpipe.unet, tpipe.clip_models,
                          tpipe.vae, tpipe.family)
    sd = tckpt.load_state_dict(str(path))
    pre = "conditioner.embedders.0.model."
    assert f"{pre}transformer.resblocks.0.attn.in_proj_weight" in sd
    assert f"{pre}text_projection" in sd
    assert not any(k.startswith("cond_stage_model.") for k in sd)
    assert tckpt.unconsumed_keys(sd, tpipe.family) == []
    text = ["a lighthouse at dawn"]
    want = tpipe.encode_prompt(text)
    treg.clear_pipeline_cache()
    jreg.clear_pipeline_cache()
    tfile = treg.load_pipeline(REFINER_CKPT, models_dir=str(tmp_path),
                               device="cpu")
    jfile = jreg.load_pipeline(REFINER_CKPT, models_dir=str(tmp_path))
    for a, b in zip(tfile.clip_models[0].parameters(),
                    tpipe.clip_models[0].parameters()):
        assert torch.equal(a, b)
    got = tfile.encode_prompt(text)
    jgot = jfile.encode_prompt(text)
    for g, jg, w in zip(got, jgot, want):
        assert torch.equal(g, w)
        np.testing.assert_allclose(np.asarray(jg), w.numpy(), **TOL)


# --- the two workflows --------------------------------------------------------

@pytest.mark.parametrize("which", ["refiner", "hires_fix"])
def test_workflow_matches_the_jax_executor(stand_ins, which):
    doc = refiner_doc() if which == "refiner" else hires_doc()
    ours = WorkflowExecutor(OpContext(device="cpu")).execute(
        copy.deepcopy(doc))
    ref = JaxExecutor(JaxOpContext()).execute(copy.deepcopy(doc))
    ref.wait_host()
    a, b = ours.image_batch, ref.image_batch
    assert a.shape == b.shape == (1, 16, 16, 3)
    assert np.isfinite(a).all() and a.std() > 0
    np.testing.assert_allclose(a, b, rtol=0, atol=IMAGE_ATOL)
    assert set(ours.timings) == set(doc) - {"__doc__"}
    if which == "refiner":
        base, refiner = ours.outputs["1"][0], ours.outputs["2"][0]
        assert (base.family.name, refiner.family.name) == (BASE, REFINER)
        assert ours.outputs["6"][0].size_cond == (1024, 1024, 0, 0, 6.0)
    else:
        # the LoRA patched the pipeline; clip-skip -2 was a no-op on it
        assert ours.outputs["20"][0] is not ours.outputs["4"][0]
        assert ours.outputs["21"][0] is ours.outputs["20"][1]
        assert ours.outputs["10"][0]["samples"].shape == (1, 8, 8, 4)


def test_refiner_handoff_differs_from_the_base_alone(stand_ins):
    """The refiner's window changes the image: the base run to the end
    (no leftover noise) gives another one."""
    doc = refiner_doc()
    whole = copy.deepcopy(doc)
    whole["8"]["inputs"].update(end_at_step=10000,
                                return_with_leftover_noise="disable")
    whole["10"]["inputs"]["samples"] = ["8", 0]
    del whole["9"]
    a = WorkflowExecutor(OpContext(device="cpu")).execute(doc).image_batch
    b = WorkflowExecutor(OpContext(device="cpu")).execute(whole).image_batch
    assert np.isfinite(b).all() and not np.allclose(a, b, atol=1e-3)
