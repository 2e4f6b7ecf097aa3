"""The UNet's structural patches in the port against the JAX package:
FreeU (v1 and v2, with its Fourier filter), HyperTile (the tiling rule
and the folded self-attention), deep shrink (``jax.image.resize``'s
bilinear filter, the level rule, the sigma window in the sampler, its
drop under a ControlNet), the ops that set them (FreeU, FreeU_V2,
HyperTile, PatchModelAddDownscale), the Canny hint preprocessor, and the
schemas of the slice's nine ops.

Both packages get the same numpy inputs and the same virtual weights;
the tiny family in fp32.  Modules, UNet outputs and samples agree within
rtol = atol = 2e-4, the Canny edges and the derived configs exactly."""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import comfyui_distributed_tpu.ops.basic  # noqa: F401  (registers the ops)
import comfyui_distributed_tpu_torch.ops.basic  # noqa: F401
from comfyui_distributed_tpu.models import layers as jlayers
from comfyui_distributed_tpu.models import registry as jreg
from comfyui_distributed_tpu.models import unet as junet
from comfyui_distributed_tpu.ops import base as jbase
from comfyui_distributed_tpu.ops.base import Conditioning as JaxCond
from comfyui_distributed_tpu.ops.base import OpContext as JaxOpContext
from comfyui_distributed_tpu.ops.base import get_op as jax_get_op
from comfyui_distributed_tpu.runtime import reuse as jreuse
from comfyui_distributed_tpu_torch.models import layers as tlayers
from comfyui_distributed_tpu_torch.models import registry as treg
from comfyui_distributed_tpu_torch.models import unet as tunet
from comfyui_distributed_tpu_torch.models.weights import state_dict_from_flax
from comfyui_distributed_tpu_torch.ops import base as tbase
from comfyui_distributed_tpu_torch.ops.base import Conditioning, OpContext
from comfyui_distributed_tpu_torch.ops.base import get_op

TOL = dict(rtol=2e-4, atol=2e-4)
CPU = torch.device("cpu")
NINE_OPS = ("ControlNetLoader", "DiffControlNetLoader", "ControlNetApply",
            "ControlNetApplyAdvanced", "Canny", "FreeU", "FreeU_V2",
            "HyperTile", "PatchModelAddDownscale")


def _np(x):
    if hasattr(x, "to_host"):
        return x.to_host()
    if isinstance(x, torch.Tensor):
        return x.detach().float().cpu().numpy()
    return np.asarray(x, np.float32)


def _clear():
    for clear in (jreg.clear_pipeline_cache, treg.clear_pipeline_cache,
                  jreuse.get_reuse().clear):
        clear()


@pytest.fixture(scope="module")
def env():
    saved = os.environ.get("DTPU_DEFAULT_FAMILY")
    os.environ["DTPU_DEFAULT_FAMILY"] = "tiny"
    _clear()
    yield
    _clear()
    if saved is None:
        os.environ.pop("DTPU_DEFAULT_FAMILY", None)
    else:
        os.environ["DTPU_DEFAULT_FAMILY"] = saved


@pytest.fixture(scope="module")
def weights():
    """The tiny UNet's virtual weights (JAX tree) and one input batch."""
    up = jreg._virtual_params(junet.UNet(junet.TINY_CONFIG), 7,
                              jnp.zeros((1, 16, 16, 4)), jnp.zeros((1,)),
                              jnp.zeros((1, 77, 64)))
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 16, 16, 4)).astype(np.float32)
    t = np.asarray([999.0, 20.5], np.float32)
    c = rng.standard_normal((2, 77, 64)).astype(np.float32)
    return up, (x, t, c)


# --- the pieces ----------------------------------------------------------------

@pytest.mark.parametrize("shape,threshold,scale", [
    ((1, 4, 8, 8), 1, 0.2), ((2, 3, 6, 10), 1, 0.9), ((1, 2, 5, 7), 2, 0.0),
    ((1, 4, 8, 8), 1, 1.0)])
def test_fourier_filter_matches_jax(shape, threshold, scale):
    x = np.random.default_rng(1).standard_normal(shape).astype(np.float32)
    want = junet._fourier_filter(jnp.asarray(x.transpose(0, 2, 3, 1)),
                                 threshold, scale)
    got = tunet._fourier_filter(torch.from_numpy(x), threshold, scale)
    np.testing.assert_allclose(_np(got.permute(0, 2, 3, 1)),
                               np.asarray(want), rtol=0, atol=1e-5)


@pytest.mark.parametrize("src,dst", [
    ((16, 16), (8, 8)), ((32, 32), (16, 16)), ((15, 9), (5, 3)),
    ((8, 8), (16, 16)), ((5, 7), (10, 13)), ((16, 16), (16, 8)),
    ((11, 11), (4, 4))])
def test_resize_bilinear_matches_jax_image_resize(src, dst):
    """Deep shrink's two resizes: ``jax.image.resize(..., "bilinear")``,
    antialiased when it shrinks, an unchanged axis left alone."""
    x = np.random.default_rng(2).standard_normal(
        (2, 3, *src)).astype(np.float32)
    want = jax.image.resize(jnp.asarray(x.transpose(0, 2, 3, 1)),
                            (2, *dst, 3), method="bilinear")
    got = tunet.resize_bilinear(torch.from_numpy(x), *dst)
    np.testing.assert_allclose(_np(got.permute(0, 2, 3, 1)),
                               np.asarray(want), rtol=0, atol=2e-6)


def test_hypertile_divisor_matches_jax():
    for n in range(1, 97):
        for tile in (1, 2, 3, 4, 8, 16, 32):
            assert tlayers._hypertile_divisor(n, tile) \
                == jlayers._hypertile_divisor(n, tile), (n, tile)


@pytest.mark.parametrize("hw,tile", [((16, 16), 8), ((12, 20), 3)])
def test_tiled_spatial_transformer_matches_jax(hw, tile):
    """The token grid folded into tiles on the batch axis (the context
    repeated per tile), the blocks run, and the grid unfolded."""
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, *hw, 32)).astype(np.float32)
    ctx = rng.standard_normal((2, 7, 24)).astype(np.float32)
    jmod = jlayers.SpatialTransformer(num_heads=2, depth=1,
                                      dtype=jnp.float32, hypertile_tile=tile)
    params = jmod.init(jax.random.PRNGKey(0), jnp.asarray(x),
                       jnp.asarray(ctx))["params"]
    want = jmod.apply({"params": params}, jnp.asarray(x), jnp.asarray(ctx))
    tmod = tlayers.SpatialTransformer(32, 2, 1, 24, dtype=torch.float32)
    tmod.load_state_dict(state_dict_from_flax(
        tmod, jax.tree_util.tree_map(np.asarray, params)))
    with torch.no_grad():
        got = tmod.eval()(torch.from_numpy(x).permute(0, 3, 1, 2),
                          torch.from_numpy(ctx), tile)
    np.testing.assert_allclose(_np(got.permute(0, 2, 3, 1)),
                               np.asarray(want), **TOL)


PATCHES = {
    "freeu": dict(freeu=(1.5, 1.6, 0.9, 0.2)),
    "freeu_v2": dict(freeu=(1.5, 1.6, 0.9, 0.2), freeu_version=2),
    "hypertile_scaled": dict(hypertile=(32, 1, True)),
    "hypertile_mid": dict(hypertile=(32, 3, False)),
    "deep_shrink": dict(deep_shrink=(1, 2.0)),
    "deep_shrink_odd": dict(deep_shrink=(0, 3.0)),
    "tome_hypertile": dict(tome_ratio=0.4, hypertile=(32, 1, False)),
}


@pytest.mark.parametrize("name", sorted(PATCHES))
def test_patched_unet_matches_jax(weights, name):
    """The tiny UNet under each patch against the JAX UNet under the
    same config; every patch moves the output off the plain UNet's."""
    up, (x, t, c) = weights
    jcfg = dataclasses.replace(junet.TINY_CONFIG, **PATCHES[name])
    want = junet.UNet(jcfg).apply({"params": up}, jnp.asarray(x),
                                  jnp.asarray(t), jnp.asarray(c))
    plain = tunet.UNet(tunet.TINY_CONFIG)
    plain.load_state_dict(state_dict_from_flax(
        plain, jax.tree_util.tree_map(np.asarray, up)))
    patched = tunet.with_config(plain.eval(), dataclasses.replace(
        tunet.TINY_CONFIG, **PATCHES[name]))
    assert patched.conv_in.weight is plain.conv_in.weight
    args = [torch.from_numpy(a) for a in (x, t, c)]
    with torch.no_grad():
        got = patched(*args)
        base = plain(*args)
    np.testing.assert_allclose(_np(got), np.asarray(want), **TOL)
    assert np.abs(_np(got) - _np(base)).max() > 1e-4


def test_unported_patches_still_raise_and_with_config_guards_weights():
    """Every patch of the JAX UNet is ported now (nothing raises): ToMe
    rides shared weights like the other patches, GLIGEN's fusers are
    weights of their own, and with_config refuses any other change."""
    with torch.device("meta"):
        unet = tunet.UNet(tunet.TINY_CONFIG)
        # SAG's capture is ported: a patch field on shared weights
        tunet.UNet(dataclasses.replace(tunet.TINY_CONFIG, sag_capture=True))
    assert tunet.with_config(unet, tunet.TINY_CONFIG) is unet
    with pytest.raises(ValueError, match="context_dim"):
        tunet.with_config(unet, dataclasses.replace(tunet.TINY_CONFIG,
                                                    context_dim=32))
    # ToMe changes no weight; GLIGEN's fusers are weights of their own
    tome = tunet.with_config(unet, dataclasses.replace(tunet.TINY_CONFIG,
                                                       tome_ratio=0.5))
    assert tome.conv_in.weight is unet.conv_in.weight
    with pytest.raises(ValueError, match="gligen"):
        tunet.with_config(unet, dataclasses.replace(tunet.TINY_CONFIG,
                                                    gligen=16))


# --- the ops -------------------------------------------------------------------

def _pipes(name):
    return jreg.load_pipeline(name), treg.load_pipeline(name, device=CPU)


def test_patch_ops_derive_shared_pipelines_like_jax(env):
    """FreeU, FreeU_V2 and HyperTile derive a pipeline whose UNet config
    is the JAX package's and whose weights are the base's (cached per
    setting); PatchModelAddDownscale's level and timestep window equal
    the JAX package's; the patches ride further derivations."""
    jp, tp = _pipes("patches.ckpt")
    jctx, tctx = JaxOpContext(), OpContext(device="cpu")
    for op, args in (("FreeU", (1.5, 1.6, 0.5, 0.5)),
                     ("FreeU_V2", (1.5, 1.6, 0.5, 0.5)),
                     ("HyperTile", (64, 2, 1, "true")),
                     ("HyperTile", (256, 3, 0, False))):
        (jd,) = jax_get_op(op).execute(jctx, jp, *args)
        (td,) = get_op(op).execute(tctx, tp, *args)
        for f in ("freeu", "freeu_version", "hypertile"):
            assert getattr(td.family.unet, f) == getattr(jd.family.unet, f)
        assert td.unet.cfg == td.family.unet
        assert td.unet.conv_in.weight is tp.unet.conv_in.weight
        assert get_op(op).execute(tctx, tp, *args)[0] is td
    for block in (1, 2, 3, 5):
        args = (block, 2.0, 0.1, 0.6, True, "bicubic", "bicubic")
        (jd,) = jax_get_op("PatchModelAddDownscale").execute(jctx, jp, *args)
        (td,) = get_op("PatchModelAddDownscale").execute(tctx, tp, *args)
        assert td.deep_shrink_spec == jd.deep_shrink_spec
        assert td.unet is tp.unet
    assert [get_op("PatchModelAddDownscale").execute(
        tctx, tp, b, 2.0, 0.0, 0.5, True, "", "")[0].deep_shrink_spec[0]
        for b in (1, 2, 3)] == [0.0, 1.0, 1.0]
    (shrunk,) = get_op("PatchModelAddDownscale").execute(
        tctx, tp, 2, 2.0, 0.0, 0.35, True, "", "")
    (both,) = get_op("FreeU").execute(tctx, shrunk, 1.1, 1.2, 0.9, 0.2)
    assert both.deep_shrink_spec == shrunk.deep_shrink_spec
    (lora, _) = get_op("LoraLoader").execute(tctx, both, both,
                                             "s.safetensors", 0.5, 0.5)
    assert lora.deep_shrink_spec == shrunk.deep_shrink_spec
    assert lora.unet.cfg.freeu == both.family.unet.freeu


def _sample(pkg, pipe, pos, neg, steps=3, lat=None):
    lat = lat or {"samples": np.zeros((1, 16, 16, 4), np.float32)}
    if pkg == "jax":
        (out,) = jax_get_op("KSampler").execute(
            JaxOpContext(), pipe, 5, steps, 4.0, "euler", "normal", pos,
            neg, lat, 1.0)
        return np.asarray(out["samples"])
    (out,) = get_op("KSampler").execute(
        OpContext(device="cpu"), pipe, 5, steps, 4.0, "euler", "normal",
        pos, neg, lat, 1.0)
    return _np(out["samples"])


SAMPLE_PATCHES = {
    "freeu_v2": ("FreeU_V2", (1.4, 1.6, 0.8, 0.4)),
    "hypertile": ("HyperTile", (64, 2, 1, False)),
    # the window covers the first two of three steps
    "deep_shrink": ("PatchModelAddDownscale",
                    (2, 2.0, 0.0, 0.6, True, "bicubic", "bicubic")),
}


@pytest.mark.parametrize("name", sorted(SAMPLE_PATCHES))
def test_patched_sampling_matches_jax(env, name):
    """KSampler on each patched pipeline against the JAX package's (deep
    shrink: the shrunk UNet inside the window, the plain one after it);
    each differs from the plain sample."""
    jp, tp = _pipes(f"{name}.ckpt")
    op, args = SAMPLE_PATCHES[name]
    (jd,) = jax_get_op(op).execute(JaxOpContext(), jp, *args)
    (td,) = get_op(op).execute(OpContext(device="cpu"), tp, *args)
    ctx, _ = tp.encode_prompt(["a fox"])
    neg, _ = tp.encode_prompt([""])
    want = _sample("jax", jd, JaxCond(context=_np(ctx)),
                   JaxCond(context=_np(neg)))
    got = _sample("torch", td, Conditioning(context=ctx),
                  Conditioning(context=neg))
    np.testing.assert_allclose(got, want, **TOL)
    plain = _sample("torch", tp, Conditioning(context=ctx),
                    Conditioning(context=neg))
    assert np.abs(got - plain).max() > 1e-3


def test_deep_shrink_window_and_its_drop_under_a_control(env, capfd):
    """A window that never opens samples as the plain pipeline does, to
    the bit; under a ControlNet the patch is dropped with the JAX
    package's log line, so the sample equals the controlled plain one to
    the bit."""
    _, tp = _pipes("dshrink.ckpt")
    tctx = OpContext(device="cpu")
    ctx, _ = tp.encode_prompt(["a fox"])
    pos, neg = Conditioning(context=ctx), Conditioning(
        context=tp.encode_prompt([""])[0])
    plain = _sample("torch", tp, pos, neg)
    (never,) = get_op("PatchModelAddDownscale").execute(
        tctx, tp, 2, 2.0, 0.0, 0.0, True, "", "")
    np.testing.assert_array_equal(_sample("torch", never, pos, neg), plain)
    (shrunk,) = get_op("PatchModelAddDownscale").execute(
        tctx, tp, 2, 2.0, 0.0, 0.6, True, "", "")
    net = treg.load_controlnet("dshrink_cn.safetensors", device=CPU)
    with torch.no_grad():
        for name, p in net.named_parameters():
            if name.startswith("zero_conv_") or name.startswith("mid_out"):
                p.normal_(0.0, 0.05, generator=torch.Generator().manual_seed(
                    len(name)))
    hint = torch.rand((1, 128, 128, 3), generator=torch.Generator()
                      .manual_seed(1))
    (cpos,) = get_op("ControlNetApply").execute(tctx, pos, net, hint, 1.0)
    capfd.readouterr()
    under = _sample("torch", shrunk, cpos, neg)
    assert "sampling WITHOUT the downscale patch" in "".join(
        capfd.readouterr())
    controlled = _sample("torch", tp, cpos, neg)
    np.testing.assert_array_equal(under, controlled)
    assert np.abs(controlled - plain).max() > 1e-3
    treg._controlnet_cache.clear()


def test_a_deep_shrink_graph_is_refused_by_continuous_batching(env, tmp_path):
    """The continuous-batching bucket build refuses a pipeline with deep
    shrink (``CBIneligible``), as the JAX package's does: a bucket's
    step runs the plain UNet."""
    from comfyui_distributed_tpu_torch.workflow import batch_executor as tcb
    doc = {
        "4": {"class_type": "CheckpointLoaderSimple",
              "inputs": {"ckpt_name": "dshrink_cb.ckpt"}},
        "30": {"class_type": "PatchModelAddDownscale",
               "inputs": {"model": ["4", 0], "block_number": 2,
                          "downscale_factor": 2.0, "start_percent": 0.0,
                          "end_percent": 0.6, "downscale_after_skip": True,
                          "downscale_method": "bicubic",
                          "upscale_method": "bicubic"}},
        "5": {"class_type": "EmptyLatentImage",
              "inputs": {"width": 16, "height": 16, "batch_size": 1}},
        "6": {"class_type": "CLIPTextEncode",
              "inputs": {"text": "a fox", "clip": ["4", 1]}},
        "7": {"class_type": "CLIPTextEncode",
              "inputs": {"text": "", "clip": ["4", 1]}},
        "3": {"class_type": "KSampler",
              "inputs": {"seed": 5, "steps": 2, "cfg": 4.0,
                         "sampler_name": "euler", "scheduler": "normal",
                         "denoise": 1.0, "model": ["30", 0],
                         "positive": ["6", 0], "negative": ["7", 0],
                         "latent_image": ["5", 0]}},
    }
    with pytest.raises(tcb.CBIneligible, match="deep_shrink_spec"):
        tcb._Bucket("sig", {"prompt": doc},
                    OpContext(device="cpu", input_dir=str(tmp_path)), 2)
    doc["3"]["inputs"]["model"] = ["4", 0]
    tcb._Bucket("sig", {"prompt": doc},
                OpContext(device="cpu", input_dir=str(tmp_path)), 2)


# --- Canny ---------------------------------------------------------------------

def test_canny_finds_a_box_edge():
    """The JAX package's own Canny case: edges ring the box, the
    interior and the background stay empty, a flat image has none."""
    octx = OpContext(device="cpu")
    img = np.zeros((1, 32, 32, 3), np.float32)
    img[:, 8:24, 8:24] = 1.0
    (edges,) = get_op("Canny").execute(octx, img, 0.1, 0.3)
    e = _np(edges)
    assert e.shape == (1, 32, 32, 3)
    assert set(np.unique(e)) <= {0.0, 1.0}
    assert e[0, 8, 16, 0] == 1.0 or e[0, 7, 16, 0] == 1.0
    assert e[0, 16, 16, 0] == 0.0 and e[0, 2, 2, 0] == 0.0
    (none,) = get_op("Canny").execute(
        octx, np.full((1, 16, 16, 3), 0.5, np.float32), 0.1, 0.3)
    assert _np(none).sum() == 0.0


@pytest.mark.parametrize("kind", ["noise", "ramp", "shapes"])
@pytest.mark.parametrize("low,high", [(0.1, 0.3), (0.4, 0.8),
                                      (0.05, 0.1)])
def test_canny_equals_the_jax_packages(kind, low, high):
    """Edge for edge on two frames: the port's float32 steps are the
    numpy ones, in the same order."""
    rng = np.random.default_rng({"noise": 0, "ramp": 1, "shapes": 2}[kind])
    img = rng.uniform(size=(2, 40, 56, 3)).astype(np.float32)
    if kind == "ramp":
        img = np.cumsum(img, axis=2) / 28.0
    elif kind == "shapes":
        img = np.zeros((2, 40, 56, 3), np.float32)
        img[0, 5:30, 8:40] = 0.9
        img[1, 10:35, 20:50, 1] = 0.7
        img += rng.uniform(0, 0.05, img.shape).astype(np.float32)
    (want,) = jax_get_op("Canny").execute(JaxOpContext(), img, low, high)
    (got,) = get_op("Canny").execute(OpContext(device="cpu"), img, low, high)
    np.testing.assert_array_equal(_np(got), np.asarray(want))


# --- the schemas ---------------------------------------------------------------

@pytest.mark.parametrize("name", NINE_OPS)
def test_op_schema_equals_the_jax_packages(name):
    """Each op of the slice is registered with the JAX package's node
    schema: type, widget order, defaults and hidden inputs."""
    t = tbase.NODE_CLASS_MAPPINGS[name]
    j = jbase.get_op(name).__class__
    assert (t.TYPE, list(t.WIDGETS), dict(t.DEFAULTS), list(t.HIDDEN)) \
        == (j.TYPE, list(j.WIDGETS), dict(j.DEFAULTS), list(j.HIDDEN))
