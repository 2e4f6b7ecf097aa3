"""The CFG variants outside ``SAMPLERS`` in the port against the JAX
package: the combines (dual CFG, Perp-Neg with its per-sample
projection, SAG with its 9-tap reflect blur and threshold mask, the CFG
rescale, population std and all), SAG's capture of the middle block's
attention, and sampling through DualCFGGuider (collapse, a distinct
middle, mixed token lengths, a ControlNet, regional entries refused, the
middle's own pooled vector on an SDXL-kind family, RescaleCFG), PerpNeg
(the patch, the guider, the tiled upscaler), SelfAttentionGuidance
(scale 0, cfg 1 and a HyperTiled middle block skipped) and RescaleCFG;
continuous batching refuses the three patches.

Both packages get the same numpy inputs and the same virtual weights
(a ControlNet's carried across with ``weights.controlnet_from_flax``);
the tiny family in fp32.  Combines and samples agree within rtol = atol
= 2e-4, decoded images within 2e-3, SAG's threshold mask exactly."""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import comfyui_distributed_tpu.ops.basic  # noqa: F401  (registers the ops)
import comfyui_distributed_tpu_torch.ops.basic  # noqa: F401
from comfyui_distributed_tpu.models import controlnet as jcn
from comfyui_distributed_tpu.models import registry as jreg
from comfyui_distributed_tpu.models import samplers as jsmp
from comfyui_distributed_tpu.models import unet as junet
from comfyui_distributed_tpu.ops.base import Conditioning as JaxCond
from comfyui_distributed_tpu.ops.base import OpContext as JaxOpContext
from comfyui_distributed_tpu.ops.base import get_op as jax_get_op
from comfyui_distributed_tpu.runtime import reuse as jreuse
from comfyui_distributed_tpu_torch.models import checkpoints as tckpt
from comfyui_distributed_tpu_torch.models import controlnet as tcn
from comfyui_distributed_tpu_torch.models import layers as tlayers
from comfyui_distributed_tpu_torch.models import registry as treg
from comfyui_distributed_tpu_torch.models import samplers as tsmp
from comfyui_distributed_tpu_torch.models import unet as tunet
from comfyui_distributed_tpu_torch.models.weights import (
    controlnet_from_flax, state_dict_from_flax)
from comfyui_distributed_tpu_torch.ops import basic as tbasic
from comfyui_distributed_tpu_torch.ops.base import Conditioning, OpContext
from comfyui_distributed_tpu_torch.ops.base import get_op
from comfyui_distributed_tpu_torch.runtime import reuse as treuse
from comfyui_distributed_tpu_torch.workflow import batch_executor as tcb

TOL = dict(rtol=2e-4, atol=2e-4)
IMAGE_ATOL = 2e-3
CPU = torch.device("cpu")


def _np(x):
    if hasattr(x, "to_host"):
        return x.to_host()
    if isinstance(x, torch.Tensor):
        return x.detach().float().cpu().numpy()
    return np.asarray(x, np.float32)


def _clear():
    for clear in (jreg.clear_pipeline_cache, treg.clear_pipeline_cache,
                  jreuse.get_reuse().clear, treuse.get_reuse().clear):
        clear()


@pytest.fixture
def env():
    """The tiny family in both packages; both pipeline caches and both
    reuse planes empty before and after each test."""
    saved = os.environ.get("DTPU_DEFAULT_FAMILY")
    os.environ["DTPU_DEFAULT_FAMILY"] = "tiny"
    _clear()
    yield
    _clear()
    if saved is None:
        os.environ.pop("DTPU_DEFAULT_FAMILY", None)
    else:
        os.environ["DTPU_DEFAULT_FAMILY"] = saved


# --- the combines ---------------------------------------------------------------

def _toy(lib):
    """A model whose prediction depends on x and the context, in either
    package's array library."""
    def model(x, sigma, context=None, y=None):
        mean = lib.mean(context, axis=(1, 2)) if lib is jnp \
            else context.mean(dim=(1, 2))
        per = mean.reshape(-1, 1, 1, 1)
        return x * 0.3 + per * x[..., :1] + per
    return model


def _rand(*shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


COMBINES = ["dual", "dual_rescale", "perp", "perp_rescale"]


@pytest.mark.parametrize("name", COMBINES)
def test_three_row_combine_matches_jax(name):
    """cfg_denoiser_dual and cfg_denoiser_perp_neg on a toy model at
    B = 2, with and without the rescale; each call leaves the uncond
    rows in ``last_uncond``."""
    x, c, m, u = (_rand(2, 6, 5, 3, seed=1), _rand(2, 7, 4, seed=2),
                  _rand(2, 7, 4, seed=3), _rand(2, 7, 4, seed=4))
    kind, _, rescale = name.partition("_")
    mult = 0.6 if rescale else 0.0
    jf = jsmp.cfg_denoiser_dual if kind == "dual" \
        else jsmp.cfg_denoiser_perp_neg
    tf = tsmp.cfg_denoiser_dual if kind == "dual" \
        else tsmp.cfg_denoiser_perp_neg
    jw = jf(_toy(jnp), *(jnp.asarray(a) for a in (c, m, u)), 6.0, 0.7,
            cfg_rescale=mult)
    tw = tf(_toy(torch), *(torch.from_numpy(a) for a in (c, m, u)), 6.0,
            0.7, cfg_rescale=mult)
    want = jw(jnp.asarray(x), jnp.asarray(2.5))
    got = tw(torch.from_numpy(x), 2.5)
    np.testing.assert_allclose(_np(got), np.asarray(want), **TOL)
    np.testing.assert_allclose(_np(tw.last_uncond),
                               np.asarray(jw.last_uncond), **TOL)


def test_perp_neg_projects_per_sample():
    """Sample 0's result does not depend on sample 1 (the projection
    reduces over axes 1..n, not over the batch)."""
    x, c, m, u = (_rand(2, 6, 5, 3, seed=1), _rand(2, 7, 4, seed=2),
                  _rand(2, 7, 4, seed=3), _rand(2, 7, 4, seed=4))
    args = [torch.from_numpy(a) for a in (c, m, u)]
    pair = tsmp.cfg_denoiser_perp_neg(_toy(torch), *args, 5.0, 1.0)(
        torch.from_numpy(x), 3.0)
    one = tsmp.cfg_denoiser_perp_neg(_toy(torch), *(a[:1] for a in args),
                                     5.0, 1.0)(torch.from_numpy(x[:1]), 3.0)
    np.testing.assert_allclose(_np(pair[:1]), _np(one), rtol=1e-6,
                               atol=1e-6)


@pytest.mark.parametrize("sigma,multiplier", [(3.0, 0.6), (0.4, 1.0),
                                              (12.0, 0.0)])
def test_rescale_cfg_math(sigma, multiplier):
    """_rescale_cfg against the numpy port of the reference patch (the
    JAX package's own case) and the JAX function; the std is the
    population one."""
    x, dc, du = (_rand(2, 4, 4, 3, seed=s) for s in (3, 4, 5))
    got = _np(tsmp._rescale_cfg(*(torch.from_numpy(a) for a in (x,)),
                                sigma, torch.from_numpy(dc),
                                torch.from_numpy(du), 7.0, multiplier))
    want = np.asarray(jsmp._rescale_cfg(jnp.asarray(x), jnp.asarray(sigma),
                                        jnp.asarray(dc), jnp.asarray(du),
                                        7.0, multiplier))
    xn, dcn, dun = (a.astype(np.float64) for a in (x, dc, du))
    s2 = sigma * sigma
    xs = xn / (s2 + 1.0)
    root = np.sqrt(s2 + 1.0)
    v_c = (xs - (xn - dcn)) * root / sigma
    v_u = (xs - (xn - dun)) * root / sigma
    v_cfg = v_u + (v_c - v_u) * 7.0
    ro_pos = v_c.std(axis=(1, 2, 3), keepdims=True)
    ro_cfg = v_cfg.std(axis=(1, 2, 3), keepdims=True)
    v_fin = multiplier * (v_cfg * ro_pos / ro_cfg) \
        + (1 - multiplier) * v_cfg
    ref = xn - (xs - v_fin * sigma / root)
    np.testing.assert_allclose(got, ref, **TOL)
    np.testing.assert_allclose(got, want, **TOL)


def test_multi_rescale_matches_jax_and_zero_is_plain_cfg():
    x = _rand(2, 4, 4, 3, seed=6)
    cond, unc = np.full((2, 7, 8), 1.5, np.float32), np.zeros(
        (2, 7, 8), np.float32)
    plain = tsmp.cfg_denoiser_multi(_toy(torch), torch.from_numpy(cond),
                                    torch.from_numpy(unc), 7.0)(
        torch.from_numpy(x), 3.0)
    zero = tsmp.cfg_denoiser_multi(_toy(torch), torch.from_numpy(cond),
                                   torch.from_numpy(unc), 7.0,
                                   cfg_rescale=0.0)(torch.from_numpy(x), 3.0)
    np.testing.assert_array_equal(_np(plain), _np(zero))
    got = tsmp.cfg_denoiser_multi(_toy(torch), torch.from_numpy(cond),
                                  torch.from_numpy(unc), 7.0,
                                  cfg_rescale=0.7)(torch.from_numpy(x), 3.0)
    want = jsmp.cfg_denoiser_multi(_toy(jnp), [(jnp.asarray(cond), None,
                                                1.0)], jnp.asarray(unc),
                                   7.0, cfg_rescale=0.7)(
        jnp.asarray(x), jnp.asarray(3.0))
    np.testing.assert_allclose(_np(got), np.asarray(want), **TOL)
    assert np.abs(_np(got) - _np(plain)).max() > 1e-3


@pytest.mark.parametrize("shape,sigma", [((1, 12, 12, 4), 2.0),
                                         ((2, 9, 16, 3), 1.3),
                                         ((1, 8, 8, 4), 0.5)])
def test_gaussian_blur_matches_jax(shape, sigma):
    x = _rand(*shape, seed=7)
    want = jsmp._gaussian_blur_nhwc(jnp.asarray(x), 9, sigma)
    got = tsmp._gaussian_blur_nhwc(torch.from_numpy(x), 9, sigma)
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=0,
                               atol=1e-6)
    flat = tsmp._gaussian_blur_nhwc(torch.full(shape, 0.7), 9, sigma)
    np.testing.assert_allclose(_np(flat), 0.7, atol=1e-6)


@pytest.mark.parametrize("mid,out", [((2, 2), (8, 8)), ((3, 3), (5, 5)),
                                     ((4, 3), (8, 6))])
def test_sag_mask_matches_jax(mid, out):
    """The threshold mask on the middle grid, resized nearest as
    ``jax.image.resize`` does (the odd grids of ceil-halving too)."""
    n = mid[0] * mid[1]
    rng = np.random.default_rng(8)
    logits = rng.standard_normal((4, 2, n, n)).astype(np.float32) * 2.0
    probs = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
    a = probs[2:].mean(axis=1).sum(axis=1)
    want = (a > 1.0).astype(np.float32).reshape(2, *mid, 1)
    want = np.asarray(jax.image.resize(jnp.asarray(want), (2, *out, 1),
                                       method="nearest"))
    got = tsmp.sag_mask(torch.from_numpy(probs), 2, mid, out)
    np.testing.assert_array_equal(_np(got), want)


# --- SAG's capture -------------------------------------------------------------

def test_capture_forward_matches_jax_and_launches_no_kernel():
    """The tiny UNet's capture forward (``sag_capture``) against the JAX
    capture apply: the prediction within tolerance, the middle block's
    weights [B, heads, N, N] in fp32 within tolerance and their
    threshold mask equal (the smallest |mass - 1| printed, so a near tie
    shows).  The captured layer is the one attention that does not go
    through the kernel's wrapper."""
    up = jreg._virtual_params(junet.UNet(junet.TINY_CONFIG), 7,
                              jnp.zeros((1, 16, 16, 4)), jnp.zeros((1,)),
                              jnp.zeros((1, 77, 64)))
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 16, 16, 4)).astype(np.float32)
    t = np.asarray([700.0, 20.5], np.float32)
    c = rng.standard_normal((2, 77, 64)).astype(np.float32)
    jcfg = dataclasses.replace(junet.TINY_CONFIG, sag_capture=True)
    out, inters = junet.UNet(jcfg).apply(
        {"params": up}, jnp.asarray(x), jnp.asarray(t), jnp.asarray(c),
        mutable=["intermediates"])
    (jprobs,) = jax.tree_util.tree_leaves(inters)
    plain = tunet.UNet(tunet.TINY_CONFIG)
    plain.load_state_dict(state_dict_from_flax(
        plain, jax.tree_util.tree_map(np.asarray, up)))
    cap = tunet.with_config(plain.eval(), dataclasses.replace(
        tunet.TINY_CONFIG, sag_capture=True))
    calls = []
    real = tlayers.flash_attention

    def counting(q, k, v):
        calls.append(tuple(q.shape))
        return real(q, k, v)

    args = [torch.from_numpy(a) for a in (x, t, c)]
    tlayers.flash_attention = counting
    try:
        with torch.no_grad():
            got, probs = cap(*args, capture=True)
            n_capture = len(calls)
            calls.clear()
            base = cap(*args)
    finally:
        tlayers.flash_attention = real
    assert n_capture == len(calls) - 1
    np.testing.assert_allclose(_np(got), np.asarray(out), **TOL)
    np.testing.assert_allclose(_np(base), np.asarray(out), **TOL)
    assert probs.dtype == torch.float32
    assert tuple(probs.shape) == tuple(jprobs.shape) == (2, 4, 64, 64)
    np.testing.assert_allclose(_np(probs), np.asarray(jprobs), **TOL)
    mass_t = _np(probs).mean(axis=1).sum(axis=1)
    mass_j = np.asarray(jprobs).mean(axis=1).sum(axis=1)
    print(f"smallest |mass - 1|: {np.abs(mass_j - 1.0).min():.3e}")
    np.testing.assert_array_equal(mass_t > 1.0, mass_j > 1.0)
    with pytest.raises(ValueError, match="sag_capture"):
        plain(*args, capture=True)


def test_sag_capture_is_a_patch_field():
    assert "sag_capture" in tunet._PATCH_FIELDS
    # GLIGEN's fusers are weights of their own: not a patch field
    assert "gligen" not in tunet._PATCH_FIELDS
    with torch.device("meta"):
        unet = tunet.UNet(tunet.TINY_CONFIG)
    cap = tunet.with_config(unet, dataclasses.replace(tunet.TINY_CONFIG,
                                                      sag_capture=True))
    assert cap.conv_in.weight is unet.conv_in.weight


# --- sampling -----------------------------------------------------------------

class Side:
    def __init__(self, pkg, name, texts=("a fox", "")):
        self.pkg = pkg
        if pkg == "jax":
            self.pipe = jreg.load_pipeline(name)
            self.ctx = JaxOpContext()
            self.get = jax_get_op
            self.cond = lambda t: JaxCond(
                context=np.asarray(self.pipe.encode_prompt([t])[0]))
        else:
            self.pipe = treg.load_pipeline(name, device=CPU)
            self.ctx = OpContext(device="cpu")
            self.get = get_op
            self.cond = lambda t: Conditioning(
                context=self.pipe.encode_prompt([t])[0])
        self.pos, self.neg = (self.cond(t) for t in texts)

    def op(self, name, *args, **kw):
        return self.get(name).execute(self.ctx, *args, **kw)

    def custom(self, guider, steps=3, seed=9, lat=None):
        (s,) = self.op("KSamplerSelect", "euler")
        (sig,) = self.op("BasicScheduler", self.pipe, "normal", steps, 1.0)
        (noise,) = self.op("RandomNoise", seed)
        out, _ = self.op("SamplerCustomAdvanced", noise, guider, s, sig,
                         lat or _lat())
        return _np(out["samples"])

    def ksampler(self, pipe, cfg=6.0, steps=2, pos=None, neg=None,
                 lat=None):
        (out,) = self.op("KSampler", pipe, 5, steps, cfg, "euler", "normal",
                         pos or self.pos, neg or self.neg, lat or _lat(),
                         1.0)
        return _np(out["samples"])


def _sides(name, texts=("a fox", "")):
    return Side("jax", name, texts), Side("torch", name, texts)


def _lat(h=8, w=8):
    return {"samples": np.zeros((1, h, w, 4), np.float32)}


def test_dual_cfg_collapses_to_cfg_and_matches_jax(env):
    """cond2 = the negative: the dual combine is plain CFG at cfg_conds
    (to 1e-5 of CFGGuider), and it matches the JAX package's."""
    res = {}
    for side in _sides("dual-eq.ckpt"):
        (dual,) = side.op("DualCFGGuider", side.pipe, side.pos, side.neg,
                          side.neg, 6.0, 3.3)
        res[side.pkg] = side.custom(dual)
    (cfg,) = side.op("CFGGuider", side.pipe, side.pos, side.neg, 6.0)
    np.testing.assert_allclose(res["torch"], side.custom(cfg), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(res["torch"], res["jax"], **TOL)


def test_dual_cfg_distinct_middle_matches_jax(env):
    res = {}
    for side in _sides("dual.ckpt"):
        (dual,) = side.op("DualCFGGuider", side.pipe, side.pos,
                          side.cond("oil painting"), side.neg, 7.0, 1.5)
        res[side.pkg] = side.custom(dual)
    np.testing.assert_allclose(res["torch"], res["jax"], **TOL)
    (cfg,) = side.op("CFGGuider", side.pipe, side.pos, side.neg, 7.0)
    assert np.abs(res["torch"] - side.custom(cfg)).max() > 1e-3


def test_dual_cfg_mixed_token_lengths_match_jax(env):
    """cond1 at 154 tokens, cond2 and the negative at 77: all three align
    to one length (whole repeats) in the same pass."""
    res = {}
    for side in _sides("dual-tok.ckpt"):
        long_ctx = side.pos.context
        long_ctx = np.concatenate([long_ctx, long_ctx], axis=1) \
            if side.pkg == "jax" else torch.cat([long_ctx, long_ctx], dim=1)
        long_pos = (JaxCond if side.pkg == "jax" else Conditioning)(
            context=long_ctx)
        (dual,) = side.op("DualCFGGuider", side.pipe, long_pos,
                          side.cond("sketch"), side.neg, 6.0, 2.0)
        res[side.pkg] = side.custom(dual)
    assert np.isfinite(res["torch"]).all()
    np.testing.assert_allclose(res["torch"], res["jax"], **TOL)


def _live_params(params, seed=11):
    cfg = junet.TINY_CONFIG
    other = jreg._virtual_params(
        jcn.ControlNet(cfg), seed, jnp.zeros((1, 8, 8, 4)), jnp.zeros((1,)),
        jnp.zeros((1, 77, cfg.context_dim)), jnp.zeros((1, 64, 64, 3)))
    return {k: (other[k] if tcn.is_zero_projection(k) else v)
            for k, v in params.items()}


def test_dual_cfg_under_a_controlnet(env):
    """A control on the positive rides the dual path with flat [cond,
    middle, uncond] strengths: the virtual net (zero projections) equals
    no control to the bit, a live net (the JAX tree carried across)
    matches the JAX package's and steers the sample."""
    jm, jp = jreg.load_controlnet("dual_cn.safetensors")
    live = _live_params(jp)
    cfg = treg.get_family("tiny").unet
    sd = controlnet_from_flax(cfg, jax.tree_util.tree_map(np.asarray, live))
    tnet = treg._build(lambda: tcn.ControlNet(cfg), CPU, torch.float32,
                       lambda m: tckpt.load_into(m, sd))
    tvirtual = treg.load_controlnet("dual_cn.safetensors", device=CPU)
    hint = np.random.default_rng(5).uniform(0, 1, (1, 64, 64, 3)).astype(
        np.float32)
    res = {}
    for side in _sides("dual-cn.ckpt"):
        mid = side.cond("photo")
        # the JAX package runs the live net only
        nets = ((jm, live),) if side.pkg == "jax" \
            else (None, tvirtual, tnet)
        h = hint if side.pkg == "jax" else torch.from_numpy(hint)
        outs = []
        for net in nets:
            pos = side.pos
            if net is not None:
                (pos,) = side.op("ControlNetApply", side.pos, net, h, 1.0)
            (g,) = side.op("DualCFGGuider", side.pipe, pos, mid, side.neg,
                           5.0, 1.5)
            outs.append(side.custom(g))
        res[side.pkg] = outs
    plain, zeroed, steered = res["torch"]
    np.testing.assert_array_equal(plain, zeroed)
    assert np.abs(steered - plain).max() > 1e-3
    np.testing.assert_allclose(steered, res["jax"][0], **TOL)
    treg._controlnet_cache.clear()


def test_dual_cfg_refuses_regional_entries(env):
    for side in _sides("dual-rej.ckpt"):
        mask = np.ones((64, 64), np.float32)
        (masked,) = side.op("ConditioningSetMask", side.cond("left half"),
                            mask if side.pkg == "jax"
                            else torch.from_numpy(mask), 0.8, "default")
        (g,) = side.op("DualCFGGuider", side.pipe, side.pos, masked,
                       side.neg, 5.0, 1.5)
        with pytest.raises(ValueError, match="multi-entry"):
            side.custom(g)


def test_dual_prep_gives_the_middle_its_own_pooled_vector(env):
    """On the SDXL-kind tiny family the middle row carries its own pooled
    ADM vector (y = [cond, middle, cond]), a control on the middle alone
    becomes flat (0, s, 0) strengths, and the sample matches the JAX
    package's."""
    os.environ["DTPU_DEFAULT_FAMILY"] = "tiny_sdxl"
    j, t = _sides("dual-pooled.ckpt")
    rng = np.random.default_rng(2)
    pooled = [rng.standard_normal((1, 64)).astype(np.float32)
              for _ in range(3)]

    def conds(side):
        mk = JaxCond if side.pkg == "jax" else Conditioning
        cv = (lambda a: a) if side.pkg == "jax" else torch.from_numpy
        return [mk(context=_np(c.context) if side.pkg == "jax"
                   else c.context, pooled=cv(p))
                for c, p in zip((side.pos, side.cond("mid"), side.neg),
                                pooled)]

    tpos, tmid, tneg = conds(t)
    net = treg.load_controlnet("pooled_cn.safetensors", device=CPU)
    hint = torch.rand((1, 64, 64, 3), generator=torch.Generator()
                      .manual_seed(3))
    (tmid_c,) = t.op("ControlNetApply", tmid, net, hint, 0.7)
    prep = tbasic._prepare_sample_inputs(t.pipe, 0, _lat(), tpos, tneg,
                                         middle=tmid_c)
    assert isinstance(prep.y, list) and len(prep.y) == 3
    assert not torch.equal(prep.y[1], prep.y[0])
    assert torch.equal(prep.y[2], prep.y[0])
    assert prep.mid_context.shape == prep.context.shape
    assert prep.control[0][2] == (0.0, 0.7, 0.0)
    assert prep.control[0][3] is None
    res = {}
    for side, (pos, mid, neg) in ((j, conds(j)), (t, (tpos, tmid, tneg))):
        (g,) = side.op("DualCFGGuider", side.pipe, pos, mid, neg, 6.0, 2.0)
        res[side.pkg] = side.custom(g)
    np.testing.assert_allclose(res["torch"], res["jax"], **TOL)
    treg._controlnet_cache.clear()


def test_dual_cfg_with_rescale_matches_jax(env):
    res = {}
    for side in _sides("dual-rs.ckpt"):
        mid = side.cond("ink wash")
        (pr,) = side.op("RescaleCFG", side.pipe, 0.7)
        (gr,) = side.op("DualCFGGuider", pr, side.pos, mid, side.neg, 7.0,
                        3.0)
        res[side.pkg] = side.custom(gr)
    np.testing.assert_allclose(res["torch"], res["jax"], **TOL)
    (g,) = side.op("DualCFGGuider", side.pipe, side.pos, mid, side.neg,
                   7.0, 3.0)
    assert np.abs(res["torch"] - side.custom(g)).max() > 1e-3


def test_rescale_cfg_sampling_matches_jax(env):
    res = {}
    for side in _sides("rescale.ckpt"):
        (pr,) = side.op("RescaleCFG", side.pipe, 0.7)
        res[side.pkg] = side.ksampler(pr, cfg=9.0)
    np.testing.assert_allclose(res["torch"], res["jax"], **TOL)
    assert np.abs(res["torch"] - side.ksampler(side.pipe, cfg=9.0)).max() \
        > 1e-3


def test_perp_neg_patch_and_guider(env):
    """The PerpNeg patch under KSampler against the JAX package's; with
    the negative as its empty conditioning it reduces to plain CFG; the
    guider with the same empty prompt and scale equals the patch to the
    bit."""
    j, t = _sides("pn.ckpt", texts=("a fox", "blurry"))
    res = {}
    for side in (j, t):
        emp = side.cond("")
        (pp,) = side.op("PerpNeg", side.pipe, emp, 0.8)
        res[side.pkg] = side.ksampler(pp)
    np.testing.assert_allclose(res["torch"], res["jax"], **TOL)
    plain = t.ksampler(t.pipe)
    (same,) = t.op("PerpNeg", t.pipe, t.neg, 1.0)
    np.testing.assert_allclose(t.ksampler(same), plain, rtol=1e-5,
                               atol=1e-5)
    emp = t.cond("")
    (pp,) = t.op("PerpNeg", t.pipe, emp, 0.8)
    (s,) = t.op("KSamplerSelect", "euler")
    (sig,) = t.op("BasicScheduler", t.pipe, "normal", 3, 1.0)
    (noise,) = t.op("RandomNoise", 9)
    (g,) = t.op("PerpNegGuider", t.pipe, t.pos, t.neg, emp, 6.0, 0.8)
    a, _ = t.op("SamplerCustomAdvanced", noise, g, s, sig, _lat())
    b, _ = t.op("SamplerCustom", pp, True, 9, 6.0, t.pos, t.neg, _lat(), s,
                sig)
    np.testing.assert_array_equal(_np(a["samples"]), _np(b["samples"]))
    assert np.abs(res["torch"] - plain).max() > 1e-3


def test_perp_neg_in_the_tiled_upscaler_matches_jax(env):
    """UltimateSDUpscaleDistributed on a PerpNeg pipeline: the tiles
    refine with the empty conditioning as the third row block, the image
    within 2e-3 of the JAX tiled upscaler's."""
    img = np.random.default_rng(6).uniform(0, 1, (1, 64, 64, 3)).astype(
        np.float32)
    res = {}
    for side in _sides("pn-tiles.ckpt", texts=("a harbor", "blurry")):
        (pp,) = side.op("PerpNeg", side.pipe, side.cond(""), 0.9)
        (out,) = side.op("UltimateSDUpscaleDistributed", img, pp, side.pos,
                         side.neg, pp, 4, 2, 5.0, "euler", "normal", 0.4,
                         32, 32, 8, 2)
        res[side.pkg] = _np(out)
    assert res["torch"].shape == (1, 64, 64, 3)
    np.testing.assert_allclose(res["torch"], res["jax"], rtol=0,
                               atol=IMAGE_ATOL)


@pytest.mark.parametrize("what", ["perp_neg", "regional"])
def test_perp_neg_tile_refine_passes_its_middle(env, what, capfd):
    """The tile refine hands the sampler the empty conditioning aligned
    to the prompt's tokens (a 154-token empty is cut to 77), guidance
    ``perp_neg`` and the patch's scale; with regional entries it logs
    and refines with the primary prompts, as the JAX package does."""
    t = Side("torch", "pn-refine.ckpt")
    emp = Conditioning(context=torch.cat([t.cond("").context] * 2, dim=1))
    (pp,) = t.op("PerpNeg", t.pipe, emp, 0.7)
    pos = t.pos
    if what == "regional":
        pos = dataclasses.replace(t.pos, siblings=(t.cond("left"),))
    seen = {}
    real = treg.DiffusionPipeline.sample

    def spy(self, lat, c, u, seeds, **kw):
        seen.update(kw, context=c)
        return real(self, lat, c, u, seeds, **kw)

    from comfyui_distributed_tpu_torch.ops.tiled_upscale import (
        UltimateSDUpscaleDistributed)
    treg.DiffusionPipeline.sample = spy
    try:
        capfd.readouterr()
        UltimateSDUpscaleDistributed()._refine_batch(
            t.ctx, pp, torch.rand(2, 32, 32, 3), [0, 1], pos, t.neg,
            {"seed": 1, "steps": 1, "cfg": 4.0, "sampler_name": "euler",
             "scheduler": "normal", "denoise": 0.5, "tile_w": 32,
             "tile_h": 32, "padding": 0}, [(0, 0), (32, 0)], (64, 32))
    finally:
        treg.DiffusionPipeline.sample = real
    assert seen["guidance"] == "perp_neg" and seen["cfg2"] == 0.7
    assert tuple(seen["middle_context"].shape) == (2, 77, 64)
    assert isinstance(seen["context"], torch.Tensor)
    said = "".join(capfd.readouterr())
    assert ("using the primary prompt only" in said) == (what == "regional")


def test_sag_changes_the_sample_and_matches_jax(env):
    """SAG at (0.8, 2.0) against the JAX package's, off the plain sample;
    at scale 0 it equals the plain sample (to the bit in the port)."""
    res = {}
    for side in _sides("sag.ckpt"):
        (ps,) = side.op("SelfAttentionGuidance", side.pipe, 0.8, 2.0)
        res[side.pkg] = side.ksampler(ps, steps=3)
    sag = res["torch"]
    np.testing.assert_allclose(sag, res["jax"], **TOL)
    (p0,) = side.op("SelfAttentionGuidance", side.pipe, 0.0, 2.0)
    plain = side.ksampler(side.pipe, steps=3)
    np.testing.assert_array_equal(side.ksampler(p0, steps=3), plain)
    assert np.abs(sag - plain).max() > 1e-3


@pytest.mark.parametrize("case", ["cfg_one", "hypertiled_mid", "control",
                                  "dual"])
def test_sag_is_skipped_where_it_does_not_apply(env, case, capfd):
    """cfg 1, a HyperTiled middle block, a ControlNet or 3-row guidance:
    SAG logs and samples without itself, equal to the unpatched
    pipeline's sample to the bit."""
    t = Side("torch", f"sag-{case}.ckpt")
    base = t.pipe
    if case == "hypertiled_mid":
        (base,) = t.op("HyperTile", t.pipe, 32, 2, 3, False)
    (ps,) = t.op("SelfAttentionGuidance", base, 0.5, 2.0)
    lat = _lat(16, 16) if case == "hypertiled_mid" else _lat()
    pos = t.pos
    if case == "control":
        net = treg.load_controlnet("sag_cn.safetensors", device=CPU)
        (pos,) = t.op("ControlNetApply", t.pos, net, torch.rand(
            (1, 64, 64, 3), generator=torch.Generator().manual_seed(1)), 1.0)
    cfg = 1.0 if case == "cfg_one" else 5.0
    capfd.readouterr()
    if case == "dual":
        mid = t.cond("mid")
        (g,) = t.op("DualCFGGuider", ps, pos, mid, t.neg, cfg, 2.0)
        (g0,) = t.op("DualCFGGuider", base, pos, mid, t.neg, cfg, 2.0)
        got, want = t.custom(g), None
        said = "".join(capfd.readouterr())
        want = t.custom(g0)
    else:
        got = t.ksampler(ps, cfg=cfg, pos=pos, lat=lat)
        said = "".join(capfd.readouterr())
        want = t.ksampler(base, cfg=cfg, pos=pos, lat=lat)
    assert "WITHOUT self-attention guidance" in said
    assert np.isfinite(got).all()
    np.testing.assert_array_equal(got, want)
    treg._controlnet_cache.clear()


def test_deep_shrink_yields_to_sag(env, capfd):
    t = Side("torch", "sag-ds.ckpt")
    (ds,) = t.op("PatchModelAddDownscale", t.pipe, 2, 2.0, 0.0, 0.6, True,
                 "bicubic", "bicubic")
    (both,) = t.op("SelfAttentionGuidance", ds, 0.5, 2.0)
    (sag,) = t.op("SelfAttentionGuidance", t.pipe, 0.5, 2.0)
    capfd.readouterr()
    got = t.ksampler(both)
    assert "does not compose with SAG" in "".join(capfd.readouterr())
    np.testing.assert_array_equal(got, t.ksampler(sag))


def _cb_doc(patch):
    doc = {
        "4": {"class_type": "CheckpointLoaderSimple",
              "inputs": {"ckpt_name": "cb-patch.ckpt"}},
        "5": {"class_type": "EmptyLatentImage",
              "inputs": {"width": 64, "height": 64, "batch_size": 1}},
        "6": {"class_type": "CLIPTextEncode",
              "inputs": {"text": "a fox", "clip": ["4", 1]}},
        "7": {"class_type": "CLIPTextEncode",
              "inputs": {"text": "", "clip": ["4", 1]}},
        "30": patch,
        "3": {"class_type": "KSampler",
              "inputs": {"seed": 5, "steps": 2, "cfg": 4.0,
                         "sampler_name": "euler", "scheduler": "normal",
                         "denoise": 1.0, "model": ["30", 0],
                         "positive": ["6", 0], "negative": ["7", 0],
                         "latent_image": ["5", 0]}},
    }
    return doc


@pytest.mark.parametrize("op,widgets,why", [
    ("SelfAttentionGuidance", {"scale": 0.5, "blur_sigma": 2.0},
     "sag_params"),
    ("PerpNeg", {"empty_conditioning": ["7", 0], "neg_scale": 1.0},
     "perp_neg_cond"),
    ("RescaleCFG", {"multiplier": 0.7}, "cfg_rescale")])
def test_continuous_batching_refuses_the_patches(env, tmp_path, op, widgets,
                                                 why):
    """The bucket build refuses SAG, PerpNeg and RescaleCFG
    (``CBIneligible``), as the JAX package's does."""
    doc = _cb_doc({"class_type": op,
                   "inputs": {"model": ["4", 0], **widgets}})
    with pytest.raises(tcb.CBIneligible, match=why):
        tcb._Bucket("sig", {"prompt": doc},
                    OpContext(device="cpu", input_dir=str(tmp_path)), 2)
