"""The noise mask in the port's sampler (ComfyUI's KSamplerX0Inpaint)
and the inpaint models' extra UNet channels, against the JAX package:
``make_denoiser``'s ``concat``, ``DiffusionPipeline.sample``'s
``noise_mask`` and ``c_concat`` over four samplers (the CFG++ side
channel included), and KSampler/KSamplerAdvanced with a mask on the
latent.  Same numpy inputs and virtual weights on both sides, fp32:
within 2e-4, and where the mask is 0 the result is the source to the
bit."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from comfyui_distributed_tpu.models import denoiser as jden
from comfyui_distributed_tpu.models import registry as jreg
from comfyui_distributed_tpu.ops import basic as _jax_ops  # noqa: F401
from comfyui_distributed_tpu.ops.base import Conditioning as JaxCond
from comfyui_distributed_tpu.ops.base import OpContext as JaxOpContext
from comfyui_distributed_tpu.ops.base import get_op as jax_get_op
from comfyui_distributed_tpu_torch.models import denoiser as tden
from comfyui_distributed_tpu_torch.models import registry as treg
from comfyui_distributed_tpu_torch.models import samplers as tsmp
from comfyui_distributed_tpu_torch.ops import basic as _ops  # noqa: F401
from comfyui_distributed_tpu_torch.ops.base import Conditioning, OpContext
from comfyui_distributed_tpu_torch.ops.base import get_op

TOL = dict(rtol=2e-4, atol=2e-4)


def _np(x):
    return x.to_host() if hasattr(x, "to_host") else np.asarray(x,
                                                                np.float32)


def _rng(seed):
    return np.random.default_rng(seed)


def _pipes(family):
    name = "tiny-inpaint.ckpt" if family == "tiny_inpaint" \
        else "tiny-plain.safetensors"
    return (jreg.load_pipeline(name, family_name=family),
            treg.load_pipeline(name, family_name=family, device="cpu"))


# --- the denoiser's concat channels and masked sampling -----------------------

def test_denoiser_concat_matches_jax():
    """The concat channels ride unscaled after c_in, repeated to the
    CFG-stacked batch."""
    jp, tp = _pipes("tiny_inpaint")
    rng = _rng(8)
    x = rng.standard_normal((4, 8, 8, 4)).astype(np.float32)
    concat = rng.standard_normal((2, 8, 8, 5)).astype(np.float32)
    ctx = rng.standard_normal((4, 77, 64)).astype(np.float32)
    sigma = 3.7
    tden_fn = tden.make_denoiser(tp.unet, tp.schedule,
                                 concat=torch.from_numpy(concat))
    jden_fn = jden.make_denoiser(jp.raw_unet_apply, jp.unet_params,
                                 jp.schedule, concat=jnp.asarray(concat))
    t = tden_fn(torch.from_numpy(x), sigma, context=torch.from_numpy(ctx))
    j = jden_fn(jnp.asarray(x), jnp.float32(sigma), context=jnp.asarray(ctx))
    np.testing.assert_allclose(t.numpy(), np.asarray(j), **TOL)
    with pytest.raises(ValueError, match="InpaintModelConditioning"):
        tp.sample(torch.from_numpy(x[:1]), torch.from_numpy(ctx[:1]),
                  torch.from_numpy(ctx[:1]), np.array([1], np.uint64),
                  steps=1, cfg=2.0, sampler_name="euler",
                  scheduler="normal")


def _masked_inputs(seed=9):
    rng = _rng(seed)
    src = rng.standard_normal((1, 8, 8, 4)).astype(np.float32)
    mask = np.zeros((1, 8, 8, 1), np.float32)
    mask[:, :, 4:] = 1.0
    mask[:, 2, 2] = 0.5
    return src, mask


@pytest.mark.parametrize("sampler,family", [
    ("euler", "tiny"), ("euler_ancestral", "tiny"), ("euler_cfg_pp", "tiny"),
    ("dpmpp_2m", "tiny"), ("euler", "tiny_inpaint")])
def test_masked_sample_matches_jax(sampler, family):
    """``pipeline.sample`` with a latent mask (and, on the inpaint
    family, concat channels) against the JAX pipeline; where the mask is
    0 both return the source to the bit, where it is 1 they resample."""
    jp, tp = _pipes(family)
    src, mask = _masked_inputs()
    ctx_c, _ = tp.encode_prompt(["a cat"])
    ctx_u, _ = tp.encode_prompt([""])
    seeds = np.array([11], np.uint64)
    kw = dict(steps=4, cfg=5.0, sampler_name=sampler, scheduler="karras")
    concat = None
    if family == "tiny_inpaint":
        concat = _rng(10).standard_normal((1, 8, 8, 5)).astype(np.float32)
    t = tp.sample(torch.from_numpy(src), ctx_c, ctx_u, seeds,
                  noise_mask=torch.from_numpy(mask),
                  c_concat=None if concat is None
                  else torch.from_numpy(concat), **kw).numpy()
    j = np.asarray(jp.sample(jnp.asarray(src), ctx_c.numpy(), ctx_u.numpy(),
                             seeds, noise_mask=jnp.asarray(mask),
                             c_concat=None if concat is None
                             else jnp.asarray(concat), **kw))
    np.testing.assert_allclose(t, j, **TOL)
    keep = mask[..., 0] == 0
    np.testing.assert_array_equal(t[keep], src[keep])
    np.testing.assert_array_equal(j[keep], src[keep])
    redo = mask[..., 0] == 1
    assert not np.allclose(t[redo], src[redo])


def test_mask_wrapper_propagates_cfg_pp_side_channel(monkeypatch):
    """A probe sampler reads ``last_uncond`` off the callable it is
    handed, as the CFG++ samplers do, and returns ``last_uncond -
    denoised``: nonzero inside the mask (the real uncond), the source
    outside (the final re-anchor)."""
    _, tp = _pipes("tiny")

    def probe(model, x, sigmas, extra_args=None, keys=None):
        den = model(x, float(sigmas[0]), **(extra_args or {}))
        return getattr(model, "last_uncond", den) - den

    monkeypatch.setitem(tsmp.SAMPLERS, "_lu_probe", probe)
    src, mask = _masked_inputs(12)
    ctx_c, _ = tp.encode_prompt(["a cat"])
    ctx_u, _ = tp.encode_prompt([""])
    out = tp.sample(torch.from_numpy(src), ctx_c, ctx_u,
                    np.array([11], np.uint64), steps=3, cfg=7.5,
                    sampler_name="_lu_probe", scheduler="normal",
                    noise_mask=torch.from_numpy(mask)).numpy()
    keep = mask[..., 0] == 0
    np.testing.assert_array_equal(out[keep], src[keep])
    assert np.abs(out[:, :, 4:]).max() > 1e-4


def _ksampler_pair(jp, tp, op, latent, **widgets):
    ctx, _ = tp.encode_prompt(["replace"])
    tcond, jcond = Conditioning(ctx), JaxCond(context=ctx.numpy())
    (t,) = get_op(op).execute(OpContext(device="cpu"), model=tp,
                              positive=tcond, negative=tcond,
                              latent_image=dict(latent), **widgets)
    (j,) = jax_get_op(op).execute(JaxOpContext(), model=jp, positive=jcond,
                                  negative=jcond, latent_image=dict(latent),
                                  **widgets)
    return t, j


@pytest.mark.parametrize("op", ["KSampler", "KSamplerAdvanced"])
def test_sampler_ops_anchor_and_keep_the_mask(op):
    """An image-resolution mask (the tiny VAE halves: 16 -> 8): the kept
    half is the source to the bit, the mask stays on the output latent;
    KSamplerAdvanced without added noise from step 2 blends with zero
    noise, as the JAX package does."""
    jp, tp = _pipes("tiny")
    src = _rng(13).standard_normal((1, 8, 8, 4)).astype(np.float32)
    mask = np.zeros((1, 16, 16), np.float32)
    mask[:, :, 8:] = 1.0
    tmask = torch.from_numpy(mask)
    if op == "KSampler":
        widgets = dict(seed=11, steps=4, cfg=1.5, sampler_name="euler",
                       scheduler="normal", denoise=1.0)
    else:
        widgets = dict(add_noise="disable", noise_seed=11, steps=4, cfg=1.5,
                       sampler_name="euler", scheduler="normal",
                       start_at_step=2, end_at_step=10000,
                       return_with_leftover_noise="disable")
    t, _ = _ksampler_pair(jp, tp, op, {"samples": src,
                                       "noise_mask": tmask}, **widgets)
    _, j = _ksampler_pair(jp, tp, op, {"samples": src, "noise_mask": mask},
                          **widgets)
    o = _np(t["samples"])
    np.testing.assert_allclose(o, np.asarray(j["samples"]), **TOL)
    np.testing.assert_array_equal(o[:, :, :4], src[:, :, :4])
    assert not np.allclose(o[:, :, 4:], src[:, :, 4:])
    assert t["noise_mask"] is tmask
