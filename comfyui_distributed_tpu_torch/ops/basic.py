"""Standard workflow ops on the txt2img path: the counterparts of
``CheckpointLoaderSimple``, ``CLIPTextEncode``, ``EmptyLatentImage``,
``KSampler``, ``VAEDecode`` and ``PreviewImage`` in
``comfyui_distributed_tpu/ops/basic.py``.

Only the plain single-entry conditioning path is ported: regional
prompts, ControlNet, inpaint masks, GLIGEN and the other patches that
``_prepare_sample_inputs`` handles in the JAX package wait for a later
slice.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from comfyui_distributed_tpu_torch.models import registry
from comfyui_distributed_tpu_torch.models.layers import timestep_embedding
from comfyui_distributed_tpu_torch.ops.base import (
    CONTROL,
    Conditioning,
    DeviceImage,
    DeviceLatent,
    Op,
    OpContext,
    SeedValue,
    as_device_array,
    as_image_array,
    register_op,
)


@register_op
class CheckpointLoaderSimple(Op):
    """-> (MODEL, CLIP, VAE); all three views of one DiffusionPipeline."""
    TYPE = "CheckpointLoaderSimple"
    WIDGETS = ["ckpt_name"]

    def execute(self, ctx: OpContext, ckpt_name: str):
        pipe = registry.load_pipeline(ckpt_name, models_dir=ctx.models_dir,
                                      device=ctx.device)
        return (pipe, pipe, pipe)


@register_op
class CLIPTextEncode(Op):
    TYPE = "CLIPTextEncode"
    WIDGETS = ["text"]

    def execute(self, ctx: OpContext, clip, text: str):
        context, pooled = clip.encode_prompt([text])
        return (Conditioning(context=context, pooled=pooled),)


@register_op
class EmptyLatentImage(Op):
    """Zero latent batch on the run's device."""
    TYPE = "EmptyLatentImage"
    WIDGETS = ["width", "height", "batch_size"]
    DEFAULTS = {"width": 512, "height": 512, "batch_size": 1}

    def execute(self, ctx: OpContext, width: int, height: int,
                batch_size: int = 1):
        lat = torch.zeros((int(batch_size), int(height) // 8,
                           int(width) // 8, 4),
                          dtype=torch.float32, device=ctx.device)
        return ({"samples": DeviceLatent(lat)},)


@dataclasses.dataclass
class _SampleInputs:
    latents: torch.Tensor
    context: torch.Tensor
    uncond: torch.Tensor
    seeds: np.ndarray
    sample_idx: np.ndarray
    y: Optional[torch.Tensor]


def _prepare_sample_inputs(model, seed, latent_image,
                           positive: Conditioning,
                           negative: Conditioning) -> _SampleInputs:
    """Latent unpack, per-row seeds and fold-in indices, the conditioning
    batch repeat and the SDXL vector cond.  At fanout 1 every row takes
    the base seed (a DistributedSeed's replica 0 keeps it too) and its
    batch position as fold-in index."""
    dev = model.device
    lat = as_device_array(latent_image["samples"], dev)
    total = int(lat.shape[0])
    base = seed.base if isinstance(seed, SeedValue) else int(seed)
    seeds = np.full((total,), np.uint64(base), np.uint64)
    if positive.context.shape[1] != negative.context.shape[1]:
        raise NotImplementedError(
            "conditionings of different token lengths are not ported yet")
    context = positive.context.to(dev).repeat(total, 1, 1)
    uncond = negative.context.to(dev).repeat(total, 1, 1)
    y = None
    if model.family.unet.adm_in_channels is not None:
        # the single-entry path: the positive's ADM vector rides both
        # CFG halves
        y = _sdxl_vector_cond(model, positive, total, lat.shape[1] * 8,
                              lat.shape[2] * 8)
    return _SampleInputs(latents=lat, context=context, uncond=uncond,
                         seeds=seeds,
                         sample_idx=np.arange(total, dtype=np.uint32), y=y)


def _sdxl_vector_cond(pipe, cond: Conditioning, batch: int, height: int,
                      width: int) -> torch.Tensor:
    """SDXL ADM vector: the pooled text embedding plus 256-dim sinusoidal
    embeddings of (H, W, crop_h=0, crop_w=0, target_H, target_W)."""
    dev = pipe.device
    pooled = cond.pooled
    if pooled is None:
        pooled = torch.zeros((1, 1280), device=dev)
    sizes = torch.tensor([height, width, 0, 0, height, width],
                         dtype=torch.float32, device=dev)
    emb = timestep_embedding(sizes, 256).reshape(1, -1)
    vec = torch.cat([pooled.to(dev, torch.float32), emb], dim=-1)
    want = pipe.family.unet.adm_in_channels
    if vec.shape[-1] < want:
        vec = torch.nn.functional.pad(vec, (0, want - vec.shape[-1]))
    return vec[:, :want].repeat(batch, 1)


@register_op
class KSampler(Op):
    """Denoise loop over the latent batch (one process, one card)."""
    TYPE = "KSampler"
    WIDGETS = ["seed", CONTROL, "steps", "cfg", "sampler_name", "scheduler",
               "denoise"]
    DEFAULTS = {"denoise": 1.0}

    def execute(self, ctx: OpContext, model, seed, steps, cfg,
                sampler_name, scheduler, positive: Conditioning,
                negative: Conditioning, latent_image, denoise: float = 1.0):
        prep = _prepare_sample_inputs(model, seed, latent_image, positive,
                                      negative)
        out = model.sample(
            prep.latents, prep.context, prep.uncond, prep.seeds,
            steps=int(steps), cfg=float(cfg), sampler_name=str(sampler_name),
            scheduler=str(scheduler), denoise=float(denoise), y=prep.y,
            sample_idx=prep.sample_idx)
        return ({"samples": DeviceLatent(out)},)


@register_op
class VAEDecode(Op):
    TYPE = "VAEDecode"

    def execute(self, ctx: OpContext, samples, vae):
        img = vae.vae_decode(as_device_array(samples["samples"], vae.device))
        return (DeviceImage(img.clamp(0.0, 1.0)),)


@register_op
class PreviewImage(Op):
    """Output node: fetches the images to the host into the run's
    collected images."""
    TYPE = "PreviewImage"

    def execute(self, ctx: OpContext, images):
        ctx.saved_images.extend(list(as_image_array(images)))
        return ()
