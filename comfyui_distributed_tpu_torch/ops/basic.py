"""Standard workflow ops on the paths of every workflow in
``workflows/``: the counterparts of ``CheckpointLoaderSimple``,
``CheckpointSave``, ``VAELoader``, ``CLIPLoader``, ``DualCLIPLoader``,
``UNETLoader``, ``LoraLoader``, ``LoraLoaderModelOnly``,
``CLIPSetLastLayer``, ``CLIPTextEncode``, ``CLIPTextEncodeSDXL``,
``CLIPTextEncodeSDXLRefiner``, ``ConditioningCombine``,
``ConditioningSetMask``, ``ConditioningSetArea``,
``ConditioningSetAreaPercentage``, ``ConditioningSetAreaStrength``,
``ConditioningSetTimestepRange``, ``CLIPVisionLoader``,
``CLIPVisionEncode``, ``unCLIPConditioning``,
``unCLIPCheckpointLoader``, ``EmptyLatentImage``, ``KSampler``,
``KSamplerAdvanced``, ``LatentUpscale``, ``LatentUpscaleBy``,
``VAEDecode``, ``VAEEncode``, ``LoadImage``, ``LoadImageMask``,
``ImageScale``, ``ImagePadForOutpaint``, ``VAEEncodeForInpaint``,
``InpaintModelConditioning``, ``InstructPixToPixConditioning``,
``SetLatentNoiseMask``, ``UpscaleModelLoader``,
``ImageUpscaleWithModel``, ``PreviewImage`` and ``SaveImage`` in
``comfyui_distributed_tpu/ops/basic.py`` (at fanout 1: VAEEncode
neither memoises nor expands the batch).

A MASK travels as a float32 tensor on the run's device ([H, W] or
[B, H, W], 1 = resample); a latent's ``noise_mask`` and a
conditioning's area mask stay at image resolution until the sampler
takes them to the latent's (:func:`image_mask_to_latent`).  ControlNet,
GLIGEN and the 3-row guidances (DualCFG, PerpNeg) that
``_prepare_sample_inputs`` handles in the JAX package wait for a later
slice.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
import re
import threading
import zlib
from typing import Any, Optional

import numpy as np
import torch

from comfyui_distributed_tpu_torch.models import registry
from comfyui_distributed_tpu_torch.models.checkpoints import save_checkpoint
from comfyui_distributed_tpu_torch.models.layers import timestep_embedding
from comfyui_distributed_tpu_torch.models.lora import apply_lora_to_pipeline
from comfyui_distributed_tpu_torch.ops.base import (
    CONTROL,
    Conditioning,
    DeviceImage,
    DeviceLatent,
    Op,
    OpContext,
    SeedValue,
    as_device_array,
    as_device_image,
    as_image_array,
    register_op,
)
from comfyui_distributed_tpu_torch.ops.tiling import tiled_apply
from comfyui_distributed_tpu_torch.utils.image import (
    decode_png,
    resize_image,
    save_png,
)
from comfyui_distributed_tpu_torch.utils.log import Timer


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
class VAELoader(Op):
    """A standalone VAE (e.g. vae-ft-mse-840000) -> VAE wire."""
    TYPE = "VAELoader"
    WIDGETS = ["vae_name"]

    def execute(self, ctx: OpContext, vae_name: str):
        return (registry.load_vae(str(vae_name), models_dir=ctx.models_dir,
                                  device=ctx.device),)


@register_op
class CLIPLoader(Op):
    """A standalone text encoder -> CLIP wire; ``type`` names the tower
    geometry (``registry.CLIP_TYPE_FAMILIES``)."""
    TYPE = "CLIPLoader"
    WIDGETS = ["clip_name", "type"]
    DEFAULTS = {"type": "stable_diffusion"}

    def execute(self, ctx: OpContext, clip_name: str,
                type: str = "stable_diffusion"):  # noqa: A002 - schema name
        fam = registry.CLIP_TYPE_FAMILIES.get(str(type))
        if fam is None:
            raise ValueError(
                f"CLIPLoader: unknown type {type!r}; available: "
                f"{sorted(registry.CLIP_TYPE_FAMILIES)}")
        if len(registry.get_family(fam).clips) != 1:
            raise ValueError(f"CLIPLoader: type {type!r} needs "
                             "DualCLIPLoader (two towers)")
        return (registry.load_clip([str(clip_name)],
                                   models_dir=ctx.models_dir,
                                   family_name=fam, device=ctx.device),)


@register_op
class DualCLIPLoader(Op):
    """Two standalone text encoders -> one two-tower CLIP wire (sdxl:
    clip_name1 is CLIP-L, clip_name2 OpenCLIP bigG)."""
    TYPE = "DualCLIPLoader"
    WIDGETS = ["clip_name1", "clip_name2", "type"]
    DEFAULTS = {"type": "sdxl"}

    def execute(self, ctx: OpContext, clip_name1: str, clip_name2: str,
                type: str = "sdxl"):  # noqa: A002 - schema name
        fam = registry.CLIP_TYPE_FAMILIES.get(str(type))
        if fam is None or len(registry.get_family(fam).clips) != 2:
            raise ValueError(f"DualCLIPLoader: type {type!r} is not a "
                             "two-tower family")
        return (registry.load_clip([str(clip_name1), str(clip_name2)],
                                   models_dir=ctx.models_dir,
                                   family_name=fam, device=ctx.device),)


@register_op
class UNETLoader(Op):
    """A standalone diffusion model -> MODEL wire, the family from the
    file name.  ``weight_dtype`` is taken for the schema: weights are
    stored in the family's compute dtype."""
    TYPE = "UNETLoader"
    WIDGETS = ["unet_name", "weight_dtype"]
    DEFAULTS = {"weight_dtype": "default"}

    def execute(self, ctx: OpContext, unet_name: str,
                weight_dtype: str = "default"):
        return (registry.load_unet(str(unet_name), models_dir=ctx.models_dir,
                                   device=ctx.device),)


def _safe_output_path(root: str, rel: str) -> str:
    """``rel`` under the output directory ``root``; a name that would
    leave it raises."""
    root = os.path.realpath(root)
    path = os.path.realpath(os.path.join(root, rel))
    if os.path.commonpath([root, path]) != root:
        raise ValueError(f"filename prefix {rel!r} escapes the output "
                         f"directory {root!r}")
    return path


@register_op
class CheckpointSave(Op):
    """Writes the pipeline back as a single-file torch-layout checkpoint
    (``{prefix}.safetensors`` in the output directory), each tower from
    its own input, in its storage dtype: bf16 UNet and CLIP on the real
    families, fp32 VAE."""
    TYPE = "CheckpointSave"
    WIDGETS = ["filename_prefix"]
    DEFAULTS = {"filename_prefix": "checkpoints/save"}

    def execute(self, ctx: OpContext, model, clip, vae,
                filename_prefix: str = "checkpoints/save"):
        path = _safe_output_path(ctx.output_dir or os.getcwd(),
                                 f"{filename_prefix}.safetensors")
        os.makedirs(os.path.dirname(path), exist_ok=True)
        save_checkpoint(path, model.unet, clip.clip_models, vae.vae,
                        model.family)
        return ()


@register_op
class LoraLoader(Op):
    """Merges a kohya-format LoRA (the file in the models directory, or
    the JAX package's virtual one from the name) into the UNet and text
    towers at the given strengths; returns the patched (MODEL, CLIP).
    The base pipeline stays untouched, and the patched one is cached."""
    TYPE = "LoraLoader"
    WIDGETS = ["lora_name", "strength_model", "strength_clip"]
    DEFAULTS = {"strength_model": 1.0, "strength_clip": 1.0}

    def execute(self, ctx: OpContext, model, clip, lora_name: str,
                strength_model: float = 1.0, strength_clip: float = 1.0):
        sm, sc, name = float(strength_model), float(strength_clip), \
            str(lora_name)
        if sm == 0.0 and sc == 0.0:
            return (model, clip)
        if model is clip:
            patched = apply_lora_to_pipeline(model, name, sm, sc,
                                             models_dir=ctx.models_dir)
            return (patched, patched)
        # MODEL and CLIP from different pipelines: each patched on its own
        m2 = apply_lora_to_pipeline(model, name, sm, 0.0,
                                    models_dir=ctx.models_dir) \
            if sm != 0.0 else model
        c2 = apply_lora_to_pipeline(clip, name, 0.0, sc,
                                    models_dir=ctx.models_dir) \
            if sc != 0.0 else clip
        return (m2, c2)


@register_op
class LoraLoaderModelOnly(Op):
    """LoraLoader on the UNet only."""
    TYPE = "LoraLoaderModelOnly"
    WIDGETS = ["lora_name", "strength_model"]
    DEFAULTS = {"strength_model": 1.0}

    def execute(self, ctx: OpContext, model, lora_name: str,
                strength_model: float = 1.0):
        sm = float(strength_model)
        if sm == 0.0:
            return (model,)
        return (apply_lora_to_pipeline(model, str(lora_name), sm, 0.0,
                                       models_dir=ctx.models_dir),)


@register_op
class CLIPSetLastLayer(Op):
    """Clip-skip: cross-attention conditioning from an earlier hidden
    layer of every text tower (-1 the last, -2 the one before...).  The
    weights are shared; the returned CLIP is the input itself when every
    tower already stops there."""
    TYPE = "CLIPSetLastLayer"
    WIDGETS = ["stop_at_clip_layer"]
    DEFAULTS = {"stop_at_clip_layer": -1}

    def execute(self, ctx: OpContext, clip, stop_at_clip_layer: int = -1):
        stop = int(stop_at_clip_layer)
        fam = clip.family
        if all(c.output_layer == stop for c in fam.clips):
            return (clip,)
        fam2 = dataclasses.replace(fam, clips=tuple(
            dataclasses.replace(c, output_layer=stop) for c in fam.clips))
        return (registry.derive_pipeline(clip, f"clip{stop}", family=fam2),)


@register_op
class CLIPTextEncode(Op):
    TYPE = "CLIPTextEncode"
    WIDGETS = ["text"]

    def execute(self, ctx: OpContext, clip, text: str):
        context, pooled = clip.encode_prompt([text])
        return (Conditioning(context=context, pooled=pooled),)


@register_op
class CLIPTextEncodeSDXL(Op):
    """SDXL's dual-prompt encode: text_l feeds the CLIP-L tower, text_g
    the OpenCLIP tower (whose pooled output starts the ADM vector), and
    the size widgets ride the conditioning as the ADM scalars (height,
    width, crop_h, crop_w, target_height, target_width); a target of 0
    takes the size."""
    TYPE = "CLIPTextEncodeSDXL"
    WIDGETS = ["width", "height", "crop_w", "crop_h", "target_width",
               "target_height", "text_g", "text_l"]
    DEFAULTS = {"crop_w": 0, "crop_h": 0}

    def execute(self, ctx: OpContext, clip, width: int, height: int,
                crop_w: int = 0, crop_h: int = 0, target_width: int = 0,
                target_height: int = 0, text_g: str = "", text_l: str = ""):
        context, pooled = clip.encode_prompt([str(text_l)],
                                             texts_alt=[str(text_g)])
        return (Conditioning(
            context=context, pooled=pooled,
            size_cond=(int(height), int(width), int(crop_h), int(crop_w),
                       int(target_height) or int(height),
                       int(target_width) or int(width))),)


@register_op
class CLIPTextEncodeSDXLRefiner(Op):
    """The SDXL refiner's encode: one prompt, and the ADM scalars
    (height, width, crop_h, crop_w, aesthetic score) of the refiner's
    five-embedding layout."""
    TYPE = "CLIPTextEncodeSDXLRefiner"
    WIDGETS = ["ascore", "width", "height", "text"]
    DEFAULTS = {"ascore": 6.0}

    def execute(self, ctx: OpContext, clip, ascore: float, width: int,
                height: int, text: str):
        context, pooled = clip.encode_prompt([str(text)])
        return (Conditioning(
            context=context, pooled=pooled,
            size_cond=(int(height), int(width), 0, 0, float(ascore))),)


# --- regional prompting -------------------------------------------------------

def _on_all(cond: Conditioning, **fields) -> Conditioning:
    """``fields`` set on the conditioning and on every sibling bundled
    with it: ComfyUI's Set nodes loop over all entries of a list."""
    return dataclasses.replace(
        cond, siblings=tuple(dataclasses.replace(s, **fields)
                             for s in cond.siblings), **fields)


@register_op
class ConditioningCombine(Op):
    """Both conditionings count at sample time, their denoised
    predictions blended by their areas and strengths: the entries are
    bundled as siblings, and the sampler runs them all in one stacked
    model call."""
    TYPE = "ConditioningCombine"

    def execute(self, ctx: OpContext, conditioning_1: Conditioning,
                conditioning_2: Conditioning):
        def flat(c: Conditioning):
            return (dataclasses.replace(c, siblings=()),) + tuple(c.siblings)

        merged = flat(conditioning_1) + flat(conditioning_2)
        return (dataclasses.replace(merged[0], siblings=merged[1:]),)


@register_op
class ConditioningSetMask(Op):
    """A conditioning's influence limited to a mask (``set_cond_area``
    "default": every entry still runs on the whole latent, the mask
    weighs its prediction in the blend; "mask bounds" is taken for the
    schema and not cropped)."""
    TYPE = "ConditioningSetMask"
    WIDGETS = ["strength", "set_cond_area"]
    DEFAULTS = {"strength": 1.0, "set_cond_area": "default"}

    def execute(self, ctx: OpContext, conditioning: Conditioning, mask,
                strength: float = 1.0, set_cond_area: str = "default"):
        return (_on_all(conditioning, area_mask=as_mask(mask, ctx.device),
                        area_strength=float(strength)),)


@register_op
class ConditioningSetArea(Op):
    """A rectangle in pixels (ComfyUI's //8 latent units), resolved
    against the latent at sample time."""
    TYPE = "ConditioningSetArea"
    WIDGETS = ["width", "height", "x", "y", "strength"]
    DEFAULTS = {"strength": 1.0}

    def execute(self, ctx: OpContext, conditioning: Conditioning,
                width: int, height: int, x: int, y: int,
                strength: float = 1.0):
        rect = ("px", int(x), int(y), int(width), int(height))
        return (_on_all(conditioning, area_mask=rect,
                        area_strength=float(strength)),)


@register_op
class ConditioningSetAreaPercentage(Op):
    """A rectangle in canvas fractions."""
    TYPE = "ConditioningSetAreaPercentage"
    WIDGETS = ["width", "height", "x", "y", "strength"]
    DEFAULTS = {"strength": 1.0}

    def execute(self, ctx: OpContext, conditioning: Conditioning,
                width: float, height: float, x: float, y: float,
                strength: float = 1.0):
        rect = ("pct", float(x), float(y), float(width), float(height))
        return (_on_all(conditioning, area_mask=rect,
                        area_strength=float(strength)),)


@register_op
class ConditioningSetAreaStrength(Op):
    TYPE = "ConditioningSetAreaStrength"
    WIDGETS = ["strength"]
    DEFAULTS = {"strength": 1.0}

    def execute(self, ctx: OpContext, conditioning: Conditioning,
                strength: float = 1.0):
        return (_on_all(conditioning, area_strength=float(strength)),)


@register_op
class ConditioningSetTimestepRange(Op):
    """Prompt scheduling: the conditioning counts only while sampling is
    inside [start, end] (percents, 0 = the first step; inclusive sigma
    bounds, as ComfyUI)."""
    TYPE = "ConditioningSetTimestepRange"
    WIDGETS = ["start", "end"]
    DEFAULTS = {"start": 0.0, "end": 1.0}

    def execute(self, ctx: OpContext, conditioning: Conditioning,
                start: float = 0.0, end: float = 1.0):
        return (_on_all(conditioning,
                        timestep_range=(float(start), float(end))),)


# --- unCLIP -------------------------------------------------------------------

@register_op
class CLIPVisionLoader(Op):
    """-> CLIP_VISION: an HF CLIPVisionModel file from the models
    directory or its ``clip_vision/``, else a virtual tower."""
    TYPE = "CLIPVisionLoader"
    WIDGETS = ["clip_name"]

    def execute(self, ctx: OpContext, clip_name: str):
        return (registry.load_clip_vision(str(clip_name),
                                          models_dir=ctx.models_dir,
                                          device=ctx.device),)


@register_op
class CLIPVisionEncode(Op):
    """IMAGE -> CLIP_VISION_OUTPUT: the projected class embedding, the
    last hidden states and those before the final layer; crop "center"
    (ComfyUI's default) or "none"."""
    TYPE = "CLIPVisionEncode"
    WIDGETS = ["crop"]
    DEFAULTS = {"crop": "center"}

    def execute(self, ctx: OpContext, clip_vision, image,
                crop: str = "center"):
        return (clip_vision.encode(
            as_device_image(image, clip_vision.device), crop=str(crop)),)


@register_op
class unCLIPConditioning(Op):
    """An image embedding attached to a conditioning for an unCLIP model
    (image variations): entries accumulate, on every sibling too."""
    TYPE = "unCLIPConditioning"
    WIDGETS = ["strength", "noise_augmentation"]
    DEFAULTS = {"strength": 1.0, "noise_augmentation": 0.0}

    def execute(self, ctx: OpContext, conditioning: Conditioning,
                clip_vision_output, strength: float = 1.0,
                noise_augmentation: float = 0.0):
        entry = (clip_vision_output.image_embeds, float(strength),
                 float(noise_augmentation))

        def attach(e: Conditioning) -> Conditioning:
            return dataclasses.replace(e, unclip=(e.unclip or ()) + (entry,))

        return (dataclasses.replace(
            attach(conditioning),
            siblings=tuple(attach(s) for s in conditioning.siblings)),)


@register_op
class unCLIPCheckpointLoader(Op):
    """-> (MODEL, CLIP, VAE, CLIP_VISION) of an unCLIP checkpoint: the
    diffusion towers as CheckpointLoaderSimple loads them (the family
    from the name, ``sd21_unclip``), and the vision tower virtual from
    ``{name}.vision`` (ViT-H, the tiny tower on a tiny family), as in
    the JAX package, which does not read the tower embedded in a real
    unCLIP file either."""
    TYPE = "unCLIPCheckpointLoader"
    WIDGETS = ["ckpt_name"]

    def execute(self, ctx: OpContext, ckpt_name: str):
        pipe = registry.load_pipeline(str(ckpt_name),
                                      models_dir=ctx.models_dir,
                                      device=ctx.device)
        vision = registry.load_clip_vision(
            f"{ckpt_name}.vision",
            config_name="tiny" if pipe.family.name.startswith("tiny")
            else "vit_h", device=ctx.device)
        return (pipe, pipe, pipe, vision)


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
    # one context [B, T, C] a side, or (regional) lists of (context,
    # mask, strength, sigma range) entries
    context: Any
    uncond: Any
    seeds: np.ndarray
    sample_idx: np.ndarray
    # one ADM vector [B, A] for every row block, or a list, one an entry
    y: Any
    noise_mask: Optional[torch.Tensor] = None
    c_concat: Optional[torch.Tensor] = None


def as_mask(mask, device) -> torch.Tensor:
    """MASK value -> float32 [B, H, W] tensor on ``device``."""
    m = as_device_array(mask, device)
    return m[None] if m.ndim == 2 else m


def cycle_batch(x: torch.Tensor, n: int) -> torch.Tensor:
    """One row per sample, a short batch cycled (row i takes row i mod
    B): the JAX package's ``_cycle_batch`` pairing rule."""
    if x.shape[0] == n:
        return x
    return x[torch.arange(n, device=x.device) % x.shape[0]]


def image_mask_to_latent(mask: torch.Tensor, h: int, w: int,
                         total: int) -> torch.Tensor:
    """Image-resolution mask [B, H, W] -> latent-resolution weights
    [1 or total, h, w, 1]: area-downsampled, clipped to [0, 1]; a
    single mask broadcasts, others cycle to ``total`` (the JAX package's
    ``_image_mask_to_latent``, the one rule for noise and area masks)."""
    m = resize_image(mask[..., None], w, h, "area").clamp(0.0, 1.0)
    return m if m.shape[0] == 1 else cycle_batch(m, total)


def materialize_area_mask(cond: Conditioning, h: int, w: int, total: int,
                          device) -> Optional[torch.Tensor]:
    """A conditioning's area -> latent-resolution weights [1 or total,
    h, w, 1] on ``device``, or None.  A rectangle resolves against this
    latent: ``"px"`` in ComfyUI's //8 latent units, ``"pct"`` as
    fractions rounded against the latent's own size (0.5 of 64 is 32
    columns); a mask resizes as a noise mask does."""
    am = cond.area_mask
    if am is None:
        return None
    if isinstance(am, tuple):
        kind, x, y, ww, hh = am
        if kind == "px":
            x0, y0 = int(x) // 8, int(y) // 8
            x1 = x0 + max(int(ww) // 8, 1)
            y1 = y0 + max(int(hh) // 8, 1)
        else:
            x0, y0 = int(round(x * w)), int(round(y * h))
            x1 = x0 + max(int(round(ww * w)), 1)
            y1 = y0 + max(int(round(hh * h)), 1)
        m = torch.zeros((1, h, w, 1), dtype=torch.float32, device=device)
        m[:, max(y0, 0):min(y1, h), max(x0, 0):min(x1, w), :] = 1.0
        return m
    return image_mask_to_latent(as_mask(am, device), h, w, total)


def entry_sigma_range(schedule, cond: Conditioning):
    """A conditioning's timestep range (sampling percents) -> (sigma
    start, sigma end) on ``schedule`` (the entry counts while s_end <=
    sigma <= s_start), or None."""
    tr = cond.timestep_range
    if tr is None:
        return None
    return (schedule.percent_to_sigma(float(tr[0])),
            schedule.percent_to_sigma(float(tr[1])))


def adm_cond_source(family, e: Conditioning,
                    positive: Conditioning) -> Conditioning:
    """The conditioning an entry's ADM vector is built from: on an unCLIP
    family the entry's own (a negative without an image embedding gets
    zeros, never the positive's); on SDXL the entry's, or the primary
    positive's when it has no pooled embedding."""
    if family.adm_kind == "unclip":
        return e
    return e if e.pooled is not None else positive


def _latent_meta(samples) -> dict:
    """What a latent-space op carries on from its input besides the
    samples: the inpaint mask."""
    return {k: samples[k] for k in ("noise_mask",) if k in samples}


def _prepare_sample_inputs(model, seed, latent_image,
                           positive: Conditioning,
                           negative: Conditioning) -> _SampleInputs:
    """Latent unpack, per-row seeds and fold-in indices, the conditioning
    entries, the ADM vectors, the latent's inpaint mask at the latent's
    resolution and an inpaint or ip2p model's concat channels (from the
    first conditioning that carries them, resized bilinear to the latent
    and cycled to the batch).  At fanout 1 every row takes the base seed
    (a DistributedSeed's replica 0 keeps it too) and its batch position
    as fold-in index.

    Both CFG sides build alike: the conditioning and the siblings
    ConditioningCombine bundled, each entry's tokens aligned across
    both sides (:func:`cond_token_align`), its area mask at the latent's
    size, its strength, its sigma range and (on an ADM family) its own
    vector.  With one plain entry a side the contexts go as single
    tensors and the positive's vector rides both sides (on an unCLIP
    family each side has its own)."""
    dev = model.device
    lat = as_device_array(latent_image["samples"], dev)
    total, h, w = int(lat.shape[0]), int(lat.shape[1]), int(lat.shape[2])
    base = seed.base if isinstance(seed, SeedValue) else int(seed)
    seeds = np.full((total,), np.uint64(base), np.uint64)
    pos_entries = [positive, *positive.siblings]
    neg_entries = [negative, *negative.siblings]
    t_align = cond_token_align(pos_entries + neg_entries)

    def entry(e):
        return (align_cond_tokens(e.context, t_align).to(dev).repeat(
                    total, 1, 1),
                materialize_area_mask(e, h, w, total, dev),
                float(e.area_strength), entry_sigma_range(model.schedule, e))

    def vector(e):
        return _sdxl_vector_cond(
            model, adm_cond_source(model.family, e, positive), total,
            h * 8, w * 8)

    cond_entries = [entry(e) for e in pos_entries]
    unc_entries = [entry(e) for e in neg_entries]
    multi = len(cond_entries) > 1 or len(unc_entries) > 1 or any(
        m is not None or s != 1.0 or sr is not None
        for _, m, s, sr in cond_entries + unc_entries)
    if multi:
        context, uncond = cond_entries, unc_entries
    else:
        context, uncond = cond_entries[0][0], unc_entries[0][0]
    y = None
    if model.family.unet.adm_in_channels is not None:
        if multi or model.family.adm_kind == "unclip":
            y = [vector(e) for e in pos_entries + neg_entries]
        else:
            y = vector(positive)
    mask = latent_image.get("noise_mask")
    if mask is not None:
        mask = image_mask_to_latent(as_mask(mask, dev), h, w, total)
    c_concat = next((c.concat_latent for c in pos_entries + neg_entries
                     if c.concat_latent is not None), None)
    if c_concat is not None:
        c_concat = as_device_array(c_concat, dev)
        if c_concat.shape[1:3] != lat.shape[1:3]:
            c_concat = resize_image(c_concat, w, h, "bilinear")
        c_concat = cycle_batch(c_concat, total)
    return _SampleInputs(latents=lat, context=context, uncond=uncond,
                         seeds=seeds,
                         sample_idx=np.arange(total, dtype=np.uint32), y=y,
                         noise_mask=mask, c_concat=c_concat)


def cond_token_align(entries) -> int:
    """The common token length of conditionings: the lcm of their lengths
    (each repeats to it whole, as ComfyUI does), or the longest when the
    lcm would pass 8 times it (the shorter are zero-padded then)."""
    lengths = {int(e.context.shape[1]) for e in entries}
    t_max = max(lengths)
    t_align = math.lcm(*lengths)
    return t_max if t_align > 8 * t_max else t_align


def align_cond_tokens(c: torch.Tensor, t_align: int) -> torch.Tensor:
    """One context [B, T, C] repeated (when T divides ``t_align``) or
    zero-padded to ``t_align`` tokens."""
    t = int(c.shape[1])
    if t == t_align:
        return c
    if t_align % t == 0:
        return c.repeat(1, t_align // t, 1)
    return torch.nn.functional.pad(c, (0, 0, 0, t_align - t))


def _unclip_vector_cond(pipe, cond: Conditioning,
                        batch: int) -> torch.Tensor:
    """unCLIP ADM vector, the JAX package's approximation of ComfyUI's
    CLIPEmbeddingNoiseAugmentation: each of the conditioning's image
    embeddings (row 0, cut or zero-padded to half the ADM width) noised
    on the model's schedule to level ``round(999 * noise_augmentation)``
    with numpy noise keyed by the embedding's bytes and the level, then
    the level's timestep embedding beside it, scaled by the strength;
    the entries sum.  No embedding: zeros.  Built on the host (the
    level embedding by the port's torch math on the CPU), then moved to
    the device, so every device gets the same vector."""
    want = int(pipe.family.unet.adm_in_channels)
    half = want // 2
    entries = cond.unclip or ()
    if not entries:
        return torch.zeros((batch, want), dtype=torch.float32,
                           device=pipe.device)
    acc = np.zeros((1, want), np.float32)
    abar = np.asarray(pipe.schedule.alphas_cumprod, np.float32)
    for embed, strength, noise_aug in entries:
        e = embed.detach().float().cpu().numpy() \
            if isinstance(embed, torch.Tensor) \
            else np.asarray(embed, np.float32)
        if e.ndim == 1:
            e = e[None]
        e = e[:1]
        if e.shape[1] < half:
            e = np.pad(e, ((0, 0), (0, half - e.shape[1])))
        e = e[:, :half]
        level = min(max(int(round((abar.shape[0] - 1)
                                  * float(noise_aug))), 0),
                    abar.shape[0] - 1)
        rng = np.random.default_rng(zlib.crc32(e.tobytes()) + level)
        noised = (np.sqrt(abar[level]) * e
                  + np.sqrt(max(1.0 - abar[level], 0.0))
                  * rng.standard_normal(e.shape).astype(np.float32))
        lvl = timestep_embedding(torch.tensor([float(level)]), half).numpy()
        acc = acc + np.concatenate([noised, lvl], axis=-1) * float(strength)
    return torch.from_numpy(acc).to(pipe.device).repeat(batch, 1)


def _sdxl_vector_cond(pipe, cond: Conditioning, batch: int, height: int,
                      width: int) -> torch.Tensor:
    """SDXL ADM vector: the pooled text embedding plus 256-dim sinusoidal
    embeddings of the conditioning's size scalars.  Without them the
    latent's size stands in: (H, W, 0, 0, H, W) on the base, and (H, W,
    0, 0, 6.0) on a refiner family, whose fifth scalar is the aesthetic
    score (6.0 the usual one), not a size.  An unCLIP family's vector is
    :func:`_unclip_vector_cond`'s."""
    if pipe.family.adm_kind == "unclip":
        return _unclip_vector_cond(pipe, cond, batch)
    dev = pipe.device
    pooled = cond.pooled
    if pooled is None:
        pooled = torch.zeros((1, 1280), device=dev)
    sc = cond.size_cond
    if sc is None:
        sc = (height, width, 0, 0, 6.0) \
            if pipe.family.name.endswith("refiner") \
            else (height, width, 0, 0, height, width)
    sizes = torch.tensor([float(v) for v in sc], dtype=torch.float32,
                         device=dev)
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
        ctx.check_interrupt()
        prep = _prepare_sample_inputs(model, seed, latent_image, positive,
                                      negative)
        with Timer(f"ksampler[{sampler_name}x{steps}]"):
            out = model.sample(
                prep.latents, prep.context, prep.uncond, prep.seeds,
                steps=int(steps), cfg=float(cfg),
                sampler_name=str(sampler_name), scheduler=str(scheduler),
                denoise=float(denoise), y=prep.y,
                sample_idx=prep.sample_idx, noise_mask=prep.noise_mask,
                c_concat=prep.c_concat)
        # the mask stays on the latent, as ComfyUI keeps it
        return ({**_latent_meta(latent_image), "samples": DeviceLatent(out)},)


@register_op
class KSamplerAdvanced(Op):
    """The staged sampler: runs the window [start_at_step, end_at_step)
    of the schedule, with or without adding noise first, and returns a
    still-noisy latent for a later stage when
    ``return_with_leftover_noise`` is enabled."""
    TYPE = "KSamplerAdvanced"
    WIDGETS = ["add_noise", "noise_seed", CONTROL, "steps", "cfg",
               "sampler_name", "scheduler", "start_at_step", "end_at_step",
               "return_with_leftover_noise"]
    DEFAULTS = {"start_at_step": 0, "end_at_step": 10000,
                "add_noise": "enable",
                "return_with_leftover_noise": "disable"}

    def execute(self, ctx: OpContext, model, add_noise, noise_seed, steps,
                cfg, sampler_name, scheduler, positive: Conditioning,
                negative: Conditioning, latent_image,
                start_at_step: int = 0, end_at_step: int = 10000,
                return_with_leftover_noise: str = "disable"):
        ctx.check_interrupt()
        prep = _prepare_sample_inputs(model, noise_seed, latent_image,
                                      positive, negative)
        with Timer(f"ksampler_adv[{sampler_name}x{steps}"
                   f"@{start_at_step}-{end_at_step}]"):
            out = model.sample(
                prep.latents, prep.context, prep.uncond, prep.seeds,
                steps=int(steps), cfg=float(cfg),
                sampler_name=str(sampler_name), scheduler=str(scheduler),
                y=prep.y, sample_idx=prep.sample_idx,
                add_noise=str(add_noise) != "disable",
                start_step=int(start_at_step),
                end_step=min(int(end_at_step), int(steps)),
                force_full_denoise=str(return_with_leftover_noise)
                == "disable",
                noise_mask=prep.noise_mask, c_concat=prep.c_concat)
        return ({**_latent_meta(latent_image), "samples": DeviceLatent(out)},)


@register_op
class LatentUpscale(Op):
    """Latent resize (hires-fix stage 1 -> 2), on the device.  The pixel
    widgets are divided by 8, as ComfyUI does; a 0 dimension follows the
    other keeping the aspect, 0/0 passes the latent through, and
    crop="center" resizes keeping the aspect and cuts the centre."""
    TYPE = "LatentUpscale"
    WIDGETS = ["upscale_method", "width", "height", "crop"]
    DEFAULTS = {"crop": "disabled", "upscale_method": "nearest-exact"}

    def execute(self, ctx: OpContext, samples, upscale_method: str,
                width: int, height: int, crop: str = "disabled"):
        lat = as_device_array(samples["samples"], ctx.device)
        _, h, w, _ = lat.shape
        width, height = int(width), int(height)
        if width == 0 and height == 0:
            return ({**_latent_meta(samples), "samples": DeviceLatent(lat)},)
        if width == 0:
            lh = max(height // 8, 1)
            lw = max(round(w * lh / h), 1)
        elif height == 0:
            lw = max(width // 8, 1)
            lh = max(round(h * lw / w), 1)
        else:
            lw, lh = max(width // 8, 1), max(height // 8, 1)
        out = resize_maybe_center(lat, lw, lh, str(upscale_method),
                                  str(crop) if width and height
                                  else "disabled")
        return ({**_latent_meta(samples), "samples": DeviceLatent(out)},)


@register_op
class LatentUpscaleBy(Op):
    TYPE = "LatentUpscaleBy"
    WIDGETS = ["upscale_method", "scale_by"]
    DEFAULTS = {"upscale_method": "nearest-exact", "scale_by": 1.5}

    def execute(self, ctx: OpContext, samples, upscale_method: str,
                scale_by: float = 1.5):
        lat = as_device_array(samples["samples"], ctx.device)
        lh = max(round(lat.shape[1] * float(scale_by)), 1)
        lw = max(round(lat.shape[2] * float(scale_by)), 1)
        return ({**_latent_meta(samples), "samples": DeviceLatent(
            resize_image(lat, lw, lh, str(upscale_method)))},)


@register_op
class VAEDecode(Op):
    TYPE = "VAEDecode"

    def execute(self, ctx: OpContext, samples, vae):
        ctx.check_interrupt()
        with Timer("vae_decode"):
            img = vae.vae_decode(as_device_array(samples["samples"],
                                                 vae.device))
        return (DeviceImage(img.clamp(0.0, 1.0)),)


@register_op
class VAEEncode(Op):
    """Pixels -> latent through the pipeline's encoder (the mean)."""
    TYPE = "VAEEncode"

    def execute(self, ctx: OpContext, pixels, vae):
        with Timer("vae_encode"):
            lat = vae.vae_encode(as_device_image(pixels, vae.device))
        return ({"samples": DeviceLatent(lat)},)


def _neutralise(img: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Pixels set to mid-gray where ``mask`` > 0.5, so the encoder does
    not carry the old content of a region to be resampled into its
    neighbours."""
    hard = (mask > 0.5).float()
    return (img - 0.5) * (1.0 - hard[..., None]) + 0.5


def _mask_to_pixels(mask, img: torch.Tensor) -> torch.Tensor:
    """MASK -> [B, H, W] at the pixels' size, resized bilinear when it
    differs (LoadImage's mask keeps the file's size while ImageScale
    has resized the pixels)."""
    m = as_mask(mask, img.device)
    if m.shape[1:3] != img.shape[1:3]:
        m = resize_image(m[..., None], img.shape[2], img.shape[1],
                         "bilinear")[..., 0]
    return m


def grow_mask(mask: torch.Tensor, grow: int) -> torch.Tensor:
    """[B, H, W] dilated by a (2g+1)-square max filter on the mask's
    device; max pooling's implicit -inf border gives what
    ``scipy.ndimage.maximum_filter``'s default ``reflect`` border gives,
    since a reflected value lies in the window already."""
    if grow <= 0:
        return mask
    return torch.nn.functional.max_pool2d(
        mask[:, None], 2 * grow + 1, stride=1, padding=grow)[:, 0]


@register_op
class VAEEncodeForInpaint(Op):
    """ComfyUI's inpaint encode: the mask resized to the pixels and grown
    by ``grow_mask_by``, the pixels under the grown mask neutralised to
    mid-gray, then encoded; the grown mask rides on the latent as its
    ``noise_mask``."""
    TYPE = "VAEEncodeForInpaint"
    WIDGETS = ["grow_mask_by"]
    DEFAULTS = {"grow_mask_by": 6}

    def execute(self, ctx: OpContext, pixels, vae, mask,
                grow_mask_by: int = 6):
        img = as_device_image(pixels, vae.device)
        m = grow_mask(_mask_to_pixels(mask, img), max(int(grow_mask_by), 0))
        lat = vae.vae_encode(_neutralise(img, m))
        return ({"samples": DeviceLatent(lat), "noise_mask": m},)


@register_op
class InpaintModelConditioning(Op):
    """An inpaint model's conditioning (9-channel checkpoints such as
    sd-v1-5-inpainting): the original pixels encoded as the latent to
    sample, a neutralised copy encoded for the UNet's extra channels,
    ``[latent mask (1), masked latent (4)]`` set as ``concat_latent`` on
    both conditionings, and the mask on the latent as its
    ``noise_mask`` unless ``noise_mask`` is off."""
    TYPE = "InpaintModelConditioning"
    WIDGETS = ["noise_mask"]
    DEFAULTS = {"noise_mask": True}

    def execute(self, ctx: OpContext, positive: Conditioning,
                negative: Conditioning, vae, pixels, mask, noise_mask=True):
        img = as_device_image(pixels, vae.device)
        m = _mask_to_pixels(mask, img)
        orig = vae.vae_encode(img)
        masked = vae.vae_encode(_neutralise(img, m))
        b, h, w = orig.shape[:3]
        m_lat = cycle_batch(image_mask_to_latent(m, h, w, b), b)
        concat = torch.cat([m_lat, masked], dim=-1)
        out = {"samples": DeviceLatent(orig)}
        if str(noise_mask).lower() not in ("false", "0", ""):
            out["noise_mask"] = m
        return (dataclasses.replace(positive, concat_latent=concat),
                dataclasses.replace(negative, concat_latent=concat), out)


@register_op
class InstructPixToPixConditioning(Op):
    """InstructPix2Pix: the source pixels encoded and set as
    ``concat_latent`` on both conditionings (the 8-channel UNet's extra
    input), and a zero latent of the source's size to sample from."""
    TYPE = "InstructPixToPixConditioning"

    def execute(self, ctx: OpContext, positive: Conditioning,
                negative: Conditioning, vae, pixels):
        concat = vae.vae_encode(as_device_image(pixels, vae.device))
        return (dataclasses.replace(positive, concat_latent=concat),
                dataclasses.replace(negative, concat_latent=concat),
                {"samples": DeviceLatent(torch.zeros_like(concat))})


@register_op
class SetLatentNoiseMask(Op):
    """Puts an inpaint mask on a latent (1 = resample, 0 = keep the
    source), in place of any it had."""
    TYPE = "SetLatentNoiseMask"

    def execute(self, ctx: OpContext, samples, mask):
        lat = as_device_array(samples["samples"], ctx.device)
        return ({**_latent_meta(samples), "samples": DeviceLatent(lat),
                 "noise_mask": as_mask(mask, ctx.device)},)


def synthetic_test_card() -> np.ndarray:
    """The JAX package's stand-in for a missing input file: a 512^2
    gradient, [1, H, W, 3] float32."""
    yy, xx = np.mgrid[0:512, 0:512].astype(np.float32)
    return np.stack([xx / 512, yy / 512, (xx + yy) / 1024], axis=-1)[None]


@register_op
class LoadImage(Op):
    """-> (IMAGE, MASK).  Reads an 8-bit PNG from ``ctx.input_dir`` (or an
    absolute path); a missing file gives the JAX package's gradient test
    card.  An RGBA file's mask is 1 - alpha, otherwise zeros."""
    TYPE = "LoadImage"
    WIDGETS = ["image", CONTROL]  # second widget is the upload button slot

    def execute(self, ctx: OpContext, image: str):
        path = image
        if ctx.input_dir and not os.path.isabs(path):
            path = os.path.join(ctx.input_dir, image)
        if os.path.exists(path):
            with open(path, "rb") as f:
                arr = decode_png(f.read())
        else:
            arr = synthetic_test_card()
        mask = 1.0 - arr[..., 3] if arr.shape[-1] == 4 else \
            np.zeros(arr.shape[:3], np.float32)
        return (DeviceImage(torch.from_numpy(np.ascontiguousarray(
                    arr[..., :3])).to(ctx.device)),
                torch.from_numpy(np.ascontiguousarray(mask)).to(ctx.device))


@register_op
class LoadImageMask(Op):
    """One channel of an image as a MASK [1, H, W]: R, G, B or (any other
    name) alpha, which inverts (transparent = 1 = resample).  An L or
    RGB file reads as PIL's ``convert("RGBA")`` gives it (R = G = B = L,
    alpha 1); a missing file gives the JAX package's 512^2 gradient card
    with alpha 1."""
    TYPE = "LoadImageMask"
    WIDGETS = ["image", "channel", CONTROL]
    DEFAULTS = {"channel": "alpha"}

    def execute(self, ctx: OpContext, image: str, channel: str = "alpha"):
        path = image
        if ctx.input_dir and not os.path.isabs(path):
            path = os.path.join(ctx.input_dir, image)
        if os.path.exists(path):
            with open(path, "rb") as f:
                arr = decode_png(f.read())[0]
            if arr.shape[-1] == 1:
                arr = np.repeat(arr, 3, axis=-1)
            if arr.shape[-1] == 3:
                arr = np.concatenate(
                    [arr, np.ones(arr.shape[:2] + (1,), np.float32)], -1)
        else:
            arr = np.concatenate([synthetic_test_card()[0],
                                  np.ones((512, 512, 1), np.float32)], -1)
        idx = {"R": 0, "G": 1, "B": 2}.get(str(channel)[:1].upper(), 3)
        m = arr[..., idx]
        if idx == 3:
            m = 1.0 - m
        return (torch.from_numpy(np.ascontiguousarray(m[None])).to(
            ctx.device),)


def resize_maybe_center(img: torch.Tensor, width: int, height: int,
                        method: str, crop: str) -> torch.Tensor:
    """Resize [B, H, W, C] to (width, height); crop="center" scales
    keeping the aspect, then cuts the centre (ComfyUI's common_upscale)."""
    if crop == "center":
        _, h, w, _ = img.shape
        ratio = max(width / w, height / h)
        iw, ih = round(w * ratio), round(h * ratio)
        img = resize_image(img, iw, ih, method)
        x0, y0 = (iw - width) // 2, (ih - height) // 2
        return img[:, y0:y0 + height, x0:x0 + width, :]
    return resize_image(img, width, height, method)


@register_op
class ImageScale(Op):
    TYPE = "ImageScale"
    WIDGETS = ["upscale_method", "width", "height", "crop"]
    DEFAULTS = {"crop": "disabled"}

    def execute(self, ctx: OpContext, image, upscale_method: str,
                width: int, height: int, crop: str = "disabled"):
        img = as_device_image(image, ctx.device)
        return (DeviceImage(resize_maybe_center(img, int(width), int(height),
                                                str(upscale_method),
                                                str(crop))),)


@register_op
class ImagePadForOutpaint(Op):
    """The outpaint canvas: the image on mid-gray, extended on the given
    sides, and a mask [H', W'] of 1 over the new area that feathers
    quadratically to 0 inside the old border, counted only from the
    sides that are extended (no feather when 2 x ``feathering`` does not
    fit the image)."""
    TYPE = "ImagePadForOutpaint"
    WIDGETS = ["left", "top", "right", "bottom", "feathering"]
    DEFAULTS = {"left": 0, "top": 0, "right": 0, "bottom": 0,
                "feathering": 40}

    def execute(self, ctx: OpContext, image, left: int = 0, top: int = 0,
                right: int = 0, bottom: int = 0, feathering: int = 40):
        img = as_device_image(image, ctx.device)
        b, h, w, c = img.shape
        left, top = max(int(left), 0), max(int(top), 0)
        right, bottom = max(int(right), 0), max(int(bottom), 0)
        dev = img.device
        out = torch.full((b, h + top + bottom, w + left + right, c), 0.5,
                         dtype=torch.float32, device=dev)
        out[:, top:top + h, left:left + w] = img
        mask = torch.ones(out.shape[1:3], dtype=torch.float32, device=dev)
        inner = torch.zeros((h, w), dtype=torch.float32, device=dev)
        f = int(feathering)
        if f > 0 and f * 2 < h and f * 2 < w:
            rows = torch.arange(h, dtype=torch.float32, device=dev)[:, None]
            cols = torch.arange(w, dtype=torch.float32, device=dev)[None, :]
            d = torch.full((h, w), float(max(h, w)), dtype=torch.float32,
                           device=dev)
            for extended, dist in ((top, rows), (bottom, h - rows),
                                   (left, cols), (right, w - cols)):
                if extended:
                    d = torch.minimum(d, dist)
            v = ((f - d) / f).clamp(0.0, 1.0)
            inner = v * v
        mask[top:top + h, left:left + w] = inner
        return (DeviceImage(out), mask)


@register_op
class UpscaleModelLoader(Op):
    TYPE = "UpscaleModelLoader"
    WIDGETS = ["model_name"]

    def execute(self, ctx: OpContext, model_name: str):
        return (registry.load_upscaler(model_name, models_dir=ctx.models_dir,
                                       device=ctx.device),)


@register_op
class ImageUpscaleWithModel(Op):
    """Super-resolution of the whole image, or above ``TILE_THRESHOLD``
    input pixels over feathered overlapping tiles (``tiled_apply``),
    which stop between tiles once the prompt is interrupted."""
    TYPE = "ImageUpscaleWithModel"
    TILE_THRESHOLD = 1024 * 1024
    TILE = 512
    OVERLAP = 32

    def execute(self, ctx: OpContext, upscale_model, image):
        img = as_device_image(image, ctx.device)
        _, h, w, _ = img.shape
        if h * w <= self.TILE_THRESHOLD:
            out = upscale_model(img)
        else:
            out = tiled_apply(upscale_model, img, self.TILE, self.OVERLAP,
                              upscale_model.scale, out_channels=img.shape[-1],
                              check_interrupt=ctx.check_interrupt)
        return (DeviceImage(out),)


@register_op
class PreviewImage(Op):
    """Output node: fetches the images to the host into the run's
    collected images."""
    TYPE = "PreviewImage"

    def execute(self, ctx: OpContext, images):
        ctx.saved_images.extend(list(as_image_array(images)))
        return ()


# one counter scan and write at a time: two runs saving under one
# prefix must not take the same numbers
_save_counter_lock = threading.Lock()


def _next_image_counter(dirpath: str, base: str) -> int:
    """First unused counter of ``base_#####.png`` in ``dirpath``."""
    pat = re.compile(re.escape(base) + r"_(\d+)\.png$")
    taken = [int(m.group(1)) for f in os.listdir(dirpath)
             if (m := pat.match(f))]
    return max(taken, default=-1) + 1


@register_op
class SaveImage(Op):
    """Output node: writes each image as ``{prefix}_NNNNN.png`` into the
    output directory, the counter continuing after the highest file
    there, with the run's API-format graph and the request's
    ``extra_pnginfo`` in text chunks (:func:`png_text`); the images also
    go into the run's collected images."""
    TYPE = "SaveImage"
    WIDGETS = ["filename_prefix"]
    DEFAULTS = {"filename_prefix": "DistributedTPU"}

    def execute(self, ctx: OpContext, images,
                filename_prefix: str = "DistributedTPU"):
        arr = as_image_array(images)
        if ctx.output_dir:
            probe = _safe_output_path(ctx.output_dir,
                                      f"{filename_prefix}_00000.png")
            d, fname = os.path.split(probe)
            base = fname[:-len("_00000.png")]
            os.makedirs(d, exist_ok=True)
            with _save_counter_lock:
                start = _next_image_counter(d, base)
                for i, img in enumerate(arr):
                    save_png(os.path.join(d, f"{base}_{start + i:05d}.png"),
                             img, png_text(ctx))
        ctx.saved_images.extend(list(arr))
        return ()


def png_text(ctx: OpContext) -> Optional[dict]:
    """The text chunks of a saved PNG, in the JAX package's order and
    encoding: ``prompt`` (the API-format graph), then one per key of the
    request's ``extra_pnginfo`` (the UI's ``workflow``), each value
    JSON-encoded; None when there is neither."""
    text = {}
    if ctx.prompt_json is not None:
        text["prompt"] = json.dumps(ctx.prompt_json)
    for k, v in dict(ctx.extra_pnginfo or {}).items():
        text[str(k)] = json.dumps(v)
    return text or None
