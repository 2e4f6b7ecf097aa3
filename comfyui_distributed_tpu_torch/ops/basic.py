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
``ImageUpscaleWithModel``, ``PreviewImage``, ``SaveImage``,
``ControlNetLoader``, ``DiffControlNetLoader``, ``ControlNetApply``,
``ControlNetApplyAdvanced``, ``Canny``, ``FreeU``, ``FreeU_V2``,
``HyperTile``, ``PatchModelAddDownscale``, the custom-sampling graph
(``KSamplerSelect``, ``BasicScheduler``, ``KarrasScheduler``,
``ExponentialScheduler``, ``PolyexponentialScheduler``,
``VPScheduler``, ``LaplaceScheduler``, ``BetaSamplingScheduler``,
``AlignYourStepsScheduler``, ``SDTurboScheduler``,
``SplitSigmasDenoise``, ``SplitSigmas``, ``FlipSigmas``,
``SamplerCustom``, ``RandomNoise``, ``DisableNoise``, ``BasicGuider``,
``CFGGuider``, ``DualCFGGuider``, ``PerpNegGuider``,
``SamplerCustomAdvanced``), the sampling patches ``RescaleCFG``,
``ModelSamplingDiscrete``, ``SelfAttentionGuidance`` and ``PerpNeg``,
``TomePatchModel``, ``HypernetworkLoader``, ``GLIGENLoader``,
``GLIGENTextBoxApply``, ``StyleModelLoader`` and ``StyleModelApply``,
``VAEDecodeTiled``, ``VAEEncodeTiled``, ``ConditioningConcat``,
``ConditioningAverage``, ``ConditioningZeroOut``, and the latent
(``LatentAdd``, ``LatentSubtract``, ``LatentMultiply``,
``LatentInterpolate``, ``LatentBlend``, ``LatentComposite``,
``LatentCompositeMasked``, ``LatentCrop``, ``LatentFlip``,
``LatentRotate``, ``LatentBatch``, ``LatentFromBatch``,
``LatentBatchSeedBehavior``, ``RepeatLatentBatch``,
``RebatchLatents``), mask (``SolidMask``, ``InvertMask``,
``GrowMask``, ``MaskComposite``, ``MaskToImage``, ``ImageToMask``,
``ImageColorToMask``, ``CropMask``, ``FeatherMask``,
``ThresholdMask``, ``Morphology``) and image ops (``EmptyImage``,
``ImageBatch``, ``ImageFromBatch``, ``RebatchImages``, ``ImageCrop``,
``ImageInvert``, ``ImageBlend``, ``ImageBlur``, ``ImageSharpen``,
``ImageCompositeMasked``, ``PorterDuffImageComposite``,
``SplitImageWithAlpha``, ``JoinImageWithAlpha``, ``ImageScaleBy``,
``ImageScaleToTotalPixels``, ``ImageQuantize``), the weight-space merges
(``ModelMergeSimple``, ``ModelMergeAdd``, ``ModelMergeSubtract``,
``ModelMergeBlocks``, ``CLIPMergeSimple``, ``CLIPMergeAdd``,
``CLIPMergeSubtract``), the savers (``ModelSave``, ``CLIPSave``,
``VAESave``, ``SaveLatent``, ``SaveAnimatedPNG``, ``SaveAnimatedWEBP``)
and ``LoadLatent`` in ``comfyui_distributed_tpu/ops/basic.py`` (at
fanout 1: VAEEncode does not expand the batch).  A merge computes each
weight in fp32 in the JAX package's order of operations, one tensor at
a time on the pipelines' device, and casts it back to the first model's
dtype; the merged pipeline is a cached derivation
(``registry.derive_pipeline``), so a second merge of the same pair
computes nothing.  The animations and the quantizer have the port's own
encoders (``utils/image.py:encode_apng``, ``utils/webp.py``,
``utils/quantize.py``), as the card's machine has no Pillow.  SIGMAS
travel as host float32 arrays; the latent, image and mask ops compute
on the run's device, Morphology as torch min and max windows on scipy's
border, blur and sharpen on numpy's.

The reuse plane's encode memo (``runtime/reuse.py``): CLIPTextEncode,
CLIPTextEncodeSDXL and VAEEncode keep their result on the device under
the executing node's input sub-graph key (``OpContext.content_key``), as
the JAX ops do, and a later run with the same sub-graph takes it (its
node span marked ``cache_hit``).  The port's memo key also names the
pipeline object (``ReusePlane.model_salt``), so one graph run on the
CPU and on the card, or under two families, in one process never
shares an entry.  Coalesced runs (``OpContext.coalesce``):
EmptyLatentImage lays out ``batch_size * k`` rows prompt-major, KSampler
takes the per-prompt seeds (``coalesced_seeds``) and each saved PNG
carries its own prompt's seed.  PreviewImage and SaveImage collect
through ``OpContext.collect_images``: on the server's host pool their
encodes and writes overlap the next run.

A MASK travels as a float32 tensor on the run's device ([H, W] or
[B, H, W], 1 = resample); a latent's ``noise_mask`` and a
conditioning's area mask stay at image resolution until the sampler
takes them to the latent's (:func:`image_mask_to_latent`), and so does a
ControlNet's hint (8x the latent's size, :func:`gather_control`).
GLIGEN's grounding tokens are built in ``_prepare_sample_inputs`` for
one set a row block (:func:`grounding_tokens`), and a grounded
conditioning makes the sampler take the fuser pipeline
(:func:`_maybe_gligen_model`).
"""

from __future__ import annotations

import copy
import dataclasses
import json
import math
import os
import re
import threading
import zlib
from typing import Any, Optional, Tuple

import numpy as np
import torch

from comfyui_distributed_tpu_torch.models import checkpoints as ckpt_mod
from comfyui_distributed_tpu_torch.models import registry
from comfyui_distributed_tpu_torch.models import schedules as sch
from comfyui_distributed_tpu_torch.models.checkpoints import save_checkpoint
from comfyui_distributed_tpu_torch.models.layers import timestep_embedding
from comfyui_distributed_tpu_torch.models.lora import apply_lora_to_pipeline
from comfyui_distributed_tpu_torch.models.samplers import get_sampler
from comfyui_distributed_tpu_torch.ops.base import (
    CONTROL,
    CBCapture,
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
from comfyui_distributed_tpu_torch.runtime import reuse as reuse_mod
from comfyui_distributed_tpu_torch.ops.tiling import tiled_apply
from comfyui_distributed_tpu_torch.utils.image import (
    decode_png,
    decode_png_rgba,
    encode_apng,
    resize_image,
    save_png,
    to_uint8,
)
from comfyui_distributed_tpu_torch.utils import quantize as quantize_mod
from comfyui_distributed_tpu_torch.utils import trace as trace_mod
from comfyui_distributed_tpu_torch.utils import webp as webp_mod
from comfyui_distributed_tpu_torch.utils.log import Timer, debug_log, log


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
class ModelSave(Op):
    """Writes the diffusion model alone as ``{prefix}.safetensors`` with
    ``model.diffusion_model.`` keys, in its storage dtype (UNETLoader
    reads it back)."""
    TYPE = "ModelSave"
    WIDGETS = ["filename_prefix"]
    DEFAULTS = {"filename_prefix": "diffusion_models/save"}

    def execute(self, ctx: OpContext, model,
                filename_prefix: str = "diffusion_models/save"):
        unet = model._require(model.unet, "UNet")
        if any(p.dtype == torch.bfloat16 for p in unet.parameters()):
            log("ModelSave: weights are stored bf16 (the family's compute "
                "dtype); the exported file will be bf16")
        path = _safe_output_path(ctx.output_dir or os.getcwd(),
                                 f"{filename_prefix}.safetensors")
        os.makedirs(os.path.dirname(path), exist_ok=True)
        ckpt_mod.save_part(path, unet, "unet", model.family.unet,
                           ckpt_mod.UNET_PREFIX)
        debug_log(f"ModelSave: wrote {path}")
        return ()


@register_op
class CLIPSave(Op):
    """Writes the text towers as ``{prefix}.safetensors``, each under
    its in-checkpoint prefix (CLIPLoader and DualCLIPLoader read it
    back, one name a tower)."""
    TYPE = "CLIPSave"
    WIDGETS = ["filename_prefix"]
    DEFAULTS = {"filename_prefix": "clip/save"}

    def execute(self, ctx: OpContext, clip,
                filename_prefix: str = "clip/save"):
        fam = clip.family
        path = _safe_output_path(ctx.output_dir or os.getcwd(),
                                 f"{filename_prefix}.safetensors")
        os.makedirs(os.path.dirname(path), exist_ok=True)
        sd = {}
        for ccfg, m, prefix in zip(
                fam.clips, clip._require(clip.clip_models, "text encoder"),
                ckpt_mod._clip_prefixes(fam)):
            sd.update(ckpt_mod._clip_runner(ccfg)(ckpt_mod._ExportMapper(
                ckpt_mod._by_path(m), prefix), ccfg))
        ckpt_mod.write_safetensors(sd, path)
        debug_log(f"CLIPSave: wrote {path}")
        return ()


@register_op
class VAESave(Op):
    """Writes the VAE as ``{prefix}.safetensors`` with bare keys
    (VAELoader reads it back)."""
    TYPE = "VAESave"
    WIDGETS = ["filename_prefix"]
    DEFAULTS = {"filename_prefix": "vae/save"}

    def execute(self, ctx: OpContext, vae, filename_prefix: str = "vae/save"):
        path = _safe_output_path(ctx.output_dir or os.getcwd(),
                                 f"{filename_prefix}.safetensors")
        os.makedirs(os.path.dirname(path), exist_ok=True)
        ckpt_mod.save_part(path, vae._require(vae.vae, "VAE"), "vae",
                           vae.family.vae)
        debug_log(f"VAESave: wrote {path}")
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


def _embed_cache_get(ctx: OpContext, kind: str, pipe):
    """The encode memo's lookup: (key, hit), the key None when the node
    has no content key, the plane is off or ``pipe`` has no identity.
    A hit marks the node's span ``cache_hit``/``cache_tier``."""
    if not reuse_mod.reuse_enabled() or not ctx.content_key:
        return None, None
    plane = reuse_mod.get_reuse()
    salt = plane.model_salt(pipe)
    if salt is None:
        return None, None
    key = f"{kind}:{ctx.content_key}:{salt}"
    hit = plane.subgraph.get(key)
    if hit is not None:
        sp = trace_mod.current_span()
        if sp is not None:
            sp.attrs["cache_hit"] = True
            sp.attrs["cache_tier"] = "embed"
    return key, hit


def _embed_cache_put(key, value, nbytes: int) -> None:
    if key is not None:
        reuse_mod.get_reuse().subgraph.put(key, value, nbytes)


@register_op
class CLIPTextEncode(Op):
    TYPE = "CLIPTextEncode"
    WIDGETS = ["text"]

    def execute(self, ctx: OpContext, clip, text: str):
        key, hit = _embed_cache_get(ctx, "embed", clip)
        if hit is not None:
            return (hit,)
        context, pooled = clip.encode_prompt([text])
        cond = Conditioning(context=context, pooled=pooled)
        _embed_cache_put(key, cond, reuse_mod.conditioning_nbytes(cond))
        return (cond,)


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
        key, hit = _embed_cache_get(ctx, "embed_sdxl", clip)
        if hit is not None:
            return (hit,)
        context, pooled = clip.encode_prompt([str(text_l)],
                                             texts_alt=[str(text_g)])
        cond = Conditioning(
            context=context, pooled=pooled,
            size_cond=(int(height), int(width), int(crop_h), int(crop_w),
                       int(target_height) or int(height),
                       int(target_width) or int(width)))
        _embed_cache_put(key, cond, reuse_mod.conditioning_nbytes(cond))
        return (cond,)


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


def _on_entries(cond: Conditioning, fn) -> Conditioning:
    """``fn`` applied to the conditioning and to every sibling bundled
    with it (ComfyUI loops the cond list)."""
    return dataclasses.replace(
        fn(cond), siblings=tuple(fn(s) for s in cond.siblings))


@register_op
class ConditioningConcat(Op):
    """Concatenates along the token axis (prompt chaining), on every
    entry of ``conditioning_to``; of ``conditioning_from`` only the
    primary entry counts, as in ComfyUI."""
    TYPE = "ConditioningConcat"

    def execute(self, ctx: OpContext, conditioning_to: Conditioning,
                conditioning_from: Conditioning):
        if conditioning_from.siblings:
            debug_log("ConditioningConcat: conditioning_from has multiple "
                      "entries; using the first (ComfyUI behavior)")
        c_from = conditioning_from.context

        def cat(e: Conditioning) -> Conditioning:
            return dataclasses.replace(
                e, context=torch.cat([e.context, c_from.to(e.context.device)],
                                     dim=1),
                control=e.control or conditioning_from.control)

        return (_on_entries(conditioning_to, cat),)


@register_op
class ConditioningAverage(Op):
    """``to * strength + from * (1 - strength)`` on every entry of
    ``conditioning_to`` (the primary entry of ``conditioning_from``,
    zero-padded or cut to each entry's token count).  The pooled
    embeddings blend when both have one, else ``to``'s, else
    ``from``'s."""
    TYPE = "ConditioningAverage"
    WIDGETS = ["conditioning_to_strength"]
    DEFAULTS = {"conditioning_to_strength": 1.0}

    def execute(self, ctx: OpContext, conditioning_to: Conditioning,
                conditioning_from: Conditioning,
                conditioning_to_strength: float = 1.0):
        if conditioning_from.siblings:
            debug_log("ConditioningAverage: conditioning_from has "
                      "multiple entries; using the first (ComfyUI "
                      "behavior)")
        w = float(conditioning_to_strength)
        p_from = conditioning_from.pooled

        def blend(e: Conditioning) -> Conditioning:
            c_to = e.context
            c_from = conditioning_from.context.to(c_to.device)
            t0 = c_to.shape[1]
            if c_from.shape[1] < t0:
                c_from = torch.nn.functional.pad(
                    c_from, (0, 0, 0, t0 - c_from.shape[1]))
            c_from = c_from[:, :t0]
            pooled = e.pooled
            if pooled is not None and p_from is not None:
                pooled = pooled * w + p_from.to(pooled.device) * (1.0 - w)
            elif pooled is None:
                pooled = p_from
            return dataclasses.replace(
                e, context=c_to * w + c_from * (1.0 - w), pooled=pooled,
                control=e.control or conditioning_from.control)

        return (_on_entries(conditioning_to, blend),)


@register_op
class ConditioningZeroOut(Op):
    """The context and pooled embeddings of every entry set to zeros
    (the unconditional that is truly nothing)."""
    TYPE = "ConditioningZeroOut"

    def execute(self, ctx: OpContext, conditioning: Conditioning):
        def zero(e: Conditioning) -> Conditioning:
            return dataclasses.replace(
                e, context=torch.zeros_like(e.context),
                pooled=None if e.pooled is None
                else torch.zeros_like(e.pooled))

        return (_on_entries(conditioning, zero),)


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
    """Zero latent batch on the run's device.  A coalesced run lays out
    ``batch_size * coalesce`` rows prompt-major (``[prompt0 x b, prompt1
    x b, ...]``, the order ``scheduler.split_images`` relies on); the
    latent carries ``local_batch``, each prompt's ``batch_size``."""
    TYPE = "EmptyLatentImage"
    WIDGETS = ["width", "height", "batch_size"]
    DEFAULTS = {"width": 512, "height": 512, "batch_size": 1}

    def execute(self, ctx: OpContext, width: int, height: int,
                batch_size: int = 1):
        total = int(batch_size) * max(int(ctx.coalesce), 1)
        lat = torch.zeros((total, int(height) // 8, int(width) // 8, 4),
                          dtype=torch.float32, device=ctx.device)
        return ({"samples": DeviceLatent(lat),
                 "local_batch": int(batch_size)},)


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
    # the ControlNet links for DiffusionPipeline.sample (gather_control)
    control: Any = None
    # 3-row guidance (DualCFGGuider, PerpNegGuider, the PerpNeg patch):
    # the middle conditioning's context [B, T, C], None for plain CFG;
    # ``guidance`` and ``cfg2`` are what a PerpNeg-patched pipeline
    # injects ("perp_neg" and its scale)
    mid_context: Optional[torch.Tensor] = None
    guidance: str = "dual"
    cfg2: float = 1.0
    # GLIGEN's grounding tokens for DiffusionPipeline.sample (its
    # ``gligen_objs``), None without a grounded entry
    gligen_objs: Any = None


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
    samples: each prompt's batch size (``local_batch``; a later sampler
    of a coalesced run restarts its fold-in indices with it), the
    inpaint mask and LatentBatchSeedBehavior's ``seed_fixed_batch``."""
    return {k: samples[k] for k in ("local_batch", "noise_mask",
                                    "seed_fixed_batch")
            if k in samples}


def _prepare_sample_inputs(model, seed, latent_image,
                           positive: Conditioning,
                           negative: Conditioning,
                           middle: Optional[Conditioning] = None
                           ) -> _SampleInputs:
    """Latent unpack, per-row seeds and fold-in indices, the conditioning
    entries, the ADM vectors, the latent's inpaint mask at the latent's
    resolution and an inpaint or ip2p model's concat channels (from the
    first conditioning that carries them, resized bilinear to the latent
    and cycled to the batch).  At fanout 1 every row takes the base seed
    (a DistributedSeed's replica 0 keeps it too) and its position in its
    prompt's batch (``local_batch`` rows) as fold-in index; a coalesced
    run's seed (``SeedValue.per_prompt``) gives prompt j's rows seed j,
    so each row draws the ``(seed, index)`` noise of its serial run.  A
    latent marked ``seed_fixed_batch`` gives every row index 0.

    Both CFG sides build alike: the conditioning and the siblings
    ConditioningCombine bundled, each entry's tokens aligned across
    both sides (:func:`cond_token_align`), its area mask at the latent's
    size, its strength, its sigma range and (on an ADM family) its own
    vector).  With one plain entry a side the contexts go as single
    tensors and the positive's vector rides both sides (on an unCLIP
    family each side has its own).

    ``middle`` (DualCFGGuider, PerpNegGuider): a third conditioning in
    the same pass.  Token alignment spans all three, it carries its own
    ADM vector (``y`` is [cond, middle, cond] on an SDXL-kind family,
    [cond, middle, uncond] on an unCLIP one), a ControlNet on any of the
    three gets flat [cond, middle, uncond] strengths and windows, and
    every side must be one plain entry.  A PerpNeg-patched pipeline
    (``perp_neg_cond``) injects its empty conditioning as the middle
    when none is given."""
    guidance, cfg2 = "dual", 1.0
    if middle is None:
        pn = getattr(model, "perp_neg_cond", None)
        if pn is not None:
            middle = pn
            guidance = "perp_neg"
            cfg2 = float(getattr(model, "perp_neg_scale", 1.0))
    dev = model.device
    lat = as_device_array(latent_image["samples"], dev)
    total, h, w = int(lat.shape[0]), int(lat.shape[1]), int(lat.shape[2])
    base = seed.base if isinstance(seed, SeedValue) else int(seed)
    per_prompt = seed.per_prompt if isinstance(seed, SeedValue) else None
    if per_prompt is not None and len(per_prompt) > 0 \
            and total % len(per_prompt) == 0:
        seeds = np.repeat(np.asarray(per_prompt, np.uint64),
                          total // len(per_prompt))
    else:
        seeds = np.full((total,), np.uint64(base), np.uint64)
    # the fold-in index restarts with each prompt's batch
    local_b = max(int(latent_image.get("local_batch", total)), 1)
    sample_idx = np.tile(np.arange(local_b, dtype=np.uint32),
                         -(-total // local_b))[:total]
    if latent_image.get("seed_fixed_batch"):
        # LatentBatchSeedBehavior "fixed": one noise stream for the batch
        sample_idx = np.zeros_like(sample_idx)
    pos_entries = [positive, *positive.siblings]
    neg_entries = [negative, *negative.siblings]
    mid_entries = [middle] if middle is not None else []
    t_align = cond_token_align(pos_entries + neg_entries + mid_entries)

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
    mid_built = [entry(e) for e in mid_entries]
    multi = len(cond_entries) > 1 or len(unc_entries) > 1 or any(
        m is not None or s != 1.0 or sr is not None
        for _, m, s, sr in cond_entries + unc_entries + mid_built)
    if middle is not None and multi:
        raise ValueError(
            f"3-row guidance ({guidance}: "
            f"{'PerpNeg patch' if guidance == 'perp_neg' else 'DualCFG'}"
            ") requires plain single-entry positive/negative "
            "conditionings")
    if multi:
        context, uncond = cond_entries, unc_entries
    else:
        context, uncond = cond_entries[0][0], unc_entries[0][0]
    y = None
    if model.family.unet.adm_in_channels is not None:
        unclip = model.family.adm_kind == "unclip"
        if middle is not None:
            y = [vector(positive), vector(middle),
                 vector(negative) if unclip else vector(positive)]
        elif multi or unclip:
            y = [vector(e) for e in pos_entries + neg_entries]
        else:
            y = vector(positive)
    mask = latent_image.get("noise_mask")
    if mask is not None:
        mask = image_mask_to_latent(as_mask(mask, dev), h, w, total)
    gligen_objs = grounding_tokens(pos_entries, neg_entries, mid_entries,
                                   total, h, w)
    c_concat = next((c.concat_latent for c in pos_entries + neg_entries
                     if c.concat_latent is not None), None)
    if c_concat is not None:
        c_concat = as_device_array(c_concat, dev)
        if c_concat.shape[1:3] != lat.shape[1:3]:
            c_concat = resize_image(c_concat, w, h, "bilinear")
        c_concat = cycle_batch(c_concat, total)
    return _SampleInputs(latents=lat, context=context, uncond=uncond,
                         seeds=seeds, sample_idx=sample_idx, y=y,
                         noise_mask=mask, c_concat=c_concat,
                         control=gather_control(model.schedule, pos_entries,
                                                neg_entries, total, h, w,
                                                mid_entries),
                         mid_context=None if middle is None
                         else mid_built[0][0],
                         guidance=guidance, cfg2=cfg2,
                         gligen_objs=gligen_objs)


def grounding_tokens(pos_entries, neg_entries, mid_entries, total: int,
                     h: int, w: int):
    """GLIGEN's grounding tokens a row block, as the JAX package's
    sampler prep builds them: each distinct spec (by identity, first
    seen over positive, negative and middle entries) becomes one token
    set, padded with null tokens to the most boxes any spec has; a block
    whose entry has no spec gets the all-null set.  Boxes (x, y, w, h)
    in latent units become xyxy fractions of this latent, clipped to
    [0, 1]; a phrase embedding wider or narrower than the first model's
    text width is cut or zero-padded.  Returns (sets [S, total, n, D],
    null set [total, n, D], one index a block: positives, the middle,
    negatives; -1 the null set), or None without a spec."""
    specs = []
    for e in list(pos_entries) + list(neg_entries) + list(mid_entries):
        sp = e.gligen
        if sp is not None and all(sp is not s for s in specs):
            specs.append(sp)
    if not specs:
        return None
    gmodel = specs[0][0]
    if any(sp[0] is not gmodel for sp in specs):
        log("GLIGEN: conditioning entries carry DIFFERENT gligen "
            "models; grounding tokens all run through the first model's "
            "fusers")
    n_max = max(len(sp[1]) for sp in specs)
    d_text = gmodel.cfg.text_dim

    def spec_tokens(entries_g):
        embs = np.zeros((1, n_max, d_text), np.float32)
        boxes = np.zeros((1, n_max, 4), np.float32)
        alive = np.zeros((1, n_max), np.float32)
        for i, (t, b) in enumerate(entries_g):
            v = (t.detach().float().cpu().numpy()
                 if isinstance(t, torch.Tensor)
                 else np.asarray(t, np.float32)).reshape(-1)
            cut = min(v.shape[0], d_text)
            embs[0, i, :cut] = v[:cut]
            bx = np.asarray([b[0], b[1], b[0] + b[2], b[1] + b[3]],
                            np.float32) / np.asarray([w, h, w, h],
                                                     np.float32)
            boxes[0, i] = np.clip(bx, 0.0, 1.0)
            alive[0, i] = 1.0
        tok = gmodel.grounding_tokens(embs, boxes, alive)
        return tok.expand(total, -1, -1)

    sets = torch.stack([spec_tokens(sp[1]) for sp in specs])
    null = spec_tokens(())

    def spec_index(e):
        return next((i for i, s in enumerate(specs) if s is e.gligen), -1)

    idxs = tuple(spec_index(e) for e in pos_entries) \
        + tuple(spec_index(e) for e in mid_entries) \
        + tuple(spec_index(e) for e in neg_entries)
    return sets, null, idxs


def _maybe_gligen_model(model, *conds):
    """The pipeline a grounded conditioning samples with: any entry (or
    sibling) carrying a GLIGEN spec pulls in the fuser pipeline of its
    model (:func:`gligen_attach`), as the JAX package's samplers do; the
    graph carries the grounding on the conditioning only."""
    for c in conds:
        if c is None:
            continue
        for e in (c, *c.siblings):
            if e.gligen is not None:
                if model.family.unet.gligen:
                    return model
                return gligen_attach(model, e.gligen[0])
    return model


def control_chain(cond: Conditioning) -> tuple:
    """A conditioning's ControlNet links as a tuple (empty without)."""
    return tuple(cond.control or ())


def gather_control(schedule, pos_entries, neg_entries, total: int, h: int,
                   w: int, mid_entries=()):
    """The sampler's ControlNet links from every entry of both sides
    (ComfyUI honours a control on any entry): each distinct (net, hint)
    in first-seen order, and the same net chained twice on one entry
    keeps both links (ComfyUI runs every link and sums).  A link's
    strengths and windows are per entry, 0 and None where the entry does
    not carry it, so a control steers only its own entries' rows; the
    percent windows become sigma pairs on ``schedule``.  Each hint is
    resized bilinearly to 8x the latent's size and cycled to the
    ``total`` rows.  Returns ``[(net, hint, (cond strengths, uncond
    strengths), (cond windows, uncond windows) or None)]``, or None.
    With a 3-row guidance's ``mid_entries`` (one entry a side) each
    link's strengths and windows are flat [cond, middle, uncond]
    triples instead."""
    nets = []            # (net, hint) in first-seen order
    net_max_ord = []     # per net: the most links of it on one entry
    spec_slot = {}       # id(link) -> (net index, ordinal on its entry)

    def net_index(spec) -> int:
        for i, (n, hint) in enumerate(nets):
            if spec[0] is n and (spec[1] is hint or (
                    spec[1].shape == hint.shape
                    and torch.equal(spec[1], hint))):
                return i
        return -1

    for e in list(pos_entries) + list(neg_entries) + list(mid_entries):
        counts = {}
        for spec in control_chain(e):
            i = spec_slot[id(spec)][0] if id(spec) in spec_slot \
                else net_index(spec)
            if i < 0:
                nets.append((spec[0], spec[1]))
                net_max_ord.append(0)
                i = len(nets) - 1
            j = counts.get(i, 0)
            counts[i] = j + 1
            spec_slot.setdefault(id(spec), (i, j))
            net_max_ord[i] = max(net_max_ord[i], j + 1)
    if not nets:
        return None

    def entry_spec(e, slot):
        return next((sp for sp in control_chain(e)
                     if spec_slot.get(id(sp)) == slot), None)

    def to_sigma(w_):
        return None if w_ is None else (
            schedule.percent_to_sigma(float(w_[0])),
            schedule.percent_to_sigma(float(w_[1])))

    wire = []
    for i, n in enumerate(net_max_ord):
        for j in range(n):
            net, hint = nets[i]

            def strength(sp):
                return 0.0 if sp is None else float(sp[2])

            def window(sp):
                return None if sp is None or len(sp) <= 3 or sp[3] is None \
                    else to_sigma(sp[3])

            if mid_entries:
                flat = [entry_spec(e, (i, j)) for e in (
                    pos_entries[0], mid_entries[0], neg_entries[0])]
                strengths = tuple(strength(sp) for sp in flat)
                windows = tuple(window(sp) for sp in flat)
                flat_windows = windows
            else:
                specs = ([entry_spec(e, (i, j)) for e in pos_entries],
                         [entry_spec(e, (i, j)) for e in neg_entries])
                strengths = tuple(tuple(strength(sp) for sp in side)
                                  for side in specs)
                windows = tuple(tuple(window(sp) for sp in side)
                                for side in specs)
                flat_windows = windows[0] + windows[1]
            if all(w_ is None for w_ in flat_windows):
                windows = None
            hint = hint.float()
            if hint.shape[1] != h * 8 or hint.shape[2] != w * 8:
                hint = resize_image(hint, w * 8, h * 8, "bilinear")
            wire.append((net, cycle_batch(hint, total), strengths, windows))
    return wire


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
    """Denoise loop over the latent batch (one process, one card).
    ``coalesced_seeds``: the coalescing scheduler's per-prompt seeds, a
    hidden override of a merged run.  ``cb_latent``: a finished
    continuous-batching slot's latent rows (the executor's decode
    tail), returned as they are, so the graph's tail runs unchanged; the
    tail's graph has no upstream links, hence the defaults.  With
    ``OpContext.cb_capture`` set the sampler records its resolved inputs
    there and raises ``CBCapture`` (the bucket build)."""
    TYPE = "KSampler"
    WIDGETS = ["seed", CONTROL, "steps", "cfg", "sampler_name", "scheduler",
               "denoise"]
    DEFAULTS = {"denoise": 1.0}
    HIDDEN = ["coalesced_seeds", "cb_latent"]

    def execute(self, ctx: OpContext, model=None, seed=0, steps=20,
                cfg=8.0, sampler_name="euler", scheduler="normal",
                positive: Conditioning = None,
                negative: Conditioning = None, latent_image=None,
                denoise: float = 1.0, coalesced_seeds=None, cb_latent=None):
        ctx.check_interrupt()
        if ctx.cb_capture is not None:
            ctx.cb_capture.update(
                model=model, seed=seed, steps=steps, cfg=cfg,
                sampler_name=str(sampler_name), scheduler=str(scheduler),
                denoise=denoise, positive=positive, negative=negative,
                latent_image=latent_image)
            raise CBCapture("KSampler inputs captured")
        if cb_latent is not None:
            lat = as_device_array(cb_latent, ctx.device)
            return ({"samples": DeviceLatent(lat),
                     "local_batch": int(lat.shape[0])},)
        if coalesced_seeds is not None and not isinstance(seed, SeedValue):
            seed = SeedValue(int(seed), per_prompt=np.asarray(
                coalesced_seeds, np.uint64))
        model = _maybe_gligen_model(model, positive, negative)
        prep = _prepare_sample_inputs(model, seed, latent_image, positive,
                                      negative)
        with Timer(f"ksampler[{sampler_name}x{steps}]"):
            out = model.sample(
                prep.latents, prep.context, prep.uncond, prep.seeds,
                steps=int(steps), cfg=float(cfg),
                sampler_name=str(sampler_name), scheduler=str(scheduler),
                denoise=float(denoise), y=prep.y,
                sample_idx=prep.sample_idx, noise_mask=prep.noise_mask,
                c_concat=prep.c_concat, control=prep.control,
                middle_context=prep.mid_context, cfg2=prep.cfg2,
                guidance=prep.guidance, gligen_objs=prep.gligen_objs)
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
        model = _maybe_gligen_model(model, positive, negative)
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
                noise_mask=prep.noise_mask, c_concat=prep.c_concat,
                control=prep.control, middle_context=prep.mid_context,
                cfg2=prep.cfg2, guidance=prep.guidance,
                gligen_objs=prep.gligen_objs)
        return ({**_latent_meta(latent_image), "samples": DeviceLatent(out)},)


@dataclasses.dataclass
class SamplerObject:
    """SAMPLER wire value (ComfyUI custom sampling): a sampler's name,
    carried from KSamplerSelect to SamplerCustom."""
    name: str


@register_op
class KSamplerSelect(Op):
    TYPE = "KSamplerSelect"
    WIDGETS = ["sampler_name"]

    def execute(self, ctx: OpContext, sampler_name: str):
        get_sampler(str(sampler_name))    # fail at selection, not sampling
        return (SamplerObject(str(sampler_name)),)


@register_op
class BasicScheduler(Op):
    """-> SIGMAS from the model's own schedule; denoise < 1 keeps the
    final fraction of the steps."""
    TYPE = "BasicScheduler"
    WIDGETS = ["scheduler", "steps", "denoise"]
    DEFAULTS = {"denoise": 1.0}

    def execute(self, ctx: OpContext, model, scheduler: str, steps: int,
                denoise: float = 1.0):
        return (np.asarray(sch.compute_sigmas(
            model.schedule, str(scheduler), int(steps), float(denoise)),
            np.float32),)


@register_op
class KarrasScheduler(Op):
    """-> SIGMAS: the Karras rho-schedule between explicit bounds."""
    TYPE = "KarrasScheduler"
    WIDGETS = ["steps", "sigma_max", "sigma_min", "rho"]
    DEFAULTS = {"sigma_max": 14.614642, "sigma_min": 0.0291675,
                "rho": 7.0}

    def execute(self, ctx: OpContext, steps: int, sigma_max: float,
                sigma_min: float, rho: float = 7.0):
        return (sch.karras_scheduler(None, int(steps), float(rho),
                                     sigma_min=float(sigma_min),
                                     sigma_max=float(sigma_max)),)


@register_op
class ExponentialScheduler(Op):
    """-> SIGMAS: a log-linear ramp between explicit bounds."""
    TYPE = "ExponentialScheduler"
    WIDGETS = ["steps", "sigma_max", "sigma_min"]
    DEFAULTS = {"sigma_max": 14.614642, "sigma_min": 0.0291675}

    def execute(self, ctx: OpContext, steps: int, sigma_max: float,
                sigma_min: float):
        return (sch.polyexponential_sigmas(int(steps), float(sigma_max),
                                           float(sigma_min), rho=1.0),)


@register_op
class PolyexponentialScheduler(Op):
    TYPE = "PolyexponentialScheduler"
    WIDGETS = ["steps", "sigma_max", "sigma_min", "rho"]
    DEFAULTS = {"sigma_max": 14.614642, "sigma_min": 0.0291675,
                "rho": 1.0}

    def execute(self, ctx: OpContext, steps: int, sigma_max: float,
                sigma_min: float, rho: float = 1.0):
        return (sch.polyexponential_sigmas(int(steps), float(sigma_max),
                                           float(sigma_min),
                                           rho=float(rho)),)


@register_op
class VPScheduler(Op):
    TYPE = "VPScheduler"
    WIDGETS = ["steps", "beta_d", "beta_min", "eps_s"]
    DEFAULTS = {"beta_d": 19.9, "beta_min": 0.1, "eps_s": 0.001}

    def execute(self, ctx: OpContext, steps: int, beta_d: float = 19.9,
                beta_min: float = 0.1, eps_s: float = 0.001):
        return (sch.vp_sigmas(int(steps), float(beta_d), float(beta_min),
                              float(eps_s)),)


@register_op
class LaplaceScheduler(Op):
    TYPE = "LaplaceScheduler"
    WIDGETS = ["steps", "sigma_max", "sigma_min", "mu", "beta"]
    DEFAULTS = {"sigma_max": 14.614642, "sigma_min": 0.0291675,
                "mu": 0.0, "beta": 0.5}

    def execute(self, ctx: OpContext, steps: int, sigma_max: float,
                sigma_min: float, mu: float = 0.0, beta: float = 0.5):
        return (sch.laplace_sigmas(int(steps), float(sigma_max),
                                   float(sigma_min), float(mu),
                                   float(beta)),)


@register_op
class BetaSamplingScheduler(Op):
    """-> SIGMAS: beta-distribution spacing over the model's schedule."""
    TYPE = "BetaSamplingScheduler"
    WIDGETS = ["steps", "alpha", "beta"]
    DEFAULTS = {"alpha": 0.6, "beta": 0.6}

    def execute(self, ctx: OpContext, model, steps: int,
                alpha: float = 0.6, beta: float = 0.6):
        return (np.asarray(sch.beta_scheduler(
            model.schedule, int(steps), float(alpha), float(beta)),
            np.float32),)


@register_op
class AlignYourStepsScheduler(Op):
    """-> SIGMAS: NVIDIA's Align-Your-Steps tables (SD1, SDXL, SVD)
    interpolated to the step count; denoise < 1 keeps the last
    ``round(steps * denoise) + 1`` levels, the last set to 0."""
    TYPE = "AlignYourStepsScheduler"
    WIDGETS = ["model_type", "steps", "denoise"]
    DEFAULTS = {"model_type": "SD1", "denoise": 1.0}

    def execute(self, ctx: OpContext, model_type: str, steps: int,
                denoise: float = 1.0):
        d = float(denoise)
        if d <= 0.0:
            return (np.zeros((0,), np.float32),)
        total = round(int(steps) * d) if d < 1.0 else int(steps)
        sig = sch.ays_sigmas(str(model_type), int(steps)).copy()
        sig = sig[-(total + 1):]
        sig[-1] = 0.0
        return (sig,)


@register_op
class SDTurboScheduler(Op):
    """-> SIGMAS for distilled turbo models: the last ``steps`` of the
    model schedule's 100-spaced timesteps."""
    TYPE = "SDTurboScheduler"
    WIDGETS = ["steps", "denoise"]
    DEFAULTS = {"steps": 1, "denoise": 1.0}

    def execute(self, ctx: OpContext, model, steps: int = 1,
                denoise: float = 1.0):
        return (sch.sd_turbo_sigmas(model.schedule, int(steps),
                                    float(denoise)),)


@register_op
class SplitSigmasDenoise(Op):
    """-> (high_sigmas, low_sigmas) split at the denoise fraction: the
    last ``round(steps * denoise)`` steps go low, the split sigma in
    both."""
    TYPE = "SplitSigmasDenoise"
    WIDGETS = ["denoise"]
    DEFAULTS = {"denoise": 1.0}

    def execute(self, ctx: OpContext, sigmas, denoise: float = 1.0):
        s = _sigmas_array(sigmas)
        steps = s.shape[0] - 1
        i = max(steps - round(steps * float(denoise)), 0)
        return (s[:i + 1], s[i:])


@register_op
class SplitSigmas(Op):
    """-> (high_sigmas, low_sigmas) split at ``step`` (two-stage custom
    chains), the split sigma in both."""
    TYPE = "SplitSigmas"
    WIDGETS = ["step"]
    DEFAULTS = {"step": 0}

    def execute(self, ctx: OpContext, sigmas, step: int = 0):
        s = _sigmas_array(sigmas)
        i = min(max(int(step), 0), s.shape[0] - 1)
        return (s[:i + 1], s[i:])


@register_op
class FlipSigmas(Op):
    """-> SIGMAS reversed (unsampling chains); a leading 0 becomes 1e-4
    so the first model call has a usable sigma."""
    TYPE = "FlipSigmas"

    def execute(self, ctx: OpContext, sigmas):
        s = _sigmas_array(sigmas)[::-1].copy()
        if s.shape[0] and s[0] == 0.0:
            s[0] = 1e-4
        return (s,)


def _sigmas_array(sigmas) -> np.ndarray:
    """A SIGMAS value as a host float32 array.  Sigmas stay on the host
    in the port: a tensor raises."""
    if isinstance(sigmas, torch.Tensor):
        raise TypeError("SIGMAS are host float32 arrays in the torch "
                        "package, not tensors")
    return np.asarray(sigmas, np.float32)


def _sampler_name(sampler) -> str:
    return sampler.name if isinstance(sampler, SamplerObject) \
        else str(sampler)


@register_op
class SamplerCustom(Op):
    """ComfyUI's custom-sampling entry: an explicit SAMPLER and SIGMAS in
    place of KSampler's widget pair.  Both latent outputs carry the
    result (no denoised preview stream is kept)."""
    TYPE = "SamplerCustom"
    WIDGETS = ["add_noise", "noise_seed", CONTROL, "cfg"]
    DEFAULTS = {"add_noise": True, "cfg": 8.0}

    def execute(self, ctx: OpContext, model, add_noise, noise_seed, cfg,
                positive: Conditioning, negative: Conditioning,
                latent_image, sampler, sigmas):
        ctx.check_interrupt()
        model = _maybe_gligen_model(model, positive, negative)
        prep = _prepare_sample_inputs(model, noise_seed, latent_image,
                                      positive, negative)
        name = _sampler_name(sampler)
        sig = _sigmas_array(sigmas)
        with Timer(f"sampler_custom[{name}x{len(sig) - 1}]"):
            out = model.sample(
                prep.latents, prep.context, prep.uncond, prep.seeds,
                steps=1, cfg=float(cfg), sampler_name=name,
                scheduler="normal", y=prep.y,
                add_noise=str(add_noise).lower()
                not in ("disable", "false", "0"),
                sample_idx=prep.sample_idx, noise_mask=prep.noise_mask,
                c_concat=prep.c_concat, control=prep.control,
                sigmas_override=sig, middle_context=prep.mid_context,
                cfg2=prep.cfg2, guidance=prep.guidance,
                gligen_objs=prep.gligen_objs)
        out_d = {**_latent_meta(latent_image), "samples": DeviceLatent(out)}
        return (out_d, dict(out_d))


@dataclasses.dataclass
class NoiseObject:
    """NOISE wire value (ComfyUI custom sampling): the initial-noise
    policy from RandomNoise or DisableNoise.  ``seed`` may be a
    SeedValue, whose DistributedSeed offsets and coalesced seeds ride
    through."""
    seed: Any = 0
    disable: bool = False


@dataclasses.dataclass
class GuiderObject:
    """GUIDER wire value (ComfyUI custom sampling): the model, the
    conditionings and the combine, from BasicGuider, CFGGuider,
    DualCFGGuider or PerpNegGuider."""
    model: Any
    positive: Conditioning
    negative: Optional[Conditioning] = None
    middle: Optional[Conditioning] = None
    cfg: float = 1.0
    cfg2: float = 1.0
    mode: str = "cfg"          # "basic" | "cfg" | "dual" | "perp"


@register_op
class RandomNoise(Op):
    """-> NOISE seeded as KSampler's widget is; a DistributedSeed value
    keeps its per-replica offsets."""
    TYPE = "RandomNoise"
    WIDGETS = ["noise_seed", CONTROL]

    def execute(self, ctx: OpContext, noise_seed):
        return (NoiseObject(seed=noise_seed),)


@register_op
class DisableNoise(Op):
    """-> NOISE that adds nothing (a later stage whose latent already
    carries its noise)."""
    TYPE = "DisableNoise"

    def execute(self, ctx: OpContext):
        return (NoiseObject(seed=0, disable=True),)


@register_op
class BasicGuider(Op):
    """-> GUIDER: the conditioning alone, no CFG combine (cfg 1: the
    uncond rows are never evaluated)."""
    TYPE = "BasicGuider"

    def execute(self, ctx: OpContext, model, conditioning: Conditioning):
        return (GuiderObject(model=model, positive=conditioning,
                             mode="basic"),)


@register_op
class CFGGuider(Op):
    """-> GUIDER: the positive/negative CFG combine at ``cfg``."""
    TYPE = "CFGGuider"
    WIDGETS = ["cfg"]
    DEFAULTS = {"cfg": 8.0}

    def execute(self, ctx: OpContext, model, positive: Conditioning,
                negative: Conditioning, cfg: float = 8.0):
        return (GuiderObject(model=model, positive=positive,
                             negative=negative, cfg=float(cfg),
                             mode="cfg"),)


@register_op
class DualCFGGuider(Op):
    """-> GUIDER with two positives (the InstructPix2Pix combine): cond2
    CFG'd against the negative at ``cfg_cond2_negative``, then cond1
    against cond2 at ``cfg_conds`` (``samplers.cfg_denoiser_dual``)."""
    TYPE = "DualCFGGuider"
    WIDGETS = ["cfg_conds", "cfg_cond2_negative"]
    DEFAULTS = {"cfg_conds": 8.0, "cfg_cond2_negative": 8.0}

    def execute(self, ctx: OpContext, model, cond1: Conditioning,
                cond2: Conditioning, negative: Conditioning,
                cfg_conds: float = 8.0, cfg_cond2_negative: float = 8.0):
        return (GuiderObject(model=model, positive=cond1, middle=cond2,
                             negative=negative, cfg=float(cfg_conds),
                             cfg2=float(cfg_cond2_negative), mode="dual"),)


@register_op
class PerpNegGuider(Op):
    """-> GUIDER: Perp-Neg with an explicit empty conditioning, CFG at
    ``cfg`` and the perpendicular negative at ``neg_scale``
    (``samplers.cfg_denoiser_perp_neg``)."""
    TYPE = "PerpNegGuider"
    WIDGETS = ["cfg", "neg_scale"]
    DEFAULTS = {"cfg": 8.0, "neg_scale": 1.0}

    def execute(self, ctx: OpContext, model, positive: Conditioning,
                negative: Conditioning, empty_conditioning: Conditioning,
                cfg: float = 8.0, neg_scale: float = 1.0):
        return (GuiderObject(model=model, positive=positive,
                             negative=negative,
                             middle=empty_conditioning, cfg=float(cfg),
                             cfg2=float(neg_scale), mode="perp"),)


def _plain_entry(e: Conditioning) -> bool:
    return (not e.siblings and e.area_mask is None
            and e.timestep_range is None and float(e.area_strength) == 1.0)


@register_op
class SamplerCustomAdvanced(Op):
    """ComfyUI's modular sampling entry: NOISE, GUIDER, SAMPLER and
    SIGMAS.  The guider picks the combine: basic (cfg 1), cfg, dual or
    Perp-Neg; a PerpNeg-patched model under a plain guider keeps its
    patch.  Both latent outputs carry the result."""
    TYPE = "SamplerCustomAdvanced"

    def execute(self, ctx: OpContext, noise: NoiseObject,
                guider: GuiderObject, sampler, sigmas, latent_image):
        ctx.check_interrupt()
        g = guider
        neg = g.negative if g.negative is not None else g.positive
        g = dataclasses.replace(g, model=_maybe_gligen_model(
            g.model, g.positive, neg, g.middle))
        three_row = g.mode in ("dual", "perp")
        if three_row and not all(
                _plain_entry(e) for e in (g.positive, g.middle, neg)):
            raise ValueError(f"{g.mode} guidance does not compose with "
                             "regional multi-entry conditionings")
        prep = _prepare_sample_inputs(
            g.model, noise.seed, latent_image, g.positive, neg,
            middle=g.middle if three_row else None)
        if three_row:
            guidance = "perp_neg" if g.mode == "perp" else "dual"
            cfg2 = float(g.cfg2)
        else:
            guidance, cfg2 = prep.guidance, prep.cfg2
        cfg = 1.0 if g.mode == "basic" else float(g.cfg)
        name = _sampler_name(sampler)
        sig = _sigmas_array(sigmas)
        with Timer(f"sampler_custom_adv[{g.mode}:{name}x{len(sig) - 1}]"):
            out = g.model.sample(
                prep.latents, prep.context, prep.uncond, prep.seeds,
                steps=1, cfg=cfg, sampler_name=name, scheduler="normal",
                y=prep.y, add_noise=not noise.disable,
                sample_idx=prep.sample_idx, noise_mask=prep.noise_mask,
                c_concat=prep.c_concat, control=prep.control,
                sigmas_override=sig, middle_context=prep.mid_context,
                cfg2=cfg2, guidance=guidance, gligen_objs=prep.gligen_objs)
        out_d = {**_latent_meta(latent_image), "samples": DeviceLatent(out)}
        return (out_d, dict(out_d))


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
class VAEDecodeTiled(Op):
    """Decode in overlapping latent tiles, feather-blended
    (``DiffusionPipeline.vae_decode_tiled``), stopping between tiles once
    the prompt is interrupted."""
    TYPE = "VAEDecodeTiled"
    WIDGETS = ["tile_size", "overlap"]
    DEFAULTS = {"tile_size": 512, "overlap": 64}

    def execute(self, ctx: OpContext, samples, vae, tile_size: int = 512,
                overlap: int = 64):
        ctx.check_interrupt()
        with Timer("vae_decode_tiled"):
            img = vae.vae_decode_tiled(
                as_device_array(samples["samples"], vae.device),
                tile_size=int(tile_size), overlap=int(overlap),
                check_interrupt=ctx.check_interrupt)
        return (DeviceImage(img.clamp(0.0, 1.0)),)


@register_op
class VAEEncodeTiled(Op):
    """Encode in overlapping pixel tiles, feather-blended at latent
    resolution (``DiffusionPipeline.vae_encode_tiled``); no encode memo,
    as in the JAX package."""
    TYPE = "VAEEncodeTiled"
    WIDGETS = ["tile_size", "overlap"]
    DEFAULTS = {"tile_size": 512, "overlap": 64}

    def execute(self, ctx: OpContext, pixels, vae, tile_size: int = 512,
                overlap: int = 64):
        ctx.check_interrupt()
        with Timer("vae_encode_tiled"):
            lat = vae.vae_encode_tiled(
                as_device_image(pixels, vae.device),
                tile_size=int(tile_size), overlap=int(overlap),
                check_interrupt=ctx.check_interrupt)
        return ({"samples": DeviceLatent(lat)},)


@register_op
class VAEEncode(Op):
    """Pixels -> latent through the pipeline's encoder (the mean)."""
    TYPE = "VAEEncode"

    def execute(self, ctx: OpContext, pixels, vae):
        # the encoded latent is memoised on the device by its input
        # sub-graph; no op writes into a latent, so the entry is shared
        key, hit = _embed_cache_get(ctx, "vaeenc", vae)
        if hit is not None:
            return ({"samples": DeviceLatent(hit)},)
        with Timer("vae_encode"):
            lat = vae.vae_encode(as_device_image(pixels, vae.device))
        _embed_cache_put(key, lat, reuse_mod.nbytes_of(lat))
        return ({"samples": DeviceLatent(lat)},)


def _truthy(v) -> bool:
    """A BOOLEAN widget as the JAX ops read it (the strings "false" and
    "0", and "", are false)."""
    return str(v).lower() not in ("false", "0", "")


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
        if _truthy(noise_mask):
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
    """-> (IMAGE, MASK).  Reads a PNG of any kind from ``ctx.input_dir``
    (or an absolute path) as ``pil_to_tensor`` does (:func:`decode_png`);
    a missing file gives the JAX package's gradient test card.  A file
    that reads as RGBA has the mask 1 - alpha, any other zeros."""
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
    name) alpha, which inverts (transparent = 1 = resample).  The file
    reads as PIL's ``convert("RGBA")`` gives it (grey-alpha and a
    palette's or a colour's tRNS keep their alpha, other kinds have
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
                arr = decode_png_rgba(f.read())
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


# --- ControlNet and the UNet's structural patches ------------------------------

@register_op
class ControlNetLoader(Op):
    """-> CONTROL_NET; a file of that name in ``ctx.models_dir`` is
    loaded (its family from its cross-attention width), else the net is
    virtual, its zero projections at zero so it leaves the UNet exactly
    as it is (``registry.load_controlnet``)."""
    TYPE = "ControlNetLoader"
    WIDGETS = ["control_net_name"]

    def execute(self, ctx: OpContext, control_net_name: str):
        return (registry.load_controlnet(str(control_net_name),
                                         models_dir=ctx.models_dir,
                                         device=ctx.device),)


@register_op
class DiffControlNetLoader(Op):
    """'Difference' ControlNet: the file's weights are deltas over the
    model's encoder, so each leaf the model's UNet has at the same path
    and shape is added on (``registry.load_diff_controlnet``, cached per
    model)."""
    TYPE = "DiffControlNetLoader"
    WIDGETS = ["control_net_name"]

    def execute(self, ctx: OpContext, model, control_net_name: str):
        return (registry.load_diff_controlnet(model, str(control_net_name),
                                              models_dir=ctx.models_dir),)


def _attach_control(cond: Conditioning, link) -> Conditioning:
    """``link`` chained onto the conditioning and every sibling (ComfyUI
    loops the entries): a second apply adds a link, it replaces none."""
    return dataclasses.replace(
        cond, control=control_chain(cond) + (link,),
        siblings=tuple(dataclasses.replace(
            s, control=control_chain(s) + (link,)) for s in cond.siblings))


@register_op
class ControlNetApply(Op):
    """A ControlNet and its hint image attached to a conditioning at a
    strength: it steers only the rows of the entries that carry it.
    Strength 0 returns the conditioning as it is."""
    TYPE = "ControlNetApply"
    WIDGETS = ["strength"]
    DEFAULTS = {"strength": 1.0}

    def execute(self, ctx: OpContext, conditioning: Conditioning,
                control_net, image, strength: float = 1.0):
        if float(strength) == 0.0:
            return (conditioning,)
        link = (control_net, as_device_image(image, ctx.device),
                float(strength))
        return (_attach_control(conditioning, link),)


@register_op
class ControlNetApplyAdvanced(Op):
    """ControlNetApply on both CFG sides with a sampling-percent window:
    the residuals count only while start_percent <= progress <=
    end_percent (a sigma gate in the denoiser)."""
    TYPE = "ControlNetApplyAdvanced"
    WIDGETS = ["strength", "start_percent", "end_percent"]
    DEFAULTS = {"strength": 1.0, "start_percent": 0.0, "end_percent": 1.0}

    def execute(self, ctx: OpContext, positive: Conditioning,
                negative: Conditioning, control_net, image,
                strength: float = 1.0, start_percent: float = 0.0,
                end_percent: float = 1.0):
        if float(strength) == 0.0:
            return (positive, negative)
        link = (control_net, as_device_image(image, ctx.device),
                float(strength), (float(start_percent), float(end_percent)))
        return (_attach_control(positive, link),
                _attach_control(negative, link))


def _freeu_pipeline(model, version: int, b1, b2, s1, s2):
    """MODEL -> a derived pipeline whose UNet config carries FreeU; the
    weights are the base's."""
    fam = model.family
    fam2 = dataclasses.replace(fam, unet=dataclasses.replace(
        fam.unet, freeu=(float(b1), float(b2), float(s1), float(s2)),
        freeu_version=int(version)))
    return registry.derive_pipeline(
        model, f"freeu{version}:{b1}:{b2}:{s1}:{s2}", family=fam2)


@register_op
class RescaleCFG(Op):
    """RescaleCFG: the CFG combine re-stded toward the cond prediction's
    v-space statistics, blended by ``multiplier`` (the high-CFG
    over-saturation fix).  A derived pipeline; the patch rides further
    derivations."""
    TYPE = "RescaleCFG"
    WIDGETS = ["multiplier"]
    DEFAULTS = {"multiplier": 0.7}

    def execute(self, ctx: OpContext, model, multiplier: float = 0.7):
        m = float(multiplier)
        if m == 0.0:
            return (model,)
        return (registry.derive_pipeline(model, f"rescale:{m}",
                                         cfg_rescale=m),)


# --- weight-space merges -----------------------------------------------------

@torch.no_grad()
def _merge_modules(m1, m2, fn) -> dict:
    """``fn(name, a, b)`` over the same-named parameters of two modules
    of one structure, in fp32 and cast back to ``m1``'s dtype, one tensor
    at a time on ``m1``'s device: the merge holds one model's new
    weights, never fp32 copies of whole models."""
    p1, p2 = dict(m1.named_parameters()), dict(m2.named_parameters())
    if set(p1) != set(p2):
        raise ValueError(f"merge: parameter names differ (e.g. "
                         f"{sorted(set(p1) ^ set(p2))[:3]})")
    return {name: fn(name, a.float(), p2[name].to(a.device).float())
            .to(a.dtype) for name, a in p1.items()}


def _merge_lerp(ratio_of):
    """``a * r + b * (1 - r)``, r from the parameter's name: the JAX
    package's ``_merge_trees`` in its order of operations."""
    def fn(name, a, b):
        r = float(ratio_of(name))
        return a * r + b * (1.0 - r)
    return fn


def _same_unet(op: str, model1, model2, families: bool = True) -> None:
    if model1.family.unet != model2.family.unet:
        raise ValueError(f"{op}: UNet configs differ"
                         + (f" ({model1.family.name} vs "
                            f"{model2.family.name})" if families else ""))


def _merged_model(model1, model2, tag: str, fn):
    """The cached clone of ``model1`` under ``tag``, its UNet ``fn`` of
    the two (a second merge of the same pair computes nothing)."""
    cached = registry.derived_cached(model1, tag)
    if cached is not None:
        return (cached,)
    merged = _merge_modules(model1.unet, model2.unet, fn)
    return (registry.derive_pipeline(model1, tag, unet_params=merged),)


def _merged_clip(op: str, clip1, clip2, tag: str, fn):
    if len(clip1.clip_models) != len(clip2.clip_models):
        raise ValueError(f"{op}: tower counts differ")
    cached = registry.derived_cached(clip1, tag)
    if cached is not None:
        return (cached,)
    merged = [_merge_modules(a, b, fn)
              for a, b in zip(clip1.clip_models, clip2.clip_models)]
    return (registry.derive_pipeline(clip1, tag, clip_params=merged),)


@register_op
class ModelMergeSimple(Op):
    """Weight-space lerp of two same-family UNets: ``model1 * ratio +
    model2 * (1 - ratio)``."""
    TYPE = "ModelMergeSimple"
    WIDGETS = ["ratio"]
    DEFAULTS = {"ratio": 1.0}

    def execute(self, ctx: OpContext, model1, model2, ratio: float = 1.0):
        _same_unet(self.TYPE, model1, model2)
        r = float(ratio)
        return _merged_model(model1, model2,
                             f"merge:{model2.cache_token}:{r}",
                             _merge_lerp(lambda _k: r))


@register_op
class ModelMergeAdd(Op):
    """Weight-space sum ``model1 + model2`` (the add-difference
    workflow's second half)."""
    TYPE = "ModelMergeAdd"

    def execute(self, ctx: OpContext, model1, model2):
        _same_unet(self.TYPE, model1, model2)
        return _merged_model(model1, model2,
                             f"merge_add:{model2.cache_token}",
                             lambda _k, a, b: a + b)


@register_op
class ModelMergeSubtract(Op):
    """Weight-space difference ``model1 - multiplier * model2`` (the
    add-difference workflow's delta)."""
    TYPE = "ModelMergeSubtract"
    WIDGETS = ["multiplier"]
    DEFAULTS = {"multiplier": 1.0}

    def execute(self, ctx: OpContext, model1, model2,
                multiplier: float = 1.0):
        _same_unet(self.TYPE, model1, model2)
        m = float(multiplier)
        return _merged_model(model1, model2,
                             f"merge_sub:{model2.cache_token}:{m}",
                             lambda _k, a, b: a - m * b)


def merge_block_section(name: str) -> str:
    """ModelMergeBlocks' section of a UNet parameter, by the first
    component of its name (a ResBlock's inner ``out_norm`` is not the
    head): the middle block is ``middle``; the decoder and the output
    head are ``out``; the encoder, ``conv_in`` and the time and label
    embeddings are ``input``."""
    top = name.split(".", 1)[0]
    if top.startswith("mid_"):
        return "middle"
    if top.startswith("up_") or top in ("out_norm", "conv_out"):
        return "out"
    return "input"


@register_op
class ModelMergeBlocks(Op):
    """Per-section merge ratios (:func:`merge_block_section`)."""
    TYPE = "ModelMergeBlocks"
    WIDGETS = ["input", "middle", "out"]
    DEFAULTS = {"input": 1.0, "middle": 1.0, "out": 1.0}

    def execute(self, ctx: OpContext, model1, model2, input: float = 1.0,
                middle: float = 1.0, out: float = 1.0):
        _same_unet(self.TYPE, model1, model2, families=False)
        ratios = {"input": float(input), "middle": float(middle),
                  "out": float(out)}
        return _merged_model(
            model1, model2,
            f"mergeb:{model2.cache_token}:{input}:{middle}:{out}",
            _merge_lerp(lambda k: ratios[merge_block_section(k)]))


@register_op
class CLIPMergeSimple(Op):
    """Weight-space lerp of two CLIPs' text towers, tower by tower."""
    TYPE = "CLIPMergeSimple"
    WIDGETS = ["ratio"]
    DEFAULTS = {"ratio": 1.0}

    def execute(self, ctx: OpContext, clip1, clip2, ratio: float = 1.0):
        r = float(ratio)
        return _merged_clip(self.TYPE, clip1, clip2,
                            f"clipmerge:{clip2.cache_token}:{r}",
                            _merge_lerp(lambda _k: r))


@register_op
class CLIPMergeAdd(Op):
    """Weight-space sum of two CLIPs' text towers."""
    TYPE = "CLIPMergeAdd"

    def execute(self, ctx: OpContext, clip1, clip2):
        return _merged_clip(self.TYPE, clip1, clip2,
                            f"clipmerge_add:{clip2.cache_token}",
                            lambda _k, a, b: a + b)


@register_op
class CLIPMergeSubtract(Op):
    """Weight-space difference ``clip1 - multiplier * clip2``."""
    TYPE = "CLIPMergeSubtract"
    WIDGETS = ["multiplier"]
    DEFAULTS = {"multiplier": 1.0}

    def execute(self, ctx: OpContext, clip1, clip2,
                multiplier: float = 1.0):
        m = float(multiplier)
        return _merged_clip(self.TYPE, clip1, clip2,
                            f"clipmerge_sub:{clip2.cache_token}:{m}",
                            lambda _k, a, b: a - m * b)


@register_op
class ModelSamplingDiscrete(Op):
    """ComfyUI's ModelSamplingDiscrete: how the model's output reads
    (eps, v_prediction, x0; lcm as eps) and, with ``zsnr``, the schedule
    rescaled to zero terminal SNR.  A derived pipeline; the patch rides
    further derivations."""
    TYPE = "ModelSamplingDiscrete"
    WIDGETS = ["sampling", "zsnr"]
    DEFAULTS = {"sampling": "eps", "zsnr": False}

    _MAP = {"eps": "eps", "v_prediction": "v", "x0": "x0", "lcm": "eps"}

    def execute(self, ctx: OpContext, model, sampling: str = "eps",
                zsnr=False):
        s = str(sampling)
        if s not in self._MAP:
            raise ValueError(f"unknown sampling {s!r}; "
                             f"available: {tuple(self._MAP)}")
        if s == "lcm":
            debug_log("ModelSamplingDiscrete: 'lcm' timestep scaling is "
                      "not modeled; treating as eps (use the lcm "
                      "sampler for LCM checkpoints)")
        z = str(zsnr).lower() not in ("false", "0", "")
        schedule = sch.rescale_zero_terminal_snr(model.schedule) if z \
            else None
        return (registry.derive_pipeline(
            model, f"msd:{s}:{int(z)}", prediction_type=self._MAP[s],
            schedule=schedule),)


@register_op
class SelfAttentionGuidance(Op):
    """SAG (Hong et al.): blur what the model attends to, denoise the
    degraded latent once more and steer away from it.  A derived
    pipeline whose UNet config captures the middle block's attention
    (``sag_capture``); three UNet rows a step."""
    TYPE = "SelfAttentionGuidance"
    WIDGETS = ["scale", "blur_sigma"]
    DEFAULTS = {"scale": 0.5, "blur_sigma": 2.0}

    def execute(self, ctx: OpContext, model, scale: float = 0.5,
                blur_sigma: float = 2.0):
        fam = model.family
        fam2 = dataclasses.replace(fam, unet=dataclasses.replace(
            fam.unet, sag_capture=True))
        return (registry.derive_pipeline(
            model, f"sag:{float(scale)}:{float(blur_sigma)}", family=fam2,
            extra_attrs={"sag_params": (float(scale),
                                        float(blur_sigma))}),)


@register_op
class PerpNeg(Op):
    """ComfyUI's PerpNeg patch: sampling evaluates a third, empty
    conditioning and subtracts only the negative's component
    perpendicular to the positive (``samplers.cfg_denoiser_perp_neg``).
    A derived pipeline, cached per scale and empty conditioning (a crc32
    of its context and pooled bytes); it rides further derivations."""
    TYPE = "PerpNeg"
    WIDGETS = ["neg_scale"]
    DEFAULTS = {"neg_scale": 1.0}

    def execute(self, ctx: OpContext, model,
                empty_conditioning: Conditioning, neg_scale: float = 1.0):
        e = empty_conditioning
        sig = zlib.crc32(_f32_bytes(e.context))
        if e.pooled is not None:
            sig = zlib.crc32(_f32_bytes(e.pooled), sig)
        return (registry.derive_pipeline(
            model, f"perpneg:{float(neg_scale)}:{sig:08x}",
            extra_attrs={"perp_neg_cond": empty_conditioning,
                         "perp_neg_scale": float(neg_scale)}),)


def _f32_bytes(t) -> bytes:
    """A tensor's (or array's) float32 bytes on the host."""
    if isinstance(t, torch.Tensor):
        t = t.detach().float().cpu().numpy()
    return np.ascontiguousarray(np.asarray(t, np.float32)).tobytes()


@register_op
class FreeU(Op):
    """FreeU (Si et al.): the decoder's backbone boost and skip low-pass,
    no weight change."""
    TYPE = "FreeU"
    WIDGETS = ["b1", "b2", "s1", "s2"]
    DEFAULTS = {"b1": 1.1, "b2": 1.2, "s1": 0.9, "s2": 0.2}

    def execute(self, ctx: OpContext, model, b1: float = 1.1,
                b2: float = 1.2, s1: float = 0.9, s2: float = 0.2):
        return (_freeu_pipeline(model, 1, b1, b2, s1, s2),)


@register_op
class FreeU_V2(Op):
    """FreeU v2: the backbone boost scales with the per-pixel normalized
    hidden mean."""
    TYPE = "FreeU_V2"
    WIDGETS = ["b1", "b2", "s1", "s2"]
    DEFAULTS = {"b1": 1.3, "b2": 1.4, "s1": 0.9, "s2": 0.2}

    def execute(self, ctx: OpContext, model, b1: float = 1.3,
                b2: float = 1.4, s1: float = 0.9, s2: float = 0.2):
        return (_freeu_pipeline(model, 2, b1, b2, s1, s2),)


@register_op
class HyperTile(Op):
    """HyperTile: the self-attention of the levels up to ``max_depth``
    tiled spatially, its tiles riding the batch axis.  The tiling is the
    JAX package's deterministic one (the largest divisor with tiles of
    at least tile_size // 8 latent units), so ``swap_size`` is accepted
    and has no effect."""
    TYPE = "HyperTile"
    WIDGETS = ["tile_size", "swap_size", "max_depth", "scale_depth"]
    DEFAULTS = {"tile_size": 256, "swap_size": 2, "max_depth": 0,
                "scale_depth": False}

    def execute(self, ctx: OpContext, model, tile_size: int = 256,
                swap_size: int = 2, max_depth: int = 0,
                scale_depth=False):
        if int(swap_size) != 2:
            debug_log("HyperTile: swap_size has no effect (deterministic "
                      "static tiling)")
        sd = str(scale_depth).lower() not in ("false", "0", "")
        fam = model.family
        fam2 = dataclasses.replace(fam, unet=dataclasses.replace(
            fam.unet, hypertile=(int(tile_size), int(max_depth), sd)))
        return (registry.derive_pipeline(
            model, f"hypertile:{tile_size}:{max_depth}:{int(sd)}",
            family=fam2),)


@register_op
class PatchModelAddDownscale(Op):
    """Kohya's deep shrink: early in sampling (the sigma window from
    start_percent to end_percent) the UNet downscales its hidden at the
    given input block and upsamples at the first skip of another size.
    The block maps to a UNet level (blocks 1..num_res_blocks are level 0,
    a level's trailing downsample belongs to the next); the window
    becomes timesteps on the model's schedule.  Both resizes are
    bilinear, so the two method widgets have no effect, as in the JAX
    package."""
    TYPE = "PatchModelAddDownscale"
    WIDGETS = ["block_number", "downscale_factor", "start_percent",
               "end_percent", "downscale_after_skip",
               "downscale_method", "upscale_method"]
    DEFAULTS = {"block_number": 3, "downscale_factor": 2.0,
                "start_percent": 0.0, "end_percent": 0.35,
                "downscale_after_skip": True,
                "downscale_method": "bicubic",
                "upscale_method": "bicubic"}

    def execute(self, ctx: OpContext, model, block_number: int = 3,
                downscale_factor: float = 2.0,
                start_percent: float = 0.0, end_percent: float = 0.35,
                downscale_after_skip=True,
                downscale_method: str = "bicubic",
                upscale_method: str = "bicubic"):
        ucfg = model.family.unet
        nrb = int(ucfg.num_res_blocks)
        b = max(int(block_number), 1)
        lvl = (b - 1) // (nrb + 1)
        if (b - 1) % (nrb + 1) == nrb:
            lvl += 1
        lvl = min(lvl, ucfg.num_levels - 1)
        sched = model.schedule
        s_hi = sched.percent_to_sigma(float(start_percent))
        s_lo = sched.percent_to_sigma(float(end_percent))
        t_hi = float(np.asarray(sched.t_from_sigma(
            np.asarray([s_hi], np.float32)))[0]) + 1e-3
        t_lo = float(np.asarray(sched.t_from_sigma(
            np.asarray([s_lo], np.float32)))[0])
        return (registry.derive_pipeline(
            model, f"deepshrink:{lvl}:{float(downscale_factor)}"
                   f":{start_percent}:{end_percent}",
            extra_attrs={"deep_shrink_spec": (
                float(lvl), float(downscale_factor), t_lo, t_hi)}),)


# --- ToMe, hypernetworks, GLIGEN and style models --------------------------------

@register_op
class TomePatchModel(Op):
    """ToMe token merging at the highest-resolution attention level
    (level 0, the reference's max_downsample=1): its self-attentions
    merge ``ratio`` (clipped to [0, 0.9]) of their query tokens into
    their most similar 2x2-cell destinations and copy the outputs back
    (``models/tome.py``; the destination grid is deterministic).  A
    family without level-0 attention (SDXL) gets a logged no-op, and
    ratio 0 the model itself.  A derived pipeline sharing the base's
    weights."""
    TYPE = "TomePatchModel"
    WIDGETS = ["ratio"]
    DEFAULTS = {"ratio": 0.3}

    def execute(self, ctx: OpContext, model, ratio: float = 0.3):
        r = min(max(float(ratio), 0.0), 0.9)
        if r == 0.0:
            return (model,)
        fam = model.family
        if fam.unet.transformer_depth[0] == 0:
            log(f"TomePatchModel: {fam.name} has no level-0 attention "
                "(SDXL layout); the patch is a no-op, as with the "
                "reference's default max_downsample=1")
            return (model,)
        fam2 = dataclasses.replace(fam, unet=dataclasses.replace(
            fam.unet, tome_ratio=r))
        return (registry.derive_pipeline(model, f"tome:{r}", family=fam2),)


@register_op
class HypernetworkLoader(Op):
    """An A1111 hypernetwork (``<models_dir>/hypernetworks/<name>``, or
    the JAX package's virtual one of the name): residual MLPs on the
    cross-attentions' key and value context at ``strength``
    (``models/hypernetwork.py``).  Chained loaders compose; strength 0
    returns the model.  A derived pipeline; the chain rides further
    derivations."""
    TYPE = "HypernetworkLoader"
    WIDGETS = ["hypernetwork_name", "strength"]
    DEFAULTS = {"strength": 1.0}

    def execute(self, ctx: OpContext, model, hypernetwork_name: str,
                strength: float = 1.0):
        from comfyui_distributed_tpu_torch.models.hypernetwork import \
            load_hypernetwork
        s = float(strength)
        if s == 0.0:
            return (model,)
        hn = load_hypernetwork(str(hypernetwork_name),
                               models_dir=ctx.models_dir)
        chain = tuple(getattr(model, "hypernets", ())) + ((hn, s),)
        # the tag names the chain's content (name and directory), never an
        # object's id, which a cache clear could hand to another
        chain_tag = (getattr(model, "hypernet_tag", "")
                     + f"|{hypernetwork_name}@{ctx.models_dir or ''}x{s}")
        return (registry.derive_pipeline(
            model, "hypernet:" + chain_tag,
            extra_attrs={"hypernets": chain, "hypernet_tag": chain_tag}),)


@register_op
class GLIGENLoader(Op):
    """-> GLIGEN: the position net (``models/gligen.py``, virtual from the
    name).  The fusers join the model when a grounded conditioning
    reaches a sampler (:func:`gligen_attach`)."""
    TYPE = "GLIGENLoader"
    WIDGETS = ["gligen_name"]

    def execute(self, ctx: OpContext, gligen_name: str):
        from comfyui_distributed_tpu_torch.models.gligen import load_gligen
        return (load_gligen(str(gligen_name), models_dir=ctx.models_dir,
                            device=ctx.device),)


def gligen_attach(model, gligen):
    """The derived pipeline with GLIGEN fusers: a UNet built with them
    that shares every parameter of ``model``'s UNet by reference and
    fills only the fusers, with the JAX package's virtual draws for the
    missing leaves (seed of ``gligen:<name>``), so the base's weights
    stay as they were.  The fusers' gates are 0 by that rule."""
    from comfyui_distributed_tpu_torch.models import unet as unet_mod
    from comfyui_distributed_tpu_torch.models.weights import fill_virtual
    tag = f"gligen:{gligen.name}"
    fam = model.family
    fam2 = dataclasses.replace(fam, unet=dataclasses.replace(
        fam.unet, gligen=int(gligen.cfg.out_dim)))

    def make():
        base = dict(model.unet.named_parameters())
        dt = next(iter(base.values())).dtype
        with torch.device("meta"):
            unet = unet_mod.UNet(fam2.unet)
        for mname, mod in unet.named_modules():
            for pname, p in list(mod._parameters.items()):
                if p is None:
                    continue
                full = f"{mname}.{pname}" if mname else pname
                mod._parameters[pname] = base[full] if full in base \
                    else torch.nn.Parameter(torch.empty(
                        p.shape, dtype=dt, device=model.device),
                        requires_grad=False)
        with torch.no_grad():
            fill_virtual(unet, registry._name_seed(tag), root="params",
                         only=lambda leaf: leaf.name not in base)
        return unet.eval()

    return registry.derive_pipeline(model, tag, family=fam2, unet=make)


@register_op
class GLIGENTextBoxApply(Op):
    """Ground a phrase to a box: the phrase's pooled encoding (its
    tokens' mean without one), cut or zero-padded to the model's text
    width, and the box in latent units (x // 8, y // 8, w // 8, h // 8,
    at least 1) join the entry's grounding, on every sibling too (each
    keeps its own earlier boxes).  The sampler grafts the fusers in."""
    TYPE = "GLIGENTextBoxApply"
    WIDGETS = ["text", "width", "height", "x", "y"]

    def execute(self, ctx: OpContext, conditioning_to: Conditioning, clip,
                gligen_textbox_model, text: str, width: int, height: int,
                x: int, y: int):
        g = gligen_textbox_model
        ctx_arr, pooled = clip.encode_prompt([str(text)])
        emb = (pooled if pooled is not None else ctx_arr.mean(dim=1)) \
            .detach().float().cpu().numpy()
        if emb.shape[-1] < g.cfg.text_dim:
            emb = np.pad(emb, ((0, 0), (0, g.cfg.text_dim - emb.shape[-1])))
        emb = emb[:, : g.cfg.text_dim]
        box = (int(x) // 8, int(y) // 8, max(int(width) // 8, 1),
               max(int(height) // 8, 1))

        def ground(e: Conditioning) -> Conditioning:
            prev = e.gligen[1] if e.gligen is not None else ()
            return dataclasses.replace(e, gligen=(g, prev + ((emb, box),)))

        return (dataclasses.replace(
            ground(conditioning_to),
            siblings=tuple(ground(s) for s in conditioning_to.siblings)),)


@register_op
class StyleModelLoader(Op):
    """-> STYLE_MODEL (``models/style_model.py``, virtual from the
    name)."""
    TYPE = "StyleModelLoader"
    WIDGETS = ["style_model_name"]

    def execute(self, ctx: OpContext, style_model_name: str):
        from comfyui_distributed_tpu_torch.models.style_model import \
            load_style_model
        return (load_style_model(str(style_model_name),
                                 models_dir=ctx.models_dir,
                                 device=ctx.device),)


@register_op
class StyleModelApply(Op):
    """The style tokens of a CLIP-vision output appended to the
    conditioning's token axis (every sibling too): the style steers
    through the ordinary cross-attention."""
    TYPE = "StyleModelApply"

    def execute(self, ctx: OpContext, conditioning: Conditioning,
                style_model, clip_vision_output):
        with Timer("style_model_apply"):
            tokens = style_model.get_cond(clip_vision_output)

        def cat(e: Conditioning) -> Conditioning:
            return dataclasses.replace(e, context=torch.cat(
                [e.context, tokens.to(e.context.device, torch.float32)],
                dim=1))

        return (dataclasses.replace(
            cat(conditioning),
            siblings=tuple(cat(s) for s in conditioning.siblings)),)


# --- Canny (the ControlNet hint preprocessor) ---------------------------------

def _accumulate(terms) -> torch.Tensor:
    """``sum(terms)`` in the given order from a zero start, as the JAX
    package's numpy sums run (the signed zeros come out alike)."""
    acc = None
    for t in terms:
        acc = torch.zeros_like(t) + t if acc is None else acc + t
    return acc


def _pad_index(n: int, before: int, after: int, mode: str,
               device) -> torch.Tensor:
    """Source index of each position of an axis of ``n`` padded by
    ``before`` and ``after``: numpy's "reflect" (mirrored about the edge
    sample) or "symmetric" (the edge sample repeated, scipy.ndimage's
    "reflect"), for pads of any length."""
    i = np.arange(-before, n + after)
    if mode == "symmetric":
        i = np.mod(i, 2 * n)
        i = np.where(i >= n, 2 * n - 1 - i, i)
    elif n == 1:
        i = np.zeros_like(i)
    else:
        i = np.mod(i, 2 * (n - 1))
        i = np.where(i >= n, 2 * (n - 1) - i, i)
    return torch.as_tensor(i, device=device)


def _blur_axis(x: torch.Tensor, k: np.ndarray, axis: int) -> torch.Tensor:
    """One pass of a separable blur with taps ``k`` over ``axis`` (1:
    rows, 2: columns) of [B, H, W] or [B, H, W, C] on numpy's "reflect"
    border, the taps summed in order as the JAX package's numpy sums
    run."""
    r = (len(k) - 1) // 2
    n = x.shape[axis]
    xp = x.index_select(axis, _pad_index(n, r, r, "reflect", x.device))
    return _accumulate(float(k[i]) * xp.narrow(axis, i, n)
                       for i in range(len(k)))


def gaussian_kernel(radius: int, sigma: float) -> np.ndarray:
    """The JAX package's normalised float32 gaussian taps."""
    xs = np.arange(-radius, radius + 1, dtype=np.float32)
    k = np.exp(-(xs ** 2) / max(2.0 * sigma * sigma, 1e-8))
    return k / k.sum()


def gaussian_blur(img: torch.Tensor, radius: int,
                  sigma: float) -> torch.Tensor:
    """Separable gaussian blur, rows then columns (ComfyUI's ImageBlur
    and Canny's smoothing)."""
    k = gaussian_kernel(radius, sigma)
    return _blur_axis(_blur_axis(img, k, 1), k, 2)


def canny_edges(gray: torch.Tensor, low: float, high: float
                ) -> torch.Tensor:
    """Canny on [B, H, W] grayscale frames on their own device, the JAX
    package's ``_canny_edges`` step for step in float32: a 5x5 gaussian
    (sigma 1.4, reflect padding), Sobel on edge padding, non-maximum
    suppression along the gradient quantized to four directions, then
    the double threshold with exact hysteresis: a weak pixel survives
    when its 8-connected component of candidates holds a strong one
    (flooded from the strong pixels until nothing changes, checked every
    ``16`` steps).  Returns 0/1 float32 [B, H, W]."""
    g = gaussian_blur(gray.float(), 2, 1.4)
    H, W = g.shape[1], g.shape[2]
    pad = torch.nn.functional.pad(g[:, None], (1, 1, 1, 1),
                                  mode="replicate")[:, 0]
    kx = np.asarray([[-1, 0, 1], [-2, 0, 2], [-1, 0, 1]], np.float32)
    ky = kx.T
    gx = _accumulate(float(kx[i, j]) * pad[:, i:i + H, j:j + W]
                     for i in range(3) for j in range(3))
    gy = _accumulate(float(ky[i, j]) * pad[:, i:i + H, j:j + W]
                     for i in range(3) for j in range(3))
    mag = torch.hypot(gx, gy)
    deg = float(np.float32(180.0) / np.float32(np.pi))
    ang = torch.remainder(torch.atan2(gy, gx) * deg + 180.0, 180.0)
    mp = torch.nn.functional.pad(mag, (1, 1, 1, 1))
    offs = torch.where(ang < 22.5, 0, torch.where(
        ang < 67.5, 1, torch.where(ang < 112.5, 2, torch.where(
            ang < 157.5, 3, 0))))
    dirs = {0: ((0, 1), (0, -1)), 1: ((-1, 1), (1, -1)),
            2: ((-1, 0), (1, 0)), 3: ((-1, -1), (1, 1))}
    keep = torch.zeros_like(mag, dtype=torch.bool)
    for o, ((dy1, dx1), (dy2, dx2)) in dirs.items():
        n1 = mp[:, 1 + dy1:1 + dy1 + H, 1 + dx1:1 + dx1 + W]
        n2 = mp[:, 1 + dy2:1 + dy2 + H, 1 + dx2:1 + dx2 + W]
        keep |= (offs == o) & (mag >= n1) & (mag >= n2)
    nms = torch.where(keep, mag, torch.zeros_like(mag))
    strong = nms >= high
    cand = (strong | (nms >= low)).float()[:, None]
    cur = strong.float()[:, None]
    while True:
        prev = cur
        for _ in range(16):
            cur = torch.nn.functional.max_pool2d(cur, 3, 1, 1) * cand
        if torch.equal(cur, prev):
            return cur[:, 0]


@register_op
class Canny(Op):
    """IMAGE -> edge IMAGE (the ControlNet hint preprocessor), on the
    run's device: the frames' luma (0.299, 0.587, 0.114) through
    :func:`canny_edges`, repeated to three channels."""
    TYPE = "Canny"
    WIDGETS = ["low_threshold", "high_threshold"]
    DEFAULTS = {"low_threshold": 0.4, "high_threshold": 0.8}

    def execute(self, ctx: OpContext, image, low_threshold: float = 0.4,
                high_threshold: float = 0.8):
        img = as_device_image(image, ctx.device)
        luma = torch.tensor([0.299, 0.587, 0.114], dtype=torch.float32,
                            device=img.device)
        with Timer("canny"):
            edges = canny_edges(img @ luma, float(low_threshold),
                                float(high_threshold))
        return (DeviceImage(edges[..., None].repeat(1, 1, 1, 3)),)


# --- latent, image and mask ops ----------------------------------------------


def _overlap_window(H: int, W: int, h: int, w: int, x: int, y: int):
    """The visible window of an (h, w) paste at (x, y) into (H, W):
    ((y0, y1, x0, x1) in the destination, (sy0, sy1, sx0, sx1) in the
    source), or None when it falls outside."""
    x0, y0 = max(int(x), 0), max(int(y), 0)
    x1, y1 = min(int(x) + w, W), min(int(y) + h, H)
    if x0 >= x1 or y0 >= y1:
        return None
    sx0, sy0 = x0 - int(x), y0 - int(y)
    return ((y0, y1, x0, x1),
            (sy0, sy0 + (y1 - y0), sx0, sx0 + (x1 - x0)))


def paste(dest: torch.Tensor, src: torch.Tensor, x: int, y: int,
          mask=None) -> torch.Tensor:
    """``src`` [Bs, h, w, C] pasted onto a copy of ``dest`` [B, H, W, C]
    at (x, y), blended by ``mask`` ([h, w] or [., h, w], area-resized to
    the source and clipped to [0, 1]) when given; what falls outside is
    cut, and a short source or mask batch cycles (the JAX package's
    ``_paste``, shared by the image, latent and mask composites)."""
    out = dest.clone()
    B, H, W, _ = dest.shape
    h, w = src.shape[1], src.shape[2]
    win = _overlap_window(H, W, h, w, x, y)
    if win is None:
        return out
    (y0, y1, x0, x1), (sy0, sy1, sx0, sx1) = win
    src_b = cycle_batch(src.to(out.device), B)[:, sy0:sy1, sx0:sx1]
    if mask is None:
        out[:, y0:y1, x0:x1] = src_b
        return out
    m = as_mask(mask, out.device)
    if m.shape[1] != h or m.shape[2] != w:
        m = resize_image(m[..., None], w, h, "area")[..., 0]
    m = cycle_batch(m, B)[:, sy0:sy1, sx0:sx1, None].clamp(0.0, 1.0)
    out[:, y0:y1, x0:x1] = src_b * m + out[:, y0:y1, x0:x1] * (1.0 - m)
    return out


def _latent(samples, device) -> torch.Tensor:
    return as_device_array(samples["samples"], device)


def _latent_out(meta: dict, lat: torch.Tensor) -> tuple:
    return ({**meta, "samples": DeviceLatent(lat)},)


def _latent_pair(samples1, samples2, device):
    """The two latents of a binary latent op: the second resized
    (bilinear) to the first's size and cycled to its batch."""
    a, b = _latent(samples1, device), _latent(samples2, device)
    if a.shape[1:3] != b.shape[1:3]:
        b = resize_image(b, a.shape[2], a.shape[1], "bilinear")
    return a, cycle_batch(b, a.shape[0])


@register_op
class LatentAdd(Op):
    TYPE = "LatentAdd"

    def execute(self, ctx: OpContext, samples1, samples2):
        a, b = _latent_pair(samples1, samples2, ctx.device)
        return _latent_out(_latent_meta(samples1), a + b)


@register_op
class LatentSubtract(Op):
    TYPE = "LatentSubtract"

    def execute(self, ctx: OpContext, samples1, samples2):
        a, b = _latent_pair(samples1, samples2, ctx.device)
        return _latent_out(_latent_meta(samples1), a - b)


@register_op
class LatentMultiply(Op):
    TYPE = "LatentMultiply"
    WIDGETS = ["multiplier"]
    DEFAULTS = {"multiplier": 1.0}

    def execute(self, ctx: OpContext, samples, multiplier: float = 1.0):
        return _latent_out(_latent_meta(samples),
                           _latent(samples, ctx.device) * float(multiplier))


@register_op
class LatentInterpolate(Op):
    """Direction-magnitude interpolation: the unit channel vectors blend
    by ``ratio`` at each position, and the result takes the blended
    magnitude."""
    TYPE = "LatentInterpolate"
    WIDGETS = ["ratio"]
    DEFAULTS = {"ratio": 1.0}

    def execute(self, ctx: OpContext, samples1, samples2,
                ratio: float = 1.0):
        a, b = _latent_pair(samples1, samples2, ctx.device)
        t = float(ratio)
        m1 = torch.linalg.vector_norm(a, dim=-1, keepdim=True)
        m2 = torch.linalg.vector_norm(b, dim=-1, keepdim=True)
        out = a / m1.clamp(min=1e-10) * t + b / m2.clamp(min=1e-10) * (1.0 - t)
        mo = torch.linalg.vector_norm(out, dim=-1, keepdim=True)
        out = out / mo.clamp(min=1e-10) * (m1 * t + m2 * (1.0 - t))
        return _latent_out(_latent_meta(samples1), out)


@register_op
class LatentBlend(Op):
    """``samples1 * blend_factor + samples2 * (1 - blend_factor)``, the
    second resized to the first's size."""
    TYPE = "LatentBlend"
    WIDGETS = ["blend_factor"]
    DEFAULTS = {"blend_factor": 0.5}

    def execute(self, ctx: OpContext, samples1, samples2,
                blend_factor: float = 0.5):
        a, b = _latent_pair(samples1, samples2, ctx.device)
        f = float(blend_factor)
        return _latent_out(_latent_meta(samples1), a * f + b * (1.0 - f))


@register_op
class LatentComposite(Op):
    """``samples_from`` pasted onto ``samples_to`` at pixel (x, y) (//8
    latent units); ``feather`` pixels of linear ramp on each edge that
    has destination beyond it, the corner rates multiplied."""
    TYPE = "LatentComposite"
    WIDGETS = ["x", "y", "feather"]
    DEFAULTS = {"x": 0, "y": 0, "feather": 0}

    def execute(self, ctx: OpContext, samples_to, samples_from,
                x: int = 0, y: int = 0, feather: int = 0):
        dest = _latent(samples_to, ctx.device)
        src = _latent(samples_from, ctx.device)
        xl, yl = int(x) // 8, int(y) // 8
        f = max(int(feather), 0) // 8
        mask = None
        if f > 0:
            h, w = src.shape[1], src.shape[2]
            H, W = dest.shape[1], dest.shape[2]
            # built on the host, factor by factor in the JAX op's order
            m = np.ones((1, h, w), np.float32)
            for t in range(min(f, h, w)):
                rate = (t + 1) / f
                if yl != 0:
                    m[:, t, :] *= rate
                if yl + h < H:
                    m[:, h - 1 - t, :] *= rate
                if xl != 0:
                    m[:, :, t] *= rate
                if xl + w < W:
                    m[:, :, w - 1 - t] *= rate
            mask = torch.from_numpy(m).to(dest.device)
        return _latent_out(_latent_meta(samples_to),
                           paste(dest, src, xl, yl, mask))


@register_op
class LatentCompositeMasked(Op):
    """LatentComposite through an optional mask; x/y are pixels (//8);
    ``resize_source`` first resizes the source to the destination."""
    TYPE = "LatentCompositeMasked"
    WIDGETS = ["x", "y", "resize_source"]
    DEFAULTS = {"x": 0, "y": 0, "resize_source": False}

    def execute(self, ctx: OpContext, destination, source, x: int = 0,
                y: int = 0, resize_source=False, mask=None):
        dest = _latent(destination, ctx.device)
        src = _latent(source, ctx.device)
        if _truthy(resize_source):
            src = resize_image(src, dest.shape[2], dest.shape[1], "bilinear")
        return _latent_out(_latent_meta(destination),
                           paste(dest, src, int(x) // 8, int(y) // 8, mask))


@register_op
class LatentCrop(Op):
    """A crop; x/y/width/height are pixels (//8), the window kept
    inside the latent."""
    TYPE = "LatentCrop"
    WIDGETS = ["width", "height", "x", "y"]

    def execute(self, ctx: OpContext, samples, width: int, height: int,
                x: int = 0, y: int = 0):
        lat = _latent(samples, ctx.device)
        H, W = lat.shape[1], lat.shape[2]
        w, h = max(int(width) // 8, 1), max(int(height) // 8, 1)
        x0 = min(max(int(x) // 8, 0), max(W - w, 0))
        y0 = min(max(int(y) // 8, 0), max(H - h, 0))
        return _latent_out(_latent_meta(samples),
                           lat[:, y0:y0 + h, x0:x0 + w].clone())


@register_op
class LatentFlip(Op):
    TYPE = "LatentFlip"
    WIDGETS = ["flip_method"]
    DEFAULTS = {"flip_method": "x-axis: vertically"}

    def execute(self, ctx: OpContext, samples,
                flip_method: str = "x-axis: vertically"):
        dim = 1 if str(flip_method).startswith("x") else 2
        return _latent_out(_latent_meta(samples),
                           _latent(samples, ctx.device).flip(dim))


@register_op
class LatentRotate(Op):
    """Rotation by 90, 180 or 270 degrees clockwise, or none."""
    TYPE = "LatentRotate"
    WIDGETS = ["rotation"]
    DEFAULTS = {"rotation": "none"}

    def execute(self, ctx: OpContext, samples, rotation: str = "none"):
        lat = _latent(samples, ctx.device)
        r = str(rotation)
        k = 3 if r.startswith("90") else 2 if r.startswith("180") \
            else 1 if r.startswith("270") else 0
        out = torch.rot90(lat, k, dims=(1, 2)).contiguous() if k else lat
        return _latent_out(_latent_meta(samples), out)


@register_op
class LatentBatch(Op):
    """The two batches concatenated (the second resized to the first's
    size); a plain batch, without the inputs' metadata."""
    TYPE = "LatentBatch"

    def execute(self, ctx: OpContext, samples1, samples2):
        a, b = _latent(samples1, ctx.device), _latent(samples2, ctx.device)
        if a.shape[1:3] != b.shape[1:3]:
            b = resize_image(b, a.shape[2], a.shape[1], "bilinear")
        return ({"samples": DeviceLatent(torch.cat([a, b], dim=0))},)


@register_op
class LatentFromBatch(Op):
    """Rows [batch_index, batch_index + length) of a latent batch, a
    plain batch; the noise mask goes with its rows (a one-row mask
    as it is)."""
    TYPE = "LatentFromBatch"
    WIDGETS = ["batch_index", "length"]
    DEFAULTS = {"batch_index": 0, "length": 1}

    def execute(self, ctx: OpContext, samples, batch_index: int = 0,
                length: int = 1):
        lat = _latent(samples, ctx.device)
        i = min(max(int(batch_index), 0), lat.shape[0] - 1)
        n = min(max(int(length), 1), lat.shape[0] - i)
        out = {"samples": DeviceLatent(lat[i:i + n])}
        if "noise_mask" in samples:
            m = as_mask(samples["noise_mask"], ctx.device)
            out["noise_mask"] = m if m.shape[0] == 1 \
                else cycle_batch(m, lat.shape[0])[i:i + n]
        return (out,)


@register_op
class LatentBatchSeedBehavior(Op):
    """"fixed": every row of the batch draws the same noise (the
    sampler's fold-in index is 0 for all); "random" keeps a stream a
    row."""
    TYPE = "LatentBatchSeedBehavior"
    WIDGETS = ["seed_behavior"]
    DEFAULTS = {"seed_behavior": "random"}

    def execute(self, ctx: OpContext, samples,
                seed_behavior: str = "random"):
        meta = _latent_meta(samples)
        meta.pop("seed_fixed_batch", None)
        if str(seed_behavior) == "fixed":
            meta["seed_fixed_batch"] = True
        return _latent_out(meta, _latent(samples, ctx.device))


@register_op
class RepeatLatentBatch(Op):
    """The batch repeated ``amount`` times (each prompt's batch size
    with it)."""
    TYPE = "RepeatLatentBatch"
    WIDGETS = ["amount"]
    DEFAULTS = {"amount": 1}

    def execute(self, ctx: OpContext, samples, amount: int = 1):
        n = max(int(amount), 1)
        meta = _latent_meta(samples)
        if "local_batch" in meta:
            meta["local_batch"] = meta["local_batch"] * n
        return _latent_out(meta, _latent(samples, ctx.device).repeat(
            n, 1, 1, 1))


@register_op
class RebatchLatents(Op):
    """The latent as it is: the executor carries whole batches, so
    ``batch_size`` bounds nothing here (as in the JAX package)."""
    TYPE = "RebatchLatents"
    WIDGETS = ["batch_size"]
    DEFAULTS = {"batch_size": 1}

    def execute(self, ctx: OpContext, latents, batch_size: int = 1):
        return _latent_out(_latent_meta(latents), _latent(latents,
                                                          ctx.device))


# masks


@register_op
class SolidMask(Op):
    TYPE = "SolidMask"
    WIDGETS = ["value", "width", "height"]
    DEFAULTS = {"value": 1.0, "width": 512, "height": 512}

    def execute(self, ctx: OpContext, value: float = 1.0,
                width: int = 512, height: int = 512):
        return (torch.full((1, int(height), int(width)), float(value),
                           dtype=torch.float32, device=ctx.device),)


@register_op
class InvertMask(Op):
    TYPE = "InvertMask"

    def execute(self, ctx: OpContext, mask):
        return (1.0 - as_device_array(mask, ctx.device),)


@register_op
class GrowMask(Op):
    """``expand`` steps of a 3x3 max filter on a zero border (the
    corners left out when ``tapered_corners``); a negative ``expand``
    shrinks the mask the same way."""
    TYPE = "GrowMask"
    WIDGETS = ["expand", "tapered_corners"]
    DEFAULTS = {"expand": 0, "tapered_corners": True}

    def execute(self, ctx: OpContext, mask, expand: int = 0,
                tapered_corners: bool = True):
        m = as_mask(mask, ctx.device)
        n = int(expand)
        if n < 0:
            m = 1.0 - m
        shifts = [(0, 0), (-1, 0), (1, 0), (0, -1), (0, 1)]
        if str(tapered_corners).lower() in ("false", "0"):
            shifts += [(-1, -1), (-1, 1), (1, -1), (1, 1)]
        H, W = m.shape[1], m.shape[2]
        for _ in range(abs(n)):
            p = torch.nn.functional.pad(m, (1, 1, 1, 1))
            m = torch.stack([p[:, 1 + dy:1 + dy + H, 1 + dx:1 + dx + W]
                             for dy, dx in shifts]).amax(0)
        if n < 0:
            m = 1.0 - m
        return (m,)


@register_op
class MaskComposite(Op):
    """``source`` combined into ``destination`` at (x, y): multiply,
    add, subtract, and, or, xor; clipped to [0, 1]."""
    TYPE = "MaskComposite"
    WIDGETS = ["x", "y", "operation"]
    DEFAULTS = {"x": 0, "y": 0, "operation": "multiply"}

    def execute(self, ctx: OpContext, destination, source, x: int = 0,
                y: int = 0, operation: str = "multiply"):
        d = as_mask(destination, ctx.device)
        s = as_mask(source, ctx.device)
        out = d.clone()
        B, H, W = d.shape
        win = _overlap_window(H, W, s.shape[1], s.shape[2], x, y)
        if win is None:
            return (out,)
        (y0, y1, x0, x1), (sy0, sy1, sx0, sx1) = win
        sb = cycle_batch(s, B)[:, sy0:sy1, sx0:sx1]
        reg = out[:, y0:y1, x0:x1]
        op = str(operation)
        if op == "multiply":
            reg = reg * sb
        elif op == "add":
            reg = reg + sb
        elif op == "subtract":
            reg = reg - sb
        elif op == "and":
            reg = torch.minimum(reg.round(), sb.round())
        elif op == "or":
            reg = torch.maximum(reg.round(), sb.round())
        elif op == "xor":
            reg = (reg.round() - sb.round()).abs()
        else:
            raise ValueError(f"unknown mask operation {op!r}")
        out[:, y0:y1, x0:x1] = reg.clamp(0.0, 1.0)
        return (out,)


@register_op
class MaskToImage(Op):
    TYPE = "MaskToImage"

    def execute(self, ctx: OpContext, mask):
        m = as_mask(mask, ctx.device)
        return (DeviceImage(m[..., None].repeat(1, 1, 1, 3)),)


@register_op
class ImageToMask(Op):
    TYPE = "ImageToMask"
    WIDGETS = ["channel"]
    DEFAULTS = {"channel": "red"}

    def execute(self, ctx: OpContext, image, channel: str = "red"):
        img = as_device_image(image, ctx.device)
        idx = {"red": 0, "green": 1, "blue": 2,
               "alpha": 3}.get(str(channel), 0)
        if idx >= img.shape[-1]:
            raise ValueError(
                f"ImageToMask: image has no {channel!r} channel "
                f"({img.shape[-1]} channels)")
        return (img[..., idx].contiguous(),)


@register_op
class ImageColorToMask(Op):
    """1 where a pixel's 8-bit RGB, packed as 0xRRGGBB, equals
    ``color``."""
    TYPE = "ImageColorToMask"
    WIDGETS = ["color"]
    DEFAULTS = {"color": 0}

    def execute(self, ctx: OpContext, image, color: int = 0):
        q = (as_device_image(image, ctx.device)[..., :3] * 255.0).clamp(
            0, 255).round().long()
        packed = (q[..., 0] << 16) | (q[..., 1] << 8) | q[..., 2]
        return ((packed == int(color)).float(),)


@register_op
class CropMask(Op):
    TYPE = "CropMask"
    WIDGETS = ["x", "y", "width", "height"]

    def execute(self, ctx: OpContext, mask, x: int = 0, y: int = 0,
                width: int = 64, height: int = 64):
        m = as_mask(mask, ctx.device)
        H, W = m.shape[1], m.shape[2]
        x0 = min(max(int(x), 0), max(W - 1, 0))
        y0 = min(max(int(y), 0), max(H - 1, 0))
        return (m[:, y0:y0 + max(int(height), 1),
                  x0:x0 + max(int(width), 1)].clone(),)


def _feather_factors(n: int, near: int, far: int) -> Tuple[np.ndarray,
                                                            np.ndarray]:
    """FeatherMask's factors along one axis: (t + 1) / margin at the
    t-th line from each side, 1 elsewhere (float32, as numpy applies a
    Python float to a float32 array)."""
    lo, hi = np.ones(n, np.float32), np.ones(n, np.float32)
    for t in range(min(max(int(near), 0), n)):
        lo[t] = np.float32((t + 1) / int(near))
    for t in range(min(max(int(far), 0), n)):
        hi[n - 1 - t] = np.float32((t + 1) / int(far))
    return lo, hi


@register_op
class FeatherMask(Op):
    """Linear ramps to 0 over the given margin on each side, (t + 1) /
    margin at the t-th line, so the innermost feathered line is 1 (a
    margin of 1 changes nothing)."""
    TYPE = "FeatherMask"
    WIDGETS = ["left", "top", "right", "bottom"]
    DEFAULTS = {"left": 0, "top": 0, "right": 0, "bottom": 0}

    def execute(self, ctx: OpContext, mask, left: int = 0, top: int = 0,
                right: int = 0, bottom: int = 0):
        m = as_mask(mask, ctx.device)
        H, W = m.shape[1], m.shape[2]
        rows = _feather_factors(H, top, bottom)
        cols = _feather_factors(W, left, right)
        # the factors in the JAX op's order: top, bottom, left, right

        def dev(v: np.ndarray) -> torch.Tensor:
            return torch.from_numpy(v).to(m.device)

        out = m * dev(rows[0])[:, None] * dev(rows[1])[:, None]
        return (out * dev(cols[0]) * dev(cols[1]),)


@register_op
class ThresholdMask(Op):
    TYPE = "ThresholdMask"
    WIDGETS = ["value"]
    DEFAULTS = {"value": 0.5}

    def execute(self, ctx: OpContext, mask, value: float = 0.5):
        return ((as_mask(mask, ctx.device) > float(value)).float(),)


def _window_filter(x: torch.Tensor, k: int, start: int, reduce: str
                   ) -> torch.Tensor:
    """A flat k x k min or max filter over dims 1 and 2 of [B, H, W],
    the window of output i covering inputs i + start .. i + start + k - 1
    on a "symmetric" border; separable, so exact."""
    for dim in (1, 2):
        n = x.shape[dim]
        xp = x.index_select(dim, _pad_index(n, -start, start + k - 1,
                                            "symmetric", x.device))
        win = xp.unfold(dim, k, 1)
        x = win.amax(-1) if reduce == "max" else win.amin(-1)
    return x


def morphology(m: torch.Tensor, op: str, size: int) -> torch.Tensor:
    """Grey morphology of [B, H, W] with a flat square of side ``size``,
    as ``scipy.ndimage``'s grey_* functions give it: a "reflect" border
    (the edge sample repeated) and, at an even size, the dilation's
    window one sample later than the erosion's."""
    k = max(int(size), 1)

    def erode(x):
        return _window_filter(x, k, -(k // 2), "min")

    def dilate(x):
        return _window_filter(x, k, -((k - 1) // 2), "max")

    if op == "erode":
        return erode(m)
    if op == "dilate":
        return dilate(m)
    if op == "open":
        return dilate(erode(m))
    if op == "close":
        return erode(dilate(m))
    if op == "gradient":
        return dilate(m) - erode(m)
    if op == "top_hat":
        return m - dilate(erode(m))
    if op == "bottom_hat":
        return erode(dilate(m)) - m
    raise ValueError(f"unknown morphology operation {op!r}")


@register_op
class Morphology(Op):
    """Grey morphology of each channel (:func:`morphology`), clipped to
    [0, 1]."""
    TYPE = "Morphology"
    WIDGETS = ["operation", "kernel_size"]
    DEFAULTS = {"operation": "dilate", "kernel_size": 3}

    def execute(self, ctx: OpContext, image, operation: str = "dilate",
                kernel_size: int = 3):
        img = as_device_image(image, ctx.device)
        b, h, w, c = img.shape
        planes = img.permute(0, 3, 1, 2).reshape(b * c, h, w)
        out = morphology(planes, str(operation), int(kernel_size))
        return (DeviceImage(out.reshape(b, c, h, w).permute(0, 2, 3, 1)
                            .clamp(0.0, 1.0).contiguous()),)


# images


@register_op
class EmptyImage(Op):
    TYPE = "EmptyImage"
    WIDGETS = ["width", "height", "batch_size", "color"]
    DEFAULTS = {"width": 512, "height": 512, "batch_size": 1, "color": 0}

    def execute(self, ctx: OpContext, width: int = 512, height: int = 512,
                batch_size: int = 1, color: int = 0):
        c = int(color)
        rgb = torch.tensor([(c >> 16) & 0xFF, (c >> 8) & 0xFF, c & 0xFF],
                           dtype=torch.float32, device=ctx.device) / 255.0
        return (DeviceImage(rgb.expand(int(batch_size), int(height),
                                       int(width), 3).contiguous()),)


@register_op
class ImageBatchOp(Op):
    """Two image batches concatenated, the second resized (bilinear) to
    the first's size.  (The class is named ...Op as in the JAX package,
    where ``ImageBatch`` is the fan-out image wrapper.)"""
    TYPE = "ImageBatch"

    def execute(self, ctx: OpContext, image1, image2):
        a, b = as_device_image(image1, ctx.device), as_device_image(image2, ctx.device)
        if a.shape[1:3] != b.shape[1:3]:
            b = resize_image(b, a.shape[2], a.shape[1], "bilinear")
        return (DeviceImage(torch.cat([a, b], dim=0)),)


@register_op
class ImageFromBatch(Op):
    TYPE = "ImageFromBatch"
    WIDGETS = ["batch_index", "length"]
    DEFAULTS = {"batch_index": 0, "length": 1}

    def execute(self, ctx: OpContext, image, batch_index: int = 0,
                length: int = 1):
        img = as_device_image(image, ctx.device)
        i = min(max(int(batch_index), 0), img.shape[0] - 1)
        return (DeviceImage(img[i:i + max(int(length), 1)]),)


@register_op
class RebatchImages(Op):
    """The images as they are (see RebatchLatents)."""
    TYPE = "RebatchImages"
    WIDGETS = ["batch_size"]
    DEFAULTS = {"batch_size": 1}

    def execute(self, ctx: OpContext, images, batch_size: int = 1):
        return (DeviceImage(as_device_image(images, ctx.device)),)


@register_op
class ImageCrop(Op):
    TYPE = "ImageCrop"
    WIDGETS = ["width", "height", "x", "y"]

    def execute(self, ctx: OpContext, image, width: int, height: int,
                x: int = 0, y: int = 0):
        img = as_device_image(image, ctx.device)
        H, W = img.shape[1], img.shape[2]
        x0 = min(max(int(x), 0), W - 1)
        y0 = min(max(int(y), 0), H - 1)
        x1 = min(x0 + max(int(width), 1), W)
        y1 = min(y0 + max(int(height), 1), H)
        return (DeviceImage(img[:, y0:y1, x0:x1].contiguous()),)


@register_op
class ImageInvert(Op):
    TYPE = "ImageInvert"

    def execute(self, ctx: OpContext, image):
        return (DeviceImage(1.0 - as_device_image(image, ctx.device)),)


@register_op
class ImageBlend(Op):
    """``image2`` composited onto ``image1`` by the mode, then mixed by
    ``blend_factor``; image2 resized (bilinear) to image1's size."""
    TYPE = "ImageBlend"
    WIDGETS = ["blend_factor", "blend_mode"]
    DEFAULTS = {"blend_factor": 0.5, "blend_mode": "normal"}

    MODES = ("normal", "multiply", "screen", "overlay", "soft_light",
             "difference")

    def execute(self, ctx: OpContext, image1, image2,
                blend_factor: float = 0.5, blend_mode: str = "normal"):
        a, b = as_device_image(image1, ctx.device), as_device_image(image2, ctx.device)
        if b.shape[1:3] != a.shape[1:3]:
            b = resize_image(b, a.shape[2], a.shape[1], "bilinear")
        b = cycle_batch(b, a.shape[0])
        mode = str(blend_mode)
        if mode == "normal":
            blended = b
        elif mode == "multiply":
            blended = a * b
        elif mode == "screen":
            blended = 1.0 - (1.0 - a) * (1.0 - b)
        elif mode == "overlay":
            blended = torch.where(a <= 0.5, 2.0 * a * b,
                                  1.0 - 2.0 * (1.0 - a) * (1.0 - b))
        elif mode == "soft_light":
            g = torch.where(a <= 0.25, ((16.0 * a - 12.0) * a + 4.0) * a,
                            a.clamp(min=0.0).sqrt())
            blended = torch.where(b <= 0.5,
                                  a - (1.0 - 2.0 * b) * a * (1.0 - a),
                                  a + (2.0 * b - 1.0) * (g - a))
        elif mode == "difference":
            blended = (a - b).abs()
        else:
            raise ValueError(f"ImageBlend: unknown mode {mode!r}; "
                             f"available: {self.MODES}")
        f = float(blend_factor)
        return (DeviceImage((a * (1.0 - f) + blended * f).clamp(0.0, 1.0)),)


@register_op
class ImageBlur(Op):
    TYPE = "ImageBlur"
    WIDGETS = ["blur_radius", "sigma"]
    DEFAULTS = {"blur_radius": 1, "sigma": 1.0}

    def execute(self, ctx: OpContext, image, blur_radius: int = 1,
                sigma: float = 1.0):
        img = as_device_image(image, ctx.device)
        r = int(blur_radius)
        if r < 1:
            return (DeviceImage(img),)
        return (DeviceImage(gaussian_blur(img, r, float(sigma))),)


@register_op
class ImageSharpen(Op):
    """Unsharp mask: ``image + alpha * (image - blur(image))``, clipped."""
    TYPE = "ImageSharpen"
    WIDGETS = ["sharpen_radius", "sigma", "alpha"]
    DEFAULTS = {"sharpen_radius": 1, "sigma": 1.0, "alpha": 1.0}

    def execute(self, ctx: OpContext, image, sharpen_radius: int = 1,
                sigma: float = 1.0, alpha: float = 1.0):
        img = as_device_image(image, ctx.device)
        r = int(sharpen_radius)
        if r < 1:
            return (DeviceImage(img),)
        blurred = gaussian_blur(img, r, float(sigma))
        return (DeviceImage((img + float(alpha) * (img - blurred)).clamp(
            0.0, 1.0)),)


@register_op
class ImageQuantize(Op):
    """Reduce each frame to at most ``colors`` palette entries: the
    port's median cut on the host, then each pixel's nearest entry on
    the run's device, or Floyd-Steinberg on the host
    (``utils/quantize.py``).  The frame is cut to 8 bits as the JAX op
    cuts it for Pillow (``x * 255``, truncated)."""
    TYPE = "ImageQuantize"
    WIDGETS = ["colors", "dither"]
    DEFAULTS = {"colors": 256, "dither": "floyd-steinberg"}

    def execute(self, ctx: OpContext, image, colors: int = 256,
                dither: str = "floyd-steinberg"):
        img = as_device_image(image, ctx.device)
        if img.shape[-1] != 3:
            raise ValueError(f"ImageQuantize takes RGB images; got "
                             f"{img.shape[-1]} channels")
        px = (img.clamp(0, 1) * 255).to(torch.uint8)
        host = px.cpu().numpy()
        out = []
        for f, hf in zip(px, host):
            pal = quantize_mod.median_cut(hf.reshape(-1, 3), colors)
            if str(dither).startswith("floyd"):
                idx = torch.from_numpy(quantize_mod.floyd_steinberg(
                    hf, pal)).to(ctx.device)
            else:
                idx = quantize_mod.nearest_entries(
                    f.reshape(-1, 3), torch.from_numpy(pal)).reshape(
                        f.shape[:2])
            # the entries' values divided on the host: a division by a
            # scalar on the card multiplies by its reciprocal, which can
            # round the last bit otherwise
            values = torch.from_numpy(pal.astype(np.float32)
                                      / np.float32(255.0)).to(ctx.device)
            out.append(values[idx])
        return (DeviceImage(torch.stack(out)),)


@register_op
class ImageCompositeMasked(Op):
    """``source`` pasted over ``destination`` at pixel (x, y), through
    an optional MASK; ``resize_source`` first resizes the source
    (bilinear) to the destination."""
    TYPE = "ImageCompositeMasked"
    WIDGETS = ["x", "y", "resize_source"]
    DEFAULTS = {"x": 0, "y": 0, "resize_source": False}

    def execute(self, ctx: OpContext, destination, source, x: int = 0,
                y: int = 0, resize_source=False, mask=None):
        dest = as_device_image(destination, ctx.device)
        src = as_device_image(source, ctx.device)
        if _truthy(resize_source):
            src = resize_image(src, dest.shape[2], dest.shape[1], "bilinear")
        return (DeviceImage(paste(dest, src, int(x), int(y), mask)),)


def porter_duff(mode: str, cs, cd, a_s, a_d):
    """The reference node's straight-alpha Porter-Duff table, as the JAX
    package applies it (its quirks at partial alpha included): (colour
    [B, H, W, C], alpha [B, H, W])."""
    asr, adr = a_s[..., None], a_d[..., None]
    over = a_s + (1 - a_s) * a_d
    if mode == "ADD":
        return (cs + cd).clamp(0, 1), (a_s + a_d).clamp(0, 1)
    if mode == "CLEAR":
        return torch.zeros_like(cs), torch.zeros_like(a_s)
    if mode == "DARKEN":
        return (1 - adr) * cs + (1 - asr) * cd + torch.minimum(cs, cd), over
    if mode == "DST":
        return cd, a_d
    if mode == "DST_ATOP":
        return asr * cd + (1 - adr) * cs, a_s
    if mode == "DST_IN":
        return cd * asr, a_s * a_d
    if mode == "DST_OUT":
        return (1 - asr) * cd, (1 - a_s) * a_d
    if mode == "DST_OVER":
        return cd + (1 - adr) * cs, a_d + (1 - a_d) * a_s
    if mode == "LIGHTEN":
        return (1 - adr) * cs + (1 - asr) * cd + torch.maximum(cs, cd), over
    if mode == "MULTIPLY":
        return cs * cd, a_s * a_d
    if mode == "OVERLAY":
        lo = 2 * cs * cd + cs * (1 - adr) + cd * (1 - asr)
        hi = cs * (1 + adr) + cd * (1 + asr) - 2 * cd * cs - adr * asr
        return torch.where(2 * cd <= adr, lo, hi), over
    if mode == "SCREEN":
        return cs + cd - cs * cd, over
    if mode == "SRC":
        return cs, a_s
    if mode == "SRC_ATOP":
        return adr * cs + (1 - asr) * cd, a_d
    if mode == "SRC_IN":
        return cs * adr, a_s * a_d
    if mode == "SRC_OUT":
        return (1 - adr) * cs, (1 - a_d) * a_s
    if mode == "SRC_OVER":
        return cs + (1 - asr) * cd, over
    if mode == "XOR":
        return ((1 - adr) * cs + (1 - asr) * cd,
                (1 - a_d) * a_s + (1 - a_s) * a_d)
    raise ValueError(f"unknown Porter-Duff mode {mode!r}")


@register_op
class PorterDuffImageComposite(Op):
    """(source, source_alpha) composited over (destination,
    destination_alpha) by :func:`porter_duff`; the destination and both
    alphas resized (bilinear) to the source and cycled to its batch."""
    TYPE = "PorterDuffImageComposite"
    WIDGETS = ["mode"]
    DEFAULTS = {"mode": "DST"}

    def execute(self, ctx: OpContext, source, source_alpha, destination,
                destination_alpha, mode: str = "DST"):
        cs = as_device_image(source, ctx.device)
        b, h, w, _ = cs.shape
        cd = as_device_image(destination, ctx.device)
        if cd.shape[1:3] != cs.shape[1:3]:
            cd = resize_image(cd, w, h, "bilinear")
        cd = cycle_batch(cd, b)

        def align(a):
            a = as_mask(a, ctx.device)
            if a.shape[1:3] != cs.shape[1:3]:
                a = resize_image(a[..., None], w, h, "bilinear")[..., 0]
            return cycle_batch(a, b)

        out_c, out_a = porter_duff(str(mode).upper(), cs, cd,
                                   align(source_alpha),
                                   align(destination_alpha))
        return (DeviceImage(out_c.clamp(0.0, 1.0)), out_a.clamp(0.0, 1.0))


@register_op
class SplitImageWithAlpha(Op):
    """-> (RGB, 1 - alpha): the mask is the inverted alpha, as in the
    reference; an image without alpha gives zeros."""
    TYPE = "SplitImageWithAlpha"

    def execute(self, ctx: OpContext, image):
        img = as_device_image(image, ctx.device)
        alpha = img[..., 3] if img.shape[-1] == 4 \
            else torch.ones(img.shape[:3], device=img.device)
        return (DeviceImage(img[..., :3].contiguous()), 1.0 - alpha)


@register_op
class JoinImageWithAlpha(Op):
    """RGB plus ``1 - alpha`` as the fourth channel (the inverse of
    SplitImageWithAlpha), the alpha resized (bilinear) and cycled to the
    image."""
    TYPE = "JoinImageWithAlpha"

    def execute(self, ctx: OpContext, image, alpha):
        img = as_device_image(image, ctx.device)[..., :3]
        a = as_mask(alpha, ctx.device)
        if a.shape[1:3] != img.shape[1:3]:
            a = resize_image(a[..., None], img.shape[2], img.shape[1],
                             "bilinear")[..., 0]
        a = cycle_batch(a, img.shape[0])
        return (DeviceImage(torch.cat([img, (1.0 - a)[..., None]], dim=-1)),)


@register_op
class ImageScaleBy(Op):
    TYPE = "ImageScaleBy"
    WIDGETS = ["upscale_method", "scale_by"]
    DEFAULTS = {"upscale_method": "lanczos", "scale_by": 2.0}

    def execute(self, ctx: OpContext, image, upscale_method: str,
                scale_by: float = 2.0):
        img = as_device_image(image, ctx.device)
        w = max(round(img.shape[2] * float(scale_by)), 1)
        h = max(round(img.shape[1] * float(scale_by)), 1)
        return (DeviceImage(resize_image(img, w, h, str(upscale_method))),)


@register_op
class ImageScaleToTotalPixels(Op):
    """A resize to about ``megapixels`` x 2^20 pixels, keeping the
    aspect."""
    TYPE = "ImageScaleToTotalPixels"
    WIDGETS = ["upscale_method", "megapixels"]
    DEFAULTS = {"upscale_method": "lanczos", "megapixels": 1.0}

    def execute(self, ctx: OpContext, image, upscale_method: str = "lanczos",
                megapixels: float = 1.0):
        img = as_device_image(image, ctx.device)
        H, W = img.shape[1], img.shape[2]
        scale = math.sqrt(float(megapixels) * 1024 * 1024 / (H * W))
        w = max(int(round(W * scale)), 1)
        h = max(int(round(H * scale)), 1)
        return (DeviceImage(resize_image(img, w, h, str(upscale_method))),)


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
        with trace_mod.stage("d2h"):
            arr = as_image_array(images)
        ctx.collect_images(lambda: list(arr))
        return ()


# one counter scan and write at a time: two runs saving under one
# prefix must not take the same numbers
_save_counter_lock = threading.Lock()


def _next_image_counter(dirpath: str, base: str, ext: str = "png") -> int:
    """First unused counter of ``base_#####.<ext>`` in ``dirpath``."""
    pat = re.compile(re.escape(base) + r"_(\d+)\." + re.escape(ext) + "$")
    taken = [int(m.group(1)) for f in os.listdir(dirpath)
             if (m := pat.match(f))]
    return max(taken, default=-1) + 1


@register_op
class SaveImage(Op):
    """Output node: writes each image as ``{prefix}_NNNNN.png`` into the
    output directory, the counter continuing after the highest file
    there, with the run's API-format graph and the request's
    ``extra_pnginfo`` in text chunks (:func:`png_text`; in a coalesced
    run each prompt's images carry that prompt's own seed); the images
    also go into the run's collected images.  The copy to the host runs
    here; the encodes and the writes run on the host pool when the run
    has one, with the metadata taken now."""
    TYPE = "SaveImage"
    WIDGETS = ["filename_prefix"]
    DEFAULTS = {"filename_prefix": "DistributedTPU"}

    def execute(self, ctx: OpContext, images,
                filename_prefix: str = "DistributedTPU"):
        output_dir = ctx.output_dir
        texts = png_text_per_prompt(ctx)
        with trace_mod.stage("d2h"):
            arr = as_image_array(images)

        def host_side():
            if output_dir:
                probe = _safe_output_path(output_dir,
                                          f"{filename_prefix}_00000.png")
                d, fname = os.path.split(probe)
                base = fname[:-len("_00000.png")]
                os.makedirs(d, exist_ok=True)
                # prompt-major: image i is prompt i // per's
                per = arr.shape[0] // len(texts) \
                    if arr.shape[0] % len(texts) == 0 else arr.shape[0]
                with trace_mod.stage("encode"), _save_counter_lock:
                    start = _next_image_counter(d, base)
                    for i, img in enumerate(arr):
                        save_png(os.path.join(
                            d, f"{base}_{start + i:05d}.png"), img,
                            texts[min(i // max(per, 1), len(texts) - 1)])
            return list(arr)

        ctx.collect_images(host_side)
        return ()


def png_text(ctx: OpContext, prompt_json: Any = None) -> Optional[dict]:
    """The text chunks of a saved PNG, in the JAX package's order and
    encoding: ``prompt`` (the API-format graph; ``prompt_json`` in place
    of the run's), then one per key of the request's ``extra_pnginfo``
    (the UI's ``workflow``), each value JSON-encoded; None when there is
    neither."""
    text = {}
    if prompt_json is None:
        prompt_json = ctx.prompt_json
    if prompt_json is not None:
        text["prompt"] = json.dumps(prompt_json)
    for k, v in dict(ctx.extra_pnginfo or {}).items():
        text[str(k)] = json.dumps(v)
    return text or None


def png_text_per_prompt(ctx: OpContext) -> list:
    """One :func:`png_text` a prompt merged into the run (one when not
    coalesced): the merged graph is prompt 0's, and prompt j's
    ``prompt`` chunk takes back its own values of the masked widgets
    from the ``coalesced_<widget>s`` hidden overrides."""
    k = max(int(ctx.coalesce), 1)
    overrides = ctx.hidden_overrides or {}
    if k <= 1 or not overrides or ctx.prompt_json is None:
        return [png_text(ctx)] * k
    texts = []
    for j in range(k):
        pj = copy.deepcopy(ctx.prompt_json)
        for nid, ov in overrides.items():
            node = pj.get(nid)
            if not isinstance(node, dict):
                continue
            for key, vals in ov.items():
                if key.startswith("coalesced_") and key.endswith("s") \
                        and isinstance(vals, (list, tuple)) \
                        and j < len(vals):
                    widget = key[len("coalesced_"):-1]
                    node.setdefault("inputs", {})[widget] = vals[j]
        texts.append(png_text(ctx, prompt_json=pj))
    return texts


# --- latents and animations on disk ------------------------------------------

def _counted_output_path(ctx: OpContext, filename_prefix: str,
                         ext: str) -> str:
    """``{prefix}_NNNNN.{ext}`` in the output directory, the counter
    after the highest such file there (a second run never overwrites)."""
    probe = _safe_output_path(ctx.output_dir or os.getcwd(),
                              f"{filename_prefix}_00000.{ext}")
    d, fname = os.path.split(probe)
    base = fname[:-len(f"_00000.{ext}")]
    os.makedirs(d, exist_ok=True)
    return os.path.join(d, f"{base}_{_next_image_counter(d, base, ext):05d}"
                           f".{ext}")


@register_op
class SaveLatent(Op):
    """Writes the latent batch as ``{prefix}_NNNNN.latent``, ComfyUI's
    safetensors layout: ``latent_tensor`` in NCHW float32 and the
    ``latent_format_version_0`` marker."""
    TYPE = "SaveLatent"
    WIDGETS = ["filename_prefix"]
    DEFAULTS = {"filename_prefix": "latents/save"}

    def execute(self, ctx: OpContext, samples,
                filename_prefix: str = "latents/save"):
        path = _counted_output_path(ctx, filename_prefix, "latent")
        lat = as_device_array(samples["samples"], ctx.device)
        ckpt_mod.write_safetensors(
            {"latent_tensor": lat.permute(0, 3, 1, 2).contiguous(),
             "latent_format_version_0": torch.tensor([0])}, path)
        debug_log(f"SaveLatent: wrote {path}")
        return ()


@register_op
class LoadLatent(Op):
    """Reads a ``.latent`` file (relative to the input directory) onto
    the run's device, NHWC; a file without the version marker holds
    scaled latents and is divided by 0.18215, as ComfyUI reads it."""
    TYPE = "LoadLatent"
    WIDGETS = ["latent"]

    def execute(self, ctx: OpContext, latent: str):
        path = str(latent)
        if ctx.input_dir and not os.path.isabs(path):
            path = os.path.join(ctx.input_dir, path)
        sd = ckpt_mod.read_safetensors(path)
        lat = sd["latent_tensor"].to(torch.float32)
        if "latent_format_version_0" not in sd:
            lat = lat * (1.0 / 0.18215)
        return ({"samples": DeviceLatent(
            lat.permute(0, 2, 3, 1).contiguous().to(ctx.device))},)


def _frame_ms(fps: float) -> int:
    return int(1000.0 / max(float(fps), 0.01))


@register_op
class SaveAnimatedWEBP(Op):
    """Writes the image batch as one animated ``{prefix}_NNNNN.webp``
    (``utils/webp.py``): lossless VP8L by default, else VP8 at
    ``quality``; ``method`` (default, fastest, slowest) only sets the
    lossy encoder's effort."""
    TYPE = "SaveAnimatedWEBP"
    WIDGETS = ["filename_prefix", "fps", "lossless", "quality"]
    DEFAULTS = {"filename_prefix": "anim/save", "fps": 6.0,
                "lossless": True, "quality": 80}
    _METHODS = {"default": 4, "fastest": 0, "slowest": 6}

    def execute(self, ctx: OpContext, images,
                filename_prefix: str = "anim/save", fps: float = 6.0,
                lossless=True, quality: int = 80, method: str = "default"):
        frames = to_uint8(as_image_array(images))
        path = _counted_output_path(ctx, filename_prefix, "webp")
        data = webp_mod.encode_animated_webp(
            frames, _frame_ms(fps), loop=0,
            lossless=str(lossless).lower() not in ("false", "0", ""),
            quality=int(quality),
            method=self._METHODS.get(str(method), 4))
        with open(path, "wb") as f:
            f.write(data)
        debug_log(f"SaveAnimatedWEBP: wrote {path} ({len(frames)} frames)")
        return ()


@register_op
class SaveAnimatedPNG(Op):
    """Writes the image batch as one APNG ``{prefix}_NNNNN.png`` with the
    run's ``prompt`` and ``extra_pnginfo`` text chunks
    (:func:`png_text`)."""
    TYPE = "SaveAnimatedPNG"
    WIDGETS = ["filename_prefix", "fps", "compress_level"]
    DEFAULTS = {"filename_prefix": "anim/save", "fps": 6.0,
                "compress_level": 4}

    def execute(self, ctx: OpContext, images,
                filename_prefix: str = "anim/save", fps: float = 6.0,
                compress_level: int = 4):
        frames = as_image_array(images)
        path = _counted_output_path(ctx, filename_prefix, "png")
        data = encode_apng(frames, _frame_ms(fps), loop=0,
                           text=png_text(ctx),
                           compress_level=int(compress_level))
        with open(path, "wb") as f:
            f.write(data)
        debug_log(f"SaveAnimatedPNG: wrote {path} ({len(frames)} frames)")
        return ()
