"""Standard workflow ops on the txt2img, img2img, SDXL and upscale
paths: the counterparts of ``CheckpointLoaderSimple``,
``CheckpointSave``, ``CLIPTextEncode``, ``CLIPTextEncodeSDXL``,
``EmptyLatentImage``, ``KSampler``, ``VAEDecode``, ``VAEEncode``,
``LoadImage``, ``ImageScale``, ``UpscaleModelLoader``,
``ImageUpscaleWithModel``, ``PreviewImage`` and ``SaveImage`` in
``comfyui_distributed_tpu/ops/basic.py`` (at fanout 1: VAEEncode neither
memoises nor expands the batch).

Only the plain single-entry conditioning path is ported: regional
prompts, ControlNet, inpaint masks, GLIGEN and the other patches that
``_prepare_sample_inputs`` handles in the JAX package wait for a later
slice.
"""

from __future__ import annotations

import dataclasses
import json
import os
import re
import threading
from typing import Optional

import numpy as np
import torch

from comfyui_distributed_tpu_torch.models import registry
from comfyui_distributed_tpu_torch.models.checkpoints import save_checkpoint
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


@register_op
class CheckpointLoaderSimple(Op):
    """-> (MODEL, CLIP, VAE); all three views of one DiffusionPipeline."""
    TYPE = "CheckpointLoaderSimple"
    WIDGETS = ["ckpt_name"]

    def execute(self, ctx: OpContext, ckpt_name: str):
        pipe = registry.load_pipeline(ckpt_name, models_dir=ctx.models_dir,
                                      device=ctx.device)
        return (pipe, pipe, pipe)


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
    embeddings of the conditioning's size scalars, or of (H, W, 0, 0, H,
    W) from the latent when it carries none."""
    dev = pipe.device
    pooled = cond.pooled
    if pooled is None:
        pooled = torch.zeros((1, 1280), device=dev)
    sc = cond.size_cond if cond.size_cond is not None else \
        (height, width, 0, 0, height, width)
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
class VAEEncode(Op):
    """Pixels -> latent through the pipeline's encoder (the mean)."""
    TYPE = "VAEEncode"

    def execute(self, ctx: OpContext, pixels, vae):
        lat = vae.vae_encode(as_device_image(pixels, vae.device))
        return ({"samples": DeviceLatent(lat)},)


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
class UpscaleModelLoader(Op):
    TYPE = "UpscaleModelLoader"
    WIDGETS = ["model_name"]

    def execute(self, ctx: OpContext, model_name: str):
        return (registry.load_upscaler(model_name, models_dir=ctx.models_dir,
                                       device=ctx.device),)


@register_op
class ImageUpscaleWithModel(Op):
    """Super-resolution of the whole image, or above ``TILE_THRESHOLD``
    input pixels over feathered overlapping tiles (``tiled_apply``)."""
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
                              upscale_model.scale, out_channels=img.shape[-1])
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
