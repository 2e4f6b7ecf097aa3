"""UltimateSDUpscaleDistributed on one card: the counterpart of
``comfyui_distributed_tpu/ops/tiled_upscale.py`` at fanout 1.

The upscaled image is cut into a row-major grid of tiles, each widened
by ``padding`` (edges repeat) and resized to the tile size; all tiles are
refined as ONE batch (VAE-encode -> sampler at ``denoise`` -> VAE-decode,
tile ``i`` seeded ``seed + i`` with fold-in index 0, so a tile's result
does not depend on where it runs); each refined window is resized back,
cut to its clamped extraction region and alpha-blended into the image in
tile order through its blurred mask.  Every step but the masks (host
uint8, cached by geometry) runs on the run's device.

Not ported: the worker/master HTTP modes (a ``multi_job_id``), regional
conditioning and PerpNeg raise ``NotImplementedError``; the changed-tile
cache waits for the reuse plane (a single run misses every tile anyway,
so the image is the same).
"""

from __future__ import annotations

from typing import Any, Dict, List, Sequence, Tuple

import numpy as np
import torch

from comfyui_distributed_tpu_torch.ops import tiling
from comfyui_distributed_tpu_torch.ops.base import (
    CONTROL,
    Conditioning,
    DeviceImage,
    Op,
    OpContext,
    as_device_image,
    register_op,
    stage,
)
from comfyui_distributed_tpu_torch.ops.basic import _sdxl_vector_cond
from comfyui_distributed_tpu_torch.utils.image import resize_image


def _is_regional(c: Conditioning) -> bool:
    return bool(getattr(c, "siblings", ())
                or getattr(c, "area_mask", None) is not None
                or getattr(c, "timestep_range", None) is not None)


@register_op
class UltimateSDUpscaleDistributed(Op):
    TYPE = "UltimateSDUpscaleDistributed"
    WIDGETS = ["seed", CONTROL, "steps", "cfg", "sampler_name", "scheduler",
               "denoise", "tile_width", "tile_height", "padding", "mask_blur",
               "force_uniform_tiles"]
    DEFAULTS = {"steps": 20, "cfg": 8.0, "denoise": 0.5, "tile_width": 512,
                "tile_height": 512, "padding": 32, "mask_blur": 8,
                "force_uniform_tiles": True}
    HIDDEN = ["multi_job_id", "is_worker", "master_url",
              "enabled_worker_ids", "worker_id", "tile_indices",
              "dispatch_attempt"]

    def execute(self, ctx: OpContext, upscaled_image, model,
                positive: Conditioning, negative: Conditioning, vae,
                seed, steps, cfg, sampler_name, scheduler, denoise,
                tile_width, tile_height, padding, mask_blur,
                force_uniform_tiles=True, multi_job_id="", is_worker=None,
                master_url="", enabled_worker_ids="[]", worker_id="",
                tile_indices="", dispatch_attempt=0):
        if multi_job_id:
            raise NotImplementedError(
                "the tiled upscaler's worker/master HTTP modes are not "
                "ported yet; the torch package runs one process on one card")
        if _is_regional(positive) or _is_regional(negative):
            raise NotImplementedError(
                "regional conditioning in the tiled upscaler is not ported "
                "yet")
        if getattr(model, "perp_neg_cond", None) is not None:
            raise NotImplementedError(
                "PerpNeg in the tiled upscaler is not ported yet")
        image = as_device_image(upscaled_image, model.device)
        p = dict(seed=int(seed), steps=int(steps), cfg=float(cfg),
                 sampler_name=str(sampler_name), scheduler=str(scheduler),
                 denoise=float(denoise),
                 tile_w=tiling.round_to_multiple(int(tile_width)),
                 tile_h=tiling.round_to_multiple(int(tile_height)),
                 padding=int(padding), mask_blur=int(mask_blur))
        return (DeviceImage(self._run(ctx, image, model, positive, negative,
                                      p)),)

    def _run(self, ctx: OpContext, image: torch.Tensor, pipe,
             positive: Conditioning, negative: Conditioning,
             p: Dict[str, Any]) -> torch.Tensor:
        h, w = image.shape[1:3]
        all_tiles = tiling.calculate_tiles(w, h, p["tile_w"], p["tile_h"])
        with stage(ctx, "tile_extract"):
            tiles = tiling.extract_tiles(image, all_tiles, p["tile_w"],
                                         p["tile_h"], p["padding"])
        refined = self._refine_batch(ctx, pipe, tiles, range(len(all_tiles)),
                                     positive, negative, p)
        with stage(ctx, "tile_blend"):
            return self._blend_all(image, refined, all_tiles, p)

    def _refine_batch(self, ctx: OpContext, pipe, tiles: torch.Tensor,
                      tile_indices: Sequence[int], positive: Conditioning,
                      negative: Conditioning,
                      p: Dict[str, Any]) -> torch.Tensor:
        """VAE-encode -> sample(denoise) -> decode a [N, th, tw, C] tile
        batch in one go; tile ``i`` takes seed ``seed + i`` and fold-in
        index 0, as if it were a batch of one."""
        n = tiles.shape[0]
        seeds = np.asarray([p["seed"] + int(t) for t in tile_indices],
                           np.uint64)
        idx = np.zeros((n,), np.uint32)
        dev = pipe.device
        context = positive.context.to(dev).repeat(n, 1, 1)
        uncond = negative.context.to(dev).repeat(n, 1, 1)
        y = None
        if pipe.family.unet.adm_in_channels is not None:
            y = _sdxl_vector_cond(pipe, positive, n, tiles.shape[1],
                                  tiles.shape[2])
        with stage(ctx, "tile_encode"):
            lat = pipe.vae_encode(tiles)
        with stage(ctx, "tile_sample"):
            lat = pipe.sample(
                lat, context, uncond, seeds, steps=p["steps"], cfg=p["cfg"],
                sampler_name=p["sampler_name"], scheduler=p["scheduler"],
                denoise=p["denoise"], y=y, add_noise=True, sample_idx=idx)
        with stage(ctx, "tile_decode"):
            # clamped at the decode boundary, as the JAX package does
            return pipe.vae_decode(lat).clamp(0.0, 1.0)

    def _blend_all(self, image: torch.Tensor, refined: torch.Tensor,
                   all_tiles: List[Tuple[int, int]],
                   p: Dict[str, Any]) -> torch.Tensor:
        """Blend the refined windows (row ``i`` is tile ``i``) into a copy
        of the image in tile order: each window is resized back to its
        padded size, cut to its clamped extraction region and composited
        through the mask of its grid rectangle (without padding the tile
        is resized to its region instead)."""
        h, w = image.shape[1:3]
        tw, th, pad = p["tile_w"], p["tile_h"], p["padding"]
        if pad > 0:
            refined = resize_image(refined, tw + 2 * pad, th + 2 * pad)
        canvas = image[0].clone()
        for i, (x, y) in enumerate(all_tiles):
            x1, y1, x2, y2 = tiling.extraction_region(x, y, tw, th, pad,
                                                      w, h)
            tile = refined[i]
            if pad > 0:
                ox, oy = x1 - (x - pad), y1 - (y - pad)
                tile = tile[oy:oy + (y2 - y1), ox:ox + (x2 - x1), :]
            tiling.blend_tile(canvas, tile, x1, y1, (x, y), tw, th,
                              (x2 - x1, y2 - y1), p["mask_blur"])
        return canvas.clamp(0.0, 1.0)[None]
