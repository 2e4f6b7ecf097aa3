"""Tile grid math, masks and feathered blending: the counterpart of
``comfyui_distributed_tpu/ops/tiling.py``.

Grid and partition math is plain Python, as there.  Images are float32
[B, H, W, C] tensors on the run's device: windows are cut, resized and
blended there.  The tile mask is host numpy, uint8 exact: Pillow's
inclusive rectangle and its ``GaussianBlur``, three passes of a
fractional-radius box blur in 24-bit fixed point (``BoxBlur.c``),
reproduced here without Pillow.
"""

from __future__ import annotations

import functools
from typing import Callable, List, Sequence, Tuple

import numpy as np
import torch

from comfyui_distributed_tpu_torch.utils.image import resize_image

BLUR_PASSES = 3


def round_to_multiple(value: int, multiple: int = 8) -> int:
    return round(value / multiple) * multiple


def calculate_tiles(image_width: int, image_height: int,
                    tile_width: int, tile_height: int
                    ) -> List[Tuple[int, int]]:
    """Row-major (x, y) grid positions at tile-size steps."""
    return [(x, y)
            for y in range(0, image_height, tile_height)
            for x in range(0, image_width, tile_width)]


def partition_tiles(total_tiles: int, num_workers: int
                    ) -> List[List[int]]:
    """Contiguous tile-index ranges for [master, worker_0, ...]: each
    part gets ``total // (N + 1)``, the master one more if there is a
    remainder, workers with index < rem - 1 one more each."""
    n_parts = num_workers + 1
    per = total_tiles // n_parts
    rem = total_tiles % n_parts
    master_count = per + (1 if rem > 0 else 0)
    parts = [list(range(0, min(master_count, total_tiles)))]
    for i in range(num_workers):
        start = master_count + i * per
        if i < rem - 1:
            start += i
            end = start + per + 1
        else:
            start += max(rem - 1, 0)
            end = start + per
        parts.append(list(range(min(start, total_tiles),
                                min(end, total_tiles))))
    return parts


def extraction_region(x: int, y: int, tile_w: int, tile_h: int,
                      padding: int, width: int, height: int
                      ) -> Tuple[int, int, int, int]:
    """Clamped padded extraction bounds (x1, y1, x2, y2)."""
    return (max(0, x - padding), max(0, y - padding),
            min(width, x + tile_w + padding),
            min(height, y + tile_h + padding))


def pad_image_for_tiles(image: torch.Tensor, tile_w: int, tile_h: int,
                        padding: int) -> Tuple[torch.Tensor, int, int]:
    """Edge-replicate pad so every grid tile has a full ``(tile + 2 *
    padding)`` window; returns (padded, x offset, y offset) of the
    original (0, 0)."""
    _, h, w, _ = image.shape
    n_cols = -(-w // tile_w)
    n_rows = -(-h // tile_h)
    rows = torch.arange(-padding, n_rows * tile_h + padding,
                        device=image.device).clamp_(0, h - 1)
    cols = torch.arange(-padding, n_cols * tile_w + padding,
                        device=image.device).clamp_(0, w - 1)
    return image[:, rows][:, :, cols], padding, padding


def extract_tiles(image: torch.Tensor, positions: Sequence[Tuple[int, int]],
                  tile_w: int, tile_h: int, padding: int,
                  resize_method: str = "lanczos") -> torch.Tensor:
    """Fixed-size padded windows at ``positions``, resized to the
    processing size (lanczos for pixels, bilinear for a regional
    mask): [N, tile_h, tile_w, C]."""
    padded, ox, oy = pad_image_for_tiles(image, tile_w, tile_h, padding)
    stack = torch.stack([
        padded[0, y + oy - padding:y + oy + tile_h + padding,
               x + ox - padding:x + ox + tile_w + padding, :]
        for x, y in positions])
    if padding > 0:
        stack = resize_image(stack, tile_w, tile_h, resize_method)
    return stack.float()


def gaussian_blur_radius(radius: float) -> np.float32:
    """Pillow's ``_gaussian_blur_radius``: the box radius whose
    ``BLUR_PASSES`` box blurs have the Gaussian's variance, in its
    float32 arithmetic (double where Pillow takes a double)."""
    f = np.float32
    sigma2 = f(f(radius) * f(radius) / f(BLUR_PASSES))
    big_l = f(np.sqrt(12.0 * float(sigma2) + 1.0))
    small_l = f(np.floor((float(big_l) - 1.0) / 2.0))
    a = (f(2) * small_l + f(1)) * (small_l * (small_l + f(1))
                                   - f(3) * sigma2)
    a = a / (f(6) * (sigma2 - (small_l + f(1)) * (small_l + f(1))))
    return f(small_l + a)


def box_blur_rows(img: np.ndarray, radius: np.float32) -> np.ndarray:
    """One pass of Pillow's horizontal box blur of a uint8 image: edge
    pixels repeat, the 2r + 1 pixels of the window weigh ``ww`` and the
    two beyond it ``fw`` (24-bit fixed point), rounded half up."""
    r = int(radius)
    ww = int(np.float32(1 << 24) / (radius * np.float32(2) + np.float32(1)))
    fw = ((1 << 24) - (2 * r + 1) * ww) // 2
    w = img.shape[1]
    px = img[:, np.clip(np.arange(-r - 1, w + r + 1), 0, w - 1)] \
        .astype(np.int64)
    cs = np.concatenate([np.zeros((img.shape[0], 1), np.int64),
                         np.cumsum(px, axis=1)], axis=1)
    acc = cs[:, 2 * r + 2:2 * r + 2 + w] - cs[:, 1:1 + w]
    far = px[:, :w] + px[:, 2 * r + 2:2 * r + 2 + w]
    return ((acc * ww + far * fw + (1 << 23)) >> 24).astype(np.uint8)


def gaussian_blur(img: np.ndarray, radius: float) -> np.ndarray:
    """``ImageFilter.GaussianBlur(radius)`` of a uint8 [H, W] image: three
    box passes along the rows, then three along the columns."""
    if radius == 0:
        return img.copy()
    box = gaussian_blur_radius(radius)
    for _ in range(BLUR_PASSES):
        img = box_blur_rows(img, box)
    img = img.T
    for _ in range(BLUR_PASSES):
        img = box_blur_rows(img, box)
    return np.ascontiguousarray(img.T)


@functools.lru_cache(maxsize=128)
def _blurred_rect(image_width: int, image_height: int, x: int, y: int,
                  tile_w: int, tile_h: int, mask_blur: int
                  ) -> Tuple[Tuple[int, int], np.ndarray]:
    """((x0, y0), uint8 block) holding every non-zero pixel of the
    blurred mask.  The block reaches past the rectangle by more than the
    blur spreads (each box pass moves r + 1 pixels), so the pixels at its
    edge stay 0 through every pass and repeating them, as the blur does
    at an edge, gives what the full canvas gives."""
    reach = BLUR_PASSES * (int(gaussian_blur_radius(mask_blur)) + 2) \
        if mask_blur > 0 else 0
    x0, y0 = max(x - reach, 0), max(y - reach, 0)
    x1 = min(x + tile_w + 1 + reach, image_width)
    y1 = min(y + tile_h + 1 + reach, image_height)
    block = np.zeros((max(y1 - y0, 0), max(x1 - x0, 0)), np.uint8)
    # ImageDraw.rectangle fills both corners: tile_w + 1 by tile_h + 1
    block[max(y, 0) - y0:min(y + tile_h + 1, image_height) - y0,
          max(x, 0) - x0:min(x + tile_w + 1, image_width) - x0] = 255
    if mask_blur > 0 and block.size:
        block = gaussian_blur(block, mask_blur)
    block.flags.writeable = False
    return (x0, y0), block


def create_tile_mask(image_width: int, image_height: int, x: int, y: int,
                     tile_w: int, tile_h: int, mask_blur: int) -> np.ndarray:
    """Blurred white rectangle, full-image size, float32 [H, W] in [0, 1]:
    the pixels of Pillow's rectangle ``[x, y, x + tile_w, y + tile_h]``
    blurred by ``GaussianBlur(mask_blur)``, divided by 255."""
    return tile_mask_region(image_width, image_height, x, y, tile_w, tile_h,
                            mask_blur, (0, 0, image_width, image_height))


def tile_mask_region(image_width: int, image_height: int, x: int, y: int,
                     tile_w: int, tile_h: int, mask_blur: int,
                     region: Tuple[int, int, int, int]) -> np.ndarray:
    """:func:`create_tile_mask` cut to ``region`` (x1, y1, x2, y2)
    without building the full canvas; masks are cached by geometry."""
    (bx, by), block = _blurred_rect(image_width, image_height, x, y,
                                    tile_w, tile_h, mask_blur)
    x1, y1, x2, y2 = region
    out = np.zeros((y2 - y1, x2 - x1), np.uint8)
    cx1, cy1 = max(x1, bx), max(y1, by)
    cx2, cy2 = min(x2, bx + block.shape[1]), min(y2, by + block.shape[0])
    if cx2 > cx1 and cy2 > cy1:
        out[cy1 - y1:cy2 - y1, cx1 - x1:cx2 - x1] = \
            block[cy1 - by:cy2 - by, cx1 - bx:cx2 - bx]
    return out.astype(np.float32) / 255.0


def blend_tile(canvas: torch.Tensor, tile: torch.Tensor, x: int, y: int,
               tile_pos: Tuple[int, int], tile_w: int, tile_h: int,
               extracted_size: Tuple[int, int],
               mask_blur: int) -> torch.Tensor:
    """Alpha-composite one processed tile into ``canvas`` [H, W, C] IN
    PLACE (the JAX package returns a copy; one canvas serves every tile
    here) and return it.  ``(x, y)`` is the extraction position, where the
    tile is pasted; ``tile_pos`` is the grid position the mask rectangle
    sits at."""
    h, w, _ = canvas.shape
    ew, eh = extracted_size
    if (tile.shape[1], tile.shape[0]) != (ew, eh):
        tile = resize_image(tile[None], ew, eh)[0]
    x2, y2 = min(x + ew, w), min(y + eh, h)
    mask = torch.from_numpy(tile_mask_region(
        w, h, tile_pos[0], tile_pos[1], tile_w, tile_h, mask_blur,
        (x, y, x2, y2))).to(canvas.device)[:, :, None]
    region = canvas[y:y2, x:x2, :]
    region.copy_(tile[:y2 - y, :x2 - x, :] * mask + region * (1.0 - mask))
    return canvas


def feather_ramp(length: int, edge: int) -> np.ndarray:
    """1D blend weights: linear ramps over ``edge`` px at both ends."""
    w = np.ones(length, np.float32)
    e = min(edge, length // 2)
    if e > 0:
        ramp = (np.arange(e, dtype=np.float32) + 1.0) / (e + 1.0)
        w[:e] = ramp
        w[-e:] = ramp[::-1]
    return w


def make_feather_mask(width: int, height: int, edge: int) -> np.ndarray:
    """[H, W] accumulation weights for uniform overlapping tiles."""
    return np.outer(feather_ramp(height, edge), feather_ramp(width, edge))


def uniform_tile_starts(total: int, tile: int, overlap: int) -> list:
    """Unique clamped starts covering [0, total) with ``tile``-sized
    windows stepping ``tile - overlap``; the last start clamps to
    ``total - tile``."""
    if total <= tile:
        return [0]
    out, pos, step = [], 0, max(tile - overlap, 1)
    while pos + tile < total:
        out.append(pos)
        pos += step
    out.append(total - tile)
    return sorted(set(out))


TileFn = Callable[[torch.Tensor], torch.Tensor]


def tiled_apply_down(fn: TileFn, x: torch.Tensor, tile: int, overlap: int,
                     down: int, out_channels: int) -> torch.Tensor:
    """:func:`tiled_apply` for a downscaling ``fn`` ([B, th * down,
    tw * down, C] -> [B, th, tw, out_channels], the VAE encoder): windows
    laid out and blended in output coordinates."""
    b, h, w, _ = x.shape
    oh, ow = h // down, w // down
    th, tw = min(tile, oh), min(tile, ow)
    canvas = x.new_zeros((b, oh, ow, out_channels))
    weight = x.new_zeros((1, oh, ow, 1))
    mask = torch.from_numpy(make_feather_mask(tw, th, overlap)).to(
        x.device)[None, :, :, None]
    for y0 in uniform_tile_starts(oh, th, overlap):
        for x0 in uniform_tile_starts(ow, tw, overlap):
            out = fn(x[:, y0 * down:(y0 + th) * down,
                       x0 * down:(x0 + tw) * down, :]).float()
            canvas[:, y0:y0 + th, x0:x0 + tw] += out * mask
            weight[:, y0:y0 + th, x0:x0 + tw] += mask
    return canvas / weight.clamp(min=1e-8)


def tiled_apply(fn: TileFn, x: torch.Tensor, tile: int, overlap: int,
                scale: int, out_channels: int) -> torch.Tensor:
    """Apply ``fn`` ([B, th, tw, C] -> [B, th * scale, tw * scale,
    out_channels]) over uniform overlapping windows of ``x``,
    feather-blending in output space (the tiled super-resolution pass)."""
    b, h, w, _ = x.shape
    th, tw = min(tile, h), min(tile, w)
    canvas = x.new_zeros((b, h * scale, w * scale, out_channels))
    weight = x.new_zeros((1, h * scale, w * scale, 1))
    mask = torch.from_numpy(make_feather_mask(
        tw * scale, th * scale, overlap * scale)).to(x.device)[None, :, :,
                                                                None]
    for y0 in uniform_tile_starts(h, th, overlap):
        for x0 in uniform_tile_starts(w, tw, overlap):
            out = fn(x[:, y0:y0 + th, x0:x0 + tw, :]).float()
            ys, xs = y0 * scale, x0 * scale
            canvas[:, ys:ys + th * scale, xs:xs + tw * scale] += out * mask
            weight[:, ys:ys + th * scale, xs:xs + tw * scale] += mask
    return canvas / weight.clamp(min=1e-8)
