"""Palette quantization without an imaging library: the counterpart of
the two Pillow passes of ImageQuantize in
``comfyui_distributed_tpu/ops/basic.py`` (``quantize(colors)`` for a
median-cut palette, then ``quantize(palette=..., dither=...)``).

- :func:`median_cut`: the palette, on the host over the image's distinct
  colours weighted by their counts.  The box with the largest summed
  squared error splits next, along its widest channel at the weighted
  median; each entry is its box's weighted mean.  An image with no more
  distinct colours than asked keeps them all, so it maps to itself.
- :func:`nearest_entries`: each pixel's nearest palette entry (squared
  RGB distance, the lower index on a tie) on any device, in exact
  integer arithmetic, so the CPU and the card agree to the bit.
- :func:`floyd_steinberg`: the dithered map on the host, one numpy
  pass an anti-diagonal: Floyd-Steinberg in raster order with Pillow's
  integer error arithmetic (errors in 1/16ths, truncated toward zero,
  each pixel clipped to [0, 255] before its lookup).

Pillow's median cut and its cached nearest-colour lookup are not
reproduced bit for bit; the result is held to the properties above and
to Pillow's error on the same image.
"""

from __future__ import annotations

import numpy as np
import torch


def median_cut(px: np.ndarray, colors: int) -> np.ndarray:
    """[N, 3] uint8 pixels -> a palette [K, 3] uint8, K <= ``colors``."""
    colors = max(int(colors), 1)
    packed = (px[:, 0].astype(np.int64) << 16) | (px[:, 1].astype(
        np.int64) << 8) | px[:, 2].astype(np.int64)
    keys, counts = np.unique(packed, return_counts=True)
    uniq = np.stack([keys >> 16, (keys >> 8) & 255, keys & 255], axis=1)
    if len(uniq) <= colors:
        return uniq.astype(np.uint8)
    w = counts.astype(np.float64)
    uf = uniq.astype(np.float64)
    uw = uf * w[:, None]
    boxes = [np.arange(len(uniq))]

    def sse(idx: np.ndarray) -> float:
        ww = w[idx]
        mean = uw[idx].sum(0) / ww.sum()
        return float((((uf[idx] - mean) ** 2).sum(1) * ww).sum())

    errs = [sse(boxes[0])]
    while len(boxes) < colors:
        k = int(np.argmax(errs))
        if errs[k] <= 0.0:
            break
        idx = boxes[k]
        c = uniq[idx]
        axis = int(np.argmax(c.max(0) - c.min(0)))
        order = idx[np.argsort(c[:, axis], kind="stable")]
        cum = np.cumsum(w[order])
        cut = int(np.searchsorted(cum, cum[-1] / 2.0)) + 1
        cut = min(max(cut, 1), len(order) - 1)
        lo, hi = order[:cut], order[cut:]
        boxes[k:k + 1] = [lo, hi]
        errs[k:k + 1] = [sse(lo), sse(hi)]
    pal = [np.floor((uniq[b] * w[b][:, None]).sum(0) / w[b].sum() + 0.5)
           for b in boxes]
    return np.clip(np.stack(pal), 0, 255).astype(np.uint8)


def nearest_entries(px: torch.Tensor, palette: torch.Tensor,
                    chunk: int = 1 << 16) -> torch.Tensor:
    """[N, 3] pixels (integer values 0-255, any dtype) -> [N] int64
    indices of their nearest ``palette`` [K, 3] entries, on ``px``'s
    device: the least |c|^2 - 2 p.c, whose integers stay below 2^24 in
    float32 (TF32 included), the first index on a tie."""
    p = px.to(torch.float32)
    pal = palette.to(p.device, torch.float32)
    norm, pal2 = (pal * pal).sum(1), 2.0 * pal.T
    out = [torch.argmin(norm - p[s:s + chunk] @ pal2, dim=1)
           for s in range(0, p.shape[0], chunk)]
    return torch.cat(out) if out else torch.zeros(0, dtype=torch.int64)


def floyd_steinberg(img: np.ndarray, palette: np.ndarray) -> np.ndarray:
    """[H, W, 3] uint8 -> [H, W] palette indices, dithered.

    Pixel (y, x) takes error from (y, x - 1) and from (y - 1, x - 1..x +
    1), so every pixel of one anti-diagonal ``x + 2 y = t`` depends only
    on earlier ones: the W + 2 H - 2 diagonals run in order, each as one
    numpy pass.  The errors are integers, so the sums do not depend on
    the order they are added in, and the result is raster order's."""
    h, w, _ = img.shape
    wp = w + 2
    src = img.astype(np.int32).reshape(-1, 3)
    pal = palette.astype(np.int32)
    # squared distance less the pixel's own norm: |c|^2 - 2 p.c, exact
    # integers below 2^24 in float32, so the lower index wins a tie
    norm = (pal.astype(np.float32) ** 2).sum(1)[None]
    pal2 = 2.0 * pal.T.astype(np.float32)
    # each pixel's error, [H + 1, W + 2] flattened: pixel (y, x) at row
    # y + 1, column x + 1, so that the row above and the columns beside
    # the edges read zeros
    err = np.zeros(((h + 1) * wp, 3), np.int32)
    out = np.zeros(h * w, np.int64)
    for t in range(w + 2 * h - 2):
        ys = np.arange(max(0, (t - w + 2) // 2), min(h - 1, t // 2) + 1)
        xs = t - 2 * ys
        up = ys * wp + xs           # (y - 1, x - 1)
        left = up + wp              # (y, x - 1)
        acc = 7 * err[left] + 3 * err[up + 2] + 5 * err[up + 1] + err[up]
        q = np.abs(acc) >> 4        # in 1/16ths, truncated toward zero
        at = ys * w + xs
        v = src[at] + np.where(acc < 0, -q, q)
        np.clip(v, 0, 255, out=v)
        i = np.argmin(norm - v.astype(np.float32) @ pal2, axis=1)
        out[at] = i
        err[left + 1] = v - pal[i]
    return out.reshape(h, w)
