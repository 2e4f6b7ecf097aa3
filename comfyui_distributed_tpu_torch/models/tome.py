"""Token merging (ToMe, tomesd) for the UNet's self-attention: the
port's copy of ``comfyui_distributed_tpu/models/tome.py``.

TomePatchModel merges the ``r`` most similar query tokens into their
nearest destination token before ``attn1`` and copies the result back
after it.  The destination grid is deterministic: the top-left token of
every 2x2 cell (tomesd's ``no_rand`` mode), as in the JAX package.  Only
the queries merge: keys and values stay whole, so a kept token's output
is the plain one and a merged token takes its destination's.  The
segment-mean of the merge is one ``index_add_`` on the device.
"""

from __future__ import annotations

from typing import Callable, Tuple

import numpy as np
import torch


def dst_grid_indices(h: int, w: int, sy: int = 2,
                     sx: int = 2) -> Tuple[np.ndarray, np.ndarray]:
    """Token indices of (dst, src) for an h x w grid: dst is the
    top-left token of each sy x sx cell, src every other token."""
    idx = np.arange(h * w).reshape(h, w)
    dst = idx[::sy, ::sx].reshape(-1)
    mask = np.zeros(h * w, bool)
    mask[dst] = True
    src = np.nonzero(~mask)[0]
    return dst, src


def build_merge(metric: torch.Tensor, h: int, w: int, ratio: float,
                sy: int = 2, sx: int = 2
                ) -> Tuple[Callable, Callable, int]:
    """-> (merge, unmerge, r).

    ``metric`` [B, N, C]: the similarity features (the block's normed
    hidden states).  ``merge(x)`` -> [B, N - r, C'], rows laid out
    [kept src; dst], each merged src token mean-pooled into its most
    similar dst.  ``unmerge(y)`` -> [B, N, C']: kept rows back to their
    places, a merged src row a copy of its dst's.  r = 0 returns
    identities."""
    B, N, _ = metric.shape
    if N != h * w:
        raise ValueError(f"ToMe: {N} tokens on a {h} x {w} grid")
    dst_np, src_np = dst_grid_indices(h, w, sy, sx)
    n_src, n_dst = src_np.shape[0], dst_np.shape[0]
    r = min(int(N * float(ratio)), n_src)
    if r <= 0:
        return (lambda x: x), (lambda y: y), 0
    dev = metric.device
    dst_idx = torch.as_tensor(dst_np, device=dev)
    src_idx = torch.as_tensor(src_np, device=dev)
    m = metric / torch.clamp(metric.norm(dim=-1, keepdim=True), min=1e-6)
    scores = torch.einsum("bsc,bdc->bsd", m[:, src_idx], m[:, dst_idx])
    node_max, node_idx = scores.max(dim=-1)         # [B, n_src] each
    order = torch.argsort(-node_max, dim=-1, stable=True)
    merged_sel = order[:, :r]                       # positions in src_idx
    kept_sel = order[:, r:]
    tgt = torch.gather(node_idx, 1, merged_sel)     # [B, r] -> dst slot
    kept_pos = src_idx[kept_sel]                    # [B, n_src - r]
    merged_pos = src_idx[merged_sel]                # [B, r]
    # each dst slot's count: 1 and its merged sources (the mean's divisor)
    rows = torch.arange(B, device=dev)[:, None]
    flat_tgt = (rows * n_dst + tgt).reshape(-1)

    def rows_of(x: torch.Tensor, sel: torch.Tensor) -> torch.Tensor:
        return torch.gather(x, 1, sel[..., None].expand(
            *sel.shape, x.shape[-1]))

    cnt = torch.ones(B * n_dst, dtype=metric.dtype, device=dev)
    cnt.index_add_(0, flat_tgt, torch.ones_like(flat_tgt,
                                                dtype=metric.dtype))

    def merge(x: torch.Tensor) -> torch.Tensor:
        C = x.shape[-1]
        src = x[:, src_idx]
        kept = rows_of(src, kept_sel)
        merged = rows_of(src, merged_sel)
        acc = x[:, dst_idx].reshape(B * n_dst, C).clone()
        acc.index_add_(0, flat_tgt, merged.reshape(B * r, C))
        pooled = acc / cnt.to(x.dtype)[:, None]
        return torch.cat([kept, pooled.reshape(B, n_dst, C)], dim=1)

    def unmerge(y: torch.Tensor) -> torch.Tensor:
        C = y.shape[-1]
        kept = y[:, :n_src - r]
        dst = y[:, n_src - r:]
        out = y.new_zeros((B, N, C))
        out[:, dst_idx] = dst
        out.scatter_(1, kept_pos[..., None].expand(B, n_src - r, C), kept)
        out.scatter_(1, merged_pos[..., None].expand(B, r, C),
                     rows_of(dst, tgt))
        return out

    return merge, unmerge, r
