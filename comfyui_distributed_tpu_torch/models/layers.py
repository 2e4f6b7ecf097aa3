"""Shared neural blocks in PyTorch: the counterparts of
``comfyui_distributed_tpu/models/layers.py``.

Conventions carried over from the JAX package:

- the dtype rule of a flax layer with ``dtype=bf16``: it casts its input
  and its weights to the compute dtype and returns that dtype, while
  LayerNorm and GroupNorm compute in fp32 (GroupNorm returns its input's
  dtype, LayerNorm fp32).  Each layer here does the same with explicit
  ``.to()`` calls; there is no autocast;
- submodules keep the flax names (``to_q``, ``blocks_0``, ``in_norm``...),
  so weights map across mechanically (``models/weights.py``);
- feature maps are NCHW inside the modules (PyTorch's convolution layout);
  the UNet and VAE keep the JAX package's NHWC at their public functions;
- every attention of the UNet (the GLIGEN fusers' and ToMe's merged
  queries too) goes through the CUDA kernel's wrapper
  (``ops/kernels/flash_attention.py``), but one: under SAG's capture the
  middle block's first self-attention runs
  :meth:`Attention.forward_capture`, which materialises its fp32
  softmax weights, as the JAX package computes that layer outside
  Pallas.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from comfyui_distributed_tpu_torch.ops.kernels.flash_attention import (
    flash_attention)


def _param(*shape: int) -> nn.Parameter:
    return nn.Parameter(torch.empty(shape), requires_grad=False)


def timestep_embedding(t: torch.Tensor, dim: int,
                       max_period: float = 10000.0) -> torch.Tensor:
    """Sinusoidal timestep embedding (DDPM convention), fp32."""
    half = dim // 2
    freqs = torch.exp(-math.log(max_period)
                      * torch.arange(half, dtype=torch.float32,
                                     device=t.device) / half)
    args = t.float()[:, None] * freqs[None, :]
    emb = torch.cat([torch.cos(args), torch.sin(args)], dim=-1)
    if dim % 2:
        emb = torch.cat([emb, torch.zeros_like(emb[:, :1])], dim=-1)
    return emb


class Dense(nn.Module):
    """flax ``nn.Dense``: ``x @ W + b`` over the last axis in ``dtype``.
    ``weight`` is [out, in] (the flax kernel is [in, out])."""

    def __init__(self, in_features: int, out_features: int,
                 bias: bool = True, dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.weight = _param(out_features, in_features)
        self.bias = _param(out_features) if bias else None
        self.dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.dtype
        bias = None if self.bias is None else self.bias.to(dt)
        return F.linear(x.to(dt), self.weight.to(dt), bias)


class Conv(nn.Module):
    """flax ``nn.Conv`` on NCHW maps in ``dtype``; ``weight`` is OIHW
    (the flax kernel is HWIO).  ``padding`` pads both sides."""

    def __init__(self, in_channels: int, out_channels: int,
                 kernel_size: int, stride: int = 1, padding: int = 0,
                 dtype: torch.dtype = torch.bfloat16, bias: bool = True):
        super().__init__()
        self.weight = _param(out_channels, in_channels, kernel_size,
                             kernel_size)
        self.bias = _param(out_channels) if bias else None
        self.stride = stride
        self.padding = padding
        self.dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.dtype
        bias = None if self.bias is None else self.bias.to(dt)
        return F.conv2d(x.to(dt), self.weight.to(dt), bias,
                        stride=self.stride, padding=self.padding)


class LayerNorm(nn.Module):
    """flax ``nn.LayerNorm(dtype=float32)``: fp32 in, fp32 out."""

    def __init__(self, dim: int, epsilon: float = 1e-5):
        super().__init__()
        self.weight = _param(dim)
        self.bias = _param(dim)
        self.epsilon = epsilon

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.layer_norm(x.float(), (x.shape[-1],), self.weight.float(),
                            self.bias.float(), self.epsilon)


class GroupNorm32(nn.Module):
    """GroupNorm over NCHW channels computed in fp32, returned in the
    input's dtype.  Groups: 32, or the largest count below it that
    divides the channels."""

    def __init__(self, channels: int, num_groups: int = 32,
                 epsilon: float = 1e-5):
        super().__init__()
        groups = min(num_groups, channels)
        while channels % groups:
            groups -= 1
        self.groups = groups
        self.weight = _param(channels)
        self.bias = _param(channels)
        self.epsilon = epsilon

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = F.group_norm(x.float(), self.groups, self.weight.float(),
                           self.bias.float(), self.epsilon)
        return out.to(x.dtype)


class Attention(nn.Module):
    """Multi-head attention over tokens [B, N, C]: self-attention when
    ``context`` is None, cross-attention on context [B, M, Cc] otherwise.
    The attention itself is the CUDA kernel (CPU tensors: its plain
    version)."""

    def __init__(self, dim: int, num_heads: int,
                 context_dim: Optional[int] = None,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.num_heads = num_heads
        self.head_dim = dim // num_heads
        inner = self.head_dim * num_heads
        ctx_dim = dim if context_dim is None else context_dim
        self.to_q = Dense(dim, inner, bias=False, dtype=dtype)
        self.to_k = Dense(ctx_dim, inner, bias=False, dtype=dtype)
        self.to_v = Dense(ctx_dim, inner, bias=False, dtype=dtype)
        self.to_out = Dense(inner, dim, dtype=dtype)

    def forward(self, x: torch.Tensor,
                context: Optional[torch.Tensor] = None,
                context_v: Optional[torch.Tensor] = None) -> torch.Tensor:
        """``context_v``: a separate value-side context (a hypernetwork
        transforms the key and value streams apart); ``context`` by
        default."""
        ctx = x if context is None else context
        ctx_v = ctx if context_v is None else context_v
        B, N, _ = x.shape
        M = ctx.shape[1]
        h, d = self.num_heads, self.head_dim
        q = self.to_q(x).view(B, N, h, d)
        k = self.to_k(ctx).view(B, M, h, d)
        v = self.to_v(ctx_v).view(B, M, h, d)
        out = flash_attention(q, k, v)
        return self.to_out(out.reshape(B, N, h * d))

    def forward_capture(self, x: torch.Tensor):
        """Self-attention with its softmax weights materialised: (output,
        weights [B, heads, N, N] in fp32).  SAG's capture of the middle
        block (a few dozen tokens), as the JAX layer's ``sow_probs``:
        fp32 logits at scale 1/sqrt(D), an fp32 softmax, the weights cast
        to v's dtype for the product.  It launches no kernel."""
        B, N, _ = x.shape
        h, d = self.num_heads, self.head_dim
        q = self.to_q(x).view(B, N, h, d)
        k = self.to_k(x).view(B, N, h, d)
        v = self.to_v(x).view(B, N, h, d)
        logits = torch.einsum("bnhd,bmhd->bhnm", q.float(), k.float()) \
            * (1.0 / math.sqrt(d))
        weights = torch.softmax(logits, dim=-1)
        out = torch.einsum("bhnm,bmhd->bnhd", weights.to(v.dtype), v)
        return self.to_out(out.reshape(B, N, h * d)), weights


class GEGLU(nn.Module):
    """Gated GELU projection with the exact (erf) gelu."""

    def __init__(self, dim: int, dim_out: int,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.proj = Dense(dim, dim_out * 2, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        a, b = self.proj(x).chunk(2, dim=-1)
        return a * F.gelu(b)


class FeedForward(nn.Module):
    def __init__(self, dim: int, mult: int = 4,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.geglu = GEGLU(dim, dim * mult, dtype=dtype)
        self.out = Dense(dim * mult, dim, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.out(self.geglu(x))


class GatedSelfAttention(nn.Module):
    """The GLIGEN fuser (GatedSelfAttentionDense): self-attention over
    [visual tokens; grounding tokens] and a feed-forward, each gated by
    tanh of a learned scalar, so a fuser with zero gates leaves the
    image as it is (its attention still runs).  The grounding tokens are
    projected from their ``objs_dim`` to the block's width first
    (``linear``)."""

    # parameters the weight bridge carries under their own flax names
    FLAX_RAW = ("alpha_attn", "alpha_dense")

    def __init__(self, dim: int, num_heads: int, objs_dim: int,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.linear = Dense(objs_dim, dim, dtype=dtype)
        self.alpha_attn = _param()
        self.alpha_dense = _param()
        self.norm1 = LayerNorm(dim)
        self.attn = Attention(dim, num_heads, dtype=dtype)
        self.norm2 = LayerNorm(dim)
        self.ff = FeedForward(dim, dtype=dtype)

    def forward(self, x: torch.Tensor, objs: torch.Tensor) -> torch.Tensor:
        n = x.shape[1]
        o = self.linear(objs)
        h = self.norm1(torch.cat([x, o.to(x.dtype)], dim=1))
        att = self.attn(h)[:, :n]
        x = x + torch.tanh(self.alpha_attn.float()).to(x.dtype) * att
        return x + torch.tanh(self.alpha_dense.float()).to(x.dtype) \
            * self.ff(self.norm2(x))


class TransformerBlock(nn.Module):
    """Self-attn -> (the GLIGEN fuser) -> cross-attn -> FF with pre-LN
    residuals.  ``gligen`` > 0 builds the fuser for grounding tokens of
    that width."""

    def __init__(self, dim: int, num_heads: int, context_dim: int,
                 dtype: torch.dtype = torch.bfloat16, gligen: int = 0):
        super().__init__()
        self.norm1 = LayerNorm(dim)
        self.attn1 = Attention(dim, num_heads, dtype=dtype)
        self.gligen = int(gligen)
        if self.gligen:
            self.fuser = GatedSelfAttention(dim, num_heads, self.gligen,
                                            dtype=dtype)
        self.norm2 = LayerNorm(dim)
        self.attn2 = Attention(dim, num_heads, context_dim=context_dim,
                               dtype=dtype)
        self.norm3 = LayerNorm(dim)
        self.ff = FeedForward(dim, dtype=dtype)

    def forward(self, x: torch.Tensor, context: torch.Tensor,
                capture: bool = False,
                context_v: Optional[torch.Tensor] = None,
                objs: Optional[torch.Tensor] = None,
                tome_ratio: float = 0.0, hw: Optional[tuple] = None):
        """``capture``: attn1 through :meth:`Attention.forward_capture`,
        returning (output, attn1's weights).  ``context_v``: attn2's
        value context (a hypernetwork's).  ``objs`` [B, n, gligen]: the
        fuser's grounding tokens (None: one zero token).  ``tome_ratio``
        with the token grid ``hw`` (ToMe, ``models/tome.py``): attn1's
        queries merge, the merged ones attend the whole token set, and
        the outputs unmerge; not under ``capture``."""
        probs = None
        xn = self.norm1(x)
        if capture:
            a, probs = self.attn1.forward_capture(xn)
            x = x + a
        elif tome_ratio > 0.0 and hw is not None:
            from comfyui_distributed_tpu_torch.models.tome import build_merge
            merge, unmerge, r = build_merge(xn, hw[0], hw[1], tome_ratio)
            x = x + (unmerge(self.attn1(merge(xn), context=xn)) if r > 0
                     else self.attn1(xn))
        else:
            x = x + self.attn1(xn)
        if self.gligen:
            o = objs if objs is not None else torch.zeros(
                (x.shape[0], 1, self.gligen), dtype=x.dtype, device=x.device)
            x = self.fuser(x, o)
        x = x + self.attn2(self.norm2(x), context=context,
                           context_v=context_v)
        x = x + self.ff(self.norm3(x))
        return (x, probs) if capture else x


def _hypertile_divisor(n: int, min_tile: int) -> int:
    """Largest divisor d of n with n // d >= min_tile: the most tiling
    that keeps tiles at least ``min_tile`` on a side (the JAX package's
    deterministic rule)."""
    best = 1
    for d in range(1, n + 1):
        if n % d == 0 and n // d >= min_tile:
            best = d
    return best


class SpatialTransformer(nn.Module):
    """NCHW map -> tokens -> transformer blocks with text cross-attention
    -> back to the map, plus the residual (the SD UNet attention block).

    ``hypertile_tile`` > 0 (HyperTile): the token grid splits into
    spatial tiles of at least that many latent units a side, which ride
    the batch axis through the blocks (the context repeats per tile), so
    self-attention costs O(tiles * (N / tiles)^2); the tiles go to the
    same attention kernel at the folded batch.  ``capture`` (SAG): the
    first block's attn1 returns its softmax weights, and the forward
    returns (output, weights); a folded grid raises under it.
    ``context_v`` (a hypernetwork's value context) and ``objs`` (GLIGEN's
    grounding tokens, ``gligen`` > 0 builds the fusers) repeat per tile
    as the context does; ``tome_ratio`` merges every block's attn1
    queries on the (tile's) token grid."""

    def __init__(self, channels: int, num_heads: int, depth: int,
                 context_dim: int, dtype: torch.dtype = torch.bfloat16,
                 gligen: int = 0):
        super().__init__()
        # CompVis Normalize: GroupNorm eps 1e-6 (ResBlock uses 1e-5)
        self.norm = GroupNorm32(channels, epsilon=1e-6)
        self.proj_in = Dense(channels, channels, dtype=dtype)
        self.depth = depth
        for i in range(depth):
            self.add_module(f"blocks_{i}", TransformerBlock(
                channels, num_heads, context_dim, dtype=dtype,
                gligen=gligen))
        self.proj_out = Dense(channels, channels, dtype=dtype)

    def forward(self, x: torch.Tensor, context: torch.Tensor,
                hypertile_tile: int = 0, capture: bool = False,
                context_v: Optional[torch.Tensor] = None,
                objs: Optional[torch.Tensor] = None,
                tome_ratio: float = 0.0):
        B, C, H, W = x.shape
        h = self.norm(x).permute(0, 2, 3, 1).reshape(B, H * W, C)
        h = self.proj_in(h)
        nh = nw = 1
        if hypertile_tile > 0:
            nh = _hypertile_divisor(H, hypertile_tile)
            nw = _hypertile_divisor(W, hypertile_tile)
        th, tw = H // nh, W // nw
        if nh * nw > 1:
            if capture:
                raise ValueError("SAG's capture takes an unfolded token "
                                 "grid; HyperTile folds this block")
            h = h.reshape(B, nh, th, nw, tw, C).transpose(2, 3) \
                .reshape(B * nh * nw, th * tw, C)
            context = context.repeat_interleave(nh * nw, dim=0)
            if context_v is not None:
                context_v = context_v.repeat_interleave(nh * nw, dim=0)
            if objs is not None:
                objs = objs.repeat_interleave(nh * nw, dim=0)
        probs = None
        kw = dict(context_v=context_v, objs=objs, tome_ratio=tome_ratio,
                  hw=(th, tw))
        for i in range(self.depth):
            if capture and i == 0:
                h, probs = self.blocks_0(h, context, capture=True, **kw)
            else:
                h = getattr(self, f"blocks_{i}")(h, context, **kw)
        if nh * nw > 1:
            h = h.reshape(B, nh, nw, th, tw, C).transpose(2, 3) \
                .reshape(B, H * W, C)
        h = self.proj_out(h)
        out = x + h.reshape(B, H, W, C).permute(0, 3, 1, 2)
        return (out, probs) if capture else out


class ResBlock(nn.Module):
    """UNet residual block with timestep-embedding injection."""

    def __init__(self, in_channels: int, out_channels: int, emb_dim: int,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.in_norm = GroupNorm32(in_channels)
        self.in_conv = Conv(in_channels, out_channels, 3, padding=1,
                            dtype=dtype)
        self.emb_proj = Dense(emb_dim, out_channels, dtype=dtype)
        self.out_norm = GroupNorm32(out_channels)
        self.out_conv = Conv(out_channels, out_channels, 3, padding=1,
                             dtype=dtype)
        self.skip = Conv(in_channels, out_channels, 1, dtype=dtype) \
            if in_channels != out_channels else None

    def forward(self, x: torch.Tensor, emb: torch.Tensor) -> torch.Tensor:
        h = self.in_conv(F.silu(self.in_norm(x)))
        h = h + self.emb_proj(F.silu(emb))[:, :, None, None]
        h = self.out_conv(F.silu(self.out_norm(h)))
        if self.skip is not None:
            x = self.skip(x)
        return x + h


class Downsample(nn.Module):
    def __init__(self, channels: int, dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.conv = Conv(channels, channels, 3, stride=2, padding=1,
                         dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(x)


class Upsample(nn.Module):
    """Nearest-neighbour 2x, then a 3x3 conv."""

    def __init__(self, channels: int, dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.conv = Conv(channels, channels, 3, padding=1, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(F.interpolate(x, scale_factor=2, mode="nearest"))
