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
- every attention of the UNet goes through the CUDA kernel's wrapper
  (``ops/kernels/flash_attention.py``).
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
    return nn.Parameter(torch.empty(*shape), requires_grad=False)


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
                context: Optional[torch.Tensor] = None) -> torch.Tensor:
        ctx = x if context is None else context
        B, N, _ = x.shape
        M = ctx.shape[1]
        h, d = self.num_heads, self.head_dim
        q = self.to_q(x).view(B, N, h, d)
        k = self.to_k(ctx).view(B, M, h, d)
        v = self.to_v(ctx).view(B, M, h, d)
        out = flash_attention(q, k, v)
        return self.to_out(out.reshape(B, N, h * d))


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


class TransformerBlock(nn.Module):
    """Self-attn -> cross-attn -> FF with pre-LN residuals."""

    def __init__(self, dim: int, num_heads: int, context_dim: int,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.norm1 = LayerNorm(dim)
        self.attn1 = Attention(dim, num_heads, dtype=dtype)
        self.norm2 = LayerNorm(dim)
        self.attn2 = Attention(dim, num_heads, context_dim=context_dim,
                               dtype=dtype)
        self.norm3 = LayerNorm(dim)
        self.ff = FeedForward(dim, dtype=dtype)

    def forward(self, x: torch.Tensor,
                context: torch.Tensor) -> torch.Tensor:
        x = x + self.attn1(self.norm1(x))
        x = x + self.attn2(self.norm2(x), context=context)
        return x + self.ff(self.norm3(x))


class SpatialTransformer(nn.Module):
    """NCHW map -> tokens -> transformer blocks with text cross-attention
    -> back to the map, plus the residual (the SD UNet attention block)."""

    def __init__(self, channels: int, num_heads: int, depth: int,
                 context_dim: int, dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        # CompVis Normalize: GroupNorm eps 1e-6 (ResBlock uses 1e-5)
        self.norm = GroupNorm32(channels, epsilon=1e-6)
        self.proj_in = Dense(channels, channels, dtype=dtype)
        self.depth = depth
        for i in range(depth):
            self.add_module(f"blocks_{i}", TransformerBlock(
                channels, num_heads, context_dim, dtype=dtype))
        self.proj_out = Dense(channels, channels, dtype=dtype)

    def forward(self, x: torch.Tensor,
                context: torch.Tensor) -> torch.Tensor:
        B, C, H, W = x.shape
        h = self.norm(x).permute(0, 2, 3, 1).reshape(B, H * W, C)
        h = self.proj_in(h)
        for i in range(self.depth):
            h = getattr(self, f"blocks_{i}")(h, context)
        h = self.proj_out(h)
        return x + h.reshape(B, H, W, C).permute(0, 3, 1, 2)


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
