"""KL-VAE decoder (the SD latent codec's image side) in PyTorch: the
counterpart of ``comfyui_distributed_tpu/models/vae.py``.

Images are NHWC in [0, 1] and latents NHWC, scaled by ``scaling_factor``,
at :meth:`VAE.decode`; the layers run NCHW.  The encoder waits for a
later port slice (img2img).  The bottleneck attention is plain torch
math (fp32 scores): the JAX package has no kernel there either.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from comfyui_distributed_tpu_torch.models.layers import (
    Conv,
    Dense,
    GroupNorm32,
)


@dataclasses.dataclass(frozen=True)
class VAEConfig:
    base_channels: int = 128
    channel_mult: Tuple[int, ...] = (1, 2, 4, 4)
    num_res_blocks: int = 2
    latent_channels: int = 4
    scaling_factor: float = 0.18215
    dtype: torch.dtype = torch.bfloat16

    @property
    def downscale(self) -> int:
        return 2 ** (len(self.channel_mult) - 1)


SD_VAE_CONFIG = VAEConfig()
SDXL_VAE_CONFIG = VAEConfig(scaling_factor=0.13025)
TINY_VAE_CONFIG = VAEConfig(base_channels=16, channel_mult=(1, 2),
                            num_res_blocks=1, dtype=torch.float32)


class VAEResBlock(nn.Module):
    def __init__(self, in_channels: int, out_channels: int,
                 dtype: torch.dtype):
        super().__init__()
        self.norm1 = GroupNorm32(in_channels, epsilon=1e-6)
        self.conv1 = Conv(in_channels, out_channels, 3, padding=1,
                          dtype=dtype)
        self.norm2 = GroupNorm32(out_channels, epsilon=1e-6)
        self.conv2 = Conv(out_channels, out_channels, 3, padding=1,
                          dtype=dtype)
        self.skip = Conv(in_channels, out_channels, 1, dtype=dtype) \
            if in_channels != out_channels else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.conv1(F.silu(self.norm1(x)))
        h = self.conv2(F.silu(self.norm2(h)))
        if self.skip is not None:
            x = self.skip(x)
        return x + h


class VAEAttnBlock(nn.Module):
    """Single-head spatial self-attention at the bottleneck."""

    def __init__(self, channels: int, dtype: torch.dtype):
        super().__init__()
        self.norm = GroupNorm32(channels, epsilon=1e-6)
        self.q = Dense(channels, channels, dtype=dtype)
        self.k = Dense(channels, channels, dtype=dtype)
        self.v = Dense(channels, channels, dtype=dtype)
        self.proj_out = Dense(channels, channels, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, C, H, W = x.shape
        h = self.norm(x).permute(0, 2, 3, 1).reshape(B, H * W, C)
        q, k, v = self.q(h), self.k(h), self.v(h)
        logits = q.float() @ k.float().transpose(1, 2)
        w = torch.softmax(logits / math.sqrt(C), dim=-1)
        out = self.proj_out(w.to(v.dtype) @ v)
        return x + out.reshape(B, H, W, C).permute(0, 3, 1, 2)


class Decoder(nn.Module):
    def __init__(self, cfg: VAEConfig):
        super().__init__()
        self.cfg = cfg
        dt = cfg.dtype
        ch = cfg.base_channels * cfg.channel_mult[-1]
        self.conv_in = Conv(cfg.latent_channels, ch, 3, padding=1, dtype=dt)
        self.mid_res_0 = VAEResBlock(ch, ch, dt)
        self.mid_attn = VAEAttnBlock(ch, dt)
        self.mid_res_1 = VAEResBlock(ch, ch, dt)
        cur = ch
        for level in reversed(range(len(cfg.channel_mult))):
            out_ch = cfg.base_channels * cfg.channel_mult[level]
            for i in range(cfg.num_res_blocks + 1):
                self.add_module(f"up_{level}_res_{i}",
                                VAEResBlock(cur, out_ch, dt))
                cur = out_ch
            if level != 0:
                self.add_module(f"up_{level}_us",
                                Conv(cur, cur, 3, padding=1, dtype=dt))
        self.out_norm = GroupNorm32(cur, epsilon=1e-6)
        self.conv_out = Conv(cur, 3, 3, padding=1, dtype=torch.float32)

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        h = self.mid_res_1(self.mid_attn(self.mid_res_0(self.conv_in(z))))
        for level in reversed(range(len(cfg.channel_mult))):
            for i in range(cfg.num_res_blocks + 1):
                h = getattr(self, f"up_{level}_res_{i}")(h)
            if level != 0:
                h = getattr(self, f"up_{level}_us")(
                    F.interpolate(h, scale_factor=2, mode="nearest"))
        return self.conv_out(F.silu(self.out_norm(h))).float()


class VAE(nn.Module):
    """The decode side of the autoencoder: scaled latents -> images."""

    def __init__(self, cfg: VAEConfig):
        super().__init__()
        self.cfg = cfg
        self.decoder = Decoder(cfg)
        self.post_quant_conv = Conv(cfg.latent_channels, cfg.latent_channels,
                                    1, dtype=torch.float32)

    def decode(self, latents: torch.Tensor) -> torch.Tensor:
        """latents [B, h, w, C] -> images [B, H, W, 3] in [0, 1]."""
        z = latents.permute(0, 3, 1, 2) / self.cfg.scaling_factor
        x = self.decoder(self.post_quant_conv(z))
        return ((x + 1.0) / 2.0).clamp(0.0, 1.0).permute(0, 2, 3, 1)
