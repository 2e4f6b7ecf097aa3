"""Diffusion UNet (SD1.x, SD2.x and SDXL families) in PyTorch: the counterpart of
``comfyui_distributed_tpu/models/unet.py``.

The forward takes and returns the JAX package's NHWC layout (x [B, H, W,
C]) and runs NCHW inside.  Eps-prediction by default; the denoiser
(``models/denoiser.py``) wraps it into ``denoised = f(x, sigma)``.  The
model patches of the JAX UNet (FreeU, HyperTile, deep shrink, ToMe,
GLIGEN, SAG capture, ControlNet residuals) are not ported yet and raise.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from comfyui_distributed_tpu_torch.models.layers import (
    Conv,
    Dense,
    Downsample,
    GroupNorm32,
    ResBlock,
    SpatialTransformer,
    Upsample,
    timestep_embedding,
)


@dataclasses.dataclass(frozen=True)
class UNetConfig:
    in_channels: int = 4
    out_channels: int = 4
    model_channels: int = 320
    channel_mult: Tuple[int, ...] = (1, 2, 4, 4)
    num_res_blocks: int = 2
    # transformer depth per level; 0 = no attention at that level
    transformer_depth: Tuple[int, ...] = (1, 1, 1, 0)
    context_dim: int = 768
    num_head_channels: int = 64
    num_heads: Optional[int] = None  # fixed head count overrides head_channels
    # middle-block depth; None = max(transformer_depth[-1], 1)
    transformer_depth_middle: Optional[int] = None
    # SDXL class/vector conditioning (pooled text + size embeddings)
    adm_in_channels: Optional[int] = None
    # checkpoint-layout metadata: torch checkpoints store the transformer
    # proj_in/proj_out as 1x1 convs (SD1.x) or Linear (SDXL); both are Dense
    use_linear_in_transformer: bool = False
    # model patches of the JAX UNet that wait for a later port slice
    freeu: Optional[Tuple[float, float, float, float]] = None
    hypertile: Optional[Tuple[int, int, bool]] = None
    sag_capture: bool = False
    deep_shrink: Optional[Tuple[int, float]] = None
    tome_ratio: float = 0.0
    gligen: int = 0
    dtype: torch.dtype = torch.bfloat16
    prediction_type: str = "eps"  # "eps" | "v"

    @property
    def num_levels(self) -> int:
        return len(self.channel_mult)


# SD1.5 uses a fixed 8 heads at every resolution (not head_channels=64)
SD15_CONFIG = UNetConfig(num_heads=8)

SDXL_CONFIG = UNetConfig(
    channel_mult=(1, 2, 4),
    transformer_depth=(0, 2, 10),
    context_dim=2048,
    adm_in_channels=2816,
    use_linear_in_transformer=True,
)

# SDXL refiner: 384 base channels over four levels, depth-4 transformers
# at the two middle levels and in the middle block, the bigG context
# (1280), and an ADM of the pooled bigG output (1280) plus five 256-wide
# size embeddings (height, width, crop_h, crop_w, aesthetic score)
SDXL_REFINER_CONFIG = UNetConfig(
    model_channels=384,
    channel_mult=(1, 2, 4, 4),
    transformer_depth=(0, 4, 4, 0),
    transformer_depth_middle=4,
    context_dim=1280,
    adm_in_channels=2560,
    use_linear_in_transformer=True,
)

# SD2.1: the SD1.x topology with 64-channel heads at every level (5, 10
# and 20 heads), the OpenCLIP-H context (1024) and Linear transformer
# projections; the 768-v line predicts v, the 512-base line eps
SD21_CONFIG = UNetConfig(
    context_dim=1024,
    use_linear_in_transformer=True,
    prediction_type="v",
)
SD21_BASE_CONFIG = dataclasses.replace(SD21_CONFIG, prediction_type="eps")

TINY_CONFIG = UNetConfig(
    model_channels=32,
    channel_mult=(1, 2),
    num_res_blocks=1,
    transformer_depth=(1, 1),
    context_dim=64,
    num_head_channels=16,
    dtype=torch.float32,  # exact CPU comparisons; real families use bf16
)

_PATCHES = ("freeu", "hypertile", "sag_capture", "deep_shrink",
            "tome_ratio", "gligen")


def mid_depth(cfg: UNetConfig) -> int:
    """Middle-block transformer depth."""
    if cfg.transformer_depth_middle is not None:
        return int(cfg.transformer_depth_middle)
    return max(cfg.transformer_depth[-1], 1)


class UNet(nn.Module):
    def __init__(self, cfg: UNetConfig):
        super().__init__()
        unported = [p for p in _PATCHES if getattr(cfg, p)]
        if unported:
            raise NotImplementedError(
                f"UNet patches {unported} are not ported to the torch "
                "package yet")
        self.cfg = cfg
        dt = cfg.dtype
        ch = cfg.model_channels
        time_dim = ch * 4

        def heads(c: int) -> int:
            if cfg.num_heads is not None:
                return cfg.num_heads
            return max(c // cfg.num_head_channels, 1)

        def attn(c: int, depth: int) -> SpatialTransformer:
            return SpatialTransformer(c, heads(c), depth, cfg.context_dim,
                                      dtype=dt)

        self.time_fc1 = Dense(ch, time_dim, dtype=dt)
        self.time_fc2 = Dense(time_dim, time_dim, dtype=dt)
        if cfg.adm_in_channels is not None:
            self.label_fc1 = Dense(cfg.adm_in_channels, time_dim, dtype=dt)
            self.label_fc2 = Dense(time_dim, time_dim, dtype=dt)
        self.conv_in = Conv(cfg.in_channels, ch, 3, padding=1, dtype=dt)

        skip_ch = [ch]
        cur = ch
        for level, mult in enumerate(cfg.channel_mult):
            out_ch = ch * mult
            for i in range(cfg.num_res_blocks):
                self.add_module(f"down_{level}_res_{i}",
                                ResBlock(cur, out_ch, time_dim, dtype=dt))
                cur = out_ch
                if cfg.transformer_depth[level] > 0:
                    self.add_module(f"down_{level}_attn_{i}",
                                    attn(cur, cfg.transformer_depth[level]))
                skip_ch.append(cur)
            if level != cfg.num_levels - 1:
                self.add_module(f"down_{level}_ds", Downsample(cur, dtype=dt))
                skip_ch.append(cur)

        self.mid_res_0 = ResBlock(cur, cur, time_dim, dtype=dt)
        self.mid_attn = attn(cur, mid_depth(cfg))
        self.mid_res_1 = ResBlock(cur, cur, time_dim, dtype=dt)

        for level in reversed(range(cfg.num_levels)):
            out_ch = ch * cfg.channel_mult[level]
            for i in range(cfg.num_res_blocks + 1):
                self.add_module(
                    f"up_{level}_res_{i}",
                    ResBlock(cur + skip_ch.pop(), out_ch, time_dim, dtype=dt))
                cur = out_ch
                if cfg.transformer_depth[level] > 0:
                    self.add_module(f"up_{level}_attn_{i}",
                                    attn(cur, cfg.transformer_depth[level]))
            if level != 0:
                self.add_module(f"up_{level}_us", Upsample(cur, dtype=dt))

        self.out_norm = GroupNorm32(cur)
        self.conv_out = Conv(cur, cfg.out_channels, 3, padding=1,
                             dtype=torch.float32)

    def forward(self, x: torch.Tensor, timesteps: torch.Tensor,
                context: torch.Tensor,
                y: Optional[torch.Tensor] = None,
                control=None) -> torch.Tensor:
        """x: [B, H, W, C_in] latent; timesteps: [B]; context: [B, M, Cc]
        text tokens; y: [B, adm_in] vector conditioning (SDXL).  Returns
        the fp32 prediction [B, H, W, C_out].  ControlNet residuals
        (``control``) are not ported yet."""
        if control is not None:
            raise NotImplementedError(
                "ControlNet residuals are not ported to the torch package "
                "yet")
        cfg = self.cfg
        emb = self.time_fc1(timestep_embedding(timesteps,
                                               cfg.model_channels))
        emb = self.time_fc2(F.silu(emb))
        if cfg.adm_in_channels is not None:
            if y is None:
                y = torch.zeros(x.shape[0], cfg.adm_in_channels,
                                dtype=x.dtype, device=x.device)
            emb = emb + self.label_fc2(F.silu(self.label_fc1(y)))

        h = self.conv_in(x.permute(0, 3, 1, 2))
        skips = [h]
        for level in range(cfg.num_levels):
            for i in range(cfg.num_res_blocks):
                h = getattr(self, f"down_{level}_res_{i}")(h, emb)
                if cfg.transformer_depth[level] > 0:
                    h = getattr(self, f"down_{level}_attn_{i}")(h, context)
                skips.append(h)
            if level != cfg.num_levels - 1:
                h = getattr(self, f"down_{level}_ds")(h)
                skips.append(h)

        h = self.mid_res_0(h, emb)
        h = self.mid_attn(h, context)
        h = self.mid_res_1(h, emb)

        for level in reversed(range(cfg.num_levels)):
            for i in range(cfg.num_res_blocks + 1):
                h = torch.cat([h, skips.pop()], dim=1)
                h = getattr(self, f"up_{level}_res_{i}")(h, emb)
                if cfg.transformer_depth[level] > 0:
                    h = getattr(self, f"up_{level}_attn_{i}")(h, context)
            if level != 0:
                h = getattr(self, f"up_{level}_us")(h)

        h = self.conv_out(F.silu(self.out_norm(h)))
        return h.float().permute(0, 2, 3, 1)
