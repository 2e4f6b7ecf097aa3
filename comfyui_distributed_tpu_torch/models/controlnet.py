"""ControlNet (Zhang et al.) in PyTorch: the counterpart of
``comfyui_distributed_tpu/models/controlnet.py``.

A trainable copy of the UNet's encoder that turns a spatial hint (an
edge map, a depth map...) into residuals for the paired UNet's skips and
middle.  Its submodules keep the UNet's own names (``conv_in``,
``down_{level}_res_{i}``, ``down_{level}_attn_{i}``, ``mid_res_0``...),
so ``models/weights.py`` and the checkpoint walk
(``models/checkpoints.py:_run_controlnet``) treat the shared structure as
they treat the UNet's, plus the hint ladder (``hint_conv_{i}``), one 1x1
``zero_conv_{i}`` a skip and the middle's ``mid_out``.

The attention of its transformers goes through the same CUDA kernel's
wrapper as the UNet's (``ops/kernels/flash_attention.py``).
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from comfyui_distributed_tpu_torch.models.layers import (
    Conv,
    Dense,
    Downsample,
    ResBlock,
    SpatialTransformer,
    timestep_embedding,
)
from comfyui_distributed_tpu_torch.models.unet import UNetConfig, mid_depth

# the hint ladder (torch ControlNet's input_hint_block: 8 convs, three
# stride-2 steps take the image-resolution hint down 8x to the latent's)
HINT_CHANNELS = (16, 16, 32, 32, 96, 96, 256)
HINT_STRIDES = (1, 1, 2, 1, 2, 1, 2)
# the ladder's last conv: ch output channels, zero in a fresh net
FINAL_HINT = f"hint_conv_{len(HINT_CHANNELS)}"


def is_zero_projection(name: str) -> bool:
    """Whether the top-level submodule ``name`` starts at zero in a fresh
    net (every zero conv, the middle's projection and the ladder's last
    conv), so that the net leaves the UNet as it is."""
    return name.startswith("zero_conv_") or name in ("mid_out", FINAL_HINT)


class ControlNet(nn.Module):
    """``forward(x, timesteps, context, hint, y) -> (skips, middle)``:
    the residuals for a UNet of the same config, in NCHW."""

    def __init__(self, cfg: UNetConfig):
        super().__init__()
        self.cfg = cfg
        dt = cfg.dtype
        ch = cfg.model_channels
        time_dim = ch * 4

        def heads(c: int) -> int:
            if cfg.num_heads is not None:
                return cfg.num_heads
            return max(c // cfg.num_head_channels, 1)

        self.time_fc1 = Dense(ch, time_dim, dtype=dt)
        self.time_fc2 = Dense(time_dim, time_dim, dtype=dt)
        if cfg.adm_in_channels is not None:
            self.label_fc1 = Dense(cfg.adm_in_channels, time_dim, dtype=dt)
            self.label_fc2 = Dense(time_dim, time_dim, dtype=dt)

        cin = 3
        for i, hc in enumerate(HINT_CHANNELS):
            self.add_module(f"hint_conv_{i}", Conv(
                cin, hc, 3, stride=HINT_STRIDES[i], padding=1, dtype=dt))
            cin = hc
        self.add_module(FINAL_HINT, Conv(cin, ch, 3, padding=1, dtype=dt))

        self.conv_in = Conv(cfg.in_channels, ch, 3, padding=1, dtype=dt)
        zero_ch = [ch]
        cur = ch
        for level, mult in enumerate(cfg.channel_mult):
            out_ch = ch * mult
            for i in range(cfg.num_res_blocks):
                self.add_module(f"down_{level}_res_{i}",
                                ResBlock(cur, out_ch, time_dim, dtype=dt))
                cur = out_ch
                if cfg.transformer_depth[level] > 0:
                    self.add_module(f"down_{level}_attn_{i}",
                                    SpatialTransformer(
                                        cur, heads(cur),
                                        cfg.transformer_depth[level],
                                        cfg.context_dim, dtype=dt))
                zero_ch.append(cur)
            if level != cfg.num_levels - 1:
                self.add_module(f"down_{level}_ds", Downsample(cur, dtype=dt))
                zero_ch.append(cur)
        for i, c in enumerate(zero_ch):
            self.add_module(f"zero_conv_{i}", Conv(c, c, 1, dtype=dt))
        self.n_skips = len(zero_ch)

        self.mid_res_0 = ResBlock(cur, cur, time_dim, dtype=dt)
        self.mid_attn = SpatialTransformer(cur, heads(cur), mid_depth(cfg),
                                           cfg.context_dim, dtype=dt)
        self.mid_res_1 = ResBlock(cur, cur, time_dim, dtype=dt)
        self.mid_out = Conv(cur, cur, 1, dtype=dt)

    def forward(self, x: torch.Tensor, timesteps: torch.Tensor,
                context: torch.Tensor, hint: torch.Tensor,
                y: Optional[torch.Tensor] = None
                ) -> Tuple[List[torch.Tensor], torch.Tensor]:
        """x: [B, h, w, C] the scaled latent the UNet sees; hint: [B, 8h,
        8w, 3] the control image in [0, 1]; timesteps, context and y as
        the UNet takes them.  Returns one residual a UNet skip (in
        down-path order) and the middle's, NCHW, in the config's
        dtype."""
        cfg = self.cfg
        emb = self.time_fc1(timestep_embedding(timesteps,
                                               cfg.model_channels))
        emb = self.time_fc2(F.silu(emb))
        if cfg.adm_in_channels is not None:
            if y is None:
                y = torch.zeros(x.shape[0], cfg.adm_in_channels,
                                dtype=x.dtype, device=x.device)
            emb = emb + self.label_fc2(F.silu(self.label_fc1(y)))

        g = hint.permute(0, 3, 1, 2)
        for i in range(len(HINT_CHANNELS)):
            g = F.silu(getattr(self, f"hint_conv_{i}")(g))
        g = getattr(self, FINAL_HINT)(g)

        h = self.conv_in(x.permute(0, 3, 1, 2)) + g
        outs = [self.zero_conv_0(h)]
        for level in range(cfg.num_levels):
            for i in range(cfg.num_res_blocks):
                h = getattr(self, f"down_{level}_res_{i}")(h, emb)
                if cfg.transformer_depth[level] > 0:
                    h = getattr(self, f"down_{level}_attn_{i}")(h, context)
                outs.append(getattr(self, f"zero_conv_{len(outs)}")(h))
            if level != cfg.num_levels - 1:
                h = getattr(self, f"down_{level}_ds")(h)
                outs.append(getattr(self, f"zero_conv_{len(outs)}")(h))

        h = self.mid_res_0(h, emb)
        h = self.mid_attn(h, context)
        h = self.mid_res_1(h, emb)
        return outs, self.mid_out(h)


@torch.no_grad()
def zero_projections(net: ControlNet) -> ControlNet:
    """Zero the leaves a fresh net starts at zero (the JAX loader's rule
    for a virtual net): the net then leaves the UNet exactly as it is."""
    for name, p in net.named_parameters():
        if is_zero_projection(name.split(".")[0]):
            p.zero_()
    return net
