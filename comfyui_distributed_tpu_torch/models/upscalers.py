"""Single-image super-resolution (ESRGAN's RRDB network) in PyTorch: the
counterpart of ``comfyui_distributed_tpu/models/upscalers.py``.

Images are NHWC in [0, 1] at :meth:`RRDBNet.forward`; the layers run
NCHW.  Convolutions compute in the config's dtype (bf16 on the real
config) with flax's cast rule (``models/layers.py``); the last one runs
in fp32 and the output is clipped to [0, 1].
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F
from torch import nn

from comfyui_distributed_tpu_torch.models.layers import Conv


@dataclasses.dataclass(frozen=True)
class RRDBConfig:
    num_features: int = 64
    num_blocks: int = 23
    growth: int = 32
    scale: int = 4
    dtype: torch.dtype = torch.bfloat16


ESRGAN_4X_CONFIG = RRDBConfig()
TINY_RRDB_CONFIG = RRDBConfig(num_features=16, num_blocks=2, growth=8, scale=2)

# upsampling stages (nearest x2, then a conv) per scale
_UPSAMPLES = {1: 0, 2: 1, 4: 2, 8: 3}


def _lrelu(x: torch.Tensor) -> torch.Tensor:
    return F.leaky_relu(x, 0.2)


class DenseBlock(nn.Module):
    """Five 3x3 convs, each seeing the input and every earlier output."""

    def __init__(self, channels: int, growth: int, dtype: torch.dtype):
        super().__init__()
        for i in range(4):
            self.add_module(f"conv{i}", Conv(channels + i * growth, growth,
                                             3, padding=1, dtype=dtype))
        self.conv4 = Conv(channels + 4 * growth, channels, 3, padding=1,
                          dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        feats = [x]
        for i in range(4):
            feats.append(_lrelu(getattr(self, f"conv{i}")(
                torch.cat(feats, dim=1))))
        return x + self.conv4(torch.cat(feats, dim=1)) * 0.2


class RRDB(nn.Module):
    def __init__(self, channels: int, growth: int, dtype: torch.dtype):
        super().__init__()
        for i in range(3):
            self.add_module(f"db{i}", DenseBlock(channels, growth, dtype))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = x
        for i in range(3):
            h = getattr(self, f"db{i}")(h)
        return x + h * 0.2


class RRDBNet(nn.Module):
    def __init__(self, cfg: RRDBConfig):
        super().__init__()
        if cfg.scale not in _UPSAMPLES:
            raise ValueError(f"RRDB scale {cfg.scale} not in "
                             f"{sorted(_UPSAMPLES)}")
        self.cfg = cfg
        dt, nf = cfg.dtype, cfg.num_features
        self.conv_first = Conv(3, nf, 3, padding=1, dtype=dt)
        for i in range(cfg.num_blocks):
            self.add_module(f"rrdb_{i}", RRDB(nf, cfg.growth, dt))
        self.trunk_conv = Conv(nf, nf, 3, padding=1, dtype=dt)
        for i in range(_UPSAMPLES[cfg.scale]):
            self.add_module(f"up_{i}", Conv(nf, nf, 3, padding=1, dtype=dt))
        self.hr_conv = Conv(nf, nf, 3, padding=1, dtype=dt)
        self.conv_last = Conv(nf, 3, 3, padding=1, dtype=torch.float32)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x [B, H, W, 3] in [0, 1] -> [B, H * scale, W * scale, 3]."""
        cfg = self.cfg
        fea = self.conv_first(x.permute(0, 3, 1, 2))
        h = fea
        for i in range(cfg.num_blocks):
            h = getattr(self, f"rrdb_{i}")(h)
        h = fea + self.trunk_conv(h)
        for i in range(_UPSAMPLES[cfg.scale]):
            h = _lrelu(getattr(self, f"up_{i}")(
                F.interpolate(h, scale_factor=2, mode="nearest")))
        out = self.conv_last(_lrelu(self.hr_conv(h)))
        return out.float().clamp(0.0, 1.0).permute(0, 2, 3, 1).contiguous()
