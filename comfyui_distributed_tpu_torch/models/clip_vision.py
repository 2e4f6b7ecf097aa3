"""CLIP vision transformer (ViT) in PyTorch: the counterpart of
``comfyui_distributed_tpu/models/clip_vision.py``, the image tower
behind CLIPVisionLoader, CLIPVisionEncode and unCLIPConditioning.

Patchify conv -> [class token; patches] + position embeddings -> pre-LN
-> the text tower's :class:`CLIPLayer` with a zero mask -> post-LN of
the class token -> visual projection.  The projected class embedding is
what unCLIP models take as their image conditioning.  The attention is
the text tower's plain torch math, as in the JAX package (257 tokens at
ViT-H's 224^2 input).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch
from torch import nn

from comfyui_distributed_tpu_torch.models.clip import CLIPConfig, CLIPLayer
from comfyui_distributed_tpu_torch.models.layers import (
    Conv,
    Dense,
    LayerNorm,
    _param,
)
from comfyui_distributed_tpu_torch.utils.image import resize_image

# OpenAI CLIP's normalisation
CLIP_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_STD = (0.26862954, 0.26130258, 0.27577711)


@dataclasses.dataclass(frozen=True)
class CLIPVisionConfig:
    width: int = 1280
    layers: int = 32
    heads: int = 16
    patch: int = 14
    image_size: int = 224
    projection_dim: int = 1024
    act: str = "gelu"
    dtype: torch.dtype = torch.float32


# ViT-H/14, SD2.1-unclip-h's image tower (1024-d projected embeddings)
VIT_H_CONFIG = CLIPVisionConfig()
# ViT-L/14 (768-d)
VIT_L_CONFIG = CLIPVisionConfig(width=1024, layers=24, heads=16,
                                projection_dim=768, act="quick_gelu")
TINY_VISION_CONFIG = CLIPVisionConfig(width=64, layers=2, heads=4,
                                      patch=16, image_size=64,
                                      projection_dim=32)


class CLIPVisionModel(nn.Module):
    def __init__(self, cfg: CLIPVisionConfig):
        super().__init__()
        self.cfg = cfg
        w = cfg.width
        self.patch_embed = Conv(3, w, cfg.patch, stride=cfg.patch,
                                dtype=cfg.dtype, bias=False)
        self.class_embedding = _param(w)
        self.position_embedding = _param(
            (cfg.image_size // cfg.patch) ** 2 + 1, w)
        self.pre_ln = LayerNorm(w)
        lcfg = CLIPConfig(width=w, layers=cfg.layers, heads=cfg.heads,
                          act=cfg.act, dtype=cfg.dtype)
        for i in range(cfg.layers):
            self.add_module(f"layers_{i}", CLIPLayer(lcfg))
        self.post_ln = LayerNorm(w)
        self.visual_projection = Dense(w, cfg.projection_dim, bias=False,
                                       dtype=torch.float32)

    def forward(self, pixels: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """pixels [B, image_size, image_size, 3], CLIP-normalised ->
        fp32 (last hidden [B, 1 + P, width], the hidden state before the
        final layer [B, 1 + P, width], image embeds [B, projection])."""
        cfg = self.cfg
        b = pixels.shape[0]
        h = self.patch_embed(pixels.permute(0, 3, 1, 2))
        h = h.flatten(2).transpose(1, 2)
        cls = self.class_embedding.to(h.dtype).expand(b, 1, cfg.width)
        h = torch.cat([cls, h], dim=1)
        h = h + self.position_embedding[None, :h.shape[1]].to(h.dtype)
        h = self.pre_ln(h)
        mask = torch.zeros((1, 1, h.shape[1], h.shape[1]),
                           dtype=torch.float32, device=h.device)
        penultimate = h
        for i in range(cfg.layers):
            if i == cfg.layers - 1:
                penultimate = h
            h = getattr(self, f"layers_{i}")(h, mask)
        embeds = self.visual_projection(self.post_ln(h[:, 0]))
        return h.float(), penultimate.float(), embeds.float()


def preprocess(images: torch.Tensor, size: int,
               crop: str = "center") -> torch.Tensor:
    """[B, H, W, 3] in [0, 1] -> CLIP-normalised [B, size, size, 3] on the
    images' device: the short side resized bicubic to ``size`` and the
    centre cut (crop="center"), or the whole image squashed
    (crop="none")."""
    imgs = images.float()
    _, h, w, _ = imgs.shape
    if crop != "none" and h != w:
        if h < w:
            nw = max(int(round(w * size / h)), size)
            imgs = resize_image(imgs, nw, size, "bicubic")
            x0 = (nw - size) // 2
            imgs = imgs[:, :, x0:x0 + size]
        else:
            nh = max(int(round(h * size / w)), size)
            imgs = resize_image(imgs, size, nh, "bicubic")
            y0 = (nh - size) // 2
            imgs = imgs[:, y0:y0 + size]
    else:
        imgs = resize_image(imgs, size, size, "bicubic")
    mean = torch.tensor(CLIP_MEAN, dtype=torch.float32, device=imgs.device)
    std = torch.tensor(CLIP_STD, dtype=torch.float32, device=imgs.device)
    return (imgs.clamp(0.0, 1.0) - mean) / std


@dataclasses.dataclass
class CLIPVisionOutput:
    """CLIP_VISION_OUTPUT wire value."""
    image_embeds: torch.Tensor
    last_hidden: Optional[torch.Tensor] = None
    # the hidden states before the final layer (a style model's input)
    penultimate_hidden: Optional[torch.Tensor] = None


@dataclasses.dataclass
class CLIPVisionTower:
    """CLIP_VISION wire value: the model on its device."""
    name: str
    cfg: CLIPVisionConfig
    model: CLIPVisionModel

    @property
    def device(self) -> torch.device:
        return self.model.position_embedding.device

    @torch.inference_mode()
    def encode(self, images: torch.Tensor,
               crop: str = "center") -> CLIPVisionOutput:
        px = preprocess(images.to(self.device), self.cfg.image_size, crop)
        hidden, penultimate, embeds = self.model(px)
        return CLIPVisionOutput(image_embeds=embeds, last_hidden=hidden,
                                penultimate_hidden=penultimate)
