"""GLIGEN grounded generation (GLIGENLoader, GLIGENTextBoxApply): the
port's copy of ``comfyui_distributed_tpu/models/gligen.py``.

Phrase embeddings and normalized boxes become grounding tokens
(:class:`PositionNet`) that every transformer block's gated
self-attention fuser attends beside the visual tokens
(``models/layers.py:GatedSelfAttention``; zero gates leave the image as
it is).  The fusers' weights live in the UNet: ``ops/basic.py:
gligen_attach`` builds a UNet with fusers, shares the base's weights
into it and fills the fusers virtually.  As in the JAX package, a
trained GLIGEN file is not converted: a file of the name is logged and
the virtual position net is used.
"""

from __future__ import annotations

import dataclasses
import math
import os
from typing import Dict, Optional

import torch
import torch.nn.functional as F
from torch import nn

from comfyui_distributed_tpu_torch.models.layers import Dense, _param
from comfyui_distributed_tpu_torch.utils.log import log

FOURIER_FREQS = 8
POS_DIM = FOURIER_FREQS * 2 * 4       # sin and cos of 4 box coordinates


def fourier_box_embed(boxes: torch.Tensor) -> torch.Tensor:
    """[..., 4] normalized xyxy -> [..., POS_DIM]: GLIGEN's Fourier
    position code at frequencies 2^0 .. 2^(F-1), in float32."""
    freqs = 2.0 ** torch.arange(FOURIER_FREQS, dtype=torch.float32,
                                device=boxes.device)
    ang = boxes.float()[..., None] * freqs * math.pi          # [..., 4, F]
    emb = torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)
    return emb.reshape(*boxes.shape[:-1], POS_DIM)


@dataclasses.dataclass(frozen=True)
class GligenConfig:
    text_dim: int = 768
    out_dim: int = 768
    hidden: int = 512


class PositionNet(nn.Module):
    """(text_embs [B, N, text_dim], boxes [B, N, 4], masks [B, N]) ->
    grounding tokens [B, N, out_dim]; an entry with mask 0 takes the
    learned null features.  fp32 (flax's default Dense dtype)."""

    # parameters the weight bridge carries under their own flax names
    FLAX_RAW = ("null_position_feature", "null_text_feature")

    def __init__(self, cfg: GligenConfig):
        super().__init__()
        self.cfg = cfg
        self.null_position_feature = _param(POS_DIM)
        self.null_text_feature = _param(cfg.text_dim)
        self.fc1 = Dense(cfg.text_dim + POS_DIM, cfg.hidden,
                         dtype=torch.float32)
        self.fc2 = Dense(cfg.hidden, cfg.hidden, dtype=torch.float32)
        self.fc3 = Dense(cfg.hidden, cfg.out_dim, dtype=torch.float32)

    def forward(self, text_embs: torch.Tensor, boxes: torch.Tensor,
                masks: torch.Tensor) -> torch.Tensor:
        m = masks.float()[..., None]
        pos = fourier_box_embed(boxes) * m \
            + self.null_position_feature.float() * (1.0 - m)
        txt = text_embs.float() * m + self.null_text_feature.float() \
            * (1.0 - m)
        h = F.silu(self.fc1(torch.cat([txt, pos], dim=-1)))
        return self.fc3(F.silu(self.fc2(h)))


@dataclasses.dataclass
class GligenModel:
    """The GLIGEN wire value: the position net and its name."""
    name: str
    cfg: GligenConfig
    net: PositionNet

    @torch.inference_mode()
    def grounding_tokens(self, text_embs, boxes, masks) -> torch.Tensor:
        dev = self.net.fc1.weight.device

        def t(a):
            return torch.as_tensor(a, dtype=torch.float32, device=dev)

        return self.net(t(text_embs), t(boxes), t(masks))


_cache: Dict[str, GligenModel] = {}


def load_gligen(name: str, models_dir: Optional[str] = None,
                text_dim: int = 768, device="cuda") -> GligenModel:
    """The virtual position net of ``name`` (seed from the name, the JAX
    package's draws) on ``device``; a file of that name is logged and
    not converted."""
    from comfyui_distributed_tpu_torch.models import registry
    from comfyui_distributed_tpu_torch.models.weights import fill_virtual
    device = torch.device(device)
    key = f"{name}:{text_dim}:{models_dir or ''}:{device}"
    if key in _cache:
        return _cache[key]
    if models_dir:
        for cand in (name, os.path.join("gligen", name)):
            if os.path.isfile(os.path.join(models_dir,
                                           cand.replace("\\", "/"))):
                log(f"gligen {name}: converting trained release weights is "
                    "not implemented; using the deterministic virtual "
                    "position net and fusers")
                break
    cfg = GligenConfig(text_dim=text_dim, out_dim=text_dim)
    seed = registry._name_seed(name)
    net = registry._build(lambda: PositionNet(cfg), device, torch.float32,
                          lambda m: fill_virtual(m, seed))
    log(f"virtual gligen {name!r} (text_dim {text_dim}), deterministic "
        f"init (seed {seed})")
    model = GligenModel(name=name, cfg=cfg, net=net)
    _cache[key] = model
    return model


def clear_gligen_cache() -> None:
    _cache.clear()
