"""The style adapter (StyleModelLoader, StyleModelApply: T2I's
coadapter-style): the port's copy of
``comfyui_distributed_tpu/models/style_model.py``.

A small transformer turns CLIP-vision hidden states into a few style
tokens that are appended to the text context, so sampling leans toward
the reference image's style through the ordinary cross-attention:
learned style queries, the port's ``CLIPLayer`` over [vision tokens;
queries], the trailing tokens normed and projected.  As in the JAX
package, trained adapter weights are not converted: a file of the name
is logged and the virtual adapter is used.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Dict, Optional

import torch
from torch import nn

from comfyui_distributed_tpu_torch.models.clip import CLIPConfig, CLIPLayer
from comfyui_distributed_tpu_torch.models.layers import (
    Dense,
    LayerNorm,
    _param,
)
from comfyui_distributed_tpu_torch.utils.log import log


@dataclasses.dataclass(frozen=True)
class StyleAdapterConfig:
    width: int = 1024
    layers: int = 3
    heads: int = 8
    num_tokens: int = 8
    context_dim: int = 768      # the output tokens' width (the text's)
    dtype: torch.dtype = torch.float32


STYLE_CONFIG = StyleAdapterConfig()
TINY_STYLE_CONFIG = StyleAdapterConfig(width=64, layers=1, heads=4,
                                       num_tokens=2, context_dim=64)


class StyleAdapter(nn.Module):
    """[B, P, width] vision hidden states -> [B, num_tokens,
    context_dim] style tokens, fp32.  The adapter takes vision states of
    its own width (ViT-L's 1024 at full size), as the JAX package's
    does."""

    FLAX_RAW = ("style_embedding",)

    def __init__(self, cfg: StyleAdapterConfig):
        super().__init__()
        self.cfg = cfg
        self.proj_in = Dense(cfg.width, cfg.width, dtype=cfg.dtype)
        self.style_embedding = _param(cfg.num_tokens, cfg.width)
        lcfg = CLIPConfig(width=cfg.width, layers=cfg.layers,
                          heads=cfg.heads, act="gelu", dtype=cfg.dtype)
        for i in range(cfg.layers):
            self.add_module(f"layers_{i}", CLIPLayer(lcfg))
        self.ln_post = LayerNorm(cfg.width)
        self.proj_out = Dense(cfg.width, cfg.context_dim,
                              dtype=torch.float32)

    def forward(self, vision_hidden: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        h = self.proj_in(vision_hidden)
        q = self.style_embedding.to(h.dtype)[None].expand(
            h.shape[0], -1, -1)
        h = torch.cat([h, q], dim=1)
        mask = torch.zeros((1, 1, h.shape[1], h.shape[1]),
                           dtype=torch.float32, device=h.device)
        for i in range(cfg.layers):
            h = getattr(self, f"layers_{i}")(h, mask)
        return self.proj_out(self.ln_post(h[:, -cfg.num_tokens:]))


@dataclasses.dataclass
class StyleModelTower:
    """The STYLE_MODEL wire value: the adapter and its name."""
    name: str
    cfg: StyleAdapterConfig
    net: StyleAdapter

    @torch.inference_mode()
    def get_cond(self, vision_output) -> torch.Tensor:
        # the reference's style path reads the PENULTIMATE vision hidden
        # states, not the last layer's
        hidden = getattr(vision_output, "penultimate_hidden", None)
        if hidden is None:
            hidden = vision_output.last_hidden
        dev = self.net.proj_out.weight.device
        return self.net(hidden.to(dev, torch.float32))


_cache: Dict[str, StyleModelTower] = {}


def load_style_model(name: str, models_dir: Optional[str] = None,
                     context_dim: int = 768,
                     device="cuda") -> StyleModelTower:
    """The virtual style adapter of ``name`` (the tiny one for a name
    with "tiny" or "test" in it); a file of that name is logged and not
    converted."""
    from comfyui_distributed_tpu_torch.models import registry
    device = torch.device(device)
    key = f"{name}:{context_dim}:{models_dir or ''}:{device}"
    if key in _cache:
        return _cache[key]
    lowered = name.lower()
    cfg = TINY_STYLE_CONFIG if ("tiny" in lowered or "test" in lowered) \
        else dataclasses.replace(STYLE_CONFIG, context_dim=context_dim)
    if models_dir:
        for cand in (name, os.path.join("style_models", name)):
            if os.path.isfile(os.path.join(models_dir,
                                           cand.replace("\\", "/"))):
                log(f"style model {name}: converting trained adapter "
                    "weights is not implemented; using a deterministic "
                    "virtual adapter")
                break
    from comfyui_distributed_tpu_torch.models.weights import fill_virtual
    seed = registry._name_seed(name)
    net = registry._build(lambda: StyleAdapter(cfg), device, torch.float32,
                          lambda m: fill_virtual(m, seed))
    log(f"virtual style model {name!r} (tokens {cfg.num_tokens} -> "
        f"{cfg.context_dim}d), deterministic init (seed {seed})")
    tower = StyleModelTower(name=name, cfg=cfg, net=net)
    _cache[key] = tower
    return tower


def clear_style_model_cache() -> None:
    _cache.clear()
