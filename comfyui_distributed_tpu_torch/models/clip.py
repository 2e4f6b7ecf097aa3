"""CLIP text encoders (ViT-L/14 text tower, OpenCLIP bigG) in PyTorch: the
counterpart of ``comfyui_distributed_tpu/models/clip.py``.

Causal transformer, pre-LN, fp32 layer norms.  The causal attention is
plain torch math (fp32 scores and softmax), as the JAX package computes
it outside its Pallas kernel: 77 tokens need no kernel.
"""

from __future__ import annotations

import copy
import dataclasses
import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from comfyui_distributed_tpu_torch.models.layers import (
    Dense,
    LayerNorm,
    _param,
)


@dataclasses.dataclass(frozen=True)
class CLIPConfig:
    vocab_size: int = 49408
    width: int = 768
    layers: int = 12
    heads: int = 12
    max_length: int = 77
    act: str = "quick_gelu"          # ViT-L; bigG uses "gelu"
    # which hidden layer feeds cross-attention: -1 final, -2 penultimate
    output_layer: int = -1
    projection_dim: Optional[int] = None  # pooled-output projection (bigG)
    # checkpoint layout: "hf" (q/k/v split) or "openclip" (packed in_proj)
    layout: str = "hf"
    dtype: torch.dtype = torch.bfloat16


CLIP_L_CONFIG = CLIPConfig()
# SDXL pairs CLIP-L (penultimate) with OpenCLIP bigG (penultimate)
CLIP_L_SDXL_CONFIG = dataclasses.replace(CLIP_L_CONFIG, output_layer=-2)
OPEN_CLIP_BIGG_CONFIG = CLIPConfig(width=1280, layers=32, heads=20,
                                   act="gelu", output_layer=-2,
                                   projection_dim=1280, layout="openclip")
# SD2.x's text tower: OpenCLIP ViT-H at its penultimate layer, with the
# checkpoint's text_projection
OPEN_CLIP_H_CONFIG = CLIPConfig(width=1024, layers=24, heads=16,
                                act="gelu", output_layer=-2,
                                projection_dim=1024, layout="openclip")
TINY_CLIP_CONFIG = CLIPConfig(vocab_size=4096, width=64, layers=2, heads=4,
                              max_length=77, dtype=torch.float32)


def _act(name: str, x: torch.Tensor) -> torch.Tensor:
    if name == "quick_gelu":
        return x * torch.sigmoid(1.702 * x)
    # OpenCLIP's nn.GELU is the exact (erf) form
    return F.gelu(x)


class Embed(nn.Module):
    """flax ``nn.Embed``: table lookup, the table cast to ``dtype``."""

    def __init__(self, num: int, dim: int, dtype: torch.dtype):
        super().__init__()
        self.weight = _param(num, dim)
        self.dtype = dtype

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        return F.embedding(ids, self.weight.to(self.dtype))


class CLIPLayer(nn.Module):
    def __init__(self, cfg: CLIPConfig):
        super().__init__()
        self.cfg = cfg
        w, dt = cfg.width, cfg.dtype
        self.ln1 = LayerNorm(w)
        self.q = Dense(w, w, dtype=dt)
        self.k = Dense(w, w, dtype=dt)
        self.v = Dense(w, w, dtype=dt)
        self.proj = Dense(w, w, dtype=dt)
        self.ln2 = LayerNorm(w)
        self.fc1 = Dense(w, w * 4, dtype=dt)
        self.fc2 = Dense(w * 4, w, dtype=dt)

    def forward(self, x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        h = self.ln1(x)
        B, N, C = h.shape
        hd = cfg.width // cfg.heads
        q = self.q(h).view(B, N, cfg.heads, hd).transpose(1, 2)
        k = self.k(h).view(B, N, cfg.heads, hd).transpose(1, 2)
        v = self.v(h).view(B, N, cfg.heads, hd).transpose(1, 2)
        logits = q.float() @ k.float().transpose(-1, -2)
        logits = logits / math.sqrt(hd) + mask
        w = torch.softmax(logits, dim=-1)
        attn = (w.to(v.dtype) @ v).transpose(1, 2).reshape(B, N, C)
        x = x + self.proj(attn)
        h = self.fc2(_act(cfg.act, self.fc1(self.ln2(x))))
        return x + h


class CLIPTextModel(nn.Module):
    # parameters the weight bridge carries under their own flax names
    FLAX_RAW = ("position_embedding",)

    def __init__(self, cfg: CLIPConfig):
        super().__init__()
        self.cfg = cfg
        self.token_embedding = Embed(cfg.vocab_size, cfg.width, cfg.dtype)
        self.position_embedding = _param(cfg.max_length, cfg.width)
        for i in range(cfg.layers):
            self.add_module(f"layers_{i}", CLIPLayer(cfg))
        self.ln_final = LayerNorm(cfg.width)
        if cfg.projection_dim is not None:
            self.text_projection = Dense(cfg.width, cfg.projection_dim,
                                         bias=False, dtype=torch.float32)

    def forward(self, tokens: torch.Tensor,
                emb_override: Optional[torch.Tensor] = None,
                emb_mask: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """tokens: [B, max_length] int.  Returns fp32 (hidden [B, N,
        width], pooled [B, width or projection_dim]).  ``emb_override``
        [B, N, width] with ``emb_mask`` [B, N] (textual inversion): where
        the mask is set, the supplied vector replaces the token's looked-up
        embedding (its id is a placeholder 0, which never wins the EOT
        argmax)."""
        cfg = self.cfg
        B, N = tokens.shape
        tok_emb = self.token_embedding(tokens)
        if emb_override is not None:
            tok_emb = torch.where(emb_mask[..., None].bool(),
                                  emb_override.to(tok_emb.dtype), tok_emb)
        x = tok_emb + self.position_embedding[None, :N].to(cfg.dtype)
        mask = torch.full((N, N), float("-inf"), device=tokens.device
                          ).triu(1)[None, None]
        hidden = []
        for i in range(cfg.layers):
            x = getattr(self, f"layers_{i}")(x, mask)
            hidden.append(x)
        # ln_final is shared by the selected layer and the pooled output
        out = self.ln_final(hidden[cfg.output_layer])
        final = out if cfg.output_layer == -1 else self.ln_final(hidden[-1])
        # pooled: the hidden state at the EOT token (highest token id)
        eot = tokens.argmax(dim=-1)
        pooled = final[torch.arange(B, device=tokens.device), eot]
        if cfg.projection_dim is not None:
            pooled = self.text_projection(pooled)
        return out.float(), pooled.float()


# the config fields that shape a tower's parameters or its numbers
# everywhere but its output selection
_WEIGHT_FIELDS = ("vocab_size", "width", "layers", "heads", "max_length",
                  "act", "projection_dim", "layout", "dtype")


def with_config(model: CLIPTextModel, cfg: CLIPConfig) -> CLIPTextModel:
    """``model``'s weights under ``cfg``, which may differ from its own
    config only in ``output_layer`` (clip-skip): ``model`` itself when
    the configs are equal, else a shallow copy that shares every
    parameter and reads ``cfg``."""
    if cfg == model.cfg:
        return model
    changed = [f for f in _WEIGHT_FIELDS
               if getattr(cfg, f) != getattr(model.cfg, f)]
    if changed:
        raise ValueError(f"with_config: {changed} differ; only "
                         "output_layer may change on shared weights")
    out = copy.copy(model)
    out.cfg = cfg
    return out
