"""Diffusion UNet (SD1.x, SD2.x and SDXL families) in PyTorch: the counterpart of
``comfyui_distributed_tpu/models/unet.py``.

The forward takes and returns the JAX package's NHWC layout (x [B, H, W,
C]) and runs NCHW inside.  Eps-prediction by default; the denoiser
(``models/denoiser.py``) wraps it into ``denoised = f(x, sigma)``.  The
forward takes ControlNet residuals (``models/controlnet.py``), a
hypernetwork's value context and GLIGEN's grounding tokens, and the
config carries the JAX UNet's structural patches: FreeU (v1 and v2),
HyperTile, deep shrink, SAG's capture and ToMe.  They change no weight,
so a patched pipeline shares its base's module through
:func:`with_config`.  ``gligen`` > 0 builds a GLIGEN fuser into every
transformer block: weights of their own, grafted beside the base's
(``ops/basic.py:gligen_attach``).
"""

from __future__ import annotations

import copy
import dataclasses
from typing import List, Optional, Tuple

import numpy as np
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
    # FreeU (Si et al.): decoder backbone boost and skip low-pass, (b1,
    # b2, s1, s2) or None; version 2 scales the boost by the per-pixel
    # normalized hidden mean
    freeu: Optional[Tuple[float, float, float, float]] = None
    freeu_version: int = 1
    # HyperTile: (tile_size_px, max_depth, scale_depth) or None; levels
    # up to max_depth tile their transformers' tokens into tiles of at
    # least tile_size // 8 latent units a side (models/layers.py)
    hypertile: Optional[Tuple[int, int, bool]] = None
    # deep shrink (PatchModelAddDownscale): (level, factor) or None; the
    # hidden is downscaled bilinearly at the level's entry and upsampled
    # at the first skip of another size.  The sigma window that turns it
    # on lives in the sampler (models/registry.py)
    deep_shrink: Optional[Tuple[int, float]] = None
    # SAG: a forward with ``capture=True`` returns the middle block's
    # first self-attention weights beside the prediction
    sag_capture: bool = False
    # ToMe (TomePatchModel): merge this fraction of attn1's query tokens
    # at the highest-resolution attention level only (level 0); 0 = off
    tome_ratio: float = 0.0
    # GLIGEN: > 0 builds a GatedSelfAttention fuser in every transformer
    # block for grounding tokens of this width (``objs`` of the forward)
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

# config fields that change no weight: a module built under one value
# serves every other through with_config
_PATCH_FIELDS = ("freeu", "freeu_version", "hypertile", "deep_shrink",
                 "sag_capture", "tome_ratio")


def mid_depth(cfg: UNetConfig) -> int:
    """Middle-block transformer depth."""
    if cfg.transformer_depth_middle is not None:
        return int(cfg.transformer_depth_middle)
    return max(cfg.transformer_depth[-1], 1)


class UNet(nn.Module):
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

        def attn(c: int, depth: int) -> SpatialTransformer:
            return SpatialTransformer(c, heads(c), depth, cfg.context_dim,
                                      dtype=dt, gligen=cfg.gligen)

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

    def _ht_tile(self, level: int) -> int:
        """HyperTile's least latent tile side at ``level`` (0: off)."""
        if self.cfg.hypertile is None:
            return 0
        tile_px, max_depth, scale_depth = self.cfg.hypertile
        if level > int(max_depth):
            return 0
        return max(32, int(tile_px)) // 8 * (2 ** level if scale_depth
                                            else 1)

    def forward(self, x: torch.Tensor, timesteps: torch.Tensor,
                context: torch.Tensor,
                y: Optional[torch.Tensor] = None,
                control: Optional[Tuple[List[torch.Tensor],
                                        torch.Tensor]] = None,
                capture: bool = False,
                context_v: Optional[torch.Tensor] = None,
                objs: Optional[torch.Tensor] = None):
        """x: [B, H, W, C_in] latent; timesteps: [B]; context: [B, M, Cc]
        text tokens; y: [B, adm_in] vector conditioning (SDXL).  Returns
        the fp32 prediction [B, H, W, C_out].  ``control``: ControlNet
        residuals ``(skips, middle)`` in NCHW, one a skip in down-path
        order, added to the skips (``skip[i] + control[i]``) and to the
        middle block's output; a count that does not match raises.
        ``capture`` (a ``sag_capture`` config only): returns
        (prediction, the middle block's first self-attention weights
        [B, heads, N, N] in fp32).  ``context_v`` [B, M, Cc]: every
        cross-attention's value context (a hypernetwork's); ``objs`` [B,
        n, gligen]: the GLIGEN fusers' grounding tokens."""
        cfg = self.cfg
        if capture and not cfg.sag_capture:
            raise ValueError("capture needs a UNet config with sag_capture")
        emb = self.time_fc1(timestep_embedding(timesteps,
                                               cfg.model_channels))
        emb = self.time_fc2(F.silu(emb))
        if cfg.adm_in_channels is not None:
            if y is None:
                y = torch.zeros(x.shape[0], cfg.adm_in_channels,
                                dtype=x.dtype, device=x.device)
            emb = emb + self.label_fc2(F.silu(self.label_fc1(y)))

        def kw(level: int) -> dict:
            # ToMe merges at level 0 only
            return dict(context_v=context_v, objs=objs,
                        tome_ratio=cfg.tome_ratio if level == 0 else 0.0)

        h = self.conv_in(x.permute(0, 3, 1, 2))
        skips = [h]
        for level in range(cfg.num_levels):
            if cfg.deep_shrink is not None and level == cfg.deep_shrink[0]:
                f = float(cfg.deep_shrink[1])
                h = resize_bilinear(h, max(1, int(round(h.shape[2] / f))),
                                    max(1, int(round(h.shape[3] / f))))
            for i in range(cfg.num_res_blocks):
                h = getattr(self, f"down_{level}_res_{i}")(h, emb)
                if cfg.transformer_depth[level] > 0:
                    h = getattr(self, f"down_{level}_attn_{i}")(
                        h, context, self._ht_tile(level), **kw(level))
                skips.append(h)
            if level != cfg.num_levels - 1:
                h = getattr(self, f"down_{level}_ds")(h)
                skips.append(h)

        if control is not None:
            ctrl_skips, ctrl_mid = control
            skips = [s + c for s, c in zip(skips, ctrl_skips, strict=True)]

        h = self.mid_res_0(h, emb)
        probs = None
        mid = dict(context_v=context_v, objs=objs)
        if capture:
            h, probs = self.mid_attn(h, context,
                                     self._ht_tile(cfg.num_levels - 1),
                                     capture=True, **mid)
        else:
            h = self.mid_attn(h, context, self._ht_tile(cfg.num_levels - 1),
                              **mid)
        h = self.mid_res_1(h, emb)
        if control is not None:
            h = h + ctrl_mid

        for level in reversed(range(cfg.num_levels)):
            for i in range(cfg.num_res_blocks + 1):
                skip = skips.pop()
                if h.shape[2:] != skip.shape[2:]:
                    # deep shrink: back to full size at the first skip of
                    # another size
                    h = resize_bilinear(h, skip.shape[2], skip.shape[3])
                if cfg.freeu is not None:
                    h, skip = _apply_freeu(cfg, h, skip)
                h = torch.cat([h, skip], dim=1)
                h = getattr(self, f"up_{level}_res_{i}")(h, emb)
                if cfg.transformer_depth[level] > 0:
                    h = getattr(self, f"up_{level}_attn_{i}")(
                        h, context, self._ht_tile(level), **kw(level))
            if level != 0:
                h = getattr(self, f"up_{level}_us")(h)

        h = self.conv_out(F.silu(self.out_norm(h)))
        out = h.float().permute(0, 2, 3, 1)
        return (out, probs) if capture else out


def with_config(unet: UNet, cfg: UNetConfig) -> UNet:
    """``unet``'s weights under ``cfg``, which may differ from its own
    config only in the patch fields (FreeU, HyperTile, deep shrink, SAG's
    capture, ToMe):
    ``unet`` itself when the configs are equal, else a shallow copy that
    shares every parameter and reads ``cfg``."""
    if cfg == unet.cfg:
        return unet
    changed = [f.name for f in dataclasses.fields(cfg)
               if f.name not in _PATCH_FIELDS
               and getattr(cfg, f.name) != getattr(unet.cfg, f.name)]
    if changed:
        raise ValueError(f"with_config: {changed} differ; only the patch "
                         f"fields {_PATCH_FIELDS} may change on shared "
                         "weights")
    out = copy.copy(unet)
    out.cfg = cfg
    return out


def _resize_weights(n_in: int, n_out: int, dtype: torch.dtype,
                    device) -> torch.Tensor:
    """[n_out, n_in] weights of ``jax.image.resize``'s bilinear filter on
    one axis: the triangle kernel at half-pixel centres, widened by the
    scale when it shrinks (antialiasing), each row normalized, in
    float32 and then cast to the input's dtype, as there."""
    scale = n_out / n_in
    inv = 1.0 / scale
    ks = max(inv, 1.0)
    sample = (torch.arange(n_out, dtype=torch.float32, device=device)
              + 0.5) * inv - 0.5
    dist = (sample[:, None] - torch.arange(n_in, dtype=torch.float32,
                                           device=device)[None, :]).abs()
    w = torch.clamp(1.0 - dist / ks, min=0.0)
    total = w.sum(dim=1, keepdim=True)
    w = torch.where(total.abs() > 1000.0 * float(np.finfo(np.float32).eps),
                    w / torch.where(total != 0, total, 1.0),
                    torch.zeros_like(w))
    inside = (sample >= -0.5) & (sample <= n_in - 0.5)
    return torch.where(inside[:, None], w, torch.zeros_like(w)).to(dtype)


def resize_bilinear(x: torch.Tensor, height: int, width: int
                    ) -> torch.Tensor:
    """NCHW ``x`` to ``height`` x ``width`` as ``jax.image.resize(...,
    "bilinear")`` resizes it (deep shrink's two resizes): an axis of
    unchanged size is left alone, each other is one contraction with
    :func:`_resize_weights`, in ``x``'s dtype."""
    H, W = int(x.shape[2]), int(x.shape[3])
    if H != height:
        wh = _resize_weights(H, height, x.dtype, x.device)
        x = torch.einsum("bchw,Hh->bcHw", x, wh)
    if W != width:
        ww = _resize_weights(W, width, x.dtype, x.device)
        x = torch.einsum("bchw,Ww->bchW", x, ww)
    return x


def _fourier_filter(x: torch.Tensor, threshold: int,
                    scale: float) -> torch.Tensor:
    """FreeU's skip filter on an NCHW map: the centred low-frequency box
    of the 2-D spectrum scaled by ``scale``, in float32."""
    xf = torch.fft.fftshift(torch.fft.fftn(x.float(), dim=(2, 3)),
                            dim=(2, 3))
    H, W = int(x.shape[2]), int(x.shape[3])
    cr, cc = H // 2, W // 2
    mask = torch.ones((1, 1, H, W), dtype=torch.float32, device=x.device)
    mask[:, :, max(cr - threshold, 0):cr + threshold,
         max(cc - threshold, 0):cc + threshold] = scale
    xf = torch.fft.ifftshift(xf * mask, dim=(2, 3))
    return torch.fft.ifftn(xf, dim=(2, 3)).real.to(x.dtype)


def _apply_freeu(cfg: UNetConfig, h: torch.Tensor, hsp: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """FreeU at a decoder concat, only where the backbone has
    model_channels * 4 (b1, s1) or * 2 (b2, s2) channels: the first half
    of the backbone's channels times the boost (v2: scaled by the
    per-pixel channel mean, min-max normalized over each sample), the
    skip through :func:`_fourier_filter`."""
    b1, b2, s1, s2 = cfg.freeu
    scales = {cfg.model_channels * 4: (float(b1), float(s1)),
              cfg.model_channels * 2: (float(b2), float(s2))}
    sc = scales.get(int(h.shape[1]))
    if sc is None:
        return h, hsp
    b, s = sc
    half = h.shape[1] // 2
    if cfg.freeu_version == 2:
        hm = h.float().mean(dim=1, keepdim=True)
        flat = hm.reshape(h.shape[0], -1)
        hmin = flat.min(dim=1).values.reshape(-1, 1, 1, 1)
        hmax = flat.max(dim=1).values.reshape(-1, 1, 1, 1)
        hm = (hm - hmin) / torch.clamp(hmax - hmin, min=1e-6)
        boost = ((b - 1.0) * hm + 1.0).to(h.dtype)
    else:
        boost = torch.tensor(b, dtype=h.dtype, device=h.device)
    h = torch.cat([h[:, :half] * boost, h[:, half:]], dim=1)
    return h, _fourier_filter(hsp, 1, s)
