"""Model families, virtual checkpoints and the DiffusionPipeline bundle in
PyTorch: the counterpart of ``comfyui_distributed_tpu/models/registry.py``.

CheckpointLoaderSimple hands back one :class:`DiffusionPipeline` as
(MODEL, CLIP, VAE).  With no weights file, parameters are virtually
initialized from the checkpoint name (``models/weights.py``): the same
name gives the same weights as the JAX package, on any host.  Loading a
weights file waits until a checkpoint is in the repository.
"""

from __future__ import annotations

import dataclasses
import hashlib
import os
import threading
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch
from torch import nn

from comfyui_distributed_tpu_torch.models import clip as clip_mod
from comfyui_distributed_tpu_torch.models import schedules as sch
from comfyui_distributed_tpu_torch.models import unet as unet_mod
from comfyui_distributed_tpu_torch.models import vae as vae_mod
from comfyui_distributed_tpu_torch.models.denoiser import make_denoiser
from comfyui_distributed_tpu_torch.models.prng import (
    INIT_NOISE_INDEX,
    batch_normal,
    sample_keys,
)
from comfyui_distributed_tpu_torch.models.samplers import (
    cfg_denoiser_multi,
    get_sampler,
)
from comfyui_distributed_tpu_torch.models.tokenizer import make_tokenizer
from comfyui_distributed_tpu_torch.models.weights import fill_virtual


@dataclasses.dataclass(frozen=True)
class ModelFamily:
    name: str
    unet: unet_mod.UNetConfig
    vae: vae_mod.VAEConfig
    clips: Tuple[clip_mod.CLIPConfig, ...]
    latent_channels: int = 4


FAMILIES: Dict[str, ModelFamily] = {
    "sd15": ModelFamily(
        name="sd15",
        unet=unet_mod.SD15_CONFIG,
        vae=vae_mod.SD_VAE_CONFIG,
        clips=(clip_mod.CLIP_L_CONFIG,),
    ),
    "sdxl": ModelFamily(
        name="sdxl",
        unet=unet_mod.SDXL_CONFIG,
        vae=vae_mod.SDXL_VAE_CONFIG,
        clips=(clip_mod.CLIP_L_SDXL_CONFIG, clip_mod.OPEN_CLIP_BIGG_CONFIG),
    ),
    "tiny": ModelFamily(
        name="tiny",
        unet=unet_mod.TINY_CONFIG,
        vae=vae_mod.TINY_VAE_CONFIG,
        clips=(clip_mod.TINY_CLIP_CONFIG,),
    ),
}

FAMILY_ENV = "DTPU_DEFAULT_FAMILY"


def detect_family(ckpt_name: str) -> str:
    """Family from checkpoint-name heuristics (the JAX package's rules);
    ``DTPU_DEFAULT_FAMILY`` overrides (tests force 'tiny').  Names of
    families not ported yet are returned too, and :func:`get_family`
    refuses them."""
    env = os.environ.get(FAMILY_ENV)
    if env:
        return env
    lowered = ckpt_name.lower()
    inpaint = "inpaint" in lowered
    if "tiny" in lowered or "test" in lowered:
        if "unclip" in lowered:
            return "tiny_unclip"
        if "ip2p" in lowered or "pix2pix" in lowered:
            return "tiny_ip2p"
        return "tiny_inpaint" if inpaint else "tiny"
    if "ip2p" in lowered or "pix2pix" in lowered:
        return "sd15_ip2p"
    if "unclip" in lowered:
        return "sd21_unclip"
    if "xl" in lowered:
        if "refiner" in lowered:
            return "sdxl_refiner"
        return "sdxl_inpaint" if inpaint else "sdxl"
    if ("sd2" in lowered or "v2-0" in lowered or "v2-1" in lowered
            or "768-v" in lowered or "512-base" in lowered
            or "512-inpainting" in lowered):
        if inpaint:
            return "sd21_inpaint"
        return "sd21" if ("768" in lowered or "v-pred" in lowered
                          or "vpred" in lowered) else "sd21_base"
    return "sd15_inpaint" if inpaint else "sd15"


def get_family(name: str) -> ModelFamily:
    if name not in FAMILIES:
        raise NotImplementedError(
            f"model family {name!r} is not ported to the torch package "
            f"yet; ported: {sorted(FAMILIES)}")
    return FAMILIES[name]


def _name_seed(name: str) -> int:
    return int.from_bytes(hashlib.sha256(name.encode()).digest()[:4], "little")


class DiffusionPipeline:
    """(MODEL, CLIP, VAE) bundle + tokenizer + schedule, on one device."""

    def __init__(self, name: str, family: ModelFamily, unet: nn.Module,
                 clip_models: List[nn.Module], vae: nn.Module,
                 device: torch.device, assets_dir: Optional[str] = None):
        self.name = name
        self.family = family
        self.unet = unet
        self.clip_models = clip_models
        self.vae = vae
        self.device = device
        self.prediction_type = family.unet.prediction_type
        self.schedule = sch.make_discrete_schedule()
        # CLIP pads with EOT, OpenCLIP-only families with 0
        self.tokenizer = make_tokenizer(
            assets_dir=assets_dir,
            vocab_size=min(c.vocab_size for c in family.clips),
            pad_with_end=not all(c.layout == "openclip"
                                 for c in family.clips))

    @torch.inference_mode()
    def encode_prompt(self, texts: List[str]
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(context [B, 77, sum(widths)], pooled [B, pooled_dim]), fp32.
        Multi-tower families (SDXL) concatenate the hidden widths; pooled
        comes from the last tower.  Token weights scale the hidden states
        around the per-sequence mean (ComfyUI-style emphasis)."""
        outs, pooled = [], None
        pairs = [self.tokenizer.encode(t) for t in texts]
        ids = torch.as_tensor(np.stack([x for x, _ in pairs]),
                              device=self.device).long()
        wa = torch.as_tensor(np.stack([w for _, w in pairs]),
                             device=self.device)
        for m in self.clip_models:
            hidden, pooled = m(ids)
            mean = hidden.mean(dim=1, keepdim=True)
            outs.append(mean + (hidden - mean) * wa[..., None])
        return torch.cat(outs, dim=-1), pooled

    @torch.inference_mode()
    def vae_decode(self, latents: torch.Tensor) -> torch.Tensor:
        return self.vae.decode(latents.to(self.device, torch.float32))

    @torch.inference_mode()
    def sample(self, latents: torch.Tensor, context: torch.Tensor,
               uncond_context: torch.Tensor, seeds, steps: int, cfg: float,
               sampler_name: str, scheduler: str, denoise: float = 1.0,
               y: Optional[torch.Tensor] = None, add_noise: bool = True,
               sample_idx=None) -> torch.Tensor:
        """schedule -> initial noise -> sampler loop -> latents.

        ``seeds``: per-sample 64-bit host seeds [B]; ``sample_idx``:
        per-sample fold-in indices (default: the batch position).  The
        initial noise is ``normal(fold_in(key_b, 0x7FFFFFFF))`` per
        sample, scaled by the first sigma and added to ``latents``."""
        sampler = get_sampler(sampler_name)
        dev = self.device
        sigmas = torch.as_tensor(sch.compute_sigmas(
            self.schedule, scheduler, steps, denoise), device=dev)
        x = latents.to(dev, torch.float32)
        if add_noise:
            keys = sample_keys(seeds, sample_idx)
            x = x + batch_normal(keys, INIT_NOISE_INDEX, x.shape[1:],
                                 dev) * sigmas[0]
        den = make_denoiser(self.unet, self.schedule, self.prediction_type,
                            device=dev)
        model = cfg_denoiser_multi(den, [(context.to(dev), None, 1.0)],
                                   uncond_context.to(dev), float(cfg))
        extra = {} if y is None else {"y": y.to(dev)}
        return sampler(model, x, sigmas, extra_args=extra)


def _virtual_module(make: Callable[[], nn.Module], seed: int,
                    device: torch.device, dtype: torch.dtype) -> nn.Module:
    """Build a module without allocating, then give it its weights
    directly on ``device`` in ``dtype`` and fill them virtually."""
    with torch.device("meta"):
        module = make()
    module = module.to(dtype=dtype).to_empty(device=device)
    fill_virtual(module, seed)
    return module.eval()


_pipeline_cache: Dict[Tuple, DiffusionPipeline] = {}
_pipeline_lock = threading.Lock()


def load_pipeline(ckpt_name: str, models_dir: Optional[str] = None,
                  family_name: Optional[str] = None,
                  device="cuda") -> DiffusionPipeline:
    """Virtually initialize the named checkpoint on ``device`` (cached
    per name, resolved family, models dir and device)."""
    device = torch.device(device)
    fam = get_family(family_name or detect_family(ckpt_name))
    key = (ckpt_name, fam.name, models_dir or "", str(device))
    with _pipeline_lock:
        pipe = _pipeline_cache.get(key)
        if pipe is not None:
            return pipe
        if models_dir and os.path.exists(
                os.path.join(models_dir, ckpt_name.replace("\\", "/"))):
            raise NotImplementedError(
                f"loading checkpoint files ({ckpt_name}) is not ported to "
                "the torch package yet; only virtual checkpoints load")
        seed = _name_seed(ckpt_name)
        # UNet/CLIP weights stored in the family's compute dtype (bf16 on
        # the real families, fp32 on 'tiny'); the VAE stays fp32 (its
        # decode is where bf16 weights visibly cost quality)
        tower_dt = fam.unet.dtype
        unet = _virtual_module(lambda: unet_mod.UNet(fam.unet), seed,
                               device, tower_dt)
        clips = [_virtual_module(lambda c=c: clip_mod.CLIPTextModel(c),
                                 seed + 1 + i, device, tower_dt)
                 for i, c in enumerate(fam.clips)]
        vae = _virtual_module(lambda: vae_mod.VAE(fam.vae), seed + 100,
                              device, torch.float32)
        pipe = DiffusionPipeline(ckpt_name, fam, unet, clips, vae, device,
                                 assets_dir=models_dir)
        _pipeline_cache[key] = pipe
        return pipe


def clear_pipeline_cache() -> None:
    with _pipeline_lock:
        _pipeline_cache.clear()
