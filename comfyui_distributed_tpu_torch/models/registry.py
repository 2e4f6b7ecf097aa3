"""Model families, virtual checkpoints and the DiffusionPipeline bundle in
PyTorch: the counterpart of ``comfyui_distributed_tpu/models/registry.py``.

CheckpointLoaderSimple hands back one :class:`DiffusionPipeline` as
(MODEL, CLIP, VAE), and UpscaleModelLoader an RRDB network
(:func:`load_upscaler`).  A file of that name in ``models_dir`` is
loaded (``models/checkpoints.py``); with no file, parameters are
virtually initialized from the name (``models/weights.py``): the same
name gives the same weights as the JAX package, on any host.  Either
way the modules are built on ``meta`` and get their storage on the
device directly, so no copy of the weights is built on the host.
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

from comfyui_distributed_tpu_torch.models import checkpoints as ckpt
from comfyui_distributed_tpu_torch.models import clip as clip_mod
from comfyui_distributed_tpu_torch.models import schedules as sch
from comfyui_distributed_tpu_torch.models import unet as unet_mod
from comfyui_distributed_tpu_torch.models import upscalers as up_mod
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
    # SDXL-shaped tiny family: an ADM head wide enough (128 > the tiny
    # pooled width 64) that CLIPTextEncodeSDXL's size embeddings reach
    # the UNet
    "tiny_sdxl": ModelFamily(
        name="tiny_sdxl",
        unet=dataclasses.replace(unet_mod.TINY_CONFIG, adm_in_channels=128),
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
    def encode_prompt(self, texts: List[str],
                      texts_alt: Optional[List[str]] = None
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(context [B, 77, sum(widths)], pooled [B, pooled_dim]), fp32.
        Multi-tower families (SDXL) concatenate the hidden widths; pooled
        comes from the last tower.  Token weights scale the hidden states
        around the per-sequence mean (ComfyUI-style emphasis).
        ``texts_alt``: the prompts of every tower after the first
        (CLIPTextEncodeSDXL's text_g beside text_l); single-tower
        families ignore it."""
        outs, pooled = [], None
        for i, m in enumerate(self.clip_models):
            ts = texts if i == 0 or texts_alt is None else texts_alt
            pairs = [self.tokenizer.encode(t) for t in ts]
            ids = torch.as_tensor(np.stack([x for x, _ in pairs]),
                                  device=self.device).long()
            wa = torch.as_tensor(np.stack([w for _, w in pairs]),
                                 device=self.device)
            hidden, pooled = m(ids)
            mean = hidden.mean(dim=1, keepdim=True)
            outs.append(mean + (hidden - mean) * wa[..., None])
        return torch.cat(outs, dim=-1), pooled

    @torch.inference_mode()
    def vae_encode(self, images: torch.Tensor) -> torch.Tensor:
        """images [B, H, W, 3] in [0, 1] -> scaled latents (the mean: no
        sample is drawn, as in the JAX pipeline)."""
        return self.vae.encode(images.to(self.device, torch.float32))

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
        # host float32 sigmas: the sampler's branches and coefficients
        # never wait for the card
        sigmas = sch.compute_sigmas(self.schedule, scheduler, steps, denoise)
        x = latents.to(dev, torch.float32)
        keys = sample_keys(seeds, sample_idx)
        if add_noise:
            x = x + batch_normal(keys, INIT_NOISE_INDEX, x.shape[1:],
                                 dev) * float(sigmas[0])
        den = make_denoiser(self.unet, self.schedule, self.prediction_type,
                            device=dev)
        model = cfg_denoiser_multi(den, [(context.to(dev), None, 1.0)],
                                   uncond_context.to(dev), float(cfg))
        extra = {} if y is None else {"y": y.to(dev)}
        return sampler(model, x, sigmas, extra_args=extra, keys=keys)


def _build(make: Callable[[], nn.Module], device: torch.device,
           dtype: torch.dtype, fill: Callable[[nn.Module], None]
           ) -> nn.Module:
    """Build a module without allocating, give it storage directly on
    ``device`` in ``dtype``, then ``fill`` its parameters."""
    with torch.device("meta"):
        module = make()
    module = module.to(dtype=dtype).to_empty(device=device)
    fill(module)
    return module.eval()


def _model_file(models_dir: Optional[str], name: str) -> Optional[str]:
    """The file ``name`` names in ``models_dir``, when it is there."""
    if not models_dir:
        return None
    path = os.path.join(models_dir, name.replace("\\", "/"))
    return path if os.path.exists(path) else None


_pipeline_cache: Dict[Tuple, DiffusionPipeline] = {}
_pipeline_lock = threading.Lock()


def load_pipeline(ckpt_name: str, models_dir: Optional[str] = None,
                  family_name: Optional[str] = None,
                  device="cuda") -> DiffusionPipeline:
    """The named checkpoint on ``device``: loaded from ``models_dir``
    when the file is there, else virtually initialized (cached per name,
    resolved family, models dir and device).  UNet and CLIP weights are
    stored in the family's compute dtype (bf16 on the real families,
    fp32 on the tiny ones), the VAE's in fp32 (its decode is where bf16
    weights visibly cost quality), whatever the file holds."""
    device = torch.device(device)
    fam = get_family(family_name or detect_family(ckpt_name))
    key = (ckpt_name, fam.name, models_dir or "", str(device))
    with _pipeline_lock:
        pipe = _pipeline_cache.get(key)
        if pipe is not None:
            return pipe
        tower_dt = fam.unet.dtype
        # the modules in order: UNet, each CLIP tower, VAE
        makes = ([(lambda: unet_mod.UNet(fam.unet), tower_dt)]
                 + [(lambda c=c: clip_mod.CLIPTextModel(c), tower_dt)
                    for c in fam.clips]
                 + [(lambda: vae_mod.VAE(fam.vae), torch.float32)])
        path = _model_file(models_dir, ckpt_name)
        if path is not None:
            unet_sd, clip_sds, vae_sd = ckpt.load_checkpoint(path, fam)
            states = [unet_sd] + clip_sds + [vae_sd]

            def fill(i: int, m: nn.Module) -> None:
                ckpt.load_into(m, states[i])
        else:
            seed = _name_seed(ckpt_name)
            seeds = [seed + i for i in range(1 + len(fam.clips))] \
                + [seed + 100]

            def fill(i: int, m: nn.Module) -> None:
                fill_virtual(m, seeds[i])
        unet, *clips, vae = [
            _build(make, device, dt, lambda m, i=i: fill(i, m))
            for i, (make, dt) in enumerate(makes)]
        pipe = DiffusionPipeline(ckpt_name, fam, unet, clips, vae, device,
                                 assets_dir=models_dir)
        _pipeline_cache[key] = pipe
        return pipe


def clear_pipeline_cache() -> None:
    with _pipeline_lock:
        _pipeline_cache.clear()
        _upscaler_cache.clear()


@dataclasses.dataclass(frozen=True)
class Upscaler:
    """UPSCALE_MODEL wire value: the network and its scale."""
    name: str
    net: nn.Module
    scale: int

    @torch.inference_mode()
    def __call__(self, images: torch.Tensor) -> torch.Tensor:
        dev = next(self.net.parameters()).device
        return self.net(images.to(dev, torch.float32))


_upscaler_cache: Dict[Tuple, Upscaler] = {}


def upscaler_config(model_name: str) -> up_mod.RRDBConfig:
    """The JAX package's rules: "tiny" in the name or
    ``DTPU_DEFAULT_FAMILY=tiny`` -> the tiny RRDB; else ESRGAN's 4x
    network at the first of 8x, 4x, 2x, 1x that the name holds (4 when
    none does)."""
    lowered = model_name.lower()
    if "tiny" in lowered or os.environ.get(FAMILY_ENV) == "tiny":
        return up_mod.TINY_RRDB_CONFIG
    scale = next((s for s in (8, 4, 2, 1) if f"{s}x" in lowered), 4)
    return dataclasses.replace(up_mod.ESRGAN_4X_CONFIG, scale=scale)


def load_upscaler(model_name: str, models_dir: Optional[str] = None,
                  device="cuda") -> Upscaler:
    """The named super-resolution network on ``device``, cached per name,
    config, models dir and device: loaded from ``models_dir`` when the
    file is there (any of the three ESRGAN namings), else virtually
    initialized with the JAX package's weights (the name's seed with no
    offset, flax paths from the network's root).  Weights are stored in
    fp32 and cast per layer, as flax does."""
    device = torch.device(device)
    cfg = upscaler_config(model_name)
    key = (model_name, cfg, models_dir or "", str(device))
    with _pipeline_lock:
        up = _upscaler_cache.get(key)
        if up is not None:
            return up
        path = _model_file(models_dir, model_name)
        if path is not None:
            state = ckpt.load_upscaler_checkpoint(path, cfg)
            fill = lambda m: ckpt.load_into(m, state)  # noqa: E731
        else:
            seed = _name_seed(model_name)
            fill = lambda m: fill_virtual(m, seed)  # noqa: E731
        net = _build(lambda: up_mod.RRDBNet(cfg), device, torch.float32,
                     fill)
        up = _upscaler_cache[key] = Upscaler(model_name, net, cfg.scale)
        return up
