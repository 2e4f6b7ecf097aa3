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

import collections
import dataclasses
import hashlib
import itertools
import os
import threading
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch
from torch import nn

from comfyui_distributed_tpu_torch.models import checkpoints as ckpt
from comfyui_distributed_tpu_torch.models import clip as clip_mod
from comfyui_distributed_tpu_torch.models import clip_vision as cv_mod
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
    _norm_entries,
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
    # how the UNet's ADM vector is built: "sdxl" (pooled text and size
    # embeddings) or "unclip" (the noise-augmented CLIP-vision embedding
    # and its noise level: ``ops/basic.py:_unclip_vector_cond``)
    adm_kind: str = "sdxl"
    # the text towers' key prefixes in a single-file checkpoint, where
    # the family departs from the standard layouts
    # (``checkpoints._clip_prefixes`` falls back to those when None)
    clip_prefixes: Optional[Tuple[str, ...]] = None


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
    # SDXL refiner: the bigG tower only, stored as embedder 0 of the
    # conditioner, and a 2560-wide ADM laid out as
    # CLIPTextEncodeSDXLRefiner emits it (pooled + 5 size scalars)
    "sdxl_refiner": ModelFamily(
        name="sdxl_refiner",
        unet=unet_mod.SDXL_REFINER_CONFIG,
        vae=vae_mod.SDXL_VAE_CONFIG,
        clips=(clip_mod.OPEN_CLIP_BIGG_CONFIG,),
        clip_prefixes=("conditioner.embedders.0.model.",),
    ),
    "sd21": ModelFamily(
        name="sd21",
        unet=unet_mod.SD21_CONFIG,
        vae=vae_mod.SD_VAE_CONFIG,
        clips=(clip_mod.OPEN_CLIP_H_CONFIG,),
    ),
    "sd21_base": ModelFamily(
        name="sd21_base",
        unet=unet_mod.SD21_BASE_CONFIG,
        vae=vae_mod.SD_VAE_CONFIG,
        clips=(clip_mod.OPEN_CLIP_H_CONFIG,),
    ),
    # inpaint models: the UNet takes [latent (4), mask (1), masked-image
    # latent (4)] = 9 input channels (the sd-v1.5-inpainting layout);
    # everything else is the base family's
    "sd15_inpaint": ModelFamily(
        name="sd15_inpaint",
        unet=dataclasses.replace(unet_mod.SD15_CONFIG, in_channels=9),
        vae=vae_mod.SD_VAE_CONFIG,
        clips=(clip_mod.CLIP_L_CONFIG,),
    ),
    # InstructPix2Pix: [latent (4), source-image latent (4)] = 8 input
    # channels, no mask
    "sd15_ip2p": ModelFamily(
        name="sd15_ip2p",
        unet=dataclasses.replace(unet_mod.SD15_CONFIG, in_channels=8),
        vae=vae_mod.SD_VAE_CONFIG,
        clips=(clip_mod.CLIP_L_CONFIG,),
    ),
    # SD2.1-unclip-h: the v-prediction SD2.1 UNet with an ADM head for
    # the noise-augmented ViT-H image embedding (1024) and its noise
    # level's timestep embedding (1024)
    "sd21_unclip": ModelFamily(
        name="sd21_unclip",
        unet=dataclasses.replace(unet_mod.SD21_CONFIG, adm_in_channels=2048),
        vae=vae_mod.SD_VAE_CONFIG,
        clips=(clip_mod.OPEN_CLIP_H_CONFIG,),
        adm_kind="unclip",
    ),
    "tiny": ModelFamily(
        name="tiny",
        unet=unet_mod.TINY_CONFIG,
        vae=vae_mod.TINY_VAE_CONFIG,
        clips=(clip_mod.TINY_CLIP_CONFIG,),
    ),
    "tiny_unclip": ModelFamily(
        name="tiny_unclip",
        unet=dataclasses.replace(unet_mod.TINY_CONFIG, adm_in_channels=64),
        vae=vae_mod.TINY_VAE_CONFIG,
        clips=(clip_mod.TINY_CLIP_CONFIG,),
        adm_kind="unclip",
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
    "tiny_inpaint": ModelFamily(
        name="tiny_inpaint",
        unet=dataclasses.replace(unet_mod.TINY_CONFIG, in_channels=9),
        vae=vae_mod.TINY_VAE_CONFIG,
        clips=(clip_mod.TINY_CLIP_CONFIG,),
    ),
    "tiny_ip2p": ModelFamily(
        name="tiny_ip2p",
        unet=dataclasses.replace(unet_mod.TINY_CONFIG, in_channels=8),
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


_pipeline_tokens = itertools.count()


class DiffusionPipeline:
    """(MODEL, CLIP, VAE) bundle + tokenizer + schedule, on one device.
    ``cache_token`` names this pipeline in the caches of the pipelines
    derived from it (:func:`derive_pipeline`, ``models/lora.py``).  A
    split loader's pipeline holds only its own part (``unet`` or ``vae``
    None, ``clip_models`` empty); using a part it lacks raises."""

    def __init__(self, name: str, family: ModelFamily,
                 unet: Optional[nn.Module], clip_models: List[nn.Module],
                 vae: Optional[nn.Module], device: torch.device,
                 assets_dir: Optional[str] = None):
        self.name = name
        self.family = family
        self.unet = unet
        self.clip_models = clip_models
        self.vae = vae
        self.device = device
        self.assets_dir = assets_dir
        self.cache_token = next(_pipeline_tokens)
        self.prediction_type = family.unet.prediction_type
        self.schedule = sch.make_discrete_schedule()
        # CLIP pads with EOT, OpenCLIP-only families with 0
        self.tokenizer = make_tokenizer(
            assets_dir=assets_dir,
            vocab_size=min(c.vocab_size for c in family.clips),
            pad_with_end=not all(c.layout == "openclip"
                                 for c in family.clips))

    def _require(self, part, what: str):
        if part is None or (isinstance(part, list) and not part):
            raise ValueError(f"{self.name!r} has no {what}: it comes from "
                             "a loader of another part")
        return part

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
        for i, m in enumerate(self._require(self.clip_models,
                                            "text encoder")):
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
        return self._require(self.vae, "VAE").encode(
            images.to(self.device, torch.float32))

    @torch.inference_mode()
    def vae_decode(self, latents: torch.Tensor) -> torch.Tensor:
        return self._require(self.vae, "VAE").decode(
            latents.to(self.device, torch.float32))

    @torch.inference_mode()
    def sample(self, latents: torch.Tensor, context, uncond_context,
               seeds, steps: int, cfg: float,
               sampler_name: str, scheduler: str, denoise: float = 1.0,
               y=None, add_noise: bool = True,
               sample_idx=None, start_step: int = 0,
               end_step: Optional[int] = None,
               force_full_denoise: bool = False,
               noise_mask: Optional[torch.Tensor] = None,
               c_concat: Optional[torch.Tensor] = None) -> torch.Tensor:
        """schedule -> initial noise -> sampler loop -> latents.

        ``seeds``: per-sample 64-bit host seeds [B]; ``sample_idx``:
        per-sample fold-in indices (default: the batch position).  The
        initial noise is ``normal(fold_in(key_b, 0x7FFFFFFF))`` per
        sample, scaled by the first sigma and added to ``latents``
        (nothing is added without ``add_noise``).
        ``start_step``/``end_step`` run a window of the schedule
        (KSamplerAdvanced): the sampler takes ``sigmas[start:end + 1]``,
        its step indices (and so its noise fold-ins) counting from 0 at
        the window's start, as the JAX sampler runs the sliced sigmas;
        the initial noise scales by the window's first sigma, and a
        window that stops early returns a still-noisy latent unless
        ``force_full_denoise`` zeroes its last sigma.  A window with
        start >= end returns ``latents`` unchanged.
        ``noise_mask`` [1 or B, h, w, 1] inpaints (1 = resample, 0 =
        keep the source), as ComfyUI's KSamplerX0Inpaint: every model
        call sees the source re-noised to the current sigma outside the
        mask (with the initial noise, zero without ``add_noise``), its
        output and its CFG++ ``last_uncond`` are re-anchored to the
        clean source there, and so is the sampler's result.
        ``c_concat`` [B, h, w, K]: the inpaint and ip2p models' extra
        UNet input channels (``make_denoiser``'s ``concat``).
        ``context`` / ``uncond_context``: one context [B, T, C] each, or
        lists of ``(context, area mask [1 or B, h, w, 1] or None,
        strength[, sigma_range])`` entries (regional prompting), every
        entry of both sides evaluated in one stacked model call
        (``cfg_denoiser_multi``).  ``y``: one ADM vector [B, A] for
        every row block, or a list with one per entry, conds first."""
        sampler = get_sampler(sampler_name)
        dev = self.device
        self._require(self.unet, "UNet")
        # host float32 sigmas: the sampler's branches and coefficients
        # never wait for the card
        sigmas = sch.compute_sigmas(self.schedule, scheduler, steps, denoise)
        start = max(int(start_step), 0)
        end = steps if end_step is None else min(int(end_step), steps)
        if start >= end:
            return latents
        if start > 0 or end < steps:
            sigmas = sigmas[start:end + 1].copy()
            if force_full_denoise:
                sigmas[-1] = 0.0
        want = self.family.unet.in_channels - int(latents.shape[-1])
        have = 0 if c_concat is None else int(c_concat.shape[-1])
        if want != have:
            raise ValueError(
                f"{self.family.name}'s UNet takes {want} channels beside "
                f"the latent's; the conditioning brings {have} (an inpaint "
                "model needs InpaintModelConditioning)")
        src = latents.to(dev, torch.float32)
        keys = sample_keys(seeds, sample_idx)
        noise = batch_normal(keys, INIT_NOISE_INDEX, src.shape[1:], dev) \
            if add_noise else None
        x = src + noise * float(sigmas[0]) if add_noise else src
        den = make_denoiser(self.unet, self.schedule, self.prediction_type,
                            device=dev, concat=None if c_concat is None
                            else c_concat.to(dev, torch.float32))
        conds, unconds = _entries(context, dev), _entries(uncond_context,
                                                          dev)
        model = cfg_denoiser_multi(den, conds, unconds, float(cfg))
        if noise_mask is not None:
            m = noise_mask.to(dev, torch.float32)
            model = _masked_model(model, m, src, noise)
        reps = len(conds) + (len(unconds) if float(cfg) != 1.0 else 0)
        extra = {} if y is None else {"y": stack_y(y, reps, dev)}
        out = sampler(model, x, sigmas, extra_args=extra, keys=keys)
        if noise_mask is not None:
            out = out * m + src * (1.0 - m)
        return out


def _entries(context, dev) -> List[Tuple]:
    """A bare context or an entry list -> ``(context, mask, strength,
    sigma_range)`` entries on ``dev``."""
    if isinstance(context, torch.Tensor):
        return [(context.to(dev), None, 1.0, None)]
    return [(c.to(dev), None if m is None else m.to(dev), s, sr)
            for c, m, s, sr in _norm_entries(context)]


def stack_y(y, reps: int, dev) -> torch.Tensor:
    """The ADM rows of a CFG model call: one vector per row block, a
    list (one per entry, conds first) cut to the ``reps`` blocks that
    run, a single vector repeated to them."""
    ys = list(y)[:reps] if isinstance(y, (list, tuple)) else [y] * reps
    ys = [v.to(dev) for v in ys]
    return ys[0] if reps == 1 else torch.cat(ys)


def _masked_model(inner: Callable, m: torch.Tensor, src: torch.Tensor,
                  noise: Optional[torch.Tensor]) -> Callable:
    """KSamplerX0Inpaint around ``inner``: the input blended with the
    source re-noised to the current sigma where ``m`` is 0 (zero noise
    when ``noise`` is None: the latent already is the noised state), the
    output re-anchored to ``src`` there; the CFG++ samplers read
    ``last_uncond`` off this callable, so it is re-exposed through the
    same blend."""
    keep = 1.0 - m
    noise = torch.zeros_like(src) if noise is None else noise

    def model(xi: torch.Tensor, sigma, **kw) -> torch.Tensor:
        s = sigma.reshape((-1,) + (1,) * (xi.ndim - 1)) \
            if isinstance(sigma, torch.Tensor) else float(sigma)
        xi = xi * m + (src + noise * s) * keep
        out = inner(xi, sigma, **kw)
        lu = getattr(inner, "last_uncond", out)
        model.last_uncond = lu * m + src * keep
        return out * m + src * keep

    return model


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


def _find_file(models_dir: Optional[str], name: str,
               subdirs: Tuple[str, ...] = ()) -> Optional[str]:
    """The file ``name`` in ``models_dir`` or the first of its
    ``subdirs`` that holds it."""
    for sub in ("",) + subdirs:
        path = _model_file(models_dir, os.path.join(sub, name) if sub
                           else name)
        if path is not None:
            return path
    return None


def _part_module(kind: str, cfg, device: torch.device, dtype: torch.dtype,
                 path: Optional[str], prefixes: Tuple[str, ...],
                 seed: int) -> nn.Module:
    """One pipeline part on ``device``: from the lone file at ``path``
    (its keys under one of ``prefixes`` or bare), else virtual from
    ``seed``."""
    make, _ = ckpt._part(kind, cfg)
    if path is not None:
        state = ckpt.load_part(ckpt.load_state_dict(path), kind, cfg,
                               prefixes)
        return _build(make, device, dtype, lambda m: ckpt.load_into(m, state))
    return _build(make, device, dtype, lambda m: fill_virtual(m, seed))


def load_vae(vae_name: str, models_dir: Optional[str] = None,
             family_name: Optional[str] = None,
             device="cuda") -> DiffusionPipeline:
    """VAELoader: a pipeline holding only a VAE, usable wherever a
    checkpoint's VAE is.  A file (with or without ``first_stage_model.``)
    loads; without one the VAE is virtual from the name's seed.  The
    family: ``family_name``, else ``DTPU_DEFAULT_FAMILY``, else ``tiny``
    when the name says so, else ``sd15``."""
    device = torch.device(device)
    default = "tiny" if "tiny" in vae_name.lower() else "sd15"
    fam = get_family(family_name or os.environ.get(FAMILY_ENV) or default)
    key = ("vae", vae_name, fam.name, models_dir or "", str(device))
    with _pipeline_lock:
        pipe = _pipeline_cache.get(key)
        if pipe is not None:
            return pipe
        vae = _part_module("vae", fam.vae, device, torch.float32,
                           _model_file(models_dir, vae_name),
                           (ckpt.VAE_PREFIX,), _name_seed(vae_name))
        pipe = _pipeline_cache[key] = DiffusionPipeline(
            f"vae:{vae_name}", fam, None, [], vae, device)
        return pipe


# CLIPLoader/DualCLIPLoader's ``type`` -> the family whose text towers
# the files hold
CLIP_TYPE_FAMILIES = {
    "stable_diffusion": "sd15",
    "sd1": "sd15",
    "sd2": "sd21",
    "sdxl": "sdxl",
    "tiny": "tiny",
}


def load_clip(clip_names: List[str], models_dir: Optional[str] = None,
              family_name: Optional[str] = None,
              device="cuda") -> DiffusionPipeline:
    """CLIPLoader/DualCLIPLoader: a pipeline holding only text towers,
    one file name a tower.  A file in ``models_dir``, ``clip/`` or
    ``text_encoders/`` loads with its keys under the tower's
    in-checkpoint prefix, ``text_model.`` or bare; a missing one is
    virtual, tower ``i`` from the name's seed plus ``i``."""
    device = torch.device(device)
    fam = get_family(family_name or os.environ.get(FAMILY_ENV) or "sd15")
    if len(clip_names) != len(fam.clips):
        raise ValueError(
            f"family {fam.name} has {len(fam.clips)} text tower(s), got "
            f"{len(clip_names)} file name(s): use "
            f"{'DualCLIPLoader' if len(fam.clips) == 2 else 'CLIPLoader'}")
    key = ("clip", tuple(clip_names), fam.name, models_dir or "",
           str(device))
    with _pipeline_lock:
        pipe = _pipeline_cache.get(key)
        if pipe is not None:
            return pipe
        clips = [
            _part_module("clip", ccfg, device, fam.unet.dtype,
                         _find_file(models_dir, name,
                                    ("clip", "text_encoders")),
                         (prefix, "text_model."), _name_seed(name) + i)
            for i, (name, ccfg, prefix) in enumerate(
                zip(clip_names, fam.clips, ckpt._clip_prefixes(fam)))]
        pipe = _pipeline_cache[key] = DiffusionPipeline(
            f"clip:{':'.join(clip_names)}", fam, None, clips, None, device,
            assets_dir=models_dir)
        return pipe


def load_unet(unet_name: str, models_dir: Optional[str] = None,
              family_name: Optional[str] = None,
              device="cuda") -> DiffusionPipeline:
    """UNETLoader: a pipeline holding only a UNet (the family from the
    name unless given).  A file in ``models_dir``, ``unet/`` or
    ``diffusion_models/`` loads with or without
    ``model.diffusion_model.``; a missing one is virtual from the name's
    seed.  The JAX package fills text towers and a VAE beside it (seeds
    + 1 + i and + 100) that no op reads off a MODEL wire; they are not
    built here."""
    device = torch.device(device)
    fam = get_family(family_name or detect_family(unet_name))
    key = ("unet", unet_name, fam.name, models_dir or "", str(device))
    with _pipeline_lock:
        pipe = _pipeline_cache.get(key)
        if pipe is not None:
            return pipe
        unet = _part_module("unet", fam.unet, device, fam.unet.dtype,
                            _find_file(models_dir, unet_name,
                                       ("unet", "diffusion_models")),
                            (ckpt.UNET_PREFIX,), _name_seed(unet_name))
        pipe = _pipeline_cache[key] = DiffusionPipeline(
            f"unet:{unet_name}", fam, unet, [], None, device,
            assets_dir=models_dir)
        return pipe


_clip_vision_cache: Dict[Tuple, "cv_mod.CLIPVisionTower"] = {}
CLIP_VISION_CONFIGS = {"vit_h": cv_mod.VIT_H_CONFIG,
                       "vit_l": cv_mod.VIT_L_CONFIG,
                       "tiny": cv_mod.TINY_VISION_CONFIG}


def load_clip_vision(clip_name: str, models_dir: Optional[str] = None,
                     config_name: Optional[str] = None,
                     device="cuda") -> "cv_mod.CLIPVisionTower":
    """CLIPVisionLoader: the image tower from an HF CLIPVisionModel file
    in ``models_dir`` or ``clip_vision/`` (ViT-H or ViT-L by its width,
    unless ``config_name`` says), else virtual from the name's seed
    (ViT-H, the tiny tower when the name says tiny or test).  Weights
    stay fp32, as the JAX package keeps them."""
    device = torch.device(device)
    key = (clip_name, config_name or "", models_dir or "", str(device))
    with _pipeline_lock:
        tower = _clip_vision_cache.get(key)
        if tower is not None:
            return tower
        path = _find_file(models_dir, clip_name, ("clip_vision",))
        if path is not None:
            sd = ckpt.load_state_dict(path)
            w = sd.get("vision_model.embeddings.class_embedding")
            width = int(w.shape[-1]) if w is not None else 1280
            cfg = CLIP_VISION_CONFIGS[config_name] if config_name \
                else (cv_mod.VIT_H_CONFIG if width >= 1280
                      else cv_mod.VIT_L_CONFIG)
            state = ckpt.load_part(sd, "clip_vision", cfg)
            fill = lambda m: ckpt.load_into(m, state)  # noqa: E731
        else:
            lowered = clip_name.lower()
            cfg = CLIP_VISION_CONFIGS.get(config_name or "") or (
                cv_mod.TINY_VISION_CONFIG
                if "tiny" in lowered or "test" in lowered
                else cv_mod.VIT_H_CONFIG)
            seed = _name_seed(clip_name)
            fill = lambda m: fill_virtual(m, seed)  # noqa: E731
        make, _ = ckpt._part("clip_vision", cfg)
        model = _build(make, device, torch.float32, fill)
        tower = _clip_vision_cache[key] = cv_mod.CLIPVisionTower(
            clip_name, cfg, model)
        return tower


def clear_pipeline_cache() -> None:
    """Drop every cached pipeline (split parts too), derived pipeline,
    LoRA-patched pipeline, CLIP-vision tower and upscaler, so their
    device memory can go."""
    with _pipeline_lock:
        _pipeline_cache.clear()
        _derived_cache.clear()
        _upscaler_cache.clear()
        _clip_vision_cache.clear()
    from comfyui_distributed_tpu_torch.models import lora as lora_mod
    lora_mod.clear_lora_cache()


# derived pipelines (clip-skip variants): modules shared with the base,
# each clone cached per (base, tag) so a repeated run gets the same one
_derived_cache: "collections.OrderedDict[Tuple, DiffusionPipeline]" = \
    collections.OrderedDict()
_DERIVED_CACHE_CAP = 8


def copy_sampler_patches(src: DiffusionPipeline,
                         dst: DiffusionPipeline) -> None:
    """What a derived or LoRA-patched pipeline keeps of its base's
    sampling: the schedule (the JAX package's other sampling patches,
    RescaleCFG and PerpNeg, are not ported)."""
    dst.schedule = src.schedule


def derive_pipeline(base: DiffusionPipeline, tag: str,
                    family: ModelFamily) -> DiffusionPipeline:
    """Cached clone of ``base`` with a replacement family, everything
    else shared by reference: the UNet and VAE as they are, each text
    tower's weights under the new family's tower config
    (:func:`clip_mod.with_config`)."""
    key = (base.cache_token, tag)
    with _pipeline_lock:
        if key in _derived_cache:
            _derived_cache.move_to_end(key)
            return _derived_cache[key]
    clone = DiffusionPipeline(
        f"{base.name}|{tag}", family, base.unet,
        [clip_mod.with_config(m, c)
         for m, c in zip(base.clip_models, family.clips, strict=True)],
        base.vae, base.device, assets_dir=base.assets_dir)
    copy_sampler_patches(base, clone)
    with _pipeline_lock:
        clone = _derived_cache.setdefault(key, clone)
        while len(_derived_cache) > _DERIVED_CACHE_CAP:
            _derived_cache.popitem(last=False)
    return clone


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
