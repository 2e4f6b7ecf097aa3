"""Model families, virtual checkpoints and the DiffusionPipeline bundle in
PyTorch: the counterpart of ``comfyui_distributed_tpu/models/registry.py``.

CheckpointLoaderSimple hands back one :class:`DiffusionPipeline` as
(MODEL, CLIP, VAE), UpscaleModelLoader an RRDB network
(:func:`load_upscaler`) and ControlNetLoader a ControlNet
(:func:`load_controlnet`).  A file of that name in ``models_dir`` is
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
import time
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch
from torch import nn

from comfyui_distributed_tpu_torch.models import checkpoints as ckpt
from comfyui_distributed_tpu_torch.models import clip as clip_mod
from comfyui_distributed_tpu_torch.models import clip_vision as cv_mod
from comfyui_distributed_tpu_torch.models import controlnet as cn_mod
from comfyui_distributed_tpu_torch.models import schedules as sch
from comfyui_distributed_tpu_torch.models import unet as unet_mod
from comfyui_distributed_tpu_torch.models import upscalers as up_mod
from comfyui_distributed_tpu_torch.models import vae as vae_mod
from comfyui_distributed_tpu_torch.models.denoiser import (
    ControlSpec,
    make_denoiser,
    make_t_from_sigma,
)
from comfyui_distributed_tpu_torch.models.prng import (
    INIT_NOISE_INDEX,
    batch_normal,
    sample_keys,
)
from comfyui_distributed_tpu_torch.models.samplers import (
    _norm_entries,
    cfg_denoiser_dual,
    cfg_denoiser_multi,
    cfg_denoiser_perp_neg,
    cfg_denoiser_sag,
    get_sampler,
    get_sampler_step,
)
from comfyui_distributed_tpu_torch.models.tokenizer import (
    encode_with_embeddings,
    has_embedding_refs,
    make_tokenizer,
)
from comfyui_distributed_tpu_torch.models.weights import (fill_virtual,
                                                          with_params)
from comfyui_distributed_tpu_torch.ops.tiling import (
    tiled_apply,
    tiled_apply_down,
)
from comfyui_distributed_tpu_torch.utils.log import log


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
    "sd21_inpaint": ModelFamily(       # 512-inpainting-ema (eps line)
        name="sd21_inpaint",
        unet=dataclasses.replace(unet_mod.SD21_BASE_CONFIG, in_channels=9),
        vae=vae_mod.SD_VAE_CONFIG,
        clips=(clip_mod.OPEN_CLIP_H_CONFIG,),
    ),
    "sdxl_inpaint": ModelFamily(
        name="sdxl_inpaint",
        unet=dataclasses.replace(unet_mod.SDXL_CONFIG, in_channels=9),
        vae=vae_mod.SDXL_VAE_CONFIG,
        clips=(clip_mod.CLIP_L_SDXL_CONFIG, clip_mod.OPEN_CLIP_BIGG_CONFIG),
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
    ``DTPU_DEFAULT_FAMILY`` overrides (tests force 'tiny')."""
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
        raise KeyError(
            f"unknown model family {name!r}; known: {sorted(FAMILIES)}")
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
        # RescaleCFG's multiplier (0: off), set by derive_pipeline
        self.cfg_rescale = 0.0
        # continuous batching's step callables (denoise_step_fn), one a
        # (sampler, cfg, rows, latent size, ADM, prediction type)
        self._step_fns: Dict[Tuple, Callable] = {}
        self._step_lock = threading.Lock()
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
        families ignore it.  ``embedding:name`` references (textual
        inversion) splice the vectors of ``<assets_dir>/embeddings/
        <name>`` into each tower's token stream
        (:func:`load_textual_embedding`); a name without a file is
        dropped."""
        outs, pooled = [], None

        def dev(arrays):
            return torch.as_tensor(np.stack(arrays), device=self.device)

        for i, m in enumerate(self._require(self.clip_models,
                                            "text encoder")):
            ts = texts if i == 0 or texts_alt is None else texts_alt
            if any(has_embedding_refs(t) for t in ts):
                width = int(m.cfg.width)

                def look(name, _i=i, _w=width):
                    return load_textual_embedding(name, self.assets_dir, _w,
                                                  tower_idx=_i)

                quads = [encode_with_embeddings(self.tokenizer, t, look,
                                                width) for t in ts]
                wa = dev([q[1] for q in quads])
                hidden, pooled = m(dev([q[0] for q in quads]).long(),
                                   dev([q[2] for q in quads]),
                                   dev([q[3] for q in quads]))
            else:
                pairs = [self.tokenizer.encode(t) for t in ts]
                wa = dev([w for _, w in pairs])
                hidden, pooled = m(dev([x for x, _ in pairs]).long())
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

    def _vae_tiles(self, tile_size: int, overlap: int) -> Tuple[int, int]:
        """(tile, overlap) in latent units: the JAX package's arithmetic,
        the tile at least twice the overlap."""
        ds = self.family.vae.downscale
        lo = max(overlap // ds, 1)
        return max(tile_size // ds, 2 * lo), lo

    @torch.inference_mode()
    def vae_encode_tiled(self, images: torch.Tensor, tile_size: int = 512,
                         overlap: int = 64,
                         check_interrupt: Optional[Callable[[], None]] = None
                         ) -> torch.Tensor:
        """Encode in overlapping pixel tiles, feather-blended at latent
        resolution (ComfyUI's VAEEncodeTiled).  Each tile's GroupNorm
        statistics are its own, so the result is close to the one-shot
        encode, not equal; a source that fits one tile takes the
        one-shot encode."""
        ds = self.family.vae.downscale
        lt, lo = self._vae_tiles(tile_size, overlap)
        if images.shape[1] // ds <= lt and images.shape[2] // ds <= lt:
            return self.vae_encode(images)
        return tiled_apply_down(
            self.vae_encode, images.to(self.device, torch.float32), lt, lo,
            ds, out_channels=self.family.latent_channels,
            check_interrupt=check_interrupt)

    @torch.inference_mode()
    def vae_decode_tiled(self, latents: torch.Tensor, tile_size: int = 512,
                         overlap: int = 64,
                         check_interrupt: Optional[Callable[[], None]] = None
                         ) -> torch.Tensor:
        """Decode in overlapping latent tiles with feathered blending
        (ComfyUI's VAEDecodeTiled): the decoder's activations are bounded
        by the tile.  Close to the one-shot decode, not equal; a latent
        that fits one tile takes the one-shot decode."""
        lt, lo = self._vae_tiles(tile_size, overlap)
        if latents.shape[1] <= lt and latents.shape[2] <= lt:
            return self.vae_decode(latents)
        return tiled_apply(
            self.vae_decode, latents.to(self.device, torch.float32), lt, lo,
            self.family.vae.downscale, out_channels=3,
            check_interrupt=check_interrupt)

    @torch.inference_mode()
    def sample(self, latents: torch.Tensor, context, uncond_context,
               seeds, steps: int, cfg: float,
               sampler_name: str, scheduler: str, denoise: float = 1.0,
               y=None, add_noise: bool = True,
               sample_idx=None, start_step: int = 0,
               end_step: Optional[int] = None,
               force_full_denoise: bool = False,
               noise_mask: Optional[torch.Tensor] = None,
               c_concat: Optional[torch.Tensor] = None,
               control=None, sigmas_override=None,
               middle_context: Optional[torch.Tensor] = None,
               cfg2: float = 1.0, guidance: str = "dual",
               gligen_objs=None) -> torch.Tensor:
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
        every row block, or a list with one per entry, conds first.
        ``control``: the ops layer's ControlNet links, each ``(net, hint
        [B, 8h, 8w, 3], (cond strengths, uncond strengths), windows)``
        with one strength an entry and ``windows`` None or ``(cond
        windows, uncond windows)`` of sigma pairs (or None) an entry;
        each link's strengths and windows flatten in lockstep to the
        stacked blocks that run (the uncond entries' only at cfg != 1).
        A deep-shrink pipeline (``deep_shrink_spec``) samples with the
        shrunk UNet while the step's timestep lies in its window, with
        the plain one else, and without the patch under a control (the
        residuals' shapes cannot follow the shrunk encoder), which it
        logs.

        ``sigmas_override`` (SamplerCustom and its Advanced form): the
        exact host sigma sequence, 1-D, in any order (FlipSigmas feeds
        it ascending); the scheduler, steps, denoise and window
        arguments are ignored, and fewer than two sigmas return
        ``latents`` unchanged.  A tensor raises: the sigmas stay on the
        host.  ``middle_context`` [B, T, C] (DualCFGGuider,
        PerpNegGuider, the PerpNeg patch): the third row block of a
        [cond, middle, uncond] call, combined by
        ``cfg_denoiser_perp_neg`` when ``guidance`` is ``"perp_neg"``
        and by ``cfg_denoiser_dual`` else, at ``cfg`` and ``cfg2``; it
        takes one plain entry a side, ``y`` as one vector or three, and
        each control link's strengths and windows as flat
        [cond, middle, uncond] triples.  A RescaleCFG pipeline
        (``cfg_rescale``) rescales every combine.  A SAG pipeline
        (``sag_params``) samples with ``cfg_denoiser_sag`` where it
        applies: cfg != 1, no middle, no control, one plain entry a side
        and a middle block that HyperTile does not fold; else it logs
        and samples without it.  Deep shrink yields to SAG, with a log
        line.  A hypernetwork pipeline (``hypernets``: (hypernetwork,
        strength) entries) transforms the context in every denoiser.

        ``gligen_objs`` (a GLIGEN pipeline, ``ops/basic.py:
        gligen_attach``): ``(sets [S, B, n, D], null set [B, n, D],
        indices)``, the grounding tokens of each distinct spec and the
        null set, and one index a row block (conds first, then the
        middle, then unconds; -1 the null set): each block's rows get
        their set."""
        sampler = get_sampler(sampler_name)
        dev = self.device
        self._require(self.unet, "UNet")
        conds, unconds = _entries(context, dev), _entries(uncond_context,
                                                          dev)
        dual = middle_context is not None
        if dual and (len(conds) != 1 or len(unconds) != 1 or any(
                m is not None or s != 1.0 or sr is not None
                for _, m, s, sr in conds + unconds)):
            raise ValueError(f"3-row guidance ({guidance}) requires plain "
                             "single-entry positive/negative "
                             "conditionings")
        if sigmas_override is not None:
            if isinstance(sigmas_override, torch.Tensor):
                raise TypeError("sigmas_override takes host sigmas (a "
                                "numpy array), not a tensor")
            sigmas = np.asarray(sigmas_override, np.float32)
            if sigmas.ndim != 1:
                raise ValueError("sigmas_override must be a 1-D sigma "
                                 "sequence (order is the sampler's "
                                 "business: FlipSigmas feeds ascending)")
            if sigmas.shape[0] < 2:
                return latents
        else:
            # host float32 sigmas: the sampler's branches and
            # coefficients never wait for the card
            sigmas = sch.compute_sigmas(self.schedule, scheduler, steps,
                                        denoise)
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
        concat = None if c_concat is None else c_concat.to(dev,
                                                           torch.float32)
        chain = None
        if control:
            with_uncond = float(cfg) != 1.0
            chain = []
            for net, hint, strengths, windows in control:
                if not dual:
                    # (cond strengths, uncond strengths) flatten to the
                    # blocks that run, the windows in lockstep
                    pos_s, neg_s = strengths
                    strengths = tuple(pos_s) + (tuple(neg_s) if with_uncond
                                                else ())
                    if windows is not None:
                        windows = tuple(windows[0]) + (
                            tuple(windows[1]) if with_uncond else ())
                chain.append(ControlSpec(net, hint.to(dev),
                                         tuple(strengths), windows))
        cfg_rescale = float(self.cfg_rescale)
        ds_spec = getattr(self, "deep_shrink_spec", None)
        if ds_spec is not None and chain:
            log("deep shrink: ControlNet residual shapes can't follow "
                "the shrunk encoder; sampling WITHOUT the downscale "
                "patch")
            ds_spec = None
        sag = getattr(self, "sag_params", None)
        sag_ok = False
        if sag is not None:
            ucfg = self.family.unet
            mid_folded = ucfg.hypertile is not None \
                and ucfg.num_levels - 1 <= int(ucfg.hypertile[1])
            sag_ok = (not dual and float(cfg) != 1.0 and len(conds) == 1
                      and len(unconds) == 1 and not chain
                      and not mid_folded
                      and not any(m is not None or s != 1.0
                                  or sr is not None
                                  for _, m, s, sr in conds + unconds))
            if not sag_ok:
                log("SAG: unsupported combination (regional/dual/"
                    "control/cfg==1/hypertiled mid-block); sampling "
                    "WITHOUT self-attention guidance")
        if ds_spec is not None and sag_ok:
            log("deep shrink: does not compose with SAG's capture "
                "branch; sampling WITHOUT the downscale patch")
            ds_spec = None
        hn = getattr(self, "hypernets", None) or None
        den = make_denoiser(self.unet, self.schedule, self.prediction_type,
                            device=dev, concat=concat, control=chain,
                            hypernet=hn)
        if ds_spec is not None:
            den = self._deep_shrink_denoiser(den, ds_spec, concat)
        if dual:
            combine = cfg_denoiser_perp_neg if guidance == "perp_neg" \
                else cfg_denoiser_dual
            model = combine(den, conds[0][0], middle_context.to(dev),
                            unconds[0][0], float(cfg), float(cfg2),
                            cfg_rescale=cfg_rescale)
            reps = 3
        elif sag_ok:
            # the middle block's grid: each stride-2 level ceil-halves
            mh, mw = int(src.shape[1]), int(src.shape[2])
            for _ in range(self.family.unet.num_levels - 1):
                mh, mw = (mh + 1) // 2, (mw + 1) // 2
            den_cap = make_denoiser(self.unet, self.schedule,
                                    self.prediction_type, device=dev,
                                    concat=concat, capture=True,
                                    hypernet=hn)
            model = cfg_denoiser_sag(den_cap, den, conds[0][0],
                                     unconds[0][0], float(cfg),
                                     float(sag[0]), float(sag[1]),
                                     (mh, mw), cfg_rescale=cfg_rescale)
            reps = 2
        else:
            model = cfg_denoiser_multi(den, conds, unconds, float(cfg),
                                       cfg_rescale=cfg_rescale)
            reps = len(conds) + (len(unconds) if float(cfg) != 1.0 else 0)
        if noise_mask is not None:
            m = noise_mask.to(dev, torch.float32)
            model = _masked_model(model, m, src, noise)
        extra = {} if y is None else {"y": stack_y(y, reps, dev)}
        if gligen_objs is not None:
            sets, null, idxs = gligen_objs
            parts = [sets[i] if i >= 0 else null
                     for i in tuple(idxs)[:reps]]
            parts += [null] * (reps - len(parts))
            extra["objs"] = torch.cat(parts).to(dev)
        out = sampler(model, x, sigmas, extra_args=extra, keys=keys)
        if noise_mask is not None:
            out = out * m + src * (1.0 - m)
        return out

    def _deep_shrink_denoiser(self, den: Callable, ds_spec: Tuple,
                              concat: Optional[torch.Tensor]) -> Callable:
        """``den`` and the same denoiser over the shrunk UNet (one module,
        shared weights, ``unet.with_config``), the shrunk one taken while
        the call's timestep ``t`` has ``t_lo < t <= t_hi``.  ``t`` is
        the denoiser's own ``t_from_sigma`` of the step's sigma, a host
        float, computed on the host, so the branch makes the host wait
        for the card nowhere; a tensor sigma (continuous batching's,
        which refuses deep shrink) raises."""
        lvl, fac, t_lo, t_hi = ds_spec
        shrunk = make_denoiser(
            unet_mod.with_config(self.unet, dataclasses.replace(
                self.unet.cfg, deep_shrink=(int(lvl), float(fac)))),
            self.schedule, self.prediction_type, device=self.device,
            concat=concat, hypernet=getattr(self, "hypernets", None) or None)
        host_t = make_t_from_sigma(self.schedule, "cpu")

        def model(x, sigma, **kw):
            if isinstance(sigma, torch.Tensor):
                raise TypeError("deep shrink takes the step's sigma as a "
                                "host float, not a tensor")
            t0 = float(host_t(torch.tensor(float(sigma),
                                           dtype=torch.float32)))
            return (shrunk if t_lo < t0 <= t_hi else den)(x, sigma, **kw)

        return model

    def denoise_step_fn(self, sampler_name: str, cfg: float, rows: int,
                        latent_hw: tuple, has_y: bool = False
                        ) -> Tuple[Callable, bool]:
        """One denoise step over a padded ``rows``-sample batch: the
        continuous-batching executor's step (``workflow/
        batch_executor.py``), ``(step, built)`` with ``built`` True when
        this call made it.

            step(x, ctx, unc, y, keys, sigma, sigma_next, step_i,
                 active) -> x

        ``x`` [rows, h, w, C] on the pipeline's device, updated in
        place and returned; ``ctx``/``unc`` the cond and uncond contexts
        and ``y`` the ADM vectors of the rows (None without); ``keys``
        [rows, 2], ``sigma``, ``sigma_next``, ``step_i`` and ``active``
        per-row host vectors: each row at its own place in its own
        schedule, and an inactive row (a pad, a finished slot) passing
        through unchanged.  The model is :meth:`sample`'s for one plain
        cond and uncond entry (``make_denoiser``,
        ``cfg_denoiser_multi``, ``stack_y``) and the step the serial
        sampler's own (``samplers.SAMPLER_STEPS``).  Cached per
        (sampler, cfg, rows, latent size, ADM, prediction type); the
        JAX package's jit and ``constrain_rows`` (a tensor-parallel
        layout pin) have nothing to do here."""
        key = ("cb_step", str(sampler_name), float(cfg), 0.0, int(rows),
               tuple(int(d) for d in latent_hw), bool(has_y),
               self.prediction_type)
        with self._step_lock:
            fn = self._step_fns.get(key)
            if fn is not None:
                return fn, False
            fn = self._step_fns[key] = self._make_step(
                str(sampler_name), float(cfg))
            return fn, True

    def _make_step(self, sampler_name: str, cfg: float) -> Callable:
        step_impl = get_sampler_step(sampler_name)
        self._require(self.unet, "UNet")
        dev = self.device
        den = make_denoiser(self.unet, self.schedule, self.prediction_type,
                            device=dev)
        reps = 2 if cfg != 1.0 else 1

        @torch.inference_mode()
        def step(x, ctx, unc, y, keys, sigma, sigma_next, step_i, active):
            model = cfg_denoiser_multi(den, [(ctx, None, 1.0, None)],
                                       [(unc, None, 1.0, None)], cfg)
            extra = {} if y is None else {"y": stack_y(y, reps, dev)}
            x_new = step_impl(model, x, sigma, sigma_next, step_i, keys,
                              extra_args=extra)
            act = torch.from_numpy(np.asarray(active, bool)).to(
                dev, non_blocking=True).reshape((-1,) + (1,) * (x.ndim - 1))
            return torch.where(act, x_new, x, out=x)

        return step

    def warmup(self, height: int = 512, width: int = 512, batch: int = 1,
               steps: int = 20, cfg: float = 7.5,
               sampler_name: str = "euler", scheduler: str = "normal",
               denoise: float = 1.0, with_vae: bool = True
               ) -> Dict[str, float]:
        """Run one txt2img-shaped request on zeros: the CLIP encode of
        an empty prompt, ``steps`` sampler steps over a ``batch`` x
        ``height // 8`` x ``width // 8`` latent and (``with_vae``) its
        VAE decode, each synchronized.  There is no jit to warm: on a
        card this builds the attention kernels at their first use,
        loads cuBLAS and cuDNN and settles the caching allocator at the
        request's shapes, so the first real request pays none of it.
        Returns ``clip_s``, ``sample_s``, ``vae_s`` (with the VAE) and
        ``total_s``, wall seconds."""
        from comfyui_distributed_tpu_torch.ops.base import Conditioning
        from comfyui_distributed_tpu_torch.ops.basic import _sdxl_vector_cond

        def sync() -> None:
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)

        timings: Dict[str, float] = {}
        t_all = time.perf_counter()
        t0 = time.perf_counter()
        ctx1, pooled = self.encode_prompt([""])
        sync()
        timings["clip_s"] = time.perf_counter() - t0
        batch = max(int(batch), 1)
        lh, lw = max(int(height) // 8, 1), max(int(width) // 8, 1)
        context = ctx1.repeat(batch, 1, 1)
        y = None
        if self.family.unet.adm_in_channels is not None:
            y = _sdxl_vector_cond(
                self, Conditioning(context=ctx1, pooled=pooled), batch,
                lh * 8, lw * 8)
        lat = torch.zeros((batch, lh, lw, self.family.latent_channels),
                          dtype=torch.float32, device=self.device)
        t0 = time.perf_counter()
        out = self.sample(lat, context, context,
                          np.zeros((batch,), np.uint64), steps=int(steps),
                          cfg=float(cfg), sampler_name=str(sampler_name),
                          scheduler=str(scheduler), denoise=float(denoise),
                          y=y)
        sync()
        timings["sample_s"] = time.perf_counter() - t0
        if with_vae:
            t0 = time.perf_counter()
            self.vae_decode(out)
            sync()
            timings["vae_s"] = time.perf_counter() - t0
        timings["total_s"] = time.perf_counter() - t_all
        log(f"warmup {self.name}: {batch}x{width}x{height} "
            f"{sampler_name}x{steps} in {timings['total_s']:.2f}s "
            f"(clip {timings['clip_s']:.2f}s, "
            f"sample {timings['sample_s']:.2f}s)")
        return timings


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
    when the file is there (a single-file checkpoint, or a native
    checkpoint directory whose manifest names the family:
    ``runtime/checkpointing.py``), else virtually initialized (cached
    per name, resolved family, models dir and device).  UNet and CLIP
    weights are stored in the family's compute dtype (bf16 on the real families,
    fp32 on the tiny ones), the VAE's in fp32 (its decode is where bf16
    weights visibly cost quality), whatever the file holds."""
    from comfyui_distributed_tpu_torch.runtime import checkpointing
    device = torch.device(device)
    path = _model_file(models_dir, ckpt_name)
    # a native checkpoint's manifest names its family, over the name's
    meta = checkpointing.read_manifest(path) if path is not None \
        and checkpointing.is_native_checkpoint(path) else None
    fam = get_family(family_name or (
        meta["family"] if meta is not None else detect_family(ckpt_name)))
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
        if path is not None:
            if meta is not None:
                _, unet_sd, clip_sds, vae_sd = \
                    checkpointing.load_pipeline_checkpoint(path, meta)
            else:
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


# ControlNets, one a (name, family, models dir, device), and each file's
# inferred family, so a repeated load reads no file
_controlnet_cache: Dict[Tuple, nn.Module] = {}
_cn_family_cache: Dict[str, str] = {}
CONTROLNET_FAMILIES = ("sd15", "sd21", "sdxl", "tiny")


def load_controlnet(cn_name: str, models_dir: Optional[str] = None,
                    family_name: Optional[str] = None,
                    device="cuda") -> nn.Module:
    """ControlNetLoader: the named ControlNet on ``device``, cached.  A
    file of that name in ``models_dir`` is loaded (``control_model.*``
    or bare keys), and without ``family_name`` its family comes from the
    file's cross-attention width (the first of sd15, sd21, sdxl and tiny
    that has it; memoised by path), not from ``DTPU_DEFAULT_FAMILY``.
    With no file the net is virtual: ``family_name``, the env's family
    or sd15, the JAX package's weights drawn from the name, then the
    zero convs, ``mid_out`` and the ladder's last conv zeroed, so a
    fresh virtual net leaves the UNet exactly as it is.  Weights are
    stored in the family's compute dtype."""
    device = torch.device(device)
    fam = get_family(family_name or os.environ.get(FAMILY_ENV) or "sd15")
    path = _model_file(models_dir, cn_name)
    sd = None
    if path is not None and family_name is None:
        with _pipeline_lock:
            cached = _cn_family_cache.get(path)
        if cached is not None:
            fam = get_family(cached)
        else:
            sd = ckpt.load_state_dict(path)
            ctx_dim = ckpt.controlnet_context_dim(sd)
            if ctx_dim is not None and ctx_dim != fam.unet.context_dim:
                fam = next((get_family(n) for n in CONTROLNET_FAMILIES
                            if FAMILIES[n].unet.context_dim == ctx_dim),
                           fam)
            with _pipeline_lock:
                _cn_family_cache[path] = fam.name
    key = (cn_name, fam.name, models_dir or "", str(device))
    with _pipeline_lock:
        net = _controlnet_cache.get(key)
        if net is not None:
            return net
        if path is not None:
            state = ckpt.load_controlnet(path, fam.unet, state_dict=sd)
            fill = lambda m: ckpt.load_into(m, state)  # noqa: E731
            log(f"loaded ControlNet {cn_name} ({fam.name}) from {path}")
        else:
            seed = _name_seed(cn_name)

            def fill(m: nn.Module) -> None:
                fill_virtual(m, seed)
                cn_mod.zero_projections(m)
            log(f"virtual ControlNet {cn_name!r} ({fam.name}): no file on "
                f"disk, deterministic init (seed {seed}, zero projections)")
        net = _build(lambda: cn_mod.ControlNet(fam.unet), device,
                     fam.unet.dtype, fill)
        _controlnet_cache[key] = net
        return net


def load_diff_controlnet(model: DiffusionPipeline, cn_name: str,
                         models_dir: Optional[str] = None) -> nn.Module:
    """DiffControlNetLoader: a 'difference' ControlNet, whose stored
    weights are deltas over the base model's encoder.  The named net is
    loaded on ``model``'s family (:func:`load_controlnet`), then each of
    its leaves that ``model``'s UNet has at the same flax path and shape
    gains the UNet's value (summed in float32, stored in the net's
    dtype) in a new module; the zero convs and the other net-only leaves
    pass as they are.  Cached per (model, name, models dir)."""
    key = ("diff", model.cache_token, cn_name, models_dir or "")
    with _pipeline_lock:
        net = _controlnet_cache.get(key)
    if net is not None:
        return net
    raw = load_controlnet(cn_name, models_dir, family_name=model.family.name,
                          device=model.device)
    base = ckpt._by_path(model._require(model.unet, "UNet"))
    matched = [0]

    @torch.no_grad()
    def fill(m: nn.Module) -> None:
        src = ckpt._by_path(raw)
        for path, leaf in ckpt._by_path(m).items():
            value = src[path].param
            other = base.get(path)
            if other is not None and \
                    tuple(other.param.shape) == tuple(value.shape):
                matched[0] += 1
                value = value.float() + other.param.float()
            leaf.param.copy_(value)

    net = _build(lambda: cn_mod.ControlNet(raw.cfg), model.device,
                 raw.cfg.dtype, fill)
    log(f"DiffControlNetLoader: added base-model weights into "
        f"{matched[0]} shared leaves of {cn_name}")
    with _pipeline_lock:
        net = _controlnet_cache.setdefault(key, net)
    return net


_embedding_cache: Dict[Tuple, Optional[np.ndarray]] = {}


def load_textual_embedding(name: str, assets_dir: Optional[str],
                           width: int, tower_idx: int = 0
                           ) -> Optional[np.ndarray]:
    """The vectors of an ``embedding:name`` prompt reference:
    ``<assets_dir>/embeddings/<name>[.safetensors]``.  An SDXL file
    holds one tensor a tower (``clip_l`` for tower 0, ``clip_g`` for
    tower 1), an SD1.x export one ``emb_params``, else the first key in
    sorted order is taken.  Returns [K, width] float32, or None (no
    file, no key for the tower, or another width: dropped, as ComfyUI
    warns and skips)."""
    if not assets_dir:
        return None
    key = (assets_dir, name, width, tower_idx)
    if key in _embedding_cache:
        return _embedding_cache[key]
    base = os.path.join(assets_dir, "embeddings")
    path = None
    for cand in (name, name + ".safetensors"):
        p = os.path.join(base, cand.replace("\\", "/"))
        if os.path.isfile(p):
            path = p
            break
    result = None
    if path is not None and path.endswith(".safetensors"):
        tensors = ckpt.read_safetensors(path)
        keys = set(tensors)
        if keys & {"clip_l", "clip_g"}:
            chosen = {0: "clip_l", 1: "clip_g"}.get(tower_idx)
            chosen = chosen if chosen in keys else None
        elif "emb_params" in keys:
            chosen = "emb_params"
        else:
            chosen = next(iter(sorted(keys)), None)
        if chosen is not None:
            arr = tensors[chosen].float().numpy()
            arr = arr.reshape(-1, arr.shape[-1])
            if arr.shape[-1] == width:
                result = np.array(arr, np.float32)
            else:
                log(f"textual inversion {name!r}: width {arr.shape[-1]} != "
                    f"tower width {width}; dropping")
    _embedding_cache[key] = result
    return result


def clear_pipeline_cache() -> None:
    """Drop every cached pipeline (split parts too), derived pipeline,
    LoRA-patched pipeline, CLIP-vision tower, upscaler, ControlNet,
    textual-inversion embedding, hypernetwork, GLIGEN position net and
    style model, so their memory can go."""
    with _pipeline_lock:
        _pipeline_cache.clear()
        _derived_cache.clear()
        _upscaler_cache.clear()
        _clip_vision_cache.clear()
        _controlnet_cache.clear()
        _embedding_cache.clear()
    from comfyui_distributed_tpu_torch.models import gligen as gg_mod
    from comfyui_distributed_tpu_torch.models import hypernetwork as hn_mod
    from comfyui_distributed_tpu_torch.models import lora as lora_mod
    from comfyui_distributed_tpu_torch.models import style_model as sm_mod
    lora_mod.clear_lora_cache()
    hn_mod.clear_hypernetwork_cache()
    gg_mod.clear_gligen_cache()
    sm_mod.clear_style_model_cache()


# derived pipelines (clip-skip variants): modules shared with the base,
# each clone cached per (base, tag) so a repeated run gets the same one
_derived_cache: "collections.OrderedDict[Tuple, DiffusionPipeline]" = \
    collections.OrderedDict()
_DERIVED_CACHE_CAP = 8


def derived_cached(base: DiffusionPipeline,
                   tag: str) -> Optional[DiffusionPipeline]:
    """The clone :func:`derive_pipeline` holds for ``(base, tag)``, or
    None; builds nothing.  An op whose derivation inputs cost real work
    (a weight-space merge) asks first."""
    with _pipeline_lock:
        return _derived_cache.get((base.cache_token, tag))


def copy_sampler_patches(src: DiffusionPipeline,
                         dst: DiffusionPipeline) -> None:
    """What a derived or LoRA-patched pipeline keeps of its base's
    sampling: RescaleCFG's ``cfg_rescale``, the schedule (a zsnr
    rescale), the prediction type and every attribute a derivation set
    through ``extra_attrs`` (deep shrink's ``deep_shrink_spec``, SAG's
    ``sag_params``, PerpNeg's ``perp_neg_cond`` and
    ``perp_neg_scale``)."""
    dst.cfg_rescale = src.cfg_rescale
    dst.schedule = src.schedule
    dst.prediction_type = src.prediction_type
    riding = set(getattr(src, "_riding_attrs", ()))
    for attr in riding:
        if hasattr(src, attr):
            setattr(dst, attr, getattr(src, attr))
    dst._riding_attrs = frozenset(riding)


def derive_pipeline(base: DiffusionPipeline, tag: str,
                    family: Optional[ModelFamily] = None,
                    cfg_rescale: Optional[float] = None,
                    prediction_type: Optional[str] = None,
                    schedule: Optional[sch.DiscreteSchedule] = None,
                    extra_attrs: Optional[Dict[str, object]] = None,
                    unet: Optional[Callable[[], nn.Module]] = None,
                    unet_params: Optional[Dict[str, torch.Tensor]] = None,
                    clip_params: Optional[List[Dict[str, torch.Tensor]]]
                    = None) -> DiffusionPipeline:
    """Cached clone of ``base`` with a replacement family and sampling
    patches, everything else shared by reference: the UNet's weights
    under the new family's UNet config (:func:`unet_mod.with_config`:
    FreeU, HyperTile, SAG's capture), the VAE as it is, each text
    tower's weights under the new family's tower config
    (:func:`clip_mod.with_config`: clip-skip).  ``cfg_rescale``
    (RescaleCFG), ``prediction_type`` and ``schedule``
    (ModelSamplingDiscrete) replace the base's; they and ``extra_attrs``
    ride every further derivation (:func:`copy_sampler_patches`).
    ``unet``: makes the clone's UNet when its weights are not all the
    base's (GLIGEN's fusers), called only on a cache miss.
    ``unet_params`` and ``clip_params`` (one dict a tower): replacement
    tensors by parameter name (the weight-space merges), every other
    parameter shared with the base."""
    key = (base.cache_token, tag)
    with _pipeline_lock:
        if key in _derived_cache:
            _derived_cache.move_to_end(key)
            return _derived_cache[key]
    family = family or base.family
    unet_m = unet() if unet is not None else None if base.unet is None \
        else unet_mod.with_config(base.unet, family.unet)
    if unet_params is not None:
        unet_m = with_params(unet_m, unet_params)
    clips = [clip_mod.with_config(m, c)
             for m, c in zip(base.clip_models, family.clips, strict=True)]
    if clip_params is not None:
        clips = [with_params(m, p)
                 for m, p in zip(clips, clip_params, strict=True)]
    clone = DiffusionPipeline(f"{base.name}|{tag}", family, unet_m, clips,
                              base.vae, base.device,
                              assets_dir=base.assets_dir)
    copy_sampler_patches(base, clone)
    if cfg_rescale is not None:
        clone.cfg_rescale = cfg_rescale
    if prediction_type is not None:
        clone.prediction_type = prediction_type
    if schedule is not None:
        clone.schedule = schedule
    if extra_attrs:
        for k, v in extra_attrs.items():
            setattr(clone, k, v)
        clone._riding_attrs = frozenset(set(clone._riding_attrs)
                                        | set(extra_attrs))
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
