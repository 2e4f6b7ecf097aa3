"""LoRA patching: kohya-format low-rank adapters merged into the port's
UNet and text towers, the counterpart of
``comfyui_distributed_tpu/models/lora.py``.

Kohya module names are the base checkpoint's torch module paths with the
dots flattened to underscores (``lora_unet_input_blocks_1_1_transformer_
blocks_0_attn1_to_q`` <- ``model.diffusion_model.input_blocks.1.1...
to_q.weight``).  Underscored names are ambiguous to parse, so the index
is built the other way: the torch keys the port's own export walk
(``models/checkpoints.py``) gives are flattened and looked up.  A delta
is added in torch layout and goes back to its parameter through the same
walk, so every layout transform (1x1 conv to Dense, OpenCLIP's packed
qkv) is the checkpoint loader's.

Text-tower prefixes: ``lora_te_`` (one tower), ``lora_te1_``/
``lora_te2_`` (SDXL's CLIP-L and bigG).

The merge, as the JAX package computes it: ``up @ down`` in fp32 (a
rank-r product that the JAX package also computes outside any kernel),
cast to the weight's dtype, scaled by ``strength * alpha / rank`` and
added in fp32; the sum is stored in the weight's dtype.  (numpy promotes
a bf16 array times a Python float to fp32, so the JAX merge holds the
fp32 sum and its bf16 layers round it once when they cast the kernel;
storing the rounded sum gives those numbers.)  A patched pipeline gets
new tensors only where a delta lands and shares every other parameter,
and the VAE, with its base by reference; the base stays untouched.
"""

from __future__ import annotations

import collections
import copy
import threading
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
from torch import nn

from comfyui_distributed_tpu_torch.models import checkpoints as ckpt
from comfyui_distributed_tpu_torch.models import registry

UNET_LORA_PREFIX = "lora_unet_"

Index = Dict[str, Tuple[str, Optional[slice]]]


def _te_prefixes(n_clips: int) -> List[str]:
    if n_clips == 1:
        return ["lora_te_"]
    return [f"lora_te{i + 1}_" for i in range(n_clips)]


def build_key_index(sd: Dict[str, torch.Tensor], family) -> Index:
    """kohya module name -> (torch weight key, row slice or None), from
    the exported state dict's own keys.

    An OpenCLIP-layout tower (SDXL's te2, the refiner's bigG) is trained
    by kohya against its HF conversion, so the HF names are indexed too:
    ``..._self_attn_q_proj`` onto rows [0:W] of the packed
    ``attn.in_proj_weight`` (k: [W:2W], v: [2W:3W]), ``mlp_fc1``/``fc2``
    onto ``mlp.c_fc``/``c_proj``."""
    index: Index = {}
    te_pre = _te_prefixes(len(family.clips))
    clip_prefixes = ckpt._clip_prefixes(family)
    for key in sd:
        if key.endswith(".in_proj_weight"):
            # packed qkv: "...attn.in_proj_weight", an underscore
            module = key[: -len("_weight")]
        elif key.endswith(".weight"):
            module = key[: -len(".weight")]
        else:
            continue
        if key.startswith(ckpt.UNET_PREFIX):
            flat = module[len(ckpt.UNET_PREFIX):].replace(".", "_")
            index[UNET_LORA_PREFIX + flat] = (key, None)
            continue
        for pre, lora_pre in zip(clip_prefixes, te_pre):
            if not key.startswith(pre.rsplit("text_model.", 1)[0]):
                continue
            if pre.endswith("text_model."):
                # HF tower: kohya's names start at "text_model."
                root = pre[: -len("text_model.")]
                flat = module[len(root):].replace(".", "_")
                index[lora_pre + flat] = (key, None)
            elif module.startswith(pre):
                _index_openclip_aliases(index, lora_pre, pre, module, key,
                                        family)
            break
    return index


def _index_openclip_aliases(index: Index, lora_pre: str, prefix: str,
                            module: str, key: str, family) -> None:
    """The HF-converted kohya names of an OpenCLIP-serialized tower."""
    width = next(c.width for c, p in zip(family.clips,
                                         ckpt._clip_prefixes(family))
                 if p == prefix)
    rel = module[len(prefix):]    # transformer.resblocks.0.attn.in_proj
    parts = rel.split(".")
    if len(parts) >= 4 and parts[0] == "transformer" \
            and parts[1] == "resblocks":
        hf_base = f"text_model_encoder_layers_{parts[2]}_"
        tail = ".".join(parts[3:])
        if tail == "attn.in_proj":
            for j, name in enumerate(("q_proj", "k_proj", "v_proj")):
                index[f"{lora_pre}{hf_base}self_attn_{name}"] = \
                    (key, slice(j * width, (j + 1) * width))
        elif tail == "attn.out_proj":
            index[f"{lora_pre}{hf_base}self_attn_out_proj"] = (key, None)
        elif tail == "mlp.c_fc":
            index[f"{lora_pre}{hf_base}mlp_fc1"] = (key, None)
        elif tail == "mlp.c_proj":
            index[f"{lora_pre}{hf_base}mlp_fc2"] = (key, None)
    # the native OpenCLIP spelling too (some tools write it)
    index[lora_pre + rel.replace(".", "_")] = (key, None)


def load_lora_state_dict(path: str) -> Dict[str, torch.Tensor]:
    """A LoRA file (safetensors or a torch pickle) as {key: CPU tensor}."""
    return ckpt.load_state_dict(path)


def virtual_lora_state_dict(name: str, index: Index,
                            sd: Dict[str, torch.Tensor], rank: int = 4,
                            max_modules: int = 8
                            ) -> Dict[str, torch.Tensor]:
    """The JAX package's deterministic stand-in for a missing LoRA file:
    rank ``rank`` adapters on the first ``max_modules`` index names, in
    sorted order, that end in q/k/v, drawn from
    ``np.random.default_rng`` seeded by the name, in the JAX package's
    order (each module's down, then its up)."""
    rng = np.random.default_rng(registry._name_seed(name))
    out: Dict[str, torch.Tensor] = {}
    picked = [m for m in sorted(index)
              if m.endswith(("to_q", "to_k", "to_v", "q_proj", "k_proj",
                             "v_proj"))][:max_modules]
    for mod in picked:
        key, rows = index[mod]
        shape = tuple(sd[key].shape)
        if len(shape) < 2:
            continue
        out_f = (rows.stop - rows.start) if rows is not None else shape[0]
        in_f = int(np.prod(shape[1:]))
        down = rng.standard_normal((rank, in_f)).astype(np.float32) * 0.01
        up = rng.standard_normal((out_f, rank)).astype(np.float32) * 0.01
        out[f"{mod}.lora_down.weight"] = torch.from_numpy(down)
        out[f"{mod}.lora_up.weight"] = torch.from_numpy(up)
        out[f"{mod}.alpha"] = torch.tensor(float(rank))
    return out


def _delta(up: torch.Tensor, down: torch.Tensor,
           target_shape: Tuple[int, ...]) -> torch.Tensor:
    """``up @ down`` in fp32 and torch layout, shaped as the weight.
    Linear: up [out, r] @ down [r, in]; conv: up [out, r, 1, 1] and down
    [r, in, kh, kw], ranks flattened."""
    u = up.float().reshape(up.shape[0], -1)
    d = down.float().reshape(down.shape[0], -1)
    return (u @ d).reshape(target_shape)


@torch.no_grad()
def apply_lora_to_state_dict(sd: Dict[str, torch.Tensor],
                             lora_sd: Dict[str, torch.Tensor], index: Index,
                             strength_model: float, strength_clip: float
                             ) -> Tuple[Dict[str, torch.Tensor], List[str]]:
    """The merged tensors: {torch key: new tensor} for each weight a
    delta lands on (``sd`` itself is not changed), and the kohya module
    names that matched no weight."""
    modules = sorted({k.split(".")[0] for k in lora_sd
                      if ".lora_down." in k or ".lora_up." in k})
    merged: Dict[str, torch.Tensor] = {}
    unmatched: List[str] = []
    for mod in modules:
        entry = index.get(mod)
        if entry is None:
            unmatched.append(mod)
            continue
        key, rows = entry
        strength = strength_model if mod.startswith(UNET_LORA_PREFIX) \
            else strength_clip
        if strength == 0.0:
            continue
        down = lora_sd.get(f"{mod}.lora_down.weight")
        up = lora_sd.get(f"{mod}.lora_up.weight")
        if down is None or up is None:
            unmatched.append(mod)
            continue
        rank = down.shape[0]
        alpha = float(lora_sd[f"{mod}.alpha"]) \
            if f"{mod}.alpha" in lora_sd else float(rank)
        w = merged.get(key, sd[key])
        target = w[rows] if rows is not None else w
        delta = _delta(up.to(w.device), down.to(w.device), target.shape)
        new = (target.float() + delta.to(w.dtype).float()
               * (strength * alpha / rank)).to(w.dtype)
        if rows is not None:
            # one q/k/v row block of a packed weight (the HF alias)
            w = w.clone()
            w[rows] = new
            merged[key] = w
        else:
            merged[key] = new
    return merged, unmatched


class _PatchMapper(ckpt._LoadMapper):
    """The load walk over the merged tensors only: every key the walk
    finds among them goes to its parameter; keys it does not find are
    the untouched parameters, not gaps."""

    def finish(self, what: str) -> Dict[str, torch.Tensor]:
        return self.out


def _with_params(module: nn.Module, new: Dict[str, torch.Tensor]
                 ) -> nn.Module:
    """A copy of ``module`` whose parameters named in ``new`` are the
    given tensors; every other parameter, and each submodule no name
    reaches, is ``module``'s own (shared, not copied)."""
    if not new:
        return module
    out = copy.copy(module)
    out._parameters = dict(module._parameters)
    out._modules = dict(module._modules)
    children: Dict[str, Dict[str, torch.Tensor]] = {}
    for name, t in new.items():
        head, _, rest = name.partition(".")
        if rest:
            children.setdefault(head, {})[rest] = t
        else:
            old = module._parameters[head]
            if tuple(t.shape) != tuple(old.shape):
                raise ValueError(f"{head}: merged shape {tuple(t.shape)}, "
                                 f"parameter {tuple(old.shape)}")
            out._parameters[head] = nn.Parameter(
                t.to(old.dtype).contiguous(), requires_grad=False)
    for head, sub in children.items():
        out._modules[head] = _with_params(module._modules[head], sub)
    return out


def _patch_module(module: nn.Module, merged: Dict[str, torch.Tensor],
                  prefix: str, walk, cfg) -> nn.Module:
    """``module`` with the merged torch-layout tensors under ``prefix``
    mapped back onto its parameters."""
    mine = {k: v for k, v in merged.items() if k.startswith(prefix)}
    if not mine:
        return module
    mapper = _PatchMapper(mine, prefix, ckpt._by_path(module))
    return _with_params(module, walk(mapper, cfg))


# Patched pipelines, cached per (base, LoRA, strengths, models dir): a
# repeated run gets the same pipeline.  LRU-bounded, as each entry holds
# its own copies of the weights the LoRA touched.
_lora_cache: "collections.OrderedDict[Tuple, object]" = \
    collections.OrderedDict()
_LORA_CACHE_CAP = 4
_lora_lock = threading.Lock()


def clear_lora_cache() -> None:
    with _lora_lock:
        _lora_cache.clear()


def apply_lora_to_pipeline(pipe, lora_name: str, strength_model: float,
                           strength_clip: float,
                           models_dir: Optional[str] = None):
    """A new pipeline with the named LoRA merged into its UNet and text
    towers at the two strengths (cached).  The file ``lora_name`` in
    ``models_dir`` is read when it is there; without it the LoRA is the
    JAX package's virtual one, drawn from the name.  Only the towers a
    nonzero strength can touch are indexed, as in the JAX package, so a
    model-only or clip-only patch draws its virtual adapters from its own
    tower's modules."""
    key = (pipe.cache_token, lora_name, float(strength_model),
           float(strength_clip), models_dir or "")
    with _lora_lock:
        if key in _lora_cache:
            _lora_cache.move_to_end(key)
            return _lora_cache[key]
    fam = pipe.family
    clip_prefixes = ckpt._clip_prefixes(fam)
    sd: Dict[str, torch.Tensor] = {}
    if strength_model != 0.0:
        sd.update(ckpt._run_unet(ckpt._ExportMapper(
            ckpt._by_path(pipe.unet), ckpt.UNET_PREFIX), fam.unet))
    if strength_clip != 0.0:
        for ccfg, m, prefix in zip(fam.clips, pipe.clip_models,
                                   clip_prefixes):
            sd.update(ckpt._clip_runner(ccfg)(ckpt._ExportMapper(
                ckpt._by_path(m), prefix), ccfg))
    index = build_key_index(sd, fam)
    path = registry._model_file(models_dir, lora_name)
    lora_sd = load_lora_state_dict(path) if path is not None \
        else virtual_lora_state_dict(lora_name, index, sd)
    merged, _ = apply_lora_to_state_dict(sd, lora_sd, index, strength_model,
                                         strength_clip)
    del sd
    unet = _patch_module(pipe.unet, merged, ckpt.UNET_PREFIX, ckpt._run_unet,
                         fam.unet)
    clips = [_patch_module(m, merged, prefix, ckpt._clip_runner(c), c)
             for c, m, prefix in zip(fam.clips, pipe.clip_models,
                                     clip_prefixes)]
    patched = registry.DiffusionPipeline(
        f"{pipe.name}+{lora_name}", fam, unet, clips, pipe.vae, pipe.device,
        assets_dir=pipe.assets_dir)
    registry.copy_sampler_patches(pipe, patched)
    with _lora_lock:
        patched = _lora_cache.setdefault(key, patched)
        while len(_lora_cache) > _LORA_CACHE_CAP:
            _lora_cache.popitem(last=False)
    return patched
