"""The weight bridge: flax parameter trees <-> the port's modules.

The port's submodules keep the flax names, so a parameter's flax path is
its module path plus a leaf name, and the mapping is mechanical:

- Dense ``kernel`` [in, out]   -> ``weight`` [out, in];
- Conv ``kernel`` HWIO         -> ``weight`` OIHW;
- LayerNorm ``scale``/``bias`` -> ``weight``/``bias``;
- GroupNorm32 holds flax's implicit ``GroupNorm_0`` (``in_norm/GroupNorm_0/
  scale`` -> ``in_norm.weight``);
- Embed ``embedding``          -> ``weight``; CLIP's raw
  ``position_embedding`` (and the vision tower's ``class_embedding``)
  keeps its name and layout.

:func:`fill_virtual` is the virtual checkpoint: every leaf is drawn in
flax layout by the JAX package's rule (``registry._virtual_leaf``) — a
numpy generator keyed by ``(seed, crc32(flax path))``, ones for
``scale``, zeros for biases and 1-D leaves, fan-in-scaled normals for
kernels — and then converted, so a checkpoint name with no file gives the
JAX package's weights.  :func:`from_flax` converts the JAX package's own
trees.
"""

from __future__ import annotations

import zlib
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Dict, List, Mapping, NamedTuple, Tuple

import numpy as np
import torch
from torch import nn

from comfyui_distributed_tpu_torch.models.clip import CLIPTextModel, Embed
from comfyui_distributed_tpu_torch.models.clip_vision import CLIPVisionModel
from comfyui_distributed_tpu_torch.models.layers import (
    Conv,
    Dense,
    GroupNorm32,
    LayerNorm,
)


class Leaf(NamedTuple):
    flax_path: Tuple[str, ...]   # path inside the module's flax tree
    name: str                    # torch parameter name
    param: nn.Parameter
    kind: str                    # "dense" | "conv" | "same"


def _flax_shape(kind: str, shape: Tuple[int, ...]) -> Tuple[int, ...]:
    if kind == "dense":
        return (shape[1], shape[0])
    if kind == "conv":
        return (shape[2], shape[3], shape[1], shape[0])
    return tuple(shape)


def _to_torch_layout(kind: str, arr: np.ndarray) -> np.ndarray:
    if kind == "dense":
        return arr.T
    if kind == "conv":
        return arr.transpose(3, 2, 0, 1)
    return arr


def leaves(module: nn.Module) -> List[Leaf]:
    """Every parameter of ``module`` with its flax path; raises if a
    parameter has no flax counterpart."""
    out: List[Leaf] = []

    def add(mname: str, flax_rel: Tuple[str, ...], attr: str, kind: str,
            mod: nn.Module) -> None:
        p = getattr(mod, attr)
        if p is None:
            return
        path = (tuple(mname.split(".")) if mname else ()) + flax_rel
        out.append(Leaf(path, f"{mname}.{attr}" if mname else attr, p, kind))

    for mname, mod in module.named_modules():
        if isinstance(mod, (Dense, Conv)):
            kind = "dense" if isinstance(mod, Dense) else "conv"
            add(mname, ("kernel",), "weight", kind, mod)
            add(mname, ("bias",), "bias", "same", mod)
        elif isinstance(mod, LayerNorm):
            add(mname, ("scale",), "weight", "same", mod)
            add(mname, ("bias",), "bias", "same", mod)
        elif isinstance(mod, GroupNorm32):
            add(mname, ("GroupNorm_0", "scale"), "weight", "same", mod)
            add(mname, ("GroupNorm_0", "bias"), "bias", "same", mod)
        elif isinstance(mod, Embed):
            add(mname, ("embedding",), "weight", "same", mod)
        elif isinstance(mod, CLIPTextModel):
            add(mname, ("position_embedding",), "position_embedding",
                "same", mod)
        elif isinstance(mod, CLIPVisionModel):
            for raw in ("class_embedding", "position_embedding"):
                add(mname, (raw,), raw, "same", mod)
    covered = {leaf.name for leaf in out}
    missing = [n for n, _ in module.named_parameters() if n not in covered]
    if missing:
        raise KeyError(f"parameters without a flax counterpart: {missing}")
    return out


def virtual_leaf(seed: int, flax_path: Tuple[str, ...],
                 shape: Tuple[int, ...]) -> np.ndarray:
    """One virtual-checkpoint leaf in flax layout, float32."""
    name = "".join(f"['{k}']" for k in ("params",) + tuple(flax_path))
    rng = np.random.default_rng(
        (np.uint64(seed), np.uint64(zlib.crc32(name.encode()))))
    if flax_path[-1] == "scale":
        arr = np.ones(shape, np.float32)
    elif flax_path[-1] == "bias" or len(shape) <= 1:
        arr = np.zeros(shape, np.float32)
    else:
        fan_in = int(np.prod(shape[:-1])) or 1
        arr = rng.standard_normal(shape, dtype=np.float32) / np.sqrt(fan_in)
    return np.asarray(arr, np.float32)


@torch.no_grad()
def fill_virtual(module: nn.Module, seed: int, workers: int = 8) -> None:
    """Fill every parameter of ``module`` (any device, any float dtype)
    with its virtual-checkpoint value; leaves are drawn in parallel."""
    def one(leaf: Leaf) -> None:
        arr = virtual_leaf(seed, leaf.flax_path,
                           _flax_shape(leaf.kind, tuple(leaf.param.shape)))
        leaf.param.copy_(torch.from_numpy(_to_torch_layout(leaf.kind, arr)))

    with ThreadPoolExecutor(max_workers=workers) as ex:
        for f in [ex.submit(one, leaf) for leaf in leaves(module)]:
            f.result()


def state_dict_from_flax(module: nn.Module,
                         tree: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """The flax tree of ``module`` (nested dicts of arrays, without the
    ``params`` wrapper) as the module's float32 state dict."""
    sd: Dict[str, torch.Tensor] = {}
    for leaf in leaves(module):
        node: Any = tree
        for k in leaf.flax_path:
            node = node[k]
        arr = np.asarray(node, dtype=np.float32)
        want = _flax_shape(leaf.kind, tuple(leaf.param.shape))
        if arr.shape != want:
            raise ValueError(f"{'/'.join(leaf.flax_path)}: flax shape "
                             f"{arr.shape}, expected {want}")
        sd[leaf.name] = torch.from_numpy(
            np.array(_to_torch_layout(leaf.kind, arr), order="C"))
    return sd


def from_flax(family, unet_params, clip_params, vae_params):
    """The JAX package's parameter trees -> the port's state dicts
    ``(unet, [clip...], vae)`` for ``family`` (a ``registry.ModelFamily``
    of the port).  The VAE's is its whole tree: encoder, ``quant_conv``,
    ``post_quant_conv`` and decoder."""
    from comfyui_distributed_tpu_torch.models.unet import UNet
    from comfyui_distributed_tpu_torch.models.vae import VAE
    with torch.device("meta"):
        unet = UNet(family.unet)
        clips = [CLIPTextModel(c) for c in family.clips]
        vae = VAE(family.vae)
    return (state_dict_from_flax(unet, unet_params),
            [state_dict_from_flax(m, p) for m, p in zip(clips, clip_params)],
            state_dict_from_flax(vae, vae_params))


def clip_vision_from_flax(cfg, params):
    """The JAX package's CLIP-vision tree -> the port's
    ``CLIPVisionModel`` state dict for ``cfg`` (a
    ``clip_vision.CLIPVisionConfig`` of the port)."""
    with torch.device("meta"):
        model = CLIPVisionModel(cfg)
    return state_dict_from_flax(model, params)


def rrdb_from_flax(cfg, params):
    """The JAX package's RRDB tree (rooted at the network, as
    ``registry.load_upscaler`` holds it) -> the port's ``RRDBNet`` state
    dict for ``cfg`` (an ``upscalers.RRDBConfig`` of the port)."""
    from comfyui_distributed_tpu_torch.models.upscalers import RRDBNet
    with torch.device("meta"):
        net = RRDBNet(cfg)
    return state_dict_from_flax(net, params)
