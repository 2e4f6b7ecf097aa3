"""Native pipeline checkpoints: the counterpart of
``comfyui_distributed_tpu/runtime/checkpointing.py``'s pipeline half.

A native checkpoint is a directory under the models directory that the
registry loads by its name (``registry.load_pipeline``), its family
from the manifest rather than from the name:

- ``dtpu_checkpoint.json``: the JAX package's keys (``format``
  ``"dtpu-pipeline"``, ``version`` 1, ``family``, ``num_clips``) and
  ``layout`` ``"safetensors"``;
- ``params/unet.safetensors``, ``params/clip_<i>.safetensors`` a text
  tower, ``params/vae.safetensors``: each module's parameters under the
  port's names, in their storage dtype, written by the port's own
  safetensors writer (``models/checkpoints.py``) and read back through
  its copy-on-write map.

The JAX package writes an orbax tree under the same manifest (no
``layout`` key).  The port cannot read orbax, so such a directory raises
a ``ValueError`` that names the layout it found.  The train-state half
of the JAX module (``save_train_state``, ``latest_train_step``,
``load_train_state``) waits for the training step it serves.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, List, Optional, Tuple

from torch import nn

from comfyui_distributed_tpu_torch.models.checkpoints import (
    Tensors,
    read_safetensors,
    write_safetensors,
)
from comfyui_distributed_tpu_torch.utils.log import log

METADATA_FILE = "dtpu_checkpoint.json"
PIPELINE_FORMAT = "dtpu-pipeline"
LAYOUT = "safetensors"


def is_native_checkpoint(path: str) -> bool:
    return os.path.isdir(path) and os.path.exists(
        os.path.join(path, METADATA_FILE))


def read_manifest(path: str) -> Dict[str, Any]:
    """The manifest of a native pipeline checkpoint the port reads; a
    train state, another version or another layout raises
    ``ValueError``."""
    with open(os.path.join(path, METADATA_FILE), "r", encoding="utf-8") as f:
        meta = json.load(f)
    if meta.get("format") != PIPELINE_FORMAT or meta.get("version") != 1:
        raise ValueError(f"{path}: not a version-1 pipeline checkpoint "
                         f"(format {meta.get('format')!r}, version "
                         f"{meta.get('version')!r})")
    layout = meta.get("layout", "orbax")
    if layout != LAYOUT:
        raise ValueError(
            f"{path}: a native checkpoint in the {layout!r} layout (the "
            f"JAX package's orbax tree under params/); this package reads "
            f"only its own {LAYOUT!r} layout: load the single-file "
            f"checkpoint instead, or save the pipeline again here")
    return meta


def _params(module: nn.Module) -> Tensors:
    return {k: p.detach() for k, p in module.named_parameters()}


def save_pipeline_checkpoint(path: str, family_name: str, unet: nn.Module,
                             clips: List[nn.Module], vae: nn.Module) -> None:
    """Write a native pipeline checkpoint: one safetensors file a
    module under ``params/``, then the manifest (last, so a directory
    with a manifest is whole)."""
    path = os.path.abspath(path)
    params = os.path.join(path, "params")
    os.makedirs(params, exist_ok=True)
    write_safetensors(_params(unet), os.path.join(params, "unet.safetensors"))
    for i, c in enumerate(clips):
        write_safetensors(_params(c),
                          os.path.join(params, f"clip_{i}.safetensors"))
    write_safetensors(_params(vae), os.path.join(params, "vae.safetensors"))
    with open(os.path.join(path, METADATA_FILE), "w", encoding="utf-8") as f:
        json.dump({"format": PIPELINE_FORMAT, "version": 1,
                   "family": family_name, "num_clips": len(clips),
                   "layout": LAYOUT}, f)
    log(f"saved native checkpoint ({family_name}) -> {path}")


def load_pipeline_checkpoint(path: str,
                             meta: Optional[Dict[str, Any]] = None
                             ) -> Tuple[str, Tensors, List[Tensors],
                                        Tensors]:
    """(family name, unet, [clip...], vae) state dicts of a native
    checkpoint, each tensor a view of its file's map; ``meta`` is its
    manifest when the caller has read it already."""
    path = os.path.abspath(path)
    if meta is None:
        meta = read_manifest(path)
    params = os.path.join(path, "params")
    unet = read_safetensors(os.path.join(params, "unet.safetensors"))
    clips = [read_safetensors(os.path.join(params, f"clip_{i}.safetensors"))
             for i in range(int(meta["num_clips"]))]
    vae = read_safetensors(os.path.join(params, "vae.safetensors"))
    log(f"restored native checkpoint ({meta['family']}) <- {path}")
    return meta["family"], unet, clips, vae
