"""Checkpoint files <-> the port's modules: the counterpart of
``comfyui_distributed_tpu/models/checkpoints.py``.

A single-file SD checkpoint (safetensors, or a torch pickle) holds:

- ``model.diffusion_model.*``                -> the UNet;
- ``first_stage_model.*``                    -> the VAE;
- ``cond_stage_model.transformer.text_model.*`` -> CLIP-L (SD1.x);
- ``cond_stage_model.model.*``               -> an OpenCLIP tower (SD2.x);
- ``conditioner.embedders.0.transformer.text_model.*`` and
  ``conditioner.embedders.1.model.*``        -> SDXL's CLIP-L and bigG;
- ``conditioner.embedders.0.model.*``        -> the SDXL refiner's bigG
  (a family's declared ``clip_prefixes``).

A ControlNet file holds ``control_model.*`` (``_run_controlnet``: the
UNet encoder's keys, the hint ladder, the zero convs and the middle's
projection).

One walk a model (``_run_unet``, ``_run_vae``, ``_run_clip_hf``,
``_run_openclip``) names each torch key beside the flax path of the
parameter it feeds; a load mapper and an export mapper run the same
walk in the two directions.  The port's modules keep the flax names and
the torch layouts, so most tensors go across unchanged.  The exceptions:
1x1 convs that feed a Dense (VAE attention, SD1.x transformer proj_in
and proj_out) lose their two trailing dims, OpenCLIP's packed
``in_proj_weight`` splits into q/k/v, and OpenCLIP's ``text_projection``
(a plain [width, dim] matrix) is transposed.

The safetensors format is read and written here, without the package:
an 8-byte little-endian header length, a JSON header (each tensor's
``dtype``, ``shape`` and ``data_offsets``, and an optional
``__metadata__``), then the raw tensors.  A file is read through a
copy-on-write ``mmap``: each tensor is a view of the file's pages, so
nothing of the file is copied on the host until a tensor goes to its
device, where it is cast to its module's storage dtype.

The split loaders read one part from a lone file (:func:`load_part`):
a VAE, a UNet or a text tower with or without its checkpoint prefix,
and an HF CLIPVisionModel file (``_run_clip_vision``).

ESRGAN/RRDB upscalers ship in three namings (old-arch ``model.N``,
xinntao ``RRDB_trunk``, Real-ESRGAN ``body``/``conv_body``);
``_rrdb_key_norm`` maps all three onto one.
"""

from __future__ import annotations

import json
import math
import mmap
import os
import zipfile
from typing import (Callable, Dict, Iterable, List, Optional, Sequence,
                    Tuple)

import torch
from torch import nn

from comfyui_distributed_tpu_torch.models.weights import Leaf, leaves

Tensors = Dict[str, torch.Tensor]

# --- state-dict IO -------------------------------------------------------------

_DTYPES = {
    "F64": torch.float64, "F32": torch.float32, "F16": torch.float16,
    "BF16": torch.bfloat16, "I64": torch.int64, "I32": torch.int32,
    "I16": torch.int16, "I8": torch.int8, "U8": torch.uint8,
    "BOOL": torch.bool,
}
_DTYPE_NAMES = {v: k for k, v in _DTYPES.items()}


def read_safetensors(path: str) -> Tensors:
    """{key: CPU tensor in the file's dtype}, each a view of a
    copy-on-write map of the file.  An unknown dtype, a header that
    does not fit the file or a tensor that runs past its end raises
    ``ValueError``."""
    size = os.path.getsize(path)
    with open(path, "rb") as f:
        head = f.read(8)
        if len(head) < 8:
            raise ValueError(f"{path}: truncated safetensors file "
                             f"({size} bytes)")
        n = int.from_bytes(head, "little")
        if n > size - 8:
            raise ValueError(f"{path}: header of {n} bytes does not fit "
                             f"in a {size}-byte file")
        header = json.loads(f.read(n))
        data = mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_COPY) \
            if size > 8 + n else None
    base, out = 8 + n, {}
    for key, info in header.items():
        if key == "__metadata__":
            continue
        dt = _DTYPES.get(info.get("dtype"))
        if dt is None:
            raise ValueError(f"{path}: {key} has unknown dtype "
                             f"{info.get('dtype')!r}")
        shape = [int(d) for d in info["shape"]]
        start, end = (int(v) for v in info["data_offsets"])
        count = math.prod(shape)
        itemsize = torch.empty((), dtype=dt).element_size()
        if end - start != count * itemsize or start < 0 \
                or base + end > size:
            raise ValueError(f"{path}: {key} ({info['dtype']} {shape}) "
                             f"does not fit bytes {start}:{end} of the "
                             f"data (file truncated?)")
        if count == 0:
            out[key] = torch.empty(shape, dtype=dt)
        else:
            out[key] = torch.frombuffer(data, dtype=dt, count=count,
                                        offset=base + start).view(shape)
    return out


def write_safetensors(tensors: Tensors, path: str) -> None:
    """Write ``tensors`` (on any device) as a safetensors file.  Tensors
    go widest dtype first, so every offset stays aligned to its dtype,
    and each comes to the host on its own: the writer holds one tensor
    at a time."""
    order = sorted(tensors, key=lambda k: -tensors[k].element_size())
    header: Dict[str, object] = {}
    offset = 0
    for key in order:
        t = tensors[key]
        if t.dtype not in _DTYPE_NAMES:
            raise ValueError(f"{key}: dtype {t.dtype} has no safetensors "
                             "name")
        nbytes = t.numel() * t.element_size()
        header[key] = {"dtype": _DTYPE_NAMES[t.dtype],
                       "shape": list(t.shape),
                       "data_offsets": [offset, offset + nbytes]}
        offset += nbytes
    blob = json.dumps(header, separators=(",", ":")).encode()
    blob += b" " * (-len(blob) % 8)
    with open(path, "wb") as f:
        f.write(len(blob).to_bytes(8, "little"))
        f.write(blob)
        for key in order:
            t = tensors[key].detach().contiguous().cpu().reshape(-1)
            if t.numel():
                f.write(t.view(torch.uint8).numpy().data)


def load_state_dict(path: str) -> Tensors:
    """A checkpoint file as {torch key: CPU tensor in the file's dtype}.
    ``.safetensors`` maps the file (:func:`read_safetensors`);
    ``.ckpt``/``.pth`` go through ``torch.load(weights_only=True)``
    (mapped when the file is a zip archive), and a ``state_dict`` entry
    is unwrapped."""
    if path.endswith(".safetensors"):
        return read_safetensors(path)
    sd = torch.load(path, map_location="cpu", weights_only=True,
                    mmap=zipfile.is_zipfile(path))
    if isinstance(sd, dict) and "state_dict" in sd:
        sd = sd["state_dict"]
    return {k: v for k, v in sd.items() if isinstance(v, torch.Tensor)}


# --- mappers: one walk, two directions -------------------------------------------

class _LoadMapper:
    """Checkpoint tensors -> {port parameter name: tensor} for one
    module, whose parameters ``params`` are keyed by flax path."""

    def __init__(self, sd: Tensors, prefix: str, params: Dict[str, Leaf],
                 consumed: Optional[set] = None):
        self.sd = sd
        self.prefix = prefix
        self.params = params
        self.out: Tensors = {}
        self.missing: List[str] = []
        self.consumed = consumed if consumed is not None else set()

    def _get(self, key: str) -> Optional[torch.Tensor]:
        full = self.prefix + key
        if full in self.sd:
            self.consumed.add(full)
            return self.sd[full]
        return None

    def _set(self, fpath: str, value: torch.Tensor) -> None:
        leaf = self.params.get(fpath)
        if leaf is None:
            raise KeyError(f"{self.prefix}: the module has no parameter "
                           f"at {fpath}")
        if tuple(value.shape) != tuple(leaf.param.shape):
            raise ValueError(f"{self.prefix}{fpath}: checkpoint shape "
                             f"{tuple(value.shape)}, module "
                             f"{tuple(leaf.param.shape)}")
        self.out[leaf.name] = value

    def _pair(self, tkey: str, fpath: str, wtrans: Callable, wname: str =
              "kernel", bias: bool = True, required: bool = True) -> None:
        w = self._get(tkey + ".weight")
        if w is None:
            if required:
                self.missing.append(self.prefix + tkey + ".weight")
            return
        self._set(f"{fpath}/{wname}", wtrans(w))
        if bias:
            b = self._get(tkey + ".bias")
            if b is not None:
                self._set(fpath + "/bias", b)

    def conv(self, tkey, fpath):
        self._pair(tkey, fpath, _same)

    def conv_optional(self, tkey, fpath):
        self._pair(tkey, fpath, _same, required=False)

    def conv_as_dense(self, tkey, fpath, export_conv=False):
        # loading takes both the 1x1-conv and the Linear form
        self._pair(tkey, fpath, lambda w: w[:, :, 0, 0] if w.ndim == 4
                   else w)

    def linear(self, tkey, fpath, bias=True):
        self._pair(tkey, fpath, _same, bias=bias)

    def norm(self, tkey, fpath):
        self._pair(tkey, fpath, _same, wname="scale")

    def raw(self, tkey, fpath, transpose=False):
        w = self._get(tkey)
        if w is None:
            self.missing.append(self.prefix + tkey)
            return
        self._set(fpath, w.t() if transpose else w)

    def packed_qkv(self, tkey: str, fpath: str, width: int) -> None:
        """OpenCLIP ``attn.in_proj_weight`` [3W, W] -> q/k/v."""
        w = self._get(tkey + ".in_proj_weight")
        b = self._get(tkey + ".in_proj_bias")
        if w is None:
            self.missing.append(self.prefix + tkey + ".in_proj_weight")
            return
        for j, name in enumerate(("q", "k", "v")):
            self._set(f"{fpath}/{name}/kernel", w[j * width:(j + 1) * width])
            if b is not None:
                self._set(f"{fpath}/{name}/bias",
                          b[j * width:(j + 1) * width])

    def projection(self, tkey: str, fpath: str) -> None:
        """OpenCLIP text_projection: a plain [W, P] matrix (x @ P) or an
        nn.Linear."""
        if self.prefix + tkey + ".weight" in self.sd:
            self.linear(tkey, fpath, bias=False)
        else:
            self.raw(tkey, fpath + "/kernel", transpose=True)

    def finish(self, what: str) -> Tensors:
        if self.missing:
            raise KeyError(f"{what} checkpoint missing {len(self.missing)} "
                           f"keys, first: {self.missing[:5]}")
        unfilled = sorted({leaf.name for leaf in self.params.values()}
                          - set(self.out))
        if unfilled:
            raise KeyError(f"{what} checkpoint leaves {len(unfilled)} "
                           f"parameters unset, first: {unfilled[:5]}")
        return self.out


class _ExportMapper:
    """A module's parameters -> torch-layout checkpoint tensors (views
    on the module's device), by the same walk."""

    def __init__(self, params: Dict[str, Leaf], prefix: str):
        self.params = params
        self.prefix = prefix
        self.sd: Tensors = {}
        self.missing: List[str] = []

    def _get(self, fpath: str) -> Optional[torch.Tensor]:
        leaf = self.params.get(fpath)
        return None if leaf is None else leaf.param.detach()

    def _pair(self, tkey, fpath, wtrans, wname="kernel", bias=True,
              required=True):
        w = self._get(f"{fpath}/{wname}")
        if w is None:
            if required:
                self.missing.append(fpath)
            return
        self.sd[self.prefix + tkey + ".weight"] = wtrans(w)
        if bias:
            b = self._get(fpath + "/bias")
            if b is not None:
                self.sd[self.prefix + tkey + ".bias"] = b

    def conv(self, tkey, fpath):
        self._pair(tkey, fpath, _same)

    def conv_optional(self, tkey, fpath):
        self._pair(tkey, fpath, _same, required=False)

    def conv_as_dense(self, tkey, fpath, export_conv=False):
        """A Dense as torch's Linear [out, in], or as the 1x1 conv [out,
        in, 1, 1] where that is the canonical layout (VAE attention
        always, the SD1.x transformer proj), so strict torch loaders
        take the export."""
        self._pair(tkey, fpath, (lambda w: w[:, :, None, None])
                   if export_conv else _same)

    def linear(self, tkey, fpath, bias=True):
        self._pair(tkey, fpath, _same, bias=bias)

    def norm(self, tkey, fpath):
        self._pair(tkey, fpath, _same, wname="scale")

    def raw(self, tkey, fpath, transpose=False):
        w = self._get(fpath)
        if w is None:
            self.missing.append(fpath)
            return
        self.sd[self.prefix + tkey] = w.t() if transpose else w

    def packed_qkv(self, tkey, fpath, width):
        ws, bs = [], []
        for name in ("q", "k", "v"):
            w = self._get(f"{fpath}/{name}/kernel")
            if w is None:
                self.missing.append(f"{fpath}/{name}")
                return
            ws.append(w)
            b = self._get(f"{fpath}/{name}/bias")
            if b is not None:
                bs.append(b)
        self.sd[self.prefix + tkey + ".in_proj_weight"] = torch.cat(ws, 0)
        if len(bs) == 3:
            self.sd[self.prefix + tkey + ".in_proj_bias"] = torch.cat(bs, 0)

    def projection(self, tkey, fpath):
        self.raw(tkey, fpath + "/kernel", transpose=True)

    def finish(self, what: str) -> Tensors:
        if self.missing:
            raise KeyError(f"{what} export missing {len(self.missing)} "
                           f"params, first: {self.missing[:5]}")
        return self.sd


def _same(w: torch.Tensor) -> torch.Tensor:
    return w


def _groupnorm(m, tkey: str, fpath: str) -> None:
    # GroupNorm32 holds flax's implicit GroupNorm_0
    m.norm(tkey, fpath + "/GroupNorm_0")


# --- UNet walk -----------------------------------------------------------------

def _map_resblock(m, tkey: str, fpath: str) -> None:
    _groupnorm(m, f"{tkey}.in_layers.0", f"{fpath}/in_norm")
    m.conv(f"{tkey}.in_layers.2", f"{fpath}/in_conv")
    m.linear(f"{tkey}.emb_layers.1", f"{fpath}/emb_proj")
    _groupnorm(m, f"{tkey}.out_layers.0", f"{fpath}/out_norm")
    m.conv(f"{tkey}.out_layers.3", f"{fpath}/out_conv")
    m.conv_optional(f"{tkey}.skip_connection", f"{fpath}/skip")


def _map_spatial_transformer(m, tkey: str, fpath: str, depth: int,
                             linear_proj: bool = False) -> None:
    _groupnorm(m, f"{tkey}.norm", f"{fpath}/norm")
    m.conv_as_dense(f"{tkey}.proj_in", f"{fpath}/proj_in",
                    export_conv=not linear_proj)
    for j in range(depth):
        b = f"{tkey}.transformer_blocks.{j}"
        fb = f"{fpath}/blocks_{j}"
        for attn in ("attn1", "attn2"):
            m.linear(f"{b}.{attn}.to_q", f"{fb}/{attn}/to_q", bias=False)
            m.linear(f"{b}.{attn}.to_k", f"{fb}/{attn}/to_k", bias=False)
            m.linear(f"{b}.{attn}.to_v", f"{fb}/{attn}/to_v", bias=False)
            m.linear(f"{b}.{attn}.to_out.0", f"{fb}/{attn}/to_out")
        m.norm(f"{b}.norm1", f"{fb}/norm1")
        m.norm(f"{b}.norm2", f"{fb}/norm2")
        m.norm(f"{b}.norm3", f"{fb}/norm3")
        m.linear(f"{b}.ff.net.0.proj", f"{fb}/ff/geglu/proj")
        m.linear(f"{b}.ff.net.2", f"{fb}/ff/out")
    m.conv_as_dense(f"{tkey}.proj_out", f"{fpath}/proj_out",
                    export_conv=not linear_proj)


def _run_unet(m, cfg):
    """The LDM UNet layout (torch ``input_blocks.N`` enumeration)
    against the port's level/index names (``models/unet.py``)."""
    from comfyui_distributed_tpu_torch.models.unet import mid_depth
    m.linear("time_embed.0", "time_fc1")
    m.linear("time_embed.2", "time_fc2")
    if cfg.adm_in_channels is not None:
        m.linear("label_emb.0.0", "label_fc1")
        m.linear("label_emb.0.2", "label_fc2")
    m.conv("input_blocks.0.0", "conv_in")
    L, lin = cfg.num_levels, cfg.use_linear_in_transformer
    idx = 1
    for level in range(L):
        for i in range(cfg.num_res_blocks):
            _map_resblock(m, f"input_blocks.{idx}.0", f"down_{level}_res_{i}")
            if cfg.transformer_depth[level] > 0:
                _map_spatial_transformer(
                    m, f"input_blocks.{idx}.1", f"down_{level}_attn_{i}",
                    cfg.transformer_depth[level], linear_proj=lin)
            idx += 1
        if level != L - 1:
            m.conv(f"input_blocks.{idx}.0.op", f"down_{level}_ds/conv")
            idx += 1
    _map_resblock(m, "middle_block.0", "mid_res_0")
    _map_spatial_transformer(m, "middle_block.1", "mid_attn",
                             mid_depth(cfg), linear_proj=lin)
    _map_resblock(m, "middle_block.2", "mid_res_1")
    idx = 0
    for level in reversed(range(L)):
        for i in range(cfg.num_res_blocks + 1):
            _map_resblock(m, f"output_blocks.{idx}.0", f"up_{level}_res_{i}")
            sub = 1
            if cfg.transformer_depth[level] > 0:
                _map_spatial_transformer(
                    m, f"output_blocks.{idx}.{sub}", f"up_{level}_attn_{i}",
                    cfg.transformer_depth[level], linear_proj=lin)
                sub += 1
            if level != 0 and i == cfg.num_res_blocks:
                m.conv(f"output_blocks.{idx}.{sub}.conv",
                       f"up_{level}_us/conv")
            idx += 1
    _groupnorm(m, "out.0", "out_norm")
    m.conv("out.2", "conv_out")
    return m.finish("UNet")


def _run_controlnet(m, cfg):
    """The torch ControlNet layout (``control_model.*``): the UNet
    encoder's enumeration (``_run_unet``'s down path and middle) plus
    ``input_hint_block`` (a Sequential with a SiLU between its convs, so
    the convs sit at the even indices), ``zero_convs`` and
    ``middle_block_out`` (``models/controlnet.py`` keeps the names)."""
    from comfyui_distributed_tpu_torch.models.controlnet import (
        HINT_CHANNELS)
    from comfyui_distributed_tpu_torch.models.unet import mid_depth
    m.linear("time_embed.0", "time_fc1")
    m.linear("time_embed.2", "time_fc2")
    if cfg.adm_in_channels is not None:
        m.linear("label_emb.0.0", "label_fc1")
        m.linear("label_emb.0.2", "label_fc2")
    m.conv("input_blocks.0.0", "conv_in")
    for i in range(len(HINT_CHANNELS) + 1):
        m.conv(f"input_hint_block.{2 * i}", f"hint_conv_{i}")
    L, lin = cfg.num_levels, cfg.use_linear_in_transformer
    idx, zi = 1, 1
    m.conv("zero_convs.0.0", "zero_conv_0")
    for level in range(L):
        for i in range(cfg.num_res_blocks):
            _map_resblock(m, f"input_blocks.{idx}.0", f"down_{level}_res_{i}")
            if cfg.transformer_depth[level] > 0:
                _map_spatial_transformer(
                    m, f"input_blocks.{idx}.1", f"down_{level}_attn_{i}",
                    cfg.transformer_depth[level], linear_proj=lin)
            m.conv(f"zero_convs.{zi}.0", f"zero_conv_{zi}")
            idx += 1
            zi += 1
        if level != L - 1:
            m.conv(f"input_blocks.{idx}.0.op", f"down_{level}_ds/conv")
            m.conv(f"zero_convs.{zi}.0", f"zero_conv_{zi}")
            idx += 1
            zi += 1
    _map_resblock(m, "middle_block.0", "mid_res_0")
    _map_spatial_transformer(m, "middle_block.1", "mid_attn",
                             mid_depth(cfg), linear_proj=lin)
    _map_resblock(m, "middle_block.2", "mid_res_1")
    m.conv("middle_block_out.0", "mid_out")
    return m.finish("ControlNet")


CONTROLNET_PREFIX = "control_model."


def load_controlnet(path: str, cfg, state_dict: Optional[Tensors] = None
                    ) -> Tensors:
    """A ControlNet ``.safetensors``/``.pth`` file (its keys under
    ``control_model.`` or bare) -> the state dict of
    ``ControlNet(cfg)``."""
    from comfyui_distributed_tpu_torch.models.controlnet import ControlNet
    sd = state_dict if state_dict is not None else load_state_dict(path)
    prefix = CONTROLNET_PREFIX if any(k.startswith(CONTROLNET_PREFIX)
                                      for k in sd) else ""
    with torch.device("meta"):
        net = ControlNet(cfg)
    return _run_controlnet(_LoadMapper(sd, prefix, _by_path(net)), cfg)


def controlnet_context_dim(sd: Tensors) -> Optional[int]:
    """The cross-attention width of a ControlNet state dict (768, 1024 or
    2048: the one width that tells the SD families apart), so the loader
    takes the family from the file itself."""
    for k, v in sd.items():
        if k.endswith("attn2.to_k.weight"):
            return int(v.shape[-1])
    return None


def export_controlnet(net: nn.Module, cfg) -> Tensors:
    """A ControlNet module -> its tensors in the ``control_model.*``
    layout (on the module's device, in its storage dtype)."""
    return _run_controlnet(_ExportMapper(_by_path(net), CONTROLNET_PREFIX),
                           cfg)


# --- VAE walk ------------------------------------------------------------------

def _map_vae_resblock(m, tkey: str, fpath: str) -> None:
    _groupnorm(m, f"{tkey}.norm1", f"{fpath}/norm1")
    m.conv(f"{tkey}.conv1", f"{fpath}/conv1")
    _groupnorm(m, f"{tkey}.norm2", f"{fpath}/norm2")
    m.conv(f"{tkey}.conv2", f"{fpath}/conv2")
    m.conv_optional(f"{tkey}.nin_shortcut", f"{fpath}/skip")


def _map_vae_attn(m, tkey: str, fpath: str) -> None:
    _groupnorm(m, f"{tkey}.norm", f"{fpath}/norm")
    # torch keeps q/k/v/proj_out as 1x1 convs; the port's block uses Dense
    for name in ("q", "k", "v", "proj_out"):
        m.conv_as_dense(f"{tkey}.{name}", f"{fpath}/{name}",
                        export_conv=True)


def _run_vae(m, cfg):
    L = len(cfg.channel_mult)
    m.conv("encoder.conv_in", "encoder/conv_in")
    for level in range(L):
        for i in range(cfg.num_res_blocks):
            _map_vae_resblock(m, f"encoder.down.{level}.block.{i}",
                              f"encoder/down_{level}_res_{i}")
        if level != L - 1:
            m.conv(f"encoder.down.{level}.downsample.conv",
                   f"encoder/down_{level}_ds")
    _map_vae_resblock(m, "encoder.mid.block_1", "encoder/mid_res_0")
    _map_vae_attn(m, "encoder.mid.attn_1", "encoder/mid_attn")
    _map_vae_resblock(m, "encoder.mid.block_2", "encoder/mid_res_1")
    _groupnorm(m, "encoder.norm_out", "encoder/out_norm")
    m.conv("encoder.conv_out", "encoder/conv_out")
    m.conv("decoder.conv_in", "decoder/conv_in")
    _map_vae_resblock(m, "decoder.mid.block_1", "decoder/mid_res_0")
    _map_vae_attn(m, "decoder.mid.attn_1", "decoder/mid_attn")
    _map_vae_resblock(m, "decoder.mid.block_2", "decoder/mid_res_1")
    # torch's decoder.up is indexed by resolution level (up.0 = full res)
    for level in range(L):
        for i in range(cfg.num_res_blocks + 1):
            _map_vae_resblock(m, f"decoder.up.{level}.block.{i}",
                              f"decoder/up_{level}_res_{i}")
        if level != 0:
            m.conv(f"decoder.up.{level}.upsample.conv",
                   f"decoder/up_{level}_us")
    _groupnorm(m, "decoder.norm_out", "decoder/out_norm")
    m.conv("decoder.conv_out", "decoder/conv_out")
    m.conv("quant_conv", "quant_conv")
    m.conv("post_quant_conv", "post_quant_conv")
    return m.finish("VAE")


# --- CLIP walks ----------------------------------------------------------------

def _run_clip_hf(m, cfg):
    """HF CLIPTextModel layout (SD1.x's text encoder, SDXL's first)."""
    m.raw("embeddings.token_embedding.weight", "token_embedding/embedding")
    m.raw("embeddings.position_embedding.weight", "position_embedding")
    for i in range(cfg.layers):
        t, f = f"encoder.layers.{i}", f"layers_{i}"
        m.norm(f"{t}.layer_norm1", f"{f}/ln1")
        m.linear(f"{t}.self_attn.q_proj", f"{f}/q")
        m.linear(f"{t}.self_attn.k_proj", f"{f}/k")
        m.linear(f"{t}.self_attn.v_proj", f"{f}/v")
        m.linear(f"{t}.self_attn.out_proj", f"{f}/proj")
        m.norm(f"{t}.layer_norm2", f"{f}/ln2")
        m.linear(f"{t}.mlp.fc1", f"{f}/fc1")
        m.linear(f"{t}.mlp.fc2", f"{f}/fc2")
    m.norm("final_layer_norm", "ln_final")
    return m.finish("CLIP")


def _run_openclip(m, cfg):
    """OpenCLIP text-tower layout (SDXL's bigG, SD2.x's ViT-H)."""
    m.raw("token_embedding.weight", "token_embedding/embedding")
    m.raw("positional_embedding", "position_embedding")
    for i in range(cfg.layers):
        t, f = f"transformer.resblocks.{i}", f"layers_{i}"
        m.norm(f"{t}.ln_1", f"{f}/ln1")
        m.packed_qkv(f"{t}.attn", f, cfg.width)
        m.linear(f"{t}.attn.out_proj", f"{f}/proj")
        m.norm(f"{t}.ln_2", f"{f}/ln2")
        m.linear(f"{t}.mlp.c_fc", f"{f}/fc1")
        m.linear(f"{t}.mlp.c_proj", f"{f}/fc2")
    m.norm("ln_final", "ln_final")
    if cfg.projection_dim is not None:
        m.projection("text_projection", "text_projection")
    return m.finish("OpenCLIP")


def _run_clip_vision(m, cfg):
    """HF CLIPVisionModel layout (``clip_vision/*.safetensors``; HF spells
    the pre-norm ``pre_layrnorm``)."""
    m.raw("vision_model.embeddings.class_embedding", "class_embedding")
    m.raw("vision_model.embeddings.position_embedding.weight",
          "position_embedding")
    m.conv("vision_model.embeddings.patch_embedding", "patch_embed")
    m.norm("vision_model.pre_layrnorm", "pre_ln")
    for i in range(cfg.layers):
        t, f = f"vision_model.encoder.layers.{i}", f"layers_{i}"
        m.norm(f"{t}.layer_norm1", f"{f}/ln1")
        m.linear(f"{t}.self_attn.q_proj", f"{f}/q")
        m.linear(f"{t}.self_attn.k_proj", f"{f}/k")
        m.linear(f"{t}.self_attn.v_proj", f"{f}/v")
        m.linear(f"{t}.self_attn.out_proj", f"{f}/proj")
        m.norm(f"{t}.layer_norm2", f"{f}/ln2")
        m.linear(f"{t}.mlp.fc1", f"{f}/fc1")
        m.linear(f"{t}.mlp.fc2", f"{f}/fc2")
    m.norm("vision_model.post_layernorm", "post_ln")
    m.linear("visual_projection", "visual_projection", bias=False)
    return m.finish("CLIPVision")


# --- top level -----------------------------------------------------------------

UNET_PREFIX = "model.diffusion_model."
VAE_PREFIX = "first_stage_model."
CLIP_PREFIX_SD15 = "cond_stage_model.transformer.text_model."
CLIP_PREFIX_SD2 = "cond_stage_model.model."
CLIP_PREFIXES_SDXL = ("conditioner.embedders.0.transformer.text_model.",
                      "conditioner.embedders.1.model.")


def _clip_prefixes(family) -> List[str]:
    """The text towers' key prefixes: the family's own when it declares
    them (the SDXL refiner's bigG is embedder 0 of the conditioner),
    else the standard layout for its towers."""
    if family.clip_prefixes is not None:
        return list(family.clip_prefixes)
    if len(family.clips) == 1:
        return [CLIP_PREFIX_SD2 if family.clips[0].layout == "openclip"
                else CLIP_PREFIX_SD15]
    return list(CLIP_PREFIXES_SDXL)


def _clip_runner(ccfg) -> Callable:
    return _run_openclip if ccfg.layout == "openclip" else _run_clip_hf


def _by_path(module: nn.Module) -> Dict[str, Leaf]:
    return {"/".join(leaf.flax_path): leaf for leaf in leaves(module)}


def _meta_modules(family) -> Tuple[nn.Module, List[nn.Module], nn.Module]:
    from comfyui_distributed_tpu_torch.models.clip import CLIPTextModel
    from comfyui_distributed_tpu_torch.models.unet import UNet
    from comfyui_distributed_tpu_torch.models.vae import VAE
    with torch.device("meta"):
        return (UNet(family.unet), [CLIPTextModel(c) for c in family.clips],
                VAE(family.vae))


def convert_state_dict(sd: Tensors, family, consumed: Optional[set] = None
                       ) -> Tuple[Tensors, List[Tensors], Tensors]:
    """A checkpoint's tensors -> the state dicts ``(unet, [clip...],
    vae)`` of ``family``'s modules, in the port's parameter names, each
    tensor the file's own (dtype unchanged; a view where it can be).  A
    missing key raises ``KeyError`` with its name."""
    unet, clips, vae = _meta_modules(family)
    unet_sd = _run_unet(_LoadMapper(sd, UNET_PREFIX, _by_path(unet),
                                    consumed), family.unet)
    vae_sd = _run_vae(_LoadMapper(sd, VAE_PREFIX, _by_path(vae), consumed),
                      family.vae)
    clip_sds = [_clip_runner(c)(_LoadMapper(sd, prefix, _by_path(m),
                                            consumed), c)
                for c, m, prefix in zip(family.clips, clips,
                                        _clip_prefixes(family))]
    return unet_sd, clip_sds, vae_sd


# non-parameter keys real checkpoints carry that no model weight maps to:
# diffusion schedule buffers, EMA copies, CLIP position ids / logit scale
EXPECTED_NONPARAM_KEYS = (
    "betas", "alphas_cumprod", "alphas_cumprod_prev",
    "sqrt_alphas_cumprod", "sqrt_one_minus_alphas_cumprod",
    "log_one_minus_alphas_cumprod", "sqrt_recip_alphas_cumprod",
    "sqrt_recipm1_alphas_cumprod", "posterior_variance",
    "posterior_log_variance_clipped", "posterior_mean_coef1",
    "posterior_mean_coef2", "logvar",
    "model_ema.",
    "cond_stage_model.transformer.text_model.embeddings.position_ids",
    "conditioner.embedders.0.transformer.text_model.embeddings.position_ids",
    "conditioner.embedders.1.model.logit_scale",
    "conditioner.embedders.0.model.logit_scale",
    "cond_stage_model.logit_scale",
    "cond_stage_model.model.attn_mask",
    "cond_stage_model.model.logit_scale",
)


def unconsumed_keys(sd: Tensors, family) -> List[str]:
    """Checkpoint keys that feed no parameter, the known non-parameter
    buffers aside: non-empty means an unexpected layout or a gap in the
    walk."""
    consumed: set = set()
    convert_state_dict(sd, family, consumed=consumed)
    return sorted(k for k in sd if k not in consumed and not any(
        k == e or k.startswith(e) for e in EXPECTED_NONPARAM_KEYS))


@torch.no_grad()
def load_into(module: nn.Module, state: Tensors) -> nn.Module:
    """Copy ``state`` (the port's names, any dtype, on the host) into
    ``module``'s parameters: each tensor goes to the parameter's device
    first and is cast there to the parameter's dtype."""
    params = dict(module.named_parameters())
    if set(params) != set(state):
        raise KeyError(f"state does not match the module: missing "
                       f"{sorted(set(params) - set(state))[:5]}, extra "
                       f"{sorted(set(state) - set(params))[:5]}")
    for name, p in params.items():
        p.copy_(state[name].to(p.device))
    return module


def export_state_dict(unet: nn.Module, clips: List[nn.Module],
                      vae: nn.Module, family) -> Tensors:
    """The modules -> a torch-layout single-file state dict (tensors on
    the modules' devices, in their storage dtypes)."""
    sd: Tensors = {}
    sd.update(_run_unet(_ExportMapper(_by_path(unet), UNET_PREFIX),
                        family.unet))
    sd.update(_run_vae(_ExportMapper(_by_path(vae), VAE_PREFIX),
                       family.vae))
    for ccfg, m, prefix in zip(family.clips, clips, _clip_prefixes(family)):
        sd.update(_clip_runner(ccfg)(_ExportMapper(_by_path(m), prefix),
                                     ccfg))
    return sd


def load_checkpoint(path: str, family
                    ) -> Tuple[Tensors, List[Tensors], Tensors]:
    """A single-file SD checkpoint -> ``(unet, [clip...], vae)`` state
    dicts of ``family``'s modules."""
    return convert_state_dict(load_state_dict(path), family)


def save_checkpoint(path: str, unet: nn.Module, clips: List[nn.Module],
                    vae: nn.Module, family) -> None:
    write_safetensors(export_state_dict(unet, clips, vae, family), path)


# --- lone files: one part of a pipeline (the split loaders) --------------------

def _part(kind: str, cfg) -> Tuple[Callable[[], nn.Module], Callable]:
    """(module factory, key walk) of a pipeline part: "unet", "vae",
    "clip" (either text layout, from ``cfg.layout``) or
    "clip_vision"."""
    from comfyui_distributed_tpu_torch.models.clip import CLIPTextModel
    from comfyui_distributed_tpu_torch.models.clip_vision import (
        CLIPVisionModel)
    from comfyui_distributed_tpu_torch.models.unet import UNet
    from comfyui_distributed_tpu_torch.models.vae import VAE
    if kind == "unet":
        return (lambda: UNet(cfg)), _run_unet
    if kind == "vae":
        return (lambda: VAE(cfg)), _run_vae
    if kind == "clip":
        return (lambda: CLIPTextModel(cfg)), _clip_runner(cfg)
    if kind == "clip_vision":
        return (lambda: CLIPVisionModel(cfg)), _run_clip_vision
    raise ValueError(f"unknown pipeline part {kind!r}")


def load_part(sd: Tensors, kind: str, cfg,
              prefixes: Sequence[str] = ()) -> Tensors:
    """One part's state dict from a lone file's tensors, its keys under
    the first of ``prefixes`` that any key starts with, else bare (the
    split loaders' rule: a VAE with or without ``first_stage_model.``, a
    UNet with or without ``model.diffusion_model.``, a text tower under
    its in-checkpoint prefix, ``text_model.`` or none)."""
    prefix = next((p for p in prefixes if any(k.startswith(p) for k in sd)),
                  "")
    make, walk = _part(kind, cfg)
    with torch.device("meta"):
        module = make()
    return walk(_LoadMapper(sd, prefix, _by_path(module)), cfg)


def save_part(path: str, module: nn.Module, kind: str, cfg,
              prefix: str = "") -> None:
    """Write one part as a lone file, its keys under ``prefix``."""
    _, walk = _part(kind, cfg)
    write_safetensors(walk(_ExportMapper(_by_path(module), prefix), cfg),
                      path)


# --- ESRGAN/RRDB upscalers ---------------------------------------------------------

def _rrdb_key_norm(sd: Iterable[str]) -> Dict[str, str]:
    """torch key -> its canonical (Real-ESRGAN-style) name."""
    keys = list(sd)
    if any(k.startswith("model.1.sub.") for k in keys):  # old ESRGAN arch
        out = {}
        nb = max(int(k.split(".")[3]) for k in keys
                 if k.startswith("model.1.sub.")
                 and k.split(".")[3].isdigit())
        # one upconv per 2x, then HRconv and conv_last, between the
        # parameter-free Upsample/LeakyReLU layers: 4x = model.{3,6,8,10},
        # 2x = model.{3,5,7}, 1x = model.{2,4}
        tail = sorted({int(p[1]) for p in (k.split(".") for k in keys)
                       if p[0] == "model" and p[1].isdigit()
                       and int(p[1]) >= 2})
        names = ([f"upconv{i + 1}" for i in range(len(tail) - 2)]
                 + ["HRconv", "conv_last"])
        tail_map = dict(zip(tail, names))
        for k in keys:
            parts = k.split(".")
            if k.startswith("model.0."):
                out[k] = f"conv_first.{parts[-1]}"
            elif k.startswith(f"model.1.sub.{nb}."):
                out[k] = f"trunk_conv.{parts[-1]}"
            elif k.startswith("model.1.sub."):
                i, rdb, conv = parts[3], parts[4], parts[5]
                out[k] = f"body.{i}.{rdb}.{conv}.{parts[-1]}"
            elif parts[0] == "model" and parts[1].isdigit() \
                    and int(parts[1]) in tail_map:
                out[k] = f"{tail_map[int(parts[1])]}.{parts[-1]}"
        return out
    # xinntao ESRGAN (RRDB_trunk) and Real-ESRGAN (body/conv_body)
    return {k: (k.replace("RRDB_trunk.", "body.")
                .replace("conv_body.", "trunk_conv.")
                .replace("conv_up1.", "upconv1.")
                .replace("conv_up2.", "upconv2.")
                .replace("conv_hr.", "HRconv.")) for k in keys}


def load_upscaler_checkpoint(path: str, cfg) -> Tensors:
    """An ESRGAN/RRDB ``.pth``/``.safetensors`` file -> the state dict of
    the port's ``RRDBNet(cfg)`` (the file's tensors and dtypes)."""
    sd = load_state_dict(path)
    norm = _rrdb_key_norm(sd)
    canon = {norm[k]: v for k, v in sd.items() if k in norm}
    out: Tensors = {}

    def conv(tkeys, name: str) -> None:
        """The first torch-key variant present -> parameter ``name``."""
        tkeys = (tkeys,) if isinstance(tkeys, str) else tkeys
        for tkey in tkeys:
            w = canon.get(tkey + ".weight")
            if w is not None:
                out[name + ".weight"] = w
                b = canon.get(tkey + ".bias")
                if b is not None:
                    out[name + ".bias"] = b
                return
        raise KeyError(f"upscaler checkpoint missing any of {tkeys} "
                       f"(have e.g. {sorted(canon)[:3]})")

    conv("conv_first", "conv_first")
    for i in range(cfg.num_blocks):
        for j in range(3):
            for k in range(5):
                # Real-ESRGAN writes rdb1, xinntao and old-arch RDB1
                conv((f"body.{i}.rdb{j + 1}.conv{k + 1}",
                      f"body.{i}.RDB{j + 1}.conv{k + 1}"),
                     f"rrdb_{i}.db{j}.conv{k}")
    conv("trunk_conv", "trunk_conv")
    n_up = {1: 0, 2: 1, 4: 2, 8: 3}[cfg.scale]
    for i in range(n_up):
        conv(f"upconv{i + 1}", f"up_{i}")
    conv("HRconv", "hr_conv")
    conv("conv_last", "conv_last")
    return out
