"""A1111-format hypernetworks: the port's copy of
``comfyui_distributed_tpu/models/hypernetwork.py``.

HypernetworkLoader patches every cross-attention: ``k = to_k(ctx +
MLP_k(ctx) * strength)`` and the same for v with its own MLP.  The text
context is the same in every layer, so the transform runs once a model
call (``models/denoiser.py``) and the UNet takes the two streams as
(context, context_v): the same numbers, one evaluation instead of
sixteen.  Only the entry of the context's width applies; entries at the
UNet's hidden widths (self-attention) are not patched, as in the JAX
package, which logs it at load.

The file (a torch pickle, read with ``weights_only=True``): integer keys
map context widths to a ``[k_state_dict, v_state_dict]`` pair of
``nn.Sequential`` exports (``linear.N.weight``/``bias``; a 2-D weight is
a Linear, a 1-D pair a LayerNorm), with ``activation_func``,
``activate_output`` and the rest as metadata.  Dropout is a no-op in
inference.
"""

from __future__ import annotations

import os
import re
import zlib
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from comfyui_distributed_tpu_torch.utils.log import log

_ACTS = {
    "linear": None,
    "relu": F.relu,
    "leakyrelu": lambda x: F.leaky_relu(x, 0.01),
    "elu": F.elu,
    "swish": F.silu,
    "silu": F.silu,
    "tanh": torch.tanh,
    "sigmoid": torch.sigmoid,
    "mish": lambda x: x * torch.tanh(F.softplus(x)),
    "softsign": F.softsign,
}

# one parsed stream: an ordered list of ("linear", w [in, out], b),
# ("ln", scale, bias) and ("act", name), arrays in float32
Layers = List[Tuple]
# context width -> (k layers, v layers)
Hypernet = Dict[int, Tuple[Layers, Layers]]


def _parse_stream(sd: Dict[str, Any], activation: str,
                  activate_output: bool) -> Layers:
    """One Sequential export -> its layers in order.  Activations have no
    parameters, so they come back from the metadata: after every Linear
    but the last (and the last too with ``activate_output``)."""
    entries = []
    for key in sd:
        m = re.fullmatch(r"(?:linear\.)?(\d+)\.weight", key)
        if not m:
            continue
        prefix = key[: -len("weight")]
        w = np.asarray(sd[key], np.float32)
        b = np.asarray(sd.get(prefix + "bias", np.zeros(w.shape[0])),
                       np.float32)
        entries.append((int(m.group(1)), w, b))
    entries.sort(key=lambda e: e[0])
    linear_count = sum(1 for _, w, _ in entries if w.ndim == 2)
    layers: Layers = []
    seen_linear = 0
    for _, w, b in entries:
        if w.ndim == 2:
            seen_linear += 1
            # a torch Linear stores [out, in]
            layers.append(("linear", np.ascontiguousarray(w.T), b))
            if activation != "linear" and (
                    seen_linear < linear_count or activate_output):
                layers.append(("act", activation))
        else:
            layers.append(("ln", w, b))
    return layers


def parse_hypernetwork(sd: Dict[str, Any]) -> Hypernet:
    activation = str(sd.get("activation_func", "linear")).lower()
    if activation not in _ACTS:
        log(f"hypernetwork: unknown activation {activation!r}; "
            "treating as linear")
        activation = "linear"
    activate_output = bool(sd.get("activate_output", False))
    out: Hypernet = {}
    for key, value in sd.items():
        if not isinstance(key, int):
            continue
        out[int(key)] = (_parse_stream(value[0], activation, activate_output),
                         _parse_stream(value[1], activation, activate_output))
    return out


def _run_stack(layers: Layers, x: torch.Tensor) -> torch.Tensor:
    """One stream's MLP in float32, on x's device, back in x's dtype."""
    h = x.float()

    def t(a):
        return torch.as_tensor(a, dtype=torch.float32, device=x.device)

    for entry in layers:
        kind = entry[0]
        if kind == "linear":
            h = h @ t(entry[1]) + t(entry[2])
        elif kind == "ln":
            mean = h.mean(dim=-1, keepdim=True)
            var = h.var(dim=-1, keepdim=True, correction=0)
            h = (h - mean) / torch.sqrt(var + 1e-5) * t(entry[1]) \
                + t(entry[2])
        else:
            h = _ACTS[entry[1]](h)
    return h.to(x.dtype)


def apply_hypernetwork_pair(hn: Hypernet, strength: float,
                            ctx_k: torch.Tensor, ctx_v: torch.Tensor
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The k stack on the k stream, the v stack on the v stream: ``x +
    MLP(x) * strength`` each when the context's width has an entry, else
    both as they are.  Chained loaders call it in turn."""
    dim = int(ctx_k.shape[-1])
    if dim not in hn:
        return ctx_k, ctx_v
    k_layers, v_layers = hn[dim]
    return (ctx_k + _run_stack(k_layers, ctx_k) * strength,
            ctx_v + _run_stack(v_layers, ctx_v) * strength)


def _virtual_hypernet(dims: Tuple[int, ...], seed: int) -> Hypernet:
    """The JAX package's virtual hypernetwork: small residual MLPs (d ->
    2d, relu, -> d) a width, drawn by numpy from (seed, d)."""
    out: Hypernet = {}
    for d in dims:
        rng = np.random.default_rng((seed, d))

        def stream():
            w1 = rng.standard_normal((d, d * 2)).astype(np.float32) \
                / np.sqrt(d) * 0.3
            w2 = rng.standard_normal((d * 2, d)).astype(np.float32) \
                / np.sqrt(d * 2) * 0.3
            return [("linear", w1, np.zeros((d * 2,), np.float32)),
                    ("act", "relu"),
                    ("linear", w2, np.zeros((d,), np.float32))]

        out[d] = (stream(), stream())
    return out


def _denumpy(v):
    if isinstance(v, torch.Tensor):
        return v.float().numpy()
    if isinstance(v, dict):
        return {k: _denumpy(x) for k, x in v.items()}
    if isinstance(v, (list, tuple)):
        return [_denumpy(x) for x in v]
    return v


_cache: Dict[tuple, Hypernet] = {}
_on_device: Dict[tuple, Tuple[Hypernet, Hypernet]] = {}


def hypernet_on(hn: Hypernet, device) -> Hypernet:
    """``hn`` with its arrays as float32 tensors on ``device``, made once
    a (hypernetwork, device): a model call then copies nothing from the
    host."""
    key = (id(hn), str(device))
    out = _on_device.get(key)
    if out is None or out[0] is not hn:
        def conv(layers):
            return [tuple(torch.as_tensor(a, dtype=torch.float32,
                                          device=device)
                          if isinstance(a, np.ndarray) else a
                          for a in entry) for entry in layers]

        out = (hn, {d: (conv(k), conv(v)) for d, (k, v) in hn.items()})
        _on_device[key] = out
    return out[1]


def load_hypernetwork(name: str, models_dir: Optional[str] = None,
                      virtual_dims: Tuple[int, ...] = (64, 320, 640, 768,
                                                       1024, 1280)
                      ) -> Hypernet:
    """``<models_dir>/hypernetworks/<name>[.pt]`` (an A1111 file); with
    no file, the virtual hypernetwork of the name (seed crc32 of it)."""
    key = (models_dir or "", name)
    if key in _cache:
        return _cache[key]
    path = None
    if models_dir:
        for cand in (name, name + ".pt"):
            p = os.path.join(models_dir, "hypernetworks",
                             cand.replace("\\", "/"))
            if os.path.isfile(p):
                path = p
                break
    if path is not None:
        sd = torch.load(path, map_location="cpu", weights_only=True)
        hn = parse_hypernetwork({k: _denumpy(v) for k, v in sd.items()})
        log(f"loaded hypernetwork {name} (dims {sorted(hn)}) from {path}")
        self_attn = sorted(d for d in hn if d not in (768, 1024, 2048))
        if self_attn:
            log(f"hypernetwork {name}: entries at hidden widths {self_attn} "
                "target self-attention, which is not patched: only the "
                "text cross-attention streams apply")
    else:
        seed = zlib.crc32(name.encode())
        hn = _virtual_hypernet(virtual_dims, seed)
        log(f"virtual hypernetwork {name!r}: no file on disk, "
            f"deterministic init (seed {seed})")
    _cache[key] = hn
    return hn


def clear_hypernetwork_cache() -> None:
    _cache.clear()
    _on_device.clear()
