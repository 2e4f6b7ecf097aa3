"""Flash attention forward: the CUDA kernel's wrapper and its plain version.

Counterpart of ``comfyui_distributed_tpu/ops/pallas/flash_attention.py``:
non-causal multi-head attention of q [B, N, H, D] against k/v
[B, M, H, D], scale 1/sqrt(D) unless given, fp32 softmax, output in the
input dtype.  Every UNet attention goes through :func:`flash_attention`.

On a CUDA tensor it launches ``csrc/flash_attention.cu`` (built for
``sm_90a`` on first use) on the current stream, reading and writing the
[B, N, H, D] layout in place; on a CPU tensor it runs
:func:`flash_attention_plain`.  The checks are the same on both, so a
shape the kernel refuses fails on the CPU too.
"""

from __future__ import annotations

import collections
import ctypes
import math
import threading
from typing import Optional

import torch

from comfyui_distributed_tpu_torch.ops.kernels import build

KERNEL = "flash_attention"
SUPPORTED_HEAD_DIMS = (16, 32, 64)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

_lib_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def _kernel_lib() -> ctypes.CDLL:
    global _lib
    with _lib_lock:
        if _lib is None:
            lib = build.load(KERNEL)
            fn = lib.dtpu_flash_attention_fwd
            fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [
                ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
            fn.restype = ctypes.c_int
            _lib = lib
        return _lib


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          scale: Optional[float] = None) -> torch.Tensor:
    """The same function in plain torch: fp32 scores, fp32 softmax,
    probabilities cast to the value dtype, output in the input dtype."""
    scale = 1.0 / math.sqrt(q.shape[-1]) if scale is None else float(scale)
    s = torch.einsum("bnhd,bmhd->bhnm", q.float(), k.float()) * scale
    w = torch.softmax(s, dim=-1)
    return torch.einsum("bhnm,bmhd->bnhd", w.to(v.dtype), v).to(q.dtype)


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    if q.ndim != 4 or k.ndim != 4 or v.ndim != 4:
        raise ValueError("flash_attention takes q [B, N, H, D] and k/v "
                         f"[B, M, H, D]; got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    B, N, H, D = q.shape
    if k.shape != v.shape or k.shape[0] != B or k.shape[2:] != (H, D):
        raise ValueError(f"q {tuple(q.shape)} and k {tuple(k.shape)} / "
                         f"v {tuple(v.shape)} disagree")
    if N == 0 or k.shape[1] == 0:
        raise ValueError("flash_attention needs at least one query and "
                         "one key")
    if q.dtype not in _DTYPE_CODES or k.dtype != q.dtype \
            or v.dtype != q.dtype:
        raise TypeError(f"flash_attention takes float32 or bfloat16 q/k/v "
                        f"of one dtype; got {q.dtype}, {k.dtype}, {v.dtype}")
    if D not in SUPPORTED_HEAD_DIMS:
        raise ValueError(f"flash_attention head dim {D} not in "
                         f"{SUPPORTED_HEAD_DIMS}")
    if not (q.device == k.device == v.device):
        raise ValueError("q, k and v must lie on one device")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("flash_attention takes contiguous q/k/v")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    scale: Optional[float] = None) -> torch.Tensor:
    """[B, N, H, D] attention of q against k/v [B, M, H, D]."""
    _check(q, k, v)
    B, N, H, D = q.shape
    scale = 1.0 / math.sqrt(D) if scale is None else float(scale)
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, scale)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention runs on cuda or cpu, not "
                         f"{q.device}")
    for t in (q, k, v):
        if t.data_ptr() % 16:
            raise ValueError("flash_attention needs 16-byte aligned q/k/v")
    fn = _kernel_lib().dtpu_flash_attention_fwd
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 B, N, k.shape[1], H, D, scale, _DTYPE_CODES[q.dtype],
                 stream)
    if err != 0:
        raise RuntimeError(f"flash_attention kernel launch failed: CUDA "
                           f"error {err}")
    flash_attention.launches += 1
    flash_attention.shapes[(B, N, k.shape[1], H, D, str(q.dtype))] += 1
    return out


def reset_counts() -> None:
    flash_attention.launches = 0
    flash_attention.shapes = collections.Counter()


# kernel launches since the last reset: a plain int, and the same count
# split by (B, N, M, H, D, dtype).  The CPU path and the plain version do
# not count.
reset_counts()
