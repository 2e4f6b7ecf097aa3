"""Flash attention forward: the CUDA kernels' wrapper and their plain version.

Counterpart of ``comfyui_distributed_tpu/ops/pallas/flash_attention.py``:
non-causal multi-head attention of q [B, N, H, D] against k/v
[B, M, H, D], scale 1/sqrt(D) unless given, fp32 softmax, output in the
input dtype.  Every UNet attention goes through :func:`flash_attention`.

On a CUDA tensor it launches one of three kernels (built for ``sm_90a``
on first use) on the current stream, reading and writing the
[B, N, H, D] layout in place.  Which one is fixed by dtype and head dim
(:func:`kernel_variant`); on a CPU tensor it runs
:func:`flash_attention_plain`.  The checks are the same on both, so a
shape no kernel takes fails on the CPU too.
"""

from __future__ import annotations

import collections
import ctypes
import math
import threading
from typing import Callable, Dict, Optional

import torch

from comfyui_distributed_tpu_torch.ops.kernels import build

# D = 64: every SDXL attention; D = 40/80/160: SD1.5's eight heads at
# widths 320/640/1280; D = 16/32: the tiny family
SUPPORTED_HEAD_DIMS = (16, 32, 40, 64, 80, 160)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

# variant -> (csrc/<source>.cu, C entry point)
VARIANTS = {
    # TMA, a K/V ring in shared memory, wgmma, warp-specialised: bf16, D = 64
    "sm90": ("flash_attention_sm90", "dtpu_flash_attention_sm90_fwd"),
    # mma.sync m16n8k16, synchronous loads: bf16, every supported D
    "mma_sync": ("flash_attention", "dtpu_flash_attention_fwd"),
    # one query row per 1, 2 or 4 threads, FMA: fp32, every supported D
    "fp32": ("flash_attention", "dtpu_flash_attention_fwd"),
}

# q, k, v, o; batch, n, m, heads, head_dim; scale; (dtype code;) stream
_ARGTYPES = {
    "dtpu_flash_attention_sm90_fwd": [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5
    + [ctypes.c_float, ctypes.c_void_p],
    "dtpu_flash_attention_fwd": [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5
    + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p],
}

_lib_lock = threading.Lock()
_fns: Dict[str, Callable[..., int]] = {}


def kernel_variant(dtype: torch.dtype, head_dim: int) -> str:
    """The kernel a CUDA launch of this dtype and head dim takes: bf16
    with D = 64 (every SDXL attention) -> ``"sm90"``; bf16 with D in
    {16, 32, 40, 80, 160} (SD1.5 and the tiny family) -> ``"mma_sync"``;
    fp32 -> ``"fp32"``.  A rule of the shape, not a fallback: raises for
    what no kernel takes."""
    if head_dim not in SUPPORTED_HEAD_DIMS:
        raise ValueError(f"flash_attention head dim {head_dim} not in "
                         f"{SUPPORTED_HEAD_DIMS}")
    if dtype == torch.bfloat16:
        return "sm90" if head_dim == 64 else "mma_sync"
    if dtype == torch.float32:
        return "fp32"
    raise TypeError(f"flash_attention takes float32 or bfloat16, not {dtype}")


def _kernel_fn(variant: str) -> Callable[..., int]:
    source, entry = VARIANTS[variant]
    with _lib_lock:
        fn = _fns.get(entry)
        if fn is None:
            fn = getattr(build.load(source), entry)
            fn.argtypes = _ARGTYPES[entry]
            fn.restype = ctypes.c_int
            _fns[entry] = fn
        return fn


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
    scale = 1.0 / math.sqrt(q.shape[-1]) if scale is None else float(scale)
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, scale)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention runs on cuda or cpu, not "
                         f"{q.device}")
    return _launch(q, k, v, scale, kernel_variant(q.dtype, q.shape[-1]))


def _launch_variant(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    variant: str, scale: Optional[float] = None
                    ) -> torch.Tensor:
    """Launch the named variant where it takes these inputs (``mma_sync``
    also takes bf16 with D = 64), to time one kernel beside another on
    the same inputs.  The main path never calls it."""
    _check(q, k, v)
    if q.device.type != "cuda":
        raise ValueError("a named variant launches a kernel: needs CUDA "
                         "tensors")
    takes = {"sm90": q.dtype == torch.bfloat16 and q.shape[-1] == 64,
             "mma_sync": q.dtype == torch.bfloat16,
             "fp32": q.dtype == torch.float32}
    if not takes.get(variant, False):
        raise ValueError(f"variant {variant!r} does not take {q.dtype} "
                         f"with head dim {q.shape[-1]}")
    scale = 1.0 / math.sqrt(q.shape[-1]) if scale is None else float(scale)
    return _launch(q, k, v, scale, variant)


def _launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float,
            variant: str) -> torch.Tensor:
    B, N, H, D = q.shape
    M = k.shape[1]
    for t in (q, k, v):
        if t.data_ptr() % 16:
            raise ValueError("flash_attention needs 16-byte aligned q/k/v")
    if variant == "sm90":
        # TMA: row strides H*D*2 bytes must be multiples of 16, and the
        # kernel's mask folds the scale into the running max
        if (H * D * q.element_size()) % 16:
            raise ValueError("flash_attention (sm90) needs a row stride "
                             "that is a multiple of 16 bytes")
        if not (scale > 0 and math.isfinite(scale)):
            raise ValueError(f"flash_attention (sm90) takes a positive "
                             f"finite scale, not {scale}")
    fn = _kernel_fn(variant)
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        args = [q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                B, N, M, H, D, scale]
        if variant != "sm90":
            args.append(_DTYPE_CODES[q.dtype])
        err = fn(*args, stream)
    if err != 0:
        raise RuntimeError(f"flash_attention kernel ({variant}) launch "
                           f"failed: CUDA error {err}")
    flash_attention.launches += 1
    flash_attention.shapes[(B, N, M, H, D, str(q.dtype))] += 1
    flash_attention.variants[variant] += 1
    return out


def reset_counts() -> None:
    flash_attention.launches = 0
    flash_attention.shapes = collections.Counter()
    flash_attention.variants = collections.Counter()


# kernel launches since the last reset: a plain int, the same count split
# by (B, N, M, H, D, dtype), and split by variant.  The CPU path and the
# plain version do not count.
reset_counts()
