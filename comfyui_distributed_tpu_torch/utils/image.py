"""Image files and resampling without an imaging library: the
counterparts of ``tensor_to_pil(...).save``, ``pil_to_tensor`` and
``resize_image`` in ``comfyui_distributed_tpu/utils/image.py``.

- PNG: an 8-bit L/RGB/RGBA writer (with ``tEXt`` chunks) and reader
  on ``zlib``.
- The raw-tensor wire of the HTTP fan-out (``encode_tensor`` /
  ``decode_tensor``): the JAX package's ``DTT1`` framing, zlib codec.
- :func:`resize_image` reproduces Pillow's resampling of float ("F")
  images (``Resample.c``), which the JAX package runs per channel: a
  separable pass over the width, then one over the height, each with the
  filter's coefficients computed in float64 and normalised per output
  pixel, the sum taken in float64 and rounded to float32 between the
  passes.  Here the passes are float64 matrix products on the image's
  own device.  Nearest-neighbour follows Pillow's affine scaling
  (``Geometry.c``), and a same-size resize is a copy, as in Pillow.
"""

from __future__ import annotations

import functools
import io
import math
import struct
import zlib
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

_PNG_MAGIC = b"\x89PNG\r\n\x1a\n"
# PNG colour type -> channels, for the 8-bit types read and written
_PNG_CHANNELS = {0: 1, 2: 3, 6: 4}
_PNG_COLOUR_TYPE = {c: t for t, c in _PNG_CHANNELS.items()}


def to_uint8(img: np.ndarray) -> np.ndarray:
    """[H, W, C] float in [0, 1] -> uint8 with round-half-up."""
    return np.clip(np.asarray(img, np.float32) * 255.0 + 0.5, 0,
                   255).astype(np.uint8)


def encode_png(img: np.ndarray,
               text: Optional[Dict[str, str]] = None) -> bytes:
    """[H, W, C] (or [1, H, W, C]) float image in [0, 1] -> PNG bytes
    (8-bit, no filter: L, RGB or RGBA for C = 1, 3 or 4); each ``text``
    item becomes a ``tEXt`` chunk, as ComfyUI stores the ``prompt`` of a
    saved image."""
    px = to_uint8(img)
    if px.ndim == 4 and px.shape[0] == 1:
        px = px[0]
    if px.ndim != 3 or px.shape[-1] not in _PNG_COLOUR_TYPE:
        raise ValueError(f"encode_png takes [H, W, 1, 3 or 4]; got "
                         f"{px.shape}")
    h, w, c = px.shape
    rows = np.concatenate([np.zeros((h, 1), np.uint8),
                           px.reshape(h, w * c)], axis=1)

    def chunk(tag: bytes, data: bytes) -> bytes:
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))

    header = struct.pack(">IIBBBBB", w, h, 8, _PNG_COLOUR_TYPE[c], 0, 0, 0)
    texts = b"".join(chunk(b"tEXt", k.encode("latin-1") + b"\0"
                           + v.encode("latin-1"))
                     for k, v in (text or {}).items())
    return (_PNG_MAGIC + chunk(b"IHDR", header) + texts
            + chunk(b"IDAT", zlib.compress(rows.tobytes(), 6))
            + chunk(b"IEND", b""))


def save_png(path: str, img: np.ndarray,
             text: Optional[Dict[str, str]] = None) -> None:
    with open(path, "wb") as f:
        f.write(encode_png(img, text))


# --- raw-tensor wire format (application/x-dtpu-tensor) ---------------------
#
# The JAX package's framing: 4-byte magic, one codec byte, then the
# array's npy bytes compressed.  The port decodes and writes zlib only
# (the card's machine has no zstandard) and says so in ``tensor_codecs``,
# so a peer never sends it zstd.

_TENSOR_WIRE_MAGIC = b"DTT1"
_CODEC_ZLIB = 1
_CODEC_ZSTD = 2


def tensor_codecs() -> List[str]:
    """The codecs this process decodes, best first."""
    return ["zlib"]


def encode_tensor(x, codec: str = "zlib") -> bytes:
    """Array -> wire bytes: lossless, dtype kept (a float32 image stays
    float32)."""
    if codec != "zlib":
        raise ValueError(f"tensor codec {codec!r} not in {tensor_codecs()}")
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    buf = io.BytesIO()
    np.save(buf, np.ascontiguousarray(x), allow_pickle=False)
    return (_TENSOR_WIRE_MAGIC + bytes([_CODEC_ZLIB])
            + zlib.compress(buf.getvalue(), 1))


def decode_tensor(data: bytes) -> np.ndarray:
    """Wire bytes -> [B, H, W, C] float32, as a decoded PNG upload."""
    if data[:4] != _TENSOR_WIRE_MAGIC:
        raise ValueError("bad tensor wire magic")
    codec, payload = data[4], data[5:]
    if codec == _CODEC_ZSTD:
        raise ValueError("zstd tensor payload: this process decodes "
                         f"{tensor_codecs()} only")
    if codec != _CODEC_ZLIB:
        raise ValueError(f"unknown tensor wire codec {codec}")
    arr = np.asarray(np.load(io.BytesIO(zlib.decompress(payload)),
                             allow_pickle=False), np.float32)
    if arr.ndim == 3:
        arr = arr[None]
    if arr.ndim != 4:
        raise ValueError(f"tensor wire payload of shape {arr.shape}; "
                         "expected [B, H, W, C] or [H, W, C]")
    return arr


def _unfilter(raw: np.ndarray, h: int, stride: int, bpp: int) -> np.ndarray:
    """Undo the PNG row filters (none, sub, up, average, Paeth) of ``h``
    rows of ``stride`` bytes, each led by its filter byte."""
    rows = raw.reshape(h, stride + 1)
    out = np.zeros((h, stride), np.uint8)
    prev = np.zeros(stride, np.int64)
    for y in range(h):
        kind, line = int(rows[y, 0]), rows[y, 1:].astype(np.int64)
        if kind == 0:
            cur = line
        elif kind == 1:
            # each byte adds the reconstructed byte bpp before it
            cur = (np.cumsum(line.reshape(-1, bpp), axis=0) & 0xFF).ravel()
        elif kind == 2:
            cur = (line + prev) & 0xFF
        elif kind in (3, 4):
            # average and Paeth predict from the reconstructed neighbours:
            # a byte-serial recurrence, on Python ints
            ln, up, c = line.tolist(), prev.tolist(), [0] * stride
            for x in range(stride):
                a = c[x - bpp] if x >= bpp else 0
                b = up[x]
                if kind == 3:
                    pred = (a + b) >> 1
                else:
                    ul = up[x - bpp] if x >= bpp else 0
                    p = a + b - ul
                    pa, pb, pc = abs(p - a), abs(p - b), abs(p - ul)
                    pred = a if pa <= pb and pa <= pc else \
                        (b if pb <= pc else ul)
                c[x] = (ln[x] + pred) & 0xFF
            cur = np.asarray(c, np.int64)
        else:
            raise ValueError(f"PNG row {y}: unknown filter type {kind}")
        out[y] = cur
        prev = cur
    return out


def decode_png(data: bytes) -> np.ndarray:
    """PNG bytes -> [1, H, W, C] float32 in [0, 1] (C = 1, 3 or 4), as
    ``pil_to_tensor(Image.open(...))`` gives for an L, RGB or RGBA file.
    Takes 8-bit greyscale, RGB and RGBA without interlacing; raises
    ``NotImplementedError`` for the other PNG kinds."""
    if data[:8] != _PNG_MAGIC:
        raise ValueError("not a PNG file")
    pos, header, idat = 8, None, []
    while pos + 8 <= len(data):
        length, tag = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + length]
        pos += 12 + length
        if tag == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif tag == b"IDAT":
            idat.append(body)
        elif tag == b"IEND":
            break
    if header is None or not idat:
        raise ValueError("PNG without IHDR or IDAT")
    w, h, depth, ctype, _comp, _filt, interlace = header
    if depth != 8 or ctype not in _PNG_CHANNELS or interlace:
        raise NotImplementedError(
            f"PNG bit depth {depth}, colour type {ctype}, interlace "
            f"{interlace}: only 8-bit L, RGB and RGBA without interlacing "
            "are read")
    c = _PNG_CHANNELS[ctype]
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    if raw.size != h * (w * c + 1):
        raise ValueError(f"PNG data holds {raw.size} bytes for a {w}x{h} "
                         f"image of {c} channels")
    px = _unfilter(raw, h, w * c, c).reshape(h, w, c)
    return (px.astype(np.float32) / 255.0)[None]


# --- resampling -------------------------------------------------------------


def _box(x: float) -> float:
    return 1.0 if -0.5 < x <= 0.5 else 0.0


def _bilinear(x: float) -> float:
    x = abs(x)
    return 1.0 - x if x < 1.0 else 0.0


def _bicubic(x: float, a: float = -0.5) -> float:
    x = abs(x)
    if x < 1.0:
        return ((a + 2.0) * x - (a + 3.0)) * x * x + 1
    if x < 2.0:
        return (((x - 5) * x + 8) * x - 4) * a
    return 0.0


def _sinc(x: float) -> float:
    if x == 0.0:
        return 1.0
    x = x * math.pi
    return math.sin(x) / x


def _lanczos(x: float) -> float:
    return _sinc(x) * _sinc(x / 3) if -3.0 <= x < 3.0 else 0.0


# method -> (filter, support); None: nearest neighbour
FILTERS: Dict[str, Tuple[Callable[[float], float], float] | None] = {
    "nearest": None,
    "nearest-exact": None,
    "area": (_box, 0.5),
    "bilinear": (_bilinear, 1.0),
    "bicubic": (_bicubic, 2.0),
    "lanczos": (_lanczos, 3.0),
}


@functools.lru_cache(maxsize=64)
def resample_matrix(in_size: int, out_size: int,
                    method: str) -> torch.Tensor:
    """[out_size, in_size] float64 weights (on the CPU) of one resampling
    pass: Pillow's ``precompute_coeffs`` (support widened by the
    downscale factor, taps rounded to whole pixels and clipped to the
    image, each output pixel's weights normalised to sum to 1)."""
    filt, support = FILTERS[method]
    scale = in_size / out_size
    filterscale = max(scale, 1.0)
    support = support * filterscale
    ss = 1.0 / filterscale
    mat = np.zeros((out_size, in_size), np.float64)
    for xx in range(out_size):
        center = (xx + 0.5) * scale
        xmin = max(int(center - support + 0.5), 0)
        xmax = min(int(center + support + 0.5), in_size)
        w = np.array([filt((x - center + 0.5) * ss)
                      for x in range(xmin, xmax)], np.float64)
        total = w.sum()
        mat[xx, xmin:xmax] = w / total if total != 0.0 else w
    return torch.from_numpy(mat)


def nearest_index(in_size: int, out_size: int) -> np.ndarray:
    """Source index of each output pixel under Pillow's nearest-neighbour
    scaling: positions accumulate ``in/out`` per pixel from half a step in
    float64, as ``ImagingScaleAffine`` adds them, and are truncated."""
    step = in_size / out_size
    pos = np.add.accumulate(np.concatenate([[step * 0.5],
                                            np.full(out_size - 1, step)]))
    return np.clip(pos.astype(np.int64), 0, in_size - 1)


def _resize_axis(x: torch.Tensor, size: int, axis: int,
                 method: str) -> torch.Tensor:
    """One pass over ``axis`` of a float32 [B, H, W, C] tensor."""
    n = x.shape[axis]
    if FILTERS[method] is None:
        idx = torch.as_tensor(nearest_index(n, size), device=x.device)
        return x.index_select(axis, idx)
    mat = resample_matrix(n, size, method).to(x.device)
    sub = "bhwc,ph->bpwc" if axis == 1 else "bhwc,pw->bhpc"
    return torch.einsum(sub, x.double(), mat).float()


def resize_image(x: torch.Tensor, width: int, height: int,
                 method: str = "lanczos") -> torch.Tensor:
    """Resize a float32 [B, H, W, C] (or [H, W, C]) tensor to ``width`` x
    ``height`` on its own device, as Pillow resizes each channel as an
    "F" image: no clipping or quantisation, so out-of-range values
    survive.  A method the JAX package does not map falls back to
    lanczos, as there."""
    if x.ndim == 3:
        return resize_image(x[None], width, height, method)[0]
    x = x.float()
    if (x.shape[2], x.shape[1]) == (width, height):
        return x.clone()
    if method not in FILTERS:
        method = "lanczos"
    if FILTERS[method] is None:
        return _resize_axis(_resize_axis(x, int(width), 2, method),
                            int(height), 1, method)
    # Pillow skips a pass whose size does not change
    if x.shape[2] != width:
        x = _resize_axis(x, int(width), 2, method)
    if x.shape[1] != height:
        x = _resize_axis(x, int(height), 1, method)
    return x
