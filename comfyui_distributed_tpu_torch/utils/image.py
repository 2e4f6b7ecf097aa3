"""Image file output without an imaging library: an 8-bit RGB PNG
writer on ``zlib``, the counterpart of ``tensor_to_pil(...).save`` in
``comfyui_distributed_tpu/utils/image.py``."""

from __future__ import annotations

import struct
import zlib

import numpy as np


def to_uint8(img: np.ndarray) -> np.ndarray:
    """[H, W, C] float in [0, 1] -> uint8 with round-half-up."""
    return np.clip(np.asarray(img, np.float32) * 255.0 + 0.5, 0,
                   255).astype(np.uint8)


def encode_png(img: np.ndarray) -> bytes:
    """[H, W, 3] float image in [0, 1] -> PNG bytes (8-bit RGB, no
    filter)."""
    px = to_uint8(img)
    if px.ndim != 3 or px.shape[-1] != 3:
        raise ValueError(f"encode_png takes [H, W, 3]; got {px.shape}")
    h, w, _ = px.shape
    rows = np.concatenate([np.zeros((h, 1), np.uint8),
                           px.reshape(h, w * 3)], axis=1)

    def chunk(tag: bytes, data: bytes) -> bytes:
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))

    header = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)
    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", header)
            + chunk(b"IDAT", zlib.compress(rows.tobytes(), 6))
            + chunk(b"IEND", b""))


def save_png(path: str, img: np.ndarray) -> None:
    with open(path, "wb") as f:
        f.write(encode_png(img))
