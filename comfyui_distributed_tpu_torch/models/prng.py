"""Seed-to-noise path: counter-based threefry2x32 keys and normal draws.

The sampler's noise comes from explicit keys, never from a global
generator: ``sample_keys`` turns per-sample 64-bit seeds into 2x32-bit
keys, and ``normal`` draws a standard-normal tensor from one key.  The
bits follow the threefry2x32 hash (Salmon et al., "Parallel random
numbers: as easy as 1, 2, 3") with the key derivation, ``fold_in`` and
bits -> uniform -> ``sqrt(2) * erfinv`` mapping of the JAX package's
default generator (partitionable counters), so one seed gives the same
noise in both packages.

The hash runs in numpy (exact 32-bit wrap-around arithmetic); the last
float step, ``erfinv``, runs on the tensor's device.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch

_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_KS_PARITY = np.uint32(0x1BD11BDA)

# fold-in index of the initial latent noise: reserved so it never
# collides with per-step noise indices (steps count from 0)
INIT_NOISE_INDEX = 0x7FFFFFFF


def _u32(x) -> np.ndarray:
    return np.atleast_1d(np.asarray(x, dtype=np.uint32))


def _rotl(x: np.ndarray, r: int) -> np.ndarray:
    return (x << np.uint32(r)) | (x >> np.uint32(32 - r))


def threefry2x32(k0, k1, x0, x1) -> Tuple[np.ndarray, np.ndarray]:
    """The threefry2x32 block function with 20 rounds: key (k0, k1),
    counter words (x0, x1), all uint32 arrays that broadcast together."""
    k0, k1, x0, x1 = (_u32(a) for a in (k0, k1, x0, x1))
    ks = (k0, k1, k0 ^ k1 ^ _KS_PARITY)
    x0 = x0 + ks[0]
    x1 = x1 + ks[1]
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = x0 + x1
            x1 = _rotl(x1, r) ^ x0
        x0 = x0 + ks[(i + 1) % 3]
        x1 = x1 + ks[(i + 2) % 3] + np.uint32(i + 1)
    return x0, x1


def key_from_seed(seed: int) -> np.ndarray:
    """Key of a 32-bit seed: the words (0, seed)."""
    return np.asarray([0, int(seed) & 0xFFFFFFFF], np.uint32)


def fold_in(key: np.ndarray, data: int) -> np.ndarray:
    """New key from ``key`` and a 32-bit integer: the hash of the
    counter (0, data) under ``key``."""
    y0, y1 = threefry2x32(key[..., 0], key[..., 1], 0,
                         np.uint32(int(data) & 0xFFFFFFFF))
    return np.stack([y0, y1], axis=-1).reshape(key.shape)


def random_bits(key: np.ndarray, shape: Sequence[int]) -> np.ndarray:
    """uint32 bits of ``shape``: element i (row-major) hashes the 64-bit
    counter i split into (hi, lo) words, and the two output words are
    xor-ed together."""
    size = int(np.prod(shape, dtype=np.int64))
    idx = np.arange(size, dtype=np.uint64)
    hi = (idx >> np.uint64(32)).astype(np.uint32)
    lo = (idx & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    b0, b1 = threefry2x32(key[0], key[1], hi, lo)
    return (b0 ^ b1).reshape(tuple(shape))


def uniform_open(key: np.ndarray, shape: Sequence[int]) -> np.ndarray:
    """float32 uniforms in [nextafter(-1, 0), 1): 23 random mantissa bits
    give a float in [1, 2), shifted to [0, 1) and scaled to the range."""
    bits = random_bits(key, shape)
    one = np.float32(1.0)
    floats = ((bits >> np.uint32(9)) | one.view(np.uint32)).view(
        np.float32) - one
    lo = np.nextafter(np.float32(-1.0), np.float32(0.0), dtype=np.float32)
    span = np.float32(one - lo)
    return np.maximum(lo, floats * span + lo).astype(np.float32)


# Giles, "Approximating the erfinv function" (GPU Computing Gems, 2011):
# single-precision polynomials in w = -log(1 - x^2), split at w = 5
_ERFINV_CENTRAL = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06,
                   -4.39150654e-06, 0.00021858087, -0.00125372503,
                   -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_TAIL = (-0.000200214257, 0.000100950558, 0.00134934322,
                -0.00367342844, 0.00573950773, -0.0076224613,
                0.00943887047, 1.00167406, 2.83297682)


def _horner(coeffs, w: torch.Tensor) -> torch.Tensor:
    p = torch.full_like(w, coeffs[0])
    for c in coeffs[1:]:
        p = c + p * w
    return p


def erfinv(x: torch.Tensor) -> torch.Tensor:
    """float32 erfinv by Giles' polynomials, the approximation the JAX
    package's noise goes through (``torch.erfinv`` differs from it by up
    to 1.5e-5 in the tails)."""
    w = -torch.log1p(-x * x)
    central = _horner(_ERFINV_CENTRAL, w - 2.5)
    tail = _horner(_ERFINV_TAIL, torch.sqrt(w) - 3.0)
    return torch.where(w < 5.0, central, tail) * x


def normal(key: np.ndarray, shape: Sequence[int],
           device: torch.device | str = "cpu") -> torch.Tensor:
    """Standard-normal float32 tensor of ``shape`` on ``device``, drawn
    from ``key``: ``sqrt(2) * erfinv(u)`` of the uniforms above."""
    u = torch.from_numpy(uniform_open(key, shape)).to(device)
    return erfinv(u) * np.float32(np.sqrt(2.0))


def sample_keys(seeds, idx: Optional[Sequence[int]] = None) -> np.ndarray:
    """Per-sample keys [B, 2] from per-sample 64-bit seeds:
    ``fold_in(fold_in(key(lo), hi), idx)``.  The high seed word is folded
    in on its own, so seeds that differ by 2^32 stay distinct; ``idx``
    (default: the batch position) keeps rows that share a seed apart."""
    s = np.atleast_1d(np.asarray(seeds, dtype=np.uint64))
    lo = (s & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    hi = (s >> np.uint64(32)).astype(np.uint32)
    if idx is None:
        idx = np.arange(s.shape[0], dtype=np.uint32)
    idx = np.asarray(idx).astype(np.uint32)
    return np.stack([
        fold_in(fold_in(key_from_seed(int(l)), int(h)), int(i))
        for l, h, i in zip(lo, hi, idx)])


def batch_normal(keys: np.ndarray, index: int, sample_shape: Sequence[int],
                 device: torch.device | str = "cpu") -> torch.Tensor:
    """[B, *sample_shape] noise, row b drawn from
    ``fold_in(keys[b], index)``."""
    return torch.stack([normal(fold_in(k, index), sample_shape, device)
                        for k in keys])
