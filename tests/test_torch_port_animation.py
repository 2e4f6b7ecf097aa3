"""The port's encoders built where the JAX package calls Pillow:
SaveAnimatedPNG (``utils/image.py:encode_apng``), SaveAnimatedWEBP
(``utils/webp.py``) and ImageQuantize (``utils/quantize.py``), on the
CPU.

Pillow (here only) reads the port's file and the JAX op's file of the
same frames, two equal frames in a row among them: both give the same
frame count, durations, loop and text chunks, and the frames of an APNG
or a lossless WEBP are equal to the bit.  A lossy WEBP at quality 80
and 50 keeps each frame's PSNR within 3 dB of the JAX file's, at most
twice its size.  ImageQuantize is held to its properties (an image of
few colours unchanged, at most ``colors`` palette entries, the nearest
entry without dither) and to Pillow's mean absolute error.
"""

import io

import numpy as np
import pytest
import torch
from PIL import Image

from comfyui_distributed_tpu.ops.base import OpContext as JaxOpContext
from comfyui_distributed_tpu.ops.base import get_op as jax_get_op
# the executors' packages import every op module: both registries full
from comfyui_distributed_tpu.workflow import WorkflowExecutor  # noqa: F401
from comfyui_distributed_tpu_torch import workflow as _tworkflow  # noqa: F401
from comfyui_distributed_tpu_torch.ops.base import (DeviceImage, OpContext,
                                                    get_op)
from comfyui_distributed_tpu_torch.utils import quantize
from comfyui_distributed_tpu_torch.utils import webp as webp_mod
from comfyui_distributed_tpu_torch.utils.image import read_png, to_uint8
from comfyui_distributed_tpu_torch.utils.webp import webp_frames

PROMPT = {"1": {"class_type": "EmptyImage", "inputs": {"width": 8}}}
EXTRA = {"workflow": {"nodes": [], "links": []}}


def _frames(n=3, h=37, w=45, seed=0):
    """Smooth frames with a little noise, each different."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w] / max(h, w)
    out = []
    for i in range(n):
        base = np.stack([0.5 + 0.4 * np.sin(6 * xx + i),
                         yy * 0.8 + 0.1 * i,
                         0.5 + 0.3 * np.cos(4 * (xx + yy))], -1)
        out.append(base + rng.normal(0, 0.02, base.shape))
    return np.clip(np.stack(out), 0, 1).astype(np.float32)


def _save(op, frames, tmp_path, ext, **widgets):
    """The port's and the JAX op's file of ``frames``."""
    tdir, jdir = tmp_path / "torch", tmp_path / "jax"
    tctx = OpContext(device="cpu", output_dir=str(tdir))
    jctx = JaxOpContext(output_dir=str(jdir))
    for ctx in (tctx, jctx):
        ctx.prompt_json, ctx.extra_pnginfo = PROMPT, EXTRA
    get_op(op).execute(tctx, DeviceImage(torch.from_numpy(frames)),
                       **widgets)
    jax_get_op(op).execute(jctx, frames, **widgets)
    rel = f"anim/save_00000.{ext}"
    return (tdir / rel).read_bytes(), (jdir / rel).read_bytes()


def _read(data):
    """Pillow's reading: (frames, durations, loop, text)."""
    im = Image.open(io.BytesIO(data))
    frames, durations = [], []
    for i in range(getattr(im, "n_frames", 1)):
        im.seek(i)
        im.load()
        frames.append(np.asarray(im.convert("RGB")))
        durations.append(im.info.get("duration"))
    return frames, durations, im.info.get("loop"), dict(
        getattr(im, "text", {}))


def _psnr(a, b):
    return 10 * np.log10(255.0 ** 2 / np.mean(
        (a.astype(np.float64) - b.astype(np.float64)) ** 2))


# which source frames each case's batch holds: two equal in a row, all
# equal (a still file), one frame
SEQUENCES = {"repeat": [0, 1, 1, 2], "all-equal": [0, 0, 0], "one": [2]}


@pytest.mark.parametrize("seq", SEQUENCES, ids=list(SEQUENCES))
@pytest.mark.parametrize("op,ext,widgets", [
    ("SaveAnimatedPNG", "png", {"fps": 6.0, "compress_level": 4}),
    ("SaveAnimatedWEBP", "webp", {"fps": 8.0}),
    ("SaveAnimatedWEBP", "webp", {"fps": 3.0, "method": "fastest"})],
    ids=["apng", "webp-lossless", "webp-lossless-fastest"])
def test_animation_reads_as_the_jax_file(tmp_path, op, ext, widgets, seq):
    frames = _frames()[SEQUENCES[seq]]
    ours, theirs = _save(op, frames, tmp_path, ext, **widgets)
    got, want = _read(ours), _read(theirs)
    assert got[1:] == want[1:]          # durations, loop, text chunks
    assert len(got[0]) == len(want[0])
    for a, b in zip(got[0], want[0]):
        np.testing.assert_array_equal(a, b)
    if ext == "webp":
        n, durations, loop = webp_frames(ours)
        assert (n, durations, loop) == (len(got[0]), got[1], want[2])
    else:
        # the port's own reader takes the default image
        np.testing.assert_array_equal(read_png(ours).pixels,
                                      to_uint8(frames[0]))


@pytest.mark.parametrize("quality", [80, 50])
def test_lossy_webp_within_3db_and_twice_the_size(tmp_path, quality):
    frames = _frames(h=64, w=80)[[0, 1, 1, 2]]
    ours, theirs = _save("SaveAnimatedWEBP", frames, tmp_path, "webp",
                         lossless=False, quality=quality)
    got, want = _read(ours), _read(theirs)
    assert got[1:] == want[1:] and len(got[0]) == len(want[0]) == 3
    src = to_uint8(frames[[0, 1, 3]])
    for a, b, s in zip(got[0], want[0], src):
        assert abs(_psnr(a, s) - _psnr(b, s)) <= 3.0
    assert len(ours) <= 2 * len(theirs)


def test_webp_refuses_what_it_does_not_take(tmp_path):
    with pytest.raises(ValueError, match="quality"):
        _save("SaveAnimatedWEBP", _frames(1), tmp_path, "webp",
              lossless=False, quality=101)



def _bool_decode(data, probs):
    """RFC 6386's boolean decoder (7.3): one bit a probability."""
    data = bytes(data) + b"\0" * 4
    value, pos, rng, count = (data[0] << 8) | data[1], 2, 255, 0
    out = []
    for prob in probs:
        split = 1 + (((rng - 1) * prob) >> 8)
        if value >= split << 8:
            out.append(1)
            rng -= split
            value -= split << 8
        else:
            out.append(0)
            rng = split
        while rng < 128:
            value <<= 1
            rng <<= 1
            count += 1
            if count == 8:
                count = 0
                value |= data[pos] if pos < len(data) else 0
                pos += 1
    return out


@pytest.mark.parametrize("n", [0, 1, 700, 50000])
def test_the_boolean_coder_decodes_back(n):
    # long runs at the extreme probabilities and mixed stretches, enough
    # decisions for the ranges to run in many chunks at once
    rng = np.random.default_rng(n)
    probs = rng.integers(1, 256, n)
    probs[: n // 4] = 255
    probs[n // 4: n // 3] = 1
    bits = (rng.integers(0, 256, n) >= probs).astype(np.int64)
    bits[n // 2: n // 2 + n // 10] = 1
    data = webp_mod._bool_encode(bits, probs)
    assert _bool_decode(data, probs.tolist()) == bits.tolist()

# --- ImageQuantize -----------------------------------------------------------

def _quantize_both(img, **widgets):
    (t,) = get_op("ImageQuantize").execute(
        OpContext(device="cpu"), DeviceImage(torch.from_numpy(img)),
        **widgets)
    (j,) = jax_get_op("ImageQuantize").execute(JaxOpContext(), img,
                                               **widgets)
    return t.to_host(), np.asarray(j)


def _test_images():
    rng = np.random.default_rng(1)
    yy, xx = np.mgrid[0:48, 0:64]
    grad = np.stack([xx / 63, yy / 47, (xx + yy) / 110], -1)
    noise = rng.random((48, 64, 3))
    return {"gradient": grad[None].astype(np.float32),
            "noise": noise[None].astype(np.float32)}


def test_few_colours_come_back_unchanged():
    # values whose x * 255 truncates back to themselves
    levels = np.array([0, 51, 102, 153, 204, 255]) / np.float32(255)
    rng = np.random.default_rng(2)
    img = levels[rng.integers(0, 6, (2, 20, 24, 3))].astype(np.float32)
    assert ((img * 255).astype(np.uint8) / np.float32(255) == img).all()
    distinct = len(np.unique(img.reshape(-1, 3), axis=0))
    for dither in ("none", "floyd-steinberg"):
        got, want = _quantize_both(img, colors=distinct, dither=dither)
        np.testing.assert_array_equal(got, img)
        np.testing.assert_array_equal(want, img)


@pytest.mark.parametrize("name", ["gradient", "noise"])
@pytest.mark.parametrize("colors", [5, 32])
@pytest.mark.parametrize("dither", ["none", "floyd-steinberg"])
def test_palette_properties_and_pillows_error(name, colors, dither):
    img = _test_images()[name]
    got, want = _quantize_both(img, colors=colors, dither=dither)
    px = np.rint(got[0] * 255).astype(np.int64).reshape(-1, 3)
    pal = np.unique(px, axis=0)
    assert len(pal) <= colors
    np.testing.assert_array_equal(px.astype(np.float32) / np.float32(255),
                                  got[0].reshape(-1, 3))
    src8 = (np.clip(img[0], 0, 1) * 255).astype(np.int64).reshape(-1, 3)
    if dither == "none":
        d = ((src8[:, None] - pal[None]) ** 2).sum(-1)
        mine = ((src8 - px) ** 2).sum(-1)
        assert (mine == d.min(1)).all()
    ours = np.abs(got - img).mean()
    pillow = np.abs(want - img).mean()
    assert ours <= 1.25 * pillow + 0.5 / 255, (ours, pillow)


def test_dither_changes_the_result_and_nearest_is_exact():
    img = _test_images()["gradient"]
    (plain,) = get_op("ImageQuantize").execute(
        OpContext(device="cpu"), DeviceImage(torch.from_numpy(img)),
        colors=4, dither="none")
    (dith,) = get_op("ImageQuantize").execute(
        OpContext(device="cpu"), DeviceImage(torch.from_numpy(img)),
        colors=4, dither="floyd-steinberg")
    assert not np.array_equal(plain.to_host(), dith.to_host())
    # the dither's lookup and the device map pick the brute-force
    # nearest entry, the lower index on a tie
    rng = np.random.default_rng(5)
    pal = rng.integers(0, 256, (40, 3))
    pal[7] = pal[3]
    cols = rng.integers(0, 256, (4000, 3))
    want = np.argmin(((cols[:, None] - pal[None]) ** 2).sum(-1), 1)
    got = quantize.nearest_entries(torch.from_numpy(cols),
                                   torch.from_numpy(pal)).numpy()
    np.testing.assert_array_equal(got, want)
    dithered = quantize.floyd_steinberg(
        cols.reshape(40, 100, 3).astype(np.uint8), pal)
    assert dithered.max() < 40 and 7 not in dithered


def _raster_floyd_steinberg(img, pal):
    """Floyd-Steinberg one pixel at a time in raster order: errors in
    1/16ths truncated toward zero, each pixel clipped before its
    brute-force nearest entry (the lower index on a tie)."""
    h, w, _ = img.shape
    pal = pal.astype(np.int64)
    acc = np.zeros((h + 1, w + 2, 3), np.int64)
    out = np.zeros((h, w), np.int64)
    for y in range(h):
        for x in range(w):
            a = acc[y, x + 1]
            v = np.clip(img[y, x].astype(np.int64)
                        + np.sign(a) * (np.abs(a) // 16), 0, 255)
            i = int(np.argmin(((pal - v) ** 2).sum(1)))
            out[y, x] = i
            e = v - pal[i]
            acc[y, x + 2] += 7 * e
            acc[y + 1, x] += 3 * e
            acc[y + 1, x + 1] += 5 * e
            acc[y + 1, x + 2] += e
    return out


@pytest.mark.parametrize("shape", [(1, 1), (1, 9), (8, 1), (2, 3),
                                   (13, 17)])
def test_the_diagonal_dither_is_raster_floyd_steinberg(shape):
    rng = np.random.default_rng(sum(shape))
    img = rng.integers(0, 256, shape + (3,)).astype(np.uint8)
    pal = rng.integers(0, 256, (9, 3))
    pal[5] = pal[2]
    np.testing.assert_array_equal(quantize.floyd_steinberg(img, pal),
                                  _raster_floyd_steinberg(img, pal))
