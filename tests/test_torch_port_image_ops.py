"""The port's latent, image, mask and conditioning ops and its PNG reader
against the JAX package, on the CPU.

Each of the 46 ops the port gained with its inpaint and compositing
slice (15 latent, 15 image, 11 mask, 3 conditioning and the two tiled
VAE ops) runs once on both sides with the same numpy inputs, made from a
seed, and no sampler.  An op that copies or slices is held to the bit;
any other within 1e-6 (``ARITH``), which leaves room for a different
summation order of a norm or a resize, not for a different formula.
Every PNG kind (bit depths 1 to 16, grey, RGB, palette with and without
tRNS, grey-alpha and RGBA, with and without Adam7) is read to the bit as
the JAX package's LoadImage and LoadImageMask read it through Pillow.
The schema test holds every op the port registers to the JAX package's
``WIDGETS``, ``DEFAULTS`` and ``HIDDEN``.
"""

import dataclasses
import io
import struct
import warnings
import zlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from comfyui_distributed_tpu.models import registry as jreg
from comfyui_distributed_tpu.ops import basic as jbasic
from comfyui_distributed_tpu.ops.base import Conditioning as JaxCond
from comfyui_distributed_tpu.ops.base import NODE_CLASS_MAPPINGS as JAX_OPS
from comfyui_distributed_tpu.ops.base import OpContext as JaxOpContext
from comfyui_distributed_tpu.ops.base import get_op as jax_get_op
# the executors' packages import every op module: both registries full
from comfyui_distributed_tpu.workflow import WorkflowExecutor  # noqa: F401
from comfyui_distributed_tpu_torch import workflow as _tworkflow  # noqa: F401
from comfyui_distributed_tpu_torch.models import registry as treg
from comfyui_distributed_tpu_torch.ops.base import NODE_CLASS_MAPPINGS
from comfyui_distributed_tpu_torch.ops.base import (
    Conditioning,
    DeviceImage,
    DeviceLatent,
    OpContext,
    get_op,
)
from comfyui_distributed_tpu_torch.utils.image import (
    decode_png,
    decode_png_rgba,
    read_png,
)

EXACT = dict(rtol=0, atol=0)
ARITH = dict(rtol=0, atol=1e-6)

# ROADMAP.md A.5: the ops the port leaves to a later slice
UNPORTED = {"ModelMergeSimple", "ModelMergeAdd", "ModelMergeSubtract",
            "ModelMergeBlocks", "CLIPMergeSimple", "CLIPMergeAdd",
            "CLIPMergeSubtract", "ModelSave", "CLIPSave", "VAESave",
            "SaveLatent", "LoadLatent", "SaveAnimatedPNG",
            "SaveAnimatedWEBP", "ImageQuantize"}


def _np(x):
    if hasattr(x, "to_host"):
        return x.to_host()
    if isinstance(x, torch.Tensor):
        return x.detach().float().cpu().numpy()
    return np.asarray(x, np.float32)


# --- the inputs, one numpy value a slot, handed to both sides ------------------

class Img(np.ndarray):
    """An IMAGE input [B, H, W, C]."""


class Mask(np.ndarray):
    """A MASK input [B, H, W] or [H, W]."""


def _img(rng, b, h, w, c=3):
    return rng.random((b, h, w, c), dtype=np.float32).view(Img)


def _mask(rng, *shape):
    return rng.random(shape, dtype=np.float32).view(Mask)


def _binary(rng, *shape):
    return (rng.random(shape) > 0.5).astype(np.float32).view(Mask)


def _lat(rng, b, h, w, **meta):
    return {"samples": rng.standard_normal((b, h, w, 4)).astype(np.float32),
            **meta}


def _to_torch(v):
    if isinstance(v, Img):
        return DeviceImage(torch.from_numpy(np.array(v)))
    if isinstance(v, Mask):
        return torch.from_numpy(np.array(v))
    if isinstance(v, dict):
        return {k: DeviceLatent(torch.from_numpy(x)) if k == "samples"
                else _to_torch(x) for k, x in v.items()}
    return v


def _to_jax(v):
    if isinstance(v, (Img, Mask)):
        return np.array(v)
    if isinstance(v, dict):
        return {k: _to_jax(x) for k, x in v.items()}
    return v


def _cases():
    """(op, widgets, inputs builder, tolerance) for each case."""
    r = np.random.default_rng
    return [
        # latent
        ("LatentAdd", {}, lambda: dict(samples1=_lat(r(1), 2, 6, 5),
                                       samples2=_lat(r(2), 1, 6, 5)), ARITH),
        ("LatentSubtract", {}, lambda: dict(
            samples1=_lat(r(3), 2, 6, 5, local_batch=2),
            samples2=_lat(r(4), 2, 4, 3)), ARITH),
        ("LatentMultiply", {"multiplier": 0.37}, lambda: dict(
            samples=_lat(r(5), 2, 6, 5, noise_mask=_mask(r(6), 1, 48, 40))),
         ARITH),
        ("LatentInterpolate", {"ratio": 0.3}, lambda: dict(
            samples1=_lat(r(7), 2, 6, 5), samples2=_lat(r(8), 2, 6, 5)),
         ARITH),
        ("LatentBlend", {"blend_factor": 0.25}, lambda: dict(
            samples1=_lat(r(9), 2, 6, 5), samples2=_lat(r(10), 1, 3, 4)),
         ARITH),
        ("LatentComposite", {"x": 16, "y": 8, "feather": 16}, lambda: dict(
            samples_to=_lat(r(11), 2, 8, 9), samples_from=_lat(r(12), 1, 4,
                                                               5)), ARITH),
        ("LatentCompositeMasked", {"x": 8, "y": 16, "resize_source": False},
         lambda: dict(destination=_lat(r(13), 2, 8, 9),
                      source=_lat(r(14), 2, 5, 4),
                      mask=_mask(r(15), 1, 7, 3)), ARITH),
        ("LatentCrop", {"width": 24, "height": 32, "x": 16, "y": 8},
         lambda: dict(samples=_lat(r(16), 2, 8, 9)), EXACT),
        ("LatentFlip", {"flip_method": "y-axis: horizontally"},
         lambda: dict(samples=_lat(r(17), 2, 6, 5)), EXACT),
        ("LatentRotate", {"rotation": "90 degrees"},
         lambda: dict(samples=_lat(r(18), 2, 6, 5, local_batch=2)), EXACT),
        ("LatentBatch", {}, lambda: dict(samples1=_lat(r(19), 2, 6, 5),
                                         samples2=_lat(r(20), 1, 6, 5)),
         EXACT),
        ("LatentFromBatch", {"batch_index": 1, "length": 2}, lambda: dict(
            samples=_lat(r(21), 4, 6, 5, noise_mask=_mask(r(22), 3, 48, 40))),
         EXACT),
        ("LatentBatchSeedBehavior", {"seed_behavior": "fixed"},
         lambda: dict(samples=_lat(r(23), 2, 6, 5, local_batch=2)), EXACT),
        ("RepeatLatentBatch", {"amount": 3},
         lambda: dict(samples=_lat(r(24), 2, 6, 5, local_batch=2)), EXACT),
        ("RebatchLatents", {"batch_size": 1},
         lambda: dict(latents=_lat(r(25), 2, 6, 5)), EXACT),
        # mask
        ("SolidMask", {"value": 0.3, "width": 9, "height": 7}, dict, EXACT),
        ("InvertMask", {}, lambda: dict(mask=_mask(r(26), 2, 7, 9)), EXACT),
        ("GrowMask", {"expand": 2, "tapered_corners": True},
         lambda: dict(mask=_binary(r(27), 2, 9, 11)), EXACT),
        ("MaskComposite", {"x": 3, "y": -2, "operation": "xor"},
         lambda: dict(destination=_mask(r(28), 2, 9, 11),
                      source=_mask(r(29), 1, 6, 5)), EXACT),
        ("MaskToImage", {}, lambda: dict(mask=_mask(r(30), 7, 9)), EXACT),
        ("ImageToMask", {"channel": "green"},
         lambda: dict(image=_img(r(31), 2, 7, 9)), EXACT),
        ("ImageColorToMask", {"color": 0x336699}, lambda: dict(
            image=np.where(r(32).random((2, 7, 9, 1)) > 0.5,
                           np.float32([0x33, 0x66, 0x99]) / 255.0,
                           r(33).random((2, 7, 9, 3))).astype(
                np.float32).view(Img)), EXACT),
        ("CropMask", {"x": 2, "y": 3, "width": 5, "height": 9},
         lambda: dict(mask=_mask(r(34), 2, 9, 11)), EXACT),
        ("FeatherMask", {"left": 3, "top": 2, "right": 4, "bottom": 5},
         lambda: dict(mask=_mask(r(35), 2, 9, 11)), EXACT),
        ("ThresholdMask", {"value": 0.4},
         lambda: dict(mask=_mask(r(36), 2, 9, 11)), EXACT),
        ("Morphology", {"operation": "top_hat", "kernel_size": 4},
         lambda: dict(image=_img(r(37), 2, 9, 11)), EXACT),
        # image
        ("EmptyImage", {"width": 9, "height": 7, "batch_size": 2,
                        "color": 0xFF8001}, dict, EXACT),
        ("ImageBatch", {}, lambda: dict(image1=_img(r(38), 2, 7, 9),
                                        image2=_img(r(39), 1, 5, 6)), ARITH),
        ("ImageFromBatch", {"batch_index": 1, "length": 2},
         lambda: dict(image=_img(r(40), 3, 7, 9)), EXACT),
        ("RebatchImages", {"batch_size": 2},
         lambda: dict(images=_img(r(41), 3, 7, 9)), EXACT),
        ("ImageCrop", {"width": 5, "height": 4, "x": 6, "y": 1},
         lambda: dict(image=_img(r(42), 2, 7, 9)), EXACT),
        ("ImageInvert", {}, lambda: dict(image=_img(r(43), 2, 7, 9)), EXACT),
        ("ImageBlend", {"blend_factor": 0.6, "blend_mode": "soft_light"},
         lambda: dict(image1=_img(r(44), 2, 7, 9),
                      image2=_img(r(45), 1, 5, 6)), ARITH),
        ("ImageBlur", {"blur_radius": 3, "sigma": 1.5},
         lambda: dict(image=_img(r(46), 2, 7, 9)), ARITH),
        ("ImageSharpen", {"sharpen_radius": 2, "sigma": 0.8, "alpha": 1.5},
         lambda: dict(image=_img(r(47), 2, 7, 9)), ARITH),
        ("ImageCompositeMasked", {"x": 3, "y": -1, "resize_source": False},
         lambda: dict(destination=_img(r(48), 2, 9, 11),
                      source=_img(r(49), 1, 5, 6),
                      mask=_mask(r(50), 1, 10, 12)), ARITH),
        ("PorterDuffImageComposite", {"mode": "overlay"},
         lambda: dict(source=_img(r(51), 2, 7, 9),
                      source_alpha=_mask(r(52), 1, 7, 9),
                      destination=_img(r(53), 1, 5, 6),
                      destination_alpha=_mask(r(54), 2, 5, 6)), ARITH),
        ("SplitImageWithAlpha", {}, lambda: dict(image=_img(r(55), 2, 7, 9,
                                                            4)), EXACT),
        ("JoinImageWithAlpha", {}, lambda: dict(image=_img(r(56), 2, 7, 9),
                                                alpha=_mask(r(57), 1, 5, 6)),
         ARITH),
        ("ImageScaleBy", {"upscale_method": "bicubic", "scale_by": 1.7},
         lambda: dict(image=_img(r(58), 2, 7, 9)), ARITH),
        ("ImageScaleToTotalPixels", {"upscale_method": "lanczos",
                                     "megapixels": 0.0001},
         lambda: dict(image=_img(r(59), 1, 7, 9)), ARITH),
    ]


CASES = _cases()


@pytest.mark.parametrize("op,widgets,make,tol", CASES,
                         ids=[c[0] for c in CASES])
def test_op_matches_jax(op, widgets, make, tol):
    inputs = make()
    want = jax_get_op(op).execute(JaxOpContext(), **widgets,
                                  **{k: _to_jax(v) for k, v in
                                     inputs.items()})
    got = get_op(op).execute(OpContext(device="cpu"), **widgets,
                             **{k: _to_torch(v) for k, v in inputs.items()})
    assert len(got) == len(want)
    for g, w in zip(got, want):
        if isinstance(w, dict):
            assert set(g) == set(w), op
            for k in w:
                if k in ("local_batch", "fanout", "seed_fixed_batch"):
                    assert g[k] == w[k], k
                    continue
                np.testing.assert_allclose(_np(g[k]), np.asarray(w[k]),
                                           err_msg=f"{op} {k}", **tol)
            continue
        gw = _np(g)
        assert gw.shape == np.asarray(w).shape, op
        np.testing.assert_allclose(gw, np.asarray(w, np.float32),
                                   err_msg=op, **tol)


def test_the_cases_cover_the_41_ops():
    """The 41 latent, image and mask ops above are one case each."""
    assert len({c[0] for c in CASES}) == 41


@pytest.mark.parametrize("operation", ["erode", "dilate", "open", "close",
                                       "gradient", "top_hat", "bottom_hat"])
@pytest.mark.parametrize("size", [1, 2, 5, 14])
def test_morphology_matches_scipy(operation, size):
    """scipy.ndimage's reflect border and its even-size origin shift;
    size 14 is wider than the 9 x 11 image."""
    img = _img(np.random.default_rng(size), 1, 9, 11)
    want = jax_get_op("Morphology").execute(JaxOpContext(), np.array(img),
                                            operation, size)[0]
    got = get_op("Morphology").execute(OpContext(device="cpu"),
                                       _to_torch(img), operation, size)[0]
    np.testing.assert_array_equal(_np(got), want)


@pytest.mark.parametrize("mode", ["ADD", "CLEAR", "DARKEN", "DST", "DST_ATOP",
                                  "DST_IN", "DST_OUT", "DST_OVER", "LIGHTEN",
                                  "MULTIPLY", "SCREEN", "SRC", "SRC_ATOP",
                                  "SRC_IN", "SRC_OUT", "SRC_OVER", "XOR"])
def test_porter_duff_modes_match_jax(mode):
    rng = np.random.default_rng(3)
    ins = dict(source=_img(rng, 1, 4, 5), source_alpha=_mask(rng, 1, 4, 5),
               destination=_img(rng, 1, 4, 5),
               destination_alpha=_mask(rng, 1, 4, 5))
    want = jax_get_op("PorterDuffImageComposite").execute(
        JaxOpContext(), mode=mode, **{k: _to_jax(v) for k, v in ins.items()})
    got = get_op("PorterDuffImageComposite").execute(
        OpContext(device="cpu"), mode=mode,
        **{k: _to_torch(v) for k, v in ins.items()})
    for g, w in zip(got, want):
        np.testing.assert_allclose(_np(g), w, **ARITH)


@pytest.mark.parametrize("mode", ["normal", "multiply", "screen", "overlay",
                                  "difference"])
def test_image_blend_modes_match_jax(mode):
    rng = np.random.default_rng(4)
    a, b = _img(rng, 2, 5, 6), _img(rng, 2, 5, 6)
    want = jax_get_op("ImageBlend").execute(JaxOpContext(), np.array(a),
                                            np.array(b), 0.7, mode)[0]
    got = get_op("ImageBlend").execute(OpContext(device="cpu"), _to_torch(a),
                                       _to_torch(b), 0.7, mode)[0]
    np.testing.assert_allclose(_np(got), want, **ARITH)


@pytest.mark.parametrize("operation", ["multiply", "add", "subtract", "and",
                                       "or"])
def test_mask_composite_operations_match_jax(operation):
    rng = np.random.default_rng(5)
    d, s = _mask(rng, 2, 6, 7), _mask(rng, 2, 4, 4)
    want = jax_get_op("MaskComposite").execute(JaxOpContext(), np.array(d),
                                               np.array(s), 4, 3,
                                               operation)[0]
    got = get_op("MaskComposite").execute(OpContext(device="cpu"),
                                          _to_torch(d), _to_torch(s), 4, 3,
                                          operation)[0]
    np.testing.assert_array_equal(_np(got), want)


@pytest.mark.parametrize("expand,tapered", [(-2, True), (3, False)])
def test_grow_mask_shrinks_and_grows_as_jax(expand, tapered):
    m = _binary(np.random.default_rng(6), 1, 12, 10)
    want = jax_get_op("GrowMask").execute(JaxOpContext(), np.array(m),
                                          expand, tapered)[0]
    got = get_op("GrowMask").execute(OpContext(device="cpu"), _to_torch(m),
                                     expand, tapered)[0]
    np.testing.assert_array_equal(_np(got), want)


def test_image_blur_radius_past_the_image_reflects_as_numpy():
    """numpy's reflect pads a radius longer than the image by bouncing
    between the edges; the port's index does the same."""
    img = _img(np.random.default_rng(7), 1, 3, 4)
    want = jax_get_op("ImageBlur").execute(JaxOpContext(), np.array(img), 6,
                                           2.0)[0]
    got = get_op("ImageBlur").execute(OpContext(device="cpu"),
                                      _to_torch(img), 6, 2.0)[0]
    np.testing.assert_allclose(_np(got), want, **ARITH)


# --- conditioning ----------------------------------------------------------------

def _cond_pair(seed, tokens, pooled=True, siblings=0, control=None):
    rng = np.random.default_rng(seed)

    def one(i):
        c = rng.standard_normal((1, tokens, 8)).astype(np.float32)
        p = rng.standard_normal((1, 5)).astype(np.float32) if pooled \
            else None
        return (JaxCond(context=jnp.asarray(c), pooled=None if p is None
                        else jnp.asarray(p), size_cond=(64, 64, 0, 0, 64, 64),
                        control=control),
                Conditioning(context=torch.from_numpy(c),
                             pooled=None if p is None
                             else torch.from_numpy(p),
                             size_cond=(64, 64, 0, 0, 64, 64),
                             control=control))

    entries = [one(i) for i in range(1 + siblings)]
    j = dataclasses.replace(entries[0][0],
                            siblings=tuple(e[0] for e in entries[1:]))
    t = dataclasses.replace(entries[0][1],
                            siblings=tuple(e[1] for e in entries[1:]))
    return j, t


def _check_cond(got: Conditioning, want: JaxCond, **tol):
    for g, w in zip((got,) + got.siblings, (want,) + want.siblings):
        np.testing.assert_allclose(_np(g.context), np.asarray(w.context),
                                   **tol)
        assert (g.pooled is None) == (w.pooled is None)
        if w.pooled is not None:
            np.testing.assert_allclose(_np(g.pooled), np.asarray(w.pooled),
                                       **tol)
        assert g.size_cond == w.size_cond
        assert g.control == w.control
    assert len(got.siblings) == len(want.siblings)


@pytest.mark.parametrize("op,widgets,to_args,from_args", [
    ("ConditioningConcat", {}, (1, 77, True, 1), (2, 77, True, 1)),
    ("ConditioningAverage", {"conditioning_to_strength": 0.35},
     (3, 77, False, 1, "ctl"), (4, 154, True, 0)),
    ("ConditioningAverage", {"conditioning_to_strength": 0.6},
     (5, 154, True, 0), (6, 77, True, 0)),
])
def test_conditioning_combinators_match_jax(op, widgets, to_args, from_args):
    """Every entry of ``conditioning_to`` takes the primary entry of
    ``conditioning_from``; the average zero-pads or cuts ``from`` and
    takes a missing pooled embedding from it."""
    jt, tt = _cond_pair(*to_args)
    jf, tf = _cond_pair(*from_args)
    want = jax_get_op(op).execute(JaxOpContext(), jt, jf, **widgets)[0]
    got = get_op(op).execute(OpContext(device="cpu"), tt, tf, **widgets)[0]
    _check_cond(got, want, **(EXACT if op == "ConditioningConcat"
                              else ARITH))


def test_conditioning_zero_out_matches_jax():
    jc, tc = _cond_pair(7, 77, True, 2)
    want = jax_get_op("ConditioningZeroOut").execute(JaxOpContext(), jc)[0]
    got = get_op("ConditioningZeroOut").execute(OpContext(device="cpu"),
                                                tc)[0]
    _check_cond(got, want, **EXACT)


def test_concat_aligns_the_other_side_to_154_tokens():
    """A concat gives 154 tokens; the sampler repeats the 77-token side
    to 154, as the JAX package's KSampler does."""
    _, t77 = _cond_pair(8, 77)
    cat = get_op("ConditioningConcat").execute(OpContext(device="cpu"), t77,
                                               t77)[0]
    from comfyui_distributed_tpu_torch.ops import basic as tbasic
    assert tbasic.cond_token_align([cat, t77]) == \
        jbasic.cond_token_align([_cond_pair(8, 154)[0],
                                 _cond_pair(8, 77)[0]]) == 154
    out = tbasic.align_cond_tokens(t77.context, 154)
    np.testing.assert_array_equal(_np(out), np.concatenate(
        [_np(t77.context)] * 2, axis=1))


# --- the tiled VAE ops, one call each -------------------------------------------

@pytest.fixture
def tiny(monkeypatch):
    monkeypatch.setenv("DTPU_DEFAULT_FAMILY", "tiny")
    jreg.clear_pipeline_cache()
    treg.clear_pipeline_cache()
    yield (jreg.load_pipeline("tiny-tiles.ckpt"),
           treg.load_pipeline("tiny-tiles.ckpt", device="cpu"))
    jreg.clear_pipeline_cache()
    treg.clear_pipeline_cache()


def test_vae_decode_tiled_op_matches_jax(tiny):
    jp, tp = tiny
    lat = np.random.default_rng(9).standard_normal((2, 20, 18, 4)).astype(
        np.float32)
    want = jax_get_op("VAEDecodeTiled").execute(
        JaxOpContext(), {"samples": lat}, jp, 16, 4)[0]
    got = get_op("VAEDecodeTiled").execute(
        OpContext(device="cpu"), {"samples": DeviceLatent(
            torch.from_numpy(lat))}, tp, 16, 4)[0]
    np.testing.assert_allclose(_np(got), np.asarray(want.data if hasattr(
        want, "data") else want), rtol=2e-4, atol=2e-4)


def test_vae_encode_tiled_op_matches_jax(tiny):
    jp, tp = tiny
    img = _img(np.random.default_rng(10), 1, 40, 36)
    want = jax_get_op("VAEEncodeTiled").execute(JaxOpContext(),
                                                np.array(img), jp, 16, 4)[0]
    got = get_op("VAEEncodeTiled").execute(OpContext(device="cpu"),
                                           _to_torch(img), tp, 16, 4)[0]
    np.testing.assert_allclose(_np(got["samples"]),
                               np.asarray(want["samples"]), rtol=2e-4,
                               atol=2e-4)


# --- the schemas -------------------------------------------------------------------

PORTED = sorted(NODE_CLASS_MAPPINGS)


@pytest.mark.parametrize("op", PORTED)
def test_schema_equals_the_jax_packages(op):
    t, j = NODE_CLASS_MAPPINGS[op], JAX_OPS[op]
    assert (t.WIDGETS, t.DEFAULTS, t.HIDDEN) == \
        (j.WIDGETS, j.DEFAULTS, j.HIDDEN)


def test_the_unported_ops_are_exactly_a5():
    assert set(JAX_OPS) - set(NODE_CLASS_MAPPINGS) == UNPORTED
    assert set(NODE_CLASS_MAPPINGS) <= set(JAX_OPS)
    assert len(NODE_CLASS_MAPPINGS) == 130


# --- every PNG kind -------------------------------------------------------------

_ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4),
          (0, 2, 2, 4), (1, 0, 2, 2), (0, 1, 1, 2))
_SAMPLES = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}


def _rows(s: np.ndarray, depth: int) -> bytes:
    """Filter-0 scanlines of integer samples [h, w, c] at ``depth``."""
    out = bytearray()
    for row in s.reshape(s.shape[0], -1).astype(np.int64):
        if depth == 16:
            b = np.stack([row >> 8, row & 0xFF], -1).reshape(-1)
        elif depth == 8:
            b = row
        else:
            per = 8 // depth
            r = np.concatenate([row, np.zeros((-len(row)) % per,
                                              np.int64)]).reshape(-1, per)
            b = (r << (np.arange(per - 1, -1, -1) * depth)).sum(1)
        out += bytes([0]) + bytes(b.astype(np.uint8).tolist())
    return bytes(out)


def png_bytes(samples, depth, ctype, plte=None, trns=None, interlace=False):
    """A PNG of any kind, written by hand: Pillow writes neither Adam7
    nor 16-bit colour."""
    s = np.asarray(samples)
    if s.ndim == 2:
        s = s[..., None]
    h, w, _ = s.shape
    raw = b"".join(_rows(s[y0::dy, x0::dx], depth)
                   for x0, y0, dx, dy in _ADAM7
                   if s[y0::dy, x0::dx].size) if interlace \
        else _rows(s, depth)

    def chunk(tag, data):
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))

    body = chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, ctype, 0, 0,
                                      int(interlace)))
    if plte is not None:
        body += chunk(b"PLTE", np.asarray(plte, np.uint8).tobytes())
    if trns is not None:
        body += chunk(b"tRNS", trns)
    return (b"\x89PNG\r\n\x1a\n" + body + chunk(b"IDAT", zlib.compress(raw))
            + chunk(b"IEND", b""))


def _kind_cases():
    out = []
    for ctype, depths in ((0, (1, 2, 4, 8, 16)), (2, (8, 16)),
                          (3, (1, 2, 4, 8)), (4, (8, 16)), (6, (8, 16))):
        for depth in depths:
            trns_kinds = (False, True) if ctype in (0, 2, 3) else (False,)
            for trns in trns_kinds:
                for interlace in (False, True):
                    out.append((ctype, depth, trns, interlace))
    return out


def _kind_png(ctype, depth, trns, interlace, seed):
    rng = np.random.default_rng(seed)
    s = rng.integers(0, 1 << depth, (13, 11, _SAMPLES[ctype]))
    plte = t = None
    if ctype == 3:
        # a palette a little shorter than the indices reach
        plte = rng.integers(0, 256, (max((1 << depth) - 1, 2), 3))
        if trns:
            t = rng.integers(0, 256, max((1 << depth) // 2, 1)).astype(
                np.uint8).tobytes()
    elif trns and ctype == 0:
        t = struct.pack(">H", int(s[0, 0, 0]))
    elif trns:
        t = struct.pack(">HHH", *(int(v) for v in s[0, 0]))
    return png_bytes(s, depth, ctype, plte, t, interlace)


KINDS = _kind_cases()


@pytest.mark.parametrize("ctype,depth,trns,interlace", KINDS,
                         ids=[f"c{c}-{d}bit{'-trns' if t else ''}"
                              f"{'-adam7' if i else ''}"
                              for c, d, t, i in KINDS])
def test_png_kind_reads_as_the_jax_loaders(ctype, depth, trns, interlace,
                                           tmp_path):
    """LoadImage and LoadImageMask (alpha and red) of the same file, to
    the bit."""
    data = _kind_png(ctype, depth, trns, interlace, seed=ctype * 100 + depth)
    (tmp_path / "k.png").write_bytes(data)
    jctx = JaxOpContext(input_dir=str(tmp_path))
    tctx = OpContext(device="cpu", input_dir=str(tmp_path))
    with warnings.catch_warnings():
        # Pillow warns on a palette whose tRNS holds several alphas
        warnings.simplefilter("ignore", UserWarning)
        jimg, jmask = jax_get_op("LoadImage").execute(jctx, "k.png")
        jm = [jax_get_op("LoadImageMask").execute(jctx, "k.png", ch)[0]
              for ch in ("alpha", "red")]
    timg, tmask = get_op("LoadImage").execute(tctx, "k.png")
    tm = [get_op("LoadImageMask").execute(tctx, "k.png", ch)[0]
          for ch in ("alpha", "red")]
    np.testing.assert_array_equal(_np(timg), np.asarray(jimg))
    np.testing.assert_array_equal(_np(tmask), np.asarray(jmask))
    for g, w in zip(tm, jm):
        np.testing.assert_array_equal(_np(g), np.asarray(w))


def test_sixteen_bit_grey_clips_as_pillow_converts_it():
    """Pillow opens 16-bit grey as I;16 and converts it to RGB by
    clipping at 255 (500 reads back as 255, 100 as 100)."""
    data = png_bytes(np.array([[0, 100, 255, 256, 500, 65535]]), 16, 0)
    assert read_png(data).mode == "I;16"
    np.testing.assert_array_equal(decode_png(data)[0, 0, :, 0] * 255.0,
                                  [0, 100, 255, 255, 255, 255])
    im = Image.open(io.BytesIO(data))
    np.testing.assert_array_equal(
        decode_png_rgba(data), np.asarray(im.convert("RGBA"), np.float32)
        / 255.0)
