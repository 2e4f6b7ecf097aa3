"""The port's tiled-upscale slice against the JAX package's, on the CPU.

``workflows/distributed-upscale.json`` runs LoadImage -> RRDB
super-resolution -> ImageScale -> UltimateSDUpscaleDistributed (every
tile VAE-encoded, refined at denoise < 1, decoded and blended through a
blurred mask).  Each piece is held against its JAX counterpart on the
same numpy inputs: the RRDB network (fp32, 2e-4), the resampler and the
tile mask against the JAX package's Pillow-backed functions (1e-5, and
the uint8 mask exactly), the tile geometry and blending, and the whole
workflow at a small size through both executors (2e-3 on [0, 1] pixels).
"""

import copy
import dataclasses
import json
import pathlib
import types

import numpy as np
import pytest
import torch

from comfyui_distributed_tpu_torch.models import registry as treg
from comfyui_distributed_tpu_torch.models import upscalers as tup
from comfyui_distributed_tpu_torch.models.weights import rrdb_from_flax
from comfyui_distributed_tpu_torch.ops import tiling
from comfyui_distributed_tpu_torch.ops.base import OpContext
from comfyui_distributed_tpu_torch.ops.basic import ImageUpscaleWithModel
from comfyui_distributed_tpu_torch.ops.tiled_upscale import (
    UltimateSDUpscaleDistributed)
from comfyui_distributed_tpu_torch.utils.image import (FILTERS, resize_image,
                                                       resample_matrix)
from comfyui_distributed_tpu_torch.workflow import WorkflowExecutor

ROOT = pathlib.Path(__file__).resolve().parents[1]
WORKFLOW = ROOT / "workflows" / "distributed-upscale.json"
TOL = dict(rtol=2e-4, atol=2e-4)
# pixels in [0, 1] after a tiny-family refine
IMAGE_ATOL = 2e-3


def _np_tree(tree):
    import jax
    return jax.tree_util.tree_map(np.asarray, tree)


def _rrdb_pair(scale):
    """(JAX net, its params, the port's net with the same weights), fp32."""
    import jax.numpy as jnp

    from comfyui_distributed_tpu.models import registry as jreg
    from comfyui_distributed_tpu.models import upscalers as jup
    jcfg = dataclasses.replace(jup.TINY_RRDB_CONFIG, dtype=jnp.float32,
                               scale=scale)
    tcfg = dataclasses.replace(tup.TINY_RRDB_CONFIG, dtype=torch.float32,
                               scale=scale)
    params = jreg._virtual_params(jup.RRDBNet(jcfg), 21,
                                  jnp.zeros((1, 16, 16, 3)))
    net = tup.RRDBNet(tcfg)
    net.load_state_dict(rrdb_from_flax(tcfg, _np_tree(params)))
    return jup.RRDBNet(jcfg), params, net.eval()


@pytest.mark.parametrize("scale", [2, 4])
def test_rrdb_matches_jax(scale):
    import jax.numpy as jnp
    jnet, params, net = _rrdb_pair(scale)
    x = np.random.default_rng(0).uniform(
        size=(2, 12, 10, 3)).astype(np.float32)
    jout = np.asarray(jnet.apply({"params": params}, jnp.asarray(x)))
    with torch.no_grad():
        tout = net(torch.from_numpy(x)).numpy()
    assert tout.shape == (2, 12 * scale, 10 * scale, 3)
    assert 0.0 <= tout.min() and tout.max() <= 1.0
    np.testing.assert_allclose(tout, jout, **TOL)


def test_virtual_upscaler_equals_the_jax_packages_weights():
    """The name's seed with no offset, flax paths from the network's
    root: the same weights as the JAX package's virtual upscaler."""
    from comfyui_distributed_tpu.models import registry as jreg
    name = "tiny-port-upscaler-check.pth"
    _, params, scale = jreg.load_upscaler(name)
    up = treg.load_upscaler(name, device="cpu")
    assert up.scale == scale == 2
    assert treg.load_upscaler(name, device="cpu") is up
    sd = rrdb_from_flax(tup.TINY_RRDB_CONFIG, _np_tree(params))
    own = up.net.state_dict()
    assert set(own) == set(sd)
    for k, v in sd.items():
        assert torch.equal(own[k], v), k
    treg.clear_pipeline_cache()


@pytest.mark.parametrize("name,scale,tiny", [
    ("4x_foolhardy_Remacri.pth", 4, False), ("RealESRGAN_x2plus_2x.pth", 2,
                                             False),
    ("8x_NMKD-Superscale.pth", 8, False), ("upscaler.pth", 4, False),
    ("tiny_sr.pth", 2, True)])
def test_upscaler_config_follows_the_name(name, scale, tiny, monkeypatch):
    monkeypatch.delenv("DTPU_DEFAULT_FAMILY", raising=False)
    cfg = treg.upscaler_config(name)
    assert cfg.scale == scale
    assert (cfg == tup.TINY_RRDB_CONFIG) == tiny
    if not tiny:
        assert cfg.num_blocks == 23 and cfg.dtype == torch.bfloat16
    monkeypatch.setenv("DTPU_DEFAULT_FAMILY", "tiny")
    assert treg.upscaler_config(name) == tup.TINY_RRDB_CONFIG


METHODS = sorted(FILTERS) + ["no-such-method"]
SIZES = [((17, 13), (40, 9)), ((64, 48), (21, 33)), ((33, 31), (33, 64)),
         ((9, 7), (9, 7)), ((5, 40), (11, 3))]


@pytest.mark.parametrize("method", METHODS)
@pytest.mark.parametrize("src,dst", SIZES)
def test_resize_matches_pillow(method, src, dst):
    """Up and down, odd sizes, one axis only, and the same size (a copy
    in Pillow), on values outside [0, 1] (no clipping in "F" mode)."""
    from comfyui_distributed_tpu.utils.image import resize_image as jresize
    (w, h), (ow, oh) = src, dst
    x = np.random.default_rng(w * 100 + h).uniform(
        -0.5, 1.5, size=(2, h, w, 3)).astype(np.float32)
    ref = jresize(x, ow, oh, method)
    out = resize_image(torch.from_numpy(x), ow, oh, method)
    assert out.dtype == torch.float32 and out.shape == (2, oh, ow, 3)
    np.testing.assert_allclose(out.numpy(), ref, rtol=0, atol=1e-5)


def test_same_size_resize_is_a_copy():
    x = torch.rand(1, 6, 5, 3)
    out = resize_image(x, 5, 6, "lanczos")
    assert torch.equal(out, x) and out.data_ptr() != x.data_ptr()


def test_resample_rows_sum_to_one():
    for method in ("area", "bilinear", "bicubic", "lanczos"):
        for n, m in ((512, 2048), (2048, 512), (37, 5)):
            mat = resample_matrix(n, m, method)
            assert mat.dtype == torch.float64 and mat.shape == (m, n)
            np.testing.assert_allclose(mat.sum(1).numpy(), 1.0, atol=1e-12)


MASKS = [(64, 64, 0, 0, 32, 32, 2), (64, 64, 32, 32, 32, 32, 0),
         (100, 80, 32, 32, 32, 32, 8), (37, 29, 16, 8, 16, 16, 1),
         (96, 64, 64, 32, 32, 32, 5), (40, 40, 8, 8, 16, 16, 16),
         (50, 30, 0, 16, 48, 16, 3), (2048, 2048, 1536, 512, 512, 512, 8)]


@pytest.mark.parametrize("w,h,x,y,tw,th,blur", MASKS)
def test_tile_mask_equals_pillows_exactly(w, h, x, y, tw, th, blur):
    """Pillow's inclusive rectangle and its GaussianBlur (three box
    passes in 24-bit fixed point), to the last uint8 step."""
    from comfyui_distributed_tpu.ops import tiling as jtiling
    ref = jtiling.create_tile_mask(w, h, x, y, tw, th, blur)
    out = tiling.create_tile_mask(w, h, x, y, tw, th, blur)
    assert out.dtype == np.float32
    np.testing.assert_array_equal(out, ref)
    region = (max(x - 11, 0), max(y - 7, 0), min(x + tw + 13, w),
              min(y + th + 5, h))
    np.testing.assert_array_equal(
        tiling.tile_mask_region(w, h, x, y, tw, th, blur, region),
        ref[region[1]:region[3], region[0]:region[2]])


@pytest.mark.parametrize("radius", [0.5, 1, 2, 3, 8, 16, 31.5])
def test_blur_radius_and_blur_match_pillow(radius):
    from PIL import Image, ImageFilter
    img = (np.random.default_rng(int(radius * 2)).uniform(size=(23, 41))
           > 0.7).astype(np.uint8) * 255
    ref = np.asarray(Image.fromarray(img, "L").filter(
        ImageFilter.GaussianBlur(radius)))
    np.testing.assert_array_equal(tiling.gaussian_blur(img, radius), ref)


def test_grid_partition_and_regions_match_jax():
    from comfyui_distributed_tpu.ops import tiling as jtiling
    for args in ((2048, 2048, 512, 512), (100, 70, 32, 32), (64, 64, 64, 64)):
        assert tiling.calculate_tiles(*args) == jtiling.calculate_tiles(*args)
    for total in (1, 5, 16, 17):
        for workers in (0, 1, 3, 7):
            assert tiling.partition_tiles(total, workers) == \
                jtiling.partition_tiles(total, workers)
    for args in ((0, 0, 512, 512, 32, 2048, 2048), (96, 64, 32, 32, 8, 100, 70),
                 (64, 32, 32, 32, 0, 96, 64)):
        assert tiling.extraction_region(*args) == \
            jtiling.extraction_region(*args)
    for v in (0, 3, 4, 12, 509, 515):
        assert tiling.round_to_multiple(v) == jtiling.round_to_multiple(v)
    for total, tile, overlap in ((100, 32, 8), (32, 32, 8), (2048, 512, 32),
                                 (70, 64, 64)):
        assert tiling.uniform_tile_starts(total, tile, overlap) == \
            jtiling.uniform_tile_starts(total, tile, overlap)
    np.testing.assert_array_equal(tiling.feather_ramp(20, 6),
                                  jtiling.feather_ramp(20, 6))
    np.testing.assert_array_equal(tiling.make_feather_mask(24, 16, 5),
                                  jtiling.make_feather_mask(24, 16, 5))


@pytest.mark.parametrize("pad", [0, 8])
def test_padding_extraction_and_blend_match_jax(pad):
    from comfyui_distributed_tpu.ops import tiling as jtiling
    img = np.random.default_rng(pad).uniform(
        size=(1, 70, 100, 3)).astype(np.float32)
    t = torch.from_numpy(img)
    jp, jx, jy = jtiling.pad_image_for_tiles(img, 32, 32, pad)
    tp, tx, ty = tiling.pad_image_for_tiles(t, 32, 32, pad)
    assert (tx, ty) == (jx, jy)
    np.testing.assert_array_equal(tp.numpy(), jp)
    pos = tiling.calculate_tiles(100, 70, 32, 32)
    ref = jtiling.extract_tiles(img, pos, 32, 32, pad)
    out = tiling.extract_tiles(t, pos, 32, 32, pad)
    np.testing.assert_allclose(out.numpy(), ref, rtol=0, atol=1e-5)
    canvas_j, canvas_t = img[0].copy(), t[0].clone()
    for i, (x, y) in enumerate(pos):
        x1, y1, x2, y2 = tiling.extraction_region(x, y, 32, 32, pad, 100, 70)
        tile = 1.0 - ref[i]
        canvas_j = jtiling.blend_tile(canvas_j, tile, x1, y1, (x, y), 32, 32,
                                      (x2 - x1, y2 - y1), 3)
        tiling.blend_tile(canvas_t, torch.from_numpy(tile), x1, y1, (x, y),
                          32, 32, (x2 - x1, y2 - y1), 3)
    np.testing.assert_allclose(canvas_t.numpy(), canvas_j, rtol=0, atol=1e-5)


def _sr(x, scale):
    """A stand-in upscaler: nearest x``scale`` and a pointwise curve."""
    return np.tanh(np.repeat(np.repeat(x, scale, 1), scale, 2) * 1.7)


def test_tiled_apply_and_tiled_apply_down_match_jax():
    from comfyui_distributed_tpu.ops import tiling as jtiling
    x = np.random.default_rng(5).uniform(
        size=(2, 45, 70, 3)).astype(np.float32)
    ref = jtiling.tiled_apply(lambda t: _sr(np.asarray(t), 2), x, 32, 8, 2, 3)
    out = tiling.tiled_apply(
        lambda t: torch.from_numpy(_sr(t.numpy(), 2)), torch.from_numpy(x),
        32, 8, 2, 3)
    assert out.shape == (2, 90, 140, 3)
    np.testing.assert_allclose(out.numpy(), ref, rtol=0, atol=1e-6)

    def pool(a):
        b, h, w, c = a.shape
        return a.reshape(b, h // 2, 2, w // 2, 2, c).mean((2, 4))[..., :2]
    ref = jtiling.tiled_apply_down(lambda t: pool(np.asarray(t)), x[:, :44],
                                   16, 4, 2, 2)
    out = tiling.tiled_apply_down(lambda t: torch.from_numpy(pool(
        t.numpy())), torch.from_numpy(x[:, :44]), 16, 4, 2, 2)
    assert out.shape == (2, 22, 35, 2)
    np.testing.assert_allclose(out.numpy(), ref, rtol=0, atol=1e-6)


def test_image_upscale_with_model_tiles_above_the_threshold(monkeypatch):
    """Whole-image pass at or below the threshold, tiled above it: the
    same network output in the interior either way."""
    _, _, net = _rrdb_pair(2)
    model = treg.Upscaler("fp32-tiny", net, 2)
    img = torch.from_numpy(np.random.default_rng(6).uniform(
        size=(1, 40, 40, 3)).astype(np.float32))
    ctx = OpContext(device="cpu")
    whole = ImageUpscaleWithModel().execute(ctx, model, img)[0].data
    monkeypatch.setattr(ImageUpscaleWithModel, "TILE_THRESHOLD", 1000)
    monkeypatch.setattr(ImageUpscaleWithModel, "TILE", 24)
    monkeypatch.setattr(ImageUpscaleWithModel, "OVERLAP", 8)
    tiled = ImageUpscaleWithModel().execute(ctx, model, img)[0].data
    assert whole.shape == tiled.shape == (1, 80, 80, 3)
    # RRDB's receptive field reaches past a 24-pixel window's edge, so
    # tiles differ from the whole pass near the seams, not everywhere
    assert (tiled - whole).abs().mean().item() < 0.05


def _small_doc(tmp_path, size=(48, 40)):
    """The workflow at a small size: a small input PNG, 2x tiny RRDB,
    ImageScale to 64^2, four 32^2 tiles + 8 px, 2 steps."""
    from PIL import Image
    w, h = size
    rng = np.random.default_rng(8)
    px = (rng.uniform(size=(h, w, 3)) * 255).astype(np.uint8)
    Image.fromarray(px, "RGB").save(tmp_path / "input.png")
    doc = json.loads(WORKFLOW.read_text())
    doc["16"]["inputs"].update(width=64, height=64)
    doc["2"]["inputs"].update(steps=2, tile_width=32, tile_height=32,
                              padding=8, mask_blur=2)
    return doc


@pytest.fixture
def tiny_family(monkeypatch):
    """The tiny family, with the tiny RRDB in fp32 on both sides: its
    bf16 convolutions round differently in XLA and in torch, and the
    refine amplifies one bf16 step past the image tolerance."""
    import jax.numpy as jnp

    from comfyui_distributed_tpu.models import registry as jreg
    monkeypatch.setenv("DTPU_DEFAULT_FAMILY", "tiny")
    monkeypatch.setattr(jreg, "TINY_RRDB_CONFIG", dataclasses.replace(
        jreg.TINY_RRDB_CONFIG, dtype=jnp.float32))
    monkeypatch.setattr(jreg, "_upscaler_cache", {})
    monkeypatch.setattr(tup, "TINY_RRDB_CONFIG", dataclasses.replace(
        tup.TINY_RRDB_CONFIG, dtype=torch.float32))
    yield
    treg.clear_pipeline_cache()


def test_upscale_workflow_matches_jax_executor(tiny_family, tmp_path):
    from comfyui_distributed_tpu.ops.base import OpContext as JaxOpContext
    from comfyui_distributed_tpu.workflow import \
        WorkflowExecutor as JaxExecutor
    doc = _small_doc(tmp_path)
    ours = WorkflowExecutor(OpContext(device="cpu", input_dir=str(tmp_path))) \
        .execute(copy.deepcopy(doc))
    ref = JaxExecutor(JaxOpContext(input_dir=str(tmp_path))).execute(
        copy.deepcopy(doc))
    ref.wait_host()
    a, b = ours.image_batch, ref.image_batch
    assert a.shape == b.shape == (1, 64, 64, 3)
    assert np.isfinite(a).all() and a.std() > 0
    np.testing.assert_allclose(a, b, rtol=0, atol=IMAGE_ATOL)
    assert set(ours.timings) == set(doc) - {"__doc__"}
    assert {"tile_extract", "tile_encode", "tile_sample", "tile_decode",
            "tile_blend"} <= set(ours.stages)


def test_upscale_tiles_are_refined_as_one_batch(tiny_family, tmp_path,
                                                monkeypatch):
    """All tiles go through one encode/sample/decode, tile i seeded
    seed + i with fold-in index 0."""
    calls = []
    real = treg.DiffusionPipeline.sample

    def spy(self, latents, *a, **kw):
        calls.append((tuple(latents.shape), [int(s) for s in a[2]],
                      kw["sample_idx"].tolist(), kw["denoise"]))
        return real(self, latents, *a, **kw)

    monkeypatch.setattr(treg.DiffusionPipeline, "sample", spy)
    WorkflowExecutor(OpContext(device="cpu", input_dir=str(tmp_path))) \
        .execute(_small_doc(tmp_path))
    assert calls == [((4, 16, 16, 4), [42, 43, 44, 45], [0, 0, 0, 0], 0.35)]


@pytest.mark.parametrize("what", ["multi_job_id", "regional", "perp_neg"])
def test_what_is_not_ported_raises(what):
    ctx = OpContext(device="cpu")
    cond = types.SimpleNamespace(context=torch.zeros(1, 77, 64))
    model = types.SimpleNamespace(device=torch.device("cpu"))
    kw = {}
    if what == "multi_job_id":
        kw["multi_job_id"] = "job-1"
    elif what == "regional":
        cond.siblings = (cond,)
    else:
        model.perp_neg_cond = cond
    with pytest.raises(NotImplementedError):
        UltimateSDUpscaleDistributed().execute(
            ctx, torch.zeros(1, 64, 64, 3), model, cond, cond, None, 1, 2,
            8.0, "euler", "normal", 0.35, 32, 32, 8, 2, **kw)
