"""The port's tiled VAE, its SDXL and SD2.1 inpaint families and its
compositing graphs against the JAX package, on the CPU.

- ``DiffusionPipeline.vae_decode_tiled`` and ``vae_encode_tiled`` on the
  tiny family agree with the JAX pipeline's within 2e-4 where the tiles
  really tile; where the input fits one tile they are the one-shot
  decode or encode to the bit; ``check_interrupt`` stops them between
  tiles.
- ``sd21_inpaint`` and ``sdxl_inpaint``: ``detect_family`` agrees on
  release names, and a 9-channel UNet in SDXL's layout at tiny widths
  draws the JAX package's virtual weights and round-trips through a
  single-file checkpoint in both packages.
- The 15 latent ops are not coalesce-safe, and continuous batching
  refuses a ``seed_fixed_batch`` latent.
- Two graphs through both executors (pixels within 2e-3, latents within
  2e-4): an inpaint composite on ``tiny_inpaint`` (a 16-bit RGBA PNG,
  GrowMask, FeatherMask, ConditioningConcat, ConditioningZeroOut,
  InpaintModelConditioning, VAEDecodeTiled, ImageCompositeMasked) and a
  batch graph on ``tiny`` (a palette PNG, VAEEncodeTiled,
  RepeatLatentBatch, LatentBatchSeedBehavior "fixed" through the
  KSampler, ConditioningAverage, LatentFromBatch and the image and mask
  ops after it).  Both are ``chip_smoke.py``'s phase 4 graphs
  (``composite_doc``, ``batch_composite_doc``).
"""

import copy
import dataclasses
import json
import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from comfyui_distributed_tpu.models import checkpoints as jckpt
from comfyui_distributed_tpu.models import registry as jreg
from comfyui_distributed_tpu.models import unet as junet
from comfyui_distributed_tpu.ops.base import OpContext as JaxOpContext
from comfyui_distributed_tpu.runtime import reuse as jreuse
from comfyui_distributed_tpu.workflow import WorkflowExecutor as JaxExecutor
from comfyui_distributed_tpu.workflow import scheduler as jsched
from comfyui_distributed_tpu_torch.models import checkpoints as tckpt
from comfyui_distributed_tpu_torch.models import registry as treg
from comfyui_distributed_tpu_torch.models import unet as tunet
from comfyui_distributed_tpu_torch.models.weights import from_flax
from comfyui_distributed_tpu_torch.ops.base import OpContext, get_op
from comfyui_distributed_tpu_torch.runtime import reuse as treuse
from comfyui_distributed_tpu_torch.workflow import WorkflowExecutor
from comfyui_distributed_tpu_torch.workflow import batch_executor as cb
from comfyui_distributed_tpu_torch.workflow import scheduler as tsched

ROOT = pathlib.Path(__file__).resolve().parents[1]
TOL = dict(rtol=2e-4, atol=2e-4)
IMAGE_ATOL = 2e-3


def _np(x):
    if hasattr(x, "to_host"):
        return x.to_host()
    if isinstance(x, torch.Tensor):
        return x.detach().float().cpu().numpy()
    return np.asarray(x, np.float32)


def _clear():
    for clear in (jreg.clear_pipeline_cache, treg.clear_pipeline_cache,
                  jreuse.get_reuse().clear, treuse.get_reuse().clear):
        clear()


@pytest.fixture(scope="module")
def tiny():
    """The tiny pipelines of both packages, loaded once for the module."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("DTPU_DEFAULT_FAMILY", "tiny")
        _clear()
        yield (jreg.load_pipeline("tiny-vae.ckpt"),
               treg.load_pipeline("tiny-vae.ckpt", device="cpu"))
        _clear()


# --- the tiled VAE -------------------------------------------------------------

# (latent or image size, tile, overlap): the tiny VAE downscales by 2
GEOMETRIES = [((2, 21, 17), 16, 4), ((1, 30, 12), 24, 10)]


@pytest.mark.parametrize("shape,tile,overlap", GEOMETRIES)
def test_tiled_decode_matches_jax(tiny, shape, tile, overlap):
    jp, tp = tiny
    lat = np.random.default_rng(1).standard_normal(shape + (4,)).astype(
        np.float32)
    want = np.asarray(jp.vae_decode_tiled(jnp.asarray(lat), tile, overlap))
    got = tp.vae_decode_tiled(torch.from_numpy(lat), tile, overlap)
    lt = max(tile // 2, 2 * max(overlap // 2, 1))
    assert max(shape[1:]) > lt      # more than one tile
    np.testing.assert_allclose(_np(got), want, **TOL)


@pytest.mark.parametrize("shape,tile,overlap", GEOMETRIES)
def test_tiled_encode_matches_jax(tiny, shape, tile, overlap):
    jp, tp = tiny
    b, h, w = shape
    img = np.random.default_rng(2).random((b, 2 * h, 2 * w, 3),
                                          dtype=np.float32)
    want = np.asarray(jp.vae_encode_tiled(img, tile, overlap))
    got = tp.vae_encode_tiled(torch.from_numpy(img), tile, overlap)
    np.testing.assert_allclose(_np(got), want, **TOL)


def test_tiled_decode_keeps_each_row_its_own(tiny):
    """VAEDecodeTiled is coalesce-safe: a group's rows decode together,
    and each row is the one its prompt decodes alone (within the CPU's
    batch rounding)."""
    _, tp = tiny
    rng = np.random.default_rng(4)
    lat = torch.from_numpy(rng.standard_normal((2, 21, 17, 4)).astype(
        np.float32))
    both = _np(tp.vae_decode_tiled(lat, 16, 4))
    for i in range(2):
        alone = _np(tp.vae_decode_tiled(lat[i:i + 1], 16, 4))[0]
        np.testing.assert_allclose(both[i], alone, rtol=0, atol=1e-5)
    assert not np.allclose(both[0], both[1], atol=1e-2)


def test_one_tile_falls_through_to_the_plain_vae_to_the_bit(tiny):
    _, tp = tiny
    rng = np.random.default_rng(3)
    lat = torch.from_numpy(rng.standard_normal((2, 12, 10, 4)).astype(
        np.float32))
    img = torch.from_numpy(rng.random((1, 24, 20, 3), dtype=np.float32))
    assert torch.equal(tp.vae_decode_tiled(lat, 24, 4), tp.vae_decode(lat))
    assert torch.equal(tp.vae_encode_tiled(img, 24, 4), tp.vae_encode(img))


@pytest.mark.parametrize("which", ["decode", "encode"])
def test_check_interrupt_stops_between_tiles(tiny, which):
    _, tp = tiny
    calls, checks = [], []

    def check():
        checks.append(len(calls))
        if len(checks) == 3:
            raise InterruptedError("execution interrupted")

    inner = getattr(tp, f"vae_{which}")
    pipe = copy.copy(tp)
    setattr(pipe, f"vae_{which}",
            lambda x: calls.append(1) or inner(x))
    x = torch.zeros((1, 40, 40, 4)) if which == "decode" \
        else torch.zeros((1, 80, 80, 3))
    with pytest.raises(InterruptedError):
        getattr(pipe, f"vae_{which}_tiled")(x, 16, 4, check_interrupt=check)
    # checked before each tile: two tiles ran, the third never started
    assert checks == [0, 1, 2] and len(calls) == 2


# --- the two families ------------------------------------------------------------

@pytest.mark.parametrize("name", [
    "sd_xl_base_1.0_inpainting_0.1.safetensors",
    "512-inpainting-ema.ckpt",
    "512-inpainting-ema.safetensors",
    "juggernautXL_v9_inpainting.safetensors",
    "sd2-inpainting.safetensors",
    "sd-v1-5-inpainting.ckpt",
    "sd_xl_base_1.0.safetensors",
])
def test_detect_family_of_release_names_matches_jax(monkeypatch, name):
    monkeypatch.delenv("DTPU_DEFAULT_FAMILY", raising=False)
    fam = treg.detect_family(name)
    assert fam == jreg.detect_family(name)
    assert treg.get_family(fam).name == jreg.FAMILIES[fam].name


def _tiny_xl9():
    """A 9-channel UNet in SDXL's layout (linear projections, no
    attention at the first level, an ADM head) at tiny widths, with the
    tiny VAE and two tiny text towers, in both packages."""
    kw = dict(in_channels=9, model_channels=32, channel_mult=(1, 2, 2),
              num_res_blocks=1, transformer_depth=(0, 1, 1), context_dim=128,
              num_head_channels=16, adm_in_channels=64 + 6 * 256)
    tfam = treg.ModelFamily(
        name="tiny_xl9",
        unet=dataclasses.replace(tunet.SDXL_CONFIG, dtype=torch.float32,
                                 **kw),
        vae=treg.FAMILIES["tiny"].vae,
        clips=treg.FAMILIES["tiny"].clips * 2)
    jfam = jreg.ModelFamily(
        name="tiny_xl9",
        unet=dataclasses.replace(junet.SDXL_CONFIG, dtype=jnp.float32, **kw),
        vae=jreg.FAMILIES["tiny"].vae,
        clips=jreg.FAMILIES["tiny"].clips * 2)
    return jfam, tfam


def test_nine_channel_sdxl_layout_round_trips_in_both_packages(
        tmp_path, monkeypatch):
    """The virtual fill draws the JAX package's 9-channel ``conv_in``;
    the port's CheckpointSave writes it as ``input_blocks.0.0.weight``
    [C, 9, 3, 3], and both packages' loaders read the file back to the
    same weights."""
    jfam, tfam = _tiny_xl9()
    monkeypatch.setitem(jreg.FAMILIES, "tiny_xl9", jfam)
    monkeypatch.setitem(treg.FAMILIES, "tiny_xl9", tfam)
    name = "xl9-inpainting.ckpt"
    _clear()
    try:
        jp = jreg.load_pipeline(name, family_name="tiny_xl9")
        tp = treg.load_pipeline(name, family_name="tiny_xl9", device="cpu")
        want_u, _, _ = from_flax(
            tfam, jp.unet_params, jp.clip_params, jp.vae_params)
        for k, v in tp.unet.state_dict().items():
            assert torch.equal(v, want_u[k].to(v.dtype)), k
        out = tmp_path / "out"
        out.mkdir()
        get_op("CheckpointSave").execute(
            OpContext(device="cpu", output_dir=str(out)), tp, tp, tp,
            filename_prefix="xl9")
        path = str(out / "xl9.safetensors")
        sd = tckpt.load_state_dict(path)
        assert tuple(sd["model.diffusion_model.input_blocks.0.0.weight"]
                     .shape) == (32, 9, 3, 3)
        assert "model.diffusion_model.label_emb.0.0.weight" in sd
        assert tckpt.unconsumed_keys(sd, tfam) == []
        got_u, _, _ = tckpt.load_checkpoint(path, tfam)
        ju, jc, jv = jckpt.load_checkpoint(path, jfam)
        back_u, _, _ = from_flax(tfam, ju, jc, jv)
        for k, v in tp.unet.state_dict().items():
            assert torch.equal(got_u[k].to(v.dtype), v), k
            assert torch.equal(back_u[k].to(v.dtype), v), k
    finally:
        _clear()


# --- what the latent ops keep out of ------------------------------------------------

LATENT_OPS = {
    "LatentAdd": {"samples1": ["5", 0], "samples2": ["5", 0]},
    "LatentSubtract": {"samples1": ["5", 0], "samples2": ["5", 0]},
    "LatentMultiply": {"samples": ["5", 0], "multiplier": 1.0},
    "LatentInterpolate": {"samples1": ["5", 0], "samples2": ["5", 0],
                          "ratio": 1.0},
    "LatentBlend": {"samples1": ["5", 0], "samples2": ["5", 0],
                    "blend_factor": 0.5},
    "LatentComposite": {"samples_to": ["5", 0], "samples_from": ["5", 0],
                        "x": 0, "y": 0, "feather": 0},
    "LatentCompositeMasked": {"destination": ["5", 0], "source": ["5", 0],
                              "x": 0, "y": 0, "resize_source": False},
    "LatentCrop": {"samples": ["5", 0], "width": 64, "height": 64, "x": 0,
                   "y": 0},
    "LatentFlip": {"samples": ["5", 0], "flip_method": "x-axis: vertically"},
    "LatentRotate": {"samples": ["5", 0], "rotation": "none"},
    "LatentBatch": {"samples1": ["5", 0], "samples2": ["5", 0]},
    "LatentFromBatch": {"samples": ["5", 0], "batch_index": 0, "length": 1},
    "LatentBatchSeedBehavior": {"samples": ["5", 0],
                                "seed_behavior": "fixed"},
    "RepeatLatentBatch": {"samples": ["5", 0], "amount": 1},
    "RebatchLatents": {"latents": ["5", 0], "batch_size": 1},
}


def _txt2img(steps=2, size=64):
    doc = json.loads((ROOT / "workflows" / "distributed-txt2img.json")
                     .read_text())
    doc["5"]["inputs"].update(width=size, height=size, batch_size=2)
    doc["3"]["inputs"].update(steps=steps, seed=5)
    for nid in ("13", "14"):      # no DistributedSeed or Collector
        doc.pop(nid)
    doc["9"]["inputs"]["images"] = ["8", 0]
    return doc


@pytest.mark.parametrize("op", sorted(LATENT_OPS))
def test_a_graph_with_a_latent_op_does_not_coalesce(op):
    doc = _txt2img()
    assert tsched.coalesce_signature(doc) is not None
    doc["20"] = {"class_type": op, "inputs": LATENT_OPS[op]}
    doc["3"]["inputs"]["latent_image"] = ["20", 0]
    assert tsched.coalesce_signature(doc) is None
    assert jsched.coalesce_signature(doc) is None


def test_continuous_batching_refuses_a_fixed_seed_batch(monkeypatch):
    monkeypatch.setenv("DTPU_DEFAULT_FAMILY", "tiny")
    doc = _txt2img()
    doc["20"] = {"class_type": "LatentBatchSeedBehavior",
                 "inputs": {"samples": ["5", 0], "seed_behavior": "fixed"}}
    doc["3"]["inputs"]["latent_image"] = ["20", 0]
    try:
        with pytest.raises(cb.CBIneligible, match="fixed-seed-batch"):
            cb._Bucket("sig", {"prompt": doc}, OpContext(device="cpu"), 2)
    finally:
        _clear()


# --- two graphs through both executors ----------------------------------------------

def _both(doc, tmp_path):
    _clear()
    try:
        ours = WorkflowExecutor(OpContext(
            device="cpu", input_dir=str(tmp_path))).execute(
                copy.deepcopy(doc))
        ref = JaxExecutor(JaxOpContext(input_dir=str(tmp_path))).execute(
            copy.deepcopy(doc))
        ref.wait_host()
    finally:
        _clear()
    return ours, ref


def test_inpaint_composite_graph_matches_the_jax_executor(tmp_path,
                                                          monkeypatch):
    monkeypatch.setenv("DTPU_DEFAULT_FAMILY", "tiny_inpaint")
    monkeypatch.setenv("DTPU_CACHE", "0")
    (tmp_path / "src16.png").write_bytes(chip_smoke.png16_rgba(48, 56, 4))
    doc = chip_smoke.composite_doc("tiny-inpaint.ckpt", "src16.png", 3, 24, 8)
    ours, ref = _both(doc, tmp_path)
    a, b = ours.image_batch, ref.image_batch
    assert a.shape == b.shape == (1, 48, 56, 3)
    assert np.isfinite(a).all() and a.std() > 0
    np.testing.assert_allclose(a, b, rtol=0, atol=IMAGE_ATOL)
    # the concat's 154 tokens, the zeroed negative, a tiled decode
    assert tuple(ours.outputs["7"][0].context.shape)[1] == 154
    assert not ours.outputs["9"][0].context.any()
    np.testing.assert_allclose(_np(ours.outputs["11"][0]["samples"]),
                               np.asarray(ref.outputs["11"][0]["samples"]),
                               **TOL)
    # outside the feathered mask the composite is the source to the bit
    m = _np(ours.outputs["4"][0])[0]
    src = _np(ours.outputs["2"][0])[0]
    np.testing.assert_array_equal(a[0][m == 0], src[m == 0])


def test_fixed_seed_batch_graph_matches_the_jax_executor(tmp_path,
                                                         monkeypatch):
    monkeypatch.setenv("DTPU_DEFAULT_FAMILY", "tiny")
    monkeypatch.setenv("DTPU_CACHE", "0")
    (tmp_path / "pal.png").write_bytes(chip_smoke.png_palette(40, 48, 5))
    ours, ref = _both(chip_smoke.batch_composite_doc(
        "tiny-batch.ckpt", "pal.png", (40, 48)), tmp_path)
    got = _np(ours.outputs["10"][0]["samples"])
    want = np.asarray(ref.outputs["10"][0]["samples"])
    assert got.shape == want.shape == (2, 20, 24, 4)
    np.testing.assert_allclose(got, want, **TOL)
    # "fixed": both rows drew the same noise from the same source
    np.testing.assert_array_equal(got[0], got[1])
    assert ours.outputs["5"][0]["seed_fixed_batch"] is True
    # the masks come from the file: equal to the bit
    for nid in ("25", "30", "32", "33"):
        np.testing.assert_array_equal(_np(ours.outputs[nid][0]),
                                      np.asarray(ref.outputs[nid][0]),
                                      err_msg=nid)
    a, b = ours.image_batch, ref.image_batch
    assert a.shape == b.shape and a.shape[0] == 2
    assert np.isfinite(a).all() and a.std() > 0
    np.testing.assert_allclose(a, b, rtol=0, atol=IMAGE_ATOL)
