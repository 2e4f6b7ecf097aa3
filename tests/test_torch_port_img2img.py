"""The port's img2img slice against the JAX package's, on the CPU.

``workflows/distributed-img2img.json`` runs LoadImage -> ImageScale ->
VAEEncode -> KSampler(denoise 0.6) -> VAEDecode.  The VAE encoder is held
against the JAX one on the same numpy inputs (fp32, 2e-4), the PNG
reader against Pillow (exact pixels), the image ops against the JAX ops,
and the whole workflow at a small size through both executors (2e-3 on
[0, 1] pixels).
"""

import copy
import dataclasses
import json
import pathlib
import struct
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from comfyui_distributed_tpu.models import registry as jreg
from comfyui_distributed_tpu.models import schedules as jsch
from comfyui_distributed_tpu.models import vae as jvae
from comfyui_distributed_tpu.ops import basic as jbasic
from comfyui_distributed_tpu.ops.base import OpContext as JaxOpContext
from comfyui_distributed_tpu.workflow import WorkflowExecutor as JaxExecutor
from comfyui_distributed_tpu_torch import cli
from comfyui_distributed_tpu_torch.models import registry as treg
from comfyui_distributed_tpu_torch.models import schedules as tsch
from comfyui_distributed_tpu_torch.models import vae as tvae
from comfyui_distributed_tpu_torch.models.weights import (
    from_flax, state_dict_from_flax)
from comfyui_distributed_tpu_torch.ops import basic as tbasic
from comfyui_distributed_tpu_torch.ops.base import OpContext
from comfyui_distributed_tpu_torch.utils.image import decode_png
from comfyui_distributed_tpu_torch.workflow import WorkflowExecutor

ROOT = pathlib.Path(__file__).resolve().parents[1]
WORKFLOW = ROOT / "workflows" / "distributed-img2img.json"
TOL = dict(rtol=2e-4, atol=2e-4)
# pixels in [0, 1]
IMAGE_ATOL = 2e-3


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _vae_pair(jcfg, tcfg, seed, size):
    params = jreg._virtual_params(jvae.VAE(jcfg), seed,
                                  jnp.zeros((1, size, size, 3)))
    vae = tvae.VAE(tcfg)
    vae.load_state_dict(state_dict_from_flax(vae, _np_tree(params)))
    return params, vae.eval()


@pytest.mark.parametrize("which", ["tiny", "sd_narrow"])
def test_vae_encode_matches_jax(which):
    """The tiny VAE (one downsample) and SD's layout (four levels, two
    res blocks each) at a narrow 32 channels, fp32: the encoder's moments
    and ``encode`` (the mean times the scaling factor)."""
    if which == "tiny":
        jcfg, tcfg, size = jvae.TINY_VAE_CONFIG, tvae.TINY_VAE_CONFIG, 16
    else:
        jcfg = dataclasses.replace(jvae.SD_VAE_CONFIG, base_channels=32,
                                   dtype=jnp.float32)
        tcfg = dataclasses.replace(tvae.SD_VAE_CONFIG, base_channels=32,
                                   dtype=torch.float32)
        size = 24
    params, vae = _vae_pair(jcfg, tcfg, 4, size)
    img = np.random.default_rng(1).uniform(
        size=(2, size, size + 8, 3)).astype(np.float32)
    jmod = jvae.VAE(jcfg)
    jlat = jmod.apply({"params": params}, jnp.asarray(img), method="encode")
    jmom = jvae.Encoder(jcfg).apply({"params": params["encoder"]},
                                    jnp.asarray(img) * 2.0 - 1.0)
    with torch.no_grad():
        tlat = vae.encode(torch.from_numpy(img))
        tmom = vae.encoder(torch.from_numpy(img).permute(0, 3, 1, 2)
                           * 2.0 - 1.0).permute(0, 2, 3, 1)
    ds = tcfg.downscale
    assert tlat.shape == (2, size // ds, (size + 8) // ds, 4)
    np.testing.assert_allclose(tmom.numpy(), np.asarray(jmom), **TOL)
    np.testing.assert_allclose(tlat.numpy(), np.asarray(jlat), **TOL)


def test_vae_encode_is_the_mean_and_draws_nothing():
    _, vae = _vae_pair(jvae.TINY_VAE_CONFIG, tvae.TINY_VAE_CONFIG, 5, 16)
    img = torch.rand(1, 16, 16, 3)
    with torch.no_grad():
        a, b = vae.encode(img), vae.encode(img)
        mom = vae.quant_conv(vae.encoder(img.permute(0, 3, 1, 2) * 2 - 1))
    assert torch.equal(a, b)
    torch.testing.assert_close(
        a, (mom[:, :4] * 0.18215).permute(0, 2, 3, 1), rtol=0, atol=0)


def test_from_flax_carries_the_whole_vae_tree():
    jp = jreg.load_pipeline("tiny-img2img-check.safetensors",
                            family_name="tiny")
    _, _, sd = from_flax(treg.FAMILIES["tiny"], _np_tree(jp.unet_params),
                         [_np_tree(p) for p in jp.clip_params],
                         _np_tree(jp.vae_params))
    roots = {k.split(".")[0] for k in sd}
    assert roots == {"encoder", "decoder", "quant_conv", "post_quant_conv"}
    assert set(jp.vae_params) == roots
    tp = treg.load_pipeline("tiny-img2img-check.safetensors",
                            family_name="tiny", device="cpu")
    for k, v in tp.vae.state_dict().items():
        assert torch.equal(v, sd[k]), k
    treg.clear_pipeline_cache()


@pytest.mark.parametrize("scheduler", ["normal", "karras"])
@pytest.mark.parametrize("denoise", [0.35, 0.6])
def test_partial_denoise_schedules_equal(scheduler, denoise):
    js = jsch.compute_sigmas(jsch.make_discrete_schedule(), scheduler, 20,
                             denoise)
    ts = tsch.compute_sigmas(tsch.make_discrete_schedule(), scheduler, 20,
                             denoise)
    assert len(ts) == 21
    np.testing.assert_array_equal(ts, js)


# --- PNG ---------------------------------------------------------------------


@pytest.mark.parametrize("mode,shape", [("RGB", (23, 37, 3)),
                                        ("RGBA", (16, 9, 4)),
                                        ("L", (31, 17))])
def test_png_written_by_pillow_decodes_to_its_pixels(mode, shape, tmp_path):
    rng = np.random.default_rng(len(mode))
    # a gradient plus noise: Pillow's adaptive filter writes sub and up
    # rows (every filter type is checked below on rows written here)
    base = np.add.outer(np.arange(shape[0]), np.arange(shape[1]) * 3)
    if len(shape) == 3:
        base = base[..., None] + np.arange(shape[2]) * 40
    px = ((base + rng.integers(0, 3, size=shape)) % 256).astype(np.uint8)
    Image.fromarray(px, mode).save(tmp_path / "x.png")
    out = decode_png((tmp_path / "x.png").read_bytes())
    want = px if px.ndim == 3 else px[..., None]
    assert out.dtype == np.float32 and out.shape == (1,) + want.shape
    np.testing.assert_array_equal(out[0], want.astype(np.float32) / 255.0)


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    return a if pa <= pb and pa <= pc else (b if pb <= pc else c)


def _png_with_filters(px: np.ndarray, filters, color_type: int) -> bytes:
    """An 8-bit PNG whose row y is written with filter filters[y % 5]."""
    h, w = px.shape[:2]
    bpp = 1 if px.ndim == 2 else px.shape[2]
    raw = px.reshape(h, w * bpp).astype(np.int64)
    out = bytearray()
    for y in range(h):
        f = filters[y % len(filters)]
        up = raw[y - 1] if y else np.zeros(w * bpp, np.int64)
        line = []
        for x in range(w * bpp):
            a = raw[y, x - bpp] if x >= bpp else 0
            c = up[x - bpp] if x >= bpp else 0
            pred = [0, a, up[x], (a + up[x]) // 2, _paeth(a, up[x], c)][f]
            line.append((raw[y, x] - pred) & 0xFF)
        out += bytes([f]) + bytes(line)

    def chunk(tag, data):
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))
    return (b"\x89PNG\r\n\x1a\n"
            + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, color_type, 0,
                                         0, 0))
            + chunk(b"IDAT", zlib.compress(bytes(out)))
            + chunk(b"IEND", b""))


@pytest.mark.parametrize("channels,color_type", [(1, 0), (3, 2), (4, 6)])
def test_every_row_filter_decodes_as_pillow_reads_it(channels, color_type,
                                                     tmp_path):
    """None, sub, up, average and Paeth rows, checked against Pillow's
    reading of the same bytes."""
    shape = (11, 13) if channels == 1 else (11, 13, channels)
    px = np.random.default_rng(channels).integers(0, 256, size=shape,
                                                  dtype=np.uint8)
    data = _png_with_filters(px, [0, 1, 2, 3, 4], color_type)
    (tmp_path / "f.png").write_bytes(data)
    ref = np.asarray(Image.open(tmp_path / "f.png"))
    np.testing.assert_array_equal(ref, px)
    out = decode_png(data)[0]
    np.testing.assert_array_equal(
        out, (ref if ref.ndim == 3 else ref[..., None]) / np.float32(255.0))


@pytest.mark.parametrize("kind", ["16-bit", "palette", "interlaced",
                                  "not-png"])
def test_png_kinds_not_read_raise(kind, tmp_path):
    if kind == "16-bit":
        Image.fromarray(np.zeros((4, 4), np.uint16), "I;16").save(
            tmp_path / "x.png")
        data = (tmp_path / "x.png").read_bytes()
    elif kind == "palette":
        Image.new("P", (4, 4)).save(tmp_path / "x.png")
        data = (tmp_path / "x.png").read_bytes()
    elif kind == "interlaced":
        data = bytearray(_png_with_filters(np.zeros((4, 4, 3), np.uint8),
                                           [0], 2))
        data[28] = 1    # the IHDR interlace byte (CRC is not checked)
        data = bytes(data)
    else:
        data = b"GIF89a" + bytes(20)
    err = ValueError if kind == "not-png" else NotImplementedError
    with pytest.raises(err):
        decode_png(data)


# --- ops ---------------------------------------------------------------------


@pytest.mark.parametrize("mode", ["RGB", "RGBA", "L", "missing"])
def test_load_image_matches_jax(mode, tmp_path):
    """A file in the input dir (RGBA: mask = 1 - alpha), or the JAX
    package's 512^2 gradient when the file is missing."""
    if mode != "missing":
        shape = (20, 30) if mode == "L" else (20, 30, len(mode))
        px = np.random.default_rng(9).integers(0, 256, size=shape,
                                               dtype=np.uint8)
        Image.fromarray(px, mode).save(tmp_path / "in.png")
    jimg, jmask = jbasic.LoadImage().execute(
        JaxOpContext(input_dir=str(tmp_path)), "in.png")
    timg, tmask = tbasic.LoadImage().execute(
        OpContext(device="cpu", input_dir=str(tmp_path)), "in.png")
    np.testing.assert_array_equal(timg.data.numpy(), np.asarray(jimg))
    np.testing.assert_array_equal(tmask.numpy(), np.asarray(jmask))
    if mode == "missing":
        assert timg.data.shape == (1, 512, 512, 3)


@pytest.mark.parametrize("method,w,h,crop", [
    ("lanczos", 64, 48, "disabled"), ("bilinear", 20, 50, "center"),
    ("nearest-exact", 33, 33, "center"), ("area", 15, 10, "disabled"),
    ("bicubic", 40, 30, "disabled"), ("lanczos", 30, 20, "disabled")])
def test_image_scale_matches_jax(method, w, h, crop):
    img = np.random.default_rng(10).uniform(
        size=(2, 20, 30, 3)).astype(np.float32)
    ref = jbasic.ImageScale().execute(JaxOpContext(), img, method, w, h,
                                      crop)[0]
    out = tbasic.ImageScale().execute(OpContext(device="cpu"),
                                      torch.from_numpy(img), method, w, h,
                                      crop)[0].data
    assert out.shape == (2, h, w, 3)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=0,
                               atol=1e-5)


# --- the workflow ------------------------------------------------------------


def _small_doc(tmp_path, size=48, steps=3):
    """The workflow at a small size: a small input PNG in the input dir,
    ImageScale to size^2, a few steps (denoise stays 0.6)."""
    px = (np.random.default_rng(12).uniform(size=(40, 56, 3)) * 255) \
        .astype(np.uint8)
    Image.fromarray(px, "RGB").save(tmp_path / "input.png")
    doc = json.loads(WORKFLOW.read_text())
    doc["2"]["inputs"].update(width=size, height=size)
    doc["3"]["inputs"]["steps"] = steps
    return doc


@pytest.fixture
def tiny_family(monkeypatch):
    monkeypatch.setenv("DTPU_DEFAULT_FAMILY", "tiny")
    yield
    treg.clear_pipeline_cache()


def test_img2img_workflow_matches_jax_executor(tiny_family, tmp_path):
    doc = _small_doc(tmp_path)
    assert doc["3"]["inputs"]["denoise"] == 0.6
    ours = WorkflowExecutor(OpContext(device="cpu", input_dir=str(tmp_path))) \
        .execute(copy.deepcopy(doc))
    ref = JaxExecutor(JaxOpContext(input_dir=str(tmp_path))).execute(
        copy.deepcopy(doc))
    ref.wait_host()
    a, b = ours.image_batch, ref.image_batch
    assert a.shape == b.shape == (1, 48, 48, 3)
    assert np.isfinite(a).all() and a.std() > 0
    np.testing.assert_allclose(a, b, rtol=0, atol=IMAGE_ATOL)
    assert set(ours.timings) == set(doc) - {"__doc__"}
    lat = ours.outputs["5"][0]["samples"].data
    assert lat.shape == (1, 24, 24, 4) and lat.device.type == "cpu"


def test_cli_run_reads_the_input_dir(tiny_family, tmp_path, capsys):
    doc = _small_doc(tmp_path, size=32, steps=2)
    wf = tmp_path / "wf.json"
    wf.write_text(json.dumps(doc))
    out = tmp_path / "out"
    assert cli.main(["run", str(wf), "--out", str(out), "--input-dir",
                     str(tmp_path), "--device", "cpu"]) == 0
    summary = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert summary["images"] == 1
    png = decode_png((out / "run_00000.png").read_bytes())
    assert png.shape == (1, 32, 32, 3)
