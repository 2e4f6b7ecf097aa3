"""The inpaint slice of the port against the JAX package:
``workflows/distributed-inpaint.json``, ``distributed-outpaint.json`` and
``distributed-inpaint-model.json`` with their ops (LoadImageMask,
ImagePadForOutpaint, VAEEncodeForInpaint, InpaintModelConditioning,
SetLatentNoiseMask), the sampler inputs they make and the 9-channel
``sd15_inpaint``/``tiny_inpaint`` families; the masked sampler itself is
``tests/test_torch_port_inpaint_sampling.py``.

Both packages get the same numpy inputs and the same virtual weights.
Mask arithmetic is exact (1e-6, the grown mask to the bit); modules at
fp32 agree within 2e-4; whole workflows on the tiny family, from the
same RGBA input files, agree within 2e-3, and where the latent mask is 0
the sampled latent is the encoded source to the bit."""

import copy
import dataclasses
import json
import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image
from scipy import ndimage

from comfyui_distributed_tpu.models import checkpoints as jckpt
from comfyui_distributed_tpu.models import registry as jreg
from comfyui_distributed_tpu.ops import basic as jbasic
from comfyui_distributed_tpu.ops.base import Conditioning as JaxCond
from comfyui_distributed_tpu.ops.base import OpContext as JaxOpContext
from comfyui_distributed_tpu.ops.base import get_op as jax_get_op
from comfyui_distributed_tpu.workflow import WorkflowExecutor as JaxExecutor
from comfyui_distributed_tpu_torch.models import checkpoints as tckpt
from comfyui_distributed_tpu_torch.models import registry as treg
from comfyui_distributed_tpu_torch.models.weights import from_flax
from comfyui_distributed_tpu_torch.ops import basic as tbasic
from comfyui_distributed_tpu_torch.ops.base import Conditioning, OpContext
from comfyui_distributed_tpu_torch.ops.base import get_op
from comfyui_distributed_tpu_torch.utils.image import encode_png
from comfyui_distributed_tpu_torch.workflow import WorkflowExecutor

ROOT = pathlib.Path(__file__).resolve().parents[1]
TOL = dict(rtol=2e-4, atol=2e-4)
EXACT = dict(rtol=0, atol=1e-6)
IMAGE_ATOL = 2e-3
INPAINT_CKPT = "tiny-inpaint.ckpt"
PLAIN_CKPT = "tiny-plain.safetensors"


def _np(x):
    if hasattr(x, "to_host"):
        return x.to_host()
    if isinstance(x, torch.Tensor):
        return x.detach().float().cpu().numpy()
    return np.asarray(x, np.float32)


def _rng(seed):
    return np.random.default_rng(seed)


def _pipes(family):
    name = INPAINT_CKPT if family == "tiny_inpaint" else PLAIN_CKPT
    return (jreg.load_pipeline(name, family_name=family),
            treg.load_pipeline(name, family_name=family, device="cpu"))


def _np_tree(tree):
    import jax
    return jax.tree_util.tree_map(np.asarray, tree)


# --- the families ---------------------------------------------------------------

@pytest.mark.parametrize("family", ["sd15_inpaint", "tiny_inpaint"])
def test_inpaint_family_is_the_jax_packages(family):
    j, t = jreg.FAMILIES[family], treg.FAMILIES[family]
    assert t.unet.in_channels == j.unet.in_channels == 9
    assert t.unet.out_channels == j.unet.out_channels == 4
    base = "sd15" if family == "sd15_inpaint" else "tiny"
    assert dataclasses.replace(t.unet, in_channels=4) \
        == treg.FAMILIES[base].unet
    for field in ("model_channels", "channel_mult", "num_res_blocks",
                  "transformer_depth", "context_dim", "num_head_channels",
                  "num_heads"):
        assert getattr(t.unet, field) == getattr(j.unet, field), field
    assert t.vae == treg.FAMILIES[base].vae
    assert [c.width for c in t.clips] == [c.width for c in j.clips]
    name = "sd-v1-5-inpainting.ckpt" if family == "sd15_inpaint" \
        else "tiny-inpaint.ckpt"
    assert treg.detect_family(name) == jreg.detect_family(name) == family


@pytest.mark.parametrize("family", ["sdxl_inpaint", "sd21_inpaint"])
def test_other_inpaint_families_stay_refused(family):
    """Once refused, the SDXL and SD2.1 inpaint families are now the
    JAX package's: the base family's UNet at 9 input channels, field by
    field, with its VAE and text towers."""
    j, t = jreg.FAMILIES[family], treg.get_family(family)
    base = "sdxl" if family == "sdxl_inpaint" else "sd21_base"
    assert t.unet.in_channels == j.unet.in_channels == 9
    assert dataclasses.replace(t.unet, in_channels=4) \
        == treg.FAMILIES[base].unet
    for f in dataclasses.fields(j.unet):
        if hasattr(t.unet, f.name) and f.name != "dtype":
            assert getattr(t.unet, f.name) == getattr(j.unet, f.name), f.name
    assert str(t.unet.dtype).split(".")[-1] == j.unet.dtype.__name__
    assert t.vae == treg.FAMILIES[base].vae
    assert [c.width for c in t.clips] == [c.width for c in j.clips]
    assert (t.latent_channels, t.adm_kind) == (j.latent_channels,
                                               j.adm_kind)


def test_tiny_inpaint_virtual_weights_equal_the_jax_packages():
    """The 9-channel conv_in is drawn at [3, 3, 9, C] in flax layout,
    as the JAX package initialises with the UNet's input width."""
    jp, tp = _pipes("tiny_inpaint")
    sd_unet, sd_clips, sd_vae = from_flax(
        treg.FAMILIES["tiny_inpaint"], _np_tree(jp.unet_params),
        [_np_tree(p) for p in jp.clip_params], _np_tree(jp.vae_params))
    assert tuple(tp.unet.conv_in.weight.shape)[1] == 9
    assert np.asarray(jp.unet_params["conv_in"]["kernel"]).shape[2] == 9
    for module, sd in [(tp.unet, sd_unet), (tp.vae, sd_vae)] + list(
            zip(tp.clip_models, sd_clips)):
        own = module.state_dict()
        assert set(own) == set(sd)
        for k, v in sd.items():
            assert torch.equal(own[k], v), k


def test_nine_channel_file_round_trips_in_both_packages(tmp_path):
    """The port writes the 9-channel UNet's conv_in as
    ``model.diffusion_model.input_blocks.0.0.weight`` [C, 9, 3, 3];
    both packages' loaders read the file back to the virtual weights."""
    jp, tp = _pipes("tiny_inpaint")
    path = tmp_path / INPAINT_CKPT.replace(".ckpt", ".safetensors")
    (out_dir := tmp_path / "out").mkdir()
    get_op("CheckpointSave").execute(
        OpContext(device="cpu", output_dir=str(out_dir)), tp, tp, tp,
        filename_prefix="inpaint")
    (out_dir / "inpaint.safetensors").rename(path)
    sd = tckpt.load_state_dict(str(path))
    w = sd["model.diffusion_model.input_blocks.0.0.weight"]
    assert tuple(w.shape) == (tp.family.unet.model_channels, 9, 3, 3)
    assert tckpt.unconsumed_keys(sd, tp.family) == []
    fam = treg.FAMILIES["tiny_inpaint"]
    got_u, _, _ = tckpt.load_checkpoint(str(path), fam)
    for k, v in tp.unet.state_dict().items():
        assert torch.equal(got_u[k].to(v.dtype), v), k
    ju, jc, jv = jckpt.load_checkpoint(str(path), jreg.FAMILIES[
        "tiny_inpaint"])
    want_u, _, _ = from_flax(fam, ju, jc, jv)
    for k, v in want_u.items():
        assert torch.equal(v, tp.unet.state_dict()[k].float()), k


# --- mask ops ------------------------------------------------------------------

def _write_png(path, kind, h=30, w=40, seed=3):
    """An 8-bit file of ``kind`` (RGBA with an alpha hole and soft edge,
    RGB or L), written by PIL."""
    rng = _rng(seed)
    if kind == "L":
        Image.fromarray(rng.integers(0, 256, (h, w), dtype=np.uint8),
                        "L").save(path)
        return
    px = rng.integers(0, 256, (h, w, 4), dtype=np.uint8)
    px[..., 3] = 255
    px[h // 4:h // 2, w // 3:2 * w // 3, 3] = 0
    px[h // 2, :, 3] = 128
    if kind == "RGB":
        Image.fromarray(px[..., :3], "RGB").save(path)
    else:
        Image.fromarray(px, "RGBA").save(path)


@pytest.mark.parametrize("channel", ["alpha", "red", "green", "blue"])
@pytest.mark.parametrize("kind", ["RGBA", "RGB", "L", "missing"])
def test_load_image_mask_matches_jax(tmp_path, kind, channel):
    if kind != "missing":
        _write_png(tmp_path / "m.png", kind)
    (t,) = get_op("LoadImageMask").execute(
        OpContext(device="cpu", input_dir=str(tmp_path)), "m.png", channel)
    (j,) = jax_get_op("LoadImageMask").execute(
        JaxOpContext(input_dir=str(tmp_path)), "m.png", channel)
    assert tuple(t.shape) == np.asarray(j).shape
    np.testing.assert_allclose(_np(t), np.asarray(j), **EXACT)
    if kind != "RGBA" and channel == "alpha":
        assert float(t.abs().max()) == 0.0
    if kind == "RGBA" and channel == "alpha":
        assert float(t.max()) == 1.0


@pytest.mark.parametrize("pad,feathering", [
    (dict(left=12), 5), (dict(top=9), 5), (dict(right=16), 5),
    (dict(bottom=7), 5), (dict(left=4, top=6, right=8, bottom=10), 6),
    (dict(right=16, bottom=4), 0), (dict(left=8, right=8), 15),
    (dict(top=3), 11)])
def test_image_pad_for_outpaint_matches_jax(pad, feathering):
    """Each side alone and several together; feathering 0; 15 and 11,
    which do not fit twice into the 28 x 30 image (no feather)."""
    img = _rng(4).uniform(size=(2, 28, 30, 3)).astype(np.float32)
    args = dict(feathering=feathering, **pad)
    t_img, t_mask = get_op("ImagePadForOutpaint").execute(
        OpContext(device="cpu"), img, **args)
    j_img, j_mask = jax_get_op("ImagePadForOutpaint").execute(
        JaxOpContext(), img, **args)
    np.testing.assert_allclose(_np(t_img), np.asarray(j_img), **EXACT)
    np.testing.assert_allclose(_np(t_mask), np.asarray(j_mask), **EXACT)
    assert t_mask.ndim == 2


@pytest.mark.parametrize("grow", [1, 2, 6, 8])
@pytest.mark.parametrize("soft", [False, True])
def test_grown_mask_equals_scipy_maximum_filter(grow, soft):
    rng = _rng(grow)
    m = rng.uniform(size=(2, 37, 50)).astype(np.float32)
    m = m if soft else (m > 0.93).astype(np.float32)
    want = np.stack([ndimage.maximum_filter(mi, size=2 * grow + 1)
                     for mi in m])
    got = tbasic.grow_mask(torch.from_numpy(m), grow).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("mask_hw,grow", [((16, 20), 2), ((12, 15), 0),
                                          ((9, 25), 3)])
def test_vae_encode_for_inpaint_matches_jax(mask_hw, grow):
    """The mask resized bilinear to the pixels when its size differs,
    grown, the pixels neutralised under it, then encoded."""
    jp, tp = _pipes("tiny")
    rng = _rng(5)
    img = rng.uniform(size=(1, 16, 20, 3)).astype(np.float32)
    mask = (rng.uniform(size=(1,) + mask_hw) > 0.8).astype(np.float32)
    (t,) = get_op("VAEEncodeForInpaint").execute(
        OpContext(device="cpu"), img, tp, torch.from_numpy(mask), grow)
    (j,) = jax_get_op("VAEEncodeForInpaint").execute(
        JaxOpContext(), img, jp, mask, grow)
    np.testing.assert_allclose(_np(t["noise_mask"]),
                               np.asarray(j["noise_mask"]), **EXACT)
    np.testing.assert_allclose(_np(t["samples"]), np.asarray(j["samples"]),
                               **TOL)
    assert _np(t["noise_mask"]).shape == (1, 16, 20)


@pytest.mark.parametrize("noise_mask", [True, False])
def test_inpaint_model_conditioning_matches_jax(noise_mask):
    jp, tp = _pipes("tiny_inpaint")
    rng = _rng(6)
    img = rng.uniform(size=(1, 16, 16, 3)).astype(np.float32)
    mask = np.zeros((1, 12, 12), np.float32)
    mask[:, 3:9, 4:10] = 1.0
    pos, _ = tp.encode_prompt(["a stone bridge"])
    neg, _ = tp.encode_prompt(["blurry"])
    tpos, tneg, tlat = get_op("InpaintModelConditioning").execute(
        OpContext(device="cpu"), Conditioning(pos), Conditioning(neg), tp,
        img, torch.from_numpy(mask), noise_mask)
    jpos, jneg, jlat = jax_get_op("InpaintModelConditioning").execute(
        JaxOpContext(), JaxCond(context=pos.numpy()),
        JaxCond(context=neg.numpy()), jp, img, mask, noise_mask)
    assert tpos.concat_latent is tneg.concat_latent
    assert tuple(tpos.concat_latent.shape) == (1, 8, 8, 5)
    np.testing.assert_allclose(_np(tpos.concat_latent),
                               np.asarray(jpos.concat_latent), **TOL)
    np.testing.assert_allclose(_np(tlat["samples"]),
                               np.asarray(jlat["samples"]), **TOL)
    assert ("noise_mask" in tlat) == ("noise_mask" in jlat) == noise_mask
    if noise_mask:
        np.testing.assert_allclose(_np(tlat["noise_mask"]),
                                   np.asarray(jlat["noise_mask"]), **EXACT)


def test_set_latent_noise_mask_and_latent_ops_keep_it():
    """The new mask replaces one already on the latent; the samplers and
    the latent upscales carry it on."""
    old = torch.zeros(1, 16, 16)
    lat = {"samples": torch.zeros(1, 8, 8, 4), "noise_mask": old}
    (out,) = get_op("SetLatentNoiseMask").execute(
        OpContext(device="cpu"), lat, torch.ones(16, 16))
    assert tuple(out["noise_mask"].shape) == (1, 16, 16)
    assert float(out["noise_mask"].sum()) == 256.0
    (up,) = get_op("LatentUpscaleBy").execute(OpContext(device="cpu"), out,
                                              "bilinear", 2.0)
    assert up["noise_mask"] is out["noise_mask"]
    (up2,) = get_op("LatentUpscale").execute(
        OpContext(device="cpu"), out, "nearest-exact", 128, 96, "disabled")
    assert up2["noise_mask"] is out["noise_mask"]


def test_prepare_sample_inputs_mask_and_concat_match_jax():
    """A batch of 3: a mask of 2 rows cycles, an image-size mask goes
    area-down to the latent, a concat of another size resizes bilinear
    and cycles."""
    jp, tp = _pipes("tiny_inpaint")
    rng = _rng(7)
    lat = rng.standard_normal((3, 6, 10, 4)).astype(np.float32)
    mask = rng.uniform(size=(2, 13, 19)).astype(np.float32)
    concat = rng.standard_normal((2, 4, 5, 5)).astype(np.float32)
    ctx, _ = tp.encode_prompt(["x"])
    tcond = Conditioning(ctx, concat_latent=torch.from_numpy(concat))
    jcond = JaxCond(context=ctx.numpy(), concat_latent=concat)
    latent = {"samples": lat, "noise_mask": mask}
    t = tbasic._prepare_sample_inputs(tp, 3, latent, Conditioning(ctx),
                                      tcond)
    j = jbasic._prepare_sample_inputs(JaxOpContext(), jp, 3, latent,
                                      JaxCond(context=ctx.numpy()), jcond)
    assert tuple(t.noise_mask.shape) == (3, 6, 10, 1)
    np.testing.assert_allclose(_np(t.noise_mask), np.asarray(j.noise_mask),
                               **EXACT)
    assert tuple(t.c_concat.shape) == (3, 6, 10, 5)
    np.testing.assert_allclose(_np(t.c_concat), np.asarray(j.c_concat),
                               **EXACT)
    single = tbasic._prepare_sample_inputs(
        tp, 3, {"samples": lat, "noise_mask": mask[:1]}, tcond, tcond)
    assert tuple(single.noise_mask.shape) == (1, 6, 10, 1)


# --- the three workflows ---------------------------------------------------------

def _rgba_card(h, w, hole, seed):
    """[H, W, 4] in [0, 1]: random colours, alpha 0 in the ``hole``
    rectangle (y0, y1, x0, x1) and 1 elsewhere."""
    img = _rng(seed).uniform(size=(h, w, 4)).astype(np.float32)
    img[..., 3] = 1.0
    y0, y1, x0, x1 = hole
    img[y0:y1, x0:x1, 3] = 0.0
    return img


def write_inputs(input_dir, scale=1):
    """The RGBA files the three workflows read, written by the port:
    ``input.png`` (at ``scale`` 8: 640 x 480, a card with a transparent
    rectangle) and ``source.png`` (at 8: 512^2 with a transparent
    hole)."""
    d = pathlib.Path(input_dir)
    (d / "input.png").write_bytes(encode_png(_rgba_card(
        60 * scale, 80 * scale,
        (18 * scale, 42 * scale, 30 * scale, 56 * scale), 21)))
    (d / "source.png").write_bytes(encode_png(_rgba_card(
        64 * scale, 64 * scale,
        (20 * scale, 44 * scale, 16 * scale, 40 * scale), 22)))


def tiny_docs():
    """The three workflows at the tiny family's size: 64 px (the
    outpaint canvas 96 x 64), 3 steps, feathering 12 (40 does not fit
    twice into 64)."""
    docs = {k: json.loads((ROOT / "workflows" / f"distributed-{f}.json")
                          .read_text())
            for k, f in (("inpaint", "inpaint"), ("outpaint", "outpaint"),
                         ("inpaint_model", "inpaint-model"))}
    docs["inpaint"]["2"]["inputs"].update(width=64, height=64)
    docs["inpaint"]["3"]["inputs"]["steps"] = 3
    docs["outpaint"]["2"]["inputs"].update(width=64, height=64)
    docs["outpaint"]["10"]["inputs"].update(right=32, feathering=12)
    docs["outpaint"]["3"]["inputs"]["steps"] = 3
    docs["inpaint_model"]["8"]["inputs"]["steps"] = 3
    return docs


FAMILY = {"inpaint": "tiny", "outpaint": "tiny",
          "inpaint_model": "tiny_inpaint"}
# (sampler node, the node whose latent it samples, image shape)
NODES = {"inpaint": ("3", "5", (1, 64, 64, 3)),
         "outpaint": ("3", "5", (1, 64, 96, 3)),
         "inpaint_model": ("8", "6", (1, 64, 64, 3))}


@pytest.mark.parametrize("which", ["inpaint", "outpaint", "inpaint_model"])
def test_workflow_matches_the_jax_executor(which, tmp_path, monkeypatch):
    monkeypatch.setenv("DTPU_DEFAULT_FAMILY", FAMILY[which])
    write_inputs(tmp_path)
    doc = tiny_docs()[which]
    jreg.clear_pipeline_cache()
    treg.clear_pipeline_cache()
    try:
        ours = WorkflowExecutor(OpContext(
            device="cpu", input_dir=str(tmp_path),
            output_dir=str(tmp_path / "t"))).execute(copy.deepcopy(doc))
        ref = JaxExecutor(JaxOpContext(
            input_dir=str(tmp_path), output_dir=str(tmp_path / "j"))
        ).execute(copy.deepcopy(doc))
        ref.wait_host()
    finally:
        jreg.clear_pipeline_cache()
        treg.clear_pipeline_cache()
    a, b = ours.image_batch, ref.image_batch
    ks, enc, shape = NODES[which]
    assert a.shape == b.shape == shape
    assert np.isfinite(a).all() and a.std() > 0
    np.testing.assert_allclose(a, b, rtol=0, atol=IMAGE_ATOL)
    assert set(ours.timings) == set(doc) - {"__doc__"}
    # anchoring: where the latent mask is 0 the sampled latent is the
    # encoded source to the bit, where it is 1 it was resampled
    out = ours.outputs[ks][0]
    source = ours.outputs[enc][-1]["samples"].to_host()
    sampled = out["samples"].to_host()
    m = tbasic.image_mask_to_latent(tbasic.as_mask(out["noise_mask"], "cpu"),
                                    *sampled.shape[1:3], 1).numpy()[..., 0]
    m = np.broadcast_to(m[..., None], sampled.shape)
    assert (m == 0).any() and (m == 1).any()
    np.testing.assert_array_equal(sampled[m == 0], source[m == 0])
    assert not np.allclose(sampled[m == 1], source[m == 1])
    if which == "inpaint_model":
        assert ours.outputs["1"][0].family.name == "tiny_inpaint"
        assert tuple(ours.outputs["6"][0].concat_latent.shape) \
            == (1, 32, 32, 5)
        assert len(list((tmp_path / "t").glob("inpaint_model_*.png"))) == 1
