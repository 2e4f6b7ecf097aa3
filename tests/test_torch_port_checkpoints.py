"""The port's checkpoint files against the JAX package's: the safetensors
format both ways against the ``safetensors`` package, single-file SD
checkpoints written by the JAX package loaded to exactly the JAX
loader's values (and the port's exports read back by the JAX loader),
the three ESRGAN namings, the registry's loaders and CheckpointSave, and
tiny txt2img from a file against the JAX executor."""

import copy
import dataclasses
import json
import os
import pathlib
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch
from safetensors.torch import load_file, save_file

from comfyui_distributed_tpu.models import checkpoints as jckpt
from comfyui_distributed_tpu.models import clip as jclip
from comfyui_distributed_tpu.models import registry as jreg
from comfyui_distributed_tpu.models import unet as junet
from comfyui_distributed_tpu.models import upscalers as jup
from comfyui_distributed_tpu.models import vae as jvae
from comfyui_distributed_tpu.ops.base import OpContext as JaxOpContext
from comfyui_distributed_tpu.workflow import WorkflowExecutor as JaxExecutor
from comfyui_distributed_tpu_torch.models import checkpoints as ckpt
from comfyui_distributed_tpu_torch.models import clip as tclip
from comfyui_distributed_tpu_torch.models import registry as treg
from comfyui_distributed_tpu_torch.models import unet as tunet
from comfyui_distributed_tpu_torch.models import upscalers as tup
from comfyui_distributed_tpu_torch.models import vae as tvae
from comfyui_distributed_tpu_torch.models.weights import from_flax
from comfyui_distributed_tpu_torch.ops.base import OpContext, get_op
from comfyui_distributed_tpu_torch.workflow import WorkflowExecutor
from test_checkpoints import _rrdb_torch_sd

ROOT = pathlib.Path(__file__).resolve().parents[1]
# pixels in [0, 1]: the two executors on the same weights
IMAGE_ATOL = 2e-3

# the two-tower tiny family of tests/test_checkpoints.py in both
# packages: an ADM head, one HF tower and one OpenCLIP tower with a
# packed qkv and a text projection
JAX_XL = jreg.ModelFamily(
    name="tiny_xl",
    unet=dataclasses.replace(junet.TINY_CONFIG, adm_in_channels=32),
    vae=jvae.TINY_VAE_CONFIG,
    clips=(jclip.TINY_CLIP_CONFIG,
           dataclasses.replace(jclip.TINY_CLIP_CONFIG, projection_dim=48,
                               layout="openclip")))
TORCH_XL = treg.ModelFamily(
    name="tiny_xl",
    unet=dataclasses.replace(tunet.TINY_CONFIG, adm_in_channels=32),
    vae=tvae.TINY_VAE_CONFIG,
    clips=(tclip.TINY_CLIP_CONFIG,
           dataclasses.replace(tclip.TINY_CLIP_CONFIG, projection_dim=48,
                               layout="openclip")))
FAMILIES = {"tiny": (jreg.FAMILIES["tiny"], treg.FAMILIES["tiny"]),
            "tiny_xl": (JAX_XL, TORCH_XL)}


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _jax_params(jfam, seed=3):
    """Virtual JAX parameters of ``jfam`` (the JAX registry's rule)."""
    import jax.numpy as jnp
    ds = jfam.vae.downscale
    x = jnp.zeros((1, 8, 8, jfam.unet.in_channels))
    unet = jreg._virtual_params(junet.UNet(jfam.unet), seed, x,
                                jnp.zeros((1,)),
                                jnp.zeros((1, 77, jfam.unet.context_dim)))
    clips = [jreg._virtual_params(jclip.CLIPTextModel(c), seed + 1 + i,
                                  jnp.zeros((1, 77), jnp.int32))
             for i, c in enumerate(jfam.clips)]
    vae = jreg._virtual_params(jvae.VAE(jfam.vae), seed + 100,
                               jnp.zeros((1, 8 * ds, 8 * ds, 3)))
    return _np(unet), [_np(c) for c in clips], _np(vae)


def _assert_state_equal(got, want):
    assert set(got) == set(want)
    for k, v in want.items():
        assert torch.equal(got[k].to(v.dtype), v), k


# --- the file format ------------------------------------------------------------

@pytest.mark.parametrize("dtype", [torch.float16, torch.bfloat16,
                                   torch.float32])
def test_safetensors_both_ways_with_the_package(tmp_path, dtype):
    g = torch.Generator().manual_seed(0)
    tensors = {"a.weight": torch.randn(5, 3, generator=g).to(dtype),
               "b": torch.randn(7, generator=g).to(dtype),
               "c.odd": torch.randn(3, 1, 1, generator=g).to(dtype),
               "ids": torch.arange(6, dtype=torch.int64).reshape(2, 3),
               "empty": torch.zeros(0, 4, dtype=dtype)}
    ours = tmp_path / "ours.safetensors"
    ckpt.write_safetensors(tensors, str(ours))
    theirs = tmp_path / "theirs.safetensors"
    save_file(tensors, str(theirs), metadata={"format": "pt"})
    for got in (load_file(str(ours)), ckpt.read_safetensors(str(theirs)),
                ckpt.read_safetensors(str(ours))):
        assert set(got) == set(tensors)
        for k, v in tensors.items():
            assert got[k].dtype == v.dtype and got[k].shape == v.shape, k
            assert torch.equal(got[k].view(-1).view(torch.uint8)
                               if v.numel() else got[k],
                               v.view(-1).view(torch.uint8)
                               if v.numel() else v), k


def test_safetensors_refuses_a_truncated_file_and_unknown_dtype(tmp_path):
    path = tmp_path / "t.safetensors"
    save_file({"w": torch.ones(64, 64)}, str(path))
    data = path.read_bytes()
    (tmp_path / "short.safetensors").write_bytes(data[:-100])
    with pytest.raises(ValueError, match="truncated"):
        ckpt.read_safetensors(str(tmp_path / "short.safetensors"))
    (tmp_path / "stub.safetensors").write_bytes(data[:5])
    with pytest.raises(ValueError, match="truncated"):
        ckpt.read_safetensors(str(tmp_path / "stub.safetensors"))
    n = int.from_bytes(data[:8], "little")
    header = json.loads(data[8:8 + n])
    header["w"]["dtype"] = "F8_E9M9"
    blob = json.dumps(header).encode()
    (tmp_path / "odd.safetensors").write_bytes(
        len(blob).to_bytes(8, "little") + blob + data[8 + n:])
    with pytest.raises(ValueError, match="unknown dtype"):
        ckpt.read_safetensors(str(tmp_path / "odd.safetensors"))


def test_the_port_imports_neither_safetensors_nor_jax():
    code = ("import sys\n"
            "import comfyui_distributed_tpu_torch.models.registry\n"
            "import comfyui_distributed_tpu_torch.models.checkpoints\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('safetensors', 'jax', 'comfyui_distributed_tpu')]\n"
            "assert not bad, bad\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


# --- single-file SD checkpoints ----------------------------------------------------

@pytest.mark.parametrize("variant", ["tiny", "tiny_xl", "tiny_fp16"])
def test_jax_written_checkpoint_loads_to_the_jax_loaders_values(tmp_path,
                                                                variant):
    jfam, tfam = FAMILIES["tiny" if variant == "tiny_fp16" else variant]
    unet_p, clip_ps, vae_p = _jax_params(jfam)
    path = str(tmp_path / "m.safetensors")
    if variant == "tiny_fp16":
        sd = jckpt.export_state_dict(unet_p, clip_ps, vae_p, jfam)
        jckpt.save_state_dict({k: v.astype(np.float16)
                               for k, v in sd.items()}, path)
    else:
        jckpt.save_checkpoint(path, unet_p, clip_ps, vae_p, jfam)
    ju, jc, jv = jckpt.load_checkpoint(path, jfam)
    want_u, want_c, want_v = from_flax(tfam, ju, jc, jv)
    got_u, got_c, got_v = ckpt.load_checkpoint(path, tfam)
    _assert_state_equal(got_u, want_u)
    _assert_state_equal(got_v, want_v)
    for g, w in zip(got_c, want_c):
        _assert_state_equal(g, w)
    if variant == "tiny_fp16":
        assert next(iter(got_u.values())).dtype == torch.float16


@pytest.mark.parametrize("family", ["tiny", "tiny_xl"])
def test_port_export_reads_back_in_the_jax_loader(tmp_path, family):
    """The port's writer and export walk: the JAX loader reads the
    file's tensors as the JAX package's own parameters."""
    jfam, tfam = FAMILIES[family]
    unet_p, clip_ps, vae_p = _jax_params(jfam, seed=11)
    sd_u, sd_c, sd_v = from_flax(tfam, unet_p, clip_ps, vae_p)
    modules = []
    for make, sd in ([(lambda: tunet.UNet(tfam.unet), sd_u),
                      (lambda: tvae.VAE(tfam.vae), sd_v)]
                     + [(lambda c=c: tclip.CLIPTextModel(c), s)
                        for c, s in zip(tfam.clips, sd_c)]):
        m = make()
        m.load_state_dict(sd)
        modules.append(m)
    unet, vae, *clips = modules
    path = str(tmp_path / "export.safetensors")
    ckpt.save_checkpoint(path, unet, clips, vae, tfam)
    jsd = jckpt.load_state_dict(path)
    assert set(jsd) == set(jckpt.export_state_dict(unet_p, clip_ps, vae_p,
                                                   jfam))
    ju, jc, jv = jckpt.convert_state_dict(jsd, jfam)
    for a, b in zip(jax.tree_util.tree_leaves((ju, jc, jv)),
                    jax.tree_util.tree_leaves((unet_p, clip_ps, vae_p))):
        np.testing.assert_array_equal(a, b)


def test_bf16_checkpoint_round_trips_within_the_port(tmp_path):
    """bf16 storage (the real families' UNet and CLIP) written and read
    back by the port, bit for bit (the JAX reader cannot open BF16
    through numpy)."""
    pipe = treg.load_pipeline("tiny-bf16.safetensors", family_name="tiny",
                              device="cpu")
    unet = pipe.unet.to(torch.bfloat16)
    clips = [c.to(torch.bfloat16) for c in pipe.clip_models]
    fam = treg.FAMILIES["tiny"]
    path = str(tmp_path / "bf16.safetensors")
    ckpt.save_checkpoint(path, unet, clips, pipe.vae, fam)
    got_u, got_c, got_v = ckpt.load_checkpoint(path, fam)
    _assert_state_equal(got_u, unet.state_dict())
    assert all(v.dtype == torch.bfloat16 for v in got_u.values())
    _assert_state_equal(got_c[0], clips[0].state_dict())
    _assert_state_equal(got_v, pipe.vae.state_dict())
    treg.clear_pipeline_cache()


def test_unconsumed_keys_and_missing_keys_as_in_jax(tmp_path):
    jfam, tfam = FAMILIES["tiny_xl"]
    unet_p, clip_ps, vae_p = _jax_params(jfam)
    sd = jckpt.export_state_dict(unet_p, clip_ps, vae_p, jfam)
    sd.update({"alphas_cumprod": np.ones(4, np.float32),
               "model_ema.decay": np.ones((), np.float32),
               "conditioner.embedders.1.model.logit_scale":
                   np.ones((), np.float32),
               "model.diffusion_model.stray.weight": np.ones(3, np.float32),
               "lora_unet_x.alpha": np.ones((), np.float32)})
    tsd = {k: torch.from_numpy(np.array(v)) for k, v in sd.items()}
    assert ckpt.unconsumed_keys(tsd, tfam) == \
        jckpt.unconsumed_keys(sd, jfam) == \
        ["lora_unet_x.alpha", "model.diffusion_model.stray.weight"]
    del tsd["model.diffusion_model.time_embed.0.weight"]
    with pytest.raises(KeyError, match="time_embed.0.weight"):
        ckpt.convert_state_dict(tsd, tfam)


@pytest.mark.parametrize("scale", [1, 2, 4])
@pytest.mark.parametrize("naming", ["realesrgan", "xinntao", "oldarch"])
def test_esrgan_namings_load(tmp_path, naming, scale):
    import jax.numpy as jnp
    jcfg = dataclasses.replace(jup.TINY_RRDB_CONFIG, scale=scale)
    tcfg = dataclasses.replace(tup.TINY_RRDB_CONFIG, scale=scale)
    params = _np(jup.RRDBNet(jcfg).init(jax.random.PRNGKey(0),
                                        jnp.zeros((1, 8, 8, 3)))["params"])
    sd = _rrdb_torch_sd(params, naming, scale=scale,
                        num_blocks=jcfg.num_blocks)
    path = str(tmp_path / "up.pth")
    torch.save({k: torch.from_numpy(np.array(v)) for k, v in sd.items()},
               path)
    from comfyui_distributed_tpu_torch.models.weights import rrdb_from_flax
    want = rrdb_from_flax(tcfg, jckpt.load_upscaler_checkpoint(path, jcfg))
    _assert_state_equal(ckpt.load_upscaler_checkpoint(path, tcfg), want)


# --- the registry and the ops ------------------------------------------------------

def test_registry_loads_files_and_fills_missing_names(tmp_path, monkeypatch):
    monkeypatch.setenv("DTPU_DEFAULT_FAMILY", "tiny")
    jfam, tfam = FAMILIES["tiny"]
    unet_p, clip_ps, vae_p = _jax_params(jfam, seed=21)
    jckpt.save_checkpoint(str(tmp_path / "real.ckpt.safetensors"), unet_p,
                          clip_ps, vae_p, jfam)
    want_u, _, want_v = from_flax(tfam, unet_p, clip_ps, vae_p)
    # the same tensors in a pickled .ckpt with a state_dict wrapper
    sd = load_file(str(tmp_path / "real.ckpt.safetensors"))
    torch.save({"state_dict": sd, "global_step": 7},
               str(tmp_path / "real.ckpt"))
    treg.clear_pipeline_cache()
    try:
        for name in ("real.ckpt.safetensors", "real.ckpt"):
            pipe = treg.load_pipeline(name, models_dir=str(tmp_path),
                                      device="cpu")
            _assert_state_equal(pipe.unet.state_dict(), want_u)
            _assert_state_equal(pipe.vae.state_dict(), want_v)
        virtual = treg.load_pipeline("absent.safetensors",
                                     models_dir=str(tmp_path), device="cpu")
        assert not torch.equal(virtual.unet.conv_in.weight,
                               want_u["conv_in.weight"])
        # an upscaler file (old-arch .pth) loads too, and an incomplete
        # one raises with the missing key
        import jax.numpy as jnp
        from comfyui_distributed_tpu_torch.models.weights import \
            rrdb_from_flax
        params = _np(jup.RRDBNet(jup.TINY_RRDB_CONFIG).init(
            jax.random.PRNGKey(1), jnp.zeros((1, 8, 8, 3)))["params"])
        sd = {k: torch.from_numpy(np.array(v)) for k, v in _rrdb_torch_sd(
            params, "oldarch", scale=2, num_blocks=2).items()}
        torch.save(sd, str(tmp_path / "4x-tiny.pth"))
        up = treg.load_upscaler("4x-tiny.pth", models_dir=str(tmp_path),
                                device="cpu")
        assert up.scale == 2
        _assert_state_equal(up.net.state_dict(),
                            rrdb_from_flax(tup.TINY_RRDB_CONFIG, params))
        del sd["model.0.weight"]
        torch.save(sd, str(tmp_path / "4x-broken.pth"))
        with pytest.raises(KeyError, match="conv_first"):
            treg.load_upscaler("4x-broken.pth", models_dir=str(tmp_path),
                               device="cpu")
    finally:
        treg.clear_pipeline_cache()


def test_checkpoint_save_op_writes_what_the_loader_reads(tmp_path,
                                                         monkeypatch):
    monkeypatch.setenv("DTPU_DEFAULT_FAMILY", "tiny")
    treg.clear_pipeline_cache()
    try:
        ctx = OpContext(device="cpu", output_dir=str(tmp_path))
        (pipe, _, _) = get_op("CheckpointLoaderSimple").execute(
            ctx, "tiny-save.safetensors")
        assert get_op("CheckpointSave").execute(
            ctx, pipe, pipe, pipe, filename_prefix="checkpoints/mine") == ()
        path = tmp_path / "checkpoints" / "mine.safetensors"
        assert path.exists()
        again = treg.load_pipeline("mine.safetensors",
                                   models_dir=str(path.parent),
                                   device="cpu")
        for a, b in ((again.unet, pipe.unet), (again.vae, pipe.vae),
                     (again.clip_models[0], pipe.clip_models[0])):
            _assert_state_equal(a.state_dict(), b.state_dict())
        with pytest.raises(ValueError, match="escapes"):
            get_op("CheckpointSave").execute(ctx, pipe, pipe, pipe,
                                             filename_prefix="../out")
    finally:
        treg.clear_pipeline_cache()


def test_tiny_txt2img_from_a_file_matches_the_jax_executor(tmp_path,
                                                           monkeypatch):
    monkeypatch.setenv("DTPU_DEFAULT_FAMILY", "tiny")
    jfam, _ = FAMILIES["tiny"]
    unet_p, clip_ps, vae_p = _jax_params(jfam, seed=31)
    name = "tiny-from-disk.safetensors"
    jckpt.save_checkpoint(str(tmp_path / name), unet_p, clip_ps, vae_p, jfam)
    doc = json.loads((ROOT / "workflows" / "distributed-txt2img.json")
                     .read_text())
    doc["4"]["inputs"]["ckpt_name"] = name
    doc["5"]["inputs"].update(width=64, height=64)
    doc["3"]["inputs"]["steps"] = 4
    treg.clear_pipeline_cache()
    jreg.clear_pipeline_cache()
    try:
        ours = WorkflowExecutor(OpContext(
            device="cpu", models_dir=str(tmp_path))).execute(
                copy.deepcopy(doc)).image_batch
        ref = JaxExecutor(JaxOpContext(models_dir=str(tmp_path))).execute(
            copy.deepcopy(doc))
        ref.wait_host()
        virtual = WorkflowExecutor(OpContext(device="cpu")).execute(
            copy.deepcopy(doc)).image_batch
    finally:
        treg.clear_pipeline_cache()
        jreg.clear_pipeline_cache()
    assert ours.shape == (1, 16, 16, 3) and ours.std() > 0
    np.testing.assert_allclose(ours, ref.image_batch, rtol=0,
                               atol=IMAGE_ATOL)
    assert np.abs(ours - virtual).max() > 1e-2   # the file's weights ran
