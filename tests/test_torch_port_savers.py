"""The port's savers, LoadLatent and native checkpoints against the JAX
package, on the CPU (tiny family, fp32 weights).

- ModelSave, CLIPSave and VAESave: the file each package writes holds
  the same keys, dtypes and values, to the bit, and each package's
  UNETLoader, CLIPLoader and VAELoader read the other's file back to the
  weights that were saved, to the bit.
- SaveLatent and LoadLatent: each package reads the other's ``.latent``
  to the bit; a file without ComfyUI's version marker is scaled by
  1/0.18215 in both.
- Native checkpoints (``runtime/checkpointing.py``): a pipeline saved
  natively loads by its name through ``load_pipeline``, its family from
  the manifest, and samples the in-memory pipeline's image to the bit; a
  JAX package's orbax directory is refused with a ``ValueError`` that
  names its layout; a directory without the manifest is not native.
"""

import copy
import json
import os

import numpy as np
import pytest
import torch
from safetensors.numpy import load_file, save_file

from comfyui_distributed_tpu.models import registry as jreg
from comfyui_distributed_tpu.ops.base import OpContext as JaxOpContext
from comfyui_distributed_tpu.ops.base import get_op as jax_get_op
from comfyui_distributed_tpu.runtime import reuse as jreuse
from comfyui_distributed_tpu_torch.models import registry as treg
from comfyui_distributed_tpu_torch.ops.base import (DeviceLatent, OpContext,
                                                    get_op)
from comfyui_distributed_tpu_torch.runtime import checkpointing as tckpt
from comfyui_distributed_tpu_torch.runtime import reuse as treuse
from comfyui_distributed_tpu_torch.workflow import WorkflowExecutor

from test_torch_port_lora import jax_sd, torch_sd

NAME = "tiny-saver.safetensors"
# (op, input slot, file under the output dir, loader, loader widgets,
#  which towers the loaded pipeline holds)
SAVERS = [
    ("ModelSave", "model", "diffusion_models/save.safetensors",
     "UNETLoader", {"unet_name": "diffusion_models/save.safetensors"},
     (True, False)),
    ("CLIPSave", "clip", "clip/save.safetensors", "CLIPLoader",
     {"clip_name": "clip/save.safetensors", "type": "tiny"}, (False, True)),
    ("VAESave", "vae", "vae/save.safetensors", "VAELoader",
     {"vae_name": "vae/save.safetensors"}, None),
]


@pytest.fixture(scope="module")
def loaded():
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("DTPU_DEFAULT_FAMILY", "tiny")
        yield (jreg.load_pipeline(NAME),
               treg.load_pipeline(NAME, device="cpu"))
    jreg.clear_pipeline_cache()
    treg.clear_pipeline_cache()


@pytest.fixture
def pair(loaded, monkeypatch):
    monkeypatch.setenv("DTPU_DEFAULT_FAMILY", "tiny")
    treuse.reset_reuse()
    jreuse.reset_reuse()
    yield loaded
    treuse.reset_reuse()
    jreuse.reset_reuse()


def vae_sd(pipe):
    """A pipeline's VAE as bare torch-layout keys (either package)."""
    if hasattr(pipe, "vae_params"):
        from comfyui_distributed_tpu.models import checkpoints as jc
        return jc._run_vae(jc._ExportMapper(pipe.vae_params, ""),
                           pipe.family.vae)
    from comfyui_distributed_tpu_torch.models import checkpoints as tc
    return tc._run_vae(tc._ExportMapper(tc._by_path(pipe.vae), ""),
                       pipe.family.vae)


def as_np(sd):
    return {k: (v.numpy() if isinstance(v, torch.Tensor) else np.asarray(v))
            for k, v in sd.items()}


def assert_bits(a, b):
    a, b = as_np(a), as_np(b)
    assert set(a) == set(b)
    for k in a:
        assert a[k].dtype == b[k].dtype, k
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


@pytest.mark.parametrize("op,slot,rel,loader,widgets,towers", SAVERS,
                         ids=[s[0] for s in SAVERS])
def test_saved_files_are_interchangeable(pair, tmp_path, op, slot, rel,
                                         loader, widgets, towers):
    jpipe, tpipe = pair
    tdir, jdir = tmp_path / "torch", tmp_path / "jax"
    get_op(op).execute(OpContext(device="cpu", output_dir=str(tdir)),
                       **{slot: tpipe})
    jax_get_op(op).execute(JaxOpContext(output_dir=str(jdir)),
                           **{slot: jpipe})
    # the two files hold the same tensors, to the bit
    assert_bits(load_file(str(tdir / rel)), load_file(str(jdir / rel)))
    # each package reads the other's file back to the saved weights
    (tl,) = get_op(loader).execute(
        OpContext(device="cpu", models_dir=str(jdir)), **widgets)
    (jl,) = jax_get_op(loader).execute(JaxOpContext(models_dir=str(tdir)),
                                       **widgets)
    if towers is None:
        assert_bits(vae_sd(tl), vae_sd(tpipe))
        assert_bits(vae_sd(jl), vae_sd(jpipe))
    else:
        assert_bits(torch_sd(tl, *towers), torch_sd(tpipe, *towers))
        assert_bits(jax_sd(jl, *towers), jax_sd(jpipe, *towers))


def test_latents_round_trip_both_ways(pair, tmp_path):
    lat = np.random.default_rng(3).standard_normal(
        (2, 5, 7, 4)).astype(np.float32)
    tdir, jdir = tmp_path / "torch", tmp_path / "jax"
    get_op("SaveLatent").execute(
        OpContext(device="cpu", output_dir=str(tdir)),
        {"samples": DeviceLatent(torch.from_numpy(lat))})
    jax_get_op("SaveLatent").execute(JaxOpContext(output_dir=str(jdir)),
                                     {"samples": lat})
    rel = "latents/save_00000.latent"
    assert_bits(load_file(str(tdir / rel)), load_file(str(jdir / rel)))
    (t,) = get_op("LoadLatent").execute(
        OpContext(device="cpu", input_dir=str(jdir)), rel)
    (j,) = jax_get_op("LoadLatent").execute(
        JaxOpContext(input_dir=str(tdir)), rel)
    np.testing.assert_array_equal(t["samples"].to_host(), lat)
    np.testing.assert_array_equal(np.asarray(j["samples"]), lat)
    # a second save counts on, never over the first
    get_op("SaveLatent").execute(
        OpContext(device="cpu", output_dir=str(tdir)),
        {"samples": DeviceLatent(torch.from_numpy(lat))})
    assert sorted(os.listdir(tdir / "latents")) == [
        "save_00000.latent", "save_00001.latent"]


def test_a_latent_without_the_marker_is_scaled(pair, tmp_path):
    lat = np.random.default_rng(4).standard_normal(
        (1, 4, 3, 6)).astype(np.float32)
    save_file({"latent_tensor": lat}, str(tmp_path / "old.latent"))
    (t,) = get_op("LoadLatent").execute(
        OpContext(device="cpu", input_dir=str(tmp_path)), "old.latent")
    (j,) = jax_get_op("LoadLatent").execute(
        JaxOpContext(input_dir=str(tmp_path)), "old.latent")
    got = t["samples"].to_host()
    np.testing.assert_array_equal(got, np.asarray(j["samples"]))
    np.testing.assert_array_equal(
        got, (lat * np.float32(1.0 / 0.18215)).transpose(0, 2, 3, 1))


def _graph(ckpt):
    return {
        "4": {"class_type": "CheckpointLoaderSimple",
              "inputs": {"ckpt_name": ckpt}},
        "5": {"class_type": "EmptyLatentImage",
              "inputs": {"width": 64, "height": 64, "batch_size": 1}},
        "6": {"class_type": "CLIPTextEncode",
              "inputs": {"text": "a lighthouse", "clip": ["4", 1]}},
        "7": {"class_type": "CLIPTextEncode",
              "inputs": {"text": "blurry", "clip": ["4", 1]}},
        "3": {"class_type": "KSampler",
              "inputs": {"seed": 5, "steps": 3, "cfg": 6.0,
                         "sampler_name": "euler", "scheduler": "karras",
                         "denoise": 1.0, "model": ["4", 0],
                         "positive": ["6", 0], "negative": ["7", 0],
                         "latent_image": ["5", 0]}},
        "8": {"class_type": "VAEDecode",
              "inputs": {"samples": ["3", 0], "vae": ["4", 2]}},
        "9": {"class_type": "PreviewImage", "inputs": {"images": ["8", 0]}},
    }


def test_native_checkpoint_loads_by_name_to_the_bit(pair, tmp_path,
                                                    monkeypatch):
    _, tpipe = pair
    models = tmp_path / "models"
    tckpt.save_pipeline_checkpoint(str(models / "my-native"), "tiny",
                                   tpipe.unet, tpipe.clip_models, tpipe.vae)
    meta = json.loads((models / "my-native" / tckpt.METADATA_FILE)
                      .read_text())
    assert meta == {"format": "dtpu-pipeline", "version": 1,
                    "family": "tiny", "num_clips": 1,
                    "layout": "safetensors"}
    # without the default family the name alone would say sd15: the
    # manifest decides
    monkeypatch.delenv("DTPU_DEFAULT_FAMILY")
    assert treg.detect_family("my-native") == "sd15"
    loaded = treg.load_pipeline("my-native", models_dir=str(models),
                                device="cpu")
    assert loaded.family.name == "tiny"
    for m, ref in [(loaded.unet, tpipe.unet), (loaded.vae, tpipe.vae),
                   (loaded.clip_models[0], tpipe.clip_models[0])]:
        for (n, p), (n2, q) in zip(m.named_parameters(),
                                   ref.named_parameters()):
            assert n == n2 and p.dtype == q.dtype
            torch.testing.assert_close(p, q, rtol=0, atol=0)
    native = WorkflowExecutor(OpContext(
        device="cpu", models_dir=str(models))).execute(_graph("my-native"))
    monkeypatch.setenv("DTPU_DEFAULT_FAMILY", "tiny")
    treuse.reset_reuse()
    plain = WorkflowExecutor(OpContext(device="cpu")).execute(_graph(NAME))
    assert native.image_batch.std() > 0
    np.testing.assert_array_equal(native.image_batch, plain.image_batch)


def test_orbax_directory_is_refused_and_a_bare_one_is_not_native(
        pair, tmp_path):
    from comfyui_distributed_tpu.runtime import checkpointing as jckpt
    jpipe, _ = pair
    models = tmp_path / "models"
    jckpt.save_pipeline_checkpoint(str(models / "jax-native"), "tiny",
                                   jpipe.unet_params, jpipe.clip_params,
                                   jpipe.vae_params)
    assert tckpt.is_native_checkpoint(str(models / "jax-native"))
    with pytest.raises(ValueError, match="'orbax' layout"):
        treg.load_pipeline("jax-native", models_dir=str(models),
                           device="cpu")
    (models / "bare").mkdir()
    assert not tckpt.is_native_checkpoint(str(models / "bare"))
    assert not tckpt.is_native_checkpoint(str(models / "nothing"))
