"""``/interrupt`` on the port against the JAX package, on the CPU.

- Every one of the 34 samplers, on the same numpy inputs, keys and
  sigmas in both packages, with an analytic denoiser (no UNet): with
  the flag set before the call, the latent comes back untouched and the
  model is called zero times; with the flag set by the model's 3rd call,
  the two latents agree within rtol = atol = 2e-4 (the port's parity
  rule) and the two call counts are equal.  The JAX side runs as its
  own ``tests/test_samplers.py`` runs it: compiled scans, the model's
  call counted by a host callback.
- A tiny txt2img prompt through the port's server, interrupted from
  another thread (``POST /interrupt``) when the model has been called
  k times: its history entry is the JAX package's error; the next
  prompt clears the flag and its image equals an uninterrupted run's to
  the bit.
- A tiled decode interrupted between tiles raises in both packages
  after the same tile, and so does the port's tiled super-resolution
  op.
- The tiled upscaler interrupted mid-sample raises before any tile is
  decoded, so no half-denoised tile is blended or sent to a master.

The flag is process-wide in both packages: every test clears both
afterwards."""

import copy
import json
import pathlib
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from comfyui_distributed_tpu.models import samplers as jsmp
from comfyui_distributed_tpu.models import schedules as jsch
from comfyui_distributed_tpu.ops import tiling as jtiling
from comfyui_distributed_tpu.ops.base import OpContext as JaxOpContext
from comfyui_distributed_tpu.runtime import interrupt as jitr
from comfyui_distributed_tpu_torch.models import prng
from comfyui_distributed_tpu_torch.models import registry as treg
from comfyui_distributed_tpu_torch.models import samplers as tsmp
from comfyui_distributed_tpu_torch.models import vae as tvae
from comfyui_distributed_tpu_torch.ops import tiling as ttiling
from comfyui_distributed_tpu_torch.ops.base import OpContext
from comfyui_distributed_tpu_torch.ops.basic import ImageUpscaleWithModel
from comfyui_distributed_tpu_torch.runtime import interrupt as titr
from comfyui_distributed_tpu_torch.utils import log as tlog
from comfyui_distributed_tpu_torch.server import app as tapp
from comfyui_distributed_tpu_torch.utils.net import get_json, post_json
from comfyui_distributed_tpu_torch.workflow import WorkflowExecutor

ROOT = pathlib.Path(__file__).resolve().parents[1]
TOL = 2e-4
STEPS = 6
STOP_AT_CALL = 3
SEEDS = np.asarray([7, 2 ** 33 + 1], np.uint64)
PROMPT_S = 120           # a prompt's own bound


@pytest.fixture(autouse=True)
def clear_flags():
    titr.clear_interrupt()
    jitr.clear_interrupt()
    yield
    titr.clear_interrupt()
    jitr.clear_interrupt()


@pytest.fixture(scope="module")
def inputs():
    sig = jsch.compute_sigmas(jsch.make_discrete_schedule(), "karras", STEPS)
    x = np.random.default_rng(11).standard_normal((2, 8, 8, 4)) \
        .astype(np.float32) * sig[0]
    return sig, x, prng.sample_keys(SEEDS)


def _scale(sigma):
    """The analytic denoiser's factor: x0 = x / (1 + sigma^2)."""
    return 1.0 / (1.0 + sigma * sigma)


def run_jax(name, inputs, stop_at):
    """The JAX sampler, its model counted in a host callback that sets the
    flag on call ``stop_at`` (None: never)."""
    sig, x, keys = inputs
    calls = []

    def model(xin, sigma, **kw):
        def cb(_):
            calls.append(1)
            if len(calls) == stop_at:
                jitr.request_interrupt()
            return np.float32(0.0)
        z = jax.pure_callback(cb, jax.ShapeDtypeStruct((), np.float32),
                              xin.reshape(-1)[0])
        return xin * _scale(sigma) + z

    out = jsmp.get_sampler(name)(model, jnp.asarray(x), jnp.asarray(sig),
                                 keys=jnp.asarray(keys))
    return np.asarray(out), len(calls)


def run_torch(name, inputs, stop_at):
    sig, x, keys = inputs
    calls = []

    def model(xin, sigma, **kw):
        calls.append(1)
        if len(calls) == stop_at:
            titr.request_interrupt()
        return xin * _scale(sigma)

    with torch.no_grad():
        out = tsmp.get_sampler(name)(model, torch.from_numpy(x.copy()), sig,
                                     keys=keys)
    return out.numpy(), len(calls)


@pytest.mark.parametrize("name", list(tsmp.SAMPLERS))
def test_a_preset_flag_skips_every_step_in_both_packages(name, inputs):
    _, x, _ = inputs
    jitr.request_interrupt()
    titr.request_interrupt()
    jout, jcalls = run_jax(name, inputs, None)
    tout, tcalls = run_torch(name, inputs, None)
    np.testing.assert_array_equal(jout, x)
    np.testing.assert_array_equal(tout, x)
    assert jcalls == tcalls == 0


@pytest.mark.parametrize("name", list(tsmp.SAMPLERS))
def test_a_flag_set_mid_run_stops_both_packages_alike(name, inputs):
    _, x, _ = inputs
    jout, jcalls = run_jax(name, inputs, STOP_AT_CALL)
    tout, tcalls = run_torch(name, inputs, STOP_AT_CALL)
    assert jcalls == tcalls >= STOP_AT_CALL
    np.testing.assert_allclose(tout, jout, rtol=TOL, atol=TOL)
    # partial: neither the input nor the uninterrupted result
    jitr.clear_interrupt()
    titr.clear_interrupt()
    full, full_calls = run_torch(name, inputs, None)
    assert full_calls > tcalls
    assert not np.array_equal(tout, x) and not np.array_equal(tout, full)


def test_the_step_loop_reads_the_flag_without_a_device_sync(monkeypatch,
                                                            inputs):
    """The check is a read of the event: no synchronize is added."""
    def no_sync(*a, **kw):
        raise AssertionError("synchronize in the step loop")
    monkeypatch.setattr(torch.cuda, "synchronize", no_sync)
    run_torch("euler", inputs, STOP_AT_CALL)


# --- a prompt through the port's server ---------------------------------------

def _tiny_doc():
    doc = json.loads((ROOT / "workflows" / "distributed-txt2img.json")
                     .read_text())
    doc["5"]["inputs"].update(width=64, height=64)
    doc["3"]["inputs"]["steps"] = 4
    return doc


def test_an_interrupted_prompt_ends_in_error_and_the_next_is_exact(
        tmp_path, monkeypatch):
    monkeypatch.setenv("DTPU_DEFAULT_FAMILY", "tiny")
    st = tapp.ServerState(config_path=str(tmp_path / "cfg.json"),
                          device="cpu", input_dir=str(tmp_path),
                          output_dir=str(tmp_path))
    srv = tapp.make_server(st, "127.0.0.1", 0)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    url = f"http://127.0.0.1:{st.port}"
    images = {}

    class Recording(tapp.WorkflowExecutor):
        def execute(self, workflow):
            res = super().execute(workflow)
            images[len(images)] = res.image_batch
            return res

    monkeypatch.setattr(tapp, "WorkflowExecutor", Recording)
    calls = []
    stop_at = [None]
    real = treg.get_sampler

    def counting_sampler(name):
        sampler = real(name)

        def run(model, x, sigmas, **kw):
            def counted(*a, **k):
                out = model(*a, **k)
                calls.append(1)
                if len(calls) == stop_at[0]:
                    t = threading.Thread(target=post_json,
                                         args=(url + "/interrupt", {}))
                    t.start()
                    t.join()
                return out
            return sampler(counted, x, sigmas, **kw)
        return run

    monkeypatch.setattr(treg, "get_sampler", counting_sampler)

    def prompt():
        pid = post_json(url + "/prompt", {"prompt": _tiny_doc()})[
            "prompt_id"]
        deadline = time.monotonic() + PROMPT_S
        while time.monotonic() < deadline:
            hist = get_json(url + "/history")
            if pid in hist:
                return hist[pid]
            time.sleep(0.05)
        raise AssertionError(f"no history in {PROMPT_S} s")

    try:
        first = prompt()
        assert first["status"] == "success" and len(calls) == 4
        calls.clear()
        stop_at[0] = 2
        entry = prompt()
        assert {k: entry[k] for k in ("status", "error")} == {
            "status": "error", "error": "execution interrupted"}
        assert len(calls) == 2          # steps 3 and 4 never ran
        assert len(images) == 1         # VAEDecode raised
        jitr.request_interrupt()    # the JAX package's own message
        with pytest.raises(InterruptedError) as jerr:
            JaxOpContext(interrupt_event=jitr.interrupt_event()) \
                .check_interrupt()
        jitr.clear_interrupt()
        assert str(jerr.value) == entry["error"]
        calls.clear()
        stop_at[0] = None
        third = prompt()
        assert third["status"] == "success" and len(calls) == 4
        assert not titr.is_interrupted()
        np.testing.assert_array_equal(images[1], images[0])
    finally:
        srv.shutdown()
        srv.server_close()
        treg.clear_pipeline_cache()


def test_the_debug_tier_logs_each_node_as_it_starts(tmp_path, monkeypatch,
                                                    capsys):
    """With ``settings.debug`` on, the executor logs ``exec node N
    (Type)`` before each node runs: what an interrupt is timed by."""
    monkeypatch.setenv("DTPU_DEFAULT_FAMILY", "tiny")
    doc = _tiny_doc()
    tlog.set_debug(True)
    try:
        WorkflowExecutor(OpContext(device="cpu", output_dir=str(tmp_path))) \
            .execute(copy.deepcopy(doc))
    finally:
        tlog.set_debug(False)
        treg.clear_pipeline_cache()
    lines = [ln for ln in capsys.readouterr().out.splitlines()
             if " exec node " in ln]
    assert sorted(lines) == sorted(
        f"dtpu-torch [DEBUG] exec node {nid} ({node['class_type']})"
        for nid, node in doc.items() if isinstance(node, dict))
    tlog.set_debug(False)
    WorkflowExecutor(OpContext(device="cpu", output_dir=str(tmp_path))) \
        .execute(copy.deepcopy(doc))
    treg.clear_pipeline_cache()
    assert " exec node " not in capsys.readouterr().out


# --- between tiles ----------------------------------------------------------

def test_a_tiled_decode_interrupted_between_tiles_raises(monkeypatch):
    """The port's tiny VAE decoder over 4 latent tiles (and the JAX
    package's tiling loop over the same tile layout): the flag set by the
    first tile stops both before the second."""
    vae = tvae.VAE(tvae.TINY_VAE_CONFIG).eval()
    gen = torch.Generator().manual_seed(0)
    with torch.no_grad():
        for p in vae.parameters():
            p.copy_(torch.randn(p.shape, generator=gen) * 0.05)
    scale = tvae.TINY_VAE_CONFIG.downscale
    lat = np.random.default_rng(3).standard_normal((1, 24, 24, 4)) \
        .astype(np.float32)
    ctx = OpContext(device="cpu", interrupt_event=titr.interrupt_event())
    jctx = JaxOpContext(interrupt_event=jitr.interrupt_event())
    tiles, jtiles = [], []

    def decode(z):
        tiles.append(z.shape)
        titr.request_interrupt()
        return vae.decode(z)

    def jdecode(z):
        jtiles.append(z.shape)
        jitr.request_interrupt()
        return np.zeros((*z.shape[:3], 3), np.float32).repeat(
            scale, 1).repeat(scale, 2)

    with torch.no_grad(), pytest.raises(InterruptedError,
                                        match="execution interrupted"):
        ttiling.tiled_apply(decode, torch.from_numpy(lat), 16, 8, scale,
                            3, check_interrupt=ctx.check_interrupt)
    with pytest.raises(InterruptedError, match="execution interrupted"):
        jtiling.tiled_apply(jdecode, lat, 16, 8, scale, 3,
                            check_interrupt=jctx.check_interrupt)
    assert len(tiles) == len(jtiles) == 1
    # the super-resolution op passes its context's check to the loop
    titr.clear_interrupt()
    monkeypatch.setattr(ImageUpscaleWithModel, "TILE_THRESHOLD", 1000)
    monkeypatch.setattr(ImageUpscaleWithModel, "TILE", 24)
    monkeypatch.setattr(ImageUpscaleWithModel, "OVERLAP", 8)
    sr_tiles = []

    class Nearest2x:
        scale = 2

        def __call__(self, x):
            sr_tiles.append(x.shape)
            titr.request_interrupt()
            return x.repeat_interleave(2, 1).repeat_interleave(2, 2)

    img = torch.from_numpy(np.random.default_rng(4).uniform(
        size=(1, 40, 40, 3)).astype(np.float32))
    with pytest.raises(InterruptedError, match="execution interrupted"):
        ImageUpscaleWithModel().execute(OpContext(device="cpu"),
                                        Nearest2x(), img)
    assert sr_tiles == [(1, 24, 24, 3)]
    # without the flag the check changes nothing
    titr.clear_interrupt()
    with torch.no_grad():
        plain = ttiling.tiled_apply(vae.decode, torch.from_numpy(lat), 16, 8,
                                    scale, 3)
        checked = ttiling.tiled_apply(vae.decode, torch.from_numpy(lat), 16,
                                      8, scale, 3,
                                      check_interrupt=ctx.check_interrupt)
    torch.testing.assert_close(checked, plain, rtol=0, atol=0)


# --- the tiled upscaler -------------------------------------------------------

def test_a_tiled_upscale_interrupted_mid_sample_raises_before_decode(
        tmp_path, monkeypatch):
    """``workflows/distributed-upscale.json`` at a small size (four 32^2
    tiles refined as one batch, 2 steps), interrupted by the model's
    first call: the prompt ends with the JAX package's error and the
    tile batch is never decoded."""
    from PIL import Image
    monkeypatch.setenv("DTPU_DEFAULT_FAMILY", "tiny")
    px = (np.random.default_rng(8).uniform(size=(40, 48, 3)) * 255) \
        .astype(np.uint8)
    Image.fromarray(px, "RGB").save(tmp_path / "input.png")
    doc = json.loads((ROOT / "workflows" / "distributed-upscale.json")
                     .read_text())
    doc["16"]["inputs"].update(width=64, height=64)
    doc["2"]["inputs"].update(steps=2, tile_width=32, tile_height=32,
                              padding=8, mask_blur=2)
    calls, decodes = [], []
    real_sampler = treg.get_sampler
    real_decode = treg.DiffusionPipeline.vae_decode

    def interrupting_sampler(name):
        sampler = real_sampler(name)

        def run(model, x, sigmas, **kw):
            def counted(*a, **k):
                calls.append(1)
                titr.request_interrupt()
                return model(*a, **k)
            return sampler(counted, x, sigmas, **kw)
        return run

    def counted_decode(self, *a, **kw):
        decodes.append(1)
        return real_decode(self, *a, **kw)

    monkeypatch.setattr(treg, "get_sampler", interrupting_sampler)
    monkeypatch.setattr(treg.DiffusionPipeline, "vae_decode",
                        counted_decode)
    try:
        with torch.no_grad(), pytest.raises(
                InterruptedError, match="execution interrupted"):
            WorkflowExecutor(OpContext(device="cpu",
                                       input_dir=str(tmp_path))) \
                .execute(doc)
    finally:
        treg.clear_pipeline_cache()
    assert calls == [1] and decodes == []
