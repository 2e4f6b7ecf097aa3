"""The port's text encoder, VAE decoder, schedules, tokenizer,
seed-to-noise path, sampler and virtual weights against the JAX
package's, on the same numpy inputs (fp32, tiny configurations)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from comfyui_distributed_tpu.models import clip as jclip
from comfyui_distributed_tpu.models import denoiser as jden
from comfyui_distributed_tpu.models import registry as jreg
from comfyui_distributed_tpu.models import samplers as jsmp
from comfyui_distributed_tpu.models import schedules as jsch
from comfyui_distributed_tpu.models import tokenizer as jtok
from comfyui_distributed_tpu.models import unet as junet
from comfyui_distributed_tpu.models import vae as jvae
from comfyui_distributed_tpu_torch.models import clip as tclip
from comfyui_distributed_tpu_torch.models import denoiser as tden
from comfyui_distributed_tpu_torch.models import prng
from comfyui_distributed_tpu_torch.models import registry as treg
from comfyui_distributed_tpu_torch.models import samplers as tsmp
from comfyui_distributed_tpu_torch.models import schedules as tsch
from comfyui_distributed_tpu_torch.models import tokenizer as ttok
from comfyui_distributed_tpu_torch.models import unet as tunet
from comfyui_distributed_tpu_torch.models import vae as tvae
from comfyui_distributed_tpu_torch.models.weights import (
    from_flax, state_dict_from_flax)

TOL = dict(rtol=2e-4, atol=2e-4)


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _load(module, flax_params):
    module.load_state_dict(state_dict_from_flax(module, _np_tree(flax_params)))
    return module.eval()


def test_clip_tiny_hidden_and_pooled():
    """TINY_CLIP (final layer, no projection) and a penultimate-layer
    tower with a pooled projection, like SDXL's bigG."""
    import dataclasses
    tok = jtok.HashTokenizer(vocab_size=4096)
    ids = np.stack([tok.encode(t)[0] for t in
                    ("a (red:1.3) lighthouse at dawn", "blurry, lowres")])
    for cfg_j, cfg_t in (
            (jclip.TINY_CLIP_CONFIG, tclip.TINY_CLIP_CONFIG),
            (dataclasses.replace(jclip.TINY_CLIP_CONFIG, output_layer=-2,
                                 projection_dim=32, act="gelu"),
             dataclasses.replace(tclip.TINY_CLIP_CONFIG, output_layer=-2,
                                 projection_dim=32, act="gelu"))):
        params = jreg._virtual_params(jclip.CLIPTextModel(cfg_j), 11,
                                      jnp.zeros((1, 77), jnp.int32))
        jh, jp = jclip.CLIPTextModel(cfg_j).apply({"params": params},
                                                  jnp.asarray(ids))
        with torch.no_grad():
            th, tp = _load(tclip.CLIPTextModel(cfg_t), params)(
                torch.from_numpy(ids).long())
        np.testing.assert_allclose(th.numpy(), np.asarray(jh), **TOL)
        np.testing.assert_allclose(tp.numpy(), np.asarray(jp), **TOL)


def test_vae_decoder_tiny():
    params = jreg._virtual_params(jvae.VAE(jvae.TINY_VAE_CONFIG), 3,
                                  jnp.zeros((1, 16, 16, 3)))
    z = np.random.default_rng(0).standard_normal(
        (2, 8, 8, 4)).astype(np.float32) * 0.2
    jimg = jvae.VAE(jvae.TINY_VAE_CONFIG).apply(
        {"params": params}, jnp.asarray(z), method="decode")
    with torch.no_grad():
        timg = _load(tvae.VAE(tvae.TINY_VAE_CONFIG), params).decode(
            torch.from_numpy(z))
    assert timg.shape == (2, 16, 16, 3)
    np.testing.assert_allclose(timg.numpy(), np.asarray(jimg), **TOL)


@pytest.mark.parametrize("scheduler", ["karras", "normal"])
@pytest.mark.parametrize("denoise", [1.0, 0.6])
def test_schedules_equal(scheduler, denoise):
    js = jsch.compute_sigmas(jsch.make_discrete_schedule(), scheduler, 20,
                             denoise)
    ts = tsch.compute_sigmas(tsch.make_discrete_schedule(), scheduler, 20,
                             denoise)
    assert ts.dtype == np.float32
    np.testing.assert_array_equal(ts, js)


def test_tokenizer_copy_equal():
    for text in ("cinematic photo of a lighthouse, ((waves)), [fog]",
                 "(foo:1.5) bar (baz", "", "x " * 100):
        for vocab, pad_end in ((49408, True), (4096, False)):
            a = jtok.HashTokenizer(vocab_size=vocab,
                                   pad_with_end=pad_end).encode(text)
            b = ttok.HashTokenizer(vocab_size=vocab,
                                   pad_with_end=pad_end).encode(text)
            np.testing.assert_array_equal(a[0], b[0])
            np.testing.assert_array_equal(a[1], b[1])
        assert jtok.parse_weighted_prompt(text) == \
            ttok.parse_weighted_prompt(text)


SEEDS = np.asarray([0, 1, 123456789, 2 ** 32 + 5, 2 ** 64 - 1,
                    987654321987], np.uint64)


def test_sample_keys_bit_exact():
    for idx in (None, np.asarray([0, 3, 1, 7, 2, 5], np.uint32)):
        np.testing.assert_array_equal(
            prng.sample_keys(SEEDS, idx),
            np.asarray(jsmp.sample_keys(SEEDS, idx)))


@pytest.mark.parametrize("index", [prng.INIT_NOISE_INDEX, 0, 7])
def test_noise_matches_within_1e6(index):
    keys = prng.sample_keys(SEEDS)
    jn = jsmp.make_noise_fn(jnp.asarray(keys))(
        jnp.asarray(index, jnp.uint32), (16, 16, 4))
    tn = prng.batch_normal(keys, index, (16, 16, 4))
    assert tn.dtype == torch.float32 and tn.shape == (6, 16, 16, 4)
    np.testing.assert_allclose(tn.numpy(), np.asarray(jn), rtol=0,
                               atol=1e-6)


def test_euler_cfg_sampling_matches():
    """make_denoiser + cfg_denoiser_multi + sample_euler over the tiny
    UNet, 4 karras steps, cfg 7: the JAX scan against the port's loop.
    rtol = atol = 1e-3: the latents reach |x| ~ 60 and cfg 7 scales the
    UNets' 2e-4 differences up."""
    params = jreg._virtual_params(junet.UNet(junet.TINY_CONFIG), 5,
                                  jnp.zeros((1, 8, 8, 4)), jnp.zeros((1,)),
                                  jnp.zeros((1, 77, 64)))
    unet = _load(tunet.UNet(tunet.TINY_CONFIG), params)
    jmod = junet.UNet(junet.TINY_CONFIG)
    sched = jsch.make_discrete_schedule()
    sig = jsch.compute_sigmas(sched, "karras", 4)
    rng = np.random.default_rng(4)
    x = rng.standard_normal((1, 8, 8, 4)).astype(np.float32) * sig[0]
    ctx, unc = (rng.standard_normal((1, 77, 64)).astype(np.float32)
                for _ in range(2))
    jden_fn = jden.make_denoiser(
        lambda p, xi, t, c, y=None, control=None, **kw: jmod.apply(
            {"params": p}, xi, t, c, y=y), params, sched)
    jmodel = jsmp.cfg_denoiser_multi(jden_fn, [(jnp.asarray(ctx), None, 1.0)],
                                     jnp.asarray(unc), 7.0)
    jout = jsmp.sample_euler(jmodel, jnp.asarray(x), jnp.asarray(sig))
    tden_fn = tden.make_denoiser(unet, tsch.make_discrete_schedule())
    tmodel = tsmp.cfg_denoiser_multi(tden_fn, [(torch.from_numpy(ctx), None,
                                                1.0)],
                                     torch.from_numpy(unc), 7.0)
    with torch.no_grad():
        tout = tsmp.sample_euler(tmodel, torch.from_numpy(x),
                                 torch.from_numpy(sig))
    np.testing.assert_allclose(tout.numpy(), np.asarray(jout), rtol=1e-3,
                               atol=1e-3)


def test_t_from_sigma_matches():
    """The timestep the UNet sees for a sigma (atol 1e-4 of a table
    index: log-interpolation in fp32 on both sides)."""
    seen = []
    jfn = jden.make_denoiser(lambda p, x, t, *a, **k: seen.append(t) or x,
                             None, jsch.make_discrete_schedule())
    t_fn = tden.make_t_from_sigma(tsch.make_discrete_schedule(), "cpu")
    for s in np.asarray([14.6146, 3.3, 1.0, 0.5, 0.0292, 0.03], np.float32):
        seen.clear()
        jfn(jnp.zeros((1, 1)), jnp.asarray(s))
        np.testing.assert_allclose(t_fn(torch.tensor(s)).numpy(),
                                   np.asarray(seen[0])[0], rtol=1e-6,
                                   atol=1e-4)


def test_virtual_tiny_pipeline_equals_from_flax_of_jax():
    """A checkpoint name with no file gives the JAX package's weights."""
    name = "tiny-port-check.safetensors"
    jp = jreg.load_pipeline(name, family_name="tiny")
    sd_unet, sd_clips, sd_vae = from_flax(
        treg.FAMILIES["tiny"], _np_tree(jp.unet_params),
        [_np_tree(p) for p in jp.clip_params], _np_tree(jp.vae_params))
    tp = treg.load_pipeline(name, family_name="tiny", device="cpu")
    for module, sd in [(tp.unet, sd_unet), (tp.vae, sd_vae)] + list(
            zip(tp.clip_models, sd_clips)):
        own = module.state_dict()
        assert set(own) == set(sd)
        for k, v in sd.items():
            assert torch.equal(own[k], v), k
