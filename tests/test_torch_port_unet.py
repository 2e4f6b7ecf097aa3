"""The port's UNet and its layers against the JAX package's.

Weights cross by ``models/weights.py`` (flax trees -> state dicts); the
inputs are numpy arrays from a seed; the JAX side runs its Pallas
attention in interpret mode (``attn_impl="pallas"``).  fp32 throughout,
rtol = atol = 2e-4: the two frameworks sum in different orders.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from comfyui_distributed_tpu.models import layers as jlayers
from comfyui_distributed_tpu.models import registry as jreg
from comfyui_distributed_tpu.models import unet as junet
from comfyui_distributed_tpu_torch.models import layers as tlayers
from comfyui_distributed_tpu_torch.models import unet as tunet
from comfyui_distributed_tpu_torch.models.weights import state_dict_from_flax

TOL = dict(rtol=2e-4, atol=2e-4)


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _load(module, flax_params):
    module.load_state_dict(state_dict_from_flax(module, _np_tree(flax_params)))
    return module.eval()


@pytest.mark.parametrize("adm", [None, 128], ids=["plain", "adm"])
def test_tiny_unet_matches_jax_pallas(adm):
    jcfg = dataclasses.replace(junet.TINY_CONFIG, adm_in_channels=adm)
    tcfg = dataclasses.replace(tunet.TINY_CONFIG, adm_in_channels=adm)
    params = jreg._virtual_params(junet.UNet(jcfg), 7,
                                  jnp.zeros((1, 16, 16, 4)), jnp.zeros((1,)),
                                  jnp.zeros((1, 77, 64)))
    model = _load(tunet.UNet(tcfg), params)
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 16, 16, 4)).astype(np.float32)
    t = np.asarray([999.0, 20.5], np.float32)
    ctx = rng.standard_normal((2, 77, 64)).astype(np.float32)
    y = None if adm is None else \
        rng.standard_normal((2, adm)).astype(np.float32)
    jout = junet.UNet(dataclasses.replace(jcfg, attn_impl="pallas")).apply(
        {"params": params}, jnp.asarray(x), jnp.asarray(t), jnp.asarray(ctx),
        y=None if y is None else jnp.asarray(y))
    with torch.no_grad():
        tout = model(torch.from_numpy(x), torch.from_numpy(t),
                     torch.from_numpy(ctx),
                     None if y is None else torch.from_numpy(y))
    assert tout.dtype == torch.float32 and tout.shape == (2, 16, 16, 4)
    np.testing.assert_allclose(tout.numpy(), np.asarray(jout), **TOL)


def test_spatial_transformer_at_sdxl_width():
    """C = 1280, 20 heads (D = 64), a 2048-wide context, N = 64 tokens."""
    rng = np.random.default_rng(1)
    x = rng.standard_normal((1, 8, 8, 1280)).astype(np.float32)
    ctx = rng.standard_normal((1, 77, 2048)).astype(np.float32)
    jmod = jlayers.SpatialTransformer(num_heads=20, depth=1,
                                      dtype=jnp.float32, attn_impl="pallas")
    params = jmod.init(jax.random.PRNGKey(0), jnp.asarray(x),
                       jnp.asarray(ctx))["params"]
    jout = jmod.apply({"params": params}, jnp.asarray(x), jnp.asarray(ctx))
    tmod = _load(tlayers.SpatialTransformer(1280, 20, 1, 2048,
                                            dtype=torch.float32), params)
    with torch.no_grad():
        tout = tmod(torch.from_numpy(x).permute(0, 3, 1, 2),
                    torch.from_numpy(ctx)).permute(0, 2, 3, 1)
    np.testing.assert_allclose(tout.numpy(), np.asarray(jout), **TOL)


def test_resblock_and_timestep_embedding():
    """The embedding's fp32 cos/sin of arguments up to 1e3 differ by a
    few ulps of the argument between libraries: atol 1e-5."""
    rng = np.random.default_rng(2)
    t = np.asarray([0.0, 1.5, 999.0], np.float32)
    np.testing.assert_allclose(
        tlayers.timestep_embedding(torch.from_numpy(t), 33).numpy(),
        np.asarray(jlayers.timestep_embedding(jnp.asarray(t), 33)),
        rtol=0, atol=1e-5)
    x = rng.standard_normal((2, 8, 8, 32)).astype(np.float32)
    emb = rng.standard_normal((2, 128)).astype(np.float32)
    jmod = jlayers.ResBlock(out_channels=64, dtype=jnp.float32)
    params = jmod.init(jax.random.PRNGKey(1), jnp.asarray(x),
                       jnp.asarray(emb))["params"]
    tmod = _load(tlayers.ResBlock(32, 64, 128, dtype=torch.float32), params)
    with torch.no_grad():
        tout = tmod(torch.from_numpy(x).permute(0, 3, 1, 2),
                    torch.from_numpy(emb)).permute(0, 2, 3, 1)
    np.testing.assert_allclose(
        tout.numpy(),
        np.asarray(jmod.apply({"params": params}, jnp.asarray(x),
                              jnp.asarray(emb))), **TOL)


@pytest.mark.parametrize("patch", [dict(freeu=(1.1, 1.2, 0.9, 0.2),
                                        tome_ratio=0.5),
                                   dict(tome_ratio=0.5), dict(gligen=768),
                                   dict(sag_capture=True, gligen=768)],
                         ids=["freeu_tome", "tome", "gligen",
                              "sag_capture_gligen"])
def test_tome_and_gligen_unets_match_jax(patch):
    """ToMe (level-0 query merging, beside FreeU too) and GLIGEN (a fuser
    in every block, its gates 0.5 and three grounding tokens a row,
    under SAG's capture too: the weights as well) against the JAX UNet
    under the same config, its attention the plain reference (``xla``);
    the fusers' weights cross by the bridge."""
    jcfg = dataclasses.replace(junet.TINY_CONFIG, **patch)
    params = jreg._virtual_params(junet.UNet(jcfg), 7,
                                  jnp.zeros((1, 16, 16, 4)), jnp.zeros((1,)),
                                  jnp.zeros((1, 77, 64)))
    params = jax.tree_util.tree_map_with_path(
        lambda p, v: v + 0.5 if "alpha" in jax.tree_util.keystr(p) else v,
        params)
    model = _load(tunet.UNet(dataclasses.replace(tunet.TINY_CONFIG,
                                                 **patch)), params)
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 16, 16, 4)).astype(np.float32)
    t = np.asarray([999.0, 20.5], np.float32)
    ctx = rng.standard_normal((2, 77, 64)).astype(np.float32)
    kw = {}
    if patch.get("gligen"):
        kw["objs"] = rng.standard_normal((2, 3, 768)).astype(np.float32)
    capture = bool(patch.get("sag_capture"))
    jmod = junet.UNet(jcfg)
    jargs = ({"params": params}, jnp.asarray(x), jnp.asarray(t),
             jnp.asarray(ctx))
    jkw = {k: jnp.asarray(v) for k, v in kw.items()}
    if capture:
        jout, inters = jmod.apply(*jargs, mutable=["intermediates"], **jkw)
        jprobs = jax.tree_util.tree_leaves(inters)[0]
    else:
        jout = jmod.apply(*jargs, **jkw)
    with torch.no_grad():
        tout = model(torch.from_numpy(x), torch.from_numpy(t),
                     torch.from_numpy(ctx), capture=capture,
                     **{k: torch.from_numpy(v) for k, v in kw.items()})
    if capture:
        tout, tprobs = tout
        np.testing.assert_allclose(tprobs.numpy(), np.asarray(jprobs),
                                   **TOL)
    np.testing.assert_allclose(tout.numpy(), np.asarray(jout), **TOL)


def test_control_residuals_raise():
    """ControlNet residuals are ported: a list that does not hold one
    residual a skip raises, as the JAX UNet's strict zip does."""
    model = tunet.UNet(tunet.TINY_CONFIG)
    with pytest.raises(ValueError):
        model(torch.zeros(1, 8, 8, 4), torch.zeros(1), torch.zeros(1, 77, 64),
              control=([], None))
