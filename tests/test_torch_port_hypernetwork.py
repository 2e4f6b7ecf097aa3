"""Hypernetworks in the port (``models/hypernetwork.py``, the value
context of ``models/layers.py``, the denoiser's transform,
HypernetworkLoader) against the JAX package's.

An A1111 file is written with ``torch.save`` (two widths, LayerNorms,
an activation, ``activate_output``) and parsed by both packages; the
virtual hypernetwork of a name, the k/v streams, the UNet with a value
context and sampled tiny graphs (one loader, two chained, from the
file) agree within rtol = atol = 2e-4.  The refusal lists: a
hypernetwork pipeline does not arm the tile tier and continuous
batching refuses it, as in the JAX package."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import comfyui_distributed_tpu.ops.basic  # noqa: F401  (registers the ops)
import comfyui_distributed_tpu_torch.ops.basic  # noqa: F401
from comfyui_distributed_tpu.models import hypernetwork as jhn
from comfyui_distributed_tpu.models import registry as jreg
from comfyui_distributed_tpu.models import unet as junet
from comfyui_distributed_tpu.ops import base as jbase
from comfyui_distributed_tpu.ops.base import Conditioning as JaxCond
from comfyui_distributed_tpu.ops.base import OpContext as JaxOpContext
from comfyui_distributed_tpu.ops.base import get_op as jax_get_op
from comfyui_distributed_tpu.runtime import reuse as jreuse
from comfyui_distributed_tpu_torch.models import hypernetwork as thn
from comfyui_distributed_tpu_torch.models import registry as treg
from comfyui_distributed_tpu_torch.models import unet as tunet
from comfyui_distributed_tpu_torch.models.weights import state_dict_from_flax
from comfyui_distributed_tpu_torch.ops import base as tbase
from comfyui_distributed_tpu_torch.ops.base import Conditioning, OpContext
from comfyui_distributed_tpu_torch.ops.base import get_op

TOL = dict(rtol=2e-4, atol=2e-4)
HN_FILE = "style-hn.pt"


def _np(x):
    if hasattr(x, "to_host"):
        return x.to_host()
    if isinstance(x, torch.Tensor):
        return x.detach().float().cpu().numpy()
    return np.asarray(x, np.float32)


def write_a1111(path, widths=(64, 320), seed=0):
    """An A1111 hypernetwork: per width a [k, v] pair of Sequential
    exports (Linear, LayerNorm, Linear) and the metadata."""
    rng = np.random.default_rng(seed)
    sd = {"activation_func": "swish", "activate_output": True,
          "is_layer_norm": True, "layer_structure": [1, 2, 1],
          "name": "style-hn"}

    def stream(d):
        def t(*shape, scale=0.2):
            return torch.from_numpy(
                (rng.standard_normal(shape) * scale).astype(np.float32))
        return {"linear.0.weight": t(2 * d, d), "linear.0.bias": t(2 * d),
                "linear.1.weight": 1.0 + t(2 * d), "linear.1.bias": t(2 * d),
                "linear.3.weight": t(d, 2 * d), "linear.3.bias": t(d)}

    for d in widths:
        sd[d] = [stream(d), stream(d)]
    os.makedirs(os.path.dirname(path), exist_ok=True)
    torch.save(sd, path)


@pytest.fixture(scope="module")
def env(tmp_path_factory):
    models_dir = tmp_path_factory.mktemp("hn")
    write_a1111(os.path.join(str(models_dir), "hypernetworks", HN_FILE))
    saved = os.environ.get("DTPU_DEFAULT_FAMILY")
    os.environ["DTPU_DEFAULT_FAMILY"] = "tiny"
    for clear in (jreg.clear_pipeline_cache, treg.clear_pipeline_cache,
                  jreuse.get_reuse().clear):
        clear()
    yield (jreg.load_pipeline("hn.ckpt"),
           treg.load_pipeline("hn.ckpt", device="cpu"), str(models_dir))
    jreg.clear_pipeline_cache()
    treg.clear_pipeline_cache()
    if saved is None:
        os.environ.pop("DTPU_DEFAULT_FAMILY", None)
    else:
        os.environ["DTPU_DEFAULT_FAMILY"] = saved


def test_a1111_file_parses_and_applies_like_jax(env):
    """The file's layers (Linear, LayerNorm, swish after every Linear with
    ``activate_output``) and the k/v streams at strength 0.7, at the
    width it holds and (passing through) at one it lacks; the virtual
    hypernetwork of a name is the JAX package's draw."""
    models_dir = env[2]
    jh = jhn.load_hypernetwork(HN_FILE, models_dir=models_dir)
    th = thn.load_hypernetwork(HN_FILE, models_dir=models_dir)
    assert sorted(th) == sorted(jh) == [64, 320]
    for d in th:
        for ts, js in zip(th[d], jh[d], strict=True):
            assert [e[0] for e in ts] == [e[0] for e in js]
            for te, je in zip(ts, js, strict=True):
                for a, b in zip(te[1:], je[1:], strict=True):
                    if isinstance(a, str):
                        assert a == b
                    else:
                        np.testing.assert_array_equal(a, np.asarray(b))
    ctx = np.random.default_rng(1).standard_normal((2, 77, 64)).astype(
        np.float32)
    for hn_t, hn_j in ((th, jh), (thn.load_hypernetwork("virt"),
                                  jhn.load_hypernetwork("virt"))):
        got = thn.apply_hypernetwork_pair(hn_t, 0.7, torch.from_numpy(ctx),
                                          torch.from_numpy(ctx))
        want = jhn.apply_hypernetwork_pair(hn_j, 0.7, jnp.asarray(ctx),
                                           jnp.asarray(ctx))
        for g, w in zip(got, want, strict=True):
            np.testing.assert_allclose(_np(g), np.asarray(w), **TOL)
        assert np.abs(_np(got[0]) - ctx).max() > 1e-3
    odd = torch.zeros((1, 3, 48))
    assert thn.apply_hypernetwork_pair(th, 1.0, odd, odd)[0] is odd


def test_unet_value_context_matches_jax():
    """Every cross-attention's value from ``context_v``, keys from
    ``context``: the tiny UNet against the JAX UNet."""
    params = jreg._virtual_params(junet.UNet(junet.TINY_CONFIG), 7,
                                  jnp.zeros((1, 16, 16, 4)), jnp.zeros((1,)),
                                  jnp.zeros((1, 77, 64)))
    model = tunet.UNet(tunet.TINY_CONFIG)
    model.load_state_dict(state_dict_from_flax(
        model, jax.tree_util.tree_map(np.asarray, params)))
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 16, 16, 4)).astype(np.float32)
    t = np.asarray([999.0, 20.5], np.float32)
    c, cv = (rng.standard_normal((2, 77, 64)).astype(np.float32)
             for _ in range(2))
    want = junet.UNet(junet.TINY_CONFIG).apply(
        {"params": params}, jnp.asarray(x), jnp.asarray(t), jnp.asarray(c),
        context_v=jnp.asarray(cv))
    with torch.no_grad():
        got = model.eval()(torch.from_numpy(x), torch.from_numpy(t),
                           torch.from_numpy(c),
                           context_v=torch.from_numpy(cv))
        plain = model(torch.from_numpy(x), torch.from_numpy(t),
                      torch.from_numpy(c))
    np.testing.assert_allclose(_np(got), np.asarray(want), **TOL)
    assert np.abs(_np(got) - _np(plain)).max() > 1e-3


def _sample(pkg, pipe, pos, neg):
    lat = {"samples": np.zeros((1, 16, 16, 4), np.float32)}
    if pkg == "jax":
        (out,) = jax_get_op("KSampler").execute(
            JaxOpContext(), pipe, 5, 3, 4.0, "euler", "normal",
            JaxCond(context=_np(pos)), JaxCond(context=_np(neg)), lat, 1.0)
        return np.asarray(out["samples"])
    (out,) = get_op("KSampler").execute(
        OpContext(device="cpu"), pipe, 5, 3, 4.0, "euler", "normal",
        Conditioning(context=pos), Conditioning(context=neg), lat, 1.0)
    return _np(out["samples"])


def test_sampled_hypernetwork_graph_matches_jax(env):
    """Two chained HypernetworkLoaders (the virtual one, then the file)
    compose in both packages: the derived pipelines carry the same
    chain, the samples agree and move off the plain one; strength 0
    returns the model."""
    jp, tp, models_dir = env
    chain = (("virt-hn", 0.6), (HN_FILE, 0.8))
    jd, td = jp, tp
    for name, s in chain:
        (jd,) = jax_get_op("HypernetworkLoader").execute(
            JaxOpContext(models_dir=models_dir), jd, name, s)
        (td,) = get_op("HypernetworkLoader").execute(
            OpContext(device="cpu", models_dir=models_dir), td, name, s)
    assert td.hypernet_tag == jd.hypernet_tag
    assert [s for _, s in td.hypernets] == [s for _, s in chain]
    assert td.unet is tp.unet
    pos, neg = tp.encode_prompt(["a fox"])[0], tp.encode_prompt([""])[0]
    got = _sample("torch", td, pos, neg)
    np.testing.assert_allclose(got, _sample("jax", jd, pos, neg), **TOL)
    assert np.abs(got - _sample("torch", tp, pos, neg)).max() > 1e-3
    assert get_op("HypernetworkLoader").execute(
        OpContext(device="cpu"), tp, "virt-hn", 0.0)[0] is tp
    t = tbase.NODE_CLASS_MAPPINGS["HypernetworkLoader"]
    j = jbase.get_op("HypernetworkLoader").__class__
    assert (t.TYPE, list(t.WIDGETS), dict(t.DEFAULTS)) \
        == (j.TYPE, list(j.WIDGETS), dict(j.DEFAULTS))


def test_a_hypernetwork_pipeline_is_refused_by_the_tile_tier_and_cb(
        env, tmp_path):
    """The tile tier does not arm under a hypernetwork pipeline, and the
    continuous-batching bucket build refuses it (``CBIneligible``), as
    in the JAX package."""
    from comfyui_distributed_tpu.ops import tiled_upscale as jtu
    from comfyui_distributed_tpu_torch.ops import tiled_upscale as ttu
    from comfyui_distributed_tpu_torch.workflow import batch_executor as tcb
    jp, tp, _ = env
    (jd,) = jax_get_op("HypernetworkLoader").execute(JaxOpContext(), jp,
                                                     "virt-hn", 1.0)
    (td,) = get_op("HypernetworkLoader").execute(OpContext(device="cpu"),
                                                 tp, "virt-hn", 1.0)
    ctx = tp.encode_prompt(["a fox"])[0]
    tc, jc = Conditioning(context=ctx), JaxCond(context=_np(ctx))
    assert ttu._tile_cache_eligible(tc, tc, tp) \
        and jtu._tile_cache_eligible(jp, jc, jc)
    assert not ttu._tile_cache_eligible(tc, tc, td)
    assert not jtu._tile_cache_eligible(jd, jc, jc)
    doc = {
        "4": {"class_type": "CheckpointLoaderSimple",
              "inputs": {"ckpt_name": "hn.ckpt"}},
        "30": {"class_type": "HypernetworkLoader",
               "inputs": {"model": ["4", 0], "hypernetwork_name": "virt-hn",
                          "strength": 1.0}},
        "5": {"class_type": "EmptyLatentImage",
              "inputs": {"width": 16, "height": 16, "batch_size": 1}},
        "6": {"class_type": "CLIPTextEncode",
              "inputs": {"text": "a fox", "clip": ["4", 1]}},
        "7": {"class_type": "CLIPTextEncode",
              "inputs": {"text": "", "clip": ["4", 1]}},
        "3": {"class_type": "KSampler",
              "inputs": {"seed": 5, "steps": 2, "cfg": 4.0,
                         "sampler_name": "euler", "scheduler": "normal",
                         "denoise": 1.0, "model": ["30", 0],
                         "positive": ["6", 0], "negative": ["7", 0],
                         "latent_image": ["5", 0]}},
    }
    with pytest.raises(tcb.CBIneligible, match="hypernets"):
        tcb._Bucket("sig", {"prompt": doc},
                    OpContext(device="cpu", input_dir=str(tmp_path)), 2)
