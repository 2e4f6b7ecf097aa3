"""Style models in the port (``models/style_model.py``,
StyleModelLoader, StyleModelApply) against the JAX package's.

The adapter's style tokens from the tiny CLIP-vision tower's
penultimate hidden states (weights through the bridge, and the port's
own virtual fill of the name), the conditioning StyleModelApply makes
(on a sibling too) and a sampled tiny graph on it, within rtol = atol =
2e-4."""

import os

import jax
import numpy as np
import pytest
import torch

import comfyui_distributed_tpu.ops.basic  # noqa: F401  (registers the ops)
import comfyui_distributed_tpu_torch.ops.basic  # noqa: F401
from comfyui_distributed_tpu.models import registry as jreg
from comfyui_distributed_tpu.models import style_model as jsm
from comfyui_distributed_tpu.ops import base as jbase
from comfyui_distributed_tpu.ops.base import Conditioning as JaxCond
from comfyui_distributed_tpu.ops.base import OpContext as JaxOpContext
from comfyui_distributed_tpu.ops.base import get_op as jax_get_op
from comfyui_distributed_tpu.runtime import reuse as jreuse
from comfyui_distributed_tpu_torch.models import registry as treg
from comfyui_distributed_tpu_torch.models import style_model as tsm
from comfyui_distributed_tpu_torch.models.weights import (
    style_adapter_from_flax,
)
from comfyui_distributed_tpu_torch.ops import base as tbase
from comfyui_distributed_tpu_torch.ops.base import Conditioning, OpContext
from comfyui_distributed_tpu_torch.ops.base import get_op

TOL = dict(rtol=2e-4, atol=2e-4)
STYLE = "tiny-style.pth"
VISION = "tiny-style-vision"


def _np(x):
    if hasattr(x, "to_host"):
        return x.to_host()
    if isinstance(x, torch.Tensor):
        return x.detach().float().cpu().numpy()
    return np.asarray(x, np.float32)


@pytest.fixture(scope="module")
def env():
    saved = os.environ.get("DTPU_DEFAULT_FAMILY")
    os.environ["DTPU_DEFAULT_FAMILY"] = "tiny"
    for clear in (jreg.clear_pipeline_cache, treg.clear_pipeline_cache,
                  jreuse.get_reuse().clear):
        clear()
    img = np.random.default_rng(3).uniform(0, 1, (1, 64, 64, 3)).astype(
        np.float32)
    (jvis,) = jax_get_op("CLIPVisionEncode").execute(
        JaxOpContext(), jreg.load_clip_vision(VISION), img, "center")
    (tvis,) = get_op("CLIPVisionEncode").execute(
        OpContext(device="cpu"), treg.load_clip_vision(VISION, device="cpu"),
        img, "center")
    yield (jreg.load_pipeline("style.ckpt"),
           treg.load_pipeline("style.ckpt", device="cpu"), jvis, tvis)
    jreg.clear_pipeline_cache()
    treg.clear_pipeline_cache()
    if saved is None:
        os.environ.pop("DTPU_DEFAULT_FAMILY", None)
    else:
        os.environ["DTPU_DEFAULT_FAMILY"] = saved


def test_style_tokens_match_jax(env):
    """The tiny adapter's two tokens from the penultimate hidden states:
    the JAX tree through the bridge and the port's own virtual fill."""
    _, _, jvis, tvis = env
    np.testing.assert_allclose(_np(tvis.penultimate_hidden),
                               np.asarray(jvis.penultimate_hidden), **TOL)
    js = jsm.load_style_model(STYLE)
    want = np.asarray(js.get_cond(jvis))
    assert want.shape == (1, 2, 64)
    net = tsm.StyleAdapter(tsm.TINY_STYLE_CONFIG)
    net.load_state_dict(style_adapter_from_flax(
        net.cfg, jax.tree_util.tree_map(np.asarray, js.params)))
    with torch.no_grad():
        got = net(tvis.penultimate_hidden.float())
    np.testing.assert_allclose(_np(got), want, **TOL)
    ts = tsm.load_style_model(STYLE, device="cpu")
    assert ts.cfg == tsm.TINY_STYLE_CONFIG
    np.testing.assert_allclose(_np(ts.get_cond(tvis)), want, **TOL)
    for tc, jc in ((tsm.STYLE_CONFIG, jsm.STYLE_CONFIG),
                   (tsm.TINY_STYLE_CONFIG, jsm.TINY_STYLE_CONFIG)):
        fields = ("width", "layers", "heads", "num_tokens", "context_dim")
        assert [getattr(tc, f) for f in fields] \
            == [getattr(jc, f) for f in fields]


def test_style_model_apply_and_sampling_match_jax(env):
    """StyleModelApply appends the tokens to the entry and its sibling;
    KSampler on the styled positive agrees with the JAX package's and
    moves off the plain sample."""
    jp, tp, jvis, tvis = env
    (jsmod,) = jax_get_op("StyleModelLoader").execute(JaxOpContext(), STYLE)
    (tsmod,) = get_op("StyleModelLoader").execute(OpContext(device="cpu"),
                                                  STYLE)
    pos, neg = tp.encode_prompt(["a fox"])[0], tp.encode_prompt([""])[0]
    other = tp.encode_prompt(["a hat"])[0]
    tcond = Conditioning(context=pos, siblings=(Conditioning(context=other),))
    jcond = JaxCond(context=_np(pos),
                    siblings=(JaxCond(context=_np(other)),))
    (tout,) = get_op("StyleModelApply").execute(OpContext(device="cpu"),
                                                tcond, tsmod, tvis)
    (jout,) = jax_get_op("StyleModelApply").execute(JaxOpContext(), jcond,
                                                    jsmod, jvis)
    assert tout.context.shape == (1, 79, 64)
    for t, j in ((tout, jout), (tout.siblings[0], jout.siblings[0])):
        np.testing.assert_allclose(_np(t.context), np.asarray(j.context),
                                   **TOL)
    lat = {"samples": np.zeros((1, 16, 16, 4), np.float32)}
    (jk,) = jax_get_op("KSampler").execute(
        JaxOpContext(), jp, 5, 3, 4.0, "euler", "normal",
        JaxCond(context=np.asarray(jout.context)),
        JaxCond(context=_np(neg)), lat, 1.0)

    def sample(cond):
        (out,) = get_op("KSampler").execute(
            OpContext(device="cpu"), tp, 5, 3, 4.0, "euler", "normal", cond,
            Conditioning(context=neg), lat, 1.0)
        return _np(out["samples"])

    got = sample(Conditioning(context=tout.context))
    np.testing.assert_allclose(got, np.asarray(jk["samples"]), **TOL)
    assert np.abs(got - sample(Conditioning(context=pos))).max() > 1e-3
    for name in ("StyleModelLoader", "StyleModelApply"):
        t = tbase.NODE_CLASS_MAPPINGS[name]
        j = jbase.get_op(name).__class__
        assert (t.TYPE, list(t.WIDGETS), dict(t.DEFAULTS)) \
            == (j.TYPE, list(j.WIDGETS), dict(j.DEFAULTS))
