"""GLIGEN in the port (``models/gligen.py``, the fusers of
``models/layers.py``, ``ops/basic.py:gligen_attach`` and the sampler's
grounding tokens, GLIGENLoader, GLIGENTextBoxApply) against the JAX
package's.

The Fourier box code and PositionNet (weights carried by the bridge,
and the port's own virtual fill), the grafted fuser pipeline (base
weights shared, the fusers the JAX package's draws), and sampled tiny
graph on three row blocks (two grounding specs and the null set),
with the virtual zero gates (the ungrounded image, to the bit) and with
gates 0.5 on both packages' pipelines, within rtol = atol = 2e-4.  The refusal lists: a grounded conditioning does not arm the tile
tier and continuous batching refuses it, as in the JAX package."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import comfyui_distributed_tpu.ops.basic as jbasic
import comfyui_distributed_tpu_torch.ops.basic as tbasic
from comfyui_distributed_tpu.models import gligen as jgl
from comfyui_distributed_tpu.models import registry as jreg
from comfyui_distributed_tpu.ops import base as jbase
from comfyui_distributed_tpu.ops.base import Conditioning as JaxCond
from comfyui_distributed_tpu.ops.base import OpContext as JaxOpContext
from comfyui_distributed_tpu.ops.base import get_op as jax_get_op
from comfyui_distributed_tpu.runtime import reuse as jreuse
from comfyui_distributed_tpu_torch.models import gligen as tgl
from comfyui_distributed_tpu_torch.models import registry as treg
from comfyui_distributed_tpu_torch.models.weights import (
    gligen_from_flax,
    state_dict_from_flax,
)
from comfyui_distributed_tpu_torch.ops import base as tbase
from comfyui_distributed_tpu_torch.ops.base import Conditioning, OpContext
from comfyui_distributed_tpu_torch.ops.base import get_op

TOL = dict(rtol=2e-4, atol=2e-4)
GLIGEN = "gligen_sd14_textbox_pruned.safetensors"


def _np(x):
    if hasattr(x, "to_host"):
        return x.to_host()
    if isinstance(x, torch.Tensor):
        return x.detach().float().cpu().numpy()
    return np.asarray(x, np.float32)


def _clear():
    for clear in (jreg.clear_pipeline_cache, treg.clear_pipeline_cache,
                  jreuse.get_reuse().clear):
        clear()


@pytest.fixture(scope="module")
def env():
    saved = os.environ.get("DTPU_DEFAULT_FAMILY")
    os.environ["DTPU_DEFAULT_FAMILY"] = "tiny"
    _clear()
    yield (jreg.load_pipeline("gligen.ckpt"),
           treg.load_pipeline("gligen.ckpt", device="cpu"))
    _clear()
    if saved is None:
        os.environ.pop("DTPU_DEFAULT_FAMILY", None)
    else:
        os.environ["DTPU_DEFAULT_FAMILY"] = saved


def test_fourier_code_and_position_net_match_jax():
    """Boxes, phrases and a mask with a dead entry: the Fourier code and
    the grounding tokens, from the JAX tree through the bridge and from
    the port's own virtual fill of the name."""
    rng = np.random.default_rng(0)
    boxes = rng.uniform(0, 1, (2, 3, 4)).astype(np.float32)
    np.testing.assert_allclose(
        _np(tgl.fourier_box_embed(torch.from_numpy(boxes))),
        np.asarray(jgl.fourier_box_embed(jnp.asarray(boxes))), **TOL)
    embs = rng.standard_normal((2, 3, 768)).astype(np.float32)
    masks = np.asarray([[1, 1, 0], [1, 0, 0]], np.float32)
    jg = jgl.load_gligen(GLIGEN)
    want = np.asarray(jg.grounding_tokens(embs, boxes, masks))
    net = tgl.PositionNet(tgl.GligenConfig())
    net.load_state_dict(gligen_from_flax(
        net.cfg, jax.tree_util.tree_map(np.asarray, jg.params)))
    with torch.no_grad():
        got = net(*(torch.from_numpy(a) for a in (embs, boxes, masks)))
    np.testing.assert_allclose(_np(got), want, **TOL)
    tg = tgl.load_gligen(GLIGEN, device="cpu")
    np.testing.assert_allclose(_np(tg.grounding_tokens(embs, boxes, masks)),
                               want, **TOL)


def test_attach_grafts_the_jax_packages_fusers(env):
    """The fuser pipeline shares every base weight and holds the JAX
    package's virtual fusers (gates 0 by the rule)."""
    jp, tp = env
    jd = jbasic.gligen_attach(jp, jgl.load_gligen(GLIGEN))
    td = tbasic.gligen_attach(tp, tgl.load_gligen(GLIGEN, device="cpu"))
    assert td.family.unet.gligen == jd.family.unet.gligen == 768
    assert td.unet.conv_in.weight is tp.unet.conv_in.weight
    assert td.unet.down_0_attn_0.blocks_0.attn1.to_q.weight \
        is tp.unet.down_0_attn_0.blocks_0.attn1.to_q.weight
    want = state_dict_from_flax(td.unet, jax.tree_util.tree_map(
        np.asarray, jd.unet_params))
    fusers = [k for k in want if ".fuser." in k]
    assert len(fusers) == 7 * 17   # 7 blocks x 17 leaves a fuser
    sd = td.unet.state_dict()
    for k in fusers:
        np.testing.assert_array_equal(_np(sd[k]), _np(want[k]), err_msg=k)
    assert float(td.unet.mid_attn.blocks_0.fuser.alpha_attn) == 0.0
    assert tbasic.gligen_attach(tp, tgl.load_gligen(GLIGEN, device="cpu")) \
        is td


def _ground(pkg, pipe, cond, g, boxes):
    """GLIGENTextBoxApply of each (text, width, height, x, y)."""
    for box in boxes:
        if pkg == "jax":
            (cond,) = jax_get_op("GLIGENTextBoxApply").execute(
                JaxOpContext(), cond, pipe, g, *box)
        else:
            (cond,) = get_op("GLIGENTextBoxApply").execute(
                OpContext(device="cpu"), cond, pipe, g, *box)
    return cond


def _sample(pkg, pipe, pos, neg):
    lat = {"samples": np.zeros((1, 16, 16, 4), np.float32)}
    if pkg == "jax":
        (out,) = jax_get_op("KSampler").execute(
            JaxOpContext(), pipe, 5, 3, 4.0, "euler", "normal", pos, neg,
            lat, 1.0)
        return np.asarray(out["samples"])
    (out,) = get_op("KSampler").execute(
        OpContext(device="cpu"), pipe, 5, 3, 4.0, "euler", "normal", pos,
        neg, lat, 1.0)
    return _np(out["samples"])


def test_sampled_grounded_graph_matches_jax(env):
    """GLIGENLoader + GLIGENTextBoxApply + KSampler on three row blocks:
    a positive grounded on two boxes, bundled by ConditioningCombine with
    a plain entry (the null set), and a negative grounded on a box of its
    own (a second spec).  With the virtual zero gates the port's image
    is the ungrounded one to the bit; with gates 0.5 on both packages'
    fuser pipelines the samples agree and move."""
    jp, tp = env
    (jg,) = jax_get_op("GLIGENLoader").execute(JaxOpContext(), GLIGEN)
    (tg,) = get_op("GLIGENLoader").execute(OpContext(device="cpu"), GLIGEN)
    pos, neg = tp.encode_prompt(["a fox"])[0], tp.encode_prompt([""])[0]
    other = tp.encode_prompt(["a hat"])[0]
    boxes = (("a red fox", 64, 48, 16, 32), ("a hat", 32, 32, 80, 8))
    wall = (("a wall", 32, 64, 96, 0),)

    def conds(pkg):
        if pkg == "jax":
            c, op, octx = JaxCond, jax_get_op, JaxOpContext()
            pipe, g, a, b, n = jp, jg, _np(pos), _np(other), _np(neg)
        else:
            c, op, octx = Conditioning, get_op, OpContext(device="cpu")
            pipe, g, a, b, n = tp, tg, pos, other, neg
        (p,) = op("ConditioningCombine").execute(
            octx, _ground(pkg, pipe, c(context=a), g, boxes), c(context=b))
        return p, _ground(pkg, pipe, c(context=n), g, wall)

    tpos, tneg = conds("torch")
    jpos, jneg = conds("jax")
    assert tpos.siblings[0].gligen is None
    assert [b for _, b in tpos.gligen[1]] == [b for _, b in jpos.gligen[1]]
    for (te, _), (je, _) in zip(tpos.gligen[1], jpos.gligen[1], strict=True):
        np.testing.assert_allclose(te, np.asarray(je), **TOL)
    (plain_pos,) = get_op("ConditioningCombine").execute(
        OpContext(device="cpu"), Conditioning(context=pos),
        Conditioning(context=other))
    plain = _sample("torch", tp, plain_pos, Conditioning(context=neg))
    np.testing.assert_array_equal(_sample("torch", tp, tpos, tneg), plain)
    try:
        jd = jbasic.gligen_attach(jp, jg)
        jd.unet_params = jax.tree_util.tree_map_with_path(
            lambda p, v: v + 0.5 if "alpha" in jax.tree_util.keystr(p)
            else v, jd.unet_params)
        td = tbasic.gligen_attach(tp, tg)
        with torch.no_grad():
            for name, p in td.unet.named_parameters():
                if "alpha" in name:
                    p.fill_(0.5)
        got = _sample("torch", td, tpos, tneg)
        np.testing.assert_allclose(got, _sample("jax", jd, jpos, jneg), **TOL)
        assert np.abs(got - plain).max() > 1e-3
    finally:
        # the gated pipelines are cached: later tests start from the draw
        jreg._derived_cache.clear()
        treg._derived_cache.clear()
    for name in ("GLIGENLoader", "GLIGENTextBoxApply"):
        t = tbase.NODE_CLASS_MAPPINGS[name]
        j = jbase.get_op(name).__class__
        assert (t.TYPE, list(t.WIDGETS), dict(t.DEFAULTS)) \
            == (j.TYPE, list(j.WIDGETS), dict(j.DEFAULTS))


def test_a_grounded_conditioning_is_refused_by_the_tile_tier_and_cb(
        env, tmp_path):
    """The tile tier does not arm for a grounded conditioning, and the
    continuous-batching bucket build refuses a grounded graph
    (``CBIneligible``), as in the JAX package."""
    from comfyui_distributed_tpu.ops import tiled_upscale as jtu
    from comfyui_distributed_tpu_torch.ops import tiled_upscale as ttu
    from comfyui_distributed_tpu_torch.workflow import batch_executor as tcb
    jp, tp = env
    ctx = tp.encode_prompt(["a fox"])[0]
    (tg,) = get_op("GLIGENLoader").execute(OpContext(device="cpu"), GLIGEN)
    (jg,) = jax_get_op("GLIGENLoader").execute(JaxOpContext(), GLIGEN)
    box = (("a fox", 64, 64, 0, 0),)
    tc = _ground("torch", tp, Conditioning(context=ctx), tg, box)
    jc = _ground("jax", jp, JaxCond(context=_np(ctx)), jg, box)
    plain_t, plain_j = Conditioning(context=ctx), JaxCond(context=_np(ctx))
    assert ttu._tile_cache_eligible(plain_t, plain_t, tp)
    assert jtu._tile_cache_eligible(jp, plain_j, plain_j)
    assert not ttu._tile_cache_eligible(tc, plain_t, tp)
    assert not jtu._tile_cache_eligible(jp, jc, plain_j)
    doc = {
        "4": {"class_type": "CheckpointLoaderSimple",
              "inputs": {"ckpt_name": "gligen.ckpt"}},
        "10": {"class_type": "GLIGENLoader",
               "inputs": {"gligen_name": GLIGEN}},
        "5": {"class_type": "EmptyLatentImage",
              "inputs": {"width": 16, "height": 16, "batch_size": 1}},
        "6": {"class_type": "CLIPTextEncode",
              "inputs": {"text": "a fox", "clip": ["4", 1]}},
        "11": {"class_type": "GLIGENTextBoxApply",
               "inputs": {"conditioning_to": ["6", 0], "clip": ["4", 1],
                          "gligen_textbox_model": ["10", 0],
                          "text": "a fox", "width": 64, "height": 64,
                          "x": 0, "y": 0}},
        "7": {"class_type": "CLIPTextEncode",
              "inputs": {"text": "", "clip": ["4", 1]}},
        "3": {"class_type": "KSampler",
              "inputs": {"seed": 5, "steps": 2, "cfg": 4.0,
                         "sampler_name": "euler", "scheduler": "normal",
                         "denoise": 1.0, "model": ["4", 0],
                         "positive": ["11", 0], "negative": ["7", 0],
                         "latent_image": ["5", 0]}},
    }
    with pytest.raises(tcb.CBIneligible, match="plain single-entry"):
        tcb._Bucket("sig", {"prompt": doc},
                    OpContext(device="cpu", input_dir=str(tmp_path)), 2)
