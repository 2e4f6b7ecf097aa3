"""ToMe in the port (``models/tome.py``, the level-0 merge in
``models/layers.py``, TomePatchModel) against the JAX package's.

``build_merge``'s destination grid and merge/unmerge indices are
compared exactly (on one-hot token features, whose means are exact);
the tiny UNet with ToMe, the op's derived pipeline and a sampled tiny
graph within rtol = atol = 2e-4.  fp32, numpy inputs from a seed."""

import os
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import comfyui_distributed_tpu.ops.basic  # noqa: F401  (registers the ops)
import comfyui_distributed_tpu_torch.ops.basic  # noqa: F401
from comfyui_distributed_tpu.models import registry as jreg
from comfyui_distributed_tpu.models import tome as jtome
from comfyui_distributed_tpu.ops import base as jbase
from comfyui_distributed_tpu.ops.base import Conditioning as JaxCond
from comfyui_distributed_tpu.ops.base import OpContext as JaxOpContext
from comfyui_distributed_tpu.ops.base import get_op as jax_get_op
from comfyui_distributed_tpu.runtime import reuse as jreuse
from comfyui_distributed_tpu_torch.models import registry as treg
from comfyui_distributed_tpu_torch.models import tome as ttome
from comfyui_distributed_tpu_torch.ops import base as tbase
from comfyui_distributed_tpu_torch.ops.base import Conditioning, OpContext
from comfyui_distributed_tpu_torch.ops.base import get_op

TOL = dict(rtol=2e-4, atol=2e-4)


def _np(x):
    if hasattr(x, "to_host"):
        return x.to_host()
    if isinstance(x, torch.Tensor):
        return x.detach().float().cpu().numpy()
    return np.asarray(x, np.float32)


@pytest.fixture(scope="module")
def pipes():
    saved = os.environ.get("DTPU_DEFAULT_FAMILY")
    os.environ["DTPU_DEFAULT_FAMILY"] = "tiny"
    for clear in (jreg.clear_pipeline_cache, treg.clear_pipeline_cache,
                  jreuse.get_reuse().clear):
        clear()
    yield (jreg.load_pipeline("tome.ckpt"),
           treg.load_pipeline("tome.ckpt", device="cpu"))
    jreg.clear_pipeline_cache()
    treg.clear_pipeline_cache()
    if saved is None:
        os.environ.pop("DTPU_DEFAULT_FAMILY", None)
    else:
        os.environ["DTPU_DEFAULT_FAMILY"] = saved


@pytest.mark.parametrize("h,w", [(8, 8), (7, 9), (64, 64), (5, 4)])
def test_dst_grid_equals_jax(h, w):
    for got, want in zip(ttome.dst_grid_indices(h, w),
                         jtome.dst_grid_indices(h, w), strict=True):
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("h,w,ratio", [(8, 8, 0.5), (16, 16, 0.3),
                                       (7, 9, 0.6), (8, 8, 0.0),
                                       (4, 4, 0.9)])
def test_build_merge_indices_equal_jax(h, w, ratio):
    """On one-hot token features the merge's rows are exact means of the
    members it pooled and the unmerge's rows the token ids it placed, so
    equal arrays mean equal indices; r equal too."""
    rng = np.random.default_rng(int(h * w + 100 * ratio))
    n = h * w
    metric = rng.standard_normal((2, n, 12)).astype(np.float32)
    jm, ju, jr = jtome.build_merge(jnp.asarray(metric), h, w, ratio)
    # one compiled program each instead of an eager compile an op
    jm, ju = jax.jit(jm), jax.jit(ju)
    tm, tu, tr = ttome.build_merge(torch.from_numpy(metric), h, w, ratio)
    assert tr == jr
    onehot = np.broadcast_to(np.eye(n, dtype=np.float32), (2, n, n)).copy()
    merged = _np(tm(torch.from_numpy(onehot)))
    np.testing.assert_array_equal(merged, np.asarray(jm(jnp.asarray(onehot))))
    assert merged.shape == (2, n - jr, n)
    ids = np.broadcast_to(np.arange(n - jr, dtype=np.float32)[None, :, None],
                          (2, n - jr, 1)).copy()
    np.testing.assert_array_equal(_np(tu(torch.from_numpy(ids))),
                                  np.asarray(ju(jnp.asarray(ids))))


def test_tome_op_derives_a_shared_pipeline_like_jax(pipes):
    """TomePatchModel: the JAX package's clipped ratio in a derived
    pipeline sharing the base's weights (cached per ratio); ratio 0 and
    a family without level-0 attention return the model itself."""
    jp, tp = pipes
    tctx = OpContext(device="cpu")
    for ratio, want in ((0.3, 0.3), (1.5, 0.9), (-1.0, 0.0)):
        (jd,) = jax_get_op("TomePatchModel").execute(JaxOpContext(), jp,
                                                     ratio)
        (td,) = get_op("TomePatchModel").execute(tctx, tp, ratio)
        assert td.family.unet.tome_ratio == jd.family.unet.tome_ratio == want
        if want == 0.0:
            assert td is tp
            continue
        assert td.unet.cfg.tome_ratio == want
        assert td.unet.conv_in.weight is tp.unet.conv_in.weight
        assert get_op("TomePatchModel").execute(tctx, tp, ratio)[0] is td
    sdxl_like = types.SimpleNamespace(family=treg.get_family("sdxl"))
    assert get_op("TomePatchModel").execute(tctx, sdxl_like, 0.5)[0] \
        is sdxl_like
    t = tbase.NODE_CLASS_MAPPINGS["TomePatchModel"]
    j = jbase.get_op("TomePatchModel").__class__
    assert (t.TYPE, list(t.WIDGETS), dict(t.DEFAULTS)) \
        == (j.TYPE, list(j.WIDGETS), dict(j.DEFAULTS))


def test_sampled_tome_graph_matches_jax(pipes):
    """KSampler on TomePatchModel(0.5) in both packages: the samples
    agree and differ from the plain pipeline's."""
    jp, tp = pipes
    (jd,) = jax_get_op("TomePatchModel").execute(JaxOpContext(), jp, 0.5)
    (td,) = get_op("TomePatchModel").execute(OpContext(device="cpu"), tp,
                                             0.5)
    pos, neg = tp.encode_prompt(["a fox"])[0], tp.encode_prompt([""])[0]
    lat = {"samples": np.zeros((1, 16, 16, 4), np.float32)}

    def sample(pkg, pipe):
        if pkg == "jax":
            (out,) = jax_get_op("KSampler").execute(
                JaxOpContext(), pipe, 5, 3, 4.0, "euler", "normal",
                JaxCond(context=_np(pos)), JaxCond(context=_np(neg)), lat,
                1.0)
            return np.asarray(out["samples"])
        (out,) = get_op("KSampler").execute(
            OpContext(device="cpu"), pipe, 5, 3, 4.0, "euler", "normal",
            Conditioning(context=pos), Conditioning(context=neg), lat, 1.0)
        return _np(out["samples"])

    got = sample("torch", td)
    np.testing.assert_allclose(got, sample("jax", jd), **TOL)
    assert np.abs(got - sample("torch", tp)).max() > 1e-3
