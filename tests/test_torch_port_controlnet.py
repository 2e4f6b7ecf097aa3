"""ControlNet in the port against the JAX package: the module and its
residuals, the ``control_model.*`` converter both ways, the loaders
(virtual, from a file with its family inferred, the difference loader),
the denoiser's chain with per-block strengths and sigma windows, the ops
(ControlNetApply, ControlNetApplyAdvanced) through KSampler, the routing
(continuous batching and coalescing refuse a control, the tile tier does
not arm under one) and a ControlNet txt2img fanned out over HTTP.

Both packages get the same numpy inputs and the same weights (the
virtual ones, drawn by one rule, or a JAX tree carried across by
``weights.controlnet_from_flax``).  The tiny family in fp32; modules,
single model calls and samples agree within rtol = atol = 2e-4.  A
virtual net's zero projections make it an exact no-op: those checks
are to the bit."""

import copy
import dataclasses
import os
import pathlib
import subprocess
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from comfyui_distributed_tpu.models import checkpoints as jckpt
from comfyui_distributed_tpu.models import controlnet as jcn
from comfyui_distributed_tpu.models import denoiser as jden
from comfyui_distributed_tpu.models import registry as jreg
from comfyui_distributed_tpu.models import unet as junet
from comfyui_distributed_tpu.ops.base import Conditioning as JaxCond
from comfyui_distributed_tpu.ops.base import OpContext as JaxOpContext
from comfyui_distributed_tpu.ops.base import get_op as jax_get_op
from comfyui_distributed_tpu.runtime import reuse as jreuse
from comfyui_distributed_tpu.workflow import batch_executor as jcb
from comfyui_distributed_tpu.workflow import scheduler as jsched
from comfyui_distributed_tpu_torch.models import checkpoints as tckpt
from comfyui_distributed_tpu_torch.models import controlnet as tcn
from comfyui_distributed_tpu_torch.models import denoiser as tden
from comfyui_distributed_tpu_torch.models import registry as treg
from comfyui_distributed_tpu_torch.models.weights import (
    controlnet_from_flax, state_dict_from_flax)
from comfyui_distributed_tpu_torch.ops import basic as tbasic
from comfyui_distributed_tpu_torch.ops import tiled_upscale as ttiled
from comfyui_distributed_tpu_torch.ops.base import Conditioning, OpContext
from comfyui_distributed_tpu_torch.ops.base import get_op
from comfyui_distributed_tpu_torch.utils.image import (decode_png, save_png,
                                                       to_uint8)
from comfyui_distributed_tpu_torch.utils.net import (find_free_port,
                                                     get_json, post_json)
from comfyui_distributed_tpu_torch.workflow import WorkflowExecutor
from comfyui_distributed_tpu_torch.workflow import batch_executor as tcb
from comfyui_distributed_tpu_torch.workflow import scheduler as tsched

ROOT = pathlib.Path(__file__).resolve().parents[1]
TOL = dict(rtol=2e-4, atol=2e-4)
CPU = torch.device("cpu")
CKPT = "cn-base.ckpt"
CN_NAME = "tiny_cn.safetensors"


def _np(x):
    if hasattr(x, "to_host"):
        return x.to_host()
    if isinstance(x, torch.Tensor):
        return x.detach().float().cpu().numpy()
    return np.asarray(x, np.float32)


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _clear():
    for clear in (jreg.clear_pipeline_cache, treg.clear_pipeline_cache,
                  jreuse.get_reuse().clear):
        clear()


@pytest.fixture(scope="module")
def env():
    """The tiny family in both packages and every cache empty, for the
    whole module (each test builds what it needs by name)."""
    saved = os.environ.get("DTPU_DEFAULT_FAMILY")
    os.environ["DTPU_DEFAULT_FAMILY"] = "tiny"
    _clear()
    yield
    _clear()
    if saved is None:
        os.environ.pop("DTPU_DEFAULT_FAMILY", None)
    else:
        os.environ["DTPU_DEFAULT_FAMILY"] = saved


def _live_params(params, seed=11):
    """A JAX ControlNet tree with its zero projections drawn (the
    virtual rule at another seed) in place of zeros: a 'trained' net."""
    cfg = junet.TINY_CONFIG
    other = jreg._virtual_params(
        jcn.ControlNet(cfg), seed, jnp.zeros((1, 8, 8, 4)), jnp.zeros((1,)),
        jnp.zeros((1, 77, cfg.context_dim)), jnp.zeros((1, 64, 64, 3)))
    return {k: (other[k] if tcn.is_zero_projection(k) else v)
            for k, v in params.items()}


def _port_net(cfg, flax_params):
    """The port's ControlNet holding a JAX tree's weights."""
    sd = controlnet_from_flax(cfg, _np_tree(flax_params))
    return treg._build(lambda: tcn.ControlNet(cfg), CPU, torch.float32,
                       lambda m: tckpt.load_into(m, sd))


@pytest.fixture(scope="module")
def nets(env):
    """Two live nets (JAX module and params, the port's copy) and the
    virtual net of ``CN_NAME`` in both packages."""
    jm, jp = jreg.load_controlnet(CN_NAME)
    live = []
    for seed in (11, 12):
        p = _live_params(jp, seed)
        live.append(((jm, p), _port_net(treg.get_family("tiny").unet, p)))
    return {"virtual": ((jm, jp), treg.load_controlnet(CN_NAME, device=CPU)),
            "live": live}


def _inputs(B=2, h=8, w=8, seed=1, ctx_dim=64):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, h, w, 4)).astype(np.float32),
            np.asarray([999.0, 20.5][:B] + [300.0] * max(B - 2, 0),
                       np.float32),
            rng.standard_normal((B, 16, ctx_dim)).astype(np.float32),
            rng.uniform(size=(B, h * 8, w * 8, 3)).astype(np.float32))


# --- the module ----------------------------------------------------------------

def test_virtual_net_equals_the_jax_packages_and_is_a_noop(nets):
    """The virtual net's weights are the JAX package's (zero projections
    included); one residual a UNet skip (conv_in, each res block, each
    downsample) plus the middle's; all zero, so the UNet's output with
    them is its output without, to the bit."""
    (jm, jp), net = nets["virtual"]
    want = controlnet_from_flax(net.cfg, _np_tree(jp))
    got = net.state_dict()
    assert set(got) == set(want)
    for k in want:
        assert torch.equal(got[k], want[k]), k
    cfg = net.cfg
    n_skips = 1 + sum(cfg.num_res_blocks + (lvl != cfg.num_levels - 1)
                      for lvl in range(cfg.num_levels))
    pipe = treg.load_pipeline(CKPT, device=CPU)
    x, t, c, hint = (torch.from_numpy(a) for a in _inputs())
    with torch.no_grad():
        outs, mid = net(x, t, c, hint)
        assert len(outs) == n_skips == net.n_skips
        assert mid.shape[1] == cfg.model_channels * cfg.channel_mult[-1]
        assert all(not o.any() for o in outs) and not mid.any()
        base = pipe.unet(x, t, c)
        ctrl = pipe.unet(x, t, c, control=(outs, mid))
    assert torch.equal(base, ctrl)
    with pytest.raises(ValueError):
        pipe.unet(x, t, c, control=(outs[:-1], mid))


@pytest.mark.parametrize("adm", [None, 128], ids=["tiny", "tiny_sdxl"])
def test_live_residuals_and_controlled_unet_match_jax(adm):
    """A net with drawn projections: its residuals and the UNet fed them
    against the JAX package's (the SDXL-shaped case feeds the ADM vector
    to both the net and the UNet)."""
    jcfg = dataclasses.replace(junet.TINY_CONFIG, adm_in_channels=adm)
    tcfg = dataclasses.replace(treg.get_family("tiny").unet,
                               adm_in_channels=adm)
    x, t, c, hint = _inputs()
    y = None if adm is None else np.random.default_rng(4).standard_normal(
        (2, adm)).astype(np.float32)
    cp = _live_params(jreg._virtual_params(
        jcn.ControlNet(jcfg), 5, jnp.zeros((1, 8, 8, 4)), jnp.zeros((1,)),
        jnp.zeros((1, 77, 64)), jnp.zeros((1, 64, 64, 3))))
    up = jreg._virtual_params(junet.UNet(jcfg), 6, jnp.zeros((1, 8, 8, 4)),
                              jnp.zeros((1,)), jnp.zeros((1, 77, 64)))
    jargs = [jnp.asarray(a) for a in (x, t, c)]
    jy = None if y is None else jnp.asarray(y)
    jouts, jmid = jcn.ControlNet(jcfg).apply({"params": cp}, *jargs,
                                             jnp.asarray(hint), jy)
    jout = junet.UNet(jcfg).apply({"params": up}, *jargs, y=jy,
                                  control=(list(jouts), jmid))
    net = _port_net(tcfg, cp)
    from comfyui_distributed_tpu_torch.models.unet import UNet
    unet = UNet(tcfg)
    unet.load_state_dict(state_dict_from_flax(unet, _np_tree(up)))
    targs = [torch.from_numpy(a) for a in (x, t, c)]
    ty = None if y is None else torch.from_numpy(y)
    with torch.no_grad():
        touts, tmid = net(*targs, torch.from_numpy(hint), ty)
        tout = unet.eval()(*targs, ty, control=(touts, tmid))
    assert len(touts) == len(jouts)
    for i, (a, b) in enumerate(zip(touts, jouts)):
        np.testing.assert_allclose(_np(a.permute(0, 2, 3, 1)),
                                   np.asarray(b), err_msg=f"residual {i}",
                                   **TOL)
    np.testing.assert_allclose(_np(tmid.permute(0, 2, 3, 1)),
                               np.asarray(jmid), **TOL)
    assert np.abs(np.asarray(jmid)).max() > 1e-2
    np.testing.assert_allclose(_np(tout), np.asarray(jout), **TOL)


# --- files ---------------------------------------------------------------------

@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_converter_round_trip_across_packages(nets, tmp_path, writer):
    """A ``control_model.*`` file written by one package and read by the
    other gives the writer's weights, leaf for leaf; both walks name the
    same keys."""
    from safetensors.numpy import save_file
    (jm, jp), net = nets["live"][0]
    cfg = net.cfg
    path = tmp_path / "cn.safetensors"
    if writer == "jax":
        sd = jckpt.export_controlnet(jp, junet.TINY_CONFIG)
        save_file({k: np.ascontiguousarray(v, np.float32)
                   for k, v in sd.items()}, str(path))
        got = tckpt.load_controlnet(str(path), cfg)
        want = controlnet_from_flax(cfg, _np_tree(jp))
        assert set(got) == set(want)
        for k in want:
            assert torch.equal(got[k].float(), want[k]), k
        assert set(tckpt.export_controlnet(net, cfg)) == set(sd)
    else:
        tckpt.write_safetensors(tckpt.export_controlnet(net, cfg), str(path))
        got = jckpt.load_controlnet(str(path), junet.TINY_CONFIG)
        flat = dict(jax.tree_util.tree_leaves_with_path(got))
        want = dict(jax.tree_util.tree_leaves_with_path(jp))
        assert set(flat) == set(want)
        for k, v in want.items():
            np.testing.assert_array_equal(np.asarray(flat[k]),
                                          np.asarray(v), err_msg=str(k))


def test_family_inferred_from_the_file(nets, tmp_path):
    """With a file on disk the net's family is the file's (its
    cross-attention width), whatever the default family says; an
    explicit family wins; the file is read once; a virtual net is drawn
    alike after a cache clear."""
    (_, jp), net = nets["live"][0]
    tckpt.write_safetensors(tckpt.export_controlnet(net, net.cfg),
                            str(tmp_path / CN_NAME))
    os.environ["DTPU_DEFAULT_FAMILY"] = "sd15"
    try:
        a = treg.load_controlnet(CN_NAME, models_dir=str(tmp_path),
                                 device=CPU)
        assert a.cfg.context_dim == 64 and a.cfg.model_channels == 32
        assert treg._cn_family_cache[str(tmp_path / CN_NAME)] == "tiny"
        b = treg.load_controlnet(CN_NAME, models_dir=str(tmp_path),
                                 family_name="tiny", device=CPU)
        assert b is a
    finally:
        os.environ["DTPU_DEFAULT_FAMILY"] = "tiny"
    want = controlnet_from_flax(a.cfg, _np_tree(jp))
    for k, v in a.state_dict().items():
        assert torch.equal(v, want[k]), k
    v1 = treg.load_controlnet("depth.safetensors", device=CPU)
    assert treg.load_controlnet("depth.safetensors", device=CPU) is v1
    treg._controlnet_cache.clear()
    v2 = treg.load_controlnet("depth.safetensors", device=CPU)
    assert v2 is not v1
    for (k, p), q in zip(v1.state_dict().items(), v2.state_dict().values()):
        assert torch.equal(p, q), k


def test_diff_loader_adds_the_base_models_leaves(nets, tmp_path):
    """DiffControlNetLoader: each leaf the model's UNet has at the same
    path and shape gains the UNet's value, as in the JAX package; the
    zero convs pass as they are; cached per model."""
    (jm, jp), net = nets["live"][0]
    tckpt.write_safetensors(tckpt.export_controlnet(net, net.cfg),
                            str(tmp_path / "diff_cn.safetensors"))
    jpipe = jreg.load_pipeline(CKPT)
    tpipe = treg.load_pipeline(CKPT, device=CPU)
    jctx, tctx = (JaxOpContext(models_dir=str(tmp_path)),
                  OpContext(device="cpu", models_dir=str(tmp_path)))
    (jdiff,) = jax_get_op("DiffControlNetLoader").execute(
        jctx, jpipe, "diff_cn.safetensors")
    (tdiff,) = get_op("DiffControlNetLoader").execute(
        tctx, tpipe, "diff_cn.safetensors")
    want = controlnet_from_flax(tdiff.cfg, _np_tree(jdiff[1]))
    changed = 0
    for k, v in tdiff.state_dict().items():
        np.testing.assert_allclose(_np(v), _np(want[k]), err_msg=k, **TOL)
        changed += not torch.equal(v, net.state_dict()[k])
    assert changed > 0
    assert torch.equal(tdiff.zero_conv_0.weight, net.zero_conv_0.weight)
    (again,) = get_op("DiffControlNetLoader").execute(
        tctx, tpipe, "diff_cn.safetensors")
    assert again is tdiff


# --- the denoiser's chain ------------------------------------------------------

def _sched_sigma(percent):
    return jreg.load_pipeline(CKPT).schedule.percent_to_sigma(percent)


# (links as (net index, strength, window)) over a [cond, uncond] stack at
# sigma 5.0; windows in sigma
DENOISER_CASES = {
    "per_block": [(0, (1.0, 0.0), None)],
    "window_closed": [(0, 0.8, (4.0, 1.0))],
    "per_block_windows": [(0, (1.0, 0.6), ((20.0, 1.0), (4.0, 1.0)))],
    "chain_two": [(0, 1.0, None), (1, (0.5, 0.7), None)],
    "same_net_twice": [(0, 0.5, None), (0, 0.5, (20.0, 1.0))],
}


@pytest.mark.parametrize("case", sorted(DENOISER_CASES))
def test_denoiser_chain_matches_jax(nets, case):
    """One CFG-stacked model call with a chain of links: each link's
    residuals times its block's strength and gate, summed, against the
    JAX package's ``make_denoiser(control=...)``; a closed window gives
    the plain call."""
    jpipe = jreg.load_pipeline(CKPT)
    tpipe = treg.load_pipeline(CKPT, device=CPU)
    x, _, c, hint = _inputs(B=1)
    x2, c2 = np.concatenate([x, x]), np.concatenate([c, c * 0.5])
    jspecs, tspecs = [], []
    for i, strength, window in DENOISER_CASES[case]:
        (jm, jp), net = nets["live"][i]

        def apply(p, xi, ts, ctx, h, y, _m=jm):
            return _m.apply({"params": p}, xi, ts, ctx, h, y)

        spec = (apply, jp, jnp.asarray(hint), strength)
        jspecs.append(spec if window is None else spec + (window,))
        tspecs.append(tden.ControlSpec(net, torch.from_numpy(hint),
                                       strength, window))
    jd = jden.make_denoiser(jpipe.raw_unet_apply, jpipe.unet_params,
                            jpipe.schedule, control=jspecs)
    td = tden.make_denoiser(tpipe.unet, tpipe.schedule, device=CPU,
                            control=tspecs)
    plain = tden.make_denoiser(tpipe.unet, tpipe.schedule, device=CPU)
    want = np.asarray(jd(jnp.asarray(x2), 5.0, context=jnp.asarray(c2)))
    with torch.no_grad():
        got = td(torch.from_numpy(x2), 5.0, context=torch.from_numpy(c2))
        base = plain(torch.from_numpy(x2), 5.0, context=torch.from_numpy(c2))
    np.testing.assert_allclose(_np(got), want, **TOL)
    if case == "window_closed":
        assert torch.equal(got, base)
    else:
        assert np.abs(_np(got) - _np(base)).max() > 1e-3
    if case == "per_block":
        assert torch.equal(got[1:], base[1:])


def test_a_windowed_link_takes_only_a_host_sigma(nets):
    """A link's window is read from the step's sigma as a host float (the
    serial samplers' convention); a tensor sigma raises rather than make
    the host wait for the card."""
    tpipe = treg.load_pipeline(CKPT, device=CPU)
    x, _, c, hint = _inputs(B=1)
    spec = tden.ControlSpec(nets["live"][0][1], torch.from_numpy(hint), 1.0,
                            (20.0, 1.0))
    td = tden.make_denoiser(tpipe.unet, tpipe.schedule, device=CPU,
                            control=[spec])
    with torch.no_grad():
        td(torch.from_numpy(x), 5.0, context=torch.from_numpy(c))
        with pytest.raises(TypeError, match="host float"):
            td(torch.from_numpy(x), torch.tensor(5.0),
               context=torch.from_numpy(c))


# --- the ops through KSampler --------------------------------------------------

def _conds(jpipe, tpipe, texts=("a house", "")):
    out = []
    for text in texts:
        ctx, _ = tpipe.encode_prompt([text])
        out.append((JaxCond(context=_np(ctx)), Conditioning(context=ctx)))
    return out


def _hint(seed=3, hw=(48, 40)):
    return np.random.default_rng(seed).uniform(
        size=(1, *hw, 3)).astype(np.float32)


LAT = {"samples": np.zeros((1, 8, 8, 4), np.float32)}


def _sample(pkg, pipe, pos, neg, steps=2, cfg=4.0):
    if pkg == "jax":
        (out,) = jax_get_op("KSampler").execute(
            JaxOpContext(), pipe, 9, steps, cfg, "euler", "normal", pos,
            neg, LAT, 1.0)
        return np.asarray(out["samples"])
    (out,) = get_op("KSampler").execute(
        OpContext(device="cpu"), pipe, 9, steps, cfg, "euler", "normal",
        pos, neg, LAT, 1.0)
    return _np(out["samples"])


def _apply(pkg, cond, cn, hint, strength=1.0):
    if pkg == "jax":
        return jax_get_op("ControlNetApply").execute(
            JaxOpContext(), cond, cn, hint, strength)[0]
    return get_op("ControlNetApply").execute(
        OpContext(device="cpu"), cond, cn, torch.from_numpy(hint),
        strength)[0]


def _advanced(pkg, pos, neg, cn, hint, strength, start, end):
    if pkg == "jax":
        return jax_get_op("ControlNetApplyAdvanced").execute(
            JaxOpContext(), pos, neg, cn, hint, strength, start, end)
    return get_op("ControlNetApplyAdvanced").execute(
        OpContext(device="cpu"), pos, neg, cn, torch.from_numpy(hint),
        strength, start, end)


def test_control_steers_only_its_own_rows(nets):
    """The virtual net and strength 0 give the plain sample to the bit;
    a control on the positive, on the negative and on both give three
    different samples, none the plain one (the per-block strengths of
    one model call are held against the JAX package's above)."""
    tpipe = treg.load_pipeline(CKPT, device=CPU)
    (_, tpos), (_, tneg) = _conds(None, tpipe)
    tnet, hint = nets["live"][0][1], _hint()
    only_pos = _sample("torch", tpipe, _apply("torch", tpos, tnet, hint),
                       tneg)
    plain = _sample("torch", tpipe, tpos, tneg)
    virtual = nets["virtual"][1]
    np.testing.assert_array_equal(_sample(
        "torch", tpipe, _apply("torch", tpos, virtual, hint), tneg), plain)
    zero = _apply("torch", tpos, tnet, hint, 0.0)
    assert zero is tpos
    only_neg = _sample("torch", tpipe, tpos,
                       _apply("torch", tneg, tnet, hint))
    both = _sample("torch", tpipe, _apply("torch", tpos, tnet, hint),
                   _apply("torch", tneg, tnet, hint))
    for a, b in ((only_pos, both), (only_neg, both), (only_pos, only_neg),
                 (only_pos, plain), (only_neg, plain)):
        assert np.abs(a - b).max() > 1e-3


def test_windows_full_empty_and_per_entry(nets):
    """ControlNetApplyAdvanced: the full window equals ControlNetApply on
    both sides, an empty one the plain sample (to the bit: the net is
    not run); two combined entries with their own windows (one shut, one
    open) equal the entry without control beside the open one, and
    match the JAX package."""
    jpipe, tpipe = jreg.load_pipeline(CKPT), treg.load_pipeline(CKPT,
                                                                device=CPU)
    (jpos, tpos), (jneg, tneg), (jb, tb) = _conds(
        jpipe, tpipe, ("a tower", "", "a river"))
    (jcnet, tnet), hint = nets["live"][0], _hint(7)
    full = _sample("torch", tpipe,
                   *_advanced("torch", tpos, tneg, tnet, hint, 1.0, 0.0, 1.0))
    both = _sample("torch", tpipe, _apply("torch", tpos, tnet, hint),
                   _apply("torch", tneg, tnet, hint))
    np.testing.assert_array_equal(full, both)
    plain = _sample("torch", tpipe, tpos, tneg)
    empty = _sample("torch", tpipe,
                    *_advanced("torch", tpos, tneg, tnet, hint, 1.0, 1.0,
                               1.0))
    np.testing.assert_array_equal(empty, plain)

    def mixed(pkg, a, b, neg, cn):
        op = jax_get_op if pkg == "jax" else get_op
        octx = JaxOpContext() if pkg == "jax" else OpContext(device="cpu")
        a_off, _ = _advanced(pkg, a, neg, cn, hint, 1.0, 1.0, 1.0)
        b_on, _ = _advanced(pkg, b, neg, cn, hint, 0.8, 0.0, 0.6)
        (m,) = op("ConditioningCombine").execute(octx, a_off, b_on)
        return m

    got = _sample("torch", tpipe, mixed("torch", tpos, tb, tneg, tnet), tneg)
    want = _sample("jax", jpipe, mixed("jax", jpos, jb, jneg, jcnet), jneg)
    np.testing.assert_allclose(got, want, **TOL)
    b_on, _ = _advanced("torch", tb, tneg, tnet, hint, 0.8, 0.0, 0.6)
    (oracle,) = get_op("ConditioningCombine").execute(
        OpContext(device="cpu"), tpos, b_on)
    np.testing.assert_array_equal(got, _sample("torch", tpipe, oracle, tneg))


def test_chains_zero_net_two_nets_and_one_net_twice(nets):
    """ComfyUI's previous_controlnet chain: a virtual net chained after
    a live one changes nothing (to the bit); two live nets match the
    JAX package; one net chained twice at 0.5 equals it once at 1.0."""
    jpipe, tpipe = jreg.load_pipeline(CKPT), treg.load_pipeline(CKPT,
                                                                device=CPU)
    (jpos, tpos), (jneg, tneg) = _conds(jpipe, tpipe, ("a castle", ""))
    (j1, t1), (j2, t2) = nets["live"]
    hint = _hint(11)
    single = _apply("torch", tpos, t1, hint)
    chained = _apply("torch", single, nets["virtual"][1], hint)
    assert len(chained.control) == 2
    one = _sample("torch", tpipe, single, tneg)
    np.testing.assert_array_equal(_sample("torch", tpipe, chained, tneg),
                                  one)
    two = _sample("torch", tpipe, _apply("torch", single, t2, hint, 0.6),
                  tneg)
    want = _sample("jax", jpipe, _apply(
        "jax", _apply("jax", jpos, j1, hint), j2, hint, 0.6), jneg)
    np.testing.assert_allclose(two, want, **TOL)
    assert np.abs(two - one).max() > 1e-3
    halves = _apply("torch", _apply("torch", tpos, t1, hint, 0.5), t1, hint,
                    0.5)
    assert len(halves.control) == 2
    np.testing.assert_allclose(_sample("torch", tpipe, halves, tneg), one,
                               rtol=1e-4, atol=1e-5)


def test_gathered_links_match_jax(nets):
    """``gather_control``: the nets in first-seen order, one slot a link
    of the same net on one entry, the per-entry strengths and sigma
    windows, the hint resized bilinearly to 8x the latent and cycled to
    the batch, as the JAX package's ``_prepare_sample_inputs`` builds
    them."""
    jpipe, tpipe = jreg.load_pipeline(CKPT), treg.load_pipeline(CKPT,
                                                                device=CPU)
    (jpos, tpos), (jneg, tneg), (jb, tb) = _conds(
        jpipe, tpipe, ("a", "", "b"))
    (j1, t1), (j2, t2) = nets["live"]
    hint = _hint(5, (40, 56))
    built = {}
    for pkg, pos, neg, b, n1, n2 in (("jax", jpos, jneg, jb, j1, j2),
                                     ("torch", tpos, tneg, tb, t1, t2)):
        op = jax_get_op if pkg == "jax" else get_op
        octx = JaxOpContext() if pkg == "jax" else OpContext(device="cpu")
        a = _apply(pkg, _apply(pkg, pos, n1, hint, 0.5), n1, hint, 0.25)
        b2, neg2 = _advanced(pkg, b, neg, n2, hint, 0.7, 0.1, 0.9)
        (both,) = op("ConditioningCombine").execute(octx, a, b2)
        lat = {"samples": np.zeros((3, 6, 5, 4), np.float32)}
        if pkg == "jax":
            built[pkg] = jbasic_prepare(octx, jpipe, lat, both, neg2)
        else:
            built[pkg] = tbasic._prepare_sample_inputs(tpipe, 5, lat, both,
                                                       neg2).control
    jw, tw = built["jax"], built["torch"]
    assert len(tw) == len(jw) == 3
    for (tnet, th, ts, twin), jspec in zip(tw, jw):
        assert ts == tuple(tuple(s) for s in jspec[3])
        jwin = jspec[4] if len(jspec) > 4 else None
        assert twin == jwin
        assert th.shape == (3, 48, 40, 3)
        np.testing.assert_allclose(_np(th), np.asarray(jspec[2]), rtol=0,
                                   atol=1e-5)
    assert tw[0][0] is tw[1][0] is t1 and tw[2][0] is t2


def jbasic_prepare(octx, jpipe, lat, pos, neg):
    from comfyui_distributed_tpu.ops import basic as jbasic
    return jbasic._prepare_sample_inputs(octx, jpipe, 5, lat, pos,
                                         neg).control


# --- routing -------------------------------------------------------------------

def _control_doc(seed=123456789, steps=3, size=16, cn=CN_NAME,
                 distributed=False, save=False):
    """A tiny ControlNet txt2img: the input image through Canny as the
    hint of a ControlNetApply on the positive."""
    doc = {
        "4": {"class_type": "CheckpointLoaderSimple",
              "inputs": {"ckpt_name": CKPT}},
        "5": {"class_type": "EmptyLatentImage",
              "inputs": {"width": size, "height": size, "batch_size": 1}},
        "6": {"class_type": "CLIPTextEncode",
              "inputs": {"text": "a lighthouse", "clip": ["4", 1]}},
        "7": {"class_type": "CLIPTextEncode",
              "inputs": {"text": "blurry", "clip": ["4", 1]}},
        "10": {"class_type": "LoadImage", "inputs": {"image": "input.png"}},
        "11": {"class_type": "Canny",
               "inputs": {"image": ["10", 0], "low_threshold": 0.1,
                          "high_threshold": 0.3}},
        "12": {"class_type": "ControlNetLoader",
               "inputs": {"control_net_name": cn}},
        "15": {"class_type": "ControlNetApply",
               "inputs": {"conditioning": ["6", 0], "control_net": ["12", 0],
                          "image": ["11", 0], "strength": 1.0}},
        "3": {"class_type": "KSampler",
              "inputs": {"seed": seed, "steps": steps, "cfg": 7.0,
                         "sampler_name": "euler", "scheduler": "karras",
                         "denoise": 1.0, "model": ["4", 0],
                         "positive": ["15", 0], "negative": ["7", 0],
                         "latent_image": ["5", 0]}},
        "8": {"class_type": "VAEDecode",
              "inputs": {"samples": ["3", 0], "vae": ["4", 2]}},
        "9": {"class_type": "SaveImage" if save else "PreviewImage",
              "inputs": {"images": ["8", 0]}},
    }
    if distributed:
        doc["13"] = {"class_type": "DistributedSeed",
                     "inputs": {"seed": seed}}
        doc["3"]["inputs"]["seed"] = ["13", 0]
        doc["14"] = {"class_type": "DistributedCollector",
                     "inputs": {"images": ["8", 0]}}
        doc["9"]["inputs"]["images"] = ["14", 0]
    return doc


def test_control_graphs_run_serially(env, tmp_path):
    """A control graph is not coalesced (its signature is None, as the
    JAX package's), passes the quick screen as there, and the
    continuous-batching bucket build refuses it (``CBIneligible``)."""
    doc = _control_doc()
    assert tsched.coalesce_signature(doc) is None
    assert jsched.coalesce_signature(doc) is None
    assert tcb.quick_eligible(doc) == jcb.quick_eligible(doc)
    with pytest.raises(tcb.CBIneligible, match="conditioning shape"):
        tcb._Bucket("sig", {"prompt": copy.deepcopy(doc)},
                    OpContext(device="cpu", input_dir=str(tmp_path)), 2)


def test_tile_tier_does_not_arm_under_a_control(nets):
    """The tiled upscaler's tile tier refuses a conditioning with a
    control (as the JAX package's) and a deep-shrink pipeline."""
    tpipe = treg.load_pipeline(CKPT, device=CPU)
    (_, tpos), (_, tneg) = _conds(None, tpipe)
    assert ttiled._tile_cache_eligible(tpos, tneg, tpipe)
    ctl = _apply("torch", tpos, nets["live"][0][1], _hint())
    assert not ttiled._tile_cache_eligible(ctl, tneg, tpipe)
    assert not ttiled._tile_cache_eligible(tpos, ctl, tpipe)
    (shrunk,) = get_op("PatchModelAddDownscale").execute(
        OpContext(device="cpu"), tpipe, 2, 2.0, 0.0, 0.35, True, "bicubic",
        "bicubic")
    assert not ttiled._tile_cache_eligible(tpos, tneg, shrunk)


# --- the HTTP fan-out ----------------------------------------------------------

TORCH_CLI = ("import sys\n"
             "from comfyui_distributed_tpu_torch import cli\n"
             "sys.exit(cli.main(sys.argv[1:]))\n")


def _input_png(path):
    img = np.zeros((40, 48, 3), np.float32)
    img[8:30, 10:36] = 0.8
    img += np.random.default_rng(8).uniform(0, 0.1, img.shape)
    save_png(str(path), img.astype(np.float32))


@pytest.fixture(scope="module")
def cluster(tmp_path_factory, nets):
    """A torch master and one torch worker on the CPU (the tiny family),
    the same ControlNet file in both models directories and the same
    input image in both input directories."""
    root = tmp_path_factory.mktemp("cn_fanout")
    net = nets["live"][0][1]
    env_ = {**os.environ, "DTPU_DEFAULT_FAMILY": "tiny",
            "PYTHONPATH": str(ROOT), "DTPU_CACHE": "0"}
    procs, ports = {}, {}
    for name, cmd in (("master", "serve"), ("w0", "worker")):
        d = root / name
        for sub in ("input", "models"):
            (d / sub).mkdir(parents=True)
        _input_png(d / "input" / "input.png")
        tckpt.write_safetensors(tckpt.export_controlnet(net, net.cfg),
                                str(d / "models" / CN_NAME))
        ports[name] = find_free_port()
        log = open(d / "log.txt", "w")
        procs[name] = (subprocess.Popen(
            [sys.executable, "-c", TORCH_CLI, cmd, "--host", "127.0.0.1",
             "--port", str(ports[name]), "--config", str(d / "cfg.json"),
             "--device", "cpu", "--input-dir", str(d / "input"),
             "--output-dir", str(d / "output"), "--models-dir",
             str(d / "models")], cwd=str(d), env=env_, stdout=log,
            stderr=subprocess.STDOUT), log)

    def logs():
        return "\n".join((root / n / "log.txt").read_text()[-3000:]
                         for n in procs)

    try:
        deadline = time.time() + 120
        for name, (proc, _) in procs.items():
            while True:
                assert proc.poll() is None, logs()
                try:
                    get_json(f"http://127.0.0.1:{ports[name]}/prompt",
                             timeout=2)
                    break
                except OSError:
                    assert time.time() < deadline, logs()
                    time.sleep(0.3)
        post_json(f"http://127.0.0.1:{ports['master']}"
                  "/distributed/config/update_worker",
                  {"id": "w0", "name": "w0", "host": "127.0.0.1",
                   "port": ports["w0"], "enabled": True})
        yield {"root": root, "url": f"http://127.0.0.1:{ports['master']}",
               "logs": logs}
    finally:
        for proc, log in procs.values():
            proc.terminate()
        for proc, log in procs.values():
            try:
                proc.wait(timeout=10)
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait()
            log.close()


def test_controlnet_txt2img_through_master_and_worker(cluster):
    """The ControlNet graph fanned out: the master's image at seed s and
    the worker's at s + 1 (over /distributed/job_complete) each equal
    the in-process run of the same graph at that seed."""
    seed = 123456789
    url, root = cluster["url"], cluster["root"]
    resp = post_json(url + "/prompt", {"prompt": _control_doc(
        seed, distributed=True, save=True), "client_id": "t"})
    deadline = time.time() + 180
    while resp["prompt_id"] not in get_json(url + "/history"):
        assert time.time() < deadline, cluster["logs"]()
        time.sleep(0.2)
    entry = get_json(url + "/history")[resp["prompt_id"]]
    assert resp["workers"] == ["w0"] and resp["failed_workers"] == [], \
        (resp, cluster["logs"]())
    assert entry["status"] == "success" and entry["images"] == 2, entry
    files = sorted((root / "master" / "output").glob("*.png"))
    assert len(files) == 2
    ctx = dict(device="cpu", input_dir=str(root / "master" / "input"),
               models_dir=str(root / "master" / "models"))
    treg.clear_pipeline_cache()
    refs = [WorkflowExecutor(OpContext(**ctx)).execute(
        _control_doc(s)).image_batch[0] for s in (seed, seed + 1)]
    plain = _control_doc(seed)
    plain["3"]["inputs"]["positive"] = ["6", 0]
    unsteered = WorkflowExecutor(OpContext(**ctx)).execute(
        plain).image_batch[0]
    treg.clear_pipeline_cache()
    for f, ref in zip(files, refs):
        got = decode_png(f.read_bytes())[0]
        want = to_uint8(ref).astype(np.float32) / 255.0
        assert np.abs(got - want).max() <= 1e-6, f
    assert np.abs(refs[0] - unsteered).max() > 2 / 255
