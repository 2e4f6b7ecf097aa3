"""Regional prompting in the port against the JAX package:
``workflows/distributed-regional.json`` (two prompts on canvas halves by
ConditioningSetAreaPercentage, bundled by ConditioningCombine, one
stacked model call with mask-blended CFG), the area ops, the sampler's
entry build, the multi-entry ``cfg_denoiser_multi`` and its
``_mask_blend``, ``percent_to_sigma``, and the tiled upscaler's regional
refine.

Both packages get the same numpy inputs and the same virtual weights.
Modules at fp32 agree within 2e-4 (rectangles and masks to the bit);
whole workflows on the tiny family within 2e-3."""

import copy
import json
import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from comfyui_distributed_tpu.models import registry as jreg
from comfyui_distributed_tpu.models import samplers as jsmp
from comfyui_distributed_tpu.models import schedules as jsch
from comfyui_distributed_tpu.ops import basic as jbasic
from comfyui_distributed_tpu.ops.base import Conditioning as JaxCond
from comfyui_distributed_tpu.ops.base import OpContext as JaxOpContext
from comfyui_distributed_tpu.ops.base import get_op as jax_get_op
from comfyui_distributed_tpu.runtime import reuse as jreuse
from comfyui_distributed_tpu.workflow import WorkflowExecutor as JaxExecutor
from comfyui_distributed_tpu_torch.models import registry as treg
from comfyui_distributed_tpu_torch.models import samplers as tsmp
from comfyui_distributed_tpu_torch.models import schedules as tsch
from comfyui_distributed_tpu_torch.ops import basic as tbasic
from comfyui_distributed_tpu_torch.ops.base import Conditioning, OpContext
from comfyui_distributed_tpu_torch.ops.base import get_op
from comfyui_distributed_tpu_torch.utils.image import save_png
from comfyui_distributed_tpu_torch.workflow import WorkflowExecutor

ROOT = pathlib.Path(__file__).resolve().parents[1]
REGIONAL = ROOT / "workflows" / "distributed-regional.json"
UPSCALE = ROOT / "workflows" / "distributed-upscale.json"
TOL = dict(rtol=2e-4, atol=2e-4)
IMAGE_ATOL = 2e-3


def _np(x):
    if hasattr(x, "to_host"):
        return x.to_host()
    if isinstance(x, torch.Tensor):
        return x.detach().float().cpu().numpy()
    return np.asarray(x, np.float32)


@pytest.fixture
def fresh(monkeypatch):
    """The tiny family in both packages, every pipeline cache and the
    JAX reuse plane empty (its encode memo is keyed by the graph, not
    by the family a name resolves to)."""
    monkeypatch.setenv("DTPU_DEFAULT_FAMILY", "tiny")
    for clear in (jreg.clear_pipeline_cache, treg.clear_pipeline_cache,
                  jreuse.get_reuse().clear):
        clear()
    yield
    for clear in (jreg.clear_pipeline_cache, treg.clear_pipeline_cache,
                  jreuse.get_reuse().clear):
        clear()


# --- schedule and area masks ---------------------------------------------------

@pytest.mark.parametrize("percent", [0.0, 0.1, 0.35, 0.5, 0.99, 1.0])
def test_percent_to_sigma_matches_jax(percent):
    j = jsch.make_discrete_schedule().percent_to_sigma(percent)
    t = tsch.make_discrete_schedule().percent_to_sigma(percent)
    assert t == j


@pytest.mark.parametrize("area", [
    ("pct", 0.5, 0.0, 0.5, 1.0),
    ("pct", 0.0, 0.0, 0.5, 1.0),
    ("pct", 0.13, 0.27, 0.4, 0.333),
    ("px", 64, 24, 200, 100),
    ("px", 0, 0, 4, 4),
    "mask1", "mask2"])
def test_area_mask_matches_jax(area):
    """Rectangles round against the latent's own size (0.5 of 12 is 6
    columns); masks area-downsample and cycle as noise masks do."""
    h, w, total = 10, 12, 3
    if isinstance(area, str):
        n = int(area[-1])
        area = np.random.default_rng(n).uniform(
            size=(n, 40, 48)).astype(np.float32)
        t_area = torch.from_numpy(area)
    else:
        t_area = area
    j = jbasic._materialize_area_mask(JaxCond(context=None, area_mask=area),
                                      h, w, total)
    t = tbasic.materialize_area_mask(Conditioning(context=None,
                                                  area_mask=t_area),
                                     h, w, total, "cpu")
    np.testing.assert_allclose(_np(t), np.asarray(j), rtol=0, atol=1e-6)
    if isinstance(t_area, tuple) and t_area[:2] == ("pct", 0.5):
        assert _np(t)[0, :, :, 0].sum(axis=1).tolist() == [6.0] * h


# --- the blend and the stacked CFG call ----------------------------------------

def _entries(rng, n, with_masks, strengths, ranges, b=2, h=4, w=5):
    out = []
    for i in range(n):
        m = rng.uniform(size=(1, h, w, 1)).astype(np.float32) \
            if with_masks[i] else None
        out.append((rng.standard_normal((b, 6, 8)).astype(np.float32), m,
                    strengths[i], ranges[i]))
    return out


def _to(pkg, entries):
    conv = (lambda a: jnp.asarray(a)) if pkg == "jax" \
        else (lambda a: torch.from_numpy(a))
    return [(conv(c), None if m is None else conv(m), s, r)
            for c, m, s, r in entries]


CASES = {
    # (masks, strengths, sigma ranges) of each entry
    "two_masked": ([True, True], [1.0, 0.7], [None, None]),
    "strength_zero": ([True, False], [0.0, 1.0], [None, None]),
    "uncovered": ([True, True], [1.0, 1.0], [None, None]),
    "range_in": ([True, False], [1.0, 0.5], [(20.0, 1.0), None]),
    "range_out": ([False, True], [1.0, 1.0], [(0.5, 0.1), None]),
    "three": ([True, False, True], [0.3, 1.0, 2.0],
              [None, (1e3, 0.0), (2.0, 0.0)]),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_mask_blend_matches_jax(case):
    masks, strengths, ranges = CASES[case]
    rng = np.random.default_rng(len(case))
    ent = _entries(rng, len(masks), masks, strengths, ranges)
    if case == "uncovered":
        # no weight anywhere on the first two columns: ~zero there
        for _, m, _, _ in ent:
            m[..., :2, :] = 0.0
    parts = [rng.standard_normal((2, 4, 5, 3)).astype(np.float32)
             for _ in ent]
    sigma = 1.5
    j = jsmp._mask_blend(_to("jax", ent), [jnp.asarray(p) for p in parts],
                         jnp.float32(sigma))
    t = tsmp._mask_blend(_to("torch", ent),
                         [torch.from_numpy(p) for p in parts], sigma)
    np.testing.assert_allclose(_np(t), np.asarray(j), **TOL)
    # a tensor sigma on the device gives the same gate as a host one
    t2 = tsmp._mask_blend(_to("torch", ent),
                          [torch.from_numpy(p) for p in parts],
                          torch.tensor(sigma))
    assert torch.equal(t, t2)
    if case == "uncovered":
        assert np.abs(_np(t)[..., :2, :]).max() < 1e-6


def _toy_model(pkg, calls):
    """The same deterministic stand-in for a denoiser in both packages:
    out = x * tanh(mean of the row's context) + sigma, per row; records
    the rows of each call."""
    if pkg == "jax":
        def model(x, sigma, context=None, **kw):
            calls.append(x.shape[0])
            g = jnp.tanh(context.mean(axis=(1, 2)))[:, None, None, None]
            return x * g + sigma
    else:
        def model(x, sigma, context=None, y=None):
            calls.append(x.shape[0])
            g = torch.tanh(context.mean(dim=(1, 2)))[:, None, None, None]
            return x * g + sigma
    return model


@pytest.mark.parametrize("cfg", [6.0, 1.0])
@pytest.mark.parametrize("layout", ["regional", "multi_uncond", "plain"])
def test_cfg_denoiser_multi_matches_jax(cfg, layout):
    """Every entry of both sides in one model call of n + nu row blocks
    (n at cfg 1), the blend, the CFG combine and ``last_uncond``."""
    rng = np.random.default_rng(7)
    if layout == "plain":
        conds = _entries(rng, 1, [False], [1.0], [None])
        unconds = _entries(rng, 1, [False], [1.0], [None])
    elif layout == "regional":
        conds = _entries(rng, 2, [True, True], [1.0, 0.8],
                         [None, (30.0, 2.0)])
        unconds = _entries(rng, 1, [False], [1.0], [None])
    else:
        conds = _entries(rng, 2, [True, False], [1.0, 1.0], [None, None])
        unconds = _entries(rng, 2, [False, True], [0.5, 1.0],
                           [(1e3, 0.0), None])
    x = rng.standard_normal((2, 4, 5, 3)).astype(np.float32)
    jcalls, tcalls = [], []
    jm = jsmp.cfg_denoiser_multi(_toy_model("jax", jcalls),
                                 _to("jax", conds), _to("jax", unconds), cfg)
    tm = tsmp.cfg_denoiser_multi(_toy_model("torch", tcalls),
                                 _to("torch", conds), _to("torch", unconds),
                                 cfg)
    for sigma in (14.0, 3.0, 0.5):
        j = jm(jnp.asarray(x), jnp.float32(sigma))
        t = tm(torch.from_numpy(x), sigma)
        np.testing.assert_allclose(_np(t), np.asarray(j), **TOL)
        np.testing.assert_allclose(_np(tm.last_uncond),
                                   np.asarray(jm.last_uncond), **TOL)
    rows = 2 * (len(conds) + (len(unconds) if cfg != 1.0 else 0))
    assert tcalls == jcalls == [rows] * 3


@pytest.mark.parametrize("form", ["entries", "bare"])
def test_plain_entries_blend_to_the_two_row_cfg_to_the_bit(form):
    """One plain entry a side goes through ``_mask_blend`` (weight 1,
    sum 1) and gives exactly the single-entry CFG: one model call on
    [x; x] with [cond; uncond], ``uncond + (cond - uncond) * cfg``."""
    rng = np.random.default_rng(11)
    cond, uncond = (torch.from_numpy(rng.standard_normal((2, 6, 8))
                                     .astype(np.float32)) for _ in range(2))
    x = torch.from_numpy(rng.standard_normal((2, 4, 5, 3))
                         .astype(np.float32))
    model = _toy_model("torch", [])
    wrapped = tsmp.cfg_denoiser_multi(
        model, [(cond, None, 1.0)] if form == "entries" else cond,
        [(uncond, None, 1.0)] if form == "entries" else uncond, 7.5)
    for sigma in (14.0, 0.5):
        den_cond, den_uncond = model(torch.cat([x, x]), sigma,
                                     context=torch.cat([cond, uncond])
                                     ).chunk(2)
        assert torch.equal(wrapped(x, sigma),
                           den_uncond + (den_cond - den_uncond) * 7.5)
        assert torch.equal(wrapped.last_uncond, den_uncond)


# --- the area ops --------------------------------------------------------------

def _cond_summary(c):
    """What the area ops set, comparable across the packages."""
    def area(a):
        if a is None or isinstance(a, tuple):
            return a
        return _np(a).tolist()
    return [(area(e.area_mask), e.area_strength, e.timestep_range,
             float(_np(e.context).sum()))
            for e in (c, *c.siblings)]


def test_area_ops_match_jax():
    """Combine flattens siblings; every setter applies to every entry
    bundled so far, as ComfyUI's Set nodes loop over a list."""
    rng = np.random.default_rng(3)
    ctxs = [rng.standard_normal((1, 4, 8)).astype(np.float32)
            for _ in range(3)]
    mask = rng.uniform(size=(16, 16)).astype(np.float32)
    out = {}
    for pkg, get, cond_cls, conv in (
            ("jax", jax_get_op, JaxCond, jnp.asarray),
            ("torch", get_op, Conditioning, torch.from_numpy)):
        ctx = JaxOpContext() if pkg == "jax" else OpContext(device="cpu")
        a, b, c = (cond_cls(context=conv(x)) for x in ctxs)

        def op(name, **kw):
            return get(name).execute(ctx, **kw)[0]

        a = op("ConditioningSetAreaPercentage", conditioning=a, width=0.5,
               height=1.0, x=0.0, y=0.0, strength=1.0)
        b = op("ConditioningSetArea", conditioning=b, width=256, height=128,
               x=64, y=32, strength=0.6)
        ab = op("ConditioningCombine", conditioning_1=a, conditioning_2=b)
        abc = op("ConditioningCombine", conditioning_1=ab, conditioning_2=c)
        ranged = op("ConditioningSetTimestepRange", conditioning=abc,
                    start=0.2, end=0.8)
        strong = op("ConditioningSetAreaStrength", conditioning=ranged,
                    strength=0.4)
        masked = op("ConditioningSetMask", conditioning=abc,
                    mask=conv(mask) if pkg == "torch" else mask,
                    strength=0.9)
        out[pkg] = [_cond_summary(x) for x in (abc, ranged, strong, masked)]
    for got, want in zip(out["torch"], out["jax"]):
        assert len(got) == len(want) == 3
        for g, w in zip(got, want):
            assert g[1:3] == w[1:3]
            assert g[3] == pytest.approx(w[3], rel=1e-6)
            if isinstance(w[0], np.ndarray) or isinstance(g[0], list):
                np.testing.assert_array_equal(np.asarray(g[0]).reshape(
                    np.shape(w[0])), np.asarray(w[0]))
            else:
                assert g[0] == w[0]


# --- the sampler's entry build -------------------------------------------------

@pytest.mark.parametrize("family", ["tiny", "tiny_sdxl"])
def test_sample_inputs_match_jax(fresh, family):
    """Each entry's aligned context, area mask, strength and sigma range,
    and on an ADM family one vector an entry: regional SDXL gives each
    region its own pooled embedding."""
    jp = jreg.load_pipeline("regional.safetensors", family_name=family)
    tp = treg.load_pipeline("regional.safetensors", family_name=family,
                            device="cpu")
    texts = ["red crystals", "blue ocean", ""]
    tconds = [Conditioning(*tp.encode_prompt([s])) for s in texts]
    # one entry 154 tokens long: every entry aligns to it by repeating
    long_ctx = torch.cat([tconds[1].context] * 2, dim=1)
    tconds[1] = Conditioning(long_ctx, tconds[1].pooled)
    jconds = [JaxCond(context=c.context.numpy(), pooled=c.pooled.numpy())
              for c in tconds]
    built = {}
    for pkg, conds, get, ctx in (
            ("jax", jconds, jax_get_op, JaxOpContext()),
            ("torch", tconds, get_op, OpContext(device="cpu"))):
        def op(name, **kw):
            return get(name).execute(ctx, **kw)[0]
        a = op("ConditioningSetAreaPercentage", conditioning=conds[0],
               width=0.5, height=1.0, x=0.0, y=0.0, strength=1.0)
        b = op("ConditioningSetAreaPercentage", conditioning=conds[1],
               width=0.5, height=1.0, x=0.5, y=0.0, strength=0.8)
        b = op("ConditioningSetTimestepRange", conditioning=b, start=0.0,
               end=0.6)
        pos = op("ConditioningCombine", conditioning_1=a, conditioning_2=b)
        lat = {"samples": np.zeros((2, 8, 12, 4), np.float32)}
        if pkg == "jax":
            built[pkg] = jbasic._prepare_sample_inputs(ctx, jp, 5, lat, pos,
                                                       conds[2])
        else:
            built[pkg] = tbasic._prepare_sample_inputs(tp, 5, lat, pos,
                                                       conds[2])
    j, t = built["jax"], built["torch"]
    for side in ("context", "uncond"):
        assert len(getattr(t, side)) == len(getattr(j, side))
        for (tc, tm, ts, tr), (jc, jm, js, jr) in zip(getattr(t, side),
                                                      getattr(j, side)):
            assert tc.shape == (2, 154, tc.shape[-1])
            np.testing.assert_allclose(_np(tc), np.asarray(jc), **TOL)
            assert (tm is None) == (jm is None)
            if tm is not None:
                np.testing.assert_array_equal(_np(tm), np.asarray(jm))
            assert ts == js and tr == jr
    if family == "tiny":
        assert t.y is None and j.y is None
    else:
        assert len(t.y) == len(j.y) == 3
        for ty, jy in zip(t.y, j.y):
            np.testing.assert_allclose(_np(ty), np.asarray(jy), **TOL)
        assert not np.allclose(_np(t.y[0]), _np(t.y[1]))


# --- whole workflows -----------------------------------------------------------

def regional_doc(variant="as_shipped"):
    """The regional workflow at the tiny family's size: 64^2, 3 steps;
    ``timestep_range`` limits the right prompt to the first 60% of
    sampling; ``cfg1`` samples at cfg 1 with the blue prompt's area at
    strength 0.5; ``advanced`` samples through KSamplerAdvanced's window
    (steps 1-3 of 4, the leftover noise kept)."""
    doc = json.loads(REGIONAL.read_text())
    doc["2"]["inputs"].update(width=64, height=64)
    doc["3"]["inputs"]["steps"] = 3
    if variant == "timestep_range":
        doc["20"] = {"class_type": "ConditioningSetTimestepRange",
                     "inputs": {"conditioning": ["18", 0], "start": 0.0,
                                "end": 0.6}}
        doc["19"]["inputs"]["conditioning_2"] = ["20", 0]
    elif variant == "cfg1":
        doc["3"]["inputs"]["cfg"] = 1.0
        doc["18"]["inputs"]["strength"] = 0.5
    elif variant == "advanced":
        inputs = doc["3"]["inputs"]
        inputs["noise_seed"] = inputs.pop("seed")
        del inputs["denoise"]
        inputs.update(steps=4, start_at_step=1, end_at_step=3,
                      add_noise="enable",
                      return_with_leftover_noise="enable")
        doc["3"]["class_type"] = "KSamplerAdvanced"
    return doc


@pytest.mark.parametrize("variant", ["as_shipped", "timestep_range", "cfg1",
                                     "advanced"])
def test_regional_workflow_matches_the_jax_executor(fresh, variant):
    doc = regional_doc(variant)
    ours = WorkflowExecutor(OpContext(device="cpu")).execute(
        copy.deepcopy(doc))
    ref = JaxExecutor(JaxOpContext()).execute(copy.deepcopy(doc))
    ref.wait_host()
    a, b = ours.image_batch, ref.image_batch
    assert a.shape == b.shape == (1, 16, 16, 3)
    assert np.isfinite(a).all() and a.std() > 0
    np.testing.assert_allclose(a, b, rtol=0, atol=IMAGE_ATOL)
    pos = ours.outputs["19"][0]
    assert len(pos.siblings) == 1
    assert pos.area_mask == ("pct", 0.0, 0.0, 0.5, 1.0)


def test_regional_halves_follow_their_prompts(fresh):
    """The left half of the regional latent differs from a run with the
    blue prompt alone, the right half from one with the red prompt
    alone."""
    def latent(positive):
        doc = regional_doc()
        doc["3"]["inputs"]["positive"] = positive
        res = WorkflowExecutor(OpContext(device="cpu")).execute(doc)
        return _np(res.outputs["3"][0]["samples"])

    both, blue, red = (latent(p) for p in (["19", 0], ["16", 0], ["6", 0]))
    w = both.shape[2] // 2
    assert np.abs(both[:, :, :w] - blue[:, :, :w]).max() > 1e-2
    assert np.abs(both[:, :, w:] - red[:, :, w:]).max() > 1e-2


def test_regional_sampling_with_noise_mask_and_cfgpp(fresh):
    """The stacked call's ``last_uncond`` passes through the area blend
    and the noise-mask blend: a masked, regional euler_cfg_pp run against
    the JAX pipeline."""
    jp = jreg.load_pipeline("regional.safetensors")
    tp = treg.load_pipeline("regional.safetensors", device="cpu")
    rng = np.random.default_rng(11)
    src = rng.standard_normal((1, 8, 8, 4)).astype(np.float32)
    ctx = [rng.standard_normal((1, 77, 64)).astype(np.float32)
           for _ in range(3)]
    masks = [np.zeros((1, 8, 8, 1), np.float32) for _ in range(2)]
    masks[0][:, :, :4] = 1.0
    masks[1][:, :, 4:] = 1.0
    noise_mask = np.zeros((1, 8, 8, 1), np.float32)
    noise_mask[:, 2:6, 1:7] = 1.0
    entries = [(ctx[0], masks[0], 1.0, None), (ctx[1], masks[1], 0.7, None)]
    kw = dict(steps=3, cfg=4.0, sampler_name="euler_cfg_pp",
              scheduler="karras", denoise=0.8)
    seeds = np.asarray([9], np.uint64)
    j = jp.sample(jnp.asarray(src),
                  [(jnp.asarray(c), jnp.asarray(m), s, r)
                   for c, m, s, r in entries],
                  [(jnp.asarray(ctx[2]), None, 1.0, None)], seeds,
                  noise_mask=jnp.asarray(noise_mask), **kw)
    t = tp.sample(torch.from_numpy(src),
                  [(torch.from_numpy(c), torch.from_numpy(m), s, r)
                   for c, m, s, r in entries],
                  [(torch.from_numpy(ctx[2]), None, 1.0, None)], seeds,
                  noise_mask=torch.from_numpy(noise_mask), **kw)
    np.testing.assert_allclose(_np(t), np.asarray(j), **TOL)
    keep = noise_mask[..., 0] == 0
    np.testing.assert_array_equal(_np(t)[0][keep[0]], src[0][keep[0]])


def regional_upscale_doc(tmp_path):
    """The tiled upscaler on the regional prompts: a 40 x 48 input
    scaled to 64^2, four 32^2 tiles + 8 px, 2 steps; the left prompt on
    the left 40% for the first 70% of sampling, the right on the right
    half at strength 0.8."""
    rng = np.random.default_rng(8)
    save_png(str(tmp_path / "input.png"),
             rng.uniform(size=(40, 48, 3)).astype(np.float32))
    up = json.loads(UPSCALE.read_text())
    reg = json.loads(REGIONAL.read_text())
    doc = {k: up[k] for k in ("1", "4", "7", "2", "9")}
    doc.update({k: reg[k] for k in ("6", "16", "17", "18", "19")})
    doc["7"]["inputs"]["clip"] = ["4", 1]
    doc["17"]["inputs"]["width"] = 0.4
    doc["18"]["inputs"]["strength"] = 0.8
    doc["20"] = {"class_type": "ConditioningSetTimestepRange",
                 "inputs": {"conditioning": ["17", 0], "start": 0.0,
                            "end": 0.7}}
    doc["19"]["inputs"]["conditioning_1"] = ["20", 0]
    doc["16s"] = {"class_type": "ImageScale",
                  "inputs": {"image": ["1", 0], "upscale_method": "lanczos",
                             "width": 64, "height": 64, "crop": "disabled"}}
    doc["2"]["inputs"].update(upscaled_image=["16s", 0], positive=["19", 0],
                              steps=2, tile_width=32, tile_height=32,
                              padding=8, mask_blur=2)
    return doc


def test_regional_tiled_upscale_matches_the_jax_executor(fresh, tmp_path):
    """Each entry's canvas mask is cut through the same padded windows
    as the tiles' pixels; the image matches the JAX executor's and
    differs from the upscale with the first prompt alone."""
    doc = regional_upscale_doc(tmp_path)
    ours = WorkflowExecutor(OpContext(device="cpu",
                                      input_dir=str(tmp_path))).execute(
        copy.deepcopy(doc))
    ref = JaxExecutor(JaxOpContext(input_dir=str(tmp_path))).execute(
        copy.deepcopy(doc))
    ref.wait_host()
    a, b = ours.image_batch, ref.image_batch
    assert a.shape == b.shape == (1, 64, 64, 3)
    assert np.isfinite(a).all() and a.std() > 0
    np.testing.assert_allclose(a, b, rtol=0, atol=IMAGE_ATOL)
    plain = copy.deepcopy(doc)
    plain["2"]["inputs"]["positive"] = ["6", 0]
    c = WorkflowExecutor(OpContext(device="cpu",
                                   input_dir=str(tmp_path))).execute(
        plain).image_batch
    assert np.abs(a - c).max() > 1e-3
