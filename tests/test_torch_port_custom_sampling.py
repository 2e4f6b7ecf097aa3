"""The custom-sampling graph in the port against the JAX package: the
schedule functions (Karras between explicit bounds, polyexponential,
VP, Laplace, Align-Your-Steps, SD-Turbo, the zero-terminal-SNR rescale),
the 25 ops of the slice (KSamplerSelect, the ten schedulers, the three
sigma ops, SamplerCustom, the noises, the four guiders,
SamplerCustomAdvanced and the RescaleCFG, ModelSamplingDiscrete,
SelfAttentionGuidance and PerpNeg patches) with their schemas,
SamplerCustom against KSampler, two-stage SplitSigmas chains, FlipSigmas,
a pass-through below two sigmas, whole graphs through both executors and
one graph POSTed to a ``cli serve`` master.

Both packages get the same numpy inputs and the same virtual weights;
the tiny family in fp32.  Sigma tables agree within 1e-6, samples within
rtol = atol = 2e-4, decoded images within 2e-3 (the VAE widens the
latents' differences); schemas and derived attributes exactly."""

import copy
import os
import pathlib
import subprocess
import sys
import time
import types

import numpy as np
import pytest
import torch

import comfyui_distributed_tpu.ops.basic  # noqa: F401  (registers the ops)
import comfyui_distributed_tpu_torch.ops.basic  # noqa: F401
from comfyui_distributed_tpu.models import registry as jreg
from comfyui_distributed_tpu.models import schedules as jsch
from comfyui_distributed_tpu.ops import base as jbase
from comfyui_distributed_tpu.ops.base import Conditioning as JaxCond
from comfyui_distributed_tpu.ops.base import OpContext as JaxOpContext
from comfyui_distributed_tpu.ops.base import SeedValue as JaxSeed
from comfyui_distributed_tpu.ops.base import get_op as jax_get_op
from comfyui_distributed_tpu.runtime import reuse as jreuse
from comfyui_distributed_tpu.workflow import WorkflowExecutor as JaxExecutor
from comfyui_distributed_tpu_torch.models import registry as treg
from comfyui_distributed_tpu_torch.models import schedules as tsch
from comfyui_distributed_tpu_torch.ops import base as tbase
from comfyui_distributed_tpu_torch.ops.base import (Conditioning, OpContext,
                                                    SeedValue, get_op)
from comfyui_distributed_tpu_torch.runtime import reuse as treuse
from comfyui_distributed_tpu_torch.utils.image import decode_png, to_uint8
from comfyui_distributed_tpu_torch.utils.net import (find_free_port,
                                                     get_json, post_json)
from comfyui_distributed_tpu_torch.workflow import WorkflowExecutor

ROOT = pathlib.Path(__file__).resolve().parents[1]
TOL = dict(rtol=2e-4, atol=2e-4)
SIGMA_TOL = dict(rtol=0, atol=1e-6)
IMAGE_ATOL = 2e-3
CPU = torch.device("cpu")
SLICE_OPS = (
    "KSamplerSelect", "BasicScheduler", "KarrasScheduler",
    "ExponentialScheduler", "PolyexponentialScheduler", "VPScheduler",
    "LaplaceScheduler", "BetaSamplingScheduler", "AlignYourStepsScheduler",
    "SDTurboScheduler", "SplitSigmasDenoise", "SplitSigmas", "FlipSigmas",
    "SamplerCustom", "RandomNoise", "DisableNoise", "BasicGuider",
    "CFGGuider", "DualCFGGuider", "PerpNegGuider", "SamplerCustomAdvanced",
    "RescaleCFG", "ModelSamplingDiscrete", "SelfAttentionGuidance",
    "PerpNeg")


def _np(x):
    if hasattr(x, "to_host"):
        return x.to_host()
    if isinstance(x, torch.Tensor):
        return x.detach().float().cpu().numpy()
    return np.asarray(x, np.float32)


def _clear():
    for clear in (jreg.clear_pipeline_cache, treg.clear_pipeline_cache,
                  jreuse.get_reuse().clear, treuse.get_reuse().clear):
        clear()


@pytest.fixture
def env():
    """The tiny family in both packages; both pipeline caches and both
    reuse planes empty before and after each test."""
    saved = os.environ.get("DTPU_DEFAULT_FAMILY")
    os.environ["DTPU_DEFAULT_FAMILY"] = "tiny"
    _clear()
    yield
    _clear()
    if saved is None:
        os.environ.pop("DTPU_DEFAULT_FAMILY", None)
    else:
        os.environ["DTPU_DEFAULT_FAMILY"] = saved


class Side:
    """One package's op runner, pipeline and conditionings."""

    def __init__(self, pkg, name, texts=("a fox", "")):
        self.pkg = pkg
        if pkg == "jax":
            self.pipe = jreg.load_pipeline(name)
            self.ctx = JaxOpContext()
            self.get = jax_get_op
            self.cond = lambda t: JaxCond(
                context=np.asarray(self.pipe.encode_prompt([t])[0]))
        else:
            self.pipe = treg.load_pipeline(name, device=CPU)
            self.ctx = OpContext(device="cpu")
            self.get = get_op
            self.cond = lambda t: Conditioning(
                context=self.pipe.encode_prompt([t])[0])
        self.pos, self.neg = (self.cond(t) for t in texts)

    def op(self, name, *args, **kw):
        return self.get(name).execute(self.ctx, *args, **kw)


def _sides(name, texts=("a fox", "")):
    return Side("jax", name, texts), Side("torch", name, texts)


def _lat(h=8, w=8, fill=0.0, b=1):
    return {"samples": np.full((b, h, w, 4), fill, np.float32)}


# --- the schedule functions ---------------------------------------------------

DS_J = jsch.make_discrete_schedule()
DS_T = tsch.make_discrete_schedule()

SCHEDULE_CASES = {
    "karras_bounds": lambda m, ds: m.karras_scheduler(
        None, 7, 5.0, sigma_min=0.05, sigma_max=9.0),
    "karras_table": lambda m, ds: m.karras_scheduler(ds, 6),
    "poly_rho1": lambda m, ds: m.polyexponential_sigmas(8, 14.6, 0.03),
    "poly_rho2": lambda m, ds: m.polyexponential_sigmas(5, 10.0, 0.1, 2.0),
    "vp": lambda m, ds: m.vp_sigmas(9),
    "vp_custom": lambda m, ds: m.vp_sigmas(4, 15.0, 0.2, 1e-2),
    "laplace": lambda m, ds: m.laplace_sigmas(10, 14.6, 0.03),
    "laplace_mu": lambda m, ds: m.laplace_sigmas(7, 14.6, 0.03, 0.5, 0.8),
    "ays_sd1_10": lambda m, ds: m.ays_sigmas("SD1", 10),
    "ays_sd15_25": lambda m, ds: m.ays_sigmas("sd1.5", 25),
    "ays_sdxl_4": lambda m, ds: m.ays_sigmas("SDXL", 4),
    "ays_svd_13": lambda m, ds: m.ays_sigmas("SVD", 13),
    "turbo_1": lambda m, ds: m.sd_turbo_sigmas(ds, 1),
    "turbo_4": lambda m, ds: m.sd_turbo_sigmas(ds, 4),
    "turbo_quarter": lambda m, ds: m.sd_turbo_sigmas(ds, 2, 0.25),
    "turbo_half": lambda m, ds: m.sd_turbo_sigmas(ds, 3, 0.5),
    "zsnr_sigmas": lambda m, ds: m.rescale_zero_terminal_snr(ds).sigmas,
    "zsnr_abar": lambda m, ds: m.rescale_zero_terminal_snr(
        ds).alphas_cumprod,
}


@pytest.mark.parametrize("case", sorted(SCHEDULE_CASES))
def test_schedule_function_matches_jax(case):
    want = np.asarray(SCHEDULE_CASES[case](jsch, DS_J))
    got = np.asarray(SCHEDULE_CASES[case](tsch, DS_T))
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_allclose(got, want, **SIGMA_TOL)


def test_ays_tables_equal_and_unknown_type_raises():
    assert tsch.AYS_TABLES == jsch.AYS_TABLES
    with pytest.raises(ValueError, match="unknown AYS"):
        tsch.ays_sigmas("SD3", 10)


# --- the schemas and the sigma ops --------------------------------------------

@pytest.mark.parametrize("name", SLICE_OPS)
def test_op_schema_equals_the_jax_packages(name):
    """Type, widget order, defaults and hidden inputs of every op of the
    slice equal the JAX package's."""
    t = tbase.NODE_CLASS_MAPPINGS[name]
    j = jbase.get_op(name).__class__
    assert (t.TYPE, list(t.WIDGETS), dict(t.DEFAULTS), list(t.HIDDEN)) \
        == (j.TYPE, list(j.WIDGETS), dict(j.DEFAULTS), list(j.HIDDEN))


def test_the_port_registers_78_ops():
    """78 ops with the custom-sampling slice; 84 since TomePatchModel,
    HypernetworkLoader, the GLIGEN pair and the style-model pair; 130
    since the tiled VAE, conditioning, latent, image and mask ops."""
    assert len(tbase.NODE_CLASS_MAPPINGS) == 130
    assert set(SLICE_OPS) <= set(jbase.NODE_CLASS_MAPPINGS)


SCHEDULER_OPS = [
    ("BasicScheduler", ("model", "karras", 5, 1.0)),
    ("BasicScheduler", ("model", "normal", 4, 0.6)),
    ("BasicScheduler", ("model", "beta", 6, 1.0)),
    ("KarrasScheduler", (6, 14.614642, 0.0291675, 7.0)),
    ("KarrasScheduler", (3, 8.0, 0.3, 3.0)),
    ("ExponentialScheduler", (5, 14.614642, 0.0291675)),
    ("PolyexponentialScheduler", (6, 12.0, 0.05, 1.7)),
    ("VPScheduler", (5, 19.9, 0.1, 0.001)),
    ("LaplaceScheduler", (8, 14.614642, 0.0291675, 0.0, 0.5)),
    ("BetaSamplingScheduler", ("model", 7, 0.6, 0.6)),
    ("AlignYourStepsScheduler", ("SD1", 10, 1.0)),
    ("AlignYourStepsScheduler", ("SDXL", 12, 0.5)),
    ("AlignYourStepsScheduler", ("SD1", 10, 0.0)),
    ("SDTurboScheduler", ("model", 1, 1.0)),
    ("SDTurboScheduler", ("model", 3, 0.5)),
]


@pytest.mark.parametrize("name,args", SCHEDULER_OPS,
                         ids=[f"{n}-{i}" for i, (n, _) in
                              enumerate(SCHEDULER_OPS)])
def test_scheduler_op_matches_jax(name, args):
    """Each scheduler op against the JAX op; a MODEL input is read for
    its schedule only."""
    def run(get, ctx, ds):
        model = types.SimpleNamespace(schedule=ds)
        a = [model if v == "model" else v for v in args]
        (sig,) = get(name).execute(ctx, *a)
        return np.asarray(sig)

    want = run(jax_get_op, JaxOpContext(), DS_J)
    got = run(get_op, OpContext(device="cpu"), DS_T)
    assert isinstance(got, np.ndarray) and got.dtype == np.float32
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, **SIGMA_TOL)


SIGMA_OPS = [("SplitSigmas", (0,)), ("SplitSigmas", (3,)),
             ("SplitSigmas", (99,)), ("SplitSigmasDenoise", (0.5,)),
             ("SplitSigmasDenoise", (0.35,)), ("SplitSigmasDenoise", (1.0,)),
             ("FlipSigmas", ())]


@pytest.mark.parametrize("name,args", SIGMA_OPS,
                         ids=[f"{n}-{i}" for i, (n, _) in
                              enumerate(SIGMA_OPS)])
def test_sigma_op_matches_jax(name, args):
    sig = tsch.karras_scheduler(DS_T, 6)
    jctx, tctx = JaxOpContext(), OpContext(device="cpu")
    want = jax_get_op(name).execute(jctx, sig.copy(), *args)
    got = get_op(name).execute(tctx, sig.copy(), *args)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, np.asarray(w))
    with pytest.raises(TypeError, match="host"):
        get_op(name).execute(tctx, torch.from_numpy(sig), *args)


def test_flip_sigmas_lifts_a_leading_zero():
    (s,) = get_op("FlipSigmas").execute(OpContext(device="cpu"),
                                        np.asarray([3.0, 1.0, 0.0],
                                                   np.float32))
    np.testing.assert_array_equal(s, np.asarray([1e-4, 1.0, 3.0],
                                                np.float32))


def test_wire_objects_match_jax(env):
    """KSamplerSelect, the noises and the guiders carry what the JAX ops
    carry; a DistributedSeed value rides RandomNoise whole."""
    j, t = _sides("wire.ckpt")
    (js,) = j.op("KSamplerSelect", "dpmpp_2m")
    (ts,) = t.op("KSamplerSelect", "dpmpp_2m")
    assert ts.name == js.name == "dpmpp_2m"
    with pytest.raises(ValueError, match="unknown sampler"):
        t.op("KSamplerSelect", "nope")
    seed = SeedValue(11, distributed=True)
    (tn,) = t.op("RandomNoise", seed)
    (jn,) = j.op("RandomNoise", JaxSeed(11, distributed=True))
    assert tn.seed is seed and (tn.disable, jn.disable) == (False, False)
    (td,) = t.op("DisableNoise")
    (jd,) = j.op("DisableNoise")
    assert (td.seed, td.disable) == (jd.seed, jd.disable) == (0, True)
    mid = t.cond("mid")
    for name, args, want in (
            ("BasicGuider", (t.pos,), ("basic", 1.0, 1.0)),
            ("CFGGuider", (t.pos, t.neg, 6.5), ("cfg", 6.5, 1.0)),
            ("DualCFGGuider", (t.pos, mid, t.neg, 5.0, 2.5),
             ("dual", 5.0, 2.5)),
            ("PerpNegGuider", (t.pos, t.neg, mid, 7.0, 0.8),
             ("perp", 7.0, 0.8))):
        (g,) = t.op(name, t.pipe, *args)
        jargs = [j.pos if a is t.pos else j.neg if a is t.neg
                 else j.cond("mid") if a is mid else a for a in args]
        (jg,) = j.op(name, j.pipe, *jargs)
        assert (g.mode, g.cfg, g.cfg2) == (jg.mode, jg.cfg, jg.cfg2) == want
        assert g.model is t.pipe and g.positive is t.pos
        if name in ("DualCFGGuider", "PerpNegGuider"):
            assert g.middle is mid


# --- the patch ops --------------------------------------------------------------

def test_patch_ops_derive_like_jax(env):
    """RescaleCFG, ModelSamplingDiscrete, SelfAttentionGuidance and
    PerpNeg derive pipelines with the JAX package's attributes (the
    zsnr table within 1e-6), share the base's UNet weights, are cached
    per setting (PerpNeg per empty conditioning) and ride a LoRA."""
    j, t = _sides("patches.ckpt")
    (tr,) = t.op("RescaleCFG", t.pipe, 0.7)
    (jr,) = j.op("RescaleCFG", j.pipe, 0.7)
    assert tr.cfg_rescale == jr.cfg_rescale == 0.7
    assert t.op("RescaleCFG", t.pipe, 0.0)[0] is t.pipe
    for sampling, zsnr in (("v_prediction", False), ("eps", True),
                           ("x0", "true"), ("lcm", False)):
        (tm,) = t.op("ModelSamplingDiscrete", t.pipe, sampling, zsnr)
        (jm,) = j.op("ModelSamplingDiscrete", j.pipe, sampling, zsnr)
        assert tm.prediction_type == jm.prediction_type
        np.testing.assert_allclose(tm.schedule.sigmas, jm.schedule.sigmas,
                                   rtol=1e-6, atol=0)
        assert tm.unet.conv_in.weight is t.pipe.unet.conv_in.weight
    with pytest.raises(ValueError, match="unknown sampling"):
        t.op("ModelSamplingDiscrete", t.pipe, "nope", False)
    (ts,) = t.op("SelfAttentionGuidance", t.pipe, 0.8, 2.5)
    (js,) = j.op("SelfAttentionGuidance", j.pipe, 0.8, 2.5)
    assert ts.sag_params == js.sag_params == (0.8, 2.5)
    assert ts.family.unet.sag_capture and ts.unet.cfg.sag_capture
    assert ts.unet.conv_in.weight is t.pipe.unet.conv_in.weight
    e1, e2 = t.cond("a"), t.cond("b")
    (p1,) = t.op("PerpNeg", t.pipe, e1, 1.0)
    (p2,) = t.op("PerpNeg", t.pipe, e2, 1.0)
    assert p1 is not p2 and p2.perp_neg_cond is e2
    assert t.op("PerpNeg", t.pipe, e1, 1.0)[0] is p1
    # the cache tag: a crc32 of the empty conditioning's float32 bytes
    same = np.random.default_rng(4).standard_normal(
        (1, 77, 64)).astype(np.float32)
    (tp,) = t.op("PerpNeg", t.pipe, Conditioning(
        context=torch.from_numpy(same)), 0.5)
    (jp,) = j.op("PerpNeg", j.pipe, JaxCond(context=same), 0.5)
    assert tp.name.split("|")[-1] == jp.name.split("|")[-1]
    (both,) = t.op("RescaleCFG", p1, 0.5)
    (msd,) = t.op("ModelSamplingDiscrete", both, "v_prediction", True)
    (lora, _) = t.op("LoraLoader", msd, msd, "s.safetensors", 0.5, 0.5)
    assert lora.perp_neg_cond is e1 and lora.perp_neg_scale == 1.0
    assert lora.cfg_rescale == 0.5 and lora.prediction_type == "v"
    assert lora.schedule is msd.schedule


# --- sampling -----------------------------------------------------------------

def _samples(out):
    return _np(out["samples"])


def test_sampler_custom_matches_jax_and_ksampler(env):
    """SamplerCustom with BasicScheduler sigmas equals the port's own
    KSampler to the bit and the JAX SamplerCustom within tolerance; its
    two outputs are one result."""
    j, t = _sides("custom.ckpt")
    res = {}
    for side in (j, t):
        (s,) = side.op("KSamplerSelect", "dpmpp_2m")
        (sig,) = side.op("BasicScheduler", side.pipe, "karras", 3, 1.0)
        a, b = side.op("SamplerCustom", side.pipe, True, 31, 5.0, side.pos,
                       side.neg, _lat(), s, sig)
        np.testing.assert_array_equal(_samples(a), _samples(b))
        res[side.pkg] = _samples(a)
    (ks,) = t.op("KSampler", t.pipe, 31, 3, 5.0, "dpmpp_2m", "karras",
                 t.pos, t.neg, _lat(), 1.0)
    np.testing.assert_array_equal(res["torch"], _samples(ks))
    np.testing.assert_allclose(res["torch"], res["jax"], **TOL)


def test_sampler_custom_advanced_matches_jax(env):
    """SamplerCustomAdvanced under CFGGuider against the JAX op, and
    equal to SamplerCustom to the bit; its two outputs are one
    result."""
    res = {}
    for side in _sides("adv-cfg.ckpt"):
        (s,) = side.op("KSamplerSelect", "euler")
        (sig,) = side.op("BasicScheduler", side.pipe, "normal", 3, 1.0)
        (noise,) = side.op("RandomNoise", 7)
        (g,) = side.op("CFGGuider", side.pipe, side.pos, side.neg, 5.0)
        a, b = side.op("SamplerCustomAdvanced", noise, g, s, sig, _lat())
        np.testing.assert_array_equal(_samples(a), _samples(b))
        res[side.pkg] = _samples(a)
    np.testing.assert_allclose(res["torch"], res["jax"], **TOL)
    ref, _ = side.op("SamplerCustom", side.pipe, True, 7, 5.0, side.pos,
                     side.neg, _lat(), s, sig)
    np.testing.assert_array_equal(res["torch"], _samples(ref))


@pytest.mark.parametrize("guider", ["basic", "disable_noise"])
def test_sampler_custom_advanced_equals_sampler_custom(env, guider):
    """BasicGuider is SamplerCustom at cfg 1, DisableNoise SamplerCustom
    without noise on a non-zero latent, to the bit (both held against
    the JAX executor by the turbo and split graphs below)."""
    t = Side("torch", f"adv-{guider}.ckpt")
    lat = _lat(fill=0.4) if guider == "disable_noise" else _lat()
    (s,) = t.op("KSamplerSelect", "euler")
    (sig,) = t.op("BasicScheduler", t.pipe, "normal", 3, 1.0)
    if guider == "disable_noise":
        (noise,) = t.op("DisableNoise")
        (g,) = t.op("CFGGuider", t.pipe, t.pos, t.neg, 5.0)
    else:
        (noise,) = t.op("RandomNoise", 7)
        (g,) = t.op("BasicGuider", t.pipe, t.pos)
    a, _ = t.op("SamplerCustomAdvanced", noise, g, s, sig, lat)
    ref, _ = t.op("SamplerCustom", t.pipe, guider != "disable_noise", 7,
                  1.0 if guider == "basic" else 5.0, t.pos, t.neg, lat, s,
                  sig)
    np.testing.assert_array_equal(_samples(a), _samples(ref))


def test_split_sigmas_round_trips_match_the_full_run(env):
    """Two stages over SplitSigmas at step 2 equal the single four-step
    run: SamplerCustom (the second without noise) and
    SamplerCustomAdvanced (RandomNoise, then DisableNoise).  The split
    graph is held against the JAX executor below."""
    t = Side("torch", "split.ckpt")
    (s,) = t.op("KSamplerSelect", "euler")
    (sig,) = t.op("BasicScheduler", t.pipe, "karras", 4, 1.0)
    full, _ = t.op("SamplerCustom", t.pipe, True, 5, 4.0, t.pos, t.neg,
                   _lat(), s, sig)
    hi, lo = t.op("SplitSigmas", sig, 2)
    st1, _ = t.op("SamplerCustom", t.pipe, True, 5, 4.0, t.pos, t.neg,
                  _lat(), s, hi)
    st2, _ = t.op("SamplerCustom", t.pipe, False, 5, 4.0, t.pos, t.neg,
                  st1, s, lo)
    np.testing.assert_allclose(_samples(st2), _samples(full), rtol=1e-5,
                               atol=1e-5)
    (g,) = t.op("CFGGuider", t.pipe, t.pos, t.neg, 4.0)
    (noise,) = t.op("RandomNoise", 5)
    (off,) = t.op("DisableNoise")
    adv, _ = t.op("SamplerCustomAdvanced", noise, g, s, sig, _lat())
    np.testing.assert_array_equal(_samples(adv), _samples(full))
    a1, _ = t.op("SamplerCustomAdvanced", noise, g, s, hi, _lat())
    a2, _ = t.op("SamplerCustomAdvanced", off, g, s, lo, a1)
    np.testing.assert_allclose(_samples(a2), _samples(full), rtol=1e-5,
                               atol=1e-5)


def test_flip_sigmas_unsampling_matches_jax(env):
    """An ascending (flipped) schedule samples without noise from a
    non-zero latent, as the JAX package's does.  Stated tolerance 2e-3:
    the first step divides the two packages' float32 rounding of the
    denoised by the lifted sigma 1e-4 and carries it up to sigma_max."""
    j, t = _sides("flip.ckpt")
    res = {}
    for side in (j, t):
        (s,) = side.op("KSamplerSelect", "euler")
        (sig,) = side.op("BasicScheduler", side.pipe, "karras", 3, 1.0)
        (flipped,) = side.op("FlipSigmas", sig)
        out, _ = side.op("SamplerCustom", side.pipe, False, 3, 1.0,
                         side.pos, side.neg, _lat(fill=0.3), s, flipped)
        res[side.pkg] = _samples(out)
    assert np.isfinite(res["torch"]).all()
    np.testing.assert_allclose(res["torch"], res["jax"], rtol=2e-3,
                               atol=2e-3)


@pytest.mark.parametrize("sigmas", [[], [2.5]])
def test_fewer_than_two_sigmas_pass_the_latent_through(env, sigmas):
    t = Side("torch", "short.ckpt")
    lat = {"samples": np.random.default_rng(1).standard_normal(
        (1, 8, 8, 4)).astype(np.float32)}
    (s,) = t.op("KSamplerSelect", "euler")
    out, _ = t.op("SamplerCustom", t.pipe, True, 1, 5.0, t.pos, t.neg, lat,
                  s, np.asarray(sigmas, np.float32))
    np.testing.assert_array_equal(_samples(out), lat["samples"])
    with pytest.raises(ValueError, match="1-D"):
        t.pipe.sample(torch.zeros(1, 8, 8, 4), t.pos.context, t.neg.context,
                      np.zeros(1, np.uint64), 1, 5.0, "euler", "normal",
                      sigmas_override=np.ones((2, 2), np.float32))


@pytest.mark.parametrize("sampling,zsnr", [("v_prediction", False),
                                           ("v_prediction", True)])
def test_model_sampling_discrete_samples_like_jax(env, sampling, zsnr):
    """KSampler on the ModelSamplingDiscrete pipeline (v-prediction of
    eps weights, the zsnr table) against the JAX package's; each moves
    the sample off the plain one.  Stated tolerance under zsnr, 2e-3:
    its first sigma is about 4519, where float32's spacing of the
    noised latent is about 5e-4 before the first step."""
    j, t = _sides(f"msd-{sampling}-{zsnr}.ckpt")
    res = {}
    for side in (j, t):
        (m,) = side.op("ModelSamplingDiscrete", side.pipe, sampling, zsnr)
        (out,) = side.op("KSampler", m, 5, 2, 4.0, "euler", "normal",
                         side.pos, side.pos, _lat(), 1.0)
        res[side.pkg] = _samples(out)
    np.testing.assert_allclose(res["torch"], res["jax"],
                               **(dict(rtol=2e-3, atol=2e-3) if zsnr
                                  else TOL))
    (plain,) = t.op("KSampler", t.pipe, 5, 2, 4.0, "euler", "normal",
                    t.pos, t.pos, _lat(), 1.0)
    assert np.isfinite(res["torch"]).all()
    assert np.abs(res["torch"] - _samples(plain)).max() > 1e-3


# --- whole graphs -------------------------------------------------------------

def custom_doc(guider="cfg", seed=77, steps=3, size=64, scheduler="karras",
               sampler="euler"):
    """A tiny txt2img through SamplerCustomAdvanced: RandomNoise, a
    guider, KSamplerSelect and BasicScheduler (or, for ``"turbo"``,
    BasicGuider over SDTurboScheduler; for ``"ays"``, CFGGuider over
    AlignYourStepsScheduler)."""
    doc = {
        "4": {"class_type": "CheckpointLoaderSimple",
              "inputs": {"ckpt_name": "graph.ckpt"}},
        "5": {"class_type": "EmptyLatentImage",
              "inputs": {"width": size, "height": size, "batch_size": 1}},
        "6": {"class_type": "CLIPTextEncode",
              "inputs": {"text": "a lighthouse", "clip": ["4", 1]}},
        "7": {"class_type": "CLIPTextEncode",
              "inputs": {"text": "blurry", "clip": ["4", 1]}},
        "20": {"class_type": "RandomNoise", "inputs": {"noise_seed": seed}},
        "21": {"class_type": "KSamplerSelect",
               "inputs": {"sampler_name": sampler}},
        "22": {"class_type": "BasicScheduler",
               "inputs": {"model": ["4", 0], "scheduler": scheduler,
                          "steps": steps, "denoise": 1.0}},
        "23": {"class_type": "CFGGuider",
               "inputs": {"model": ["4", 0], "positive": ["6", 0],
                          "negative": ["7", 0], "cfg": 6.0}},
        "3": {"class_type": "SamplerCustomAdvanced",
              "inputs": {"noise": ["20", 0], "guider": ["23", 0],
                         "sampler": ["21", 0], "sigmas": ["22", 0],
                         "latent_image": ["5", 0]}},
        "8": {"class_type": "VAEDecode",
              "inputs": {"samples": ["3", 0], "vae": ["4", 2]}},
        "9": {"class_type": "PreviewImage", "inputs": {"images": ["8", 0]}},
    }
    if guider == "dual":
        doc["24"] = {"class_type": "CLIPTextEncode",
                     "inputs": {"text": "oil painting", "clip": ["4", 1]}}
        doc["23"] = {"class_type": "DualCFGGuider",
                     "inputs": {"model": ["4", 0], "cond1": ["6", 0],
                                "cond2": ["24", 0], "negative": ["7", 0],
                                "cfg_conds": 6.0,
                                "cfg_cond2_negative": 2.0}}
    elif guider == "perp":
        doc["24"] = {"class_type": "CLIPTextEncode",
                     "inputs": {"text": "", "clip": ["4", 1]}}
        doc["23"] = {"class_type": "PerpNegGuider",
                     "inputs": {"model": ["4", 0], "positive": ["6", 0],
                                "negative": ["7", 0],
                                "empty_conditioning": ["24", 0],
                                "cfg": 6.0, "neg_scale": 0.8}}
    elif guider == "turbo":
        doc["22"] = {"class_type": "SDTurboScheduler",
                     "inputs": {"model": ["4", 0], "steps": 1,
                                "denoise": 1.0}}
        doc["23"] = {"class_type": "BasicGuider",
                     "inputs": {"model": ["4", 0],
                                "conditioning": ["6", 0]}}
    elif guider == "ays":
        doc["22"] = {"class_type": "AlignYourStepsScheduler",
                     "inputs": {"model_type": "SD1", "steps": steps,
                                "denoise": 1.0}}
    elif guider == "split":
        doc["25"] = {"class_type": "SplitSigmas",
                     "inputs": {"sigmas": ["22", 0], "step": 1}}
        doc["26"] = {"class_type": "DisableNoise", "inputs": {}}
        doc["3"]["inputs"]["sigmas"] = ["25", 0]
        doc["27"] = {"class_type": "SamplerCustomAdvanced",
                     "inputs": {"noise": ["26", 0], "guider": ["23", 0],
                                "sampler": ["21", 0], "sigmas": ["25", 1],
                                "latent_image": ["3", 0]}}
        doc["8"]["inputs"]["samples"] = ["27", 0]
    return doc


@pytest.mark.parametrize("guider", ["dual", "turbo", "ays", "split"])
def test_custom_graph_matches_the_jax_executor(env, guider):
    """The slice as a whole: each graph through the port's
    WorkflowExecutor and the JAX one, the decoded images within 2e-3
    (DualCFGGuider; BasicGuider over SDTurboScheduler; CFGGuider over
    AlignYourStepsScheduler with dpmpp_2m; a SplitSigmas pair, the
    second under DisableNoise)."""
    doc = custom_doc(guider, sampler="dpmpp_2m" if guider == "ays"
                     else "euler")
    ours = WorkflowExecutor(OpContext(device="cpu")).execute(
        copy.deepcopy(doc))
    ref = JaxExecutor(JaxOpContext()).execute(copy.deepcopy(doc))
    ref.wait_host()
    a, b = ours.image_batch, ref.image_batch
    assert a.shape == b.shape == (1, 16, 16, 3)
    assert np.isfinite(a).all() and a.std() > 0
    np.testing.assert_allclose(a, b, rtol=0, atol=IMAGE_ATOL)


def test_custom_graphs_are_never_coalesced_or_batched(env, tmp_path):
    """A custom-sampler graph has no coalescing signature (its ops are
    not in the coalesce-safe list, as in the JAX package) and the
    continuous-batching screen answers as the JAX package's."""
    from comfyui_distributed_tpu.workflow import batch_executor as jcb
    from comfyui_distributed_tpu.workflow import scheduler as jsched
    from comfyui_distributed_tpu_torch.utils import constants as tconst
    from comfyui_distributed_tpu.utils import constants as jconst
    from comfyui_distributed_tpu_torch.workflow import batch_executor as tcb
    from comfyui_distributed_tpu_torch.workflow import scheduler as tsched
    assert tconst.COALESCE_SAFE_NODE_TYPES == jconst.COALESCE_SAFE_NODE_TYPES
    assert tconst.RESULT_CACHE_SAFE_NODE_TYPES \
        == jconst.RESULT_CACHE_SAFE_NODE_TYPES
    assert not set(SLICE_OPS) & tconst.COALESCE_SAFE_NODE_TYPES
    for guider in ("cfg", "dual", "turbo"):
        doc = custom_doc(guider)
        assert tsched.coalesce_signature(doc) is None
        assert jsched.coalesce_signature(doc) is None
        assert tcb.quick_eligible(doc) == jcb.quick_eligible(doc)
    with pytest.raises(tcb.CBIneligible, match="KSampler"):
        tcb._Bucket("sig", {"prompt": custom_doc()},
                    OpContext(device="cpu", input_dir=str(tmp_path)), 2)


TORCH_CLI = ("import sys\n"
             "from comfyui_distributed_tpu_torch import cli\n"
             "sys.exit(cli.main(sys.argv[1:]))\n")


def test_custom_graph_through_a_cli_serve_master(env, tmp_path):
    """One SamplerCustomAdvanced graph (DualCFGGuider) POSTed to a port
    ``cli serve`` master on the CPU: its saved image equals the
    in-process run's, 8-bit for 8-bit."""
    port = find_free_port()
    env_ = {**os.environ, "DTPU_DEFAULT_FAMILY": "tiny",
            "PYTHONPATH": str(ROOT), "DTPU_CACHE": "0"}
    for sub in ("input", "output"):
        (tmp_path / sub).mkdir()
    log = open(tmp_path / "log.txt", "w")
    proc = subprocess.Popen(
        [sys.executable, "-c", TORCH_CLI, "serve", "--host", "127.0.0.1",
         "--port", str(port), "--config", str(tmp_path / "cfg.json"),
         "--device", "cpu", "--input-dir", str(tmp_path / "input"),
         "--output-dir", str(tmp_path / "output")], cwd=str(tmp_path),
        env=env_, stdout=log, stderr=subprocess.STDOUT)
    url = f"http://127.0.0.1:{port}"

    def logs():
        return (tmp_path / "log.txt").read_text()[-3000:]

    doc = custom_doc("dual", steps=2)
    doc["9"]["class_type"] = "SaveImage"
    doc["9"]["inputs"]["filename_prefix"] = "custom"
    try:
        deadline = time.time() + 120
        while True:
            assert proc.poll() is None, logs()
            try:
                get_json(url + "/prompt", timeout=2)
                break
            except OSError:
                assert time.time() < deadline, logs()
                time.sleep(0.3)
        resp = post_json(url + "/prompt", {"prompt": copy.deepcopy(doc),
                                           "client_id": "t"})
        deadline = time.time() + 180
        while resp["prompt_id"] not in get_json(url + "/history"):
            assert time.time() < deadline, logs()
            time.sleep(0.2)
        entry = get_json(url + "/history")[resp["prompt_id"]]
    finally:
        proc.terminate()
        try:
            proc.wait(timeout=10)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()
        log.close()
    assert entry["status"] == "success" and entry["images"] == 1, \
        (entry, logs())
    files = sorted((tmp_path / "output").glob("*.png"))
    assert len(files) == 1
    doc["9"] = {"class_type": "PreviewImage",
                "inputs": {"images": ["8", 0]}}
    ref = WorkflowExecutor(OpContext(device="cpu")).execute(doc) \
        .image_batch[0]
    got = decode_png(files[0].read_bytes())[0]
    want = to_uint8(ref).astype(np.float32) / 255.0
    np.testing.assert_array_equal(got, want)
