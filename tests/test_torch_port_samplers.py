"""The port's nine schedulers and 34 samplers against the JAX package's:
every scheduler to the bit; every sampler over the tiny UNet for 4 steps
at fp32, with the same keys and sigmas, and every noise draw of the
noise-drawing samplers from the same keys and fold-ins, to the bit."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from comfyui_distributed_tpu.models import denoiser as jden
from comfyui_distributed_tpu.models import registry as jreg
from comfyui_distributed_tpu.models import samplers as jsmp
from comfyui_distributed_tpu.models import schedules as jsch
from comfyui_distributed_tpu.models import unet as junet
from comfyui_distributed_tpu_torch.models import denoiser as tden
from comfyui_distributed_tpu_torch.models import prng
from comfyui_distributed_tpu_torch.models import samplers as tsmp
from comfyui_distributed_tpu_torch.models import schedules as tsch
from comfyui_distributed_tpu_torch.models import unet as tunet
from comfyui_distributed_tpu_torch.models.weights import state_dict_from_flax

# a sampler's latents against the JAX package's: |x| reaches ~50, and
# the two UNets differ by ~1e-6 a call at fp32
TOL = 2e-4
# samplers that need more, and why (none may exceed 2e-3)
WIDER_TOL = {
    # its step sizes follow an error estimate taken from the difference
    # of an embedded solver pair, a cancellation that magnifies the
    # UNets' differences: 21 attempts land ~1e-6 apart in t and the
    # latents differ by up to 5e-4 (the same attempts are accepted:
    # test_dpm_adaptive_takes_the_same_model_calls)
    "dpm_adaptive": 1e-3,
}
NOISE_SAMPLERS = ("euler_ancestral", "euler_ancestral_cfg_pp",
                  "dpm_2_ancestral", "dpmpp_2s_ancestral", "dpmpp_sde",
                  "dpmpp_2m_sde", "dpmpp_3m_sde", "ddpm", "lcm",
                  "res_multistep_ancestral",
                  "res_multistep_ancestral_cfg_pp", "er_sde", "seeds_2",
                  "seeds_3")
SEEDS = np.asarray([7, 2 ** 33 + 1], np.uint64)
CFG = 2.5


@pytest.mark.parametrize("denoise", [1.0, 0.6, 0.35])
@pytest.mark.parametrize("scheduler", list(jsch.SCHEDULERS))
def test_scheduler_equals_jax_to_the_bit(scheduler, denoise):
    jd, td = jsch.make_discrete_schedule(), tsch.make_discrete_schedule()
    for steps in range(1, 51):
        js = jsch.compute_sigmas(jd, scheduler, steps, denoise)
        ts = tsch.compute_sigmas(td, scheduler, steps, denoise)
        assert ts.dtype == js.dtype == np.float32
        np.testing.assert_array_equal(ts, js, err_msg=f"{steps} steps")


def test_every_name_is_registered_and_unknown_names_raise():
    assert list(tsmp.SAMPLERS) == list(jsmp.SAMPLERS)
    assert list(tsch.SCHEDULERS) == list(jsch.SCHEDULERS)
    with pytest.raises(ValueError, match="unknown sampler"):
        tsmp.get_sampler("euler_but_faster")
    with pytest.raises(ValueError, match="unknown scheduler"):
        tsch.compute_sigmas(tsch.make_discrete_schedule(), "fancy", 4)
    with pytest.raises(ValueError, match="keys"):
        tsmp.get_sampler("euler_ancestral")(
            lambda x, s: x, torch.zeros(1, 2, 2, 4), [1.0, 0.0])


class _Runs:
    """Each sampler run once a side over the tiny UNet: the JAX package's
    eagerly (``jax.disable_jit``, so every fold-in index and branch is a
    concrete value) around one jitted CFG denoiser, the port's on the
    CPU; each run's latents, noise draws and model calls are kept."""

    def __init__(self):
        params = jreg._virtual_params(
            junet.UNet(junet.TINY_CONFIG), 5, jnp.zeros((1, 8, 8, 4)),
            jnp.zeros((1,)), jnp.zeros((1, 77, 64)))
        unet = tunet.UNet(tunet.TINY_CONFIG)
        unet.load_state_dict(state_dict_from_flax(
            unet, jax.tree_util.tree_map(np.asarray, params)))
        jmod = junet.UNet(junet.TINY_CONFIG)
        sched = jsch.make_discrete_schedule()
        self.sig = jsch.compute_sigmas(sched, "karras", 4)
        rng = np.random.default_rng(4)
        self.x = rng.standard_normal((2, 8, 8, 4)).astype(np.float32) \
            * self.sig[0]
        ctx, unc = (rng.standard_normal((2, 77, 64)).astype(np.float32)
                    for _ in range(2))
        self.keys = prng.sample_keys(SEEDS)
        jden_fn = jden.make_denoiser(
            lambda p, xi, t, c, y=None, control=None, **kw: jmod.apply(
                {"params": p}, xi, t, c, y=y), params, sched)
        jcfg = jsmp.cfg_denoiser_multi(
            jden_fn, [(jnp.asarray(ctx), None, 1.0)], jnp.asarray(unc), CFG)
        self._jstep = jax.jit(lambda x, s: (jcfg(x, s), jcfg.last_uncond))
        self._tmodel = tsmp.cfg_denoiser_multi(
            tden.make_denoiser(unet.eval(), tsch.make_discrete_schedule()),
            [(torch.from_numpy(ctx), None, 1.0)], torch.from_numpy(unc),
            CFG)
        self._jax, self._torch = {}, {}

    def jax(self, name):
        if name not in self._jax:
            self._jax[name] = self._run_jax(name)
        return self._jax[name]

    def torch(self, name):
        if name not in self._torch:
            self._torch[name] = self._run_torch(name)
        return self._torch[name]

    def _run_jax(self, name):
        draws, calls = [], [0]

        def model(x, sigma, **kw):
            calls[0] += 1
            with jax.disable_jit(False):
                out, model.last_uncond = self._jstep(
                    jnp.asarray(x, jnp.float32),
                    jnp.asarray(sigma, jnp.float32))
            return out

        def recording(make):
            def make_noise(keys):
                fn = make(keys)

                def noise(step, shape):
                    draws.append(int(np.asarray(step).reshape(-1)[0]))
                    return fn(step, shape)
                return noise
            return make_noise

        real = jsmp.make_noise_fn, jsmp.make_noise_fn_rowwise
        jsmp.make_noise_fn, jsmp.make_noise_fn_rowwise = map(recording, real)
        try:
            with jax.disable_jit():
                out = jsmp.get_sampler(name)(
                    model, jnp.asarray(self.x), jnp.asarray(self.sig),
                    keys=jnp.asarray(self.keys))
        finally:
            jsmp.make_noise_fn, jsmp.make_noise_fn_rowwise = real
        return np.asarray(out), draws, calls[0]

    def _run_torch(self, name):
        draws, calls = [], [0]

        def model(x, sigma, **kw):
            calls[0] += 1
            out = self._tmodel(x, sigma, **kw)
            model.last_uncond = self._tmodel.last_uncond
            return out

        def recording(keys, index, x):
            draws.append(index)
            return real(keys, index, x)

        real = tsmp.step_noise
        tsmp.step_noise = recording
        try:
            with torch.no_grad():
                out = tsmp.get_sampler(name)(model, torch.from_numpy(self.x),
                                             self.sig, keys=self.keys)
        finally:
            tsmp.step_noise = real
        assert out.dtype == torch.float32
        return out.numpy(), draws, calls[0]


@pytest.fixture(scope="module")
def runs():
    return _Runs()


@pytest.mark.parametrize("name", list(jsmp.SAMPLERS))
def test_sampler_matches_jax(name, runs):
    jout, _, jcalls = runs.jax(name)
    tout, _, tcalls = runs.torch(name)
    assert tout.shape == jout.shape == runs.x.shape
    assert tcalls == jcalls >= 4
    tol = WIDER_TOL.get(name, TOL)
    np.testing.assert_allclose(tout, jout, rtol=tol, atol=tol)


def test_dpm_adaptive_takes_the_same_model_calls(runs):
    """The controller accepts and rejects the same attempts: a flipped
    decision shows as another number of model calls (3 an attempt)."""
    assert runs.torch("dpm_adaptive")[2] == runs.jax("dpm_adaptive")[2] > 12


@pytest.mark.parametrize("name", NOISE_SAMPLERS)
def test_noise_draws_equal_jax_to_the_bit(name, runs):
    """The port draws at the JAX sampler's fold-in indices, in order
    (it skips only the last step's draws, whose amount is 0), and each
    draw's random bits are the JAX package's to the bit."""
    jdraws, tdraws = runs.jax(name)[1], runs.torch(name)[1]
    per_step = 3 if name == "seeds_3" else \
        2 if name in ("dpmpp_sde", "seeds_2") else 1
    assert tdraws and jdraws[:len(tdraws)] == tdraws
    # the draws the port skips are the last step's
    assert all(i >= per_step * 3 for i in jdraws[len(tdraws):])
    for index in sorted(set(tdraws)):
        for key in runs.keys:
            want = jax.random.bits(jax.random.fold_in(jnp.asarray(key),
                                                      index), (8, 8, 4))
            got = prng.random_bits(prng.fold_in(key, index), (8, 8, 4))
            np.testing.assert_array_equal(got, np.asarray(want))
