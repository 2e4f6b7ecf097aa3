"""k-diffusion samplers in PyTorch: the counterpart of the ``SAMPLERS``
table of ``comfyui_distributed_tpu/models/samplers.py`` (all 34 of
KSampler's ``sampler_name`` values) and of its classifier-free guidance:
the multi-entry combine with its optional CFG rescale, and the combines
outside ``SAMPLERS`` (dual CFG, Perp-Neg, self-attention guidance).

Each sampler is a Python loop over consecutive sigma pairs, ended early
by an interrupt (:func:`_until_interrupted`, checked at the top of each
step).  The sigmas are host values (float32, read once), so what the
JAX package decides with ``lax.cond``/``lax.switch`` on a traced sigma
or step index (the last step to sigma 0, the order ramps of the
multistep solvers) is a plain Python branch here, and every scalar
coefficient is a host float: nothing in the loop waits for the card.  Only ``dpm_adaptive`` reads a
value back, its error estimate, once per attempt.

Step noise: row b of step i's draw comes from ``fold_in(keys[b], i)``
(``models/prng.py``), the JAX package's ``make_noise_fn``; samplers that
draw more than once a step use its indices (2i and 2i + 1, or 3i to
3i + 2).  A draw whose amount is 0 (the last step of an ancestral
sampler) is skipped: adding it would change nothing.

Model convention: ``model(x, sigma, **extra) -> denoised`` (x0
prediction) on NHWC latents, ``sigma`` a host float; the extracted
steps (euler, ddim, euler_ancestral, ``SAMPLER_STEPS``) pass a [B]
float32 tensor on x's device when their rows' sigmas differ (a
continuous-batching bucket).  A CFG wrapper
(:func:`cfg_denoiser_multi`) leaves the uncond denoised of its last call
in ``model.last_uncond``, which the CFG++ samplers read; a bare model
falls back to the denoised.
"""

from __future__ import annotations

import math
from typing import (Any, Callable, Dict, Iterable, Iterator, List, Optional,
                    Tuple)

import numpy as np
import torch

from comfyui_distributed_tpu_torch.models.prng import batch_normal, rows_normal
from comfyui_distributed_tpu_torch.runtime import interrupt as itr

Model = Callable[..., torch.Tensor]
Extra = Optional[Dict[str, Any]]


def _host_sigmas(sigmas) -> List[float]:
    """The sigma sequence as host floats (float32 values)."""
    if isinstance(sigmas, torch.Tensor):
        sigmas = sigmas.detach().cpu().numpy()
    return np.asarray(sigmas, np.float32).tolist()


def _until_interrupted(steps: Iterable) -> Iterator:
    """``steps`` up to the first one that finds the interrupt flag set
    (``runtime/interrupt.py``), read at the top of each step: that step
    and every later one skip their model calls and leave the latent as
    it is, the JAX package's per-step contract.  A step of two or more
    model calls is checked once, at its top."""
    for step in steps:
        if itr.is_interrupted():
            return
        yield step


def _steps(sig: List[float]) -> Iterator[Tuple[int, float, float]]:
    """(i, sigma_i, sigma_i+1) of each step, while not interrupted."""
    return _until_interrupted(
        (i, s, s_next) for i, (s, s_next) in enumerate(zip(sig[:-1],
                                                            sig[1:])))


def step_noise(keys: np.ndarray, index: int, x: torch.Tensor
               ) -> torch.Tensor:
    """[B, *x.shape[1:]] standard normals on x's device, row b from
    ``fold_in(keys[b], index)``."""
    return batch_normal(keys, index, tuple(x.shape[1:]), x.device)


def _need_keys(name: str, keys) -> None:
    if keys is None:
        raise ValueError(f"{name} requires per-sample keys")


def _ancestral_sigmas(s: float, s_next: float, eta: float = 1.0
                      ) -> Tuple[float, float]:
    """(sigma_down, sigma_up) split of an ancestral step."""
    su = min(s_next, eta * math.sqrt(max(
        s_next ** 2 * (s ** 2 - s_next ** 2) / max(s ** 2, 1e-20), 0.0)))
    return math.sqrt(max(s_next ** 2 - su ** 2, 0.0)), su


def _to_d(x: torch.Tensor, s: float, denoised: torch.Tensor
          ) -> torch.Tensor:
    return (x - denoised) / max(s, 1e-20)


def _t(s: float) -> float:
    """Half-log-SNR time t = -log(sigma)."""
    return -math.log(max(s, 1e-20))


def _last_uncond(model: Model, denoised: torch.Tensor) -> torch.Tensor:
    return getattr(model, "last_uncond", denoised)


def _phi1(neg_h: float) -> float:
    return math.expm1(neg_h) / neg_h


def _phi2(neg_h: float) -> float:
    return (_phi1(neg_h) - 1.0) / neg_h


# --- extracted steps (continuous batching) ----------------------------------
#
# The step executor (workflow/batch_executor.py) advances a padded batch
# one sigma pair at a time with every row at its own place in its own
# schedule, so these samplers' step is a callable of its own,
# ``<name>_step(model, x, sigma, sigma_next, step_i, keys, extra_args)``,
# taking per-row [B] vectors (a host float or int stands for every row).
# sample_euler, sample_ddim and sample_euler_ancestral run through the
# same callables, so the serial loop and a bucket do the same arithmetic
# on a row: its coefficients in float32 on the host, one copy of them a
# step to the device, the same device expressions.

def _row_vector(v, n: int, dtype=np.float32) -> np.ndarray:
    """A host [n] vector from a scalar (every row) or a [n] vector."""
    return np.broadcast_to(np.asarray(v, dtype), (n,)).copy()


def _rows_on_device(x: torch.Tensor, *cols: np.ndarray
                    ) -> List[torch.Tensor]:
    """Host float32 [B] columns -> [B] tensors on x's device, one copy
    for all of them."""
    t = torch.from_numpy(np.stack(cols).astype(np.float32)).to(
        x.device, non_blocking=True)
    return list(t.unbind(0))


def _per_row(v: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    return v.reshape((-1,) + (1,) * (x.ndim - 1))


def _model_sigma(s: np.ndarray, s_dev: torch.Tensor):
    """The model's sigma: a host float while every row shares it (the
    serial loop; the model convention above), else the [B] tensor.  The
    denoiser makes the same per-row values of either."""
    return float(s[0]) if (s == s[0]).all() else s_dev


def _ancestral_rows(s: np.ndarray, s_next: np.ndarray, eta: float = 1.0
                    ) -> Tuple[np.ndarray, np.ndarray]:
    """(sigma_down, sigma_up) per row, float32 as the JAX package's."""
    f = np.float32
    su = np.minimum(s_next, f(eta) * np.sqrt(np.maximum(
        s_next * s_next * (s * s - s_next * s_next)
        / np.maximum(s * s, f(1e-20)), f(0.0))))
    sd = np.sqrt(np.maximum(s_next * s_next - su * su, f(0.0)))
    return sd, su


def step_noise_rows(keys: np.ndarray, step_i, x: torch.Tensor,
                    live: np.ndarray) -> torch.Tensor:
    """[B, *x.shape[1:]] normals, row b from ``fold_in(keys[b],
    step_i[b])`` (zeros where ``live`` is False)."""
    return rows_normal(keys, _row_vector(step_i, x.shape[0], np.int64),
                       tuple(x.shape[1:]), x.device, live=live)


def euler_step(model: Model, x: torch.Tensor, sigma, sigma_next,
               step_i=0, keys=None, extra_args: Extra = None
               ) -> torch.Tensor:
    """One Euler (== deterministic DDIM) step; ``step_i`` and ``keys``
    are taken for a uniform signature and unused."""
    n = x.shape[0]
    s, s_next = _row_vector(sigma, n), _row_vector(sigma_next, n)
    s_dev, s_div, dt = _rows_on_device(
        x, s, np.maximum(s, np.float32(1e-20)), s_next - s)
    denoised = model(x, _model_sigma(s, s_dev), **(extra_args or {}))
    return x + (x - denoised) / _per_row(s_div, x) * _per_row(dt, x)


def euler_ancestral_step(model: Model, x: torch.Tensor, sigma,
                         sigma_next, step_i, keys,
                         extra_args: Extra = None,
                         eta: float = 1.0) -> torch.Tensor:
    """One ancestral Euler step: to sigma_down, then row b's noise from
    ``fold_in(keys[b], step_i[b])`` at sigma_up.  No row draws where
    its sigma_up is 0 (the last step, a pad row): adding nothing leaves
    it as it is."""
    _need_keys("euler_ancestral", keys)
    n = x.shape[0]
    s, s_next = _row_vector(sigma, n), _row_vector(sigma_next, n)
    sd, su = _ancestral_rows(s, s_next, eta)
    s_dev, s_div, c_down, c_up = _rows_on_device(
        x, s, np.maximum(s, np.float32(1e-20)), sd - s, su)
    denoised = model(x, _model_sigma(s, s_dev), **(extra_args or {}))
    x = x + (x - denoised) / _per_row(s_div, x) * _per_row(c_down, x)
    live = su > 0
    if not live.any():
        return x
    if np.ndim(step_i) == 0 and live.all():
        noise = step_noise(keys, int(step_i), x)
    else:
        noise = step_noise_rows(keys, step_i, x, live)
    return x + noise * _per_row(c_up, x)


# sampler name -> its extracted step: what the step executor admits
# (constants.CB_SAFE_SAMPLERS names the same keys)
SAMPLER_STEPS: Dict[str, Callable] = {
    "euler": euler_step,
    "ddim": euler_step,
    "euler_ancestral": euler_ancestral_step,
}


def get_sampler_step(name: str) -> Callable:
    if name not in SAMPLER_STEPS:
        raise ValueError(
            f"sampler {name!r} has no extracted step callable; "
            f"continuous batching supports: {sorted(SAMPLER_STEPS)}")
    return SAMPLER_STEPS[name]


# --- first-order and ancestral ----------------------------------------------

def sample_euler(model: Model, x: torch.Tensor, sigmas, extra_args: Extra
                 = None, keys=None) -> torch.Tensor:
    sig = _host_sigmas(sigmas)
    for i, s, s_next in _steps(sig):
        x = euler_step(model, x, s, s_next, i, keys, extra_args)
    return x


sample_ddim = sample_euler  # deterministic DDIM == euler in sigma space


def sample_euler_ancestral(model: Model, x: torch.Tensor, sigmas,
                           extra_args: Extra = None, keys=None,
                           eta: float = 1.0) -> torch.Tensor:
    _need_keys("euler_ancestral", keys)
    sig = _host_sigmas(sigmas)
    for i, s, s_next in _steps(sig):
        x = euler_ancestral_step(model, x, s, s_next, i, keys, extra_args,
                                 eta)
    return x


def sample_euler_cfg_pp(model: Model, x: torch.Tensor, sigmas,
                        extra_args: Extra = None, keys=None
                        ) -> torch.Tensor:
    """Euler CFG++: the direction from the uncond denoised, the anchor
    the CFG result."""
    extra = extra_args or {}
    sig = _host_sigmas(sigmas)
    for _, s, s_next in _steps(sig):
        denoised = model(x, s, **extra)
        x = denoised + _to_d(x, s, _last_uncond(model, denoised)) * s_next
    return x


def sample_euler_ancestral_cfg_pp(model: Model, x: torch.Tensor, sigmas,
                                  extra_args: Extra = None, keys=None,
                                  eta: float = 1.0) -> torch.Tensor:
    _need_keys("euler_ancestral_cfg_pp", keys)
    extra = extra_args or {}
    sig = _host_sigmas(sigmas)
    for i, s, s_next in _steps(sig):
        denoised = model(x, s, **extra)
        sd, su = _ancestral_sigmas(s, s_next, eta)
        x = denoised + _to_d(x, s, _last_uncond(model, denoised)) * sd
        if su > 0:
            x = x + step_noise(keys, i, x) * su
    return x


def sample_heun(model: Model, x: torch.Tensor, sigmas, extra_args: Extra
                = None, keys=None) -> torch.Tensor:
    extra = extra_args or {}
    sig = _host_sigmas(sigmas)
    for _, s, s_next in _steps(sig):
        d = _to_d(x, s, model(x, s, **extra))
        x_euler = x + d * (s_next - s)
        if s_next > 0:
            d2 = _to_d(x_euler, s_next, model(x_euler, s_next, **extra))
            x = x + (d + d2) / 2 * (s_next - s)
        else:
            x = x_euler
    return x


def sample_dpm_2(model: Model, x: torch.Tensor, sigmas, extra_args: Extra
                 = None, keys=None) -> torch.Tensor:
    """DPM-Solver-2 (midpoint in log sigma)."""
    extra = extra_args or {}
    sig = _host_sigmas(sigmas)
    for _, s, s_next in _steps(sig):
        d = _to_d(x, s, model(x, s, **extra))
        if s_next > 0:
            s_mid = math.exp((math.log(s) + math.log(max(s_next, 1e-20)))
                             / 2)
            x_mid = x + d * (s_mid - s)
            d2 = _to_d(x_mid, s_mid, model(x_mid, s_mid, **extra))
            x = x + d2 * (s_next - s)
        else:
            x = x + d * (s_next - s)
    return x


def sample_dpm_2_ancestral(model: Model, x: torch.Tensor, sigmas,
                           extra_args: Extra = None, keys=None,
                           eta: float = 1.0) -> torch.Tensor:
    _need_keys("dpm_2_ancestral", keys)
    extra = extra_args or {}
    sig = _host_sigmas(sigmas)
    for i, s, s_next in _steps(sig):
        denoised = model(x, s, **extra)
        sd, su = _ancestral_sigmas(s, s_next, eta)
        d = _to_d(x, s, denoised)
        if sd > 0:
            s_mid = math.exp((math.log(s) + math.log(max(sd, 1e-20))) / 2)
            x_mid = x + d * (s_mid - s)
            d2 = _to_d(x_mid, s_mid, model(x_mid, s_mid, **extra))
            x = x + d2 * (sd - s)
            x = x + step_noise(keys, i, x) * su
        else:
            x = x + d * (s_next - s)
    return x


def sample_dpmpp_2s_ancestral(model: Model, x: torch.Tensor, sigmas,
                              extra_args: Extra = None, keys=None,
                              eta: float = 1.0) -> torch.Tensor:
    """DPM-Solver++(2S) ancestral."""
    _need_keys("dpmpp_2s_ancestral", keys)
    extra = extra_args or {}
    sig = _host_sigmas(sigmas)
    for i, s, s_next in _steps(sig):
        denoised = model(x, s, **extra)
        sd, su = _ancestral_sigmas(s, s_next, eta)
        if sd > 0:
            t = _t(s)
            h = _t(sd) - t
            s_mid = math.exp(-(t + h / 2))
            x_2 = (s_mid / s) * x - math.expm1(-h * 0.5) * denoised
            denoised_2 = model(x_2, s_mid, **extra)
            x = (sd / s) * x - math.expm1(-h) * denoised_2
            x = x + step_noise(keys, i, x) * su
        else:
            x = x + _to_d(x, s, denoised) * (s_next - s)
    return x


# --- DPM-Solver++ multistep and SDE -----------------------------------------

def sample_dpmpp_2m(model: Model, x: torch.Tensor, sigmas, extra_args:
                    Extra = None, keys=None) -> torch.Tensor:
    """DPM-Solver++(2M): multistep over the previous denoised."""
    extra = extra_args or {}
    sig = _host_sigmas(sigmas)
    old = None
    for i, s, s_next in _steps(sig):
        denoised = model(x, s, **extra)
        h = _t(s_next) - _t(s)
        if i > 0 and s_next > 0:
            r = (_t(s) - _t(sig[i - 1])) / h
            denoised_d = (1 + 1 / (2 * r)) * denoised \
                - (1 / (2 * r)) * old
        else:
            denoised_d = denoised
        if s_next > 0:
            x = (s_next / s) * x - math.expm1(-h) * denoised_d
        else:
            x = denoised_d
        old = denoised
    return x


def sample_dpmpp_2m_cfg_pp(model: Model, x: torch.Tensor, sigmas,
                           extra_args: Extra = None, keys=None
                           ) -> torch.Tensor:
    """DPM-Solver++(2M) with the CFG++ anchor: the exponential decay
    anchors on the uncond denoised; dpmpp_2m for a bare model."""
    extra = extra_args or {}
    sig = _host_sigmas(sigmas)
    old = None
    for i, s, s_next in _steps(sig):
        denoised = model(x, s, **extra)
        anchor = _last_uncond(model, denoised)
        if s_next > 0:
            h = _t(s_next) - _t(s)
            x_new = denoised + math.exp(-h) * (x - anchor)
            if i > 0:
                r = (_t(s) - _t(sig[i - 1])) / h
                x_new = x_new + -math.expm1(-h) * (1.0 / (2.0 * r)) \
                    * (denoised - old)
            x = x_new
        else:
            x = denoised
        old = denoised
    return x


def sample_dpmpp_2m_sde(model: Model, x: torch.Tensor, sigmas,
                        extra_args: Extra = None, keys=None,
                        eta: float = 1.0) -> torch.Tensor:
    """DPM-Solver++(2M) SDE, midpoint variant."""
    _need_keys("dpmpp_2m_sde", keys)
    extra = extra_args or {}
    sig = _host_sigmas(sigmas)
    old, h_last = None, 1.0
    for i, s, s_next in _steps(sig):
        denoised = model(x, s, **extra)
        if s_next > 0:
            h = -math.log(s_next) + math.log(s)
            x = (s_next / s) * math.exp(-h * eta) * x \
                + (-math.expm1(-h * (1 + eta))) * denoised
            if i > 0:
                r = h_last / h
                x = x + 0.5 * (-math.expm1(-h * (1 + eta))) * (1 / r) \
                    * (denoised - old)
            amt = s_next * math.sqrt(max(-math.expm1(-2 * eta * h), 0.0))
            x = x + step_noise(keys, i, x) * amt
            h_last = h
        else:
            x = denoised
        old = denoised
    return x


def sample_dpmpp_sde(model: Model, x: torch.Tensor, sigmas, extra_args:
                     Extra = None, keys=None, eta: float = 1.0,
                     r: float = 1.0 / 2) -> torch.Tensor:
    """DPM-Solver++ (stochastic): two model calls and two noise draws
    (fold-ins 2i, 2i + 1) a step."""
    _need_keys("dpmpp_sde", keys)
    extra = extra_args or {}
    sig = _host_sigmas(sigmas)
    fac = 1.0 / (2.0 * r)
    for i, s, s_next in _steps(sig):
        denoised = model(x, s, **extra)
        if s_next > 0:
            t = -math.log(s)
            h = _t(s_next) - t
            s_mid = math.exp(-(t + h * r))
            sd1, su1 = _ancestral_sigmas(s, s_mid, eta)
            x_2 = (sd1 / s) * (x - denoised) + denoised
            x_2 = x_2 + step_noise(keys, i * 2, x) * su1
            denoised_2 = model(x_2, s_mid, **extra)
            sd2, su2 = _ancestral_sigmas(s, s_next, eta)
            denoised_d = (1 - fac) * denoised + fac * denoised_2
            x = (sd2 / s) * (x - denoised_d) + denoised_d
            x = x + step_noise(keys, i * 2 + 1, x) * su2
        else:
            x = x + _to_d(x, s, denoised) * (s_next - s)
    return x


def sample_dpmpp_3m_sde(model: Model, x: torch.Tensor, sigmas,
                        extra_args: Extra = None, keys=None,
                        eta: float = 1.0) -> torch.Tensor:
    """DPM-Solver++(3M) SDE: the two previous denoiseds and step sizes;
    the order ramps 1 -> 2 -> 3 over the first steps."""
    _need_keys("dpmpp_3m_sde", keys)
    extra = extra_args or {}
    sig = _host_sigmas(sigmas)
    den_1 = den_2 = None
    h_1 = h_2 = 1.0
    for i, s, s_next in _steps(sig):
        denoised = model(x, s, **extra)
        if s_next <= 0:
            x = denoised
            continue
        h = -math.log(s_next) + math.log(s)
        h_eta = h * (eta + 1.0)
        x_out = math.exp(-h_eta) * x - math.expm1(-h_eta) * denoised
        phi_2 = math.expm1(-h_eta) / h_eta + 1.0
        if i == 1:
            x_out = x_out + phi_2 * ((denoised - den_1) / (h_1 / h))
        elif i >= 2:
            r0, r1 = h_1 / h, h_2 / h
            d1_0 = (denoised - den_1) / r0
            d1_1 = (den_1 - den_2) / r1
            d1 = d1_0 + (d1_0 - d1_1) * r0 / (r0 + r1)
            d2 = (d1_0 - d1_1) / (r0 + r1)
            phi_3 = phi_2 / h_eta - 0.5
            x_out = x_out + phi_2 * d1 - phi_3 * d2
        if eta:
            amt = s_next * math.sqrt(max(-math.expm1(-2.0 * h * eta), 0.0))
            x_out = x_out + step_noise(keys, i, x) * amt
        x = x_out
        den_1, den_2, h_1, h_2 = denoised, den_1, h, h_1
    return x


# --- linear multistep ---------------------------------------------------------

# 4-point Gauss-Legendre on [-1, 1]: exact for the LMS coefficient
# integrands (degree <= 3)
_GL4_NODES = (-0.8611363115940526, -0.3399810435848563,
              0.3399810435848563, 0.8611363115940526)
_GL4_WEIGHTS = (0.3478548451374538, 0.6521451548625461,
                0.6521451548625461, 0.3478548451374538)


def _lms_coeff(order: int, sig_hist: List[float], s: float, s_next: float
               ) -> List[float]:
    """Integral over [s, s_next] of the Lagrange basis on ``sig_hist``
    (``sig_hist[k]`` = sigma k steps back), one per basis polynomial."""
    half, mid = (s_next - s) / 2.0, (s_next + s) / 2.0
    coeffs = []
    for j in range(order):
        total = 0.0
        for node, w in zip(_GL4_NODES, _GL4_WEIGHTS):
            tau = mid + half * node
            prod = 1.0
            for k in range(order):
                if k != j:
                    prod = prod * (tau - sig_hist[k]) \
                        / (sig_hist[j] - sig_hist[k])
            total = total + w * prod
        coeffs.append(half * total)
    return coeffs


def sample_lms(model: Model, x: torch.Tensor, sigmas, extra_args: Extra
               = None, keys=None, order: int = 4) -> torch.Tensor:
    """Linear multistep over the last ``order`` derivatives."""
    extra = extra_args or {}
    sig = _host_sigmas(sigmas)
    order = max(1, min(int(order), 4))
    d_hist: List[torch.Tensor] = []          # newest first
    for i, s, s_next in _steps(sig):
        d_hist = [_to_d(x, s, model(x, s, **extra))] + d_hist[:order - 1]
        cur = min(i, order - 1) + 1
        cs = _lms_coeff(cur, [sig[max(i - k, 0)] for k in range(cur)], s,
                        s_next)
        for j in range(cur):
            x = x + cs[j] * d_hist[j]
    return x


# Adams-Bashforth coefficients for uniform steps, order 1..4
_IPNDM_COEFFS = (
    (1.0,),
    (3.0 / 2, -1.0 / 2),
    (23.0 / 12, -16.0 / 12, 5.0 / 12),
    (55.0 / 24, -59.0 / 24, 37.0 / 24, -9.0 / 24),
)


def sample_ipndm(model: Model, x: torch.Tensor, sigmas, extra_args: Extra
                 = None, keys=None, max_order: int = 4) -> torch.Tensor:
    """iPNDM: Adams-Bashforth over the derivative history with the fixed
    table (order ramps 1 -> 4)."""
    extra = extra_args or {}
    sig = _host_sigmas(sigmas)
    max_order = max(1, min(int(max_order), 4))
    d_hist: List[torch.Tensor] = []          # d at i-1-k
    for i, s, s_next in _steps(sig):
        d = _to_d(x, s, model(x, s, **extra))
        cs = _IPNDM_COEFFS[min(i, max_order - 1)]
        upd = cs[0] * d
        for k in range(1, len(cs)):
            upd = upd + cs[k] * d_hist[k - 1]
        x = x + (s_next - s) * upd
        d_hist = [d] + d_hist[:max(max_order - 1, 1) - 1]
    return x


def _ab_vs_coeffs(nodes: List[float], t_cur: float, t_next: float
                  ) -> List[float]:
    """Variable-step Adams-Bashforth weights: the mean over [t_cur,
    t_next] of the Lagrange basis on ``nodes`` (newest first), by
    2-point Gauss-Legendre (exact for the <= cubic basis)."""
    mid, half = (t_cur + t_next) / 2.0, (t_next - t_cur) / 2.0
    qs = (mid - half / math.sqrt(3.0), mid + half / math.sqrt(3.0))

    def basis(j: int, t: float) -> float:
        out = 1.0
        for m, tm in enumerate(nodes):
            if m != j:
                out = out * (t - tm) / (nodes[j] - tm)
        return out

    return [(basis(j, qs[0]) + basis(j, qs[1])) / 2.0
            for j in range(len(nodes))]


def _make_ab_variable(max_order: int, name: str) -> Callable:
    """ipndm_v (order 4) and DEIS 'tab' (order 3): integrate the Lagrange
    interpolation of the derivative over the sigma step."""
    def sampler(model: Model, x: torch.Tensor, sigmas, extra_args: Extra
                = None, keys=None) -> torch.Tensor:
        extra = extra_args or {}
        sig = _host_sigmas(sigmas)
        d_hist: List[torch.Tensor] = []
        for i, s, s_next in _steps(sig):
            d = _to_d(x, s, model(x, s, **extra))
            order = min(i, max_order - 1) + 1
            nodes = [s] + [sig[max(i - k, 0)] for k in range(1, order)]
            cs = _ab_vs_coeffs(nodes, s, s_next)
            upd = cs[0] * d
            for k in range(1, order):
                upd = upd + cs[k] * d_hist[k - 1]
            x = x + (s_next - s) * upd
            d_hist = [d] + d_hist[:max(max_order - 1, 1) - 1]
        return x

    sampler.__name__ = f"sample_{name}"
    return sampler


sample_ipndm_v = _make_ab_variable(4, "ipndm_v")
sample_deis = _make_ab_variable(3, "deis")


def sample_heunpp2(model: Model, x: torch.Tensor, sigmas, extra_args:
                   Extra = None, keys=None) -> torch.Tensor:
    """Heun++: Euler on the final step, weighted Heun on the one before,
    a 3-evaluation combination elsewhere."""
    extra = extra_args or {}
    sig = _host_sigmas(sigmas)
    s_end, s0 = sig[-1], sig[0]
    sig_ext = sig + sig[-1:]
    for i, s, s_next in _steps(sig):
        s2 = sig_ext[i + 2]
        d = _to_d(x, s, model(x, s, **extra))
        dt = s_next - s
        x_euler = x + d * dt
        if s_next == s_end:
            x = x_euler
            continue
        d_2 = _to_d(x_euler, s_next, model(x_euler, s_next, **extra))
        if s2 == s_end:
            w2 = s_next / (2.0 * s0)
            x = x + (d * (1.0 - w2) + d_2 * w2) * dt
        else:
            x_3 = x_euler + d_2 * (s2 - s_next)
            d_3 = _to_d(x_3, s2, model(x_3, s2, **extra))
            w = 3.0 * s0
            w2, w3 = s_next / w, s2 / w
            x = x + (d * (1.0 - w2 - w3) + d_2 * w2 + d_3 * w3) * dt
    return x


# --- DPM-Solver (fast, adaptive) ----------------------------------------------

def _dpm_eps(model: Model, x: torch.Tensor, s: float, extra
             ) -> torch.Tensor:
    return _to_d(x, s, model(x, s, **extra))


def _dpm1_step(model, x, t, t_next, extra):
    """DPM-Solver-1 in t = -log sigma."""
    h = t_next - t
    eps = _dpm_eps(model, x, math.exp(-t), extra)
    return x - math.exp(-t_next) * math.expm1(h) * eps


def _dpm2_step(model, x, t, t_next, extra, r1=0.5):
    h = t_next - t
    eps = _dpm_eps(model, x, math.exp(-t), extra)
    s1 = t + r1 * h
    u1 = x - math.exp(-s1) * math.expm1(r1 * h) * eps
    eps_r1 = _dpm_eps(model, u1, math.exp(-s1), extra)
    return (x - math.exp(-t_next) * math.expm1(h) * eps
            - math.exp(-t_next) / (2.0 * r1) * math.expm1(h)
            * (eps_r1 - eps))


def _dpm3_terms(model, x, t, t_next, extra, r1=1.0 / 3, r2=2.0 / 3):
    """(second-order, third-order) solutions of one DPM-Solver-3 step:
    the embedded pair shares its three evaluations."""
    h = t_next - t
    eps = _dpm_eps(model, x, math.exp(-t), extra)
    s1, s2 = t + r1 * h, t + r2 * h
    u1 = x - math.exp(-s1) * math.expm1(r1 * h) * eps
    eps_r1 = _dpm_eps(model, u1, math.exp(-s1), extra)
    low = (x - math.exp(-t_next) * math.expm1(h) * eps
           - math.exp(-t_next) / (2.0 * r1) * math.expm1(h)
           * (eps_r1 - eps))
    u2 = (x - math.exp(-s2) * math.expm1(r2 * h) * eps
          - math.exp(-s2) * (r2 / r1)
          * (math.expm1(r2 * h) / (r2 * h) - 1.0) * (eps_r1 - eps))
    eps_r2 = _dpm_eps(model, u2, math.exp(-s2), extra)
    high = (x - math.exp(-t_next) * math.expm1(h) * eps
            - math.exp(-t_next) / r2 * (math.expm1(h) / h - 1.0)
            * (eps_r2 - eps))
    return low, high


def _dpm3_step(model, x, t, t_next, extra):
    return _dpm3_terms(model, x, t, t_next, extra)[1]


def _t_span(sig: List[float]) -> Tuple[float, float]:
    """(t_start, t_end) of a DPM-Solver run: sigma_min falls back past a
    trailing 0."""
    sig_min = sig[-1] if sig[-1] > 0 else sig[-2]
    return -math.log(sig[0]), -math.log(sig_min)


def sample_dpm_fast(model: Model, x: torch.Tensor, sigmas, extra_args:
                    Extra = None, keys=None) -> torch.Tensor:
    """DPM-Solver fast: the budget len(sigmas) - 1 splits into
    third-order steps on a uniform t grid; only the endpoints and the
    count of ``sigmas`` matter."""
    extra = extra_args or {}
    sig = _host_sigmas(sigmas)
    nfe = len(sig) - 1
    if nfe < 1:
        return x
    t_start, t_end = _t_span(sig)
    m = nfe // 3 + 1
    ts = [t_start + (t_end - t_start) * (i / m) for i in range(m + 1)]
    if nfe % 3 == 0:
        orders = [3] * (m - 2) + [2, 1]
    else:
        orders = [3] * (m - 1) + [nfe % 3]
    steps = {1: _dpm1_step, 2: _dpm2_step, 3: _dpm3_step}
    for i, order in _until_interrupted(enumerate(orders)):
        x = steps[order](model, x, ts[i], ts[i + 1], extra)
    return x


def sample_dpm_adaptive(model: Model, x: torch.Tensor, sigmas,
                        extra_args: Extra = None, keys=None,
                        order: int = 3, rtol: float = 0.05,
                        atol: float = 0.0078, h_init: float = 0.05,
                        pcoeff: float = 0.0, icoeff: float = 1.0,
                        dcoeff: float = 0.0, accept_safety: float = 0.81,
                        max_iters: int = 512) -> torch.Tensor:
    """DPM-Solver-12/23 adaptive: the embedded 2nd/3rd-order pair in t
    with a PID step-size controller.  Each attempt reads its error
    estimate back to the host to accept or reject the step; only the
    endpoints of ``sigmas`` matter."""
    extra = extra_args or {}
    sig = _host_sigmas(sigmas)
    if len(sig) < 2:
        return x
    t_start, t_end = _t_span(sig)
    # the controller's scalars in float32, as the JAX package keeps them:
    # its step sizes then follow the same roundings
    f32 = np.float32
    t_start, t_end = f32(t_start), f32(t_end)
    b1 = (pcoeff + icoeff + dcoeff) / order
    b2 = -(pcoeff + 2.0 * dcoeff) / order
    b3 = dcoeff / order
    n_sqrt = f32(float(x.numel()) ** 0.5)
    x_prev, s, h = x, t_start, f32(h_init)
    errs = [f32(1.0 / 1e-8), f32(1.0 / 1e-8)]
    it = 0
    while s < t_end - f32(1e-5) and it < max_iters \
            and not itr.is_interrupted():
        t = min(t_end, f32(s + h))
        x_low, x_high = _dpm3_terms(model, x, float(s), float(t), extra)
        delta = torch.clamp(rtol * torch.maximum(x_low.abs(), x_prev.abs()),
                            min=atol)
        error = f32(torch.sqrt(torch.sum(((x_low - x_high) / delta) ** 2))
                    .item()) / n_sqrt
        e0 = f32(1.0) / (f32(1e-8) + error)
        e1, e2 = (e0, e0) if it == 0 else errs
        factor = f32(e0 ** f32(b1) * e1 ** f32(b2) * e2 ** f32(b3))
        factor = f32(1.0) + np.arctan(factor - f32(1.0))
        if factor >= f32(accept_safety):
            x, x_prev, s = x_high, x_low, t
            errs = [e0, e1]
        else:
            errs = [e1, e2]
        h = f32(h * factor)
        it += 1
    return x


# --- exponential integrators ----------------------------------------------------

def sample_lcm(model: Model, x: torch.Tensor, sigmas, extra_args: Extra
               = None, keys=None) -> torch.Tensor:
    """Latent consistency: jump to x0, re-noise to the next sigma."""
    _need_keys("lcm", keys)
    extra = extra_args or {}
    sig = _host_sigmas(sigmas)
    for i, s, s_next in _steps(sig):
        x = model(x, s, **extra)
        if s_next > 0:
            x = x + step_noise(keys, i, x) * s_next
    return x


def sample_ddpm(model: Model, x: torch.Tensor, sigmas, extra_args: Extra
                = None, keys=None) -> torch.Tensor:
    """DDPM's posterior-mean step in the VP-scaled frame
    x / sqrt(1 + sigma^2), rescaled back between steps."""
    _need_keys("ddpm", keys)
    extra = extra_args or {}
    sig = _host_sigmas(sigmas)
    for i, s, s_next in _steps(sig):
        eps = _to_d(x, s, model(x, s, **extra))
        xs = x / math.sqrt(1.0 + s ** 2)
        ac = 1.0 / (s * s + 1.0)
        ac_prev = 1.0 / (max(s_next, 0.0) ** 2 + 1.0)
        alpha = ac / ac_prev
        mu = math.sqrt(1.0 / alpha) * (
            xs - (1.0 - alpha) * eps / math.sqrt(1.0 - ac))
        if s_next > 0:
            std = math.sqrt(max((1.0 - alpha) * (1.0 - ac_prev)
                                / (1.0 - ac), 0.0))
            mu = mu + step_noise(keys, i, x) * std
            x = mu * math.sqrt(1.0 + s_next ** 2)
        else:
            x = mu
    return x


def _res_multistep(model: Model, x: torch.Tensor, sigmas, extra_args:
                   Extra, keys, eta: float, cfg_pp: bool) -> torch.Tensor:
    """RES second-order exponential multistep, deterministic (eta = 0)
    or ancestral, optionally anchored on the uncond denoised (CFG++)."""
    extra = extra_args or {}
    sig = _host_sigmas(sigmas)
    old = None
    for i, s, s_next in _steps(sig):
        denoised = model(x, s, **extra)
        anchor = _last_uncond(model, denoised) if cfg_pp else denoised
        if s_next <= 0:
            x = denoised
            old = denoised
            continue
        sd, su = _ancestral_sigmas(s, s_next, eta) if eta > 0 \
            else (s_next, 0.0)
        t = -math.log(s)
        h = _t(sd) - t
        if cfg_pp:
            x_new = denoised + math.exp(-h) * (x - anchor)
        else:
            x_new = math.exp(-h) * x - math.expm1(-h) * denoised
        if i > 0:
            c2 = (-math.log(sig[i - 1]) - t) / h
            b2 = _phi2(-h) / c2
            x_new = x_new + h * b2 * (old - denoised)
        if eta > 0 and su > 0:
            x_new = x_new + step_noise(keys, i, x) * su
        x = x_new
        old = denoised
    return x


def sample_res_multistep(model, x, sigmas, extra_args=None, keys=None):
    return _res_multistep(model, x, sigmas, extra_args, keys, 0.0, False)


def sample_res_multistep_cfg_pp(model, x, sigmas, extra_args=None,
                                keys=None):
    return _res_multistep(model, x, sigmas, extra_args, keys, 0.0, True)


def sample_res_multistep_ancestral(model, x, sigmas, extra_args=None,
                                   keys=None, eta: float = 1.0):
    _need_keys("res_multistep_ancestral", keys)
    return _res_multistep(model, x, sigmas, extra_args, keys, eta, False)


def sample_res_multistep_ancestral_cfg_pp(model, x, sigmas,
                                          extra_args=None, keys=None,
                                          eta: float = 1.0):
    _need_keys("res_multistep_ancestral_cfg_pp", keys)
    return _res_multistep(model, x, sigmas, extra_args, keys, eta, True)


def sample_gradient_estimation(model: Model, x: torch.Tensor, sigmas,
                               extra_args: Extra = None, keys=None,
                               ge_gamma: float = 2.0) -> torch.Tensor:
    """Euler whose direction extrapolates the previous step's:
    gamma * d + (1 - gamma) * d_old."""
    extra = extra_args or {}
    sig = _host_sigmas(sigmas)
    old_d = None
    for i, s, s_next in _steps(sig):
        d = _to_d(x, s, model(x, s, **extra))
        d_bar = ge_gamma * d + (1.0 - ge_gamma) * old_d if i > 0 else d
        x = x + d_bar * (s_next - s)
        old_d = d
    return x


def sample_er_sde(model: Model, x: torch.Tensor, sigmas, extra_args:
                  Extra = None, keys=None, s_noise: float = 1.0,
                  max_stage: int = 3) -> torch.Tensor:
    """ER-SDE-Solver-3 (VE): the stage ramps 1 -> 3; the noise-scale
    integrals are 200-point Riemann sums."""
    _need_keys("er_sde", keys)
    extra = extra_args or {}
    sig = _host_sigmas(sigmas)
    n_int = 200

    def scaler(sigma):
        return sigma * (np.exp(sigma ** 0.3) + 10.0)

    old_den = old_den_d = None
    for i, s, s_next in _steps(sig):
        denoised = model(x, s, **extra)
        den_d = denoised if i == 0 else \
            (denoised - old_den) / (s - sig[i - 1])
        if s_next > 0:
            r = float(scaler(s_next) / scaler(s))
            x_new = r * x + (1.0 - r) * denoised
            stage = min(i + 1, max_stage)
            dt = s_next - s
            pos = s_next + np.arange(n_int) * (-dt / n_int)
            scale_next = float(scaler(s_next))
            if stage >= 2:
                int1 = float(np.sum(1.0 / scaler(np.maximum(pos, 1e-20)))
                             * (-dt / n_int))
                x_new = x_new + (dt + int1 * scale_next) * den_d
            if stage >= 3:
                den_u = (den_d - old_den_d) / ((s - sig[i - 2]) / 2.0)
                int2 = float(np.sum((pos - s) / scaler(np.maximum(pos,
                                                                  1e-20)))
                             * (-dt / n_int))
                x_new = x_new + ((dt ** 2) / 2.0 + int2 * scale_next) * den_u
            amt = math.sqrt(max(s_next ** 2 - (s * r) ** 2, 0.0))
            x = x_new + step_noise(keys, i, x) * s_noise * amt
        else:
            x = denoised
        old_den, old_den_d = denoised, den_d
    return x


def sample_sa_solver(model: Model, x: torch.Tensor, sigmas, extra_args:
                     Extra = None, keys=None) -> torch.Tensor:
    """SA-Solver, deterministic (tau = 0) order-2 predictor-corrector:
    two model calls a step."""
    extra = extra_args or {}
    sig = _host_sigmas(sigmas)
    old = None
    for i, s, s_next in _steps(sig):
        denoised = model(x, s, **extra)
        if s_next > 0:
            t = -math.log(s)
            h = -math.log(s_next) - t
            phi1, phi2 = _phi1(-h), _phi2(-h)
            if i > 0:
                b2 = phi2 / ((-math.log(sig[i - 1]) - t) / h)
                b1 = phi1 - b2
                x_pred = math.exp(-h) * x + h * (b1 * denoised + b2 * old)
            else:
                x_pred = math.exp(-h) * x + h * phi1 * denoised
            denoised_p = model(x_pred, s_next, **extra)
            x = math.exp(-h) * x + h * ((phi1 - phi2) * denoised
                                        + phi2 * denoised_p)
        else:
            x = denoised
        old = denoised
    return x


def sample_seeds_2(model: Model, x: torch.Tensor, sigmas, extra_args:
                   Extra = None, keys=None, eta: float = 1.0,
                   s_noise: float = 1.0, r: float = 0.5) -> torch.Tensor:
    """SEEDS-2: two-stage exponential solver in h * (1 + eta), noise
    coupled across the midpoint and the full step (fold-ins 2i,
    2i + 1)."""
    inject = eta > 0 and s_noise > 0
    if inject:
        _need_keys("seeds_2", keys)
    extra = extra_args or {}
    sig = _host_sigmas(sigmas)
    fac = 1.0 / (2.0 * r)
    for i, s, s_next in _steps(sig):
        denoised = model(x, s, **extra)
        if s_next <= 0:
            x = denoised
            continue
        t = -math.log(s)
        h = -math.log(s_next) - t
        h_eta = h * (eta + 1.0)
        sigma_mid = math.exp(-(t + r * h))
        coeff_1, coeff_2 = math.expm1(-r * h_eta), math.expm1(-h_eta)
        x_2 = (coeff_1 + 1.0) * x - coeff_1 * denoised
        if inject:
            nc1 = math.sqrt(-math.expm1(-2.0 * r * h * eta))
            n1 = step_noise(keys, i * 2, x)
            x_2 = x_2 + sigma_mid * nc1 * n1 * s_noise
        denoised_2 = model(x_2, sigma_mid, **extra)
        denoised_d = (1.0 - fac) * denoised + fac * denoised_2
        x_out = (coeff_2 + 1.0) * x - coeff_2 * denoised_d
        if inject:
            nc2 = math.sqrt(max(math.expm1(-2.0 * r * h * eta)
                                - math.expm1(-2.0 * h * eta), 0.0))
            n2 = step_noise(keys, i * 2 + 1, x)
            x_out = x_out + s_next * (nc2 * n1 + nc1 * n2) * s_noise
        x = x_out
    return x


def sample_seeds_3(model: Model, x: torch.Tensor, sigmas, extra_args:
                   Extra = None, keys=None, eta: float = 1.0,
                   s_noise: float = 1.0, r_1: float = 1.0 / 3,
                   r_2: float = 2.0 / 3) -> torch.Tensor:
    """SEEDS-3: three stages at fractions r_1, r_2 of the step, noise
    coupled down the chain (fold-ins 3i to 3i + 2)."""
    inject = eta > 0 and s_noise > 0
    if inject:
        _need_keys("seeds_3", keys)
    extra = extra_args or {}
    sig = _host_sigmas(sigmas)
    for i, s, s_next in _steps(sig):
        denoised = model(x, s, **extra)
        if s_next <= 0:
            x = denoised
            continue
        t = -math.log(s)
        h = -math.log(s_next) - t
        h_eta = h * (eta + 1.0)
        sigma_1, sigma_2 = math.exp(-(t + r_1 * h)), math.exp(-(t + r_2 * h))
        coeff_1 = math.expm1(-r_1 * h_eta)
        coeff_2 = math.expm1(-r_2 * h_eta)
        coeff_3 = math.expm1(-h_eta)
        if inject:
            nc1 = math.sqrt(-math.expm1(-2.0 * r_1 * h * eta))
            nc2 = math.sqrt(max(math.expm1(-2.0 * r_1 * h * eta)
                                - math.expm1(-2.0 * r_2 * h * eta), 0.0))
            nc3 = math.sqrt(max(math.expm1(-2.0 * r_2 * h * eta)
                                - math.expm1(-2.0 * h * eta), 0.0))
            n1, n2, n3 = (step_noise(keys, i * 3 + j, x) for j in range(3))
        x_2 = (coeff_1 + 1.0) * x - coeff_1 * denoised
        if inject:
            x_2 = x_2 + sigma_1 * nc1 * n1 * s_noise
        denoised_2 = model(x_2, sigma_1, **extra)
        x_3 = (coeff_2 + 1.0) * x - coeff_2 * denoised \
            + (r_2 / r_1) * (coeff_2 / (r_2 * h_eta) + 1.0) \
            * (denoised_2 - denoised)
        if inject:
            x_3 = x_3 + sigma_2 * (nc2 * n1 + nc1 * n2) * s_noise
        denoised_3 = model(x_3, sigma_2, **extra)
        x = (coeff_3 + 1.0) * x - coeff_3 * denoised \
            + (1.0 / r_2) * (coeff_3 / h_eta + 1.0) \
            * (denoised_3 - denoised)
        if inject:
            x = x + s_next * (nc3 * n1 + nc2 * n2 + nc1 * n3) * s_noise
    return x


# --- UniPC --------------------------------------------------------------------

def _unipc_rb(order: int, h: float, lam0: float, lam_hist, variant: str):
    """UniPC's r_k ratios and b vector (x0 prediction, hh = -h); returns
    (rks, b, B_h, h_phi_1)."""
    hh = -h
    h_phi_1 = math.expm1(hh)
    B_h = hh if variant == "bh1" else math.expm1(hh)
    rks = [(lam_hist[k] - lam0) / h for k in range(1, order)] + [1.0]
    b = []
    h_phi_k = h_phi_1 / hh - 1.0
    factorial_i = 1.0
    for i in range(1, order + 1):
        b.append(h_phi_k * factorial_i / B_h)
        factorial_i *= i + 1
        h_phi_k = h_phi_k / hh - 1.0 / factorial_i
    return rks, b, B_h, h_phi_1


def _make_unipc(variant: str) -> Callable:
    def sample(model: Model, x: torch.Tensor, sigmas, extra_args: Extra
               = None, keys=None) -> torch.Tensor:
        """UniPC, order 3, x0 prediction: each step predicts, evaluates
        the model at the prediction and corrects with it; that
        evaluation is the next step's, so one model call a step plus one
        before the loop.  The order ramps 1 -> 3 at the start and back
        down at the end; the last step skips the corrector."""
        extra = extra_args or {}
        sig = _host_sigmas(sigmas)
        n = len(sig) - 1
        if n < 1:
            return x

        def lam_at(i: int) -> float:
            return _t(sig[max(i, 0)])

        # the priming call obeys the flag as the steps do
        if itr.is_interrupted():
            return x
        m0 = model(x, sig[0], **extra)
        m1 = m2 = None
        for i, s, s_next in _steps(sig):
            if s_next <= 0:
                x = m0
                m0, m1, m2 = m0, m0, m1
                continue
            lam0 = -math.log(s)
            h = -math.log(s_next) - lam0
            order = min(i + 1, 3, n - i)
            rks, b, B_h, h_phi_1 = _unipc_rb(
                order, h, lam0, [None, lam_at(i - 1), lam_at(i - 2)],
                variant)
            m_hist = [m0, m1, m2]
            d1s = [(m_hist[k] - m0) / rks[k - 1] for k in range(1, order)]
            x_t_ = (s_next / s) * x - h_phi_1 * m0
            if order == 1:
                x_pred = x_t_
            elif order == 2:
                x_pred = x_t_ - B_h * (0.5 * d1s[0])
            else:
                rhos_p = np.linalg.solve(
                    np.asarray([[1.0, 1.0], [rks[0], rks[1]]]),
                    np.asarray(b[:2])).tolist()
                x_pred = x_t_ - B_h * (rhos_p[0] * d1s[0]
                                       + rhos_p[1] * d1s[1])
            if i == n - 1:
                # the last step of a window that ends above sigma 0
                m0, m1, m2 = m0, m0, m1
                x = x_pred
                continue
            m_t = model(x_pred, s_next, **extra)
            if order == 1:
                corr = 0.5 * (m_t - m0)
            else:
                rhos_c = np.linalg.solve(
                    np.asarray([[rk ** p for rk in rks]
                                for p in range(order)]),
                    np.asarray(b)).tolist()
                corr_base = rhos_c[0] * d1s[0]
                for k in range(1, order - 1):
                    corr_base = corr_base + rhos_c[k] * d1s[k]
                corr = corr_base + rhos_c[-1] * (m_t - m0)
            x = x_t_ - B_h * corr
            m0, m1, m2 = m_t, m0, m1
        return x

    sample.__name__ = f"sample_uni_pc_{variant}"
    return sample


sample_uni_pc = _make_unipc("bh1")
sample_uni_pc_bh2 = _make_unipc("bh2")


SAMPLERS: Dict[str, Callable] = {
    "euler": sample_euler,
    "ddim": sample_ddim,
    "euler_cfg_pp": sample_euler_cfg_pp,
    "euler_ancestral": sample_euler_ancestral,
    "euler_ancestral_cfg_pp": sample_euler_ancestral_cfg_pp,
    "heun": sample_heun,
    "dpm_2": sample_dpm_2,
    "dpm_2_ancestral": sample_dpm_2_ancestral,
    "dpmpp_2s_ancestral": sample_dpmpp_2s_ancestral,
    "dpmpp_sde": sample_dpmpp_sde,
    "dpmpp_2m": sample_dpmpp_2m,
    "dpmpp_2m_sde": sample_dpmpp_2m_sde,
    "dpmpp_3m_sde": sample_dpmpp_3m_sde,
    "lms": sample_lms,
    "ddpm": sample_ddpm,
    "ipndm": sample_ipndm,
    "ipndm_v": sample_ipndm_v,
    "deis": sample_deis,
    "heunpp2": sample_heunpp2,
    "dpm_fast": sample_dpm_fast,
    "dpm_adaptive": sample_dpm_adaptive,
    "lcm": sample_lcm,
    "uni_pc": sample_uni_pc,
    "uni_pc_bh2": sample_uni_pc_bh2,
    "res_multistep": sample_res_multistep,
    "res_multistep_cfg_pp": sample_res_multistep_cfg_pp,
    "res_multistep_ancestral": sample_res_multistep_ancestral,
    "res_multistep_ancestral_cfg_pp": sample_res_multistep_ancestral_cfg_pp,
    "dpmpp_2m_cfg_pp": sample_dpmpp_2m_cfg_pp,
    "gradient_estimation": sample_gradient_estimation,
    "er_sde": sample_er_sde,
    "sa_solver": sample_sa_solver,
    "seeds_2": sample_seeds_2,
    "seeds_3": sample_seeds_3,
}


def get_sampler(name: str) -> Callable:
    if name not in SAMPLERS:
        raise ValueError(f"unknown sampler {name!r}; available: "
                         f"{tuple(SAMPLERS)}")
    return SAMPLERS[name]


def _norm_entries(entries):
    """(context, mask, strength[, sigma_range]) entries -> 4-tuples."""
    return [tuple(e) if len(e) == 4 else (*e, None) for e in entries]


def _entry_active(sigma, srange, like: torch.Tensor):
    """1.0 while the step's sigma lies in the entry's [s_end, s_start]
    (ComfyUI's timestep-range gate), else 0.0, compared in float32: a
    host sigma gives a host factor, a tensor sigma a device one."""
    s_start, s_end = np.float32(srange[0]), np.float32(srange[1])
    if isinstance(sigma, torch.Tensor):
        sig = sigma.to(torch.float32).max()
        return ((sig <= float(s_start)) & (sig >= float(s_end))).to(
            like.dtype)
    sig = np.float32(np.max(np.asarray(sigma, np.float32)))
    return float(s_end <= sig <= s_start)


def _mask_blend(entries, parts, sigma) -> torch.Tensor:
    """``sum_i(w_i * den_i) / max(sum_i(w_i), 1e-9)`` with ``w_i =
    strength_i * mask_i * active_i(sigma)``: the blend of one CFG
    side's per-entry denoised predictions.  A pixel no entry covers
    blends to about zero, as in ComfyUI."""
    acc = wsum = None
    for (_, m, s, srange), p in zip(entries, parts):
        if m is None:
            w = torch.full((1, 1, 1, 1), float(s), dtype=p.dtype,
                           device=p.device)
        else:
            w = m.to(p.device, p.dtype) * float(s)
        if srange is not None:
            w = w * _entry_active(sigma, srange, p)
        term = p * w
        wb = w.expand(p.shape[:-1] + (1,))
        acc = term if acc is None else acc + term
        wsum = wb if wsum is None else wsum + wb
    return acc / torch.clamp(wsum, min=1e-9)


def cfg_denoiser_multi(model: Model, conds, uncond, cfg_scale: float,
                       cfg_rescale: float = 0.0) -> Model:
    """Classifier-free guidance over ComfyUI's multi-entry conditioning
    lists (the JAX package's ``cfg_denoiser_multi``).  ``conds`` and
    ``uncond``: lists of ``(context [B, T, C], mask [1 or B, h, w, 1] or
    None, strength[, sigma_range])`` entries, or one bare context.

    Every entry of both sides runs in ONE model call on the stacked
    [cond_1..cond_n; uncond_1..uncond_m] rows (only the cond rows at
    cfg == 1); each side's predictions blend by :func:`_mask_blend`,
    then ``uncond + (cond - uncond) * cfg``.  A ``y`` in the call's
    arguments must already be stacked to those rows
    (``registry.stack_y``).  Each call leaves its blended uncond
    (the blended cond at cfg == 1) in ``last_uncond`` for the CFG++
    samplers.  One plain entry a side blends to its own prediction to
    the bit (weight 1, sum 1).  ``cfg_rescale`` (RescaleCFG's
    multiplier) re-stds the combine with :func:`_rescale_cfg`."""
    conds = _norm_entries(conds) if isinstance(conds, (list, tuple)) \
        else [(conds, None, 1.0, None)]
    unconds = _norm_entries(uncond) if isinstance(uncond, (list, tuple)) \
        else [(uncond, None, 1.0, None)]
    n, nu = len(conds), len(unconds)

    def wrapped(x: torch.Tensor, sigma,
                y: Optional[torch.Tensor] = None) -> torch.Tensor:
        use_uncond = cfg_scale != 1.0
        reps = n + (nu if use_uncond else 0)
        if reps == 1 and conds[0][1] is None and conds[0][3] is None:
            den = model(x, sigma, context=conds[0][0], y=y)
            wrapped.last_uncond = den
            return den
        ctx = [c for c, _, _, _ in conds] \
            + ([c for c, _, _, _ in unconds] if use_uncond else [])
        out = model(torch.cat([x] * reps), _rows_sigma(sigma, reps),
                    context=torch.cat(ctx), y=y)
        parts = out.chunk(reps)
        den_cond = _mask_blend(conds, parts[:n], sigma)
        if not use_uncond:
            wrapped.last_uncond = den_cond
            return den_cond
        den_uncond = _mask_blend(unconds, parts[n:], sigma)
        wrapped.last_uncond = den_uncond
        if cfg_rescale:
            return _rescale_cfg(x, sigma, den_cond, den_uncond, cfg_scale,
                                cfg_rescale)
        return den_uncond + (den_cond - den_uncond) * cfg_scale
    return wrapped


def _rows_sigma(sigma, reps: int):
    """A [B] sigma (one a row) repeated with ``reps`` stacked row blocks;
    a host float or a scalar as it is."""
    if isinstance(sigma, torch.Tensor) and sigma.ndim:
        return sigma.repeat(reps)
    return sigma


def _sigma_like(sigma, x: torch.Tensor) -> torch.Tensor:
    """The step's sigma as a float32 tensor shaped against ``x``: a
    scalar filled on x's device (no copy that waits for the card), or a
    [B] tensor as [B, 1, 1, 1]."""
    if isinstance(sigma, torch.Tensor):
        s = sigma.to(device=x.device, dtype=x.dtype)
        return s.reshape((-1,) + (1,) * (x.ndim - 1)) if s.ndim else s
    return torch.full((), float(sigma), dtype=x.dtype, device=x.device)


def cfg_denoiser_dual(model: Model, cond: torch.Tensor,
                      middle: torch.Tensor, uncond: torch.Tensor,
                      cfg1: float, cfg2: float,
                      cfg_rescale: float = 0.0) -> Model:
    """Dual-CFG guidance (ComfyUI's DualCFGGuider, the InstructPix2Pix
    combine): one model call on the stacked [cond; middle; uncond] rows,

        out = (uncond + cfg2 * (middle - uncond)) + cfg1 * (cond - middle)

    a RescaleCFG patch applying to the middle/uncond combine.  ``y``
    must already be stacked to the three blocks."""
    def wrapped(x: torch.Tensor, sigma,
                y: Optional[torch.Tensor] = None) -> torch.Tensor:
        out = model(torch.cat([x, x, x]), _rows_sigma(sigma, 3),
                    context=torch.cat([cond, middle, uncond]), y=y)
        pos, mid, neg = out.chunk(3)
        wrapped.last_uncond = neg
        if cfg_rescale:
            base = _rescale_cfg(x, sigma, mid, neg, cfg2, cfg_rescale)
        else:
            base = neg + (mid - neg) * cfg2
        return base + (pos - mid) * cfg1
    return wrapped


def cfg_denoiser_perp_neg(model: Model, cond: torch.Tensor,
                          empty: torch.Tensor, uncond: torch.Tensor,
                          cfg_scale: float, neg_scale: float,
                          cfg_rescale: float = 0.0) -> Model:
    """Perp-Neg guidance (Armandpour et al.; ComfyUI's PerpNeg and
    PerpNegGuider): one call on the stacked [cond; empty; uncond] rows,
    then with pos = cond - empty and neg = uncond - empty

        perp = neg - (<neg, pos> / max(|pos|^2, 1e-12)) pos
        out  = empty + cfg * (pos - neg_scale * perp)

    the products reduced per sample (over axes 1..n), never over the
    batch.  A RescaleCFG patch re-stds the combine toward the cond
    prediction."""
    def wrapped(x: torch.Tensor, sigma,
                y: Optional[torch.Tensor] = None) -> torch.Tensor:
        out = model(torch.cat([x, x, x]), _rows_sigma(sigma, 3),
                    context=torch.cat([cond, empty, uncond]), y=y)
        den_cond, den_empty, den_unc = out.chunk(3)
        wrapped.last_uncond = den_unc
        pos = den_cond - den_empty
        neg = den_unc - den_empty
        axes = tuple(range(1, x.ndim))
        dot = torch.sum(neg * pos, dim=axes, keepdim=True)
        sq = torch.clamp(torch.sum(pos * pos, dim=axes, keepdim=True),
                         min=1e-12)
        direction = pos - neg_scale * (neg - (dot / sq) * pos)
        if cfg_rescale:
            return _rescale_cfg(x, sigma, den_empty + direction, den_empty,
                                cfg_scale, cfg_rescale)
        return den_empty + cfg_scale * direction
    return wrapped


def _gaussian_blur_nhwc(x: torch.Tensor, ksize: int = 9,
                        sigma: float = 2.0) -> torch.Tensor:
    """Separable gaussian blur of [B, H, W, C] with reflect padding (the
    SAG reference's gaussian_blur_2d), the taps summed in order."""
    r = ksize // 2
    xs = torch.arange(-r, r + 1, dtype=torch.float32, device=x.device)
    k = torch.exp(-(xs ** 2) / max(2.0 * sigma * sigma, 1e-8))
    k = (k / k.sum()).to(x.dtype)
    n_h, n_w = int(x.shape[1]), int(x.shape[2])
    h = torch.nn.functional.pad(x.permute(0, 3, 1, 2), (0, 0, r, r),
                                mode="reflect").permute(0, 2, 3, 1)
    acc = 0
    for i in range(ksize):
        acc = acc + k[i] * h[:, i:i + n_h]
    h = torch.nn.functional.pad(acc.permute(0, 3, 1, 2), (r, r, 0, 0),
                                mode="reflect").permute(0, 2, 3, 1)
    out = 0
    for i in range(ksize):
        out = out + k[i] * h[:, :, i:i + n_w]
    return out


def _nearest_rows(n_in: int, n_out: int, device) -> torch.Tensor:
    """``jax.image.resize(..., "nearest")``'s source index of each output
    position on one axis: floor((i + 0.5) * n_in / n_out)."""
    pos = (torch.arange(n_out, dtype=torch.float32, device=device) + 0.5) \
        * (n_in / n_out)
    return torch.clamp(torch.floor(pos).long(), 0, n_in - 1)


def sag_mask(probs: torch.Tensor, b: int, mid_hw: tuple,
             out_hw: tuple) -> torch.Tensor:
    """SAG's degradation mask [B, H, W, 1] from the captured middle-block
    weights [2B, heads, N, N] (uncond rows second): the key tokens whose
    attention mass (mean over heads, summed over queries) exceeds 1, on
    the middle block's grid, resized nearest to the latent's."""
    a = probs[b:].mean(dim=1).sum(dim=1)
    mask = (a > 1.0).to(probs.dtype).reshape(b, mid_hw[0], mid_hw[1], 1)
    rows = _nearest_rows(mid_hw[0], out_hw[0], mask.device)
    cols = _nearest_rows(mid_hw[1], out_hw[1], mask.device)
    return mask[:, rows][:, :, cols]


def cfg_denoiser_sag(model_capture: Callable, model_plain: Model,
                     cond: torch.Tensor, uncond: torch.Tensor,
                     cfg_scale: float, sag_scale: float, blur_sigma: float,
                     mid_hw: tuple, cfg_rescale: float = 0.0) -> Model:
    """Self-attention guidance (Hong et al.; the reference ecosystem's
    SelfAttentionGuidance): the stacked [cond; uncond] call also returns
    the middle block's first self-attention weights
    (``model_capture``); where the uncond rows attend strongly
    (:func:`sag_mask`) the uncond prediction is gaussian-blurred, the
    degraded estimate re-noised to the step's level and denoised once
    more under the uncond context (``model_plain``, its ``y`` the
    uncond block's rows), and

        out = cfg(cond, uncond) + sag_scale * (degraded - den_degraded)

    Three UNet rows a step: two in the capture call, one after."""
    def wrapped(x: torch.Tensor, sigma,
                y: Optional[torch.Tensor] = None) -> torch.Tensor:
        b = x.shape[0]
        out, probs = model_capture(torch.cat([x, x]), _rows_sigma(sigma, 2),
                                   context=torch.cat([cond, uncond]), y=y)
        den_cond, den_unc = out.chunk(2)
        wrapped.last_uncond = den_unc
        mask = sag_mask(probs, b, mid_hw, (x.shape[1], x.shape[2])) \
            .to(x.dtype)
        blurred = _gaussian_blur_nhwc(den_unc, 9, float(blur_sigma))
        degraded = blurred * mask + den_unc * (1.0 - mask)
        den_sag = model_plain(degraded + x - den_unc, sigma, context=uncond,
                              y=None if y is None else y[b:2 * b])
        if cfg_rescale:
            cfg_out = _rescale_cfg(x, sigma, den_cond, den_unc, cfg_scale,
                                   cfg_rescale)
        else:
            cfg_out = den_unc + (den_cond - den_unc) * cfg_scale
        return cfg_out + (degraded - den_sag) * sag_scale
    return wrapped


def _rescale_cfg(x: torch.Tensor, sigma, den_cond: torch.Tensor,
                 den_uncond: torch.Tensor, cfg_scale: float,
                 multiplier: float) -> torch.Tensor:
    """RescaleCFG (Lin et al.): the CFG combine in v-space re-stded toward
    the cond prediction's per-sample std, blended by ``multiplier``;
    x0 predictions in, x0 out.  The std is the population one
    (``correction=0``), as ``jnp.std``."""
    s = _sigma_like(sigma, x)
    s2 = s * s
    xs = x / (s2 + 1.0)
    root = torch.sqrt(s2 + 1.0)
    v_cond = (xs - (x - den_cond)) * root / s
    v_unc = (xs - (x - den_uncond)) * root / s
    v_cfg = v_unc + (v_cond - v_unc) * cfg_scale
    axes = tuple(range(1, x.ndim))
    ro_pos = torch.std(v_cond, dim=axes, keepdim=True, correction=0)
    ro_cfg = torch.std(v_cfg, dim=axes, keepdim=True, correction=0)
    v_res = v_cfg * (ro_pos / torch.clamp(ro_cfg, min=1e-9))
    v_fin = multiplier * v_res + (1.0 - multiplier) * v_cfg
    return x - (xs - v_fin * s / root)
