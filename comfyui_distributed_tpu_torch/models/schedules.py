"""Noise schedules and sigma tables (numpy): the port's own copy of
``comfyui_distributed_tpu/models/schedules.py``'s discrete VP table and
its nine step schedulers (KSampler's ``scheduler`` widget), the
custom-sampler schedules (Karras with explicit bounds, polyexponential,
VP, Laplace, Align-Your-Steps, SD-Turbo) and ModelSamplingDiscrete's
zero-terminal-SNR rescale.

Sigmas are returned descending with a trailing 0.0, shape ``[steps +
1]`` (the k-diffusion convention).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, Optional

import numpy as np
import scipy.stats


@dataclasses.dataclass(frozen=True)
class DiscreteSchedule:
    """Discrete VP schedule: sigma_t = sqrt((1 - abar_t) / abar_t)."""

    sigmas: np.ndarray          # ascending, [T]
    alphas_cumprod: np.ndarray  # [T]

    @property
    def sigma_min(self) -> float:
        return float(self.sigmas[0])

    @property
    def sigma_max(self) -> float:
        return float(self.sigmas[-1])

    def t_from_sigma(self, sigma) -> np.ndarray:
        """Continuous timestep index of a sigma, log-linear interpolation."""
        log_sigmas = np.log(self.sigmas)
        log_s = np.log(np.maximum(np.asarray(sigma, dtype=np.float64), 1e-10))
        return np.interp(log_s, log_sigmas, np.arange(len(self.sigmas)))

    def sigma_from_t(self, t) -> np.ndarray:
        return np.interp(np.asarray(t, dtype=np.float64),
                         np.arange(len(self.sigmas)), self.sigmas)

    def percent_to_sigma(self, percent: float) -> float:
        """ComfyUI's sampling percent -> sigma: 0.0 is the start of
        sampling (above sigma_max), 1.0 the end (sigma 0), between them
        log-sigma interpolation over the table
        (ConditioningSetTimestepRange's gate)."""
        if percent <= 0.0:
            return float(self.sigmas[-1]) * 1e3
        if percent >= 1.0:
            return 0.0
        t = (1.0 - percent) * (len(self.sigmas) - 1)
        return float(np.exp(np.interp(t, np.arange(len(self.sigmas)),
                                      np.log(self.sigmas))))


def make_discrete_schedule(beta_start: float = 0.00085,
                           beta_end: float = 0.012,
                           num_timesteps: int = 1000) -> DiscreteSchedule:
    """SD1.x/SDXL scaled-linear betas over ``num_timesteps`` steps."""
    betas = np.linspace(beta_start ** 0.5, beta_end ** 0.5, num_timesteps,
                        dtype=np.float64) ** 2
    abar = np.cumprod(1.0 - betas)
    sigmas = np.sqrt((1 - abar) / abar)
    return DiscreteSchedule(sigmas=sigmas.astype(np.float32),
                            alphas_cumprod=abar.astype(np.float32))


def _append_zero(sigmas: np.ndarray) -> np.ndarray:
    return np.concatenate([sigmas, [0.0]]).astype(np.float32)


def rescale_zero_terminal_snr(ds: DiscreteSchedule) -> DiscreteSchedule:
    """Zero-terminal-SNR rescale (Lin et al., "Common Diffusion Noise
    Schedules and Sample Steps are Flawed"), ModelSamplingDiscrete's
    ``zsnr``: sqrt(abar) shifted and scaled so the last step carries no
    signal, the terminal abar clamped at 4.8973451890853435e-08 (sigma
    about 4519, the constant the reference ecosystem pins)."""
    abar_sqrt = np.sqrt(ds.alphas_cumprod)
    a0, aT = abar_sqrt[0], abar_sqrt[-1]
    abar_sqrt = (abar_sqrt - aT) * (a0 / (a0 - aT))
    abar = np.clip(abar_sqrt ** 2, 4.8973451890853435e-08, 1.0)
    sigmas = np.sqrt((1.0 - abar) / abar)
    return DiscreteSchedule(sigmas=sigmas.astype(np.float32),
                            alphas_cumprod=abar.astype(np.float32))


def normal_scheduler(ds: DiscreteSchedule, steps: int,
                     sgm: bool = False) -> np.ndarray:
    """Uniform in timestep space over the model's sigma table; ``sgm``
    drops the endpoint (``sgm_uniform``)."""
    start = ds.t_from_sigma(ds.sigma_max)
    end = ds.t_from_sigma(ds.sigma_min)
    if sgm:
        ts = np.linspace(start, end, steps + 1)[:-1]
    else:
        ts = np.linspace(start, end, steps)
    return _append_zero(ds.sigma_from_t(ts))


def karras_scheduler(ds: Optional[DiscreteSchedule], steps: int,
                     rho: float = 7.0, sigma_min: Optional[float] = None,
                     sigma_max: Optional[float] = None) -> np.ndarray:
    """Karras et al. 2022 rho-schedule between the table's bounds, or
    between explicit ones (the KarrasScheduler op, ``ds`` None)."""
    lo = float(sigma_min if sigma_min is not None else ds.sigma_min)
    hi = float(sigma_max if sigma_max is not None else ds.sigma_max)
    ramp = np.linspace(0, 1, steps)
    min_r, max_r = lo ** (1 / rho), hi ** (1 / rho)
    return _append_zero((max_r + ramp * (min_r - max_r)) ** rho)


def polyexponential_sigmas(steps: int, sigma_max: float, sigma_min: float,
                           rho: float = 1.0) -> np.ndarray:
    """k-diffusion's get_sigmas_polyexponential: a polynomial ramp in
    log sigma (PolyexponentialScheduler; ExponentialScheduler at rho
    1)."""
    ramp = np.linspace(1.0, 0.0, steps) ** rho
    sig = np.exp(ramp * (math.log(sigma_max) - math.log(sigma_min))
                 + math.log(sigma_min))
    return np.concatenate([sig, [0.0]]).astype(np.float32)


def vp_sigmas(steps: int, beta_d: float = 19.9, beta_min: float = 0.1,
              eps_s: float = 1e-3) -> np.ndarray:
    """k-diffusion's get_sigmas_vp: the continuous VP-SDE schedule
    (VPScheduler)."""
    t = np.linspace(1.0, eps_s, steps)
    sig = np.sqrt(np.exp(beta_d * t ** 2 / 2 + beta_min * t) - 1.0)
    return np.concatenate([sig, [0.0]]).astype(np.float32)


def laplace_sigmas(steps: int, sigma_max: float, sigma_min: float,
                   mu: float = 0.0, beta: float = 0.5) -> np.ndarray:
    """k-diffusion's get_sigmas_laplace (LaplaceScheduler): inverse
    Laplace CDF spacing in log sigma, clipped to the bounds."""
    epsilon = 1e-5
    x = np.linspace(0.0, 1.0, steps)
    lmb = mu - beta * np.sign(0.5 - x) * np.log(1 - 2 * np.abs(0.5 - x)
                                                + epsilon)
    sig = np.clip(np.exp(lmb), sigma_min, sigma_max)
    return np.concatenate([sig, [0.0]]).astype(np.float32)


# NVIDIA Align-Your-Steps' published 10-step noise levels; other step
# counts interpolate them log-linearly
AYS_TABLES = {
    "SD1": [14.615, 6.475, 3.861, 2.697, 1.886, 1.396, 0.963, 0.652,
            0.399, 0.152, 0.029],
    "SDXL": [14.615, 6.315, 3.771, 2.181, 1.342, 0.862, 0.555, 0.380,
             0.234, 0.113, 0.029],
    "SVD": [700.00, 54.5, 15.886, 7.977, 4.248, 1.789, 0.981, 0.403,
            0.173, 0.034, 0.002],
}


def ays_sigmas(model_type: str, steps: int) -> np.ndarray:
    """Align-Your-Steps: the model line's table log-linearly interpolated
    to ``steps + 1`` levels (its last, 0.029 or 0.002, not zeroed)."""
    key = str(model_type).upper().replace("1.5", "1").replace("SD15",
                                                              "SD1")
    if key not in AYS_TABLES:
        raise ValueError(f"unknown AYS model type {model_type!r}; "
                         f"available: {tuple(AYS_TABLES)}")
    table = np.asarray(AYS_TABLES[key], np.float64)
    xs = np.linspace(0.0, 1.0, table.shape[0])
    xq = np.linspace(0.0, 1.0, int(steps) + 1)
    return np.exp(np.interp(xq, xs, np.log(table))).astype(np.float32)


def sd_turbo_sigmas(ds: DiscreteSchedule, steps: int,
                    denoise: float = 1.0) -> np.ndarray:
    """SDTurboScheduler: the last ``steps`` of the timesteps 999, 899,
    ..., 99 after skipping ``10 - int(10 * denoise)`` of them (the
    reference node's indexing, not ``int(10 - 10 * denoise)``: 0.25
    skips 8), their sigmas on the table, trailing 0."""
    steps = max(int(steps), 1)
    start = max(10 - int(10 * float(denoise)), 0)
    ts = np.flip(np.arange(1, 11) * 100 - 1)[start:start + steps]
    sig = ds.sigmas[ts.astype(int)]
    return np.concatenate([sig, [0.0]]).astype(np.float32)


def exponential_scheduler(ds: DiscreteSchedule, steps: int) -> np.ndarray:
    """Uniform in log sigma between the table's bounds."""
    return _append_zero(np.exp(np.linspace(math.log(ds.sigma_max),
                                           math.log(ds.sigma_min), steps)))


def simple_scheduler(ds: DiscreteSchedule, steps: int) -> np.ndarray:
    """Every (T/steps)-th entry of the model table, descending."""
    ss = len(ds.sigmas) / steps
    return _append_zero(np.asarray(
        [float(ds.sigmas[-(1 + int(i * ss))]) for i in range(steps)]))


def ddim_uniform_scheduler(ds: DiscreteSchedule, steps: int) -> np.ndarray:
    """Every (T // steps)-th timestep from 1, descending."""
    T = len(ds.sigmas)
    ss = max(T // steps, 1)
    timesteps = np.asarray(list(range(1, T + 1, ss))[:steps], dtype=np.int64)
    return _append_zero(ds.sigmas[timesteps - 1][::-1])


def beta_scheduler(ds: DiscreteSchedule, steps: int, alpha: float = 0.6,
                   beta: float = 0.6) -> np.ndarray:
    """Timesteps at the beta(alpha, beta) quantiles, rounded onto the
    table and deduplicated in order (fewer sigmas when two round to one
    timestep)."""
    ts = scipy.stats.beta.ppf(1.0 - np.linspace(0, 1, steps, endpoint=False),
                              alpha, beta)
    T = len(ds.sigmas)
    idx = np.clip((ts * (T - 1)).round().astype(np.int64), 0, T - 1)
    chosen = list(dict.fromkeys(int(i) for i in idx))
    return _append_zero(ds.sigmas[np.asarray(chosen)])


def linear_quadratic_scheduler(ds: DiscreteSchedule, steps: int,
                               threshold_noise: float = 0.025,
                               linear_steps: Optional[int] = None
                               ) -> np.ndarray:
    """Denoising progress p(i) rises linearly to ``threshold_noise`` over
    the first ``linear_steps`` (half by default), then follows the
    quadratic that matches its value and slope there and reaches 1 at
    the last step; sigma = (1 - p) * sigma_max."""
    if steps == 1:
        return _append_zero(np.asarray([ds.sigma_max]))
    L = linear_steps if linear_steps is not None else steps // 2
    L = int(np.clip(L, 1, steps - 1))
    i = np.arange(steps + 1, dtype=np.float64)
    slope = threshold_noise / L
    u_end = steps - L
    a = (1.0 - threshold_noise - slope * u_end) / (u_end ** 2)
    u = i - L
    p = np.where(i <= L, slope * i, a * u ** 2 + slope * u + threshold_noise)
    return _append_zero((1.0 - p[:-1]) * ds.sigma_max)


def kl_optimal_scheduler(ds: DiscreteSchedule, steps: int) -> np.ndarray:
    """KL-optimal spacing (arctan interpolation, Sabour et al. 2024)."""
    t = np.linspace(0, 1, steps)
    return _append_zero(np.tan((1 - t) * math.atan(ds.sigma_max)
                               + t * math.atan(ds.sigma_min)))


SCHEDULERS: Dict[str, Callable[[DiscreteSchedule, int], np.ndarray]] = {
    "normal": normal_scheduler,
    "karras": karras_scheduler,
    "exponential": exponential_scheduler,
    "sgm_uniform": lambda ds, n: normal_scheduler(ds, n, sgm=True),
    "simple": simple_scheduler,
    "ddim_uniform": ddim_uniform_scheduler,
    "beta": beta_scheduler,
    "linear_quadratic": linear_quadratic_scheduler,
    "kl_optimal": kl_optimal_scheduler,
}


def compute_sigmas(ds: DiscreteSchedule, scheduler: str, steps: int,
                   denoise: float = 1.0) -> np.ndarray:
    """Full sigma sequence for a run; ``denoise < 1`` keeps the final
    fraction of the steps (img2img semantics)."""
    if scheduler not in SCHEDULERS:
        raise ValueError(f"unknown scheduler {scheduler!r}; "
                         f"available: {tuple(SCHEDULERS)}")
    if denoise >= 0.9999:
        return SCHEDULERS[scheduler](ds, steps)
    if denoise <= 0.0:
        return np.asarray([0.0], dtype=np.float32)
    total = max(int(steps / denoise), steps)
    return SCHEDULERS[scheduler](ds, total)[-(steps + 1):]
