"""Noise schedules and sigma tables (numpy): the port's own copy of
``comfyui_distributed_tpu/models/schedules.py``'s discrete VP table and
its nine step schedulers (KSampler's ``scheduler`` widget).  The
custom-sampler schedule functions (polyexponential, VP, Laplace, AYS,
SD-Turbo) are not ported yet.

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


def karras_scheduler(ds: DiscreteSchedule, steps: int,
                     rho: float = 7.0) -> np.ndarray:
    """Karras et al. 2022 rho-schedule between the table's bounds."""
    ramp = np.linspace(0, 1, steps)
    min_r, max_r = ds.sigma_min ** (1 / rho), ds.sigma_max ** (1 / rho)
    return _append_zero((max_r + ramp * (min_r - max_r)) ** rho)


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
