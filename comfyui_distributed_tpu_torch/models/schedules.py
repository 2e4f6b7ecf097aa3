"""Noise schedules and sigma tables (numpy): the port's own copy of the
part of ``comfyui_distributed_tpu/models/schedules.py`` that the txt2img
path uses — the discrete VP table and the ``normal`` and ``karras`` step
schedules.

Sigmas are returned descending with a trailing 0.0, shape ``[steps +
1]`` (the k-diffusion convention).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict

import numpy as np


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


def normal_scheduler(ds: DiscreteSchedule, steps: int) -> np.ndarray:
    """Uniform in timestep space over the model's sigma table."""
    start = ds.t_from_sigma(ds.sigma_max)
    end = ds.t_from_sigma(ds.sigma_min)
    return _append_zero(ds.sigma_from_t(np.linspace(start, end, steps)))


def karras_scheduler(ds: DiscreteSchedule, steps: int,
                     rho: float = 7.0) -> np.ndarray:
    """Karras et al. 2022 rho-schedule between the table's bounds."""
    ramp = np.linspace(0, 1, steps)
    min_r, max_r = ds.sigma_min ** (1 / rho), ds.sigma_max ** (1 / rho)
    return _append_zero((max_r + ramp * (min_r - max_r)) ** rho)


SCHEDULERS: Dict[str, Callable[[DiscreteSchedule, int], np.ndarray]] = {
    "normal": normal_scheduler,
    "karras": karras_scheduler,
}


def compute_sigmas(ds: DiscreteSchedule, scheduler: str, steps: int,
                   denoise: float = 1.0) -> np.ndarray:
    """Full sigma sequence for a run; ``denoise < 1`` keeps the final
    fraction of the steps (img2img semantics)."""
    if scheduler not in SCHEDULERS:
        raise ValueError(f"scheduler {scheduler!r} is not ported to the "
                         f"torch package; available: {tuple(SCHEDULERS)}")
    if denoise >= 0.9999:
        return SCHEDULERS[scheduler](ds, steps)
    if denoise <= 0.0:
        return np.asarray([0.0], dtype=np.float32)
    total = max(int(steps / denoise), steps)
    return SCHEDULERS[scheduler](ds, total)[-(steps + 1):]
