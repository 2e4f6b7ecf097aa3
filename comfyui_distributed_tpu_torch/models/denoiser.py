"""Denoiser wrapper: UNet (eps/v prediction) -> k-diffusion interface.
The counterpart of ``comfyui_distributed_tpu/models/denoiser.py`` for
the plain path and the inpaint models' extra input channels (no
ControlNet or hypernetworks yet).

The UNet input is pre-scaled by ``1/sqrt(sigma^2+1)`` and the timestep is
the continuous index of sigma in the model's table.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from comfyui_distributed_tpu_torch.models.schedules import DiscreteSchedule


def make_t_from_sigma(ds: DiscreteSchedule, device=None) -> Callable:
    """sigma -> continuous table index (piecewise-linear in log sigma);
    the table is made on ``device`` and follows sigma's device."""
    log_sigmas = torch.log(torch.as_tensor(ds.sigmas, device=device))

    def t_from_sigma(sigma: torch.Tensor) -> torch.Tensor:
        log_s = torch.log(torch.clamp(sigma, min=1e-10))
        table = log_sigmas.to(log_s.device)
        idx = torch.searchsorted(table, log_s.reshape(-1),
                                 side="left").reshape(log_s.shape)
        idx = torch.clamp(idx, 1, table.shape[0] - 1)
        lo, hi = table[idx - 1], table[idx]
        frac = (log_s - lo) / torch.clamp(hi - lo, min=1e-12)
        return (idx - 1).float() + frac

    return t_from_sigma


def make_denoiser(unet: Callable, ds: DiscreteSchedule,
                  prediction_type: str = "eps",
                  device=None,
                  concat: Optional[torch.Tensor] = None) -> Callable:
    """``model(x, sigma, context=..., y=...) -> denoised`` over
    ``unet(x, timesteps, context, y)``; ``sigma`` is a host float (made
    a float32 scalar on x's device by a fill, not a copy that would wait
    for the card), a float32 scalar tensor, or a [B] tensor, one sigma a
    row of x (continuous batching), shaped [B, 1, 1, 1] against x as
    the JAX package's ``_broadcast_sigma`` does.  ``concat`` [B, h, w, K]:
    the inpaint models' extra input channels (mask and masked latent),
    appended unscaled after the ``c_in`` scaling, its rows repeated to
    the CFG-stacked batch ([cond rows; uncond rows] each get them)."""
    if prediction_type not in ("eps", "v"):
        raise ValueError(f"prediction type {prediction_type!r} is not "
                         "ported to the torch package")
    t_from_sigma = make_t_from_sigma(ds, device)

    def denoiser(x: torch.Tensor, sigma: torch.Tensor,
                 context: Optional[torch.Tensor] = None,
                 y: Optional[torch.Tensor] = None) -> torch.Tensor:
        if isinstance(sigma, torch.Tensor):
            sigma = sigma.to(device=x.device, dtype=torch.float32)
        else:
            sigma = torch.full((), float(sigma), dtype=torch.float32,
                               device=x.device)
        ts = t_from_sigma(sigma).reshape(-1)
        if ts.shape[0] == 1:
            ts = ts.expand(x.shape[0])
        if sigma.ndim:
            sigma = sigma.reshape((-1,) + (1,) * (x.ndim - 1))
        c_in = 1.0 / torch.sqrt(sigma ** 2 + 1.0)
        xin = x * c_in
        if concat is not None:
            reps = x.shape[0] // concat.shape[0]
            xin = torch.cat([xin, concat.to(xin.dtype).repeat(reps, 1, 1, 1)],
                            dim=-1)
        out = unet(xin, ts, context, y)
        if prediction_type == "v":
            # VP parameterization: denoised = c_skip*x - c_out*v
            c_skip = 1.0 / (sigma ** 2 + 1.0)
            c_out = sigma / torch.sqrt(sigma ** 2 + 1.0)
            return x * c_skip - out * c_out
        return x - out * sigma

    return denoiser
