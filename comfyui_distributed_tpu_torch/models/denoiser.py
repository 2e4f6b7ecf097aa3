"""Denoiser wrapper: UNet (eps, v or x0 prediction) -> k-diffusion
interface.  The counterpart of ``comfyui_distributed_tpu/models/
denoiser.py``: the plain path, the inpaint models' extra input channels,
a chain of ControlNets and SAG's capture (no hypernetworks yet).

The UNet input is pre-scaled by ``1/sqrt(sigma^2+1)`` and the timestep is
the continuous index of sigma in the model's table.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, List, Optional, Sequence, Tuple

import numpy as np
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


@dataclasses.dataclass(frozen=True)
class ControlSpec:
    """One ControlNet link of a chain: the net, its hint [b, H, W, 3] on
    the run's device (b the latent's rows, H x W 8x the latent's), its
    strength (one for every row block, or a tuple with one a stacked
    block: [cond_1..cond_n, uncond_1..uncond_m]) and its sigma window:
    None, one ``(sigma_start, sigma_end)`` pair, or a tuple with one pair
    (or None: always on) a block.  A block's residuals count only while
    ``sigma_end <= sigma <= sigma_start``."""
    net: Callable
    hint: torch.Tensor
    strength: Any
    window: Any = None


def _gate(sigma, window):
    """The window's gate at the host sigma ``sigma``: None (no window),
    else a bool, compared in float32 as the JAX package compares.  A
    tensor sigma raises: reading it would make the host wait for the
    card, and only continuous batching passes one, which refuses a
    control."""
    if window is None:
        return None
    if isinstance(sigma, torch.Tensor):
        raise TypeError("a ControlNet's sigma window takes the step's "
                        "sigma as a host float, not a tensor")
    s_start, s_end = np.float32(window[0]), np.float32(window[1])
    sig = np.float32(np.max(np.asarray(sigma, np.float32)))
    return bool(s_end <= sig <= s_start)


def _run_one_controlnet(spec: ControlSpec, xin: torch.Tensor, ts: torch.Tensor,
                   context: torch.Tensor, y: Optional[torch.Tensor], sigma
                   ) -> Optional[Tuple[List[torch.Tensor], torch.Tensor]]:
    """One link's residuals, each times its block's strength and gate;
    the hint repeats over the stacked blocks.  None when every block's
    window is closed at this sigma: the net is not run (the JAX package
    skips its forward there too), as its residuals would all be zero."""
    hint = spec.hint
    reps = xin.shape[0] // hint.shape[0]
    per_block = isinstance(spec.window, (tuple, list)) and spec.window \
        and isinstance(spec.window[0], (tuple, list, type(None)))
    if spec.window is None:
        gates = None
    elif per_block:
        gates = [_gate(sigma, w) for w in spec.window]
    else:
        gates = [_gate(sigma, spec.window)]
    if gates is not None and all(g is False for g in gates):
        return None
    outs, mid = spec.net(xin, ts, context,
                         hint.repeat(reps, 1, 1, 1) if reps > 1 else hint, y)
    if isinstance(spec.strength, (tuple, list)):
        if len(spec.strength) != reps:
            raise ValueError(f"{len(spec.strength)} ControlNet strengths "
                             f"for {reps} row blocks")
        strengths = [float(v) for v in spec.strength]
    else:
        strengths = [float(spec.strength)] * reps

    def gate(i):
        g = None if gates is None else gates[i if per_block else 0]
        return True if g is None else g

    vals = [v if gate(i) else 0.0 for i, v in enumerate(strengths)]
    if len(set(vals)) == 1:
        return [o * vals[0] for o in outs], mid * vals[0]
    ones = torch.ones((hint.shape[0], 1, 1, 1), dtype=mid.dtype,
                      device=mid.device)
    scale = torch.cat([ones * v for v in vals])
    return [o * scale for o in outs], mid * scale


def _run_control_chain(chain: Sequence[ControlSpec], xin: torch.Tensor,
                      ts: torch.Tensor, context: torch.Tensor,
                      y: Optional[torch.Tensor], sigma):
    """Every link on the same scaled input; their residuals sum (ComfyUI's
    previous_controlnet chain).  None when no link ran."""
    acc = None
    for spec in chain:
        one = _run_one_controlnet(spec, xin, ts, context, y, sigma)
        if one is None:
            continue
        if acc is None:
            acc = one
        else:
            acc = ([a + b for a, b in zip(acc[0], one[0], strict=True)],
                   acc[1] + one[1])
    return acc


def make_denoiser(unet: Callable, ds: DiscreteSchedule,
                  prediction_type: str = "eps",
                  device=None,
                  concat: Optional[torch.Tensor] = None,
                  control: Optional[Sequence[ControlSpec]] = None,
                  capture: bool = False) -> Callable:
    """``model(x, sigma, context=..., y=...) -> denoised`` over
    ``unet(x, timesteps, context, y)``; ``sigma`` is a host float (made
    a float32 scalar on x's device by a fill, not a copy that would wait
    for the card), a float32 scalar tensor, or a [B] tensor, one sigma a
    row of x (continuous batching), shaped [B, 1, 1, 1] against x as
    the JAX package's ``_broadcast_sigma`` does.  ``concat`` [B, h, w, K]:
    the inpaint models' extra input channels (mask and masked latent),
    appended unscaled after the ``c_in`` scaling, its rows repeated to
    the CFG-stacked batch ([cond rows; uncond rows] each get them).
    ``control``: a chain of :class:`ControlSpec`, run each call on the
    same scaled input the UNet sees (before the concat channels), their
    summed residuals passed as the UNet's ``control``.  ``capture``
    (SAG): the UNet runs its capture forward and the denoiser returns
    (denoised, the middle block's attention weights).
    ``prediction_type``: ``"eps"``, ``"v"`` (denoised = x / (sigma^2 +
    1) - v * sigma / sqrt(sigma^2 + 1)) or ``"x0"`` (the output is the
    denoised sample; ModelSamplingDiscrete's ``x0``)."""
    if prediction_type not in ("eps", "v", "x0"):
        raise ValueError(f"prediction type {prediction_type!r} is not "
                         "ported to the torch package")
    t_from_sigma = make_t_from_sigma(ds, device)

    def denoiser(x: torch.Tensor, sigma: torch.Tensor,
                 context: Optional[torch.Tensor] = None,
                 y: Optional[torch.Tensor] = None) -> torch.Tensor:
        sigma_in = sigma
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
        ctrl = None
        if control:
            ctrl = _run_control_chain(control, xin, ts, context, y, sigma_in)
        if concat is not None:
            reps = x.shape[0] // concat.shape[0]
            xin = torch.cat([xin, concat.to(xin.dtype).repeat(reps, 1, 1, 1)],
                            dim=-1)
        kw = {"capture": True} if capture else {}
        out = unet(xin, ts, context, y, **kw) if ctrl is None \
            else unet(xin, ts, context, y, ctrl, **kw)
        out, probs = out if capture else (out, None)
        if prediction_type == "v":
            # VP parameterization: denoised = c_skip*x - c_out*v
            c_skip = 1.0 / (sigma ** 2 + 1.0)
            c_out = sigma / torch.sqrt(sigma ** 2 + 1.0)
            den = x * c_skip - out * c_out
        elif prediction_type == "x0":
            den = out
        else:
            den = x - out * sigma
        return (den, probs) if capture else den

    return denoiser
