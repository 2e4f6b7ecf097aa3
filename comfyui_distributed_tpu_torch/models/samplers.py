"""k-diffusion samplers in PyTorch: the counterpart of the part of
``comfyui_distributed_tpu/models/samplers.py`` on the txt2img path — the
Euler sampler (a Python loop over sigma pairs) and classifier-free
guidance for one cond and one uncond entry.

Model convention: ``model(x, sigma, **extra) -> denoised`` (x0
prediction) on NHWC latents, ``sigma`` a float32 scalar tensor.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional

import torch

Model = Callable[..., torch.Tensor]


def euler_step(model: Model, x: torch.Tensor, sigma: torch.Tensor,
               sigma_next: torch.Tensor,
               extra_args: Optional[Dict[str, Any]] = None) -> torch.Tensor:
    """One Euler (== deterministic DDIM) step."""
    denoised = model(x, sigma, **(extra_args or {}))
    d = (x - denoised) / torch.clamp(sigma, min=1e-20)
    return x + d * (sigma_next - sigma)


def sample_euler(model: Model, x: torch.Tensor, sigmas: torch.Tensor,
                 extra_args: Optional[Dict[str, Any]] = None) -> torch.Tensor:
    """Euler over every consecutive pair of the float32 ``sigmas``."""
    for i in range(sigmas.shape[0] - 1):
        x = euler_step(model, x, sigmas[i], sigmas[i + 1], extra_args)
    return x


SAMPLERS: Dict[str, Callable] = {"euler": sample_euler}


def get_sampler(name: str) -> Callable:
    if name not in SAMPLERS:
        raise ValueError(f"sampler {name!r} is not ported to the torch "
                         f"package; available: {tuple(SAMPLERS)}")
    return SAMPLERS[name]


def cfg_denoiser_multi(model: Model, conds, uncond,
                       cfg_scale: float) -> Model:
    """Classifier-free guidance for the single-entry case of the JAX
    package's ``cfg_denoiser_multi``: ``conds`` is one ``(context, None,
    1.0)`` entry (or a bare context), ``uncond`` a context.  One model
    call per step on the stacked [cond rows; uncond rows] batch (B=2 for
    one image), then ``uncond + (cond - uncond) * cfg``; with cfg == 1
    only the cond rows run.  Regional entries (masks, strengths, timestep
    ranges) are not ported yet and raise."""
    if isinstance(conds, (list, tuple)):
        cond, *rest = conds[0]
        mask, strength, srange = rest + [None, 1.0, None][len(rest):]
        if len(conds) != 1 or mask is not None or float(strength) != 1.0 \
                or srange is not None:
            raise NotImplementedError(
                "multi-entry or masked conditioning is not ported yet")
    else:
        cond = conds

    def wrapped(x: torch.Tensor, sigma: torch.Tensor,
                y: Optional[torch.Tensor] = None) -> torch.Tensor:
        if cfg_scale == 1.0:
            return model(x, sigma, context=cond, y=y)
        y2 = None if y is None else torch.cat([y, y])
        out = model(torch.cat([x, x]), sigma,
                    context=torch.cat([cond, uncond]), y=y2)
        den_cond, den_uncond = out.chunk(2)
        return den_uncond + (den_cond - den_uncond) * cfg_scale
    return wrapped
