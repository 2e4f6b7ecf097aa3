"""Where one denoise step spends the card's time.

    python -m comfyui_distributed_tpu_torch.tools.profile_step \\
        [--steps 3] [--trace build/profile_step.json] \\
        [--family sd15 --size 512 --batch 16]

Loads a virtual pipeline on the card (SDXL unless ``--family`` says
otherwise) and makes one model call of ``--batch`` images (cond and
uncond stacked: B = 2 x batch) on a ``--size / 8`` square latent, cfg 7.
The defaults are the txt2img path's call (SDXL, B = 2, a 128x128
latent); ``--family sd15 --size 512 --batch 16`` is the tiled
upscaler's (16 tiles of 512^2, B = 32); ``--family sd15_inpaint --size
512 --batch 1`` is an inpaint model's (B = 2, the UNet's 5 extra input
channels a mask and a masked latent, random here).  The call runs twice
to warm up, ``--steps`` times timed, then ``--steps`` times under
``torch.profiler``.  Prints the card (``nvidia-smi``) and one JSON line:
the wall time of a step without and with the profiler (host clock around
synchronized calls), the device time of a step by kernel class (the
port's flash attention, GEMMs, convolutions, normalisation, everything
else), the top kernels, and the device's busy share of the unprofiled
step's wall time.  ``--trace`` also writes the chrome trace.  ``--family tiny --size 64 --device cpu`` rehearses
the script on a host without a card (no device time is reported).
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from collections import defaultdict

import torch

# first match wins: cuDNN's convolutions are implicit GEMMs by name
CLASSES = (
    ("flash_attention", ("flash_fwd",)),
    ("conv", ("conv", "fprop", "implicit", "winograd", "dgrad")),
    ("gemm", ("gemm", "nvjet", "cutlass", "s16816", "sm90_")),
    ("norm", ("norm", "welford", "moments", "fusedparams")),
)


def kernel_class(name: str) -> str:
    low = name.lower()
    for cls, keys in CLASSES:
        if any(k in low for k in keys):
            return cls
    return "elementwise_and_other"


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--steps", type=int, default=3)
    p.add_argument("--trace", default=None)
    p.add_argument("--family", default="sdxl",
                   help="model family (tiny: a CPU rehearsal)")
    p.add_argument("--size", type=int, default=1024, help="image side, px")
    p.add_argument("--batch", type=int, default=1,
                   help="images per call (the upscaler's tiles)")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    on_cuda = torch.device(args.device).type == "cuda"
    if on_cuda and not torch.cuda.is_available():
        print("profile_step: no CUDA card", file=sys.stderr)
        return 1

    def sync():
        if on_cuda:
            torch.cuda.synchronize()
    if on_cuda:
        print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True).stdout.strip(), flush=True)

    from comfyui_distributed_tpu_torch.models.denoiser import make_denoiser
    from comfyui_distributed_tpu_torch.models.registry import (
        load_pipeline, stack_y)
    from comfyui_distributed_tpu_torch.models.samplers import (
        cfg_denoiser_multi)
    from comfyui_distributed_tpu_torch.models.schedules import compute_sigmas
    from comfyui_distributed_tpu_torch.ops.base import Conditioning
    from comfyui_distributed_tpu_torch.ops.basic import _sdxl_vector_cond

    pipe = load_pipeline("sd_xl_base_1.0.safetensors",
                         family_name=args.family, device=args.device)
    dev = pipe.device
    side = args.size // 8
    with torch.inference_mode():
        n = args.batch
        ctx, pooled = pipe.encode_prompt(["a lighthouse on a cliff"])
        unc, _ = pipe.encode_prompt(["blurry"])
        y = None
        if pipe.family.unet.adm_in_channels is not None:
            # one vector for each of the call's two CFG row blocks
            y = stack_y(_sdxl_vector_cond(pipe, Conditioning(ctx, pooled),
                                          n, args.size, args.size), 2, dev)
        ctx, unc = ctx.repeat(n, 1, 1), unc.repeat(n, 1, 1)
        extra = pipe.family.unet.in_channels - pipe.family.latent_channels
        concat = torch.randn((n, side, side, extra), device=dev) \
            if extra else None
        model = cfg_denoiser_multi(
            make_denoiser(pipe.unet, pipe.schedule, device=dev,
                          concat=concat),
            [(ctx, None, 1.0)], unc, 7.0)
        sigma = torch.tensor(float(compute_sigmas(pipe.schedule, "karras",
                                                  20)[0]), device=dev)
        x = torch.randn((n, side, side, 4), device=dev) * sigma

        def step():
            return model(x, sigma, y=y)

        for _ in range(2):
            step()
        sync()
        t0 = time.perf_counter()
        for _ in range(args.steps):
            step()
        sync()
        plain_wall = time.perf_counter() - t0
        acts = [torch.profiler.ProfilerActivity.CPU]
        if on_cuda:
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        with torch.profiler.profile(activities=acts) as prof:
            t0 = time.perf_counter()
            for _ in range(args.steps):
                step()
            sync()
            wall = time.perf_counter() - t0
    by_class = defaultdict(float)
    kernels = []
    for evt in prof.key_averages():
        if evt.device_type != torch.autograd.DeviceType.CUDA:
            continue
        us = float(evt.self_device_time_total)
        if us <= 0:
            continue
        by_class[kernel_class(evt.key)] += us
        kernels.append((us, evt.count, evt.key))
    n = args.steps
    device_ms = sum(by_class.values()) / 1e3 / n
    kernels.sort(reverse=True)
    # the profiler slows the host, not the kernels: the busy share is the
    # profiled device time over the unprofiled wall time of a step
    report = {
        "family": args.family, "size": args.size, "batch": args.batch,
        "steps": n,
        "unprofiled_wall_ms_per_step": plain_wall * 1e3 / n,
        "wall_ms_per_step": wall * 1e3 / n,
        "device_ms_per_step": device_ms,
        "busy_share": device_ms / (plain_wall * 1e3 / n) if device_ms
        else None,
        "device_ms_per_step_by_class": {k: v / 1e3 / n for k, v in
                                        sorted(by_class.items())},
        "top_kernels": [{"name": name[:120], "launches_per_step": c / n,
                         "ms_per_step": us / 1e3 / n}
                        for us, c, name in kernels[:12]],
        "profiler_saw_device_time": bool(by_class),
    }
    print(json.dumps({"profile_step": report}), flush=True)
    if args.trace:
        prof.export_chrome_trace(args.trace)
    return 0


if __name__ == "__main__":
    sys.exit(main())
