"""Whether a latent row's denoise step on the card depends on where it
sits in a continuous-batching bucket, and from which module on.

    python -m comfyui_distributed_tpu_torch.tools.row_position \\
        [--family sdxl --size 1024] [--rows 2] [--device cuda]

Loads a virtual pipeline (SDXL unless ``--family`` says otherwise),
builds the continuous-batching step (``registry.denoise_step_fn``,
euler, cfg 7) at ``--rows`` rows on a ``--size / 8`` latent and calls it
on latents [r, s], [s, r] and [r, t], every row at the schedule's first
sigma: row r at slot 0 against slot 1 (its position) and beside another
row (its neighbour).  For a pair that differs, a hooked run of each
names the first module whose output for r's cond row differs (its
float64 sum and sum of squares).  Then the same position test on three
bare bf16 calls at the step's shapes: a matmul, a convolution and the
port's flash attention.  Prints the card (``nvidia-smi``) and one JSON
line.
``--family tiny --size 64 --device cpu`` rehearses it on a host without
a card.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys

import numpy as np
import torch


def _fingerprints(unet, call):
    """(module name, (sum, sum of squares) of each output's row 0..) in
    call order, for outputs whose leading dimension is the CFG batch."""
    seen = []
    hooks = []

    def hook(name):
        def fn(mod, inp, out):
            if isinstance(out, torch.Tensor) and out.ndim >= 2:
                d = out.detach().double()
                seen.append((name, [(float(r.sum()), float((r * r).sum()))
                                    for r in d]))
        return fn
    for name, mod in unet.named_modules():
        if name:
            hooks.append(mod.register_forward_hook(hook(name)))
    try:
        call()
    finally:
        for h in hooks:
            h.remove()
    return seen


def _first_difference(a, b, row_a: int, row_b: int):
    """The first module whose fingerprint of r differs between two runs
    (r at ``row_a`` in the first, ``row_b`` in the second)."""
    for (name, fa), (_, fb) in zip(a, b):
        if len(fa) > max(row_a, row_b) and fa[row_a] != fb[row_b]:
            return name
    return None


def _position_probe(fn, blocks, cat_dim=0) -> dict:
    """fn(cat([x, y])) against fn(cat([y, x])): x's rows equal?"""
    x, y = blocks
    a = fn(torch.cat([x, y], cat_dim))
    b = fn(torch.cat([y, x], cat_dim))
    n = x.shape[cat_dim]
    xa = a.narrow(cat_dim, 0, n)
    xb = b.narrow(cat_dim, b.shape[cat_dim] - n, n)
    return {"equal": bool(torch.equal(xa, xb)),
            "max_abs": float((xa.float() - xb.float()).abs().max())}


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--family", default="sdxl")
    p.add_argument("--size", type=int, default=1024)
    p.add_argument("--rows", type=int, default=2)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    on_cuda = torch.device(args.device).type == "cuda"
    if on_cuda and not torch.cuda.is_available():
        print("row_position: no CUDA card", file=sys.stderr)
        return 1
    if on_cuda:
        print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True).stdout.strip(), flush=True)

    from comfyui_distributed_tpu_torch.models.registry import load_pipeline
    from comfyui_distributed_tpu_torch.models.schedules import compute_sigmas
    from comfyui_distributed_tpu_torch.ops.base import Conditioning
    from comfyui_distributed_tpu_torch.ops.basic import _sdxl_vector_cond
    from comfyui_distributed_tpu_torch.ops.kernels import flash_attention as fa

    pipe = load_pipeline("sd_xl_base_1.0.safetensors",
                         family_name=args.family, device=args.device)
    dev = pipe.device
    side, rows = args.size // 8, max(args.rows, 2)
    gen = torch.Generator(device=dev).manual_seed(0)
    report = {"family": args.family, "size": args.size, "rows": rows}
    with torch.inference_mode():
        ctx1, pooled = pipe.encode_prompt(["a lighthouse on a cliff"])
        unc1, _ = pipe.encode_prompt(["blurry"])
        y = None
        if pipe.family.unet.adm_in_channels is not None:
            y = _sdxl_vector_cond(pipe, Conditioning(ctx1, pooled), rows,
                                  args.size, args.size)
        ctx, unc = ctx1.repeat(rows, 1, 1), unc1.repeat(rows, 1, 1)
        fn, _ = pipe.denoise_step_fn("euler", 7.0, rows, (side, side),
                                     has_y=y is not None)
        sig = compute_sigmas(pipe.schedule, "karras", 20)
        s0 = sig[0]

        def lat():
            return torch.randn((1, side, side, pipe.family.latent_channels),
                               generator=gen, device=dev) * float(s0)
        r, s, t = lat(), lat(), lat()
        pad = [lat() for _ in range(rows - 2)]

        def step(*rs):
            x = torch.cat([*rs, *pad])
            return fn(x, ctx, unc, y, np.zeros((rows, 2), np.uint32),
                      np.full(rows, s0, np.float32),
                      np.full(rows, sig[1], np.float32),
                      np.zeros(rows, np.int64), np.ones(rows, bool))
        a, b, c = step(r, s), step(s, r), step(r, t)
        report["position"] = {"equal": bool(torch.equal(a[0], b[1])),
                              "max_abs": float((a[0] - b[1]).abs().max())}
        report["neighbour"] = {"equal": bool(torch.equal(a[0], c[0])),
                               "max_abs": float((a[0] - c[0]).abs().max())}
        # the first module where r's cond row parts: the CFG stack is
        # [cond rows; uncond rows], so r's cond row is its slot
        for key, others, row_b in (("position", (s, r), 1),
                                   ("neighbour", (r, t), 0)):
            if report[key]["equal"]:
                continue
            fa_ = _fingerprints(pipe.unet, lambda: step(r, s))
            fb_ = _fingerprints(pipe.unet, lambda: step(*others))
            report[key]["first_module"] = _first_difference(fa_, fb_, 0,
                                                            row_b)
        # the same position test on bare calls at the step's shapes
        dt = torch.bfloat16 if on_cuda else torch.float32
        tok, ch = (side // 2) ** 2, 640 if args.family == "sdxl" else 64

        def rnd(*shape):
            return torch.randn(shape, generator=gen, device=dev).to(dt)
        w = rnd(ch, ch)
        report["matmul"] = _position_probe(
            lambda z: z @ w, (rnd(tok, ch), rnd(tok, ch)))
        k = rnd(ch, ch, 3, 3)
        report["conv"] = _position_probe(
            lambda z: torch.nn.functional.conv2d(z, k, padding=1),
            (rnd(1, ch, side // 2, side // 2), rnd(1, ch, side // 2,
                                                   side // 2)))
        heads = ch // 64 if ch >= 64 else 1
        q = (rnd(2, tok, heads, 64), rnd(2, tok, heads, 64))
        report["flash_attention"] = _position_probe(
            lambda z: fa.flash_attention(z, z, z), q)
    print(json.dumps({"row_position": report}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
