#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with a CUDA card (and
``nvcc``).  It imports nothing of JAX.  Phases, each fatal on failure:

1. the card's name and power limit (``nvidia-smi``);
2. build: every ``comfyui_distributed_tpu_torch/csrc/*.cu`` compiled for
   ``sm_90a`` anew, all at once, with ptxas' register, shared-memory and
   spill report; it fails if ptxas reports spills, serialized ``wgmma``
   instructions or an ignored ``setmaxnreg`` for the sm90 kernel;
3. kernel checks: the flash-attention kernels against their plain
   PyTorch version on the card at every shape the SDXL 1024^2 path gives
   them, plus the sm90 kernel's edges (N and M not multiples of 128,
   M < 16, one batch-head, N < 64), fp32 and other head dims (bf16:
   relative error < 2e-2; fp32: absolute error < 2e-4, TF32 off).  Each
   shape is
   timed beside the plain version, ``scaled_dot_product_attention`` (a
   yardstick the port never calls), at bf16 D = 64 the older
   ``mma.sync`` kernel on the same inputs, and the least time the card
   could take (``bound_ms``).  Times are device times: the card is kept
   busy by a sleep kernel while the host enqueues, the candidates run in
   turns (forward, then reversed) and each time is the median of five
   rounds;
4. a tiny-family txt2img on the card against the same run on the CPU
   (plain versions): images must agree within 1e-3;
5. the main path: ``workflows/distributed-txt2img.json`` unchanged (SDXL,
   1024^2, 20 euler/karras steps, cfg 7, virtual weights) through the
   port's WorkflowExecutor as three requests with three seeds.  Launch
   counts are zeroed just before and read just after; each request must
   launch the sm90 kernel 2800 times (70 transformer blocks x 2
   attentions x 20 steps) and give a finite, non-constant
   (1, 1024, 1024, 3) image.

The line before the last is ``{"kernels": [...]}``: for each kernel
variant phase 5 launched, its launches and, over exactly those launches
(each shape's measured time times its launch count), ``ms``,
``plain_ms``, ``library_ms``, ``bound_ms`` and, for sm90, ``mma_sync_ms``.
The last line is ``{"ok": true, "device": {...}}``.  Without a CUDA card,
or outside a checkout, it exits non-zero before printing any result.
"""

from __future__ import annotations

import copy
import json
import math
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
WORKFLOW = os.path.join(ROOT, "workflows", "distributed-txt2img.json")
REPLACES = "comfyui_distributed_tpu/ops/pallas/flash_attention.py:134"
SOURCES = {
    "sm90": "comfyui_distributed_tpu_torch/csrc/flash_attention_sm90.cu",
    "mma_sync": "comfyui_distributed_tpu_torch/csrc/flash_attention.cu",
    "fp32": "comfyui_distributed_tpu_torch/csrc/flash_attention.cu",
}
SM90_SOURCE = "flash_attention_sm90"
ROUNDS = 5
# host seconds one launch may take to enqueue, at most: the sleep that
# keeps the card busy while the host enqueues a timed run is sized by it
HOST_S_PER_LAUNCH = 200e-6
SLEEP_CYCLES_PER_S = 2e9

# H100 SXM published peaks (dense): bf16 tensor cores, fp32 outside the
# tensor cores, HBM3 bandwidth
PEAK_FLOPS = {"torch.bfloat16": 989e12, "torch.float32": 67e12}
PEAK_BYTES_PER_S = 3.35e12
BF16_REL_BAR = 2e-2
FP32_ABS_BAR = 2e-4
SEEDS = (123456789, 987654321, 42)
DEVICE = "cuda"
LAUNCHES_PER_REQUEST = 2800


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def emit(tag: str, obj) -> None:
    print(json.dumps({tag: obj}), flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    if out.returncode != 0:
        fail(f"nvidia-smi exited {out.returncode}: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def bound(B, N, M, H, D, dtype):
    """(bound_ms, bound_by, flops, bytes) of one launch: each input read
    once, the output written once."""
    elt = 2 if dtype == "torch.bfloat16" else 4
    flops = 4.0 * B * H * N * M * D
    nbytes = float(elt * (2 * B * N * H * D + 2 * B * M * H * D))
    t_ops = flops / PEAK_FLOPS[dtype]
    t_mem = nbytes / PEAK_BYTES_PER_S
    return (max(t_ops, t_mem) * 1e3,
            "operations" if t_ops >= t_mem else "bytes", flops, nbytes)


def time_ms(fn, reps: int) -> float:
    """Device ms per call of ``fn``: CUDA events around ``reps`` calls
    made while a sleep kernel keeps the card busy, so the host's enqueue
    time is hidden and the events see the kernels back to back."""
    import torch
    fn()
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(SLEEP_CYCLES_PER_S * HOST_S_PER_LAUNCH * reps))
    e0.record()
    for _ in range(reps):
        fn()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / reps


def time_in_turns(fns, reps):
    """name -> median device ms over ROUNDS rounds; each round times every
    candidate once, in the given order and then reversed, so a drift of
    the card's clock falls on all of them alike."""
    times = {name: [] for name in fns}
    for r in range(ROUNDS):
        order = list(fns) if r % 2 == 0 else list(fns)[::-1]
        for name in order:
            fn, n = fns[name]
            times[name].append(time_ms(fn, max(int(reps * n), 3)))
    return {name: statistics.median(ts) for name, ts in times.items()}


def check_kernel(shapes):
    """Phase 3: every shape against the plain version, timed."""
    import torch
    import torch.nn.functional as F

    from comfyui_distributed_tpu_torch.ops.kernels.flash_attention import (
        _launch_variant, flash_attention, flash_attention_plain,
        kernel_variant)
    gen = torch.Generator(device=DEVICE).manual_seed(0)
    rows = []
    for B, N, M, H, D, dt, role in shapes:
        dtype = getattr(torch, dt.split(".")[1])
        variant = kernel_variant(dtype, D)

        def rnd(n):
            return torch.randn((B, n, H, D), generator=gen, device=DEVICE,
                               dtype=torch.float32).to(dtype)

        q, k, v = rnd(N), rnd(M), rnd(M)
        ref = flash_attention_plain(q, k, v)
        errs = {}
        outs = {"ms": lambda: flash_attention(q, k, v)}
        if variant == "sm90":
            outs["mma_sync_ms"] = lambda: _launch_variant(q, k, v,
                                                          "mma_sync")
        for key, fn in outs.items():
            out = fn()
            torch.cuda.synchronize()
            err = (out.float() - ref.float()).abs().max().item()
            rel = err / max(ref.float().abs().max().item(), 1e-30)
            ok = (rel < BF16_REL_BAR) if dtype == torch.bfloat16 \
                else (err < FP32_ABS_BAR)
            if not math.isfinite(err) or not ok:
                fail(f"flash_attention {key} {role} {B, N, M, H, D, dt}: "
                     f"max abs err {err}, rel {rel}")
            errs[key] = (err, rel)

        def sdpa():
            return F.scaled_dot_product_attention(
                q.transpose(1, 2), k.transpose(1, 2),
                v.transpose(1, 2)).transpose(1, 2)

        # (function, share of the reps): the plain version is slow
        fns = {"ms": (outs["ms"], 1.0), "library_ms": (sdpa, 1.0),
               "plain_ms": (lambda: flash_attention_plain(q, k, v), 0.25)}
        if "mma_sync_ms" in outs:
            fns["mma_sync_ms"] = (outs["mma_sync_ms"], 1.0)
        times = time_in_turns(fns, 20 if N * M >= 1 << 20 else 100)
        b_ms, b_by, flops, nbytes = bound(B, N, M, H, D, dt)
        row = {"role": role, "variant": variant, "B": B, "N": N, "M": M,
               "H": H, "D": D, "dtype": dt, "max_abs_err": errs["ms"][0],
               "rel_err": errs["ms"][1], **times, "bound_ms": b_ms,
               "bound_us": b_ms * 1e3, "bound_by": b_by,
               "tflops": flops / (times["ms"] * 1e-3) / 1e12,
               "roofline_share": b_ms / times["ms"]}
        if "mma_sync_ms" in errs:
            row["mma_sync_rel_err"] = errs["mma_sync_ms"][1]
        rows.append(row)
        del q, k, v, ref
    torch.cuda.empty_cache()
    return rows


def tiny_against_cpu(doc):
    """Phase 4: the tiny family's txt2img on the card against the CPU
    run of the same graph (kernels' plain versions)."""
    import numpy as np

    from comfyui_distributed_tpu_torch.models import registry
    from comfyui_distributed_tpu_torch.ops.base import OpContext
    from comfyui_distributed_tpu_torch.workflow import WorkflowExecutor
    small = copy.deepcopy(doc)
    small["5"]["inputs"].update(width=64, height=64)
    small["3"]["inputs"]["steps"] = 4
    os.environ["DTPU_DEFAULT_FAMILY"] = "tiny"
    try:
        imgs = {dev: WorkflowExecutor(OpContext(device=dev)).execute(
            copy.deepcopy(small)).image_batch for dev in (DEVICE, "cpu")}
    finally:
        del os.environ["DTPU_DEFAULT_FAMILY"]
        registry.clear_pipeline_cache()
    card, host = imgs[DEVICE], imgs["cpu"]
    err = float(np.abs(card - host).max())
    if card.shape != host.shape or not err < 1e-3:
        fail(f"tiny txt2img on the card disagrees with the CPU run: "
             f"shapes {card.shape} {host.shape}, max err {err}")
    return {"shape": list(card.shape), "max_abs_err": err, "atol": 1e-3}


def main_path(doc):
    """Phase 5: three SDXL 1024^2 requests; returns the per-request
    report and the launch counts of the whole run."""
    import numpy as np
    import torch

    from comfyui_distributed_tpu_torch.ops.base import OpContext
    from comfyui_distributed_tpu_torch.ops.kernels import flash_attention \
        as fa
    from comfyui_distributed_tpu_torch.workflow import WorkflowExecutor
    requests = []
    fa.reset_counts()
    for seed in SEEDS:
        req = copy.deepcopy(doc)
        req["13"]["inputs"]["seed"] = seed
        torch.cuda.reset_peak_memory_stats()
        before = fa.flash_attention.launches
        sm90_before = fa.flash_attention.variants["sm90"]
        t0 = time.perf_counter()
        res = WorkflowExecutor(OpContext(device="cuda")).execute(req)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = fa.flash_attention.launches - before
        sm90 = fa.flash_attention.variants["sm90"] - sm90_before
        img = res.image_batch
        finite = bool(img is not None and np.isfinite(img).all())
        std = float(img.std()) if img is not None else 0.0
        requests.append({
            "seed": seed, "seconds": seconds,
            "node_seconds": {k: round(v, 4) for k, v in
                             res.timings.items()},
            "shape": list(img.shape) if img is not None else None,
            "finite": finite, "std": std, "launches": launches,
            "sm90_launches": sm90,
            "max_memory_allocated": torch.cuda.max_memory_allocated()})
        if img is None or img.shape != (1, 1024, 1024, 3) or not finite \
                or not std > 0.0:
            fail(f"request seed {seed}: image shape "
                 f"{None if img is None else img.shape}, finite {finite}, "
                 f"std {std}")
        if launches != LAUNCHES_PER_REQUEST or sm90 != LAUNCHES_PER_REQUEST:
            fail(f"request seed {seed}: {launches} flash-attention "
                 f"launches, {sm90} of them sm90; expected "
                 f"{LAUNCHES_PER_REQUEST} sm90 launches")
    return requests, dict(fa.flash_attention.variants), \
        dict(fa.flash_attention.shapes)


def kernels_line(rows, variant_counts, shape_counts):
    """The contract's entries over phase 5's launches: one per kernel
    variant that phase 5 launched, each over exactly its shapes."""
    by_shape = {(r["B"], r["N"], r["M"], r["H"], r["D"], r["dtype"]): r
                for r in rows}
    missing = [s for s in shape_counts if s not in by_shape]
    if missing:
        fail(f"main path launched shapes that phase 3 did not check: "
             f"{missing}")
    entries = []
    for variant in sorted({by_shape[s]["variant"] for s in shape_counts}):
        shapes = {s: n for s, n in shape_counts.items()
                  if by_shape[s]["variant"] == variant}
        launches = sum(shapes.values())
        if launches != variant_counts.get(variant, 0):
            fail(f"{variant}: {variant_counts.get(variant, 0)} launches "
                 f"counted, {launches} by shape")
        keys = ["ms", "plain_ms", "library_ms"]
        if variant == "sm90":
            keys.append("mma_sync_ms")
        tot = dict.fromkeys(keys, 0.0)
        flops = nbytes = 0.0
        for shape, n in shapes.items():
            for key in keys:
                tot[key] += n * by_shape[shape][key]
            _, _, f, b = bound(*shape)
            flops += n * f
            nbytes += n * b
        dt = next(iter(shapes))[5]
        t_ops = flops / PEAK_FLOPS[dt] * 1e3
        t_mem = nbytes / PEAK_BYTES_PER_S * 1e3
        entries.append({
            "name": f"flash_attention_{variant}",
            "route": "cuda",
            "source": SOURCES[variant],
            "replaces": REPLACES,
            "launches": launches,
            "max_abs_err": max(r["max_abs_err"] for r in rows
                               if r["variant"] == variant),
            **tot,
            "bound_ms": max(t_ops, t_mem),
            "bound_by": "operations" if t_ops >= t_mem else "bytes",
            "launches_by_shape": [
                {"B": s[0], "N": s[1], "M": s[2], "H": s[3], "D": s[4],
                 "dtype": s[5], "launches": n}
                for s, n in sorted(shapes.items())],
        })
    return entries


def main() -> int:
    try:
        import torch
    except ImportError:
        fail("torch is not installed")
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke runs on a "
             "CUDA card only")
    if not os.path.isdir(os.path.join(ROOT, "comfyui_distributed_tpu_torch")) \
            or not os.path.exists(WORKFLOW):
        fail("run chip_smoke.py from the root of a checkout")
    sys.path.insert(0, ROOT)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    print(card_line(), flush=True)

    from comfyui_distributed_tpu_torch.ops.kernels import build
    report = build.timed_build_all(force=True)
    emit("build", report)
    if report["problems"].get(SM90_SOURCE):
        fail(f"ptxas: {report['problems'][SM90_SOURCE]}")

    main_shapes = [
        (2, 4096, 4096, 10, 64, "torch.bfloat16", "self 64x64 latent"),
        (2, 1024, 1024, 20, 64, "torch.bfloat16", "self 32x32 latent"),
        (2, 4096, 77, 10, 64, "torch.bfloat16", "cross 64x64 latent"),
        (2, 1024, 77, 20, 64, "torch.bfloat16", "cross 32x32 latent"),
    ]
    extra_shapes = [
        (1, 1000, 77, 3, 64, "torch.bfloat16", "sm90: N % 128 != 0"),
        (1, 300, 300, 2, 64, "torch.bfloat16", "sm90: M % 128 != 0"),
        (2, 256, 7, 2, 64, "torch.bfloat16", "sm90: M < 16"),
        (1, 128, 128, 1, 64, "torch.bfloat16", "sm90: one batch-head"),
        (2, 40, 77, 3, 64, "torch.bfloat16", "sm90: N < 64"),
        (2, 200, 77, 2, 16, "torch.float32", "fp32 tiny, ragged"),
        (2, 256, 256, 2, 16, "torch.float32", "fp32 tiny self"),
        (1, 100, 50, 3, 16, "torch.bfloat16", "bf16 ragged N and M"),
        (1, 90, 33, 4, 32, "torch.bfloat16", "bf16 D = 32, ragged"),
        (1, 90, 33, 4, 32, "torch.float32", "fp32 D = 32, ragged"),
    ]
    rows = check_kernel(main_shapes + extra_shapes)
    emit("kernel_checks", rows)

    with open(WORKFLOW, "r", encoding="utf-8") as f:
        doc = json.load(f)
    emit("tiny_workflow", tiny_against_cpu(doc))

    requests, variant_counts, shape_counts = main_path(doc)
    emit("workflow", {"requests": requests,
                      "seconds": [r["seconds"] for r in requests],
                      "launches_per_request": [r["launches"]
                                               for r in requests]})
    emit("kernels", kernels_line(rows, variant_counts, shape_counts))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
