#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with a CUDA card (and
``nvcc``).  It imports nothing of JAX.  Phases, each fatal on failure:

1. the card's name and power limit (``nvidia-smi``);
2. build: every ``comfyui_distributed_tpu_torch/csrc/*.cu`` compiled for
   ``sm_90a`` anew, all at once, with ptxas' register, shared-memory and
   spill report; it fails if ptxas reports spills in any kernel (every
   ``flash_fwd_bf16``/``flash_fwd_f32`` instantiation and the sm90
   kernel), serialized ``wgmma`` instructions or an ignored
   ``setmaxnreg``;
3. kernel checks: the flash-attention kernels against their plain
   PyTorch version on the card at every shape the three paths below give
   them (SDXL's D = 64 and SD1.5's D = 40/80/160), plus the edges of
   both kernels (N and M not multiples of the tile, M < 16, one
   batch-head, N < 64), fp32 and the other head dims (bf16: relative
   error < 2e-2; fp32: absolute error < 2e-4, TF32 off).  The plain
   version runs in batch chunks, so its fp32 scores fit the card.  Each
   shape is timed beside the plain version, ``scaled_dot_product_attention``
   (a yardstick the port never calls), at bf16 D = 64 the older
   ``mma.sync`` kernel on the same inputs, and the least time the card
   could take (``bound_ms``).  Times are device times: the card is kept
   busy by a sleep kernel while the host enqueues, the candidates run in
   turns (forward, then reversed) and each time is the median of five
   rounds;
4. the tiny family on the card against the same runs on the CPU (plain
   versions): txt2img, img2img and the tiled upscale must agree within
   1e-3;
5. txt2img: ``workflows/distributed-txt2img.json`` unchanged (SDXL,
   1024^2, 20 euler/karras steps, cfg 7, virtual weights) through the
   port's WorkflowExecutor as three requests with three seeds; each must
   launch the sm90 kernel 2800 times (70 transformer blocks x 2
   attentions x 20 steps) and give a finite, non-constant
   (1, 1024, 1024, 3) image;
6. img2img: ``workflows/distributed-img2img.json`` unchanged (the 512^2
   test card of a missing input file, lanczos to 1024^2, SDXL encode,
   20 steps at denoise 0.6) as one request: 2800 sm90 launches, a finite,
   non-constant (1, 1024, 1024, 3) image;
7. upscale: ``workflows/distributed-upscale.json`` unchanged (SD1.5;
   the 512^2 test card, 4x RRDB to 2048^2, 16 tiles of 512^2 + 32 px
   refined as one batch, 20 euler/normal steps at denoise 0.35, cfg 8)
   as two requests, cold and warm: each exactly 640 ``mma_sync``
   launches (16 transformer blocks x 2 attentions x 20 steps) and a
   finite, non-constant (1, 2048, 2048, 3) image.

Launch counts are zeroed just before each request of phases 5-7 and
read just after.  The line before the last is ``{"kernels": [...]}``: for
each kernel variant those phases launched, its launches and, over exactly
those launches (each shape's measured time times its launch count),
``ms``, ``plain_ms``, ``library_ms``, ``bound_ms`` and, for sm90,
``mma_sync_ms``.  The last line is ``{"ok": true, "device": {...}}``.
Without a CUDA card, or outside a checkout, it exits non-zero before
printing any result.
"""

from __future__ import annotations

import copy
import json
import math
import os
import statistics
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
WORKFLOWS = {name: os.path.join(ROOT, "workflows", f"distributed-{name}.json")
             for name in ("txt2img", "img2img", "upscale")}
REPLACES = "comfyui_distributed_tpu/ops/pallas/flash_attention.py:134"
SOURCES = {
    "sm90": "comfyui_distributed_tpu_torch/csrc/flash_attention_sm90.cu",
    "mma_sync": "comfyui_distributed_tpu_torch/csrc/flash_attention.cu",
    "fp32": "comfyui_distributed_tpu_torch/csrc/flash_attention.cu",
}
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
# (variant, launches) of one request of each path
EXPECTED = {"txt2img": ("sm90", 2800), "img2img": ("sm90", 2800),
            "upscale": ("mma_sync", 640)}
# the plain version's fp32 scores of one batch chunk stay below this
PLAIN_CHUNK_BYTES = 2 << 30
# instantiations of csrc/flash_attention.cu that the upscale path and
# phases 3-4 launch
LAUNCHED_KERNELS = [f"flash_fwd_bf16<{d}>" for d in (16, 40, 80, 160)] \
    + [f"flash_fwd_f32<{d}>" for d in (16, 32, 40, 80, 160)]


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


def plain_in_chunks(q, k, v):
    """The plain version over batch chunks whose fp32 scores fit in
    PLAIN_CHUNK_BYTES (at (32, 4096, 4096, 8, 40) the whole batch's are
    17 GB)."""
    import torch

    from comfyui_distributed_tpu_torch.ops.kernels.flash_attention import (
        flash_attention_plain)
    B, N, H, _ = q.shape
    per = max(PLAIN_CHUNK_BYTES // (4 * H * N * k.shape[1]), 1)
    if per >= B:
        return flash_attention_plain(q, k, v)
    return torch.cat([flash_attention_plain(q[i:i + per], k[i:i + per],
                                            v[i:i + per])
                      for i in range(0, B, per)])


def check_kernel(shapes):
    """Phase 3: every shape against the plain version, timed."""
    import torch
    import torch.nn.functional as F

    from comfyui_distributed_tpu_torch.ops.kernels.flash_attention import (
        _launch_variant, flash_attention, kernel_variant)
    gen = torch.Generator(device=DEVICE).manual_seed(0)
    rows = []
    for B, N, M, H, D, dt, role in shapes:
        dtype = getattr(torch, dt.split(".")[1])
        variant = kernel_variant(dtype, D)

        def rnd(n):
            return torch.randn((B, n, H, D), generator=gen, device=DEVICE,
                               dtype=torch.float32).to(dtype)

        q, k, v = rnd(N), rnd(M), rnd(M)
        ref = plain_in_chunks(q, k, v)
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
               "plain_ms": (lambda: plain_in_chunks(q, k, v), 0.25)}
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


def small_docs(docs):
    """Phase 4's tiny-family runs: each workflow shrunk to a few steps
    and a small image."""
    txt = copy.deepcopy(docs["txt2img"])
    txt["5"]["inputs"].update(width=64, height=64)
    txt["3"]["inputs"]["steps"] = 4
    i2i = copy.deepcopy(docs["img2img"])
    i2i["2"]["inputs"].update(width=64, height=64)
    i2i["3"]["inputs"]["steps"] = 4
    up = copy.deepcopy(docs["upscale"])
    up["16"]["inputs"].update(width=128, height=128)
    up["2"]["inputs"].update(steps=2, tile_width=64, tile_height=64,
                             padding=8, mask_blur=2)
    return {"txt2img": txt, "img2img": i2i, "upscale": up}


def tiny_against_cpu(docs, input_dir):
    """Phase 4: the tiny family's txt2img, img2img and tiled upscale on
    the card against the CPU runs of the same graphs (kernels' plain
    versions).  The tiny RRDB runs in fp32 here: its bf16 convolutions
    round differently in cuDNN and on the CPU, which the refine then
    amplifies past 1e-3."""
    import dataclasses

    import numpy as np
    import torch

    from comfyui_distributed_tpu_torch.models import registry, upscalers
    from comfyui_distributed_tpu_torch.ops.base import OpContext
    from comfyui_distributed_tpu_torch.workflow import WorkflowExecutor
    os.environ["DTPU_DEFAULT_FAMILY"] = "tiny"
    tiny_rrdb = upscalers.TINY_RRDB_CONFIG
    upscalers.TINY_RRDB_CONFIG = dataclasses.replace(tiny_rrdb,
                                                     dtype=torch.float32)
    out = {}
    try:
        for name, doc in small_docs(docs).items():
            imgs = {dev: WorkflowExecutor(OpContext(
                device=dev, input_dir=input_dir)).execute(
                    copy.deepcopy(doc)).image_batch
                for dev in (DEVICE, "cpu")}
            card, host = imgs[DEVICE], imgs["cpu"]
            err = float(np.abs(card - host).max())
            if card.shape != host.shape or not err < 1e-3:
                fail(f"tiny {name} on the card disagrees with the CPU run: "
                     f"shapes {card.shape} {host.shape}, max err {err}")
            out[name] = {"shape": list(card.shape), "max_abs_err": err,
                         "atol": 1e-3}
    finally:
        del os.environ["DTPU_DEFAULT_FAMILY"]
        upscalers.TINY_RRDB_CONFIG = tiny_rrdb
        registry.clear_pipeline_cache()
    return out


def run_requests(path, doc, seeds, input_dir, shape_counts):
    """Phases 5-7: one request of ``path`` per seed, its launch counts
    zeroed just before it and read just after (and added to
    ``shape_counts``); returns the per-request report."""
    import numpy as np
    import torch

    from comfyui_distributed_tpu_torch.ops.base import OpContext
    from comfyui_distributed_tpu_torch.ops.kernels import flash_attention \
        as fa
    from comfyui_distributed_tpu_torch.workflow import WorkflowExecutor
    variant, want = EXPECTED[path]
    side = 2048 if path == "upscale" else 1024
    seed_node = next(n for n, node in doc.items() if isinstance(node, dict)
                     and node.get("class_type") in ("DistributedSeed",
                                                    "UltimateSDUpscaleDistributed"))
    requests = []
    for seed in seeds:
        req = copy.deepcopy(doc)
        req[seed_node]["inputs"]["seed"] = seed
        torch.cuda.reset_peak_memory_stats()
        fa.reset_counts()
        t0 = time.perf_counter()
        res = WorkflowExecutor(OpContext(device=DEVICE,
                                         input_dir=input_dir)).execute(req)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = fa.flash_attention.launches
        variants = dict(fa.flash_attention.variants)
        shape_counts.update(fa.flash_attention.shapes)
        img = res.image_batch
        finite = bool(img is not None and np.isfinite(img).all())
        std = float(img.std()) if img is not None else 0.0
        requests.append({
            "path": path, "seed": seed, "seconds": seconds,
            "node_seconds": {f"{k} {doc[k]['class_type']}": round(v, 4)
                             for k, v in res.timings.items()},
            "stage_seconds": {k: round(v, 4) for k, v in res.stages.items()},
            "shape": list(img.shape) if img is not None else None,
            "finite": finite, "std": std, "launches": launches,
            "variants": variants,
            "max_memory_allocated": torch.cuda.max_memory_allocated()})
        if img is None or img.shape != (1, side, side, 3) or not finite \
                or not std > 0.0:
            fail(f"{path} request seed {seed}: image shape "
                 f"{None if img is None else img.shape}, finite {finite}, "
                 f"std {std}")
        if launches != want or variants != {variant: want}:
            fail(f"{path} request seed {seed}: {launches} flash-attention "
                 f"launches {variants}; expected {want} {variant} launches")
    return requests


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
            or not all(os.path.exists(p) for p in WORKFLOWS.values()):
        fail("run chip_smoke.py from the root of a checkout")
    sys.path.insert(0, ROOT)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    print(card_line(), flush=True)

    from comfyui_distributed_tpu_torch.ops.kernels import build
    report = build.timed_build_all(force=True)
    emit("build", report)
    problems = {n: p for n, p in report["problems"].items() if p}
    if problems:
        fail(f"ptxas: {problems}")
    # the spill check above covers only what ptxas reported
    missing = [k for k in LAUNCHED_KERNELS
               if k not in report["ptxas"]["flash_attention"]]
    if missing:
        fail(f"ptxas reported nothing for {missing}")

    bf, f32 = "torch.bfloat16", "torch.float32"
    main_shapes = [
        (2, 4096, 4096, 10, 64, bf, "SDXL self 64x64 latent"),
        (2, 1024, 1024, 20, 64, bf, "SDXL self 32x32 latent"),
        (2, 4096, 77, 10, 64, bf, "SDXL cross 64x64 latent"),
        (2, 1024, 77, 20, 64, bf, "SDXL cross 32x32 latent"),
        # SD1.5 at B = 32: 16 tiles x (cond, uncond), 8 heads
        (32, 4096, 4096, 8, 40, bf, "SD1.5 self 64x64 latent"),
        (32, 4096, 77, 8, 40, bf, "SD1.5 cross 64x64 latent"),
        (32, 1024, 1024, 8, 80, bf, "SD1.5 self 32x32 latent"),
        (32, 1024, 77, 8, 80, bf, "SD1.5 cross 32x32 latent"),
        (32, 256, 256, 8, 160, bf, "SD1.5 self 16x16 latent"),
        (32, 256, 77, 8, 160, bf, "SD1.5 cross 16x16 latent"),
        (32, 64, 64, 8, 160, bf, "SD1.5 mid self 8x8 latent"),
        (32, 64, 77, 8, 160, bf, "SD1.5 mid cross 8x8 latent"),
    ]
    extra_shapes = [
        (1, 1000, 77, 3, 64, bf, "sm90: N % 128 != 0"),
        (1, 300, 300, 2, 64, bf, "sm90: M % 128 != 0"),
        (2, 256, 7, 2, 64, bf, "sm90: M < 16"),
        (1, 128, 128, 1, 64, bf, "sm90: one batch-head"),
        (2, 40, 77, 3, 64, bf, "sm90: N < 64"),
        (2, 200, 77, 2, 16, f32, "fp32 tiny, ragged"),
        (2, 256, 256, 2, 16, f32, "fp32 tiny self"),
        (1, 100, 50, 3, 16, bf, "bf16 ragged N and M"),
        (1, 90, 33, 4, 32, bf, "bf16 D = 32, ragged"),
        (1, 90, 33, 4, 32, f32, "fp32 D = 32, ragged"),
        (1, 100, 50, 3, 40, bf, "mma_sync D = 40: ragged N and M"),
        (2, 90, 7, 2, 80, bf, "mma_sync D = 80: M < 16"),
        (1, 33, 200, 2, 160, bf, "mma_sync D = 160: N < 64, ragged M"),
        (1, 5, 3, 1, 40, bf, "mma_sync D = 40: one batch-head, N, M < 16"),
        (1, 100, 50, 3, 40, f32, "fp32 D = 40, ragged"),
        (2, 90, 7, 2, 80, f32, "fp32 D = 80: two threads a row"),
        (1, 33, 200, 2, 160, f32, "fp32 D = 160: four threads a row"),
    ]
    rows = check_kernel(main_shapes + extra_shapes)
    emit("kernel_checks", rows)

    docs = {}
    for name, path in WORKFLOWS.items():
        with open(path, "r", encoding="utf-8") as f:
            docs[name] = json.load(f)
    import collections
    with tempfile.TemporaryDirectory() as input_dir:
        # an empty input dir: LoadImage synthesises its 512^2 test card
        emit("tiny_workflows", tiny_against_cpu(docs, input_dir))
        shape_counts = collections.Counter()
        requests = run_requests("txt2img", docs["txt2img"], SEEDS,
                                input_dir, shape_counts)
        requests += run_requests("img2img", docs["img2img"], SEEDS[:1],
                                 input_dir, shape_counts)
        requests += run_requests("upscale", docs["upscale"], (42, 43),
                                 input_dir, shape_counts)
    emit("workflow", {"requests": requests,
                      "seconds": [r["seconds"] for r in requests],
                      "launches_per_request": [r["launches"]
                                               for r in requests]})
    variant_counts = collections.Counter()
    for r in requests:
        variant_counts.update(r["variants"])
    emit("kernels", kernels_line(rows, dict(variant_counts),
                                 dict(shape_counts)))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
