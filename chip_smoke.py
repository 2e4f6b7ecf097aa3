#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with a CUDA card (and
``nvcc``).  It imports nothing of JAX.  Phases, each fatal on failure:

1. the card's name and power limit (``nvidia-smi``);
2. build: every ``comfyui_distributed_tpu_torch/csrc/*.cu`` compiled for
   ``sm_90a`` anew, all at once, with ptxas' register, shared-memory and
   spill report; it fails if ptxas reports spills in any kernel (every
   ``flash_fwd_bf16``/``flash_fwd_f32`` instantiation and every
   ``flash_fwd_sm90`` head dim), serialized ``wgmma`` instructions or an
   ignored ``setmaxnreg``;
3. kernel checks: the flash-attention kernels against their plain
   PyTorch version on the card at every shape the three paths below give
   them (SDXL's D = 64 and SD1.5's D = 40/80/160, all in the sm90
   kernel), plus the edges of both kernels at every head dim (N and M not
   multiples of the tile, M < 16, one batch-head, N < 64; the older
   ``mma.sync`` kernel's launched by name), fp32 and the tiny head dims
   (bf16: relative error < 2e-2; fp32: absolute error < 2e-4, TF32 off).
   The plain version runs in batch chunks, so its fp32 scores fit the
   card.  Each shape is timed beside the plain version,
   ``scaled_dot_product_attention`` (a yardstick the port never calls),
   at every sm90 shape the older ``mma.sync`` kernel on the same inputs,
   the least time the card could take (``bound_ms``) and the least time
   its SFUs could take for one exp2 a score (``exp2_ms``).  Times are
   device times: the card is kept busy by a sleep kernel while the host
   enqueues, the candidates run in turns (forward, then reversed) and
   each time is the median of five rounds;
4. the tiny family on the card against the same runs on the CPU (plain
   versions): txt2img, img2img, the tiled upscale, the SDXL workflow
   (``tiny_sdxl``, 4 dpmpp_2m steps) and txt2img from a tiny checkpoint
   file the port wrote must agree within 1e-3;
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
   as two requests, cold and warm: each exactly 640 ``sm90`` launches
   (16 transformer blocks x 2 attentions x 20 steps) and a finite,
   non-constant (1, 2048, 2048, 3) image;
8. the HTTP fan-out on one card: in-process txt2img at the two shares'
   seeds first; then the pipelines are released and a
   ``python -m comfyui_distributed_tpu_torch.cli serve`` master and a
   ``... worker`` start on free ports of 127.0.0.1 (own config, input
   and output directories, logs on file; both killed at the end), w0 is
   enabled through ``/distributed/config/update_worker``, and the two
   workflows, PreviewImage swapped for SaveImage, go to the master's
   ``/prompt`` cold and then warm.  Each request must fan out to
   ``["w0"]``; txt2img must save 2 images (seed s from the master, s + 1
   from the worker, over ``/distributed/job_complete``) and the upscale
   one 2048^2 image with tiles 8-15 over ``/distributed/tile_complete``;
   each server's log line must show exactly 2800 (txt2img) or 640
   (upscale) ``sm90`` launches for its share and no other variant; and
   each saved image must agree within ``FANOUT_ATOL`` with an in-process
   run in the same batches (the upscale's tiles 0-7 and 8-15 refined as
   two batches), and the upscale also with phase 7's one-batch image.
   It prints a ``fanout`` line.
9. SDXL dual prompt: ``workflows/distributed-sdxl.json`` unchanged
   (CLIPTextEncodeSDXL, 20 dpmpp_2m/karras steps, cfg 7, seed 777,
   virtual weights) as two requests, cold and warm, with an
   ``extra_pnginfo``: each exactly 2800 sm90 launches, a finite,
   non-constant (1, 1024, 1024, 3) image, the two equal to the bit, and
   a saved PNG whose text chunks are ``prompt`` and ``workflow``; the
   ADM vector built from node 3's conditioning differs from the one
   with a 512^2 target;
10. weights from disk: the free bytes of the directory first (it fails
   if the files cannot fit); SDXL base written from its virtual weights
   by the port's ``save_checkpoint`` (bf16 UNet and CLIP, fp32 VAE),
   phase 9's request run from that file, equal to phase 9's image to
   the bit; the file deleted, then SD1.5 written and the 4x RRDB saved
   as an old-arch ``.pth`` (``torch.save``), and phase 7's upscale at
   seed 42 run from the two files, equal to phase 7's image to the bit.
   Each write's and load's seconds, and the host's resident memory
   (anonymous and file-backed) at its peak during each load, go into a
   ``from_disk`` line.

Launch counts are zeroed just before each request of phases 5-7, 9 and
10 and read just after.  The line before the last is ``{"kernels":
[...]}``: for each kernel variant those phases launched, its launches
and, over exactly
those launches (each shape's measured time times its launch count),
``ms``, ``plain_ms``, ``library_ms``, ``bound_ms`` and, for sm90,
``mma_sync_ms``.  The last line is ``{"ok": true, "device": {...}}``.
Without a CUDA card, or outside a checkout, it exits non-zero before
printing any result.
"""

from __future__ import annotations

import collections
import copy
import json
import math
import os
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import threading
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
WORKFLOWS = {name: os.path.join(ROOT, "workflows", f"distributed-{name}.json")
             for name in ("txt2img", "img2img", "upscale", "sdxl")}
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
# exp2 on the SFUs: 16 a clock on each of 132 SMs at the 1.83 GHz behind
# the tensor-core peak
PEAK_EXP2_PER_S = 3.865e12
BF16_REL_BAR = 2e-2
FP32_ABS_BAR = 2e-4
SEEDS = (123456789, 987654321, 42)
DEVICE = "cuda"
# (variant, launches) of one request of each path
EXPECTED = {"txt2img": ("sm90", 2800), "img2img": ("sm90", 2800),
            "upscale": ("sm90", 640), "sdxl": ("sm90", 2800)}
# phase 9's request carries this UI workflow for SaveImage's PNG
EXTRA_PNGINFO = {"workflow": {"last_node_id": 9, "nodes": [],
                              "links": [], "version": 0.4}}
# the plain version's fp32 scores of one batch chunk stay below this
PLAIN_CHUNK_BYTES = 2 << 30
# phase 8: (max, mean) |difference| of a fan-out image from an
# in-process image, both as 8-bit files, in [0, 1].  "same": an
# in-process run whose batches are the fan-out's (each txt2img share is
# a batch of one; the upscale's tiles 0-7 and 8-15 each a batch of 8),
# measured equal to the bit on the card, the limit leaving room for one
# bf16 rounding flip; "one_batch": phase 7's upscale, all 16 tiles in
# one batch, whose other kernel choices move the image by a measured
# max 13/255 and mean 0.0053 (about half of these limits).
FANOUT_ATOL = {"same": (2 / 255, 1e-4), "one_batch": (0.1, 0.01)}
FANOUT_START_S = 180     # a server must answer /prompt within this
FANOUT_REQUEST_S = 300   # a fan-out request must finish within this
# source -> the instantiations that phases 3-7 launch
LAUNCHED_KERNELS = {
    "flash_attention_sm90": [f"flash_fwd_sm90<{d}>"
                             for d in (40, 64, 80, 160)],
    "flash_attention": [f"flash_fwd_bf16<{d}>"
                        for d in (16, 32, 40, 64, 80, 160)]
    + [f"flash_fwd_f32<{d}>" for d in (16, 32, 40, 80, 160)],
}


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


def exp2_ms(B, N, M, H, D, dtype):
    """ms the SFUs need for one exp2 a score of one launch."""
    return B * H * N * M / PEAK_EXP2_PER_S * 1e3


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
    for B, N, M, H, D, dt, role, *named in shapes:
        dtype = getattr(torch, dt.split(".")[1])
        # a row may name the kernel it launches (the older one at a head
        # dim the main path gives to sm90); else the main path's own
        variant = named[0] if named else kernel_variant(dtype, D)

        def rnd(n):
            return torch.randn((B, n, H, D), generator=gen, device=DEVICE,
                               dtype=torch.float32).to(dtype)

        q, k, v = rnd(N), rnd(M), rnd(M)
        ref = plain_in_chunks(q, k, v)
        errs = {}
        if named:
            outs = {"ms": lambda: _launch_variant(q, k, v, variant)}
        else:
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
               "exp2_ms": exp2_ms(B, N, M, H, D, dt), "named": bool(named),
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
    xl = copy.deepcopy(docs["sdxl"])
    xl["2"]["inputs"].update(width=64, height=64)
    xl["6"]["inputs"]["steps"] = 4
    from_file = copy.deepcopy(txt)
    from_file["4"]["inputs"]["ckpt_name"] = TINY_FILE
    return {"txt2img": txt, "img2img": i2i, "upscale": up, "sdxl": xl,
            "txt2img_from_file": from_file}


TINY_FILE = "tiny-from-disk.safetensors"


def tiny_against_cpu(docs, input_dir):
    """Phase 4: the tiny family's txt2img, img2img, tiled upscale, the
    SDXL graph (on ``tiny_sdxl``) and txt2img from a checkpoint file the
    port wrote, on the card against the CPU runs of the same graphs
    (kernels' plain versions).  The tiny RRDB runs in fp32 here: its
    bf16 convolutions round differently in cuDNN and on the CPU, which
    the refine then amplifies past 1e-3."""
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
    models_dir = tempfile.mkdtemp(prefix="tiny_models_")
    try:
        from comfyui_distributed_tpu_torch.models.checkpoints import (
            save_checkpoint)
        pipe = registry.load_pipeline("tiny-to-disk.safetensors",
                                      device="cpu")
        save_checkpoint(os.path.join(models_dir, TINY_FILE), pipe.unet,
                        pipe.clip_models, pipe.vae, pipe.family)
        for name, doc in small_docs(docs).items():
            os.environ["DTPU_DEFAULT_FAMILY"] = \
                "tiny_sdxl" if name == "sdxl" else "tiny"
            imgs = {dev: WorkflowExecutor(OpContext(
                device=dev, input_dir=input_dir,
                models_dir=models_dir)).execute(
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
        shutil.rmtree(models_dir, ignore_errors=True)
    return out


def run_requests(path, doc, seeds, input_dir, shape_counts, images=None,
                 results=None, **ctx_kw):
    """Phases 5-7, 9 and 10: one request of ``path`` per seed, its launch
    counts zeroed just before it and read just after (and added to
    ``shape_counts``); returns the per-request report, puts each seed's
    image into ``images`` and each run's result into ``results`` when
    given.  ``ctx_kw``: more of the run's OpContext (models_dir,
    output_dir, extra_pnginfo)."""
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
        res = WorkflowExecutor(OpContext(device=DEVICE, input_dir=input_dir,
                                         **ctx_kw)).execute(req)
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
        if images is not None:
            images[seed] = img[0]
        if results is not None:
            results.append(res)
    return requests


def totals(shapes, by_shape, keys):
    """Over ``shapes`` (shape -> launches): each key's measured ms times
    the launches, and the bound of that work."""
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
    return {**tot, "bound_ms": max(t_ops, t_mem),
            "bound_by": "operations" if t_ops >= t_mem else "bytes"}


def kernels_line(rows, variant_counts, shape_counts):
    """The contract's entries over phases 5-7's launches: one per kernel
    variant that they launched, each over exactly its shapes."""
    by_shape = {(r["B"], r["N"], r["M"], r["H"], r["D"], r["dtype"]): r
                for r in rows if not r.get("named")}
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
        entries.append({
            "name": f"flash_attention_{variant}",
            "route": "cuda",
            "source": SOURCES[variant],
            "replaces": REPLACES,
            "launches": launches,
            "max_abs_err": max(r["max_abs_err"] for r in rows
                               if r["variant"] == variant
                               and not r.get("named")),
            **totals(shapes, by_shape, keys),
            "launches_by_shape": [
                {"B": s[0], "N": s[1], "M": s[2], "H": s[3], "D": s[4],
                 "dtype": s[5], "launches": n}
                for s, n in sorted(shapes.items())],
        })
    return entries


def with_save_image(doc):
    """``doc`` with its PreviewImage swapped for SaveImage, nothing else
    changed."""
    doc = copy.deepcopy(doc)
    for node in doc.values():
        if isinstance(node, dict) and node.get("class_type") == "PreviewImage":
            node["class_type"] = "SaveImage"
    return doc


def image_diff(png_path, ref):
    """(max, mean) |pixel difference| in [0, 1] between a saved PNG and
    the 8-bit image of ``ref`` [H, W, 3]: 0 when the floats behind both
    round alike."""
    import numpy as np

    from comfyui_distributed_tpu_torch.utils.image import decode_png, to_uint8
    with open(png_path, "rb") as f:
        got = decode_png(f.read())[0]
    want = to_uint8(ref).astype(np.float32) / 255.0
    if got.shape != want.shape:
        fail(f"fan-out image {png_path}: shape {got.shape}, expected "
             f"{want.shape}")
    d = np.abs(got - want)
    return float(d.max()), float(d.mean())


class Cluster:
    """A ``cli serve`` master and a ``cli worker`` on free ports of
    127.0.0.1, each with its own config, input and output directories
    and log file under ``root``."""

    def __init__(self, root):
        from comfyui_distributed_tpu_torch.utils.net import find_free_port
        self.root = root
        self.procs, self.dirs, self.ports, self.logs = {}, {}, {}, {}
        for role in ("serve", "worker"):
            d = os.path.join(root, role)
            os.makedirs(os.path.join(d, "input"))
            self.dirs[role] = d
            self.ports[role] = find_free_port()
            self.logs[role] = os.path.join(d, "log.txt")

    def url(self, role):
        return f"http://127.0.0.1:{self.ports[role]}"

    def start(self):
        for role, d in self.dirs.items():
            with open(self.logs[role], "w") as log:
                self.procs[role] = subprocess.Popen(
                    [sys.executable, "-m", "comfyui_distributed_tpu_torch.cli",
                     role, "--host", "127.0.0.1",
                     "--port", str(self.ports[role]), "--device", DEVICE,
                     "--config", os.path.join(d, "cluster_config.json"),
                     "--input-dir", os.path.join(d, "input"),
                     "--output-dir", os.path.join(d, "output")],
                    cwd=ROOT, stdout=log, stderr=subprocess.STDOUT)
        from comfyui_distributed_tpu_torch.utils.net import get_json
        deadline = time.time() + FANOUT_START_S
        for role in self.dirs:
            while True:
                if self.procs[role].poll() is not None:
                    self.fail(f"{role} exited {self.procs[role].returncode}")
                try:
                    get_json(self.url(role) + "/prompt", timeout=2)
                    break
                except OSError:
                    if time.time() > deadline:
                        self.fail(f"{role} did not answer in "
                                  f"{FANOUT_START_S} s")
                    time.sleep(0.5)

    def prompt_lines(self, role):
        """The ``dtpu-torch prompt {...}`` lines of a server's log."""
        with open(self.logs[role], "r", errors="replace") as f:
            return [json.loads(ln.split(" ", 2)[2]) for ln in f
                    if ln.startswith("dtpu-torch prompt ")]

    def outputs(self):
        d = os.path.join(self.dirs["serve"], "output")
        return sorted(os.listdir(d)) if os.path.isdir(d) else []

    def fail(self, msg):
        for role, path in self.logs.items():
            try:
                with open(path, "r", errors="replace") as f:
                    tail = f.read()[-4000:]
            except OSError:
                tail = ""
            print(f"--- {role} log tail ---\n{tail}", file=sys.stderr)
        fail(f"fan-out: {msg}")

    def stop(self):
        for p in self.procs.values():
            if p.poll() is None:
                p.kill()
        for p in self.procs.values():
            p.wait()


def fanout_request(cluster, path, doc, want_launches, refs, checked):
    """One fan-out request of ``path`` through the master's /prompt; fails
    unless the worker took part, the counters and the saved images are
    what the fan-out gives, each server launched ``want_launches`` sm90
    and nothing else for its share, and every image agrees with its
    in-process references (``refs``: per image, {FANOUT_ATOL key:
    [H, W, 3] image}).  Every shape a server launched must be one that
    phase 3 checked (``checked``: shape -> its row); each share's
    attention is priced from those rows."""
    from comfyui_distributed_tpu_torch.utils.net import get_json, post_json
    master, worker = cluster.url("serve"), cluster.url("worker")
    m0 = get_json(master + "/distributed/metrics")
    n_lines = {r: len(cluster.prompt_lines(r)) for r in ("serve", "worker")}
    files0 = set(cluster.outputs())
    t0 = time.perf_counter()
    resp = post_json(master + "/prompt", {"prompt": doc,
                                          "client_id": "chip_smoke"})
    if resp.get("workers") != ["w0"] or resp.get("failed_workers") != []:
        cluster.fail(f"{path}: the master did not fan out to w0: {resp}")
    pid = resp["prompt_id"]
    deadline = time.time() + FANOUT_REQUEST_S
    # the worker's GET /prompt (the preflight probe, 0.3 s) while both
    # servers fill weights and sample: the handler threads must answer
    probe_s = []
    while True:
        hist = get_json(master + "/history")
        if pid in hist:
            break
        if time.time() > deadline:
            cluster.fail(f"{path}: no history after {FANOUT_REQUEST_S} s")
        t1 = time.perf_counter()
        get_json(worker + "/prompt", timeout=10)
        probe_s.append(time.perf_counter() - t1)
        time.sleep(0.05)
    seconds = time.perf_counter() - t0
    entry = hist[pid]
    m1 = get_json(master + "/distributed/metrics")
    if entry.get("status") != "success" or entry.get("images") != len(refs):
        cluster.fail(f"{path}: history {entry}, expected success with "
                     f"{len(refs)} images")
    got = {k: m1[k] - m0[k] for k in ("images_received", "tiles_received",
                                      "wire_tensor_bytes", "wire_png_bytes",
                                      "wire_tensor_msgs", "wire_png_msgs")}
    want = {"images_received": 1, "tiles_received": 0}
    if path == "upscale":
        # the worker's part of partition_tiles(tiles, 1): 8 of 16
        from comfyui_distributed_tpu_torch.ops import tiling
        size, p = doc["16"]["inputs"], doc["2"]["inputs"]
        n = len(tiling.calculate_tiles(size["width"], size["height"],
                                       p["tile_width"], p["tile_height"]))
        want = {"images_received": 0,
                "tiles_received": len(tiling.partition_tiles(n, 1)[1])}
    if any(got[k] != v for k, v in want.items()):
        cluster.fail(f"{path}: the master received {got}, expected {want}")
    # the worker's line follows its last upload, so it may come last
    shares = {}
    while True:
        lines = {r: cluster.prompt_lines(r)[n_lines[r]:]
                 for r in ("serve", "worker")}
        if all(lines.values()):
            break
        if time.time() > deadline:
            cluster.fail(f"{path}: no prompt line in {lines}")
        time.sleep(0.05)
    for role, new in lines.items():
        share = shares[role] = new[0]
        if share["status"] != "success" or share["launches"] != {
                "sm90": want_launches, "mma_sync": 0, "fp32": 0}:
            cluster.fail(f"{path}: {role}'s share {share}; expected "
                         f"{want_launches} sm90 launches")
        by_shape = {tuple(s[:6]): s[6] for s in share["launches_by_shape"]}
        missing = [s for s in by_shape if s not in checked]
        if missing:
            cluster.fail(f"{path}: {role} launched shapes that phase 3 did "
                         f"not check: {missing}")
        share["attention"] = totals(by_shape, checked, [
            "ms", "plain_ms", "library_ms"]) if by_shape else None
    new_files = sorted(set(cluster.outputs()) - files0)
    if len(new_files) != len(refs):
        cluster.fail(f"{path}: {len(new_files)} new PNGs {new_files}, "
                     f"expected {len(refs)}")
    paths = [os.path.join(cluster.dirs["serve"], "output", f)
             for f in new_files]
    diffs = [{key: image_diff(f, ref) for key, ref in r.items()}
             for f, r in zip(paths, refs)]
    for f, d in zip(new_files, diffs):
        for key, (dmax, dmean) in d.items():
            tol_max, tol_mean = FANOUT_ATOL[key]
            if not (dmax <= tol_max and dmean <= tol_mean):
                cluster.fail(f"{path}: {f} differs from the {key!r} "
                             f"in-process image by max {dmax}, mean {dmean} "
                             f"(limits {tol_max}, {tol_mean})")
    # a yardstick: image 0 against the other seed's image
    wrong = image_diff(paths[0], refs[-1]["same"]) if len(refs) > 1 \
        else None
    return {"path": path, "prompt_id": pid, "seconds": seconds,
            "files": new_files, "master_received": got,
            "abs_diff": [{key: {"max": v[0], "mean": v[1]}
                          for key, v in d.items()} for d in diffs],
            "wrong_seed_diff": wrong,
            "worker_probe_s": {"n": len(probe_s),
                               "max": max(probe_s, default=None),
                               "median": statistics.median(probe_s)
                               if probe_s else None},
            "shares": {r: {k: s.get(k) for k in (
                "seconds", "launches", "launches_by_shape", "attention",
                "max_memory_allocated", "node_seconds", "stage_seconds")}
                for r, s in shares.items()}}


def fanout(docs, input_dir, upscale_ref, rows):
    """Phase 8: the HTTP fan-out on one card.  The in-process images of
    the two txt2img shares and of the upscale in the fan-out's two tile
    batches first; then the pipelines are released and a master and a
    worker server start; parallel SDXL generation and the distributed
    SD1.5 upscale each run cold and warm.  ``rows``: phase 3's checks."""
    import gc

    import torch

    from comfyui_distributed_tpu_torch.models import registry
    from comfyui_distributed_tpu_torch.ops.base import OpContext
    from comfyui_distributed_tpu_torch.ops.kernels import flash_attention \
        as fa
    from comfyui_distributed_tpu_torch.ops import tiling
    from comfyui_distributed_tpu_torch.ops.tiled_upscale import (
        UltimateSDUpscaleDistributed as Upscaler)
    from comfyui_distributed_tpu_torch.utils.net import post_json
    from comfyui_distributed_tpu_torch.workflow import WorkflowExecutor

    def run(doc):
        return WorkflowExecutor(OpContext(
            device=DEVICE, input_dir=input_dir)).execute(doc).image_batch[0]

    checked = {(r["B"], r["N"], r["M"], r["H"], r["D"], r["dtype"]): r
               for r in rows if not r.get("named")}
    seed = SEEDS[0]
    txt_refs = []
    for s in (seed, seed + 1):   # the master's share, the worker's
        req = copy.deepcopy(docs["txt2img"])
        req["13"]["inputs"]["seed"] = s
        txt_refs.append({"same": run(req)})
    # the upscale with its tiles refined in the fan-out's batches:
    # partition_tiles(16, 1), tiles 0-7 then 8-15
    whole = Upscaler._refine_tiles

    def in_parts(self, ctx, pipe, image, all_tiles, indices, *a):
        out = {}
        for part in tiling.partition_tiles(len(indices), 1):
            out.update(whole(self, ctx, pipe, image, all_tiles,
                             [indices[i] for i in part], *a))
        return out

    Upscaler._refine_tiles = in_parts
    try:
        up_ref = run(copy.deepcopy(docs["upscale"]))
    finally:
        Upscaler._refine_tiles = whole
    fa.reset_counts()
    registry.clear_pipeline_cache()
    gc.collect()
    torch.cuda.empty_cache()
    free, total = torch.cuda.mem_get_info()
    print(f"phase 8: {free} of {total} bytes of device memory free before "
          f"the servers start", flush=True)
    txt = with_save_image(docs["txt2img"])
    txt["13"]["inputs"]["seed"] = seed
    up = with_save_image(docs["upscale"])
    up["2"]["inputs"]["seed"] = 42
    requests = []
    with tempfile.TemporaryDirectory() as root:
        cluster = Cluster(root)
        try:
            t0 = time.perf_counter()
            cluster.start()
            started_s = time.perf_counter() - t0
            post_json(cluster.url("serve")
                      + "/distributed/config/update_worker",
                      {"id": "w0", "name": "w0",
                       "port": cluster.ports["worker"], "enabled": True})
            for path, doc, want, refs in (
                    ("txt2img", txt, EXPECTED["txt2img"][1], txt_refs),
                    ("upscale", up, EXPECTED["upscale"][1],
                     [{"same": up_ref, "one_batch": upscale_ref}])):
                for run in ("cold", "warm"):
                    r = fanout_request(cluster, path, copy.deepcopy(doc),
                                       want, refs, checked)
                    requests.append({"run": run, **r})
        finally:
            cluster.stop()
    return {"free_bytes_before": free, "servers_start_s": started_s,
            "cudnn_benchmark": torch.backends.cudnn.benchmark,
            "atol": {k: {"max": v[0], "mean": v[1]}
                     for k, v in FANOUT_ATOL.items()},
            "requests": requests,
            "seconds": {f"{r['path']} {r['run']}": r["seconds"]
                        for r in requests},
            "peak_memory": {f"{r['path']} {r['run']}": {
                role: s["max_memory_allocated"]
                for role, s in r["shares"].items()} for r in requests}}


def png_text_chunks(path):
    """[(key, value)] of a PNG's tEXt chunks, in file order."""
    with open(path, "rb") as f:
        data = f.read()
    out, pos = [], 8
    while pos + 8 <= len(data):
        n = int.from_bytes(data[pos:pos + 4], "big")
        kind, body = data[pos + 4:pos + 8], data[pos + 8:pos + 8 + n]
        if kind == b"tEXt":
            key, _, value = body.partition(b"\0")
            out.append((key.decode("latin-1"), value.decode("latin-1")))
        pos += 12 + n
    return out


def sdxl_requests(doc, input_dir, shape_counts):
    """Phase 9: ``distributed-sdxl.json`` cold and warm; returns (the
    report, the requests, the image)."""
    import dataclasses

    import numpy as np
    import torch

    from comfyui_distributed_tpu_torch.ops.basic import \
        _prepare_sample_inputs
    images, results = {}, []
    with tempfile.TemporaryDirectory() as out_dir:
        requests = []
        for run in ("cold", "warm"):
            requests += run_requests("sdxl", doc, (777,), input_dir,
                                     shape_counts, images, results,
                                     output_dir=out_dir,
                                     extra_pnginfo=EXTRA_PNGINFO)
            requests[-1]["run"] = run
            if run == "cold":
                first = images[777]
        saved = sorted(os.listdir(out_dir))
        if saved != ["sdxl_00000.png", "sdxl_00001.png"]:
            fail(f"sdxl: SaveImage wrote {saved}")
        chunks = png_text_chunks(os.path.join(out_dir, saved[0]))
    keys = [k for k, _ in chunks]
    if keys != ["prompt", "workflow"] \
            or json.loads(chunks[1][1]) != EXTRA_PNGINFO["workflow"] \
            or json.loads(chunks[0][1])["3"]["class_type"] \
            != "CLIPTextEncodeSDXL":
        fail(f"sdxl: the PNG's text chunks are {keys}: "
             f"{[v[:80] for _, v in chunks]}")
    if not np.array_equal(first, images[777]):
        fail("sdxl: the warm request's image differs from the cold one's")
    # the size scalars reach the UNet: node 3's ADM vector against the
    # one with a 512^2 target
    res = results[-1]
    pipe, cond = res.outputs["1"][0], res.outputs["3"][0]
    lat = res.outputs["2"][0]
    y = _prepare_sample_inputs(pipe, 777, lat, cond, cond).y
    y512 = _prepare_sample_inputs(
        pipe, 777, lat, dataclasses.replace(
            cond, size_cond=cond.size_cond[:4] + (512, 512)), cond).y
    adm_diff = float((y - y512).abs().max())
    if cond.size_cond != (1024, 1024, 0, 0, 1024, 1024) \
            or y.shape != (1, 2816) or not adm_diff > 0:
        fail(f"sdxl: size scalars {cond.size_cond}, ADM {tuple(y.shape)}, "
             f"difference from a 512^2 target {adm_diff}")
    torch.cuda.synchronize()
    return ({"png_text_chunks": [k for k, _ in chunks],
             "adm_max_diff_vs_512_target": adm_diff,
             "cold_equals_warm": True,
             "seconds": {r["run"]: r["seconds"] for r in requests}},
            requests, images[777])


class HostMemory:
    """The process's peak resident bytes while the block runs, sampled
    every 20 ms from ``/proc/self/status``: ``VmRSS``, and its anonymous
    and file-backed parts where the kernel reports them."""

    KEYS = ("VmRSS", "RssAnon", "RssFile")

    @classmethod
    def now(cls):
        out = {}
        with open("/proc/self/status") as f:
            for line in f:
                key, _, value = line.partition(":")
                if key in cls.KEYS:
                    out[key] = int(value.split()[0]) * 1024
        return out

    def __enter__(self):
        self.before = self.now()
        self.peak = dict(self.before)
        self._stop = threading.Event()

        def sample():
            while not self._stop.wait(0.02):
                for k, v in self.now().items():
                    self.peak[k] = max(self.peak.get(k, 0), v)

        self._thread = threading.Thread(target=sample, daemon=True)
        self._thread.start()
        return self

    def __exit__(self, *exc):
        self._stop.set()
        self._thread.join()
        for k, v in self.now().items():
            self.peak[k] = max(self.peak.get(k, 0), v)

    def report(self):
        return {**{f"{k}_before": v for k, v in self.before.items()},
                **{f"{k}_peak": v for k, v in self.peak.items()}}


def models_dir_root():
    """The directory for phase 10's files: whichever of the temporary
    directory and the checkout has more free bytes."""
    cands = {d: shutil.disk_usage(d).free
             for d in (tempfile.gettempdir(), ROOT)}
    return max(cands, key=cands.get), cands


def rrdb_old_arch(net):
    """The port's RRDB parameters under the old ESRGAN arch's keys
    (``model.N``, ``model.1.sub.i.RDBj.convk.0``)."""
    n = net.cfg.num_blocks
    ups = [f"up_{i}" for i in range({1: 0, 2: 1, 4: 2, 8: 3}[net.cfg.scale])]
    tail = ups + ["hr_conv", "conv_last"]
    # 4x: model.3, 6 (upconvs), 8 (HRconv), 10 (conv_last)
    index = {name: 3 + 3 * i for i, name in enumerate(ups)}
    index["hr_conv"] = 2 + 3 * len(ups)
    index["conv_last"] = 4 + 3 * len(ups)
    out = {}
    for name, t in net.state_dict().items():
        mod, leaf = name.rsplit(".", 1)
        parts = mod.split(".")
        if mod == "conv_first":
            key = "model.0"
        elif mod == "trunk_conv":
            key = f"model.1.sub.{n}"
        elif parts[0].startswith("rrdb_"):
            i, j, k = (int(re.sub(r"\D", "", p)) for p in parts)
            key = f"model.1.sub.{i}.RDB{j + 1}.conv{k + 1}.0"
        elif mod in tail:
            key = f"model.{index[mod]}"
        else:
            fail(f"rrdb: no old-arch key for {name}")
        out[f"{key}.{leaf}"] = t.detach().cpu().clone()
    return out


def from_disk(docs, input_dir, shape_counts, sdxl_img, upscale_img):
    """Phase 10: SDXL base, then SD1.5 and the 4x RRDB, written from
    their virtual weights by the port and read back by its loaders; the
    requests must give phase 9's and phase 7's images to the bit."""
    import gc

    import numpy as np
    import torch

    from comfyui_distributed_tpu_torch.models import registry
    from comfyui_distributed_tpu_torch.models.checkpoints import (
        save_checkpoint)

    def nbytes(*modules):
        return sum(p.numel() * p.element_size() for m in modules
                   for p in m.parameters())

    def release():
        registry.clear_pipeline_cache()
        gc.collect()
        torch.cuda.empty_cache()

    root, free = models_dir_root()
    print(f"phase 10: free bytes {json.dumps(free)}; files go under {root}",
          flush=True)
    report, requests = {"free_bytes": free, "dir": root}, []
    models_dir = tempfile.mkdtemp(prefix="chip_smoke_models_", dir=root)
    try:
        # SDXL base: bf16 UNet and CLIP, fp32 VAE
        xl_name = docs["sdxl"]["1"]["inputs"]["ckpt_name"]
        pipe = registry.load_pipeline(xl_name, device=DEVICE)
        need = nbytes(pipe.unet, pipe.vae, *pipe.clip_models)
        if shutil.disk_usage(models_dir).free < need + (1 << 30):
            fail(f"phase 10 needs {need} bytes and 1 GiB to spare for "
                 f"{xl_name} in {models_dir}; "
                 f"{shutil.disk_usage(models_dir).free} are free")
        path = os.path.join(models_dir, xl_name)
        t0 = time.perf_counter()
        save_checkpoint(path, pipe.unet, pipe.clip_models, pipe.vae,
                        pipe.family)
        report["sdxl_write_s"] = time.perf_counter() - t0
        report["sdxl_file_bytes"] = os.path.getsize(path)
        del pipe
        release()
        images, results = {}, []
        with HostMemory() as mem:
            requests += run_requests("sdxl", docs["sdxl"], (777,), input_dir,
                                     shape_counts, images, results,
                                     models_dir=models_dir)
        requests[-1]["run"] = "from_disk"
        report["sdxl_load_s"] = results[-1].timings["1"]
        report["sdxl_host_memory"] = mem.report()
        report["sdxl_request_s"] = requests[-1]["seconds"]
        if not np.array_equal(images[777], sdxl_img):
            fail("phase 10: SDXL from its file differs from phase 9's "
                 f"image (max {np.abs(images[777] - sdxl_img).max()})")
        del results
        release()
        os.remove(path)
        # SD1.5 and the 4x RRDB (old-arch .pth)
        up_doc = docs["upscale"]
        sd_name = up_doc["4"]["inputs"]["ckpt_name"]
        up_name = up_doc["14"]["inputs"]["model_name"]
        pipe = registry.load_pipeline(sd_name, device=DEVICE)
        t0 = time.perf_counter()
        save_checkpoint(os.path.join(models_dir, sd_name), pipe.unet,
                        pipe.clip_models, pipe.vae, pipe.family)
        report["sd15_write_s"] = time.perf_counter() - t0
        report["sd15_file_bytes"] = os.path.getsize(
            os.path.join(models_dir, sd_name))
        up = registry.load_upscaler(up_name, device=DEVICE)
        t0 = time.perf_counter()
        torch.save(rrdb_old_arch(up.net), os.path.join(models_dir, up_name))
        report["rrdb_write_s"] = time.perf_counter() - t0
        report["rrdb_file_bytes"] = os.path.getsize(
            os.path.join(models_dir, up_name))
        del pipe, up
        release()
        images, results = {}, []
        with HostMemory() as mem:
            requests += run_requests("upscale", up_doc, (42,), input_dir,
                                     shape_counts, images, results,
                                     models_dir=models_dir)
        requests[-1]["run"] = "from_disk"
        report["sd15_load_s"] = results[-1].timings["4"]
        report["rrdb_load_s"] = results[-1].timings["14"]
        report["upscale_host_memory"] = mem.report()
        report["upscale_request_s"] = requests[-1]["seconds"]
        if not np.array_equal(images[42], upscale_img):
            fail("phase 10: the upscale from files differs from phase 7's "
                 f"image (max {np.abs(images[42] - upscale_img).max()})")
        del results
        release()
    finally:
        shutil.rmtree(models_dir, ignore_errors=True)
    report["equal_to_virtual"] = True
    return report, requests


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
    missing = [k for src, names in LAUNCHED_KERNELS.items() for k in names
               if k not in report["ptxas"][src]]
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
        # phase 8's upscale shares: 8 tiles x (cond, uncond) a server
        (16, 4096, 4096, 8, 40, bf, "SD1.5 share self 64x64 latent"),
        (16, 4096, 77, 8, 40, bf, "SD1.5 share cross 64x64 latent"),
        (16, 1024, 1024, 8, 80, bf, "SD1.5 share self 32x32 latent"),
        (16, 1024, 77, 8, 80, bf, "SD1.5 share cross 32x32 latent"),
        (16, 256, 256, 8, 160, bf, "SD1.5 share self 16x16 latent"),
        (16, 256, 77, 8, 160, bf, "SD1.5 share cross 16x16 latent"),
        (16, 64, 64, 8, 160, bf, "SD1.5 share mid self 8x8 latent"),
        (16, 64, 77, 8, 160, bf, "SD1.5 share mid cross 8x8 latent"),
    ]
    extra_shapes = [
        # the sm90 kernel's edges at SD1.5's head dims: N off the Q tile
        # (192 rows at D = 40, 128 else), M off the K/V stage (128 keys,
        # 64 at D = 160), M < 16, N < 64, one batch-head
        (1, 1000, 77, 3, 40, bf, "sm90 D = 40: N % 192 != 0"),
        (1, 300, 300, 2, 40, bf, "sm90 D = 40: M % 128 != 0"),
        (2, 256, 7, 2, 40, bf, "sm90 D = 40: M < 16"),
        (2, 40, 77, 3, 40, bf, "sm90 D = 40: N < 64"),
        (1, 192, 192, 1, 40, bf, "sm90 D = 40: one batch-head"),
        (1, 1000, 77, 3, 80, bf, "sm90 D = 80: N % 128 != 0"),
        (1, 300, 300, 2, 80, bf, "sm90 D = 80: M % 128 != 0"),
        (2, 256, 7, 2, 80, bf, "sm90 D = 80: M < 16"),
        (2, 40, 77, 3, 80, bf, "sm90 D = 80: N < 64"),
        (1, 128, 128, 1, 80, bf, "sm90 D = 80: one batch-head"),
        (1, 300, 77, 3, 160, bf, "sm90 D = 160: N % 128 != 0"),
        (1, 200, 100, 2, 160, bf, "sm90 D = 160: M % 64 != 0"),
        (2, 256, 7, 2, 160, bf, "sm90 D = 160: M < 16"),
        (2, 40, 77, 3, 160, bf, "sm90 D = 160: N < 64"),
        (1, 128, 128, 1, 160, bf, "sm90 D = 160: one batch-head"),
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
        (1, 100, 50, 3, 40, bf, "mma_sync D = 40: ragged N and M",
         "mma_sync"),
        (2, 90, 7, 2, 80, bf, "mma_sync D = 80: M < 16", "mma_sync"),
        (1, 33, 200, 2, 160, bf, "mma_sync D = 160: N < 64, ragged M",
         "mma_sync"),
        (1, 5, 3, 1, 40, bf, "mma_sync D = 40: one batch-head, N, M < 16",
         "mma_sync"),
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
    with tempfile.TemporaryDirectory() as input_dir:
        # an empty input dir: LoadImage synthesises its 512^2 test card
        emit("tiny_workflows", tiny_against_cpu(docs, input_dir))
        shape_counts = collections.Counter()
        requests = run_requests("txt2img", docs["txt2img"], SEEDS,
                                input_dir, shape_counts)
        requests += run_requests("img2img", docs["img2img"], SEEDS[:1],
                                 input_dir, shape_counts)
        upscaled = {}
        requests += run_requests("upscale", docs["upscale"], (42, 43),
                                 input_dir, shape_counts, upscaled)
        emit("workflow", {"requests": requests,
                          "seconds": [r["seconds"] for r in requests],
                          "launches_per_request": [r["launches"]
                                                   for r in requests]})
        emit("fanout", fanout(docs, input_dir, upscaled[42], rows))
        sdxl_report, sdxl_reqs, sdxl_img = sdxl_requests(
            docs["sdxl"], input_dir, shape_counts)
        requests += sdxl_reqs
        emit("sdxl", sdxl_report)
        disk_report, disk_reqs = from_disk(docs, input_dir, shape_counts,
                                           sdxl_img, upscaled[42])
        requests += disk_reqs
        emit("from_disk", disk_report)
        emit("workflow_9_10", {"requests": sdxl_reqs + disk_reqs})
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
