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
   PyTorch version on the card at every shape the paths below give them
   (SDXL's D = 64 at 1024^2, 832^2 and 1216^2, the SDXL refiner's 12 and
   24 heads, SD1.5's D = 40/80/160 at B = 32 and 16 for the upscale
   and at B = 12 and 10 for phase 14's shares, hedges and reassignments,
   at B = 2 for the inpaint requests at 512^2 and 768 x 512 and at B = 3
   for the regional request, and SD2.1's 5/10/20 heads of 64 at 768^2,
   all in the sm90 kernel), plus the edges of both kernels at every head dim
   (N and M not multiples of the tile, M < 16, one batch-head, N < 64;
   the older ``mma.sync`` kernel's launched by name), fp32 and the tiny
   head dims (bf16: relative error < 2e-2; fp32: absolute error < 2e-4,
   TF32 off).
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
   (``tiny_sdxl``, 4 dpmpp_2m steps), txt2img from a tiny checkpoint
   file the port wrote, and the refiner and hires-fix workflows shrunk
   (each checkpoint name on a tiny stand-in of its family: a two-tower
   base with an ADM head, a one-tower OpenCLIP refiner under the
   refiner's checkpoint prefix), and the three inpaint workflows shrunk
   (``tiny``, and ``tiny_inpaint`` for the inpaint model; 64 px, 3
   steps, their own small RGBA inputs), and the regional (``tiny``),
   ip2p (``tiny_ip2p`` and the tiny VAE and text tower by their names)
   and unclip (``tiny_unclip``) workflows shrunk, on small inputs of
   their own, must agree within 1e-3 (the unclip run on the card takes
   the CPU run's image embedding, as the unCLIP noise is keyed by its
   bytes, and the card's own embedding must agree within 1e-3 too);
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
   and output directories, logs on file; both killed at the end; the
   master with ``DTPU_HEDGE=0``, so no tile is hedged), w0 is
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
   It prints a ``fanout`` line, with the pipelined upload's split: the
   worker's encode and POST seconds and the master's decode seconds.
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
11. staged SDXL: ``workflows/distributed-sdxl-refiner.json`` (SDXL base
   then the SDXL refiner: KSamplerAdvanced windows 0-18 and 18-24 of 24
   euler/normal steps, the leftover noise handed on) and
   ``workflows/distributed-hires-fix.json`` (the virtual LoRA, clip-skip
   -2, 14 of 20 euler/karras steps at 832^2, a nearest-exact latent
   upscale to 1216^2, steps 14-20 there), unchanged with virtual
   weights, each cold (every pipeline released first) and then warm:
   exactly 3048 (refiner: 18 x 70 x 2 + 6 x 44 x 2) and 2800 (hires-fix:
   14 x 70 x 2 + 6 x 70 x 2) sm90 launches a request, finite,
   non-constant (1, 1024, 1024, 3) and (1, 1216, 1216, 3) images, the
   cold and the warm image equal to the bit; the LoRA-patched pipeline
   must share the base's UNet.  It prints a ``staged`` line.
12. inpainting: ``workflows/distributed-inpaint.json`` (SD1.5,
   VAEEncodeForInpaint with a grown mask), ``distributed-outpaint.json``
   (ImagePadForOutpaint to 768 x 512) and ``distributed-inpaint-model.json``
   (the 9-channel ``sd15_inpaint`` family, LoadImageMask,
   InpaintModelConditioning), unchanged with virtual weights, each cold
   (every pipeline released first) and then warm, on inputs this script
   writes with the port's PNG writer (a 640 x 480 ``input.png`` and a
   512^2 ``source.png``, both RGBA with a transparent region): exactly
   640 sm90 launches a request (16 x 2 x 20) at shapes phase 3 checked,
   finite, non-constant images of 512^2 (the outpaint 768 wide, 512
   high), the warm image equal to the cold one to the bit, and the
   sampled latent equal to the encoded source to the bit where the
   latent mask is 0 and different where it is 1.  It prints a
   ``phase12`` line for each request.
13. regional, ip2p and unclip: ``workflows/distributed-regional.json``
   (SD1.5 at 512^2, two prompts on canvas halves and the uncond in one
   stacked call, 20 euler/karras steps), ``distributed-ip2p.json`` (the
   split loaders, the 8-channel ``sd15_ip2p`` UNet on a 512^2
   ``input.png``, 12 steps) and ``distributed-unclip.json``
   (``sd21_unclip``, v-prediction, the ViT-H image embedding of a
   640 x 512 ``concept.png``, 20 dpmpp_2m steps at 768^2), unchanged
   with virtual weights on inputs this script writes, each cold (every
   pipeline released first) and then warm: exactly 640, 384 and 640 sm90
   launches a request at shapes phase 3 checked, finite, non-constant
   images, the warm image equal to the cold one to the bit; each half of
   the regional latent closer (mean |difference|) to a run with its own
   prompt alone than to one with the other half's prompt alone, the
   ip2p latent different from a sampling with zero concat channels, and
   the unclip image from one at noise_augmentation 0.5.  It prints a ``phase13`` line for each
   request and a ``phase13_report`` line.

14. the control plane's fault drills: the in-process inpaint images of
   three seed slices first; then the pipelines are released (it fails
   unless ``DRILL_MIN_FREE`` bytes of device memory are free) and a
   ``cli serve`` master and two ``cli worker``s, w0 and w1, start (leases
   of ``DRILL_LEASE_S``, one failed probe for suspect, the master's
   hedge wait ``DRILL_HEDGE_MIN_WAIT_S``), the workers registering
   themselves through ``DTPU_MASTER_URL``/``DTPU_WORKER_ID``.  Drill 1:
   the upscale (seed 42, cold) with w1 started stalling
   ``DRILL_STALL_S`` before its first tile: the master hedges w1's 5
   tiles and its late uploads are refused.  Drill 2: the upscale again,
   w1's pid killed (SIGKILL) as soon as /prompt returns: its tiles are
   reassigned.  Drill 3: w1 restarted without a fault, the inpaint
   fan-out (three seed slices), w1 killed after dispatch: its slice is
   redispatched to w0.  Each drill must end in success with every
   ledger unit checked in and the lost units reassigned or hedged, w1
   dead after a kill, every server's launches sm90 at shapes phase 3
   checked, the upscale within ``FANOUT_ATOL["one_batch"]`` of phase 7's
   image and the three inpaint images within ``FANOUT_ATOL["same"]`` of
   the in-process ones.  It prints a ``drill`` line for each (seconds
   from the stall or the kill to the success, the request's seconds,
   each server's peak memory, the ledger's summary) and a ``phase14``
   line.
15. worker management and the control routes: the pipelines released,
   a ``cli serve`` master starts in its own directory with w0 in its
   config (local, enabled, not running).  (1) ``POST
   /distributed/launch_worker`` starts w0 under the master-death
   monitor; ``managed_workers`` shows it alive and its ``launching``
   must clear (the health poller's first contact) within
   ``PHASE15_READY_S``; its log holds the session header and its
   ``listening`` line.  (2) A cold ``distributed-txt2img.json`` fan-out
   (SaveImage) to ``["w0"]``, checked as phase 8 checks it against
   phase 8's in-process images.  (3) With w0 disabled, the master alone:
   one request to time by, one with ``POST /interrupt`` half that run's
   KSampler seconds after the master logs the KSampler's start (its
   debug tier's ``exec node`` line, on through the config's
   ``settings.debug``), which must end as ``execution interrupted``
   within ``PHASE15_INTERRUPT_END_S`` with ``sm90`` launches a whole
   number of steps (140 each) between 0 and 2800 at shapes phase 3
   checked, and (4) the same seed again, whose image must equal the
   first run's to the bit.  (5) w0 enabled,
   ``/distributed/cluster/interrupt`` during a fan-out, timed the same
   way from the master's KSampler start: ``{"w0": 200}``, both shares
   ``execution interrupted`` with whole steps between 0 and 2800 at
   checked shapes, the request over within
   ``PHASE15_CLUSTER_INTERRUPT_END_S``.  (6)
   ``/distributed/cluster/clear_memory`` must free over
   ``PHASE15_CLEAR_MIN_FREED`` bytes on each server (``nvidia-smi``'s
   compute apps printed before and after).  (7) ``stop_worker``: no
   process of w0's tree, listed from ``/proc`` before, may be alive
   after; the master's log names the kill branch, and the ``ps`` branch
   is drilled on a three-process tree with psutil set aside, whichever
   the server took.  (8) w0 launched
   again, the master SIGKILLed: the monitor must end w0's tree within
   2 x ``WORKER_CHECK_INTERVAL`` + ``PROCESS_TERMINATION_TIMEOUT``.  It
   prints a ``phase15`` line with the card; the interrupted request's
   launches count in the ``kernels`` line.
16. the master's death (the write-ahead log, ``runtime/durable.py``):
   the pipelines released (it fails unless ``PHASE16_MIN_FREE`` bytes
   are free), four SD1.5 ``cli`` servers start: master A with
   ``DTPU_WAL_DIR`` (fsync always, a ``PHASE16_MASTER_LEASE_S`` lease),
   standby B on the same log (``DTPU_STANDBY=1``), w0, and w1 stalling
   ``PHASE16_STALL_S`` before it sends.  References on A with w1
   disabled: the upscale (seed 42) cold and twice warm, each within
   ``FANOUT_ATOL["one_batch"]`` of phase 7's image, with A's
   ``wal_spill`` and ``wal_append`` seconds beside phase 8's warm
   upscale, and the inpaint fan-out, equal to phase 14's in-process
   slices to the bit.  Drill 1: the upscale with w1; once A holds every
   tile but w1's, A and w1 get SIGKILL; B must take over when the lease
   expires (epoch 2, one takeover), resume the prompt under its id to
   ``success``, with the tile job recovered, every tile done, the tiles
   done at the kill preloaded and w1's reassigned, w0 healthy at B
   through its re-homed heartbeat, and the image within the one-batch
   limits of A's reference and phase 7's.  Drill 2: w1 started again
   (stalling), the inpaint fan-out on B; once w0's slice is in, B and w1
   get SIGKILL and B starts again in place with its owner id (epoch 3):
   the prompt ends ``success`` under its id with w0's slice loaded from
   the store (preloaded, w0 renders it no more), w1's redispatched (the
   restarted B receives that one slice), the three images equal to
   phase 14's in-process slices and A's reference to the bit.  Then
   ``cli wal --dir D`` must find no corrupt record.  Every server's
   launches must be sm90 alone at shapes phase 3 checked; they count in
   the ``kernels`` line.  It prints the seconds from each kill (to the
   lease's expiry, the takeover and the success) and a ``phase16``
   line.
17. traces, Prometheus and the resource view (``utils/trace.py``,
   ``trace_export.py``, ``trace_analysis.py``, ``resource.py``), on
   phase 8's master and worker before they stop, tracing on and the
   capture files in a temporary directory a server: (1) one warm
   fan-out upscale after ``metrics/reset``; ``GET
   /distributed/trace/<id>`` must give one trace id and one root (the
   master's job) over the queue wait, execute, node, preflight,
   dispatch, collect and finalize spans, w0's shipped spans (its job,
   queue wait, execute, the upscaler's span and its ``d2h``,
   ``encode`` and ``upload`` stages) under the dispatch span, and no
   dropped span; (2) ``cli why <id> --json``: the categories and the
   unattributed gap sum to the root span's duration within
   ``PHASE17_WHY_SUM_ATOL_S`` and ``compute`` is above 0; (3) ``cli
   trace <id> --export-dir DIR --perfetto`` reads the same span ids
   from the capture files; (4) ``metrics.prom`` parses (every line a
   HELP, TYPE or sample, every histogram cumulative up to its
   ``_count``) and its ``job_e2e`` count equals the prompts run since
   the reset; (5) ``cluster/metrics`` lists the master and w0, neither
   stale, each with over ``PHASE17_MIN_DEVICE_BYTES`` in use from
   ``torch.cuda``, and ``cluster/metrics.prom`` parses; (6)
   ``profile/start``, one more warm fan-out upscale, ``profile/stop``:
   the master's Chrome trace holds exactly ``PHASE17_PROFILE_SM90``
   ``flash_fwd_sm90`` kernel events and none of the other attention
   kernels, and ``profile/status`` is not running after; (7) in this
   process (inside phase 8, while the SDXL pipeline is warm) the
   txt2img four times, tracing on, off, on, off, each under a job span:
   the 8-bit images equal to the bit.  It prints a ``phase17`` line: the
   span names, ``why``'s blame, the transfer bytes by direction, the
   profile's top ten kernels, the traced and profiled request seconds
   and check 7's four.

18. admission, SLOs and more than one master (``workflow/scheduler.py``,
   ``utils/slo.py``, ``runtime/shard.py``): the pipelines released (it
   fails unless ``PHASE18_MIN_FREE`` bytes are free), sharded masters m0
   and m1 (``DTPU_SHARD_ID``, one ``DTPU_SHARD_PEERS``, one
   ``DTPU_SHARD_WAL_ROOT``, a ``PHASE18_MASTER_LEASE_S`` lease, the
   reassign policy, hedging armed with a ``PHASE18_HEDGE_MIN_WAIT_S``
   wait; m0 with ``DTPU_MAX_QUEUE``, ``DTPU_SLO_SPEC`` and
   ``DTPU_DRAIN_TIMEOUT_S`` of ``PHASE18_*``), workers w0 and w1
   heartbeating both (``DTPU_MASTER_URLS``; w1 stalling
   ``PHASE18_STALL_S`` before it sends and disabled until drill 3) and a
   ``cli router`` over both, which must not hold the card.  Each master's
   ``/distributed/ring`` must name both and its log lie under the root at
   its id.  (1) Four upscales (seed 42) through the router, each landing
   on the owner the ring names for its id, and one posted to m1 under an
   id m0 owns, forwarded one hop, its admission in m0's log; the router's
   merged ``/history`` holds all five, each image within the one-batch
   limits of phase 7's.  (2) While an upscale runs on m0, seven inpaints
   in ``PHASE18_BURST``'s classes must meet ``PHASE18_LADDER`` (each shed
   a 429 with ``Retry-After`` >= 1 and reason ``overload``), the four
   admitted must start in ``PHASE18_ORDER``'s stride order (f1, b1, f2,
   b2 on a first attempt) and equal phase 14's in-process slices to the
   bit, and no worker may shed a dispatched share.  (3) m0's ``/distributed/slo`` fast burn rates must
   equal those recomputed from its ``/history`` (paid 20, free 0,
   completion 0), each paid trace hold one ``slo_breach`` span and ``cli
   slo`` print the same; then an upscale with ``slo_s`` of
   ``PHASE18_SLO_S`` and w1 enabled: ``/distributed/cluster`` shows its
   deadline and w1's units are hedged after at most max(0.25 x the
   budget left, 0.25 s) of silence.  (4) An upscale owned by m1 with w1;
   once m1's log holds every unit but w1's, m1 gets SIGKILL: m0 absorbs
   its shard and finishes the prompt under its id (recovered, every
   unit done, the logged units preloaded, w1's reassigned), m0's and the
   router's ring show m0 alone at epoch >= 2, both workers healthy at
   m0, the image within the one-batch limits of drill 1's and phase 7's,
   and ``cli wal`` verifies both shards' logs.  (5) SIGTERM to m0 during
   an upscale: the upscale ends ``success``, a ``/prompt`` gets 503, and
   m0 exits within ``PHASE18_DRAIN_TIMEOUT_S`` with no process of its
   tree left.  Every server's launches must be sm90 alone at shapes
   phase 3 checked; they count in the ``kernels`` line.  It prints a
   ``phase18`` line: the card, the decisions and the order, the burn
   rates, the hedge's silence, the kill's seconds, the drain's and each
   server's peak memory and sm90 launches.

Launch counts are zeroed just before each request of phases 5-7 and
9-13 and read just after (phase 15's interrupted request and every
request of phases 16 and 18: their servers' prompt lines).  The line before the last is ``{"kernels":
[...]}``: for each kernel variant those phases launched, its launches
and, over exactly
those launches (each shape's measured time times its launch count),
``ms``, ``plain_ms``, ``library_ms``, ``bound_ms`` and, for sm90,
``mma_sync_ms``.  The last line is ``{"ok": true, "device": {...}}``.
Without a CUDA card, or outside a checkout, it exits non-zero before
printing any result.

    python3 chip_smoke.py --ab DIR

compares this checkout's port with the one at ``DIR`` (another commit,
unpacked): the txt2img, sdxl and inpaint workflows' warm seconds, the
two sides in turns in one process each, and their images to the bit
(:func:`ab`).

    python3 chip_smoke.py --fanout-ab DIR

compares the two checkouts' fan-out upscale through a master and a
worker, fresh servers a turn (:func:`fanout_ab`).
"""

from __future__ import annotations

import collections
import copy
import json
import math
import os
import re
import shutil
import signal
import statistics
import subprocess
import sys
import tempfile
import threading
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
WORKFLOWS = {name: os.path.join(ROOT, "workflows", f"distributed-{file}.json")
             for name, file in (("txt2img", "txt2img"),
                                ("img2img", "img2img"),
                                ("upscale", "upscale"), ("sdxl", "sdxl"),
                                ("refiner", "sdxl-refiner"),
                                ("hires_fix", "hires-fix"),
                                ("inpaint", "inpaint"),
                                ("outpaint", "outpaint"),
                                ("inpaint_model", "inpaint-model"),
                                ("regional", "regional"), ("ip2p", "ip2p"),
                                ("unclip", "unclip"))}
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
            "upscale": ("sm90", 640), "sdxl": ("sm90", 2800),
            "refiner": ("sm90", 3048), "hires_fix": ("sm90", 2800),
            "inpaint": ("sm90", 640), "outpaint": ("sm90", 640),
            "inpaint_model": ("sm90", 640), "regional": ("sm90", 640),
            "ip2p": ("sm90", 384), "unclip": ("sm90", 640)}
# (height, width) of each path's image ((1024, 1024) where not listed)
IMAGE_HW = {"upscale": (2048, 2048), "hires_fix": (1216, 1216),
            "inpaint": (512, 512), "outpaint": (512, 768),
            "inpaint_model": (512, 512), "regional": (512, 512),
            "ip2p": (512, 512), "unclip": (768, 768)}
# phase 12: (sampler node, the node whose latent it samples) of each
# inpaint workflow
INPAINT_NODES = {"inpaint": ("3", "5"), "outpaint": ("3", "5"),
                 "inpaint_model": ("8", "6")}
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
# phase 8's master and worker; the master hedges nothing, so each share
# refines exactly its part of the tiles (phase 14 drills the hedge)
PHASE8_ROLES = {"serve": ("serve", {"DTPU_HEDGE": "0"}),
                "worker": ("worker", {})}
# phase 14: a worker's lease (it heartbeats every third of it), the
# master's hedge wait (drill 2's kill is seen as a lease expiry well
# before it, drill 1's stall outlasts it and the master's refine of the
# stalled tiles), w1's stall, and the free device memory three SD1.5
# servers need (an upscale server peaked at 17.30 GB in phase 8)
DRILL_LEASE_S = 3.0
DRILL_HEDGE_MIN_WAIT_S = 6.0
# the overdue bar is max(this x the ledger's latency estimate, the wait):
# at the default 3 a cold first refine can lift it past the stall
DRILL_HEDGE_FACTOR = 1.0
DRILL_STALL_S = 15.0
DRILL_MIN_FREE = 52_000_000_000
FANOUT_REQUEST_S = 300   # a fan-out request must finish within this
# phase 15: a managed worker answers and its ``launching`` clears within
# READY_S of its launch (a cold start imports torch and opens the card);
# an interrupted request ends within INTERRUPT_END_S of /interrupt (the
# step in flight, ~0.1 s alone, then VAEDecode's check), and within
# CLUSTER_INTERRUPT_END_S of /distributed/cluster/interrupt on a card
# shared with the worker, well under the collector's 10 s
# WORKER_JOB_TIMEOUT; each server's SDXL pipeline (about 7 GB of
# weights) must free over CLEAR_MIN_FREED bytes; one SDXL step is 70
# transformer blocks x 2 attentions
PHASE15_READY_S = 120
PHASE15_INTERRUPT_END_S = 2.0
PHASE15_CLUSTER_INTERRUPT_END_S = 5.0
PHASE15_CLEAR_MIN_FREED = 5_000_000_000
SDXL_STEP_LAUNCHES = 140
# phase 16: the master lease (renewed every third of it, the standby
# looks as often), w1's stall before it sends (it is killed first), and
# the free device memory four SD1.5 servers need (phase 8's upscale
# servers peaked at 17.30 GB at B = 16, phase 14's at 8.17 GB)
PHASE16_MASTER_LEASE_S = 3.0
PHASE16_STALL_S = 300
PHASE16_MIN_FREE = 60_000_000_000
# phase 17: an SD1.5 server holds its pipelines, more device memory
# than this in the federated view (PERF.md: 7-17 GB a server); the
# profiled request's master share is 16 UNet attentions x (self, cross)
# x 20 steps of sm90; the blame categories and the unattributed gap of
# ``cli why`` sum to the root span's duration within this many seconds
PHASE17_MIN_DEVICE_BYTES = 5_000_000_000
PHASE17_MEMORY_SOURCE = "memory_stats"   # torch.cuda's, not host RSS
PHASE17_PROFILE_SM90 = 640
PHASE17_WHY_SUM_ATOL_S = 1e-3
# kernels of the variants the profiled request must not launch: the
# older mma.sync and fp32 ones and torch's own attention
PHASE17_FORBIDDEN_KERNELS = ("flash_fwd_bf16", "flash_fwd_f32", "fmha",
                             "pytorch_flash", "efficient_attention",
                             "scaled_dot_product")
# phase 18: the sharded masters' master lease, the hedge's plain wait
# (so long that only a deadline hedges), m0's queue cap, SLO spec and
# drain bound, the deadline drill's budget, w1's stall before it sends,
# the burst of drill 2 with the ladder it must meet, and the free device
# memory four SD1.5 servers need (as phase 16)
PHASE18_MASTER_LEASE_S = 3.0
PHASE18_HEDGE_MIN_WAIT_S = 600.0
PHASE18_MAX_QUEUE = 4
PHASE18_SLO_SPEC = "paid:p95<0.1s,completion>0.99;free:p95<60s"
PHASE18_DRAIN_TIMEOUT_S = 60
PHASE18_SLO_S = 30.0
PHASE18_STALL_S = 300
PHASE18_BURST = ("batch", "batch", "batch", "free", "free", "free", "paid")
PHASE18_LADDER = ("admit", "admit", "overload", "admit", "admit",
                  "overload", "overload")
# the admitted prompts' start order by attempt: the stride scheduling of
# the default weights (paid 6, free 3, batch 1) after the paid upscales
# alone; a second attempt starts from the first one's passes
PHASE18_ORDER = (["f1", "b1", "f2", "b2"], ["f1", "f2", "b1", "b2"])
PHASE18_MIN_FREE = 60_000_000_000
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
    refiner = copy.deepcopy(docs["refiner"])
    refiner["3"]["inputs"].update(width=64, height=64)
    refiner["8"]["inputs"].update(steps=4, end_at_step=3)
    refiner["9"]["inputs"].update(steps=4, start_at_step=3)
    hires = copy.deepcopy(docs["hires_fix"])
    hires["5"]["inputs"].update(width=32, height=32)
    hires["3"]["inputs"].update(steps=2, end_at_step=1)
    hires["10"]["inputs"].update(width=64, height=64)
    hires["11"]["inputs"].update(steps=2, start_at_step=1)
    inpaint = copy.deepcopy(docs["inpaint"])
    inpaint["2"]["inputs"].update(width=64, height=64)
    inpaint["3"]["inputs"]["steps"] = 3
    outpaint = copy.deepcopy(docs["outpaint"])
    outpaint["2"]["inputs"].update(width=64, height=64)
    # 40 px of feather does not fit twice into 64
    outpaint["10"]["inputs"].update(right=32, feathering=12)
    outpaint["3"]["inputs"]["steps"] = 3
    inpaint_model = copy.deepcopy(docs["inpaint_model"])
    inpaint_model["8"]["inputs"]["steps"] = 3
    regional = copy.deepcopy(docs["regional"])
    regional["2"]["inputs"].update(width=64, height=64)
    regional["3"]["inputs"]["steps"] = 3
    # the split loaders' tiny geometry comes from the names (the UNet's
    # and the VAE's) and CLIPLoader's type
    ip2p = copy.deepcopy(docs["ip2p"])
    ip2p["2"]["inputs"]["unet_name"] = "tiny-ip2p-unet.sft"
    ip2p["3"]["inputs"].update(clip_name="tiny-clip.sft", type="tiny")
    ip2p["4"]["inputs"]["vae_name"] = "tiny-vae.sft"
    ip2p["9"]["inputs"]["steps"] = 2
    unclip = copy.deepcopy(docs["unclip"])
    unclip["7"]["inputs"].update(width=64, height=64)
    unclip["9"]["inputs"]["steps"] = 2
    return {"txt2img": txt, "img2img": i2i, "upscale": up, "sdxl": xl,
            "txt2img_from_file": from_file, "refiner": refiner,
            "hires_fix": hires, "inpaint": inpaint, "outpaint": outpaint,
            "inpaint_model": inpaint_model, "regional": regional,
            "ip2p": ip2p, "unclip": unclip}


# the family of each inpaint workflow's tiny stand-in (phase 4)
TINY_INPAINT_FAMILY = {"inpaint": "tiny", "outpaint": "tiny",
                       "inpaint_model": "tiny_inpaint"}
# phase 4's family override of the phase 13 stand-ins (None: the names
# decide, as the split loaders' tiny names do)
TINY_PHASE13_FAMILY = {"regional": "tiny", "ip2p": None,
                       "unclip": "tiny_unclip"}


def write_phase13_inputs(input_dir, size):
    """The files the ip2p and unclip workflows read, written by the port's
    PNG writer: ``input.png`` (``size`` square, phase 13's 512) and
    ``concept.png`` (5/4 ``size`` wide, ``size`` high, so the CLIP-vision
    crop cuts its sides), smooth colour fields."""
    import numpy as np

    from comfyui_distributed_tpu_torch.utils.image import encode_png
    for name, (h, w) in (("input.png", (size, size)),
                         ("concept.png", (size, size * 5 // 4))):
        yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
        img = np.stack([0.5 + 0.5 * np.sin(xx / w * 6.3),
                        yy / h, 0.5 + 0.5 * np.cos((xx + yy) / h * 3.1)],
                       axis=-1)
        with open(os.path.join(input_dir, name), "wb") as f:
            f.write(encode_png(img))


def shared_embedding(basic, embeds):
    """Patches ``basic.CLIPVisionEncode`` to hand on ``embeds`` (moved to
    the run's card) in place of the tower's own, recording the largest
    difference between the two; returns (the restore function, the
    record).  The unCLIP vector's noise is keyed by the embedding's
    bytes, so phase 4 gives the card the CPU's embedding and holds the
    tower itself within the same 1e-3."""
    real = basic.CLIPVisionEncode.execute
    record = {"max_abs_err": 0.0}

    def execute(self, ctx, **kw):
        (out,) = real(self, ctx, **kw)
        record["max_abs_err"] = max(record["max_abs_err"], float(
            (out.image_embeds.cpu() - embeds).abs().max()))
        out.image_embeds = embeds.to(out.image_embeds.device)
        return (out,)

    basic.CLIPVisionEncode.execute = execute

    def restore():
        basic.CLIPVisionEncode.execute = real

    return restore, record


def write_inpaint_inputs(input_dir, scale):
    """The RGBA files the inpaint workflows read, written by the port's
    PNG writer: ``input.png`` (80 x 60 times ``scale``; phase 12's 8
    gives 640 x 480) and ``source.png`` (64^2 times ``scale``), each a
    colour gradient with a transparent rectangle, the region to
    resample (a missing file would give a mask of zeros)."""
    import numpy as np

    from comfyui_distributed_tpu_torch.utils.image import encode_png

    def card(h, w, hole):
        yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
        img = np.stack([xx / w, yy / h, (xx + yy) / (h + w),
                        np.ones((h, w), np.float32)], axis=-1)
        y0, y1, x0, x1 = (v * scale for v in hole)
        img[y0:y1, x0:x1, 3] = 0.0
        return img

    for name, (h, w), hole in (("input.png", (60, 80), (18, 42, 30, 56)),
                               ("source.png", (64, 64), (20, 44, 16, 40))):
        with open(os.path.join(input_dir, name), "wb") as f:
            f.write(encode_png(card(h * scale, w * scale, hole)))


TINY_FILE = "tiny-from-disk.safetensors"
# phase 4's stand-ins for the staged workflows' two checkpoints
TINY_BASE, TINY_REFINER = "tiny_xl_base", "tiny_xl_refiner"


def staged_stand_ins(registry):
    """Registers phase 4's tiny stand-ins of SDXL base and refiner in the
    port's registry; returns the family rule that sends each checkpoint
    name to its own (a name holding "refiner" to the refiner's)."""
    import dataclasses

    from comfyui_distributed_tpu_torch.models import clip, unet, vae
    tower = dataclasses.replace(clip.TINY_CLIP_CONFIG, layers=3,
                                output_layer=-2)
    bigg = dataclasses.replace(tower, projection_dim=48, layout="openclip")
    registry.FAMILIES[TINY_BASE] = registry.ModelFamily(
        name=TINY_BASE, vae=vae.TINY_VAE_CONFIG, clips=(tower, bigg),
        unet=dataclasses.replace(unet.TINY_CONFIG, context_dim=128,
                                 adm_in_channels=48 + 6 * 256))
    registry.FAMILIES[TINY_REFINER] = registry.ModelFamily(
        name=TINY_REFINER, vae=vae.TINY_VAE_CONFIG, clips=(bigg,),
        unet=dataclasses.replace(unet.TINY_CONFIG, context_dim=64,
                                 adm_in_channels=48 + 5 * 256),
        clip_prefixes=("conditioner.embedders.0.model.",))
    return lambda name: TINY_REFINER if "refiner" in name.lower() \
        else TINY_BASE


def tiny_against_cpu(docs, input_dir):
    """Phase 4: the tiny family's txt2img, img2img, tiled upscale, the
    SDXL graph (on ``tiny_sdxl``), txt2img from a checkpoint file the
    port wrote, the shrunk refiner and hires-fix graphs (on
    :func:`staged_stand_ins`), the three inpaint graphs (on ``tiny``
    and ``tiny_inpaint``, from their own small RGBA inputs) and the
    regional, ip2p (``tiny_ip2p`` by the names) and unclip
    (``tiny_unclip``, the CPU's image embedding handed to the card:
    :func:`shared_embedding`) graphs, on the card against the CPU runs
    of the same graphs (kernels' plain versions).  The tiny RRDB runs in fp32
    here: its bf16 convolutions round differently in cuDNN and on the
    CPU, which the refine then amplifies past 1e-3."""
    import dataclasses

    import numpy as np
    import torch

    from comfyui_distributed_tpu_torch.models import registry, upscalers
    from comfyui_distributed_tpu_torch.ops import basic
    from comfyui_distributed_tpu_torch.ops.base import OpContext
    from comfyui_distributed_tpu_torch.workflow import WorkflowExecutor
    os.environ["DTPU_DEFAULT_FAMILY"] = "tiny"
    tiny_rrdb = upscalers.TINY_RRDB_CONFIG
    upscalers.TINY_RRDB_CONFIG = dataclasses.replace(tiny_rrdb,
                                                     dtype=torch.float32)
    detect_family = registry.detect_family
    staged_family = staged_stand_ins(registry)
    out = {}
    models_dir = tempfile.mkdtemp(prefix="tiny_models_")
    inpaint_dir = tempfile.mkdtemp(prefix="tiny_inpaint_inputs_")
    phase13_dir = tempfile.mkdtemp(prefix="tiny_phase13_inputs_")
    try:
        write_inpaint_inputs(inpaint_dir, 1)
        from comfyui_distributed_tpu_torch.models.checkpoints import (
            save_checkpoint)
        pipe = registry.load_pipeline("tiny-to-disk.safetensors",
                                      device="cpu")
        save_checkpoint(os.path.join(models_dir, TINY_FILE), pipe.unet,
                        pipe.clip_models, pipe.vae, pipe.family)
        write_phase13_inputs(phase13_dir, 32)
        for name, doc in small_docs(docs).items():
            staged = name in ("refiner", "hires_fix")
            registry.detect_family = staged_family if staged \
                else detect_family
            family = "tiny_sdxl" if name == "sdxl" \
                else TINY_PHASE13_FAMILY[name] \
                if name in TINY_PHASE13_FAMILY \
                else TINY_INPAINT_FAMILY.get(name, "tiny")
            if staged or family is None:
                os.environ.pop("DTPU_DEFAULT_FAMILY", None)
            else:
                os.environ["DTPU_DEFAULT_FAMILY"] = family
            run_dir = inpaint_dir if name in TINY_INPAINT_FAMILY \
                else phase13_dir if name in TINY_PHASE13_FAMILY \
                else input_dir
            results = {}
            for dev in ("cpu", DEVICE):
                restore = None
                if name == "unclip" and dev == DEVICE:
                    restore, vision = shared_embedding(
                        basic, results["cpu"].outputs["3"][0].image_embeds)
                try:
                    results[dev] = WorkflowExecutor(OpContext(
                        device=dev, input_dir=run_dir,
                        models_dir=models_dir)).execute(copy.deepcopy(doc))
                finally:
                    if restore is not None:
                        restore()
            card = results[DEVICE].image_batch
            host = results["cpu"].image_batch
            err = float(np.abs(card - host).max())
            if card.shape != host.shape or not err < 1e-3:
                fail(f"tiny {name} on the card disagrees with the CPU run: "
                     f"shapes {card.shape} {host.shape}, max err {err}")
            out[name] = {"shape": list(card.shape), "max_abs_err": err,
                         "atol": 1e-3}
            if name == "unclip":
                if not vision["max_abs_err"] < 1e-3:
                    fail(f"tiny unclip: the card's CLIP-vision embedding "
                         f"differs from the CPU's by {vision}")
                out[name]["vision_max_abs_err"] = vision["max_abs_err"]
    finally:
        os.environ.pop("DTPU_DEFAULT_FAMILY", None)
        upscalers.TINY_RRDB_CONFIG = tiny_rrdb
        registry.detect_family = detect_family
        for name in (TINY_BASE, TINY_REFINER):
            registry.FAMILIES.pop(name, None)
        registry.clear_pipeline_cache()
        shutil.rmtree(models_dir, ignore_errors=True)
        shutil.rmtree(inpaint_dir, ignore_errors=True)
        shutil.rmtree(phase13_dir, ignore_errors=True)
    return out


def run_requests(path, doc, seeds, input_dir, shape_counts, images=None,
                 results=None, **ctx_kw):
    """Phases 5-7 and 9-13: one request of ``path`` per seed, its launch
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
    hw = IMAGE_HW.get(path, (1024, 1024))
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
        shapes = dict(fa.flash_attention.shapes)
        shape_counts.update(shapes)
        img = res.image_batch
        finite = bool(img is not None and np.isfinite(img).all())
        std = float(img.std()) if img is not None else 0.0
        requests.append({
            "path": path, "seed": seed, "seconds": seconds,
            "node_seconds": {f"{k} {doc[k]['class_type']}": round(v, 4)
                             for k, v in res.timings.items()},
            "stage_seconds": {k: round(v, 4) for k, v in res.stages.items()},
            "node_max_memory": res.node_max_memory,
            "shape": list(img.shape) if img is not None else None,
            "finite": finite, "std": std, "launches": launches,
            "variants": variants,
            "launches_by_shape": [[*k, n] for k, n in sorted(shapes.items())],
            "max_memory_allocated": torch.cuda.max_memory_allocated()})
        if img is None or img.shape != (1, *hw, 3) or not finite \
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
    """The contract's entries over the launches of phases 5-7, 9-13, 15's
    interrupted request and 16: one per kernel variant that they
    launched, each over exactly its shapes."""
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
    """Port servers on free ports of 127.0.0.1, each with its own config,
    input and output directories and log file under ``root``:
    ``roles`` maps a name to (the ``cli`` command, more environment);
    by default a ``serve`` master and a ``worker``.  ``cwd``: the
    checkout whose package the servers run."""

    def __init__(self, root, roles=None, cwd=ROOT):
        from comfyui_distributed_tpu_torch.utils.net import find_free_port
        self.root, self.cwd = root, cwd
        self.roles = roles or {"serve": ("serve", {}),
                               "worker": ("worker", {})}
        self.procs, self.dirs, self.ports, self.logs = {}, {}, {}, {}
        for role in self.roles:
            d = os.path.join(root, role)
            os.makedirs(os.path.join(d, "input"))
            self.dirs[role] = d
            self.ports[role] = find_free_port()
            self.logs[role] = os.path.join(d, "log.txt")

    def url(self, role):
        return f"http://127.0.0.1:{self.ports[role]}"

    def launch(self, role, env=None):
        """Start one server (its log appended to); ``env`` replaces the
        role's own extra environment."""
        cmd, extra = self.roles[role]
        d = self.dirs[role]
        with open(self.logs[role], "a") as log:
            self.procs[role] = subprocess.Popen(
                [sys.executable, "-m", "comfyui_distributed_tpu_torch.cli",
                 cmd, "--host", "127.0.0.1",
                 "--port", str(self.ports[role]), "--device", DEVICE,
                 "--config", os.path.join(d, "cluster_config.json"),
                 "--input-dir", os.path.join(d, "input"),
                 "--output-dir", os.path.join(d, "output")],
                cwd=self.cwd, stdout=log, stderr=subprocess.STDOUT,
                env={**os.environ, **(extra if env is None else env)})

    def wait_up(self, roles):
        from comfyui_distributed_tpu_torch.utils.net import get_json
        deadline = time.time() + FANOUT_START_S
        for role in roles:
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

    def start(self):
        for role in self.roles:
            self.launch(role)
        self.wait_up(self.roles)

    def kill(self, role):
        """SIGKILL the server's own pid (never a match on a command
        line) and reap it."""
        proc = self.procs[role]
        os.kill(proc.pid, signal.SIGKILL)
        proc.wait()

    def count_lines(self, role, text):
        """How many lines of a server's log hold ``text``."""
        with open(self.logs[role], "r", errors="replace") as f:
            return sum(text in ln for ln in f)

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
        self.stop()
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
    # the pipelined upload's split: the worker's encode (on its pool
    # thread) and POST seconds, the master's decode seconds
    stages = shares["worker"].get("stage_seconds") or {}
    wire = {"worker_encode_s": stages.get("wire_encode"),
            "worker_post_s": stages.get("wire_post"),
            "worker_send_stage_s": stages.get("tile_send"),
            "master_decode_s": m1["wire_decode_s"] - m0["wire_decode_s"]}
    return {"path": path, "prompt_id": pid, "seconds": seconds,
            "wire_split": wire, "files": new_files, "master_received": got,
            "abs_diff": [{key: {"max": v[0], "mean": v[1]}
                          for key, v in d.items()} for d in diffs],
            "wrong_seed_diff": wrong,
            "worker_probe_s": {"n": len(probe_s),
                               "max": max(probe_s, default=None),
                               "median": statistics.median(probe_s)
                               if probe_s else None},
            "shares": {r: {k: s.get(k) for k in (
                "seconds", "launches", "launches_by_shape", "attention",
                "max_memory_allocated", "node_seconds", "stage_seconds",
                "transfers")}
                for r, s in shares.items()}}


def fanout(docs, input_dir, upscale_ref, rows):
    """Phase 8: the HTTP fan-out on one card.  The in-process images of
    the two txt2img shares and of the upscale in the fan-out's two tile
    batches first; then the pipelines are released and a master and a
    worker server start; parallel SDXL generation and the distributed
    SD1.5 upscale each run cold and warm.  ``rows``: phase 3's checks.
    Returns the report and the in-process txt2img images of the two
    shares (phase 15 holds its fan-out against them)."""
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
    # phase 17's check 7 while the SDXL pipeline is warm in this process
    req = copy.deepcopy(docs["txt2img"])
    req["13"]["inputs"]["seed"] = seed
    parity = tracing_parity(req, input_dir)
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
        # tracing is on by default; the capture files go to a temporary
        # directory a server
        export = {role: os.path.join(root, f"capture-{role}")
                  for role in PHASE8_ROLES}
        cluster = Cluster(root, {
            role: (cmd, {**env, "DTPU_TRACE_EXPORT_DIR": export[role]})
            for role, (cmd, env) in PHASE8_ROLES.items()})
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
            phase17 = observability(
                cluster, up, [{"same": up_ref, "one_batch": upscale_ref}],
                checked, export["serve"], os.path.join(root, "profile"))
        finally:
            cluster.stop()
    phase17["tracing_parity"] = parity
    report = {"free_bytes_before": free, "servers_start_s": started_s,
              "cudnn_benchmark": torch.backends.cudnn.benchmark,
              "atol": {k: {"max": v[0], "mean": v[1]}
                       for k, v in FANOUT_ATOL.items()},
              "requests": requests,
              "seconds": {f"{r['path']} {r['run']}": r["seconds"]
                          for r in requests},
              "wire_split": {f"{r['path']} {r['run']}": r["wire_split"]
                             for r in requests},
              "peak_memory": {f"{r['path']} {r['run']}": {
                  role: s["max_memory_allocated"]
                  for role, s in r["shares"].items()} for r in requests},
              "phase17": phase17}
    return report, [r["same"] for r in txt_refs]


PROM_SAMPLE = re.compile(
    r'^([a-zA-Z_:][a-zA-Z0-9_:]*)(\{(?:[a-zA-Z_][a-zA-Z0-9_]*="(?:[^"\\]|'
    r'\\.)*",?)*\})? (\S+)( # \{[^}]*\} \S+ \S+)?$')
PROM_LABEL = re.compile(r'([a-zA-Z_][a-zA-Z0-9_]*)="((?:[^"\\]|\\.)*)"')


def parse_prom(text, what):
    """Prometheus text -> {(name, labels): value}; fails unless every
    line is a ``# HELP``, a ``# TYPE`` or a sample, and every histogram's
    buckets are cumulative, non-decreasing and end at ``_count``."""
    samples = {}
    buckets = collections.defaultdict(list)
    for ln in text.splitlines():
        if ln.startswith("# HELP ") or ln.startswith("# TYPE "):
            continue
        m = PROM_SAMPLE.match(ln)
        if m is None:
            fail(f"phase 17: {what}: not a Prometheus line: {ln!r}")
        labels = dict(PROM_LABEL.findall(m.group(2) or ""))
        value = float(m.group(3))
        name = m.group(1)
        if name.endswith("_bucket") and "le" in labels:
            le = labels.pop("le")
            buckets[(name[:-len("_bucket")],
                     tuple(sorted(labels.items())))].append(
                (math.inf if le == "+Inf" else float(le), value))
        samples[(name, tuple(sorted(labels.items())))] = value
    for (fam, labels), series in buckets.items():
        les = [le for le, _ in series]
        counts = [n for _, n in series]
        if les != sorted(les) or les[-1] != math.inf \
                or any(b < a for a, b in zip(counts, counts[1:])) \
                or counts[-1] != samples.get((fam + "_count", labels)):
            fail(f"phase 17: {what}: histogram {fam}{dict(labels)} is not "
                 f"cumulative: {series}")
    return samples


def tracing_parity(doc, input_dir):
    """Phase 17, check 7: the warm in-process SDXL txt2img four times,
    tracing on, off, on, off (``trace.set_tracing``, the JAX package's
    switch), each under a job span as a server runs it; the four 8-bit
    images must be equal to the bit.  Returns each run's seconds and
    spans."""
    import numpy as np
    import torch

    from comfyui_distributed_tpu_torch.ops.base import OpContext
    from comfyui_distributed_tpu_torch.utils import trace
    from comfyui_distributed_tpu_torch.utils.image import to_uint8
    from comfyui_distributed_tpu_torch.workflow import WorkflowExecutor
    runs, images = [], []
    was = trace.tracing_enabled()

    def sync():
        if DEVICE == "cuda":
            torch.cuda.synchronize()
    try:
        for i, on in enumerate((True, False, True, False)):
            trace.set_tracing(on)
            sync()
            t0 = time.perf_counter()
            root = trace.start_span("job", attrs={"prompt_id": f"p17_{i}"})
            with trace.use_span(root):
                res = WorkflowExecutor(OpContext(
                    device=DEVICE, input_dir=input_dir)).execute(
                        copy.deepcopy(doc))
            sync()
            seconds = time.perf_counter() - t0
            n_spans = 0
            if root is not None:
                root.end()
                trace.GLOBAL_TRACES.commit(f"p17_{i}", root.trace_id,
                                           root_span_id=root.span_id)
                n_spans = trace.GLOBAL_TRACES.get(f"p17_{i}")["n_spans"]
            if (n_spans > 0) != on:
                fail(f"phase 17: tracing {'on' if on else 'off'} recorded "
                     f"{n_spans} spans")
            images.append(to_uint8(res.image_batch[0]))
            runs.append({"tracing": on, "seconds": seconds,
                         "spans": n_spans})
    finally:
        trace.set_tracing(was)
    if any(not np.array_equal(images[0], im) for im in images[1:]):
        fail("phase 17: the image with tracing on differs from the one "
             "with tracing off")
    on_s = [r["seconds"] for r in runs if r["tracing"]]
    off_s = [r["seconds"] for r in runs if not r["tracing"]]
    return {"runs": runs, "equal_to_the_bit": True,
            "on_mean_s": statistics.mean(on_s),
            "off_mean_s": statistics.mean(off_s),
            "overhead_pct": 100.0 * (statistics.mean(on_s)
                                     / statistics.mean(off_s) - 1.0)}


def cli_json(args, what):
    """Run the port's ``cli`` with ``args`` and read its JSON output."""
    out = subprocess.run(
        [sys.executable, "-m", "comfyui_distributed_tpu_torch.cli", *args],
        cwd=ROOT, capture_output=True, text=True, timeout=120)
    if out.returncode != 0:
        fail(f"phase 17: cli {what} exited {out.returncode}: "
             f"{out.stderr[-2000:]}")
    return json.loads(out.stdout)


def observability(cluster, doc, refs, checked, export_dir, profile_dir):
    """Phase 17: traces, Prometheus and the resource view on phase 8's
    master and worker (checks 1-6; check 7 is :func:`tracing_parity`).
    ``doc``: the fan-out upscale, ``refs`` its references."""
    from comfyui_distributed_tpu_torch.utils.net import get_json, post_json
    master = cluster.url("serve")
    t_phase = time.perf_counter()
    post_json(master + "/distributed/metrics/reset", {})
    # check 1: one warm upscale fan-out, one trace tree
    req = fanout_request(cluster, "upscale", copy.deepcopy(doc),
                         EXPECTED["upscale"][1], refs, checked)
    pid = req["prompt_id"]
    deadline = time.time() + 30
    while True:   # the trace is committed just after the history entry
        try:
            rec = get_json(f"{master}/distributed/trace/{pid}")
            break
        except OSError:
            if time.time() > deadline:
                cluster.fail(f"phase 17: no trace for {pid}")
            time.sleep(0.1)
    spans = rec["spans"]
    by_id = {sp["span_id"]: sp for sp in spans}
    names = collections.Counter(sp["name"] for sp in spans)
    if {sp["trace_id"] for sp in spans} != {rec["trace_id"]}:
        cluster.fail("phase 17: more than one trace id in the tree")
    if len(rec["tree"]) != 1 or rec["tree"][0]["span_id"] \
            != rec["root_span_id"] or rec["tree"][0]["name"] != "job":
        cluster.fail(f"phase 17: roots {[r['name'] for r in rec['tree']]}, "
                     "expected the one job root")

    def under(sp, anc_id):
        while sp is not None:
            if sp.get("parent_id") == anc_id:
                return True
            sp = by_id.get(sp.get("parent_id"))
        return False

    root_id = rec["root_span_id"]
    master_nodes = {n["class_type"] for n in doc.values()
                    if isinstance(n, dict)}
    for name in ("queue_wait", "execute", "preflight", "dispatch",
                 "collect", "finalize", *master_nodes):
        if not any(sp["name"] == name and under(sp, root_id)
                   for sp in spans):
            cluster.fail(f"phase 17: no {name} span under the root: "
                         f"{dict(names)}")
    (dispatch,) = [sp for sp in spans if sp["name"] == "dispatch"]
    w_job = [sp for sp in spans if sp["name"] == "job"
             and (sp.get("attrs") or {}).get("role") == "worker"]
    if len(w_job) != 1 or w_job[0]["parent_id"] != dispatch["span_id"]:
        cluster.fail(f"phase 17: w0's job span is not under the dispatch "
                     f"span: {w_job}")
    w_names = collections.Counter(
        sp["name"] for sp in spans if under(sp, dispatch["span_id"]))
    for name in ("queue_wait", "execute", "UltimateSDUpscaleDistributed",
                 "d2h", "encode", "upload"):
        if not w_names.get(name):
            cluster.fail(f"phase 17: w0 shipped no {name} span: "
                         f"{dict(w_names)}")
    metrics = get_json(master + "/distributed/metrics")
    if metrics["tracing"]["dropped_spans"] != 0:
        cluster.fail(f"phase 17: {metrics['tracing']['dropped_spans']} "
                     "spans dropped")
    # check 2: cli why
    why = cli_json(["why", pid, "--url", master, "--json"], "why")
    blamed = sum(why["categories"].values()) + why["unattributed_s"]
    root_dur = by_id[root_id]["duration_s"]
    if abs(blamed - root_dur) > PHASE17_WHY_SUM_ATOL_S \
            or abs(why["e2e_s"] - root_dur) > PHASE17_WHY_SUM_ATOL_S:
        cluster.fail(f"phase 17: why's categories sum to {blamed} s, the "
                     f"root span lasted {root_dur} s")
    if not why["categories"].get("compute", 0) > 0:
        cluster.fail(f"phase 17: why blames no compute: {why['categories']}")
    # check 3: the capture files hold the span ids the recorder served
    doc_p = cli_json(["trace", pid, "--export-dir", export_dir,
                      "--perfetto"], "trace")
    captured = {ev["args"]["span_id"] for ev in doc_p["traceEvents"]
                if ev.get("ph") in ("X", "i")}
    if captured != set(by_id):
        cluster.fail(f"phase 17: the capture files hold "
                     f"{len(captured)} span ids, the recorder "
                     f"{len(by_id)}; {len(captured ^ set(by_id))} differ")
    # check 4: metrics.prom
    import urllib.request
    with urllib.request.urlopen(master + "/distributed/metrics.prom",
                                timeout=30) as r:
        prom = parse_prom(r.read().decode(), "metrics.prom")
    ran = metrics["prompts_executed"] + metrics["prompts_failed"]
    e2e_count = prom.get(("dtpu_stage_seconds_count",
                          (("stage", "job_e2e"),)))
    if e2e_count != ran or ran != 1:
        cluster.fail(f"phase 17: job_e2e count {e2e_count}, prompts run "
                     f"since the reset {ran}")
    # check 5: the federated resource view
    fleet = get_json(master + "/distributed/cluster/metrics")
    parts = fleet["participants"]
    memory = {}
    for who in ("master", "w0"):
        p = parts.get(who)
        if p is None or p["stale"] \
                or p["resources"]["source"] != PHASE17_MEMORY_SOURCE \
                or not p["resources"]["device_bytes_in_use"] \
                > PHASE17_MIN_DEVICE_BYTES:
            cluster.fail(f"phase 17: {who} in the federated view: {p}")
        memory[who] = p["resources"]["device_bytes_in_use"]
    with urllib.request.urlopen(master + "/distributed/cluster/metrics.prom",
                                timeout=30) as r:
        parse_prom(r.read().decode(), "cluster/metrics.prom")
    # check 6: a profile of one warm fan-out, its kernels by name
    post_json(master + "/distributed/profile/start", {"dir": profile_dir})
    prof_req = fanout_request(cluster, "upscale", copy.deepcopy(doc),
                              EXPECTED["upscale"][1], refs, checked)
    t0 = time.perf_counter()
    stopped = post_json(master + "/distributed/profile/stop", {})
    stop_s = time.perf_counter() - t0
    if get_json(master + "/distributed/profile/status")["running"]:
        cluster.fail("phase 17: the profile still runs after stop")
    with open(stopped["file"], "r", encoding="utf-8") as f:
        events = json.load(f)["traceEvents"]
    kernels = [ev for ev in events if ev.get("cat") == "kernel"]
    sm90 = [ev for ev in kernels if "flash_fwd_sm90" in ev["name"]]
    other = sorted({ev["name"] for ev in kernels
                    if any(k in ev["name"]
                           for k in PHASE17_FORBIDDEN_KERNELS)})
    if len(sm90) != PHASE17_PROFILE_SM90 or other:
        cluster.fail(f"phase 17: the profile holds {len(sm90)} sm90 kernels "
                     f"(expected {PHASE17_PROFILE_SM90}) and {other}")
    by_kernel = collections.defaultdict(lambda: [0, 0.0])
    for ev in kernels:
        k = by_kernel[ev["name"][:120]]
        k[0] += 1
        k[1] += float(ev.get("dur", 0)) / 1e3
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1][1])[:10]
    serve_line = req["shares"]["serve"]
    worker_line = req["shares"]["worker"]
    return {"prompt_id": pid, "trace_id": rec["trace_id"],
            "spans": len(spans), "span_names": dict(names),
            "worker_span_names": dict(w_names),
            "dropped_spans": metrics["tracing"]["dropped_spans"],
            "why": {"e2e_s": why["e2e_s"], "categories": why["categories"],
                    "unattributed_s": why["unattributed_s"],
                    "unattributed_pct": why["unattributed_pct"],
                    "negative_edges": why["negative_edges"]},
            "captured_span_ids": len(captured),
            "job_e2e_count": e2e_count,
            "device_bytes_in_use": memory,
            "transfers": {"master": serve_line.get("transfers"),
                          "worker": worker_line.get("transfers")},
            "profile": {"sm90_kernels": len(sm90),
                        "kernel_events": len(kernels),
                        "events": len(events), "stop_s": stop_s,
                        "top_kernels": [{"name": n, "count": c, "ms": ms}
                                        for n, (c, ms) in top]},
            "request_s": {"traced": req["seconds"],
                          "profiled": prof_req["seconds"]},
            "phase_s": time.perf_counter() - t_phase}


def drill_env(role):
    """Phase 14's environment of a server: short leases for all, the
    fault policy and the hedge's wait on the master, the master's URL and
    the worker's id on a worker (it self-registers and heartbeats)."""
    env = {"DTPU_LEASE_S": str(DRILL_LEASE_S), "DTPU_SUSPECT_PROBES": "1"}
    if role == "serve":
        return {**env, "DTPU_FAULT_POLICY": "reassign", "DTPU_HEDGE": "1",
                "DTPU_HEDGE_FACTOR": str(DRILL_HEDGE_FACTOR),
                "DTPU_HEDGE_MIN_WAIT_S": str(DRILL_HEDGE_MIN_WAIT_S)}
    return {**env, "DTPU_WORKER_ID": role}


def share_attention(cluster, what, share, checked):
    """A server's share (its ``dtpu-torch prompt`` line) must have
    launched sm90 and no other variant, at shapes phase 3 checked
    (``checked``: shape -> its row); returns its attention priced from
    those rows."""
    launches = share["launches"]
    if launches["mma_sync"] or launches["fp32"] or not launches["sm90"]:
        cluster.fail(f"{what}'s share launched {launches}; expected sm90 "
                     f"launches only")
    by_shape = {tuple(x[:6]): x[6] for x in share["launches_by_shape"]}
    missing = [x for x in by_shape if x not in checked]
    if missing:
        cluster.fail(f"{what} launched shapes that phase 3 did not check: "
                     f"{missing}")
    return totals(by_shape, checked, ["ms", "plain_ms", "library_ms"])


def drill_request(cluster, name, path, doc, fault, lost, refs, checked):
    """One drill of phase 14: ``doc`` through the master's /prompt with
    ``fault`` ("kill": w1's pid gets SIGKILL as soon as /prompt returns;
    "stall": w1 was started stalling before its first tile).  Fails
    unless the request succeeds with every ledger unit checked in and
    the ``lost`` units reassigned or hedged, every server's launches are
    sm90 at shapes phase 3 checked, and each saved image agrees with its
    references (``refs``: per image, {FANOUT_ATOL key: [H, W, 3]})."""
    from comfyui_distributed_tpu_torch.utils.net import get_json, post_json
    master = cluster.url("serve")
    live = [r for r in ("serve", "w0", "w1")
            if cluster.procs[r].poll() is None]
    m0 = get_json(master + "/distributed/metrics")
    jobs0 = {j["job_id"] for j in get_json(
        master + "/distributed/cluster")["ledger"]["completed_jobs"]}
    n_lines = {r: len(cluster.prompt_lines(r)) for r in live}
    files0 = set(cluster.outputs())
    with open(cluster.logs["w1"], "r", errors="replace") as f:
        w1_log0 = len(f.read())
    t0 = time.perf_counter()
    resp = post_json(master + "/prompt", {"prompt": doc,
                                          "client_id": "chip_smoke"})
    t_fault = None
    if fault == "kill":
        cluster.kill("w1")
        t_fault = time.perf_counter()
    if sorted(resp.get("workers", [])) != ["w0", "w1"]:
        cluster.fail(f"{name}: the master did not fan out to w0 and w1: "
                     f"{resp}")
    pid = resp["prompt_id"]
    deadline = time.time() + FANOUT_REQUEST_S
    while True:
        hist = get_json(master + "/history")
        if pid in hist:
            break
        if t_fault is None and fault == "stall":
            with open(cluster.logs["w1"], "r", errors="replace") as f:
                if "FAULT INJECTION" in f.read()[w1_log0:]:
                    t_fault = time.perf_counter()
        if time.time() > deadline:
            cluster.fail(f"{name}: no history after {FANOUT_REQUEST_S} s")
        time.sleep(0.05)
    t_done = time.perf_counter()
    entry = hist[pid]
    if entry.get("status") != "success" or entry.get("images") != len(refs):
        cluster.fail(f"{name}: history {entry}, expected success with "
                     f"{len(refs)} images")
    if t_fault is None:
        cluster.fail(f"{name}: w1 never reached its stall before the "
                     f"request ended")
    # w1 reads dead once its lease has run out since the kill
    snap = get_json(master + "/distributed/cluster")
    while fault == "kill" and snap["workers"]["w1"]["state"] != "dead":
        if time.perf_counter() - t_fault > DRILL_LEASE_S + 3:
            cluster.fail(f"{name}: w1 reads {snap['workers']['w1']} "
                         f"{DRILL_LEASE_S + 3} s after the kill")
        time.sleep(0.2)
        snap = get_json(master + "/distributed/cluster")
    jobs = [j for j in snap["ledger"]["completed_jobs"]
            if j["job_id"] not in jobs0]
    if len(jobs) != 1:
        cluster.fail(f"{name}: expected one finished ledger job, got {jobs}")
    job = jobs[0]
    if job["done_units"] != job["total_units"] or job["pending_units"] \
            or max(job["reassigned_units"], job["hedged_units"]) < lost:
        cluster.fail(f"{name}: ledger {job}; expected every unit done and "
                     f"{lost} reassigned or hedged")
    # every live server's share, the stalled w1's last upload refused too
    for role in live:
        if role == "w1" and fault == "kill":
            continue
        while get_json(cluster.url(role) + "/prompt", timeout=10)[
                "exec_info"]["queue_remaining"]:
            if time.time() > deadline:
                cluster.fail(f"{name}: {role} still busy")
            time.sleep(0.2)
    shares = {}
    for role in live:
        while True:
            lines = cluster.prompt_lines(role)[n_lines[role]:]
            if lines or (role == "w1" and fault == "kill"):
                break
            if time.time() > deadline:
                cluster.fail(f"{name}: no prompt line from {role}")
            time.sleep(0.05)
        for k, share in enumerate(lines):
            shares[f"{role} {k}"] = {
                "status": share["status"], "error": share.get("error"),
                "seconds": share["seconds"], "launches": share["launches"],
                "launches_by_shape": share["launches_by_shape"],
                "attention": share_attention(cluster, f"{name}: {role}",
                                             share, checked),
                "max_memory_allocated": share["max_memory_allocated"],
                "stage_seconds": share.get("stage_seconds")}
    m1 = get_json(master + "/distributed/metrics")
    new_files = sorted(set(cluster.outputs()) - files0)
    if len(new_files) != len(refs):
        cluster.fail(f"{name}: {len(new_files)} new PNGs, expected "
                     f"{len(refs)}")
    diffs = []
    for f, r in zip(new_files, refs):
        d = {key: image_diff(os.path.join(cluster.dirs["serve"], "output",
                                          f), ref)
             for key, ref in r.items()}
        for key, (dmax, dmean) in d.items():
            tol_max, tol_mean = FANOUT_ATOL[key]
            if not (dmax <= tol_max and dmean <= tol_mean):
                cluster.fail(f"{name}: {f} differs from the {key!r} "
                             f"in-process image by max {dmax}, mean {dmean} "
                             f"(limits {tol_max}, {tol_mean})")
        diffs.append({key: {"max": v[0], "mean": v[1]}
                      for key, v in d.items()})
    peaks = {}
    for key, share in shares.items():
        role = key.split()[0]
        peaks[role] = max(peaks.get(role) or 0,
                          share["max_memory_allocated"] or 0)
    return {"drill": name, "path": path, "fault": fault,
            "settings": {"lease_s": DRILL_LEASE_S, "suspect_probes": 1,
                         "hedge_min_wait_s": DRILL_HEDGE_MIN_WAIT_S,
                         "hedge_factor": DRILL_HEDGE_FACTOR,
                         "stall_s": DRILL_STALL_S, "policy": "reassign"},
            "seconds": t_done - t0, "fault_to_success_s": t_done - t_fault,
            "ledger": job, "w1_state": snap["workers"]["w1"]["state"],
            "received": {k: m1[k] - m0[k] for k in (
                "images_received", "tiles_received", "wire_decode_s")},
            "counters": {k: v - m0["pipeline"]["counters"].get(k, 0)
                         for k, v in m1["pipeline"]["counters"].items()
                         if k.startswith("cluster_")},
            "peak_memory": peaks, "abs_diff": diffs, "shares": shares}


def fault_drills(docs, input_dir, upscale_ref, rows):
    """Phase 14: the control plane's fault drills on one card.  The
    in-process inpaint images of the three seed slices first; then the
    pipelines are released and a master and two workers (w0, w1) start,
    the workers self-registering; drill 1 runs the upscale with w1
    stalling before its first tile (hedged on the master), drill 2 the
    upscale with w1 killed after dispatch (its tiles reassigned), and
    drill 3, after w1 restarts without a fault, the inpaint fan-out with
    w1 killed after dispatch (its seed slice redispatched to w0).
    ``rows``: phase 3's checks.  Returns the report and the in-process
    inpaint slices (phase 16 holds its own against them)."""
    import gc

    import torch

    from comfyui_distributed_tpu_torch.models import registry
    from comfyui_distributed_tpu_torch.ops import tiling
    from comfyui_distributed_tpu_torch.ops.base import OpContext
    from comfyui_distributed_tpu_torch.utils.net import get_json
    from comfyui_distributed_tpu_torch.workflow import WorkflowExecutor

    checked = {(r["B"], r["N"], r["M"], r["H"], r["D"], r["dtype"]): r
               for r in rows if not r.get("named")}
    seed = SEEDS[0]
    inpaint = with_save_image(docs["inpaint"])
    seed_node = next(n for n, node in inpaint.items()
                     if isinstance(node, dict)
                     and node.get("class_type") == "DistributedSeed")
    inpaint[seed_node]["inputs"]["seed"] = seed
    inpaint_refs = []
    for k in range(3):   # the master's slice, w0's, and w1's
        req = copy.deepcopy(docs["inpaint"])
        req[seed_node]["inputs"]["seed"] = seed + k
        inpaint_refs.append({"same": WorkflowExecutor(OpContext(
            device=DEVICE, input_dir=input_dir)).execute(req).image_batch[0]})
    registry.clear_pipeline_cache()
    gc.collect()
    torch.cuda.empty_cache()
    free, total = torch.cuda.mem_get_info()
    print(f"phase 14: {free} of {total} bytes of device memory free before "
          f"the servers start", flush=True)
    if free < DRILL_MIN_FREE:
        fail(f"phase 14 needs {DRILL_MIN_FREE} bytes free for three SD1.5 "
             f"servers, {free} are")
    up = with_save_image(docs["upscale"])
    up["2"]["inputs"]["seed"] = 42
    # phase 7 read no file (its 512^2 test card); every server here holds
    # the inpaint's input.png, so the upscale names a file none has
    up["1"]["inputs"]["image"] = "drill_test_card.png"
    size, p = up["16"]["inputs"], up["2"]["inputs"]
    n_tiles = len(tiling.calculate_tiles(size["width"], size["height"],
                                         p["tile_width"], p["tile_height"]))
    lost_tiles = len(tiling.partition_tiles(n_tiles, 2)[2])
    drills = []
    with tempfile.TemporaryDirectory() as root:
        roles = {"serve": ("serve", drill_env("serve")),
                 "w0": ("worker", drill_env("w0")),
                 "w1": ("worker", drill_env("w1"))}
        cluster = Cluster(root, roles)
        for role in roles:
            for name in ("input.png", "source.png"):
                shutil.copy(os.path.join(input_dir, name),
                            os.path.join(cluster.dirs[role], "input"))
        master = cluster.url("serve")
        with open(os.path.join(cluster.dirs["serve"], "cluster_config.json"),
                  "w") as f:
            json.dump({"master": {"host": "127.0.0.1"},
                       "workers": [{"id": w, "name": w, "host": "127.0.0.1",
                                    "port": cluster.ports[w],
                                    "enabled": True}
                                   for w in ("w0", "w1")]}, f)
        for role in ("w0", "w1"):
            roles[role][1]["DTPU_MASTER_URL"] = master

        def wait_healthy(role):
            deadline = time.time() + FANOUT_START_S
            while get_json(master + "/distributed/cluster")["workers"].get(
                    role, {}).get("state") != "healthy":
                if time.time() > deadline:
                    cluster.fail(f"{role} never registered healthy")
                time.sleep(0.2)

        try:
            t0 = time.perf_counter()
            cluster.launch("serve")
            cluster.launch("w0")
            cluster.launch("w1", {**roles["w1"][1], "DTPU_FAULT_INJECT":
                                  json.dumps({"stall_s": DRILL_STALL_S})})
            cluster.wait_up(roles)
            for role in ("w0", "w1"):
                wait_healthy(role)
            started_s = time.perf_counter() - t0
            # partition_tiles(16, 2): master 0-5, w0 6-10, w1 11-15
            drills.append(drill_request(
                cluster, "1 straggler hedged (cold)", "upscale", up,
                "stall", lost_tiles, [{"one_batch": upscale_ref}], checked))
            emit("drill", drills[-1])
            drills.append(drill_request(
                cluster, "2 dead worker, tiles reassigned (warm)", "upscale",
                up, "kill", lost_tiles, [{"one_batch": upscale_ref}],
                checked))
            emit("drill", drills[-1])
            t1 = time.perf_counter()
            cluster.launch("w1")
            cluster.wait_up(["w1"])
            wait_healthy("w1")
            restart_s = time.perf_counter() - t1
            drills.append(drill_request(
                cluster, "3 dead worker, slice redispatched (warm master)",
                "inpaint", copy.deepcopy(inpaint), "kill", 1, inpaint_refs,
                checked))
            emit("drill", drills[-1])
        finally:
            cluster.stop()
    return {"free_bytes_before": free, "servers_start_s": started_s,
            "w1_restart_s": restart_s,
            "seconds": {d["drill"]: d["seconds"] for d in drills},
            "fault_to_success_s": {d["drill"]: d["fault_to_success_s"]
                                   for d in drills},
            "peak_memory": {d["drill"]: d["peak_memory"] for d in drills},
            "ledger": {d["drill"]: d["ledger"] for d in drills}}, \
        inpaint_refs


def proc_tree(pid):
    """``pid`` and its descendants, from the parent pids in
    ``/proc/*/stat``."""
    children = collections.defaultdict(list)
    for d in os.listdir("/proc"):
        if d.isdigit():
            try:
                with open(f"/proc/{d}/stat", "r", errors="replace") as f:
                    fields = f.read().rsplit(")", 1)[-1].split()
            except OSError:
                continue
            children[int(fields[1])].append(int(d))
    tree, frontier = [pid], [pid]
    while frontier:
        kids = children.get(frontier.pop(), [])
        tree.extend(kids)
        frontier.extend(kids)
    return tree


def pid_alive(pid):
    """``/proc/<pid>`` exists and is no zombie (an exited process whose
    parent has not reaped it)."""
    try:
        with open(f"/proc/{pid}/stat", "r", errors="replace") as f:
            return f.read().rsplit(")", 1)[-1].split()[0] != "Z"
    except OSError:
        return False


def compute_apps():
    out = subprocess.run(
        ["nvidia-smi", "--query-compute-apps=pid,used_memory",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    return out.stdout.strip().splitlines()


def ps_branch_drill(cluster):
    """The tree kill's ``ps`` branch on this machine, whatever the server
    used: a process, its child and its grandchild (sleeps), killed by
    ``kill_process_tree`` with psutil set aside; none may be alive
    after."""
    from comfyui_distributed_tpu_torch.utils import process
    code = ("import subprocess, sys, time; subprocess.Popen([sys.executable,"
            " '-c', 'import subprocess, sys, time; subprocess.Popen("
            "[sys.executable, \"-c\", \"import time; time.sleep(60)\"]); "
            "time.sleep(60)']); time.sleep(60)")
    root = subprocess.Popen([sys.executable, "-c", code])
    try:
        deadline = time.time() + 30
        while len(proc_tree(root.pid)) < 3:
            if time.time() > deadline:
                cluster.fail("the ps drill's tree did not start")
            time.sleep(0.05)
        tree = proc_tree(root.pid)
        saved, process.psutil = process.psutil, None
        try:
            t0 = time.perf_counter()
            ok, branch = process.kill_process_tree(root.pid)
            seconds = time.perf_counter() - t0
        finally:
            process.psutil = saved
        root.wait(timeout=10)
        alive = [p for p in tree if pid_alive(p)]
        if not ok or branch != "ps" or alive:
            cluster.fail(f"ps branch: {ok}, {branch}, {alive} of {tree} "
                         f"alive")
        return {"tree": tree, "seconds": seconds, "branch": branch}
    finally:
        if root.poll() is None:
            root.kill()
            root.wait()


def master_request(cluster, doc, interrupt_at=None, route="/interrupt"):
    """One request through the master's /prompt, its history entry and its
    ``dtpu-torch prompt`` line.  ``interrupt_at``: seconds after the
    master logs the start of the KSampler node (its debug tier's ``exec
    node`` line) at which ``route`` is posted; the seconds from /prompt
    to that line and from the post to the history entry are returned."""
    from comfyui_distributed_tpu_torch.utils.net import get_json, post_json
    master = cluster.url("serve")
    n_lines = len(cluster.prompt_lines("serve"))
    ks_line = next(f"exec node {nid} (KSampler)" for nid, node in doc.items()
                   if isinstance(node, dict)
                   and node.get("class_type") == "KSampler")
    n_ks = cluster.count_lines("serve", ks_line)
    files0 = set(cluster.outputs())
    t0 = time.perf_counter()
    resp = post_json(master + "/prompt", {"prompt": doc,
                                          "client_id": "chip_smoke"})
    deadline = time.time() + FANOUT_REQUEST_S
    out = {"workers": resp.get("workers"), "interrupt_answer": None,
           "interrupt_at_s": interrupt_at}
    if interrupt_at is not None:
        while cluster.count_lines("serve", ks_line) <= n_ks:
            if time.time() > deadline:
                cluster.fail(f"the master logged no '{ks_line}' line")
            time.sleep(0.005)
        t_ks = time.perf_counter()
        out["ksampler_start_s"] = t_ks - t0
        time.sleep(interrupt_at)
        t_int = time.perf_counter()
        out["interrupt_answer"] = post_json(master + route, {})
    while True:
        hist = get_json(master + "/history")
        if resp["prompt_id"] in hist:
            break
        if time.time() > deadline:
            cluster.fail(f"no history after {FANOUT_REQUEST_S} s")
        time.sleep(0.01)
    t_end = time.perf_counter()
    while len(cluster.prompt_lines("serve")) <= n_lines:
        if time.time() > deadline:
            cluster.fail("no prompt line for the request")
        time.sleep(0.05)
    out.update(entry=hist[resp["prompt_id"]],
               line=cluster.prompt_lines("serve")[n_lines],
               seconds=t_end - t0,
               files=sorted(set(cluster.outputs()) - files0))
    if interrupt_at is not None:
        out["interrupt_to_end_s"] = t_end - t_int
    return out


def worker_management(docs, txt_refs, rows):
    """Phase 15: worker management and the control routes on one card.
    A ``cli serve`` master starts with w0 in its config (local, enabled,
    not running); w0 is launched through the master's route, runs its
    share of a txt2img fan-out, and the master alone has an SDXL request
    interrupted mid-sampling; then the cluster is interrupted during a
    fan-out, both servers' memory cleared, w0 stopped, launched again and
    left to the monitor when the master is killed.  ``txt_refs``: phase
    8's in-process images of the two shares; ``rows``: phase 3's checks.
    Returns the report and the interrupted request's launches (by
    variant and by shape) for the ``kernels`` line."""
    import gc

    import numpy as np
    import torch

    from comfyui_distributed_tpu_torch.models import registry
    from comfyui_distributed_tpu_torch.utils import constants as C
    from comfyui_distributed_tpu_torch.utils.image import decode_png
    from comfyui_distributed_tpu_torch.utils.net import (find_free_port,
                                                         get_json, post_json)

    checked = {(r["B"], r["N"], r["M"], r["H"], r["D"], r["dtype"]): r
               for r in rows if not r.get("named")}
    registry.clear_pipeline_cache()
    gc.collect()
    torch.cuda.empty_cache()
    seed = SEEDS[0]
    txt = with_save_image(docs["txt2img"])
    txt["13"]["inputs"]["seed"] = seed
    refs = [{"same": ref} for ref in txt_refs]
    report = {"card": card_line()}
    trees = []           # every worker tree this phase started
    with tempfile.TemporaryDirectory() as root:
        serve_dir = os.path.join(root, "serve")
        # the master runs in its own directory (its managed workers log to
        # serve_dir/logs/workers) and finds the package on PYTHONPATH
        env = {**PHASE8_ROLES["serve"][1], "PYTHONPATH": os.pathsep.join(
            p for p in (ROOT, os.environ.get("PYTHONPATH")) if p)}
        cluster = Cluster(root, {"serve": ("serve", env)}, cwd=serve_dir)
        master = cluster.url("serve")
        wport = find_free_port()
        w0_dir = os.path.join(root, "w0")
        os.makedirs(os.path.join(w0_dir, "input"))
        with open(os.path.join(serve_dir, "cluster_config.json"), "w") as f:
            json.dump({"master": {"host": "127.0.0.1",
                                  "port": cluster.ports["serve"]},
                       "workers": [{
                           "id": "w0", "name": "w0", "host": "127.0.0.1",
                           "port": wport, "enabled": True,
                           "extra_args": f"--host 127.0.0.1 --device "
                                         f"{DEVICE} --input-dir "
                                         f"{w0_dir}/input --output-dir "
                                         f"{w0_dir}/output"}],
                       "settings": {"auto_launch_workers": False,
                                    "stop_workers_on_master_exit": True,
                                    "debug": True}},
                      f)

        def saved(files):
            with open(os.path.join(serve_dir, "output", files[-1]),
                      "rb") as f:
                return decode_png(f.read())[0]

        def launch():
            t0 = time.perf_counter()
            entry = post_json(master + "/distributed/launch_worker",
                              {"id": "w0"})["worker"]
            trees.append([entry["pid"]])
            if not get_json(master + "/distributed/managed_workers")[
                    "w0"]["alive"]:
                cluster.fail("w0 is not alive after its launch")
            while get_json(master + "/distributed/managed_workers")[
                    "w0"]["launching"]:
                if time.perf_counter() - t0 > PHASE15_READY_S:
                    cluster.fail(f"w0's launching did not clear in "
                                 f"{PHASE15_READY_S} s")
                time.sleep(0.1)
            trees[-1] = proc_tree(entry["pid"])
            return entry, time.perf_counter() - t0

        try:
            cluster.start()
            # 1. the launch, through the master's route
            entry, ready_s = launch()
            wlog = get_json(master + "/distributed/worker_log?id=w0")["log"]
            if "=== session" not in wlog or "worker listening on" not in wlog:
                cluster.fail(f"w0's log lacks its session header or its "
                             f"listening line: {wlog[-2000:]}")
            cluster.ports["worker"] = wport
            cluster.logs["worker"] = entry["log_file"]
            report["launch"] = {"pid": entry["pid"],
                                "tree": len(trees[-1]),
                                "launch_to_ready_s": ready_s,
                                "bound_s": PHASE15_READY_S}
            print(f"phase 15: w0 launched, ready after {ready_s:.3f} s",
                  flush=True)
            # 2. its share of a fan-out (cold: both servers fill SDXL)
            report["fanout"] = fanout_request(
                cluster, "txt2img", copy.deepcopy(txt), EXPECTED["txt2img"][1],
                refs, checked)
            # 3. the master alone: one run to time the steps by, one
            # interrupted at half its KSampler, then 4. the same again
            post_json(master + "/distributed/config/update_worker",
                      {"id": "w0", "enabled": False})
            def check_launches(name, line, interrupted):
                """A prompt line's launches: sm90 alone, at shapes phase 3
                checked, and 2800 of them, or (``interrupted``) a whole
                number of steps between 0 and 2800."""
                launches = line["launches"]
                bad_shapes = [x[:6] for x in line["launches_by_shape"]
                              if tuple(x[:6]) not in checked]
                if bad_shapes or launches["mma_sync"] or launches["fp32"]:
                    cluster.fail(f"{name}: launches {launches}, unchecked "
                                 f"shapes {bad_shapes}")
                n = launches["sm90"]
                if not interrupted:
                    if n != EXPECTED["txt2img"][1]:
                        cluster.fail(f"{name}: {n} sm90 launches")
                elif not (0 < n < EXPECTED["txt2img"][1]
                          and n % SDXL_STEP_LAUNCHES == 0):
                    cluster.fail(f"{name}: {n} sm90 launches, not a whole "
                                 f"number of steps between 0 and 2800")

            def master_alone(name, at=None):
                """A request on the master alone, checked: success with
                2800 sm90 launches and one saved image, or (``at``)
                interrupted after a whole number of steps."""
                r = master_request(cluster, copy.deepcopy(txt), at)
                if r["workers"] is not None:
                    cluster.fail(f"{name}: dispatched to {r['workers']}")
                check_launches(name, r["line"], at is not None)
                if at is None:
                    if r["entry"].get("status") != "success" \
                            or len(r["files"]) != 1:
                        cluster.fail(f"{name}: {r['entry']}, {r['files']}")
                    return r
                if r["entry"].get("status") != "error" \
                        or r["entry"].get("error") != "execution interrupted":
                    cluster.fail(f"{name}: {r['entry']}")
                if r["interrupt_to_end_s"] > PHASE15_INTERRUPT_END_S:
                    cluster.fail(f"{name} ended {r['interrupt_to_end_s']} "
                                 f"s after /interrupt")
                return r

            calib = master_alone("calibration")
            # the interrupt lands half-way through KSampler: half the
            # calibration's KSampler seconds after the master logs the
            # node's start
            ksampler_s = next(v for k, v in calib["line"]["node_seconds"]
                              .items() if k.endswith(" KSampler"))
            intr = master_alone("interrupted", 0.5 * ksampler_s)
            nxt = master_alone("next")
            runs = {"calibration": calib, "interrupted": intr, "next": nxt}
            if not np.array_equal(saved(nxt["files"]),
                                  saved(calib["files"])):
                cluster.fail("the request after the interrupt differs from "
                             "the uninterrupted one")
            same = image_diff(os.path.join(serve_dir, "output",
                                           calib["files"][0]), txt_refs[0])
            if not (same[0] <= FANOUT_ATOL["same"][0]
                    and same[1] <= FANOUT_ATOL["same"][1]):
                cluster.fail(f"the master's image differs from phase 8's "
                             f"in-process one by {same}")
            report["interrupt"] = {
                "ksampler_start_s": intr["ksampler_start_s"],
                "interrupt_after_ksampler_start_s": intr["interrupt_at_s"],
                "interrupt_to_end_s": intr["interrupt_to_end_s"],
                "bound_s": PHASE15_INTERRUPT_END_S,
                "step_wall_s": ksampler_s / 20,
                "steps_done": intr["line"]["launches"]["sm90"]
                // SDXL_STEP_LAUNCHES,
                "launches": intr["line"]["launches"],
                "entry": intr["entry"],
                "seconds": {k: v["seconds"] for k, v in runs.items()},
                "next_equal_to_uninterrupted": True,
                "vs_phase8": {"max": same[0], "mean": same[1]}}
            print(f"phase 15: /interrupt to the end of the request "
                  f"{intr['interrupt_to_end_s']:.3f} s, one step "
                  f"{ksampler_s / 20:.3f} s, "
                  f"{report['interrupt']['steps_done']} of 20 steps done",
                  flush=True)
            # 5. the cluster interrupted during a fan-out
            post_json(master + "/distributed/config/update_worker",
                      {"id": "w0", "enabled": True})
            n_worker = len(cluster.prompt_lines("worker"))
            ci = master_request(cluster, copy.deepcopy(txt),
                                0.5 * ksampler_s,
                                route="/distributed/cluster/interrupt")
            if ci["workers"] != ["w0"] \
                    or ci["interrupt_answer"].get("workers") != {"w0": 200}:
                cluster.fail(f"cluster interrupt: dispatched to "
                             f"{ci['workers']}, answer "
                             f"{ci['interrupt_answer']}")
            if ci["entry"].get("error") != "execution interrupted" \
                    or ci["interrupt_to_end_s"] \
                    > PHASE15_CLUSTER_INTERRUPT_END_S:
                cluster.fail(f"cluster interrupt: {ci['entry']} after "
                             f"{ci['interrupt_to_end_s']} s")
            deadline = time.time() + 60
            while len(cluster.prompt_lines("worker")) <= n_worker:
                if time.time() > deadline:
                    cluster.fail("w0 logged no prompt line for its share")
                time.sleep(0.05)
            wline = cluster.prompt_lines("worker")[n_worker]
            if wline.get("error") != "execution interrupted":
                cluster.fail(f"w0's share was not interrupted: {wline}")
            check_launches("the master's interrupted share", ci["line"],
                           True)
            check_launches("w0's interrupted share", wline, True)
            report["cluster_interrupt"] = {
                "answer": ci["interrupt_answer"],
                "ksampler_start_s": ci["ksampler_start_s"],
                "interrupt_after_ksampler_start_s": ci["interrupt_at_s"],
                "interrupt_to_end_s": ci["interrupt_to_end_s"],
                "bound_s": PHASE15_CLUSTER_INTERRUPT_END_S,
                "launches": {"master": ci["line"]["launches"],
                             "w0": wline["launches"]}}
            # 6. clear memory on both servers
            apps_before = compute_apps()
            cleared = post_json(master + "/distributed/cluster/clear_memory",
                                {})
            apps_after = compute_apps()
            print(f"phase 15: nvidia-smi compute apps before "
                  f"{apps_before}, after {apps_after}", flush=True)
            freed = cleared.get("freed_bytes", {})
            if cleared.get("workers") != {"w0": 200} or any(
                    freed.get(k, 0) <= PHASE15_CLEAR_MIN_FREED
                    for k in ("master", "w0")):
                cluster.fail(f"clear_memory: {cleared}")
            report["clear_memory"] = {**cleared, "apps_before": apps_before,
                                      "apps_after": apps_after,
                                      "min_freed": PHASE15_CLEAR_MIN_FREED}
            # 7. the stop: no process of the tree outlives it
            tree = proc_tree(entry["pid"])
            t0 = time.perf_counter()
            post_json(master + "/distributed/stop_worker", {"id": "w0"})
            stop_s = time.perf_counter() - t0
            alive = [p for p in tree if pid_alive(p)]
            with open(cluster.logs["serve"], "r", errors="replace") as f:
                branch = re.findall(r"stopped worker w0 \(pid \d+, kill "
                                    r"branch (\w+)\)", f.read())
            if alive or not branch:
                cluster.fail(f"stop_worker left {alive} of {tree} alive "
                             f"(kill branch {branch})")
            report["stop"] = {"tree": tree, "seconds": stop_s,
                              "kill_branch": branch[-1]}
            print(f"phase 15: w0 stopped in {stop_s:.3f} s, tree {tree}, "
                  f"kill branch {branch[-1]}", flush=True)
            report["stop"]["ps_branch"] = ps_branch_drill(cluster)
            # 8. launched again, then the master dies
            entry, relaunch_s = launch()
            tree = trees[-1]
            if len(tree) < 2:
                cluster.fail(f"w0's tree {tree}: no monitor and worker")
            t0 = time.perf_counter()
            cluster.kill("serve")
            bound_s = 2 * C.WORKER_CHECK_INTERVAL \
                + C.PROCESS_TERMINATION_TIMEOUT
            while any(pid_alive(p) for p in tree):
                if time.perf_counter() - t0 > 3 * bound_s:
                    break
                time.sleep(0.05)
            gone_s = time.perf_counter() - t0
            alive = [p for p in tree if pid_alive(p)]
            if alive or gone_s > bound_s:
                cluster.fail(f"after the master's death {alive} of {tree} "
                             f"were alive at {gone_s:.3f} s (bound "
                             f"{bound_s} s)")
            report["master_death"] = {"tree": tree,
                                      "relaunch_to_ready_s": relaunch_s,
                                      "kill_to_gone_s": gone_s,
                                      "bound_s": bound_s}
            print(f"phase 15: the master killed; w0's tree gone after "
                  f"{gone_s:.3f} s", flush=True)
        finally:
            cluster.stop()
            for tree in trees:
                for p in tree:
                    if pid_alive(p):
                        os.kill(p, signal.SIGKILL)
    interrupted = {"path": "txt2img interrupted",
                   "variants": intr["line"]["launches"],
                   "shapes": {tuple(x[:6]): x[6] for x in
                              intr["line"]["launches_by_shape"]}}
    return report, interrupted


def master_failover(docs, input_dir, upscale_ref, inpaint_refs,
                    phase8_warm_s, rows):
    """Phase 16: the fan-out survives its master's death on one card.  A
    durable master A (``DTPU_WAL_DIR``, fsync always, a
    ``PHASE16_MASTER_LEASE_S`` lease), a standby B on the same log, and
    workers w0 and w1 (w1 stalling ``PHASE16_STALL_S`` before it sends)
    start as four ``cli`` servers.  References on A with w1 disabled:
    the upscale cold and twice warm and the inpaint fan-out.  Drill 1:
    the upscale with w1, A and w1 SIGKILLed once every tile but w1's is
    in; B takes over when the lease expires, resumes the prompt under
    its id, blends the stored tiles and redispatches w1's to w0.  Drill
    2: the inpaint fan-out on B with a new w1, B and w1 SIGKILLed once
    w0's slice is in; B restarted in place resumes it, loads w0's slice
    and redispatches w1's.  Then ``cli wal`` verifies the log.
    ``upscale_ref``: phase 7's image; ``inpaint_refs``: phase 14's
    in-process slices at seeds s, s + 1, s + 2; ``phase8_warm_s``: phase
    8's warm fan-out upscale; ``rows``: phase 3's checks.  Returns the
    report and every server's launches (by variant and by shape)."""
    import gc

    import torch

    from comfyui_distributed_tpu_torch.models import registry
    from comfyui_distributed_tpu_torch.ops import tiling
    from comfyui_distributed_tpu_torch.runtime import durable
    from comfyui_distributed_tpu_torch.utils.image import decode_png
    from comfyui_distributed_tpu_torch.utils.net import get_json, post_json

    checked = {(r["B"], r["N"], r["M"], r["H"], r["D"], r["dtype"]): r
               for r in rows if not r.get("named")}
    registry.clear_pipeline_cache()
    gc.collect()
    torch.cuda.empty_cache()
    free, total = torch.cuda.mem_get_info()
    print(f"phase 16: {free} of {total} bytes of device memory free before "
          f"the servers start", flush=True)
    if free < PHASE16_MIN_FREE:
        fail(f"phase 16 needs {PHASE16_MIN_FREE} bytes free for four SD1.5 "
             f"servers, {free} are")
    seed = SEEDS[0]
    up = with_save_image(docs["upscale"])
    up["2"]["inputs"]["seed"] = 42
    up["1"]["inputs"]["image"] = "drill_test_card.png"   # as in phase 14
    size, p = up["16"]["inputs"], up["2"]["inputs"]
    n_tiles = len(tiling.calculate_tiles(size["width"], size["height"],
                                         p["tile_width"], p["tile_height"]))
    w1_tiles = len(tiling.partition_tiles(n_tiles, 2)[2])
    inpaint = with_save_image(docs["inpaint"])
    seed_node = next(n for n, node in inpaint.items()
                     if isinstance(node, dict)
                     and node.get("class_type") == "DistributedSeed")
    inpaint[seed_node]["inputs"]["seed"] = seed
    launches = {"variants": collections.Counter(),
                "shapes": collections.Counter()}
    report = {"card": card_line(), "free_bytes_before": free,
              "settings": {"master_lease_s": PHASE16_MASTER_LEASE_S,
                           "wal_sync": "always", "stall_s": PHASE16_STALL_S,
                           "hedge": 0}}
    with tempfile.TemporaryDirectory() as root:
        wal_dir = os.path.join(root, "wal")
        durable_env = {"DTPU_WAL_DIR": wal_dir, "DTPU_WAL_SYNC": "always",
                       "DTPU_MASTER_LEASE_S": str(PHASE16_MASTER_LEASE_S),
                       "DTPU_HEDGE": "0", "DTPU_FAULT_POLICY": "reassign"}
        stall = json.dumps({"stall_s": PHASE16_STALL_S})
        roles = {"A": ("serve", durable_env),
                 "B": ("serve", {**durable_env, "DTPU_STANDBY": "1",
                                 "DTPU_MASTER_ID": "B"}),
                 "w0": ("worker", {"DTPU_WORKER_ID": "w0"}),
                 "w1": ("worker", {"DTPU_WORKER_ID": "w1",
                                   "DTPU_FAULT_INJECT": stall})}
        cluster = Cluster(root, roles)
        for role in roles:
            for name in ("input.png", "source.png"):
                shutil.copy(os.path.join(input_dir, name),
                            os.path.join(cluster.dirs[role], "input"))
        for role, w1_on in (("A", False), ("B", True)):
            with open(os.path.join(cluster.dirs[role],
                                   "cluster_config.json"), "w") as f:
                json.dump({"master": {"host": "127.0.0.1"},
                           "workers": [{"id": w, "name": w,
                                        "host": "127.0.0.1",
                                        "port": cluster.ports[w],
                                        "enabled": w == "w0" or w1_on}
                                       for w in ("w0", "w1")]}, f)
        for role in ("w0", "w1"):
            roles[role][1]["DTPU_MASTER_URL"] = cluster.url("A")

        def outputs(role):
            d = os.path.join(cluster.dirs[role], "output")
            return sorted(os.path.join(d, f) for f in os.listdir(d)) \
                if os.path.isdir(d) else []

        def wait_healthy(master, role):
            deadline = time.time() + FANOUT_START_S
            while get_json(cluster.url(master) + "/distributed/cluster")[
                    "workers"].get(role, {}).get("state") != "healthy":
                if time.time() > deadline:
                    cluster.fail(f"{role} never read healthy at {master}")
                time.sleep(0.2)

        def history(master, pid, what):
            deadline = time.time() + FANOUT_REQUEST_S
            while True:
                try:
                    hist = get_json(cluster.url(master) + "/history")
                except OSError:
                    hist = {}     # a restarted master binds a moment later
                if pid in hist:
                    if hist[pid].get("status") != "success":
                        cluster.fail(f"{what}: history {hist[pid]}")
                    return hist[pid]
                if time.time() > deadline:
                    cluster.fail(f"{what}: no history after "
                                 f"{FANOUT_REQUEST_S} s")
                time.sleep(0.05)

        def post(master, doc, workers, what):
            resp = post_json(cluster.url(master) + "/prompt",
                             {"prompt": copy.deepcopy(doc),
                              "client_id": "chip_smoke"})
            if sorted(resp.get("workers", [])) != workers \
                    or resp.get("failed_workers"):
                cluster.fail(f"{what}: {master} did not fan out to "
                             f"{workers}: {resp}")
            return resp["prompt_id"]

        lines_seen = {r: 0 for r in roles}

        def new_lines(role, what):
            """A server's prompt lines since the last call: sm90 alone
            (or none) at shapes phase 3 checked, counted for the kernels
            line."""
            lines = cluster.prompt_lines(role)[lines_seen[role]:]
            lines_seen[role] += len(lines)
            for line in lines:
                lv = line["launches"]
                if lv["mma_sync"] or lv["fp32"] or line["status"] \
                        != "success":
                    cluster.fail(f"{what}: {role}'s share {line}")
                by_shape = {tuple(x[:6]): x[6]
                            for x in line["launches_by_shape"]}
                missing = [x for x in by_shape if x not in checked]
                if missing:
                    cluster.fail(f"{what}: {role} launched shapes that "
                                 f"phase 3 did not check: {missing}")
                launches["variants"].update(lv)
                launches["shapes"].update(by_shape)
            return lines

        def wait_lines(role, n, what):
            deadline = time.time() + FANOUT_REQUEST_S
            got = []
            while len(got) < n:
                got += new_lines(role, what)
                if time.time() > deadline:
                    cluster.fail(f"{what}: {len(got)} prompt lines from "
                                 f"{role}, expected {n}")
                time.sleep(0.05)
            return got

        def check_diff(path, ref_img, key, what):
            dmax, dmean = image_diff(path, ref_img)
            tol_max, tol_mean = (0.0, 0.0) if key == "bit" \
                else FANOUT_ATOL[key]
            if not (dmax <= tol_max and dmean <= tol_mean):
                cluster.fail(f"{what}: {os.path.basename(path)} differs from "
                             f"its {key!r} reference by max {dmax}, mean "
                             f"{dmean} (limits {tol_max}, {tol_mean})")
            return {"max": dmax, "mean": dmean}

        def saved(path):
            with open(path, "rb") as f:
                return decode_png(f.read())[0]

        def wait_logged(kind, units, what):
            """Until the log holds ``units`` checked-in units of its open
            job of ``kind``: a unit reads done in the ledger's memory
            before its spill and record are on disk."""
            deadline = time.time() + FANOUT_REQUEST_S
            while True:
                state, _ = durable.replay(wal_dir)
                done = [sum(u["done"] for u in job["units"].values())
                        for job in state.jobs.values() if job["kind"] == kind]
                if done and done[0] >= units:
                    return done[0]
                if time.time() > deadline:
                    cluster.fail(f"{what}: the log never held {units} "
                                 f"{kind} units: {state.jobs}")
                time.sleep(0.05)

        try:
            t0 = time.perf_counter()
            # A holds the lease before B looks at it: a standby reads no
            # lease as an expired one
            cluster.launch("A")
            cluster.wait_up(["A"])
            for role in ("B", "w0", "w1"):
                cluster.launch(role)
            cluster.wait_up(["B", "w0", "w1"])
            for role in ("w0", "w1"):
                wait_healthy("A", role)
            report["servers_start_s"] = time.perf_counter() - t0
            info = get_json(cluster.url("A") + "/distributed/durability")
            binfo = get_json(cluster.url("B") + "/distributed/durability")
            if info.get("epoch") != 1 or info.get("role") != "active" \
                    or binfo.get("role") != "standby":
                cluster.fail(f"A {info}, B {binfo}: expected A active at "
                             f"epoch 1 and B standing by")

            # references on A, w1 disabled: A and w0 a half each
            refs = {}
            for run in ("cold", "warm", "warm 2"):
                t1 = time.perf_counter()
                pid = post("A", up, ["w0"], f"upscale {run}")
                history("A", pid, f"upscale {run}")
                secs = time.perf_counter() - t1
                (line,) = wait_lines("A", 1, f"upscale {run}")
                wait_lines("w0", 1, f"upscale {run}")
                path = outputs("A")[-1]
                refs[f"upscale {run}"] = {
                    "seconds": secs, "path": path,
                    "stage_seconds": {k: line["stage_seconds"].get(k) for k in
                                      ("wal_spill", "wal_append",
                                       "tile_collect", "tile_sample")},
                    "vs_phase7": check_diff(path, upscale_ref, "one_batch",
                                            f"upscale {run}")}
            files0 = set(outputs("A"))
            pid = post("A", inpaint, ["w0"], "inpaint reference")
            history("A", pid, "inpaint reference")
            wait_lines("A", 1, "inpaint reference")
            wait_lines("w0", 1, "inpaint reference")
            inpaint_files = sorted(set(outputs("A")) - files0)
            if len(inpaint_files) != 2:
                cluster.fail(f"inpaint reference: {inpaint_files}")
            refs["inpaint"] = [check_diff(f, r["same"], "bit",
                                          "inpaint reference")
                               for f, r in zip(inpaint_files, inpaint_refs)]
            report["references"] = {k: {kk: vv for kk, vv in v.items()
                                        if kk != "path"}
                                    if isinstance(v, dict) else v
                                    for k, v in refs.items()}
            warm = [refs[k] for k in ("upscale warm", "upscale warm 2")]
            report["spill"] = {
                "warm_upscale_s": [r["seconds"] for r in warm],
                "wal_spill_s": [r["stage_seconds"]["wal_spill"] for r in warm],
                "wal_append_s": [r["stage_seconds"]["wal_append"]
                                 for r in warm],
                "phase8_warm_upscale_s": phase8_warm_s}
            print(f"phase 16: warm durable upscale {report['spill']}",
                  flush=True)

            # drill 1: a standby takes over during the upscale
            post_json(cluster.url("A") + "/distributed/config/update_worker",
                      {"id": "w1", "enabled": True})
            wait_healthy("A", "w1")
            files_b = set(outputs("B"))
            pid = post("A", up, ["w0", "w1"], "drill 1")
            done_at_kill = wait_logged("tile", n_tiles - w1_tiles, "drill 1")
            jobs = get_json(cluster.url("A") + "/distributed/cluster")[
                "ledger"]["active_jobs"]
            if [j["done_units"] for j in jobs.values()] != [done_at_kill]:
                cluster.fail(f"drill 1: A's ledger {jobs}, the log "
                             f"{done_at_kill} units done")
            with open(os.path.join(wal_dir, "master.lease")) as f:
                expires_at = json.load(f)["expires_at"]
            t_kill = time.perf_counter()
            wall_kill = time.time()
            cluster.kill("A")
            cluster.kill("w1")
            new_lines("A", "drill 1")    # A's lines before the kill
            while get_json(cluster.url("B") + "/distributed/durability").get(
                    "role") != "active":
                if time.perf_counter() - t_kill > FANOUT_START_S:
                    cluster.fail("drill 1: B never took over")
                time.sleep(0.05)
            t_takeover = time.perf_counter()
            history("B", pid, "drill 1")
            t_done = time.perf_counter()
            info = get_json(cluster.url("B") + "/distributed/durability")
            snap = get_json(cluster.url("B") + "/distributed/cluster")
            (job,) = [j for j in snap["ledger"]["completed_jobs"]
                      if j["kind"] == "tile"]
            if not (job["recovered"] and job["done_units"]
                    == job["total_units"] == n_tiles
                    and job["preloaded_units"] == done_at_kill
                    and job["reassigned_units"] >= w1_tiles):
                cluster.fail(f"drill 1: B's job {job}; expected recovered, "
                             f"{n_tiles} done, {done_at_kill} preloaded, "
                             f">= {w1_tiles} reassigned")
            if info.get("epoch") != 2 or info.get("takeovers") != 1:
                cluster.fail(f"drill 1: B's durability {info}")
            if snap["workers"].get("w0", {}).get("state") != "healthy" \
                    or not cluster.count_lines(
                        "w0", f"re-homed to master {cluster.url('B')}"):
                cluster.fail(f"drill 1: w0 at B {snap['workers'].get('w0')}, "
                             f"re-homed lines "
                             f"{cluster.count_lines('w0', 're-homed')}")
            (img,) = sorted(set(outputs("B")) - files_b)
            b_lines = wait_lines("B", 1, "drill 1")
            w0_lines = wait_lines("w0", 2, "drill 1")
            report["drill1"] = {
                "prompt_id": pid, "done_at_kill": done_at_kill,
                "kill_to_lease_expiry_s": expires_at - wall_kill,
                "kill_to_takeover_s": t_takeover - t_kill,
                "kill_to_success_s": t_done - t_kill,
                "ledger": job, "durability": info,
                "vs_A_reference": check_diff(
                    img, saved(refs["upscale warm"]["path"]), "one_batch",
                    "drill 1"),
                "vs_phase7": check_diff(img, upscale_ref, "one_batch",
                                        "drill 1"),
                "B_line": {k: b_lines[0].get(k) for k in (
                    "seconds", "launches", "node_seconds", "stage_seconds",
                    "max_memory_allocated")},
                "w0_lines": [{k: ln.get(k) for k in (
                    "seconds", "launches", "launches_by_shape",
                    "stage_seconds", "max_memory_allocated")}
                    for ln in w0_lines]}
            print(f"phase 16: drill 1 kill to lease expiry "
                  f"{expires_at - wall_kill:.3f} s, to takeover "
                  f"{t_takeover - t_kill:.3f} s, to success "
                  f"{t_done - t_kill:.3f} s", flush=True)

            # drill 2: B restarted in place during the inpaint fan-out
            roles["w1"][1]["DTPU_MASTER_URL"] = cluster.url("B")
            cluster.launch("w1")
            cluster.wait_up(["w1"])
            wait_healthy("B", "w1")
            files_b = set(outputs("B"))
            pid = post("B", inpaint, ["w0", "w1"], "drill 2")
            wait_logged("image", 1, "drill 2")
            t_kill = time.perf_counter()
            cluster.kill("B")
            cluster.kill("w1")
            new_lines("B", "drill 2")
            cluster.launch("B", {**durable_env, "DTPU_MASTER_ID": "B"})
            cluster.wait_up(["B"])
            history("B", pid, "drill 2")
            t_done = time.perf_counter()
            info = get_json(cluster.url("B") + "/distributed/durability")
            snap = get_json(cluster.url("B") + "/distributed/cluster")
            m1 = get_json(cluster.url("B") + "/distributed/metrics")
            (job,) = [j for j in snap["ledger"]["completed_jobs"]
                      if j["kind"] == "image"]
            if not (job["recovered"] and job["done_units"]
                    == job["total_units"] == 2 and job["preloaded_units"] == 1
                    and job["reassigned_units"] >= 1):
                cluster.fail(f"drill 2: B's job {job}; expected recovered, "
                             f"2 done, 1 preloaded, >= 1 reassigned")
            if info.get("epoch") != 3 or info.get("owner") != "B":
                cluster.fail(f"drill 2: B's durability {info}")
            if m1["images_received"] != 1:
                cluster.fail(f"drill 2: the restarted B received "
                             f"{m1['images_received']} images, expected w1's "
                             f"slice alone")
            files = sorted(set(outputs("B")) - files_b)
            if len(files) != 3:
                cluster.fail(f"drill 2: {len(files)} new PNGs, expected 3")
            b_lines = wait_lines("B", 1, "drill 2")
            # w0's own slice, then w1's redispatched: never its own again
            w0_lines = wait_lines("w0", 2, "drill 2")
            while get_json(cluster.url("w0") + "/prompt")["exec_info"][
                    "queue_remaining"]:
                time.sleep(0.1)
            if new_lines("w0", "drill 2"):
                cluster.fail("drill 2: w0 rendered a slice again")
            report["drill2"] = {
                "prompt_id": pid, "kill_to_success_s": t_done - t_kill,
                "ledger": job, "durability": info,
                "vs_in_process": [check_diff(f, r["same"], "bit", "drill 2")
                                  for f, r in zip(files, inpaint_refs)],
                "vs_A_reference": [check_diff(f, saved(r), "bit", "drill 2")
                                   for f, r in zip(files, inpaint_files)],
                "B_line": {k: b_lines[0].get(k) for k in (
                    "seconds", "launches", "node_seconds", "stage_seconds",
                    "max_memory_allocated")},
                "w0_lines": [{k: ln.get(k) for k in (
                    "seconds", "launches", "max_memory_allocated")}
                    for ln in w0_lines]}
            print(f"phase 16: drill 2 kill to success "
                  f"{t_done - t_kill:.3f} s", flush=True)
        finally:
            cluster.stop()
        out = subprocess.run(
            [sys.executable, "-m", "comfyui_distributed_tpu_torch.cli", "wal",
             "--dir", wal_dir, "--json"], cwd=ROOT, capture_output=True,
            text=True, timeout=120)
        if out.returncode != 0:
            fail(f"cli wal exited {out.returncode}: {out.stdout[-2000:]} "
                 f"{out.stderr[-2000:]}")
        verified = json.loads(out.stdout)
        if not verified["ok"] or any(
                s["checksum"].startswith("CORRUPT")
                for s in verified["segments"]):
            fail(f"cli wal: {verified['segments']}")
        report["wal"] = {
            "segments": [{k: s[k] for k in ("segment", "bytes", "records",
                                             "checksum")}
                         for s in verified["segments"]],
            "snapshots": verified["snapshots"],
            "records_by_type": verified["records_by_type"],
            "lease": verified["lease"],
            "pending_prompts": verified["replay"]["pending_prompts"],
            "active_jobs": verified["replay"]["active_jobs"]}
        print(f"phase 16: cli wal {json.dumps(report['wal'])}", flush=True)
    report["launches"] = dict(launches["variants"])
    return report, {"path": "phase 16",
                    "variants": dict(launches["variants"]),
                    "shapes": dict(launches["shapes"])}


def wal_records(dirpath):
    """Every record of a log directory's segments, in order."""
    from comfyui_distributed_tpu_torch.runtime import durable
    recs = []
    for _epoch, _seq, path in durable.list_segments(dirpath):
        recs += durable.read_segment(path)[0]
    return recs


def sharded_masters(docs, input_dir, upscale_ref, inpaint_refs, rows):
    """Phase 18: admission, SLOs and more than one master on one card.
    Sharded masters m0 and m1, workers w0 and w1 heartbeating both, and
    a ``cli router`` over the masters; the five drills of the module
    docstring.  ``upscale_ref``: phase 7's image; ``inpaint_refs``: phase
    14's in-process slices at seeds s, s + 1, s + 2; ``rows``: phase 3's
    checks.  Returns the report and every server's launches (by variant
    and by shape)."""
    import gc

    import torch

    from comfyui_distributed_tpu_torch.models import registry
    from comfyui_distributed_tpu_torch.ops import tiling
    from comfyui_distributed_tpu_torch.runtime import durable
    from comfyui_distributed_tpu_torch.runtime.shard import HashRing
    from comfyui_distributed_tpu_torch.utils.net import (
        find_free_port, get_json, post_json, request_json)

    checked = {(r["B"], r["N"], r["M"], r["H"], r["D"], r["dtype"]): r
               for r in rows if not r.get("named")}
    registry.clear_pipeline_cache()
    gc.collect()
    torch.cuda.empty_cache()
    free, total = torch.cuda.mem_get_info()
    print(f"phase 18: {free} of {total} bytes of device memory free before "
          f"the servers start", flush=True)
    if free < PHASE18_MIN_FREE:
        fail(f"phase 18 needs {PHASE18_MIN_FREE} bytes free for four SD1.5 "
             f"servers, {free} are")
    up = with_save_image(docs["upscale"])
    up["2"]["inputs"]["seed"] = 42
    up["1"]["inputs"]["image"] = "drill_test_card.png"   # as in phase 14
    size, p = up["16"]["inputs"], up["2"]["inputs"]
    n_tiles = len(tiling.calculate_tiles(size["width"], size["height"],
                                         p["tile_width"], p["tile_height"]))
    w1_tiles = len(tiling.partition_tiles(n_tiles, 2)[2])
    inpaint = with_save_image(docs["inpaint"])
    seed_node = next(n for n, node in inpaint.items()
                     if isinstance(node, dict)
                     and node.get("class_type") == "DistributedSeed")
    inpaint[seed_node]["inputs"]["seed"] = SEEDS[0]
    launches = {"variants": collections.Counter(),
                "shapes": collections.Counter()}
    per_server = collections.defaultdict(lambda: {"sm90": 0, "peak": 0})
    report = {"card": card_line(), "free_bytes_before": free,
              "settings": {"master_lease_s": PHASE18_MASTER_LEASE_S,
                           "hedge_min_wait_s": PHASE18_HEDGE_MIN_WAIT_S,
                           "max_queue": PHASE18_MAX_QUEUE,
                           "slo_spec": PHASE18_SLO_SPEC,
                           "slo_s": PHASE18_SLO_S,
                           "drain_timeout_s": PHASE18_DRAIN_TIMEOUT_S,
                           "stall_s": PHASE18_STALL_S}}
    with tempfile.TemporaryDirectory() as root:
        wal_root = os.path.join(root, "wal")
        roles = {"m0": ("serve", {}), "m1": ("serve", {}),
                 "w0": ("worker", {}), "w1": ("worker", {})}
        cluster = Cluster(root, roles)
        urls = {r: cluster.url(r) for r in roles}
        masters_env = {
            "DTPU_SHARD_PEERS": f"m0={urls['m0']},m1={urls['m1']}",
            "DTPU_SHARD_WAL_ROOT": wal_root,
            "DTPU_MASTER_LEASE_S": str(PHASE18_MASTER_LEASE_S),
            "DTPU_FAULT_POLICY": "reassign", "DTPU_HEDGE": "1",
            "DTPU_HEDGE_MIN_WAIT_S": str(PHASE18_HEDGE_MIN_WAIT_S),
            "DTPU_LEASE_S": str(DRILL_LEASE_S), "DTPU_SUSPECT_PROBES": "1"}
        roles["m0"][1].update(masters_env, DTPU_SHARD_ID="m0",
                              DTPU_MAX_QUEUE=str(PHASE18_MAX_QUEUE),
                              DTPU_SLO_SPEC=PHASE18_SLO_SPEC,
                              DTPU_DRAIN_TIMEOUT_S=str(
                                  PHASE18_DRAIN_TIMEOUT_S))
        roles["m1"][1].update(masters_env, DTPU_SHARD_ID="m1")
        for w in ("w0", "w1"):
            roles[w][1].update(DTPU_MASTER_URLS=f"{urls['m0']},{urls['m1']}",
                               DTPU_WORKER_ID=w,
                               DTPU_LEASE_S=str(DRILL_LEASE_S))
        roles["w1"][1]["DTPU_FAULT_INJECT"] = json.dumps(
            {"stall_s": PHASE18_STALL_S})
        for role in roles:
            shutil.copy(os.path.join(input_dir, "input.png"),
                        os.path.join(cluster.dirs[role], "input"))
        for role in ("m0", "m1"):
            with open(os.path.join(cluster.dirs[role],
                                   "cluster_config.json"), "w") as f:
                json.dump({"master": {"host": "127.0.0.1"},
                           "workers": [{"id": w, "name": w,
                                        "host": "127.0.0.1",
                                        "port": cluster.ports[w],
                                        "enabled": w == "w0"}
                                       for w in ("w0", "w1")]}, f)
        cluster.ports["router"] = find_free_port()
        cluster.logs["router"] = os.path.join(root, "router.log")
        router = cluster.url("router")

        def outputs(role):
            d = os.path.join(cluster.dirs[role], "output")
            return sorted(os.path.join(d, f) for f in os.listdir(d)) \
                if os.path.isdir(d) else []

        def history(role, pid, what):
            deadline = time.time() + FANOUT_REQUEST_S
            while True:
                hist = get_json(cluster.url(role) + "/history")
                if pid in hist:
                    if hist[pid].get("status") != "success":
                        cluster.fail(f"{what}: history {hist[pid]}")
                    return hist[pid]
                if time.time() > deadline:
                    cluster.fail(f"{what}: no history at {role} after "
                                 f"{FANOUT_REQUEST_S} s")
                time.sleep(0.05)

        def post(role, doc, workers, what, **fields):
            t0 = time.perf_counter()
            code, body, _ = request_json(
                "POST", cluster.url(role) + "/prompt",
                {"prompt": copy.deepcopy(doc), "client_id": "chip_smoke",
                 **fields}, timeout=FANOUT_REQUEST_S)
            secs = time.perf_counter() - t0
            if code != 200 or sorted(body.get("workers", [])) != workers \
                    or body.get("failed_workers"):
                cluster.fail(f"{what}: {role} answered {code} {body}; "
                             f"expected a fan-out to {workers}")
            return body, secs

        def set_worker(master, wid, enabled):
            post_json(cluster.url(master) + "/distributed/config/"
                      "update_worker", {"id": wid, "enabled": enabled})

        def wait_healthy(master, wids):
            deadline = time.time() + FANOUT_START_S
            for wid in wids:
                while get_json(cluster.url(master) + "/distributed/cluster")[
                        "workers"].get(wid, {}).get("state") != "healthy":
                    if time.time() > deadline:
                        cluster.fail(f"{wid} never read healthy at {master}")
                    time.sleep(0.2)

        lines_seen = collections.Counter()

        def new_lines(role, what):
            """A server's prompt lines since the last call: sm90 alone (or
            none) at shapes phase 3 checked, counted for the kernels
            line."""
            lines = cluster.prompt_lines(role)[lines_seen[role]:]
            lines_seen[role] += len(lines)
            for line in lines:
                lv = line["launches"]
                if lv["mma_sync"] or lv["fp32"] or line["status"] \
                        != "success":
                    cluster.fail(f"{what}: {role}'s share {line}")
                by_shape = {tuple(x[:6]): x[6]
                            for x in line["launches_by_shape"]}
                missing = [x for x in by_shape if x not in checked]
                if missing:
                    cluster.fail(f"{what}: {role} launched shapes that "
                                 f"phase 3 did not check: {missing}")
                launches["variants"].update(lv)
                launches["shapes"].update(by_shape)
                per_server[role]["sm90"] += lv["sm90"]
                per_server[role]["peak"] = max(
                    per_server[role]["peak"],
                    line.get("max_memory_allocated") or 0)
            return lines

        def wait_lines(role, n, what):
            deadline = time.time() + FANOUT_REQUEST_S
            got = []
            while len(got) < n:
                got += new_lines(role, what)
                if time.time() > deadline:
                    cluster.fail(f"{what}: {len(got)} prompt lines from "
                                 f"{role}, expected {n}")
                time.sleep(0.05)
            return got

        def check_diff(path, ref_img, key, what):
            dmax, dmean = image_diff(path, ref_img)
            tol_max, tol_mean = (0.0, 0.0) if key == "bit" \
                else FANOUT_ATOL[key]
            if not (dmax <= tol_max and dmean <= tol_mean):
                cluster.fail(f"{what}: {os.path.basename(path)} differs from "
                             f"its {key!r} reference by max {dmax}, mean "
                             f"{dmean} (limits {tol_max}, {tol_mean})")
            return {"max": dmax, "mean": dmean}

        def saved(path):
            from comfyui_distributed_tpu_torch.utils.image import decode_png
            with open(path, "rb") as f:
                return decode_png(f.read())[0]

        def cli_run(args, what):
            out = subprocess.run(
                [sys.executable, "-m", "comfyui_distributed_tpu_torch.cli",
                 *args], cwd=ROOT, capture_output=True, text=True,
                timeout=120)
            if out.returncode != 0:
                cluster.fail(f"{what}: cli {args} exited {out.returncode}: "
                             f"{out.stdout[-2000:]} {out.stderr[-2000:]}")
            return json.loads(out.stdout)

        try:
            t0 = time.perf_counter()
            for role in roles:
                cluster.launch(role)
            with open(cluster.logs["router"], "a") as log:
                cluster.procs["router"] = subprocess.Popen(
                    [sys.executable, "-m",
                     "comfyui_distributed_tpu_torch.cli", "router",
                     "--host", "127.0.0.1",
                     "--port", str(cluster.ports["router"]),
                     "--masters", f"{urls['m0']},{urls['m1']}"],
                    cwd=ROOT, stdout=log, stderr=subprocess.STDOUT)
            cluster.wait_up(["m0", "m1", "w0", "w1"])
            for m in ("m0", "m1"):
                wait_healthy(m, ("w0", "w1"))
            # each master resolved its peers as shard_config does, logs
            # under the root at its id and holds its own lease
            rings = {}
            for m in ("m0", "m1"):
                ring = get_json(cluster.url(m) + "/distributed/ring")
                lease = os.path.join(wal_root, m, "master.lease")
                with open(lease) as f:
                    owner = json.load(f).get("owner")
                dinfo = get_json(cluster.url(m) + "/distributed/durability")
                if not ring.get("enabled") or ring.get("self") != m \
                        or set(ring.get("members", {})) != {"m0", "m1"} \
                        or owner != m or dinfo.get("epoch") != 1:
                    cluster.fail(f"{m} started unsharded or not on its own "
                                 f"log: ring {ring}, lease owner {owner}, "
                                 f"durability {dinfo}")
                rings[m] = ring
            deadline = time.time() + FANOUT_START_S
            while True:
                try:
                    rring = get_json(router + "/distributed/ring")
                except OSError:
                    rring = {}
                if set(rring.get("members", {})) == {"m0", "m1"}:
                    break
                if time.time() > deadline:
                    cluster.fail(f"the router never saw both masters: "
                                 f"{rring}")
                time.sleep(0.2)
            # this process and the four servers hold the card, the router
            # not (inside a container nvidia-smi may show every pid as 1)
            apps = compute_apps()
            router_pid = str(cluster.procs["router"].pid)
            if len(apps) > 5 or any(a.split(",")[0].strip() == router_pid
                                    for a in apps):
                cluster.fail(f"the router holds the card: {apps}")
            report["servers_start_s"] = time.perf_counter() - t0
            report["compute_apps"] = apps
            ring = HashRing(rings["m0"]["members"], rings["m0"]["vnodes"])

            # drill 1: routing by hash, and one forward of one hop
            files0 = {m: set(outputs(m)) for m in ("m0", "m1")}
            routed = [None] * 4

            def route(i):
                t1 = time.perf_counter()
                routed[i] = (*request_json(
                    "POST", router + "/prompt",
                    {"prompt": copy.deepcopy(up), "client_id": "chip_smoke"},
                    timeout=FANOUT_REQUEST_S), time.perf_counter() - t1)

            threads = [threading.Thread(target=route, args=(i,))
                       for i in range(4)]
            for t in threads:
                t.start()
            for t in threads:
                t.join()
            placed = []
            for code, body, _hdrs, secs in routed:
                pid = (body or {}).get("prompt_id")
                if code != 200 or body.get("workers") != ["w0"] \
                        or body.get("shard") != ring.owner(pid):
                    cluster.fail(f"drill 1: the router answered {code} "
                                 f"{body}; the ring owner of its id is "
                                 f"{ring.owner(pid) if pid else None}")
                placed.append({"prompt_id": pid, "shard": body["shard"],
                               "post_s": secs})
            fwd_pid = next(f"fwd{i}" for i in range(10_000)
                           if ring.owner(f"fwd{i}") == "m0")
            body, fwd_s = post("m1", up, ["w0"], "drill 1 forward",
                               prompt_id=fwd_pid)
            if body.get("prompt_id") != fwd_pid or body.get("shard") != "m0" \
                    or body.get("forwarded_from") != "m1":
                cluster.fail(f"drill 1: the forward answered {body}")
            if not any(r.get("t") == "enqueue" and r.get("pid") == fwd_pid
                       for r in wal_records(os.path.join(wal_root, "m0"))):
                cluster.fail("drill 1: m0's log holds no admission of the "
                             "forwarded prompt")
            placed.append({"prompt_id": fwd_pid, "shard": "m0",
                           "post_s": fwd_s, "forwarded_from": "m1"})
            for pl in placed:
                history(pl["shard"], pl["prompt_id"], "drill 1")
            per_master = collections.Counter(pl["shard"] for pl in placed)
            for m in ("m0", "m1"):
                wait_lines(m, per_master[m], "drill 1")
            wait_lines("w0", len(placed), "drill 1")
            merged = get_json(router + "/history")
            if not all(pl["prompt_id"] in merged for pl in placed):
                cluster.fail(f"drill 1: the router's /history lacks some of "
                             f"{[pl['prompt_id'] for pl in placed]}")
            images1 = []
            for m in ("m0", "m1"):
                new = sorted(set(outputs(m)) - files0[m])
                if len(new) != per_master[m]:
                    cluster.fail(f"drill 1: {m} saved {new}, expected "
                                 f"{per_master[m]} images")
                images1 += new
            report["drill1"] = {
                "placed": placed,
                "vs_phase7": [check_diff(f, upscale_ref, "one_batch",
                                         "drill 1") for f in images1],
                "router": get_json(router + "/distributed/ring")}
            print(f"phase 18: drill 1 {json.dumps(placed)}", flush=True)

            # drill 2: the 429 ladder and the stride order on m0
            adm0 = get_json(cluster.url("m0") + "/distributed/metrics")[
                "admission"]["per_class"]
            for attempt in (1, 2):
                files0 = set(outputs("m0"))
                body, _ = post("m0", up, ["w0"], "drill 2 upscale")
                up_pid = body["prompt_id"]
                deadline = time.time() + FANOUT_REQUEST_S
                while get_json(cluster.url("m0") + "/distributed/metrics")[
                        "admission"]["queued_by_class"] != {
                        "paid": 0, "free": 0, "batch": 0}:
                    if time.time() > deadline:
                        cluster.fail("drill 2: m0 never started the upscale")
                    time.sleep(0.01)
                burst, seen = [], collections.Counter()
                t_burst = time.perf_counter()
                for tenant in PHASE18_BURST:
                    t1 = time.perf_counter()
                    code, rb, hdrs = request_json(
                        "POST", cluster.url("m0") + "/prompt",
                        {"prompt": copy.deepcopy(inpaint),
                         "client_id": "chip_smoke", "priority": tenant},
                        timeout=FANOUT_REQUEST_S)
                    secs = time.perf_counter() - t1
                    if code == 200:
                        seen[tenant] += 1
                        burst.append({"tenant": tenant, "verdict": "admit",
                                      "id": f"{tenant[0]}{seen[tenant]}",
                                      "prompt_id": rb["prompt_id"],
                                      "post_s": secs})
                    elif code == 429:
                        burst.append({"tenant": tenant,
                                      "verdict": rb.get("reason"),
                                      "retry_after": hdrs.get("Retry-After"),
                                      "body_tenant": rb.get("tenant"),
                                      "post_s": secs})
                    else:
                        cluster.fail(f"drill 2: {tenant} answered {code} "
                                     f"{rb}")
                burst_s = time.perf_counter() - t_burst
                still = up_pid not in get_json(cluster.url("m0")
                                               + "/history")
                admitted = [b for b in burst if b["verdict"] == "admit"]
                for b in [{"prompt_id": up_pid}] + admitted:
                    history("m0", b["prompt_id"], "drill 2")
                wait_lines("m0", 1 + len(admitted), "drill 2")
                wait_lines("w0", 1 + len(admitted), "drill 2")
                if still:
                    break
                if attempt == 2:
                    cluster.fail("drill 2: the upscale ended before the "
                                 "burst did, twice")
                print("phase 18: drill 2's upscale ended before the burst; "
                      "once more", flush=True)
            if tuple(b["verdict"] for b in burst) != PHASE18_LADDER:
                cluster.fail(f"drill 2: the ladder {burst}, expected "
                             f"{PHASE18_LADDER}")
            for b in burst:
                if b["verdict"] != "admit" and not (
                        b["body_tenant"] == b["tenant"]
                        and int(b["retry_after"] or 0) >= 1):
                    cluster.fail(f"drill 2: a shed {b}")
            hist = get_json(cluster.url("m0") + "/history")
            order = [b["id"] for b in sorted(
                admitted, key=lambda b: hist[b["prompt_id"]]["started_at"])]
            want = PHASE18_ORDER[attempt - 1]
            fifo = [b["id"] for b in admitted]
            if order != want or order == fifo:
                cluster.fail(f"drill 2: the admitted started as {order}, "
                             f"expected {want} (FIFO {fifo})")
            adm1 = get_json(cluster.url("m0") + "/distributed/metrics")[
                "admission"]["per_class"]
            delta = {c: {k: adm1[c][k] - adm0[c][k] for k in adm1[c]}
                     for c in adm1}
            new = sorted(set(outputs("m0")) - files0)
            if len(new) != 1 + 2 * len(admitted):
                cluster.fail(f"drill 2: m0 saved {len(new)} images")
            slices = []
            for f in new:
                if saved(f).shape[:2] == upscale_ref.shape[:2]:
                    continue
                diffs = [image_diff(f, r["same"]) for r in inpaint_refs[:2]]
                if min(d[0] for d in diffs) != 0.0:
                    cluster.fail(f"drill 2: {os.path.basename(f)} equals "
                                 f"no in-process slice: {diffs}")
                slices.append(min(diffs))
            wshed = {w: get_json(cluster.url(w) + "/distributed/metrics")[
                "admission"]["per_class"] for w in ("w0", "w1")}
            if any(v["shed_overload"] or v["shed_rate"]
                   for per in wshed.values() for v in per.values()):
                cluster.fail(f"drill 2: a worker shed a dispatched share: "
                             f"{wshed}")
            report["drill2"] = {
                "attempts": attempt, "ladder": burst, "burst_s": burst_s,
                "started_order": order, "fifo_order": fifo,
                "admission_delta": delta,
                "shed_post_s": [b["post_s"] for b in burst
                                if b["verdict"] != "admit"],
                "inpaint_slices_vs_in_process": slices,
                "w0_admission": wshed["w0"]}
            print(f"phase 18: drill 2 ladder {[b['verdict'] for b in burst]}"
                  f", order {order}", flush=True)

            # drill 3: the burn rates, then a deadline's hedge
            slo = get_json(cluster.url("m0") + "/distributed/slo")
            hist = get_json(cluster.url("m0") + "/history")
            recomputed = {}
            for cls, objs in (("paid", ("p95<0.1s", "completion>0.99")),
                              ("free", ("p95<60s",))):
                entries = [h for h in hist.values()
                           if h.get("tenant") == cls]
                n = len(entries)
                slow = {"p95<0.1s": 0.1, "p95<60s": 60.0}
                recomputed[cls] = {
                    "count": n,
                    "burn_rates": {o: round(
                        (sum(h.get("duration_s", 0) > slow[o]
                             for h in entries) / n) / 0.05, 4)
                        if o in slow else round(
                        (sum(h["status"] != "success" for h in entries)
                         / n) / 0.01, 4) for o in objs}}
            got = {cls: {"count": slo["tenants"][cls]["windows"]["fast"][
                "count"], "burn_rates": slo["tenants"][cls]["windows"][
                "fast"]["burn_rates"]} for cls in recomputed}
            if got != recomputed or recomputed["paid"]["burn_rates"] != {
                    "p95<0.1s": 20.0, "completion>0.99": 0.0} \
                    or recomputed["free"]["burn_rates"] != {"p95<60s": 0.0}:
                cluster.fail(f"drill 3: /distributed/slo {got}, from the "
                             f"history {recomputed}")
            breaches = {}
            for pid, h in hist.items():
                if h.get("tenant") not in ("paid", "free"):
                    continue
                spans = get_json(cluster.url("m0")
                                 + f"/distributed/trace/{pid}")["spans"]
                breaches[pid] = sum(s["name"] == "slo_breach" for s in spans)
                if breaches[pid] != (h["tenant"] == "paid"):
                    cluster.fail(f"drill 3: {h['tenant']} prompt {pid} has "
                                 f"{breaches[pid]} slo_breach spans")
            cli_slo = cli_run(["slo", "--url", cluster.url("m0"), "--json"],
                              "drill 3")
            if {cls: cli_slo["tenants"][cls]["windows"]["fast"]["burn_rates"]
                    for cls in got} != {cls: g["burn_rates"]
                                        for cls, g in got.items()}:
                cluster.fail(f"drill 3: cli slo {cli_slo}")
            set_worker("m0", "w1", True)
            wait_healthy("m0", ("w1",))
            files0 = set(outputs("m0"))
            body, direct_s = post("m0", up, ["w0", "w1"], "drill 3 deadline",
                                  slo_s=PHASE18_SLO_S)
            dl_pid, seen_deadline, fired, prev = body["prompt_id"], None, \
                None, None
            hist = {}
            deadline = time.time() + FANOUT_REQUEST_S
            while dl_pid not in hist:
                jobs = [j for j in get_json(
                    cluster.url("m0") + "/distributed/cluster")["ledger"][
                    "active_jobs"].values() if j["kind"] == "tile"]
                for j in jobs:
                    if j["slo_deadline_remaining_s"] is not None \
                            and seen_deadline is None:
                        seen_deadline = j
                    if j["hedged_units"] and fired is None:
                        fired = {"at": j, "before": prev}
                    prev = j
                hist = get_json(cluster.url("m0") + "/history")
                if time.time() > deadline:
                    cluster.fail("drill 3: the deadline upscale never ended")
                time.sleep(0.05)
            history("m0", dl_pid, "drill 3")
            if seen_deadline is None or fired is None:
                cluster.fail(f"drill 3: deadline {seen_deadline}, hedge "
                             f"{fired}")
            silence = fired["at"]["age_s"]
            bar = max(0.25 * fired["at"]["slo_deadline_remaining_s"], 0.25)
            # the drain polls every CLUSTER_POLL_S, this loop every 0.05 s
            if not silence <= bar + 0.25 + 0.15 + 0.05 \
                    or silence >= PHASE18_HEDGE_MIN_WAIT_S / 10:
                cluster.fail(f"drill 3: hedged at {silence} s of silence, "
                             f"the bar {bar} s")
            snap = get_json(cluster.url("m0") + "/distributed/cluster")
            job = [j for j in snap["ledger"]["completed_jobs"]
                   if j["kind"] == "tile"][-1]
            if not job["done_units"] == job["total_units"] == n_tiles \
                    or job["hedged_units"] < w1_tiles:
                cluster.fail(f"drill 3: the job {job}")
            (img,) = sorted(set(outputs("m0")) - files0)
            wait_lines("m0", 1, "drill 3")
            wait_lines("w0", 1, "drill 3")
            set_worker("m0", "w1", False)
            report["drill3"] = {
                "slo": got, "recomputed_from_history": recomputed,
                "slo_breach_spans": breaches,
                "deadline_seen": seen_deadline,
                "hedge_silence_s": silence, "hedge_bar_s": bar,
                "post_s": direct_s,
                "before_hedge": fired["before"], "ledger": job,
                "vs_phase7": check_diff(img, upscale_ref, "one_batch",
                                        "drill 3")}
            print(f"phase 18: drill 3 burn {got}; hedged at {silence} s of "
                  f"silence (bar {bar} s)", flush=True)

            # drill 4: m1 dies, m0 absorbs its shard
            set_worker("m1", "w1", True)
            wait_healthy("m1", ("w1",))
            files0 = set(outputs("m0"))
            body, direct_s = post("m1", up, ["w0", "w1"], "drill 4")
            kill_pid = body["prompt_id"]
            if ring.owner(kill_pid) != "m1":
                cluster.fail(f"drill 4: m1 made an id it does not own: "
                             f"{kill_pid}")
            deadline = time.time() + FANOUT_REQUEST_S
            while True:
                state, _ = durable.replay(os.path.join(wal_root, "m1"))
                held = [sum(u["done"] and u["spilled"]
                            for u in j["units"].values())
                        for j in state.jobs.values() if j["kind"] == "tile"]
                if held and held[0] >= n_tiles - w1_tiles:
                    break
                if time.time() > deadline:
                    cluster.fail(f"drill 4: m1's log never held "
                                 f"{n_tiles - w1_tiles} units: {state.jobs}")
                time.sleep(0.05)
            with open(os.path.join(wal_root, "m1", "master.lease")) as f:
                expires_at = json.load(f)["expires_at"]
            wall_kill, t_kill = time.time(), time.perf_counter()
            cluster.kill("m1")
            new_lines("m1", "drill 4")
            t_absorb = None
            deadline = time.time() + FANOUT_REQUEST_S
            hist = {}
            while kill_pid not in hist:
                if t_absorb is None and "m1" not in get_json(
                        cluster.url("m0") + "/distributed/ring")["members"]:
                    t_absorb = time.perf_counter()
                hist = get_json(cluster.url("m0") + "/history")
                if time.time() > deadline:
                    cluster.fail("drill 4: m0 never finished m1's prompt")
                time.sleep(0.05)
            t_done = time.perf_counter()
            history("m0", kill_pid, "drill 4")
            t_absorb = t_absorb or t_done
            snap = get_json(cluster.url("m0") + "/distributed/cluster")
            job = [j for j in snap["ledger"]["completed_jobs"]
                   if j["kind"] == "tile"][-1]
            if not (job["recovered"] and job["done_units"]
                    == job["total_units"] == n_tiles
                    and job["preloaded_units"] == held[0]
                    and job["reassigned_units"] >= w1_tiles):
                cluster.fail(f"drill 4: m0's job {job}; expected recovered, "
                             f"{n_tiles} done, {held[0]} preloaded, >= "
                             f"{w1_tiles} reassigned")
            ring0 = get_json(cluster.url("m0") + "/distributed/ring")
            deadline = time.time() + FANOUT_START_S
            while True:
                rring = get_json(router + "/distributed/ring")
                if set(rring["members"]) == {"m0"}:
                    break
                if time.time() > deadline:
                    cluster.fail(f"drill 4: the router's ring {rring}")
                time.sleep(0.2)
            shard0 = get_json(cluster.url("m0") + "/distributed/metrics")[
                "shard"]
            if set(ring0["members"]) != {"m0"} or ring0["ring_epoch"] < 2 \
                    or ring0["owned"] != ["m0", "m1"] \
                    or shard0["takeovers"] != 1:
                cluster.fail(f"drill 4: m0's ring {ring0}, shard {shard0}")
            if any(snap["workers"].get(w, {}).get("state") != "healthy"
                   for w in ("w0", "w1")):
                cluster.fail(f"drill 4: the workers at m0 {snap['workers']}")
            (img,) = sorted(set(outputs("m0")) - files0)
            wait_lines("m0", 1, "drill 4")
            wait_lines("w0", 2, "drill 4")
            wal = {m: cli_run(["wal", "--dir", os.path.join(wal_root, m),
                               "--json"], "drill 4") for m in ("m0", "m1")}
            if not all(v["ok"] for v in wal.values()):
                cluster.fail(f"drill 4: cli wal {wal}")
            report["drill4"] = {
                "prompt_id": kill_pid, "held_at_kill": held[0],
                "post_s": direct_s,
                "kill_to_lease_expiry_s": expires_at - wall_kill,
                "kill_to_absorb_s": t_absorb - t_kill,
                "kill_to_success_s": t_done - t_kill,
                "ledger": job, "ring": ring0, "router_ring": rring,
                "shard": {k: shard0[k] for k in ("absorbed", "takeovers",
                                                 "ring_epoch", "owned")},
                "vs_drill1": check_diff(img, saved(images1[0]), "one_batch",
                                        "drill 4"),
                "vs_phase7": check_diff(img, upscale_ref, "one_batch",
                                        "drill 4"),
                "wal": {m: {"ok": v["ok"], "lease": v["lease"],
                            "records_by_type": v["records_by_type"]}
                        for m, v in wal.items()}}
            print(f"phase 18: drill 4 kill to lease expiry "
                  f"{expires_at - wall_kill:.3f} s, to absorb "
                  f"{t_absorb - t_kill:.3f} s, to success "
                  f"{t_done - t_kill:.3f} s", flush=True)

            # drill 5: SIGTERM drains m0
            body, direct_s = post("m0", up, ["w0"], "drill 5")
            drain_pid = body["prompt_id"]
            deadline = time.time() + FANOUT_REQUEST_S
            while get_json(cluster.url("m0") + "/distributed/metrics")[
                    "admission"]["queued_by_class"]["paid"]:
                if time.time() > deadline:
                    cluster.fail("drill 5: m0 never started the upscale")
                time.sleep(0.01)
            proc = cluster.procs["m0"]
            tree = proc_tree(proc.pid)
            t_term = time.perf_counter()
            os.kill(proc.pid, signal.SIGTERM)
            time.sleep(0.2)
            code, rb, _ = request_json(
                "POST", cluster.url("m0") + "/prompt",
                {"prompt": copy.deepcopy(inpaint), "client_id": "chip_smoke"},
                timeout=30)
            if code != 503:
                cluster.fail(f"drill 5: a /prompt while draining got {code} "
                             f"{rb}")
            try:
                proc.wait(timeout=PHASE18_DRAIN_TIMEOUT_S + 10)
            except subprocess.TimeoutExpired:
                cluster.fail("drill 5: m0 did not exit after its drain")
            exit_s = time.perf_counter() - t_term
            left = [p for p in tree if pid_alive(p)]
            done = [ln for ln in cluster.prompt_lines("m0")
                    if ln["prompt_id"] == drain_pid]
            if proc.returncode != 0 or exit_s > PHASE18_DRAIN_TIMEOUT_S \
                    or left or [ln["status"] for ln in done] != ["success"] \
                    or not cluster.count_lines("m0", "drained in"):
                cluster.fail(f"drill 5: m0 exited {proc.returncode} after "
                             f"{exit_s} s, left {left}, the upscale "
                             f"{done}")
            wait_lines("m0", 1, "drill 5")
            wait_lines("w0", 1, "drill 5")
            report["drill5"] = {"sigterm_to_exit_s": exit_s,
                                "post_s": direct_s,
                                "answer_while_draining": code,
                                "tree": tree, "left": left}
            print(f"phase 18: drill 5 SIGTERM to exit {exit_s:.3f} s",
                  flush=True)
        finally:
            cluster.stop()
        for role in ("m0", "m1", "w0", "w1"):
            new_lines(role, "phase 18")
    report["servers"] = {r: {"sm90": v["sm90"], "peak_bytes": v["peak"]}
                         for r, v in sorted(per_server.items())}
    report["launches"] = dict(launches["variants"])
    return report, {"path": "phase 18",
                    "variants": dict(launches["variants"]),
                    "shapes": dict(launches["shapes"])}


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


def staged_request_pair(path, doc, input_dir, shape_counts):
    """One staged workflow of phase 11, cold and then warm: (its report,
    its requests).  Everything it held is released when it returns."""
    import numpy as np
    import torch

    seed = doc["13"]["inputs"]["seed"]
    images, results, requests = {}, [], []
    for run in ("cold", "warm"):
        requests += run_requests(path, doc, (seed,), input_dir, shape_counts,
                                 images, results)
        requests[-1]["run"] = run
        if run == "cold":
            first = images[seed]
    if not np.array_equal(first, images[seed]):
        fail(f"{path}: the warm request's image differs from the cold "
             f"one's (max {np.abs(first - images[seed]).max()})")
    report = {"seconds": {r["run"]: r["seconds"] for r in requests},
              "max_memory_allocated": {r["run"]: r["max_memory_allocated"]
                                       for r in requests},
              "cold_equals_warm": True}
    res = results[-1]
    # the decode's own peak above what the request holds: the sampled
    # latent decoded again with the peak counter reset
    edges = doc[{"refiner": "10", "hires_fix": "8"}[path]]["inputs"]
    vae = res.outputs[edges["vae"][0]][edges["vae"][1]]
    lat = res.outputs[edges["samples"][0]][0]["samples"].data
    torch.cuda.synchronize()
    report["held_bytes"] = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    vae.vae_decode(lat)
    torch.cuda.synchronize()
    report["decode_peak_above_held_bytes"] = \
        torch.cuda.max_memory_allocated() - report["held_bytes"]
    if path == "refiner":
        base, refiner = res.outputs["1"][0], res.outputs["2"][0]
        if refiner.family.name != "sdxl_refiner" \
                or res.outputs["6"][0].size_cond != (1024, 1024, 0, 0, 6.0):
            fail(f"refiner: family {refiner.family.name}, size scalars "
                 f"{res.outputs['6'][0].size_cond}")
        report["weight_bytes"] = {
            p.name: sum(t.numel() * t.element_size() for m in
                        [p.unet, p.vae, *p.clip_models]
                        for t in m.parameters())
            for p in (base, refiner)}
    else:
        base, patched = res.outputs["4"][0], res.outputs["20"][0]
        new = [n for m, b in zip([patched.unet, *patched.clip_models],
                                 [base.unet, *base.clip_models])
               for (n, p), q in zip(m.named_parameters(), b.parameters())
               if p is not q]
        if patched.unet is not base.unet or len(new) != 8 \
                or res.outputs["21"][0] is not patched:
            fail(f"hires_fix: the LoRA replaced {new}; the UNet shared "
                 f"{patched.unet is base.unet}")
        report["lora_new_tensors"] = new
    return report, requests


def staged(docs, input_dir, shape_counts):
    """Phase 11: the refiner and hires-fix workflows, each cold (every
    pipeline released first) and then warm; returns (the report, the
    requests)."""
    import gc

    import torch

    from comfyui_distributed_tpu_torch.models import registry
    def release():
        registry.clear_pipeline_cache()
        gc.collect()
        torch.cuda.empty_cache()

    report, requests = {}, []
    for path in ("refiner", "hires_fix"):
        release()
        report[path], reqs = staged_request_pair(path, docs[path], input_dir,
                                                 shape_counts)
        requests += reqs
    release()
    return report, requests


def inpaint_request_pair(path, doc, input_dir, shape_counts, checked):
    """One inpaint workflow of phase 12, cold and then warm: (its report,
    its requests).  Each request's attention is priced from phase 3's
    rows (``checked``), and its sampled latent is held against the
    encoded source under the latent mask.  Everything it held is
    released when it returns."""
    import numpy as np
    import torch

    from comfyui_distributed_tpu_torch.ops.basic import (
        as_mask, image_mask_to_latent)
    seed = next(node["inputs"]["seed"] for node in doc.values()
                if isinstance(node, dict)
                and node.get("class_type") == "DistributedSeed")
    images, results, requests = {}, [], []
    for run in ("cold", "warm"):
        requests += run_requests(path, doc, (seed,), input_dir, shape_counts,
                                 images, results)
        requests[-1]["run"] = run
        if run == "cold":
            first = images[seed]
    if not np.array_equal(first, images[seed]):
        fail(f"{path}: the warm request's image differs from the cold "
             f"one's (max {np.abs(first - images[seed]).max()})")
    ks, enc = INPAINT_NODES[path]
    for req, res in zip(requests, results):
        shapes = {tuple(s[:6]): s[6] for s in req["launches_by_shape"]}
        missing = [s for s in shapes if s not in checked]
        if missing:
            fail(f"{path}: launched shapes that phase 3 did not check: "
                 f"{missing}")
        req["attention"] = totals(shapes, checked, [
            "ms", "plain_ms", "library_ms", "mma_sync_ms"])
        # where the latent mask is 0 the sampler must hand back the
        # encoded source to the bit, where it is 1 something else
        out = res.outputs[ks][0]
        sampled = out["samples"].data
        source = res.outputs[enc][-1]["samples"].data
        m = image_mask_to_latent(
            as_mask(out["noise_mask"], sampled.device), sampled.shape[1],
            sampled.shape[2], 1).expand_as(sampled)
        keep, redo = m == 0, m == 1
        kept_equal = bool(torch.equal(sampled[keep], source[keep]))
        change = float((sampled[redo] - source[redo]).abs().max()) \
            if redo.any() else 0.0
        req["anchoring"] = {"kept_values": int(keep.sum()),
                            "resampled_values": int(redo.sum()),
                            "kept_equal_to_the_bit": kept_equal,
                            "resampled_max_abs_change": change}
        if not keep.any() or not kept_equal or not change > 0.0:
            fail(f"{path}: anchoring {req['anchoring']}")
        if path == "inpaint_model" and (
                res.outputs["1"][0].family.name != "sd15_inpaint"
                or res.outputs["6"][0].concat_latent.shape[-1] != 5):
            fail(f"inpaint_model: family {res.outputs['1'][0].family.name}")
        emit("phase12", req)
    report = {"seconds": {r["run"]: r["seconds"] for r in requests},
              "max_memory_allocated": {r["run"]: r["max_memory_allocated"]
                                       for r in requests},
              "attention_ms": {r["run"]: r["attention"]["ms"]
                               for r in requests},
              "cold_equals_warm": True,
              "anchoring": requests[-1]["anchoring"]}
    return report, requests


def inpainting(docs, input_dir, shape_counts, rows):
    """Phase 12: the three inpaint workflows, each cold (every pipeline
    released first) and then warm, on the RGBA inputs in ``input_dir``;
    returns (the report, the requests)."""
    import gc

    import torch

    from comfyui_distributed_tpu_torch.models import registry

    def release():
        registry.clear_pipeline_cache()
        gc.collect()
        torch.cuda.empty_cache()

    checked = {(r["B"], r["N"], r["M"], r["H"], r["D"], r["dtype"]): r
               for r in rows if not r.get("named")}
    report, requests = {}, []
    for path in ("inpaint", "outpaint", "inpaint_model"):
        release()
        report[path], reqs = inpaint_request_pair(
            path, docs[path], input_dir, shape_counts, checked)
        requests += reqs
    release()
    return report, requests


def phase13_request_pair(path, doc, input_dir, shape_counts, checked):
    """One workflow of phase 13, cold and then warm, and the runs that
    show its conditioning reached the model: (its report, its requests).
    Everything it held is released when it returns."""
    import dataclasses

    import numpy as np
    import torch

    from comfyui_distributed_tpu_torch.ops.base import OpContext, get_op
    seed = next(node["inputs"]["seed"] for node in doc.values()
                if isinstance(node, dict)
                and node.get("class_type") == "DistributedSeed")
    images, results, requests = {}, [], []
    for run in ("cold", "warm"):
        requests += run_requests(path, doc, (seed,), input_dir, shape_counts,
                                 images, results)
        requests[-1]["run"] = run
        if run == "cold":
            first = images[seed]
    if not np.array_equal(first, images[seed]):
        fail(f"{path}: the warm request's image differs from the cold "
             f"one's (max {np.abs(first - images[seed]).max()})")
    res = results[-1]
    report = {"cold_equals_warm": True}
    if path == "regional":
        # each half of the latent sits closer to a run of its own prompt
        # alone (over the whole canvas) than to one of the other half's
        # prompt alone: node 6 sets the left half, node 16 the right
        lat = res.outputs["3"][0]["samples"].data
        half = lat.shape[2] // 2
        alone = {}
        for node in ("6", "16"):
            alt = copy.deepcopy(doc)
            alt["3"]["inputs"]["positive"] = [node, 0]
            alt_res = []
            requests += run_requests(path, alt, (seed,), input_dir,
                                     shape_counts, results=alt_res)
            requests[-1]["run"] = f"positive {node} alone"
            alone[node] = alt_res[0].outputs["3"][0]["samples"].data
        dist = {}
        for side, cols, own, other in (("left", slice(0, half), "6", "16"),
                                       ("right", slice(half, None), "16",
                                        "6")):
            dist[side] = {f"positive {n} alone": float(
                (lat[:, :, cols] - alone[n][:, :, cols]).abs().mean())
                for n in (own, other)}
            if not dist[side][f"positive {own} alone"] \
                    < dist[side][f"positive {other} alone"]:
                fail(f"regional: the {side} half is not closer to its own "
                     f"prompt's run than to the other's: {dist}")
        report["half_mean_abs_diff"] = dist
    elif path == "ip2p":
        # the same sampling with zero concat channels
        pos, neg, lat = res.outputs["8"]
        if res.outputs["2"][0].family.name != "sd15_ip2p" \
                or tuple(pos.concat_latent.shape) != (1, 64, 64, 4):
            fail(f"ip2p: family {res.outputs['2'][0].family.name}, concat "
                 f"{tuple(pos.concat_latent.shape)}")
        zero = [dataclasses.replace(c, concat_latent=torch.zeros_like(
            c.concat_latent)) for c in (pos, neg)]
        widgets = {k: v for k, v in doc["9"]["inputs"].items()
                   if not isinstance(v, list)}
        (other,) = get_op("KSampler").execute(
            OpContext(device=DEVICE), model=res.outputs["2"][0],
            seed=res.outputs["13"][0], positive=zero[0], negative=zero[1],
            latent_image=lat, **widgets)
        report["zero_concat_max_abs_diff"] = float(
            (res.outputs["9"][0]["samples"].data - other["samples"].data)
            .abs().max())
        if not report["zero_concat_max_abs_diff"] > 0.0:
            fail("ip2p: the source's concat channels change nothing")
    else:
        pipe, vision = res.outputs["1"][0], res.outputs["1"][3]
        embeds = res.outputs["3"][0].image_embeds
        if pipe.family.name != "sd21_unclip" or pipe.prediction_type != "v" \
                or tuple(embeds.shape) != (1, 1024) \
                or vision.cfg.width != 1280:
            fail(f"unclip: family {pipe.family.name}, embeds "
                 f"{tuple(embeds.shape)}, vision width {vision.cfg.width}")
        alt = copy.deepcopy(doc)
        alt["6"]["inputs"]["noise_augmentation"] = 0.5
        alt_images = {}
        requests += run_requests(path, alt, (seed,), input_dir,
                                 shape_counts, alt_images)
        requests[-1]["run"] = "noise_augmentation 0.5"
        report["noise_augmentation_max_abs_diff"] = float(
            np.abs(alt_images[seed] - images[seed]).max())
        if not report["noise_augmentation_max_abs_diff"] > 0.0:
            fail("unclip: noise_augmentation 0.05 and 0.5 give one image")
    for req in requests:
        shapes = {tuple(s[:6]): s[6] for s in req["launches_by_shape"]}
        missing = [s for s in shapes if s not in checked]
        if missing:
            fail(f"{path}: launched shapes that phase 3 did not check: "
                 f"{missing}")
        req["attention"] = totals(shapes, checked, [
            "ms", "plain_ms", "library_ms", "mma_sync_ms"])
        emit("phase13", req)
    main_reqs = [r for r in requests if r["run"] in ("cold", "warm")]
    report.update(
        seconds={r["run"]: r["seconds"] for r in main_reqs},
        max_memory_allocated={r["run"]: r["max_memory_allocated"]
                              for r in main_reqs},
        attention_ms={r["run"]: r["attention"]["ms"] for r in main_reqs},
        bound_ms=main_reqs[0]["attention"]["bound_ms"])
    return report, requests


def phase13(docs, input_dir, shape_counts, rows):
    """Phase 13: the regional, ip2p and unclip workflows, each cold
    (every pipeline released first) and then warm, on the inputs in
    ``input_dir``; returns (the report, the requests)."""
    import gc

    import torch

    from comfyui_distributed_tpu_torch.models import registry

    def release():
        registry.clear_pipeline_cache()
        gc.collect()
        torch.cuda.empty_cache()

    checked = {(r["B"], r["N"], r["M"], r["H"], r["D"], r["dtype"]): r
               for r in rows if not r.get("named")}
    report, requests = {}, []
    for path in ("regional", "ip2p", "unclip"):
        release()
        report[path], reqs = phase13_request_pair(
            path, docs[path], input_dir, shape_counts, checked)
        requests += reqs
    release()
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
        # phase 11: the SDXL refiner at 1024^2 (12 heads at 768 channels,
        # 24 at 1536) and SDXL's hires-fix at 832^2 and 1216^2
        (2, 4096, 4096, 12, 64, bf, "refiner self 64x64 latent"),
        (2, 4096, 77, 12, 64, bf, "refiner cross 64x64 latent"),
        (2, 1024, 1024, 24, 64, bf, "refiner self 32x32 latent"),
        (2, 1024, 77, 24, 64, bf, "refiner cross 32x32 latent"),
        (2, 256, 256, 24, 64, bf, "refiner mid self 16x16 latent"),
        (2, 256, 77, 24, 64, bf, "refiner mid cross 16x16 latent"),
        (2, 2704, 2704, 10, 64, bf, "SDXL 832^2 self 52x52 latent"),
        (2, 2704, 77, 10, 64, bf, "SDXL 832^2 cross 52x52 latent"),
        (2, 676, 676, 20, 64, bf, "SDXL 832^2 self 26x26 latent"),
        (2, 676, 77, 20, 64, bf, "SDXL 832^2 cross 26x26 latent"),
        (2, 5776, 5776, 10, 64, bf, "SDXL 1216^2 self 76x76 latent"),
        (2, 5776, 77, 10, 64, bf, "SDXL 1216^2 cross 76x76 latent"),
        (2, 1444, 1444, 20, 64, bf, "SDXL 1216^2 self 38x38 latent"),
        (2, 1444, 77, 20, 64, bf, "SDXL 1216^2 cross 38x38 latent"),
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
        # phase 14's upscale shares over three servers:
        # partition_tiles(16, 2) gives the master 6 tiles (B = 12), each
        # worker 5 (B = 10), and a hedge or a reassignment 5 (B = 10)
        *[(b, n, m, 8, d, bf, f"SD1.5 drill B = {b} {kind}")
          for b in (12, 10)
          for n, m, d, kind in (
              (4096, 4096, 40, "self 64x64"), (4096, 77, 40, "cross 64x64"),
              (1024, 1024, 80, "self 32x32"), (1024, 77, 80, "cross 32x32"),
              (256, 256, 160, "self 16x16"), (256, 77, 160, "cross 16x16"),
              (64, 64, 160, "mid self 8x8"), (64, 77, 160, "mid cross 8x8"))],
        # phase 12: SD1.5 at B = 2 (cond, uncond), 512^2 and 768 x 512
        (2, 4096, 4096, 8, 40, bf, "SD1.5 512^2 self 64x64 latent"),
        (2, 4096, 77, 8, 40, bf, "SD1.5 512^2 cross 64x64 latent"),
        (2, 1024, 1024, 8, 80, bf, "SD1.5 512^2 self 32x32 latent"),
        (2, 1024, 77, 8, 80, bf, "SD1.5 512^2 cross 32x32 latent"),
        (2, 256, 256, 8, 160, bf, "SD1.5 512^2 self 16x16 latent"),
        (2, 256, 77, 8, 160, bf, "SD1.5 512^2 cross 16x16 latent"),
        (2, 64, 64, 8, 160, bf, "SD1.5 512^2 mid self 8x8 latent"),
        (2, 64, 77, 8, 160, bf, "SD1.5 512^2 mid cross 8x8 latent"),
        (2, 6144, 6144, 8, 40, bf, "SD1.5 768x512 self 64x96 latent"),
        (2, 6144, 77, 8, 40, bf, "SD1.5 768x512 cross 64x96 latent"),
        (2, 1536, 1536, 8, 80, bf, "SD1.5 768x512 self 32x48 latent"),
        (2, 1536, 77, 8, 80, bf, "SD1.5 768x512 cross 32x48 latent"),
        (2, 384, 384, 8, 160, bf, "SD1.5 768x512 self 16x24 latent"),
        (2, 384, 77, 8, 160, bf, "SD1.5 768x512 cross 16x24 latent"),
        (2, 96, 96, 8, 160, bf, "SD1.5 768x512 mid self 8x12 latent"),
        (2, 96, 77, 8, 160, bf, "SD1.5 768x512 mid cross 8x12 latent"),
        # phase 13: the regional request's two cond entries and one
        # uncond in one stacked call (B = 3), SD1.5 at 512^2
        (3, 4096, 4096, 8, 40, bf, "regional self 64x64 latent"),
        (3, 4096, 77, 8, 40, bf, "regional cross 64x64 latent"),
        (3, 1024, 1024, 8, 80, bf, "regional self 32x32 latent"),
        (3, 1024, 77, 8, 80, bf, "regional cross 32x32 latent"),
        (3, 256, 256, 8, 160, bf, "regional self 16x16 latent"),
        (3, 256, 77, 8, 160, bf, "regional cross 16x16 latent"),
        (3, 64, 64, 8, 160, bf, "regional mid self 8x8 latent"),
        (3, 64, 77, 8, 160, bf, "regional mid cross 8x8 latent"),
        # phase 13: SD2.1-unclip at 768^2, 5/10/20 heads of 64
        (2, 9216, 9216, 5, 64, bf, "SD2.1 768^2 self 96x96 latent"),
        (2, 9216, 77, 5, 64, bf, "SD2.1 768^2 cross 96x96 latent"),
        (2, 2304, 2304, 10, 64, bf, "SD2.1 768^2 self 48x48 latent"),
        (2, 2304, 77, 10, 64, bf, "SD2.1 768^2 cross 48x48 latent"),
        (2, 576, 576, 20, 64, bf, "SD2.1 768^2 self 24x24 latent"),
        (2, 576, 77, 20, 64, bf, "SD2.1 768^2 cross 24x24 latent"),
        (2, 144, 144, 20, 64, bf, "SD2.1 768^2 mid self 12x12 latent"),
        (2, 144, 77, 20, 64, bf, "SD2.1 768^2 mid cross 12x12 latent"),
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
        fanout_report, txt_refs = fanout(docs, input_dir, upscaled[42], rows)
        report17 = fanout_report.pop("phase17")
        emit("fanout", fanout_report)
        sdxl_report, sdxl_reqs, sdxl_img = sdxl_requests(
            docs["sdxl"], input_dir, shape_counts)
        requests += sdxl_reqs
        emit("sdxl", sdxl_report)
        disk_report, disk_reqs = from_disk(docs, input_dir, shape_counts,
                                           sdxl_img, upscaled[42])
        requests += disk_reqs
        emit("from_disk", disk_report)
        staged_report, staged_reqs = staged(docs, input_dir, shape_counts)
        requests += staged_reqs
        emit("staged", staged_report)
        emit("workflow_9_11", {"requests": sdxl_reqs + disk_reqs
                               + staged_reqs})
        # phase 12's own inputs: the other phases read the empty dir
        inpaint_dir = os.path.join(input_dir, "inpaint")
        os.makedirs(inpaint_dir)
        write_inpaint_inputs(inpaint_dir, 8)
        inpaint_report, inpaint_reqs = inpainting(docs, inpaint_dir,
                                                  shape_counts, rows)
        requests += inpaint_reqs
        emit("inpainting", inpaint_report)
        # phase 13's own inputs: input.png (ip2p) and concept.png (unclip)
        phase13_dir = os.path.join(input_dir, "phase13")
        os.makedirs(phase13_dir)
        write_phase13_inputs(phase13_dir, 512)
        report13, reqs13 = phase13(docs, phase13_dir, shape_counts, rows)
        requests += reqs13
        emit("phase13_report", report13)
        report14, inpaint_refs = fault_drills(docs, inpaint_dir,
                                              upscaled[42], rows)
        emit("phase14", report14)
        report15, interrupted = worker_management(docs, txt_refs, rows)
        shape_counts.update(interrupted["shapes"])
        requests.append(interrupted)
        emit("phase15", report15)
        report16, failover = master_failover(
            docs, inpaint_dir, upscaled[42], inpaint_refs,
            fanout_report["seconds"]["upscale warm"], rows)
        shape_counts.update(failover["shapes"])
        requests.append(failover)
        emit("phase16", report16)
        emit("phase17", {"card": card_line(), **report17})
        report18, sharded = sharded_masters(docs, inpaint_dir, upscaled[42],
                                            inpaint_refs, rows)
        shape_counts.update(sharded["shapes"])
        requests.append(sharded)
        emit("phase18", report18)
    variant_counts = collections.Counter()
    for r in requests:
        variant_counts.update(r["variants"])
    emit("kernels", kernels_line(rows, dict(variant_counts),
                                 dict(shape_counts)))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


def ab_child(root, input_dir) -> int:
    """``--ab-child ROOT INPUT_DIR``: one side of :func:`ab`.  Imports the
    port of the checkout at ``root`` and, for each line ``NAME cold`` or
    ``NAME warm`` on its input, runs ``workflows/distributed-NAME.json``
    of that checkout unchanged (every pipeline released first when
    cold), then answers with one line ``AB {...}``: the request's
    seconds, its samplers' node seconds and the sha256 of its image's
    float32 bytes."""
    import gc
    import hashlib

    sys.path.insert(0, root)
    import numpy as np
    import torch

    from comfyui_distributed_tpu_torch.models import registry
    from comfyui_distributed_tpu_torch.ops.base import OpContext
    from comfyui_distributed_tpu_torch.workflow import WorkflowExecutor
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    for line in sys.stdin:
        name, run = line.split()
        if run == "cold":
            registry.clear_pipeline_cache()
            gc.collect()
            torch.cuda.empty_cache()
        path = os.path.join(root, "workflows", f"distributed-{name}.json")
        with open(path, "r", encoding="utf-8") as f:
            doc = json.load(f)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = WorkflowExecutor(OpContext(device="cuda",
                                         input_dir=input_dir)).execute(doc)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        img = np.ascontiguousarray(res.image_batch, np.float32)
        print("AB " + json.dumps({
            "seconds": seconds,
            "sampler_seconds": sum(
                v for k, v in res.timings.items()
                if doc[k]["class_type"].startswith("KSampler")),
            "sha256": hashlib.sha256(img.tobytes()).hexdigest()}),
            flush=True)
    return 0


AB_WORKFLOWS = ("txt2img", "sdxl", "inpaint")
AB_PAIRS = 10


def ab(parent_root) -> int:
    """``--ab DIR``: this checkout's port against the one at ``DIR`` (an
    unpacked parent commit) on one card.  Each side is a process of its
    own (:func:`ab_child`) that keeps its pipelines; for each of
    ``AB_WORKFLOWS`` both run one cold request, then ``AB_PAIRS`` pairs
    of warm ones in turns (parent first in even pairs, the change first
    in odd ones), so both sides see the same run length and drift.  It
    fails unless every image of a workflow is equal to the bit on both
    sides, and prints one ``ab`` line: each side's seconds and sampler
    seconds per request, the warm medians and quartiles."""
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this comparison runs on "
             "a CUDA card only")
    parent_root = os.path.abspath(parent_root)
    for root in (parent_root, ROOT):
        if not os.path.isdir(os.path.join(root,
                                          "comfyui_distributed_tpu_torch")):
            fail(f"{root} is not a checkout of the port")
    sys.path.insert(0, ROOT)
    card = card_line()
    print(card, flush=True)
    sides = (("parent", parent_root), ("change", ROOT))
    report = {"card": card, "parent": parent_root, "pairs": AB_PAIRS,
              "workflows": {}}
    with tempfile.TemporaryDirectory() as input_dir:
        write_inpaint_inputs(input_dir, 8)
        procs = {side: subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--ab-child", root,
             input_dir], cwd=root, stdin=subprocess.PIPE,
            stdout=subprocess.PIPE, text=True) for side, root in sides}

        def ask(side, name, run):
            proc = procs[side]
            proc.stdin.write(f"{name} {run}\n")
            proc.stdin.flush()
            for line in proc.stdout:
                if line.startswith("AB "):
                    return {"run": run, **json.loads(line[3:])}
            fail(f"{side} ended while running {name} ({run}): exit "
                 f"{proc.wait()}")

        try:
            for name in AB_WORKFLOWS:
                runs = {side: [ask(side, name, "cold")] for side, _ in sides}
                for i in range(AB_PAIRS):
                    for side, _ in (sides if i % 2 == 0 else sides[::-1]):
                        runs[side].append(ask(side, name, "warm"))
                digests = {r["sha256"] for rs in runs.values() for r in rs}
                if len(digests) != 1:
                    fail(f"{name}: the images differ: {sorted(digests)}")
                summary = {}
                for side, rs in runs.items():
                    warm = [r["seconds"] for r in rs[1:]]
                    q1, q2, q3 = statistics.quantiles(warm, n=4)
                    summary[side] = {
                        "cold_seconds": rs[0]["seconds"],
                        "warm_seconds": warm,
                        "warm_median": statistics.median(warm),
                        "warm_quartiles": [q1, q3],
                        "warm_sampler_seconds": [r["sampler_seconds"]
                                                 for r in rs[1:]],
                        "warm_sampler_median": statistics.median(
                            r["sampler_seconds"] for r in rs[1:])}
                summary["sha256"] = digests.pop()
                report["workflows"][name] = summary
        finally:
            for proc in procs.values():
                proc.stdin.close()
            for proc in procs.values():
                try:
                    proc.wait(timeout=120)
                except subprocess.TimeoutExpired:
                    proc.kill()
                    proc.wait()
    emit("ab", report)
    return 0


FANOUT_AB_WARM = 4


def fanout_ab(parent_root) -> int:
    """``--fanout-ab DIR``: phase 8's fan-out upscale (a master and a
    worker, ``workflows/distributed-upscale.json`` at seed 42) with the
    servers of the checkout at ``DIR`` (an unpacked parent commit) and
    with this checkout's, in the turns parent, change, change, parent;
    each turn starts fresh servers and runs one cold and
    ``FANOUT_AB_WARM`` warm requests.  Each side's kernels are built
    first.  It fails unless every saved image is equal to the bit, and
    prints one ``fanout_ab`` line: per side the requests' seconds through
    the master and the worker's ``tile_send`` and the master's
    ``tile_collect`` stage seconds, and the warm medians."""
    import hashlib

    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this comparison runs on "
             "a CUDA card only")
    parent_root = os.path.abspath(parent_root)
    for root in (parent_root, ROOT):
        if not os.path.isdir(os.path.join(root,
                                          "comfyui_distributed_tpu_torch")):
            fail(f"{root} is not a checkout of the port")
    sys.path.insert(0, ROOT)
    from comfyui_distributed_tpu_torch.utils.image import decode_png
    from comfyui_distributed_tpu_torch.utils.net import get_json, post_json
    card = card_line()
    print(card, flush=True)
    sides = {"parent": parent_root, "change": ROOT}
    for side, root in sides.items():
        out = subprocess.run(
            [sys.executable, "-c", "from comfyui_distributed_tpu_torch.ops."
             "kernels import build; build.build_all()"], cwd=root,
            capture_output=True, text=True, timeout=600)
        if out.returncode != 0:
            fail(f"{side}: the kernels did not build: {out.stderr[-2000:]}")
    with open(WORKFLOWS["upscale"], "r", encoding="utf-8") as f:
        doc = with_save_image(json.load(f))
    doc["2"]["inputs"]["seed"] = 42
    runs = {side: [] for side in sides}
    digests = set()
    for side in ("parent", "change", "change", "parent"):
        with tempfile.TemporaryDirectory() as tmp:
            cluster = Cluster(tmp, PHASE8_ROLES, cwd=sides[side])
            try:
                cluster.start()
                master = cluster.url("serve")
                post_json(master + "/distributed/config/update_worker",
                          {"id": "w0", "name": "w0",
                           "port": cluster.ports["worker"], "enabled": True})
                for k in range(1 + FANOUT_AB_WARM):
                    lines0 = {r: len(cluster.prompt_lines(r))
                              for r in ("serve", "worker")}
                    t0 = time.perf_counter()
                    pid = post_json(master + "/prompt", {
                        "prompt": copy.deepcopy(doc),
                        "client_id": "chip_smoke"})["prompt_id"]
                    deadline = time.time() + FANOUT_REQUEST_S
                    while pid not in get_json(master + "/history"):
                        if time.time() > deadline:
                            cluster.fail(f"{side}: no history")
                        time.sleep(0.05)
                    seconds = time.perf_counter() - t0
                    if get_json(master + "/history")[pid]["status"] \
                            != "success":
                        cluster.fail(f"{side}: the request failed")
                    stages = {}
                    for role in ("serve", "worker"):
                        while len(cluster.prompt_lines(role)) \
                                <= lines0[role]:
                            if time.time() > deadline:
                                cluster.fail(f"{side}: no {role} line")
                            time.sleep(0.05)
                        stages[role] = cluster.prompt_lines(role)[
                            lines0[role]]["stage_seconds"]
                    # the pixels: the PNG's text chunks hold the graph,
                    # whose job ids differ from request to request
                    png = cluster.outputs()[-1]
                    with open(os.path.join(cluster.dirs["serve"], "output",
                                           png), "rb") as f:
                        digests.add(hashlib.sha256(
                            decode_png(f.read()).tobytes()).hexdigest())
                    runs[side].append({
                        "run": "cold" if k == 0 else "warm",
                        "seconds": seconds,
                        "worker_tile_send_s": stages["worker"].get(
                            "tile_send"),
                        "worker_wire_s": {key: stages["worker"].get(key)
                                          for key in ("wire_encode",
                                                      "wire_post")},
                        "master_tile_collect_s": stages["serve"].get(
                            "tile_collect")})
            finally:
                cluster.stop()
    if len(digests) != 1:
        fail(f"fan-out images differ between the sides: {sorted(digests)}")
    report = {"card": card, "parent": parent_root, "warm": FANOUT_AB_WARM,
              "sha256": digests.pop(), "runs": runs}
    for side, rs in runs.items():
        warm = [r for r in rs if r["run"] == "warm"]
        report[f"{side}_warm_median_s"] = statistics.median(
            r["seconds"] for r in warm)
        report[f"{side}_warm_tile_send_median_s"] = statistics.median(
            r["worker_tile_send_s"] for r in warm)
    emit("fanout_ab", report)
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--ab-child"] and len(sys.argv) == 4:
        sys.exit(ab_child(sys.argv[2], sys.argv[3]))
    if sys.argv[1:2] == ["--ab"] and len(sys.argv) == 3:
        sys.exit(ab(sys.argv[2]))
    if sys.argv[1:2] == ["--fanout-ab"] and len(sys.argv) == 3:
        sys.exit(fanout_ab(sys.argv[2]))
    sys.exit(main())
