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
   (SDXL's D = 64 at 1024^2, 832^2 and 1216^2, and at B = 8 and 16 for
   phase 19's coalesced groups of 4 and of DTPU_MAX_COALESCE's 8 and at
   B = 4 for phase 20's buckets at pad 2, the SDXL refiner's 12 and
   24 heads, SD1.5's D = 40/80/160 at B = 32 and 16 for the upscale
   and at B = 12 and 10 for phase 14's shares, hedges and reassignments,
   at B = 2 for the inpaint requests at 512^2 and 768 x 512 and at B = 3
   for the regional request, SD2.1's 5/10/20 heads of 64 at 768^2 and
   at 512^2, and SDXL's cross-attentions over ConditioningConcat's 154
   tokens, all in the sm90 kernel), plus the edges of both kernels at every head dim
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
   the kernel's and the library's times are the median of three rounds,
   the plain version's and ``mma.sync``'s (comparators) of the first
   round alone.  Each row has its host seconds and the seconds the
   comparators' two later rounds would have added; the ``phase3`` line
   sums both, and phase 24's own rows' seconds, beside the seconds the
   patched UNets' meta-device forwards took (run while phase 2's
   ``nvcc`` builds) and the seconds the build's end waited for them;
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
   their own, and phase 25's compositing graph on ``tiny_inpaint`` (a
   16-bit RGBA file, tiles that really tile) with a batch graph on
   ``tiny`` (a palette file, VAEEncodeTiled, RepeatLatentBatch,
   LatentBatchSeedBehavior "fixed" at B = 2, ConditioningAverage,
   LatentFromBatch and the image and mask ops:
   :func:`tiny_composite_docs`), a merge graph (ModelMergeBlocks, then
   CLIPMergeSimple: :func:`tiny_merge_doc`) and txt2img as a UI document
   with a bypassed node (:func:`ui_doc`, whose card image also equals
   the API document's to the bit), must agree within 1e-3 (the unclip run
   on the card takes the CPU run's image embedding, as the unCLIP noise
   is keyed by its bytes, and the card's own embedding must agree within
   1e-3 too);
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
   one request to time by, one with ``POST /interrupt``
   ``PHASE15_INTERRUPT_AT`` of that run's KSampler seconds after the
   master logs the KSampler's start (its
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
   disabled: the upscale (seed 42) cold and once warm (a second warm
   run was cut to hold the script's time), each within
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
19. the JAX package's default dispatch model (coalescing, the overlapped
   finalize, the reuse plane's three tiers, ``/distributed/warmup``, the
   preview route), through one ``cli serve`` and the reuse plane on (a
   ``cli worker`` beside it, enabled only for step 5b), SDXL txt2img at
   1024^2 and 20 euler/karras steps as a
   plain graph (``distributed-txt2img.json`` without DistributedSeed and
   DistributedCollector), virtual weights.  Its in-process references
   are made where their pipelines are warm: serial runs of the burst's
   seeds (and of the encode tier's seed with ``DTPU_CACHE=0``) right
   after phase 5, the tile tier's ``DTPU_CACHE=0`` upscale of the
   changed source right after phase 7 (their launches are not
   counted).  The pipelines are released first (it fails unless
   ``PHASE19_MIN_FREE`` bytes are free).  (1) ``POST
   /distributed/warmup`` (batch 1, the request's shape) and the first
   request after it.  (2) An occupier (another prompt text: another
   signature) starts, then four plain graphs at seeds
   ``PHASE19_SEEDS`` and a queued PreviewImage graph (a third text) are
   posted: the four must run as one dispatch, each history entry
   ``coalesced: 4``, ``coalesced_batches`` up by one, each PNG's
   ``prompt`` chunk with its own seed and each image within
   ``FANOUT_ATOL["one_batch"]`` of its serial run; a preview client of
   the queued graph disconnects and the graph must end ``abandoned``
   with no launch (two runs in all), while a client of the first of the
   four gets the terminal event.  (3) A PreviewImage graph twice: the
   second history entry is the JAX package's cache-hit entry, its job
   span ``cache_hit``.  (4) The first text at a new seed: both
   CLIPTextEncode spans ``cache_hit``, the PNG equal to the bit to the
   ``DTPU_CACHE=0`` in-process run.  (5) The tile tier:
   ``distributed-upscale.json`` with its ImageScale reading a 512^2
   source directly (the RRDB's receptive field spans the whole source,
   so any change there moves every tile) twice on one source: the
   second run skips all 16 tiles, launches nothing and equals the first
   to the bit; then one tile's region of the source changes: 15 tiles
   skipped, tile 5 refined alone (B = 2), the image equal to the bit to
   an in-process ``DTPU_CACHE=0`` run of the changed source outside
   tile 5's region and within the one-batch limits inside it.  (5b)
   The tile tier on the fan-out, the worker enabled (the master hedges
   nothing, as phase 8's): a third source
   (step 5's flipped upside down) split between the master and the
   worker (8 tiles each; none skipped, the worker's 8 received and
   stored by the master), then its re-run: all 16 tiles skipped (they
   check in to the ledger as ``cache`` before any work, so the drain
   ends without the worker's sends), the master launching nothing, the
   image equal to the first fan-out's to the bit.  (6)
   ``cli reuse`` shows entries in all three tiers, ``/distributed/
   metrics`` ``pipeline.overlap`` and ``pipeline.coalesce`` true and the
   ``reuse`` block, ``metrics.prom`` the ``dtpu_cache_*`` and
   ``dtpu_preview_*`` families and ``clear_memory`` a
   ``cache_freed_bytes`` above 0.  Every launch must be sm90 at shapes
   phase 3 checked; they count in the ``kernels`` line (the servers'
   prompt lines: a group's head line carries its run's launches; the
   worker's share of the re-run fails once its uploads find the
   master's job finished, and its line still counts its launches).  It
   prints a ``phase19`` line: the card, the warmup's timings, the
   seconds an image coalesced and serial, the replay's seconds, the
   tiles skipped, the peak memory and the sm90 launches.
20. continuous batching, through one ``cli serve`` with
   ``PHASE20_ENV`` (``DTPU_CB=1``, parking armed, the reuse plane off,
   two slots and the pad set {2}: every boundary at attention batch
   B = 4, previews every 5 steps), SDXL txt2img at 1024^2 and 20 steps as
   phase 19's plain graph.  Its references are phase 19's in-process
   runs (and two euler_ancestral ones made with them).  It first times
   ``samplers.step_noise_rows`` at the ancestral bucket's shape in
   process.  (0) ``POST /distributed/warmup``, then the graph with
   dpmpp_2m (no extracted step: the fallback, one dispatch at B = 2),
   the server's serial yardstick.  (1) Prompt a (euler), its preview
   stream watched; once its bucket has stepped ``PHASE20_JOIN_AT``
   times, prompt b: b must join a's bucket (one bucket, two admits, b's
   ``cb_admit`` span at slot 1, under 40 boundaries for the two); then
   an euler_ancestral pair makes a second bucket.  Each image within
   ``FANOUT_ATOL["one_batch"]`` of its serial run; a's stream four
   preview frames, at steps 5, 10, 15 and 20, each a PNG of the latent's
   size.  (2) The batch-class prompt at seed 1004 alone (its unparked
   run), then batch-class prompts at 1003 and 1004 (1004 admitted
   second), then a paid prompt once their bucket has stepped
   ``PHASE20_PREEMPT_AT`` times: one park (1004, its ``cb_park`` span
   ``preempted_by`` paid, the parked count seen at 1), one preemption,
   one resume, the paid prompt done before 1004, every image within the
   one-batch limits of its serial run; 1004's image against its
   unparked run's is recorded (to the bit expected).  (3) ``cli
   flightdeck --json``: a deck row a boundary, its admits, retires and
   preemptions summing to the drills' (8, 8, 1); the table's last rows
   printed.  Each bucket must have launched sm90 140 times a boundary at
   shapes phase 3 checked; the buckets' and the fallback's launches
   count in the ``kernels`` line.  It prints a ``phase20`` line: the
   seconds an image of the late-join pair and of the second bucket
   against the fallback's, the park and resume seconds, the noise
   draw's host seconds, the flight deck's histogram and the launches.
21. the elastic fleet (``runtime/autoscale.py``, ``utils/chaos.py``), on
   one ``cli serve`` master with no workers (started while phase 20
   runs) and ``PHASE21_ENV``: the autoscaler armed at a short tempo (up
   over 2 prompts a participant, down under 0.5, windows of two 0.5 s
   samples, a 3 s cooldown, at most one worker), the reuse plane,
   coalescing and the hedge off, and a seeded ``DTPU_CHAOS`` spec
   faulting only ``/distributed/job_complete`` (503s and corrupted
   uploads, ``PHASE21_CHAOS``).  Eight ``distributed-txt2img.json``
   prompts (SDXL 1024^2, 20 steps) at seeds SEEDS[0] + 1 .. + 8 within
   0.5 s; ``/distributed/fleet`` polled every ``PHASE21_POLL_S``: one
   ``up`` spawns an ``auto_*`` ``cli worker`` on the card through the
   process manager; once it is ready (healthy, ``launching`` clear)
   ``cli top --json`` must list it and a prompt at SEEDS[0] fans out to
   it, its upload answered 503, then 500 (corrupted), then delivered;
   once the queue empties one ``down`` marks it ``retiring`` and the
   reap stops it.  Hard: every prompt ``success`` (one image a burst
   prompt, two for the fan-out), the decision ring exactly up and down
   with no flap, no process of the worker's tree alive, the config and
   the registry without it, at least one 5xx and one corruption injected
   and one image received, ``cli fleet`` and ``cli top`` exiting 0,
   ``metrics.prom``'s autoscale counters 1, 1 and 0, 2800 sm90 launches
   on every prompt line of the master and the worker at shapes phase 3
   checked, and the burst's image at SEEDS[0] + 1 and the fan-out's two
   within ``FANOUT_ATOL["same"]`` of phase 8's in-process images.  It
   prints a ``phase21`` line: the seconds of each event from the burst's
   first post, the utilization at each decision, the chaos counters, the
   images' differences and the launches.
22. ControlNet and the UNet's structural patches, in process on SD1.5
   (phase 10's file when it was kept, else its virtual weights; 512^2,
   batch 1, 20 euler/karras steps, cfg 7), graphs built here: the plain
   graph's image; it written as a PNG, ``LoadImage`` and ``Canny(0.4,
   0.8)`` give the hint.  A virtual ControlNet through ControlNetApply,
   ControlNetApplyAdvanced with the window (0, 1), and with an empty
   window (1, 1), each equal to the plain image to the bit (the virtual
   net's zero projections); a ControlNet file the port writes
   (``export_controlnet``, its projections drawn from
   ``PHASE22_PROJ_SEED``), loaded by ControlNetLoader with its family
   inferred from the file (sd15), run twice: equal to the bit, finite,
   non-constant and beyond ``FANOUT_ATOL["one_batch"]`` of the plain
   image; a second file of that net less the UNet's matching leaves
   through DiffControlNetLoader, within those limits of the file's
   image; the file's net and the virtual one chained, equal to the
   file's image to the bit; FreeU and FreeU_V2 (``PHASE22_FREEU``),
   ``HyperTile`` (``PHASE22_HYPERTILE``) and PatchModelAddDownscale at
   its defaults, each finite, non-constant and off the plain image; and
   deep shrink under the file's net, equal to the file's image to the
   bit with the JAX package's log line.  Each request's sm90 launches
   are exact (640 a UNet, 280 more a ControlNet that runs: 920 for one
   net, 1200 for two) and at shapes phase 3 checked (which takes
   HyperTile's and deep shrink's own shapes from a forward of the
   patched UNet on the meta device, :func:`patched_attention_shapes`).
   It prints a ``phase22`` line: each check's max and mean difference,
   each request's seconds, node seconds, launches, attention ms (phase
   3's times of its shapes times its launches) and peak memory, and the
   card.
23. Custom sampling and the CFG variants, in phase 22's process on its
   SD1.5 file, seed and plain graph (:func:`phase23_doc`) with
   ``DTPU_CACHE=0``, phase 22's plain image reused.  Equal to it to the
   bit: SamplerCustomAdvanced (RandomNoise, CFGGuider at the same cfg,
   KSamplerSelect euler, BasicScheduler karras 20), SamplerCustom with
   the same sampler and sigmas, and ModelSamplingDiscrete (eps, zsnr
   off) under KSampler; equal to the first of those to the bit, the
   sigmas split at step 10 (``PHASE23_SPLIT_AT``) into two
   SamplerCustomAdvanced, the second under DisableNoise.  Within the
   one-batch limits (``FANOUT_ATOL["one_batch"]``) of plain, since they
   reduce to plain CFG but run other batches: DualCFGGuider with cond2
   the negative, PerpNegGuider whose empty conditioning is an encode of
   the negative's text, and SelfAttentionGuidance at scale 0.  The
   PerpNeg patch under KSampler with that empty conditioning equal to
   PerpNegGuider's image to the bit.  Finite and beyond those limits of
   plain: SAG at ``PHASE23_SAG``, RescaleCFG ``PHASE23_RESCALE``,
   AlignYourStepsScheduler SD1 with 10 dpmpp_2m steps, and one
   SDTurboScheduler step under BasicGuider.  Each request's sm90
   launches are exact (:func:`phase23_launches`: 640 at B = 3 for the
   3-row guidances, 1260 for SAG, 620 at B = 2 and 640 at B = 1, its
   captured middle self-attention launching none, 32 at B = 1 for
   SDTurbo) and at shapes phase 3 checked (its B = 1 rows and the
   counts of a call, 32 and SAG's capture 31, from
   :func:`phase23_kernel_shapes`, a meta-device forward).  It prints a
   ``phase23`` line: each check's max and mean difference, each
   request's seconds, sampler-node seconds, node seconds, launches,
   attention ms and peak memory, and the card.
24. The UNet's last patches and the conditioning add-ons, in phase 22's
   process after phase 23, on its SD1.5 file, seed and plain graph
   (:func:`phase24_doc`) with ``DTPU_CACHE=0``, phase 22's plain image
   reused.  The phase first writes its files into the models directory
   (:func:`write_phase24_files`): an A1111 hypernetwork holding the
   virtual ``PHASE24_HN``'s 768-wide streams, a ViT-L CLIP-vision file
   of virtual weights and a textual-inversion ``emb_params`` file.
   Beyond the same-batch limits (``FANOUT_ATOL["same"]``) of plain:
   TomePatchModel 0.3 (640 launches, 100 of them at (2, 2868, 4096, 8,
   40): kept tokens are exact, only the merged ones move), the virtual
   hypernetwork at strength 1, and GLIGEN with the fuser pipeline's
   gates set to ``PHASE24_GATES``, which repeats to the bit.  Equal to
   plain to the bit: TomePatchModel 0, HypernetworkLoader at strength
   0, GLIGENLoader + GLIGENTextBoxApply with one box (the virtual gates
   are 0; 960 launches, a fuser's attention a block), and a prompt
   naming an embedding with no file; the hypernetwork file equal to the
   virtual one to the bit.  Beyond the one-batch limits of plain:
   CLIPVisionLoader (the ViT-L file) and CLIPVisionEncode of phase 22's
   hint image with StyleModelLoader and StyleModelApply (320 of the 640
   launches cross-attend 77 + 8 tokens), and the prompt with
   ``embedding:`` and the file's name.  Each request's sm90 launches are
   exact and at shapes phase 3 checked (:func:`phase24_kernel_shapes`, a
   meta-device forward under each patch).  It prints a ``phase24`` line
   like phase 23's, with the files' write seconds and bytes.
25. The inpaint families and the compositing ops, in process from
   virtual weights with ``DTPU_CACHE=0`` (:func:`inpaint_composites`):
   :func:`composite_doc` (LoadImage of a 16-bit RGBA file the phase
   writes, GrowMask and FeatherMask on its mask, InpaintModelConditioning
   with ConditioningConcat on the positive and ConditioningZeroOut on
   the negative, KSampler at 20 euler/karras steps and cfg 7,
   VAEDecodeTiled at tile 512 and overlap 64, ImageCompositeMasked back
   onto the source) on ``sd_xl_base_1.0_inpainting_0.1.safetensors``
   (``sdxl_inpaint``) at 1024^2 cold and warm, and on
   ``512-inpainting-ema.ckpt`` (``sd21_inpaint``, without the concat)
   at 512^2 cold.  Hard: every image finite with std > 0; exactly 2800
   sm90 launches for an SDXL request and 640 for SD2.1, at shapes phase
   3 checked; the sampled latent equal to the encoded source to the bit
   where the latent mask is 0; the warm image equal to the cold one;
   VAEDecodeTiled at a tile of 1024 equal to VAEDecode on the warm
   latent, and at 512 (9 tiles) and VAEEncodeTiled of the source within
   ``PHASE25_DECODE_LIMITS`` and ``PHASE25_ENCODE_LIMITS`` of their
   one-shot forms.  It prints a ``phase25`` line: each request's
   seconds, node seconds, launches, attention ms and peak memory, the
   anchoring, and the tiled forms' differences and seconds beside the
   one-shot ones.
26. Merging, saving and the animations, in phase 22's process
   on its SD1.5 file (A), graph and seed, with ``DTPU_CACHE=0``: a
   second SD1.5 name (B, ``PHASE26_B``, a virtual fill), then
   ModelMergeSimple at ratio 1.0 (A's image to the bit), 0.0 (B's) and
   0.5 (beyond the one-batch limits of both), ModelMergeSubtract(A, B, 1)
   then ModelMergeAdd(., B) (within them of A: bf16 rounds twice),
   ModelMergeBlocks(1, 0, 1) (every middle-block weight B's and every
   other A's, to the bit; the image beyond the same-batch limits of A's,
   as the middle block alone moves it less than the one-batch ones) and
   CLIPMergeSimple(0.5) (beyond the one-batch limits of A's).  The 0.5
   merge's ModelSave, CLIPSave, VAESave and SaveLatent files read back
   through UNETLoader, CLIPLoader, VAELoader and LoadLatent (then
   VAEDecode), and its native checkpoint (``runtime/checkpointing.py``)
   through CheckpointLoaderSimple, each to the 0.5 merge's image to the
   bit.  SaveAnimatedPNG and SaveAnimatedWEBP (lossless and lossy) write
   four of those images from the card (their encoders run on the host):
   the APNG's default image reads back to the bit with the port's
   ``read_png``, each WEBP's chunks give its frames and durations.
   ImageQuantize, without and with dither, runs on the card and on the
   CPU on the whole 0.5 merge's image, to the same output.  Every sampled
   request launches exactly 640 sm90 at shapes phase 3 checked.  It
   prints a ``phase26`` line: each request's seconds, node seconds,
   launches, attention ms and peak memory, the merges' seconds and the
   peak bytes a merge adds, each file's write and load seconds and
   bytes, and the native load's seconds beside the lone safetensors
   files'.

Phases 14, 15, 16, 20 and 21 launch their servers before the phase
before them (13, 14, 15, 19 and 20) runs, so a server's start
(importing torch, opening the card: about 12 s) overlaps it; each
releases the pipelines, checks its free device memory and waits for its
servers when its own turn comes.

The servers of phases 14-21 load phase 10's model files
(``SERVER_MODELS_DIR``; phase 10 keeps them while 8 GiB of disk stay
free beside them) instead of filling their pipelines virtually.  The
servers of phases 8 and 14-18 start with ``DTPU_CACHE=0``
(``RECOMPUTE_ENV``), and phase 8's in-process two-batch upscale runs
with it too: their checks need each request recomputed (a warm fan-out
upscale's master would take every tile from the tile tier, so its
share's launches, its profile and its batches would not be the ones
checked).  The in-process requests of phases 4-13 run with the plane on
(the encode memo: a warm request takes its text encodes from it).

Launch counts are zeroed just before each request of phases 5-7,
9-13 and 22-26 and read just after (phase 15's interrupted request and every
request of phases 16, 18, 19 and 21: their servers' prompt lines;
phase 20's: its buckets' counts, each step's own, and its prompt
lines).  The line before the last is ``{"kernels":
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

import atexit
import collections
import concurrent.futures
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
# phase 3's timing rounds (each candidate once a round, in turns): three
# keep the whole script inside its 1200 s on a slow host
ROUNDS = 3
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
# phase 10's model files, kept for every later server (``--models-dir``):
# a server loads SDXL from its file in about 1.5 s, SD1.5 in 0.5 s, where
# a virtual fill takes 11-15 s and 3.7-7.6 s; phase 10 holds the files
# equal to the virtual weights (its images to the bit).  None: servers
# fill virtually.
SERVER_MODELS_DIR = None
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
# the servers of phases 8 and 14-18 run with the reuse plane off: their
# checks need each request recomputed (a warm fan-out upscale's master
# would take every tile from the tile tier, and its launches and
# profile would read 0); phase 19's server turns it on
RECOMPUTE_ENV = {"DTPU_CACHE": "0"}
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
# the interrupt's time after the KSampler's start, as a share of the
# calibration request's KSampler seconds: a quarter, so that it lands
# mid-sampling even when phase 16's servers, starting meanwhile, slowed
# the calibration on the host (at a half, a slow host's interrupt once
# came after the sampler's end)
PHASE15_INTERRUPT_AT = 0.25
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
# phase 22: ControlNet and the UNet patches on SD1.5 at 512^2
PHASE22_SEED = 2201
PHASE22_HINT = "phase22_plain.png"
PHASE22_VIRTUAL_CN = "control_v11p_sd15_canny_virtual.pth"
PHASE22_CN = "phase22_canny_sd15.safetensors"
PHASE22_DIFF_CN = "phase22_canny_sd15_diff.safetensors"
# the file's net: the virtual net's weights, with its zero projections
# (zero convs, mid_out, the hint ladder's last conv) drawn by the virtual
# rule from this seed in place of zeros
PHASE22_PROJ_SEED = 22
PHASE22_FREEU = (1.5, 1.6, 0.9, 0.2)
PHASE22_HYPERTILE = (256, 2, 0, False)
# sm90 launches a request: the UNet's 16 transformer blocks x 2
# attentions x 20 steps, and a ControlNet's 7 (6 down, 1 middle)
PHASE22_UNET_LAUNCHES = 640
PHASE22_NET_LAUNCHES = 280
PHASE22_BUDGET_S = 40.0
# phase 23: custom sampling and the CFG variants on phase 22's SD1.5 file,
# seed and graph; an SD1.5 UNet call launches 32 attentions (16
# transformer blocks x 2), SAG's capture call 31 (its middle block's
# first self-attention is materialised, not launched)
PHASE23_CALL_LAUNCHES = 32
PHASE23_CAPTURE_LAUNCHES = 31
PHASE23_STEPS = 20
PHASE23_SPLIT_AT = 10
PHASE23_DUAL_CFG2 = 3.0
PHASE23_SAG = (0.5, 2.0)
PHASE23_RESCALE = 0.7
PHASE23_AYS_STEPS = 10
PHASE23_BUDGET_S = 30.0
# phase 24: the UNet's last patches and the conditioning add-ons
PHASE24_TOME = 0.3
PHASE24_HN = "phase24_hypernetwork.pt"            # no file: the virtual one
PHASE24_HN_FILE = "phase24_hypernetwork_file.pt"  # its weights, written
PHASE24_GLIGEN = "gligen_sd14_textbox_pruned.safetensors"
PHASE24_BOX = ("a lighthouse", 192, 320, 160, 96)  # text, width, height, x, y
PHASE24_GATES = 0.5
PHASE24_VISION = "phase24_clip_vit_l.safetensors"  # a ViT-L file, written
PHASE24_STYLE = "t2iadapter_style_sd14v1.pth"
PHASE24_STYLE_TOKENS = 8
PHASE24_EMBEDDING = "phase24_embedding"
PHASE24_EMB_SHAPE = (4, 768)
PHASE24_EMB_SEED = 24
PHASE24_BUDGET_S = 40.0
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


# (tag, seconds since the start) of each emitted line: where the run's
# time goes, printed as the ``timeline`` line before the ``kernels`` line
_T0 = time.perf_counter()
TIMELINE = []


def emit(tag: str, obj) -> None:
    TIMELINE.append([tag, round(time.perf_counter() - _T0, 3)])
    print(f"chip_smoke: {tag} at {TIMELINE[-1][1]} s", file=sys.stderr,
          flush=True)
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


def time_in_turns(fns, reps, once=()):
    """name -> median device ms over ROUNDS rounds; each round times every
    candidate once, in the given order and then reversed, so a drift of
    the card's clock falls on all of them alike.  The names in ``once``
    (comparators, no yardstick) are timed in the first round only.
    Returns (medians, the host seconds each candidate's timing took)."""
    times = {name: [] for name in fns}
    walls = dict.fromkeys(fns, 0.0)
    for r in range(ROUNDS):
        order = list(fns) if r % 2 == 0 else list(fns)[::-1]
        for name in order:
            if r and name in once:
                continue
            fn, n = fns[name]
            t0 = time.perf_counter()
            times[name].append(time_ms(fn, max(int(reps * n), 3)))
            walls[name] += time.perf_counter() - t0
    return ({name: statistics.median(ts) for name, ts in times.items()},
            walls)


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
        t_row = time.perf_counter()
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
        # the plain version and mma_sync are comparators: one round each
        once = ("plain_ms", "mma_sync_ms")
        times, walls = time_in_turns(fns, 20 if N * M >= 1 << 20 else 100,
                                     once=once)
        b_ms, b_by, flops, nbytes = bound(B, N, M, H, D, dt)
        row = {"role": role, "variant": variant, "B": B, "N": N, "M": M,
               "H": H, "D": D, "dtype": dt, "max_abs_err": errs["ms"][0],
               "rel_err": errs["ms"][1], **times, "bound_ms": b_ms,
               "bound_us": b_ms * 1e3, "bound_by": b_by,
               "exp2_ms": exp2_ms(B, N, M, H, D, dt), "named": bool(named),
               "tflops": flops / (times["ms"] * 1e-3) / 1e12,
               "roofline_share": b_ms / times["ms"],
               # host seconds of the row, and what timing the
               # comparators in every round would have added
               "seconds": time.perf_counter() - t_row,
               "rounds_saved_s": (ROUNDS - 1) * sum(walls.get(k, 0.0)
                                                    for k in once)}
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


def tiny_merge_doc(txt):
    """Phase 4's merge graph: the tiny txt2img with a second checkpoint,
    its UNet through ModelMergeBlocks(0.3, 0.6, 0.8) and its CLIP through
    CLIPMergeSimple(0.4)."""
    doc = copy.deepcopy(txt)
    doc["20"] = _node("CheckpointLoaderSimple",
                      ckpt_name="tiny-merge-b.safetensors")
    doc["21"] = _node("ModelMergeBlocks", model1=["4", 0], model2=["20", 0],
                      input=0.3, middle=0.6, out=0.8)
    doc["22"] = _node("CLIPMergeSimple", clip1=["4", 1], clip2=["20", 1],
                      ratio=0.4)
    doc["3"]["inputs"]["model"] = ["21", 0]
    doc["6"]["inputs"]["clip"] = doc["7"]["inputs"]["clip"] = ["22", 0]
    return doc


def ui_doc(api, bypass):
    """``api`` as the UI-format document ComfyUI's browser saves: nodes
    with ``widgets_values`` in each op's ``WIDGETS`` order (``CONTROL``
    slots "fixed") and links, an ImageInvert in mode 4 (bypassed) spliced
    into the IMAGE link ``bypass`` = (node id, input) names."""
    from comfyui_distributed_tpu_torch.ops.base import (CONTROL,
                                                        NODE_CLASS_MAPPINGS)
    api = {k: copy.deepcopy(v) for k, v in api.items()
           if isinstance(v, dict) and "class_type" in v}
    nid, inp = bypass
    api["900"] = dict(_node("ImageInvert", image=api[nid]["inputs"][inp]),
                      mode=4)
    api[nid]["inputs"][inp] = ["900", 0]

    def is_link(v):
        return isinstance(v, list) and len(v) == 2 and isinstance(v[1], int)

    nodes, links = [], []
    for nid, node in api.items():
        cls = NODE_CLASS_MAPPINGS[node["class_type"]]
        defaults = cls.DEFAULTS or {}
        widgets = ["fixed" if w == CONTROL
                   else defaults.get(w, 0) if is_link(
                       node["inputs"].get(w)) or w not in node["inputs"]
                   else node["inputs"][w] for w in cls.WIDGETS]
        inputs = []
        for slot, (name, v) in enumerate(node["inputs"].items()):
            if is_link(v):
                ltype = "IMAGE" if name in ("image", "images") else name
                links.append([len(links) + 1, int(v[0]), v[1], int(nid),
                              slot, ltype])
                inputs.append({"name": name, "type": ltype,
                               "link": len(links)})
        nodes.append({"id": int(nid), "type": node["class_type"],
                      "mode": node.get("mode", 0), "inputs": inputs,
                      "outputs": [{"type": "IMAGE"}],
                      "widgets_values": widgets})
    return {"nodes": nodes, "links": links, "version": 0.4}


# the family of each inpaint workflow's tiny stand-in (phase 4)
TINY_INPAINT_FAMILY = {"inpaint": "tiny", "outpaint": "tiny",
                       "inpaint_model": "tiny_inpaint"}
# phase 4's family override of the phase 13 stand-ins (None: the names
# decide, as the split loaders' tiny names do)
TINY_PHASE13_FAMILY = {"regional": "tiny", "ip2p": None,
                       "unclip": "tiny_unclip"}
# phase 4's compositing graphs (phase 25's at the tiny size), their
# family and their inputs: a 16-bit RGBA file and a palette file
TINY_COMPOSITE_FAMILY = {"inpaint_composite": "tiny_inpaint",
                         "batch_composite": "tiny"}
TINY_COMPOSITE_HW = (40, 48)


def tiny_composite_docs(input_dir):
    """Phase 4's two compositing graphs, their PNG inputs written into
    ``input_dir``: :func:`composite_doc` at 48 x 56 (tiles of 24 pixels,
    12 latent units, overlapping by 8) and :func:`batch_composite_doc`
    at ``TINY_COMPOSITE_HW``."""
    with open(os.path.join(input_dir, "src16.png"), "wb") as f:
        f.write(png16_rgba(48, 56, 4))
    with open(os.path.join(input_dir, "palette.png"), "wb") as f:
        f.write(png_palette(*TINY_COMPOSITE_HW, 5))
    return {"inpaint_composite": composite_doc(
                "tiny-inpaint-composite.ckpt", "src16.png", 3, 24, 8),
            "batch_composite": batch_composite_doc(
                "tiny-batch-composite.ckpt", "palette.png",
                TINY_COMPOSITE_HW)}


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


def _png_chunk(tag, body):
    import struct
    import zlib
    return (struct.pack(">I", len(body)) + tag + body
            + struct.pack(">I", zlib.crc32(tag + body)))


def png16_rgba(h, w, seed):
    """A 16-bit RGBA PNG (the port's writer and Pillow write none): a
    colour gradient with noise, opaque but for a transparent rectangle
    in the middle (the region to resample)."""
    import struct
    import zlib

    import numpy as np
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w] / max(h, w)
    rgb = np.stack([xx, yy, 1 - xx * yy], -1) * 50000 \
        + rng.integers(0, 15000, (h, w, 3))
    alpha = np.full((h, w, 1), 65535)
    alpha[h // 3:2 * h // 3, w // 4:3 * w // 4] = 0
    px = np.concatenate([rgb, alpha], -1).astype(">u2")
    raw = b"".join(b"\0" + row.tobytes() for row in px.reshape(h, -1))
    return (b"\x89PNG\r\n\x1a\n"
            + _png_chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 16, 6, 0, 0,
                                              0))
            + _png_chunk(b"IDAT", zlib.compress(raw, 1))
            + _png_chunk(b"IEND", b""))


def png_palette(h, w, seed):
    """A 4-bit palette PNG of 16 colours in 4-pixel diagonal bands (``w``
    even)."""
    import struct
    import zlib

    import numpy as np
    rng = np.random.default_rng(seed)
    idx = (np.arange(h)[:, None] // 4 + np.arange(w)[None] // 4) % 16
    pal = rng.integers(0, 256, (16, 3), dtype=np.uint8)
    rows = b"".join(b"\0" + (r[0::2] << 4 | r[1::2]).astype(
        np.uint8).tobytes() for r in idx)
    return (b"\x89PNG\r\n\x1a\n"
            + _png_chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 4, 3, 0, 0,
                                              0))
            + _png_chunk(b"PLTE", pal.tobytes())
            + _png_chunk(b"IDAT", zlib.compress(rows))
            + _png_chunk(b"IEND", b""))


def _node(class_type, **inputs):
    return {"class_type": class_type, "inputs": inputs}


def composite_doc(ckpt, image, steps, tile, overlap, concat=True):
    """Phase 25's inpaint composite (phase 4's on ``tiny_inpaint``):
    LoadImage of an RGBA file, its mask grown (GrowMask) and feathered
    (FeatherMask); InpaintModelConditioning of a positive that
    ConditioningConcat chains from two prompts (154 tokens; with
    ``concat`` false the first prompt alone) and a negative zeroed by
    ConditioningZeroOut; KSampler (euler, karras, cfg 7); VAEDecodeTiled
    at ``tile`` and ``overlap``; ImageCompositeMasked of the result
    back onto the source through the mask; PreviewImage."""
    return {
        "1": _node("CheckpointLoaderSimple", ckpt_name=ckpt),
        "2": _node("LoadImage", image=image),
        "3": _node("GrowMask", mask=["2", 1], expand=4,
                   tapered_corners=True),
        "4": _node("FeatherMask", mask=["3", 0], left=8, top=8, right=8,
                   bottom=8),
        "5": _node("CLIPTextEncode", text="a stone lighthouse on a cliff",
                   clip=["1", 1]),
        "6": _node("CLIPTextEncode", text="at dawn, volumetric light",
                   clip=["1", 1]),
        "7": _node("ConditioningConcat", conditioning_to=["5", 0],
                   conditioning_from=["6", 0]),
        "8": _node("CLIPTextEncode", text="blurry, lowres", clip=["1", 1]),
        "9": _node("ConditioningZeroOut", conditioning=["8", 0]),
        "10": _node("InpaintModelConditioning",
                    positive=["7", 0] if concat else ["5", 0],
                    negative=["9", 0], vae=["1", 2], pixels=["2", 0],
                    mask=["4", 0], noise_mask=True),
        "11": _node("KSampler", seed=2501, steps=steps, cfg=7.0,
                    sampler_name="euler", scheduler="karras", denoise=1.0,
                    model=["1", 0], positive=["10", 0], negative=["10", 1],
                    latent_image=["10", 2]),
        "12": _node("VAEDecodeTiled", samples=["11", 0], vae=["1", 2],
                    tile_size=tile, overlap=overlap),
        "13": _node("ImageCompositeMasked", destination=["2", 0],
                    source=["12", 0], x=0, y=0, resize_source=False,
                    mask=["4", 0]),
        "14": _node("PreviewImage", images=["13", 0]),
    }


def batch_composite_doc(ckpt, image, hw):
    """Phase 4's batch graph on ``tiny``: LoadImage of a palette file
    (``hw`` its (height, width)), VAEEncodeTiled (tiles of 32 pixels:
    the tiny VAE's 16 latent units), RepeatLatentBatch to B = 2,
    LatentBatchSeedBehavior "fixed", ConditioningAverage of two prompts,
    KSampler at denoise 0.7, LatentFromBatch of row 1, VAEDecode; then
    the image and mask ops on the decoded image and the file: blur,
    sharpen, invert, blend, ImageToMask, ThresholdMask, MaskToImage,
    Morphology, SolidMask, MaskComposite, InvertMask, CropMask,
    ImageColorToMask, JoinImageWithAlpha, SplitImageWithAlpha,
    PorterDuffImageComposite, EmptyImage, ImageBatch, ImageFromBatch,
    RebatchImages, ImageCrop, ImageScaleBy, ImageScaleToTotalPixels;
    PreviewImage of the two-image batch.  Every mask comes from the
    file's pixels, so the card's masks are the CPU's to the bit."""
    h, w = hw
    return {
        "1": _node("CheckpointLoaderSimple", ckpt_name=ckpt),
        "2": _node("LoadImage", image=image),
        "3": _node("VAEEncodeTiled", pixels=["2", 0], vae=["1", 2],
                   tile_size=32, overlap=8),
        "4": _node("RepeatLatentBatch", samples=["3", 0], amount=2),
        "5": _node("LatentBatchSeedBehavior", samples=["4", 0],
                   seed_behavior="fixed"),
        "6": _node("CLIPTextEncode", text="a mosaic of coloured glass",
                   clip=["1", 1]),
        "7": _node("CLIPTextEncode", text="a cathedral window",
                   clip=["1", 1]),
        "8": _node("ConditioningAverage", conditioning_to=["6", 0],
                   conditioning_from=["7", 0],
                   conditioning_to_strength=0.7),
        "9": _node("CLIPTextEncode", text="", clip=["1", 1]),
        "10": _node("KSampler", seed=11, steps=3, cfg=5.0,
                    sampler_name="euler", scheduler="karras", denoise=0.7,
                    model=["1", 0], positive=["8", 0], negative=["9", 0],
                    latent_image=["5", 0]),
        "11": _node("LatentFromBatch", samples=["10", 0], batch_index=1,
                    length=1),
        "12": _node("VAEDecode", samples=["11", 0], vae=["1", 2]),
        "20": _node("ImageBlur", image=["12", 0], blur_radius=2, sigma=1.0),
        "21": _node("ImageSharpen", image=["20", 0], sharpen_radius=1,
                    sigma=1.0, alpha=0.8),
        "22": _node("ImageInvert", image=["2", 0]),
        "23": _node("ImageBlend", image1=["21", 0], image2=["22", 0],
                    blend_factor=0.4, blend_mode="overlay"),
        "24": _node("ImageToMask", image=["2", 0], channel="green"),
        "25": _node("ThresholdMask", mask=["24", 0], value=0.5),
        "26": _node("MaskToImage", mask=["25", 0]),
        "27": _node("Morphology", image=["26", 0], operation="close",
                    kernel_size=3),
        "28": _node("ImageToMask", image=["27", 0], channel="red"),
        "29": _node("SolidMask", value=0.5, width=w // 2, height=h // 2),
        "30": _node("MaskComposite", destination=["28", 0],
                    source=["29", 0], x=w // 4, y=h // 4, operation="add"),
        "31": _node("InvertMask", mask=["30", 0]),
        "32": _node("CropMask", mask=["31", 0], x=4, y=4, width=w - 8,
                    height=h - 8),
        "33": _node("ImageColorToMask", image=["2", 0], color=0),
        "34": _node("JoinImageWithAlpha", image=["23", 0], alpha=["32", 0]),
        "35": _node("SplitImageWithAlpha", image=["34", 0]),
        "36": _node("PorterDuffImageComposite", source=["35", 0],
                    source_alpha=["35", 1], destination=["22", 0],
                    destination_alpha=["33", 0], mode="SRC_OVER"),
        "37": _node("EmptyImage", width=w, height=h, batch_size=1,
                    color=0x336699),
        "38": _node("ImageBatch", image1=["36", 0], image2=["37", 0]),
        "39": _node("ImageFromBatch", image=["38", 0], batch_index=0,
                    length=2),
        "40": _node("RebatchImages", images=["39", 0], batch_size=1),
        "41": _node("ImageCrop", image=["40", 0], width=w - 8,
                    height=h - 8, x=4, y=4),
        "42": _node("ImageScaleBy", image=["41", 0],
                    upscale_method="bicubic", scale_by=1.5),
        "43": _node("ImageScaleToTotalPixels", image=["42", 0],
                    upscale_method="lanczos",
                    megapixels=h * w / (1 << 20)),
        "44": _node("PreviewImage", images=["43", 0]),
    }


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
    :func:`shared_embedding`) graphs, and the two compositing graphs
    (:func:`tiny_composite_docs`), a merge graph
    (:func:`tiny_merge_doc`) and the tiny txt2img as a UI document with a
    bypassed node (:func:`ui_doc`; its card image also equal to the API
    document's to the bit), on the card against the CPU runs of the same
    graphs (kernels' plain versions).  The tiny RRDB runs in fp32
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
    composite_dir = tempfile.mkdtemp(prefix="tiny_composite_inputs_")
    try:
        write_inpaint_inputs(inpaint_dir, 1)
        from comfyui_distributed_tpu_torch.models.checkpoints import (
            save_checkpoint)
        pipe = registry.load_pipeline("tiny-to-disk.safetensors",
                                      device="cpu")
        save_checkpoint(os.path.join(models_dir, TINY_FILE), pipe.unet,
                        pipe.clip_models, pipe.vae, pipe.family)
        write_phase13_inputs(phase13_dir, 32)
        tiny_docs = small_docs(docs)
        tiny_docs.update(tiny_composite_docs(composite_dir))
        tiny_docs["merge"] = tiny_merge_doc(tiny_docs["txt2img"])
        tiny_docs["txt2img_ui"] = ui_doc(tiny_docs["txt2img"],
                                         ("14", "images"))
        card_images = {}
        for name, doc in tiny_docs.items():
            staged = name in ("refiner", "hires_fix")
            registry.detect_family = staged_family if staged \
                else detect_family
            family = "tiny_sdxl" if name == "sdxl" \
                else TINY_PHASE13_FAMILY[name] \
                if name in TINY_PHASE13_FAMILY \
                else TINY_COMPOSITE_FAMILY[name] \
                if name in TINY_COMPOSITE_FAMILY \
                else TINY_INPAINT_FAMILY.get(name, "tiny")
            if staged or family is None:
                os.environ.pop("DTPU_DEFAULT_FAMILY", None)
            else:
                os.environ["DTPU_DEFAULT_FAMILY"] = family
            run_dir = inpaint_dir if name in TINY_INPAINT_FAMILY \
                else phase13_dir if name in TINY_PHASE13_FAMILY \
                else composite_dir if name in TINY_COMPOSITE_FAMILY \
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
            card_images[name] = card
            if name == "txt2img_ui":
                # the UI document's graph is the API document's
                same = bool(np.array_equal(card, card_images["txt2img"]))
                out[name]["equals_api_image"] = same
                if not same:
                    fail("tiny txt2img as a UI document: its image on the "
                         "card differs from the API document's")
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
        shutil.rmtree(composite_dir, ignore_errors=True)
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
    interrupted request, 16, 18 and 19: one per kernel variant that they
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
        models = ["--models-dir", SERVER_MODELS_DIR] \
            if SERVER_MODELS_DIR else []
        with open(self.logs[role], "a") as log:
            self.procs[role] = subprocess.Popen(
                [sys.executable, "-m", "comfyui_distributed_tpu_torch.cli",
                 cmd, "--host", "127.0.0.1",
                 "--port", str(self.ports[role]), "--device", DEVICE,
                 "--config", os.path.join(d, "cluster_config.json"),
                 "--input-dir", os.path.join(d, "input"),
                 "--output-dir", os.path.join(d, "output"), *models],
                cwd=self.cwd, stdout=log, stderr=subprocess.STDOUT,
                env={**os.environ, **RECOMPUTE_ENV,
                     **(extra if env is None else env)})

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
    # with the plane off: phase 7's tiles at seed 42 are in the tile tier
    prev = os.environ.get("DTPU_CACHE")
    os.environ["DTPU_CACHE"] = "0"
    try:
        up_ref = run(copy.deepcopy(docs["upscale"]))
    finally:
        Upscaler._refine_tiles = whole
        if prev is None:
            os.environ.pop("DTPU_CACHE", None)
        else:
            os.environ["DTPU_CACHE"] = prev
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
    """Phase 14: the control plane's fault drills on one card.  A
    generator (:func:`resumed`): its first step launches a master and two
    workers (w0, w1), the workers self-registering, so that their start
    overlaps phase 13; its second makes the in-process inpaint images of
    the three seed slices, releases the pipelines and, once the servers
    answer, runs the drills.  Drill 1 runs the upscale with w1
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
            yield
            inpaint_refs = []
            for k in range(3):   # the master's slice, w0's, and w1's
                req = copy.deepcopy(docs["inpaint"])
                req[seed_node]["inputs"]["seed"] = seed + k
                inpaint_refs.append({"same": WorkflowExecutor(OpContext(
                    device=DEVICE, input_dir=input_dir)).execute(
                        req).image_batch[0]})
            registry.clear_pipeline_cache()
            gc.collect()
            torch.cuda.empty_cache()
            free, total = torch.cuda.mem_get_info()
            print(f"phase 14: {free} of {total} bytes of device memory free "
                  f"beside the idle servers", flush=True)
            if free < DRILL_MIN_FREE:
                cluster.fail(f"phase 14 needs {DRILL_MIN_FREE} bytes free "
                             f"for three SD1.5 servers, {free} are")
            t1 = time.perf_counter()
            cluster.wait_up(roles)
            for role in ("w0", "w1"):
                wait_healthy(role)
            started_s = time.perf_counter() - t0
            wait_s = time.perf_counter() - t1
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
    return {"free_bytes_before": free,
            "servers_up_after_launch_s": started_s,
            "servers_wait_s": wait_s, "w1_restart_s": restart_s,
            "seconds": {d["drill"]: d["seconds"] for d in drills},
            "fault_to_success_s": {d["drill"]: d["fault_to_success_s"]
                                   for d in drills},
            "peak_memory": {d["drill"]: d["peak_memory"] for d in drills},
            "ledger": {d["drill"]: d["ledger"] for d in drills}}, \
        inpaint_refs


def resumed(phase):
    """Run a phase generator's second step (its first launched its
    servers) and return what the phase returns."""
    try:
        next(phase)
    except StopIteration as done:
        return done.value
    fail("a phase yielded twice")


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
    left to the monitor when the master is killed.  A generator
    (:func:`resumed`): its first step launches the master, so that its
    start overlaps phase 14.  ``txt_refs``: phase 8's in-process images
    of the two shares; ``rows``: phase 3's checks.  Returns the report
    and the interrupted request's launches (by variant and by shape) for
    the ``kernels`` line."""
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
            t0 = time.perf_counter()
            cluster.launch("serve")
            yield
            registry.clear_pipeline_cache()
            gc.collect()
            torch.cuda.empty_cache()
            t1 = time.perf_counter()
            cluster.wait_up(["serve"])
            report["server_up_after_launch_s"] = time.perf_counter() - t0
            report["server_wait_s"] = time.perf_counter() - t1
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
            # interrupted mid-KSampler, then 4. the same again
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
            # the interrupt lands mid-KSampler: PHASE15_INTERRUPT_AT of
            # the calibration's KSampler seconds after the master logs
            # the node's start
            ksampler_s = next(v for k, v in calib["line"]["node_seconds"]
                              .items() if k.endswith(" KSampler"))
            intr = master_alone("interrupted",
                                PHASE15_INTERRUPT_AT * ksampler_s)
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
                                PHASE15_INTERRUPT_AT * ksampler_s,
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
    start as four ``cli`` servers: a generator (:func:`resumed`) whose
    first step launches them (B once A answers), so that their start
    overlaps phase 15.  References on A with w1 disabled:
    the upscale cold and once warm and the inpaint fan-out.  Drill 1:
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
    report = {"card": card_line(),
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

        # B is launched on a thread once A answers; a phase ending first
        # (a failure) launches none
        closing = threading.Lock()
        closed = []

        def launch_standby():
            # A holds the lease before B looks at it: a standby reads no
            # lease as an expired one
            deadline = time.time() + FANOUT_START_S
            while time.time() < deadline \
                    and cluster.procs["A"].poll() is None:
                try:
                    get_json(cluster.url("A") + "/prompt", timeout=2)
                except OSError:
                    time.sleep(0.5)
                    continue
                with closing:
                    if not closed:
                        cluster.launch("B")
                return

        try:
            t0 = time.perf_counter()
            for role in ("A", "w0", "w1"):
                cluster.launch(role)
            standby = threading.Thread(target=launch_standby, daemon=True)
            standby.start()
            yield
            standby.join()
            registry.clear_pipeline_cache()
            gc.collect()
            torch.cuda.empty_cache()
            free, total = torch.cuda.mem_get_info()
            print(f"phase 16: {free} of {total} bytes of device memory free "
                  f"beside the idle servers", flush=True)
            if free < PHASE16_MIN_FREE:
                cluster.fail(f"phase 16 needs {PHASE16_MIN_FREE} bytes free "
                             f"for four SD1.5 servers, {free} are")
            report["free_bytes_before"] = free
            t1 = time.perf_counter()
            cluster.wait_up(["A"])
            if "B" not in cluster.procs:
                cluster.fail("B was not launched once A answered")
            cluster.wait_up(["B", "w0", "w1"])
            for role in ("w0", "w1"):
                wait_healthy("A", role)
            report["servers_up_after_launch_s"] = time.perf_counter() - t0
            report["servers_wait_s"] = time.perf_counter() - t1
            info = get_json(cluster.url("A") + "/distributed/durability")
            binfo = get_json(cluster.url("B") + "/distributed/durability")
            if info.get("epoch") != 1 or info.get("role") != "active" \
                    or binfo.get("role") != "standby":
                cluster.fail(f"A {info}, B {binfo}: expected A active at "
                             f"epoch 1 and B standing by")

            # references on A, w1 disabled: A and w0 a half each
            refs = {}
            # cold and once warm (a second warm run was cut to keep the
            # script inside its time limit)
            for run in ("cold", "warm"):
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
            warm = [refs["upscale warm"]]
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
            with closing:
                closed.append(True)
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


# the free disk phase 10 leaves beside the files it keeps for servers
SERVER_FILES_SPARE = 8 << 30


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
    requests must give phase 9's and phase 7's images to the bit.  The
    files stay for the later phases' servers (``SERVER_MODELS_DIR``)
    while the disk keeps 8 GiB beside them: (report, requests, their
    directory or None)."""
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
    kept = []
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
        if shutil.disk_usage(models_dir).free < SERVER_FILES_SPARE:
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
        kept = sorted(os.listdir(models_dir))
        if shutil.disk_usage(models_dir).free < SERVER_FILES_SPARE:
            kept = []
    finally:
        if not kept:
            shutil.rmtree(models_dir, ignore_errors=True)
    report["equal_to_virtual"] = True
    report["kept_for_servers"] = kept
    return report, requests, models_dir if kept else None


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


# --- phase 19: the default dispatch model ------------------------------------

# phase 19's own server keeps the reuse plane on (every other phase's
# servers start with it off, RECOMPUTE_ENV); its master hedges nothing,
# as phase 8's, so step 5b's worker refines exactly its part of the
# tiles (a cold worker's share would otherwise be hedged on the master)
PHASE19_ENV = {"DTPU_CACHE": "1"}
PHASE19_MIN_FREE = 60_000_000_000
# the coalesced burst: k plain SDXL txt2img prompts behind one occupier
PHASE19_BURST = 4
PHASE19_SEEDS = (1001, 1002, 1003, 1004)
# the tile tier's one changed tile (row 1, column 1 of the 4 x 4 grid)
PHASE19_DIRTY_TILES = [5]
# a CPU rehearsal launches no kernel: it sets this False to skip the
# checks of the changed run's batch
PHASE19_CHECK_BATCHES = True
# /history polls while a run goes on: each answer is JSON the handler
# thread encodes, holding the GIL the execution thread's host-bound
# sampler needs, so the phase polls at 0.1 s (the replay at 1 ms) and
# times the runs by their /history timestamps
PHASE19_POLL_S = 0.1


def phase19_tile_geometry(doc):
    """(source size, output size, tile size, padding, the changed source
    box) of the tile tier's upscale: a source a quarter of node 16's
    size (a 4x lanczos upscale, as the RRDB's), and a box inside tile 5's
    core more than the padding and lanczos' 3-pixel reach (both in
    source pixels) away from every other tile's window, so only tile 5's
    window moves."""
    out = int(doc["16"]["inputs"]["width"])
    tile = int(doc["2"]["inputs"]["tile_width"])
    pad = int(doc["2"]["inputs"]["padding"])
    src, t = out // 4, tile // 4
    margin = -(-pad // 4) + 3 + 2
    return src, out, tile, pad, (t + margin, 2 * t - margin)


def plain_txt2img(doc, seed, text=None, save=True):
    """``distributed-txt2img.json`` as a plain graph: DistributedSeed and
    DistributedCollector taken out, the seed a KSampler widget, SaveImage
    (or PreviewImage) on the decode; ``text``: another positive prompt
    (another coalescing signature, the same shapes)."""
    out = {}
    for nid, node in copy.deepcopy(doc).items():
        if not isinstance(node, dict):
            out[nid] = node
        elif node["class_type"] not in ("DistributedSeed",
                                        "DistributedCollector"):
            out[nid] = node
    ks = next(n for n in out.values() if isinstance(n, dict)
              and n["class_type"] == "KSampler")
    ks["inputs"]["seed"] = int(seed)
    dec = next(nid for nid, n in out.items() if isinstance(n, dict)
               and n["class_type"] == "VAEDecode")
    for n in out.values():
        if isinstance(n, dict) and n["class_type"] in ("PreviewImage",
                                                       "SaveImage"):
            n["class_type"] = "SaveImage" if save else "PreviewImage"
            n["inputs"] = {"images": [dec, 0]}
    if text is not None:
        pos = ks["inputs"]["positive"][0]
        out[pos]["inputs"]["text"] = text
    return out


def tile_tier_doc(doc, image_name):
    """``distributed-upscale.json`` with its ImageScale reading the
    source directly, the RRDB taken out (its receptive field spans the
    whole 512^2 source, so any change there would move every tile), and
    SaveImage; the SD1.5 tiled upscaler as the workflow has it."""
    out = with_save_image(doc)
    src = next(nid for nid, n in out.items() if isinstance(n, dict)
               and n["class_type"] == "LoadImage")
    out[src]["inputs"]["image"] = image_name
    for nid in [nid for nid, n in out.items() if isinstance(n, dict)
                and n["class_type"] in ("UpscaleModelLoader",
                                        "ImageUpscaleWithModel")]:
        del out[nid]
    scale = next(n for n in out.values() if isinstance(n, dict)
                 and n["class_type"] == "ImageScale")
    scale["inputs"]["image"] = [src, 0]
    return out


def sse_events(url, pid, timeout=FANOUT_REQUEST_S):
    """The events of ``/distributed/preview/<pid>`` until the stream
    ends: [(event, data)]."""
    import urllib.request
    events = []
    with urllib.request.urlopen(f"{url}/distributed/preview/{pid}",
                                timeout=timeout) as r:
        for block in r.read().decode().split("\n\n"):
            fields = dict(ln.split(": ", 1) for ln in block.splitlines()
                          if ln and not ln.startswith(":"))
            if "event" in fields:
                events.append((fields["event"], json.loads(fields["data"])))
    return events


def phase19_in_process(doc, cache, input_dir=None):
    """One in-process run of ``doc`` with the reuse plane on or off ->
    its image [H, W, 3]."""
    import torch

    from comfyui_distributed_tpu_torch.ops.base import OpContext
    from comfyui_distributed_tpu_torch.workflow import WorkflowExecutor
    prev = os.environ.get("DTPU_CACHE")
    os.environ["DTPU_CACHE"] = "1" if cache else "0"
    try:
        res = WorkflowExecutor(OpContext(
            device=DEVICE, input_dir=input_dir)).execute(copy.deepcopy(doc))
    finally:
        if prev is None:
            os.environ.pop("DTPU_CACHE", None)
        else:
            os.environ["DTPU_CACHE"] = prev
    torch.cuda.synchronize()
    return res.image_batch[0]


def phase19_sources(doc):
    """The tile tier's two sources: a smooth image (the upscale's tiles
    must differ) and the same with one tile's region changed."""
    import numpy as np
    size, _, _, _, (lo, hi) = phase19_tile_geometry(doc)
    yy, xx = np.mgrid[0:size, 0:size].astype(np.float32) / size
    src = np.stack([0.5 + 0.4 * np.sin(6.0 * xx + 2.0 * yy),
                    0.5 + 0.4 * np.cos(5.0 * yy - 3.0 * xx),
                    0.3 + 0.6 * xx * yy], -1).astype(np.float32)
    changed = src.copy()
    changed[lo:hi, lo:hi] = np.random.default_rng(19).uniform(
        size=(hi - lo, hi - lo, 3))
    return src, changed


PHASE19_ENCODE_SEED = 1006


def phase19_sdxl_references(docs):
    """Phase 19's in-process SDXL references, run while phase 5 has the
    pipeline warm: the burst's seeds one at a time (the plane on) and
    the encode tier's seed with ``DTPU_CACHE=0``."""
    txt = docs["txt2img"]
    refs, seconds = {}, []
    for s in PHASE19_SEEDS:
        t0 = time.perf_counter()
        refs[s] = phase19_in_process(plain_txt2img(txt, s, save=False),
                                     True)
        seconds.append(time.perf_counter() - t0)
    refs["encode"] = phase19_in_process(
        plain_txt2img(txt, PHASE19_ENCODE_SEED, save=False), False)
    # phase 20's euler_ancestral pair (its euler prompts reuse the
    # seeds above)
    for s in PHASE20_ANCESTRAL_SEEDS:
        refs[s] = phase19_in_process(with_sampler(plain_txt2img(
            txt, s, save=False), "euler_ancestral"), False)
    return refs, seconds


def phase19_tile_reference(docs):
    """Phase 19's in-process tile-tier reference, run while phase 7 has
    the SD1.5 pipeline warm: the changed source's upscale with
    ``DTPU_CACHE=0`` (every tile refined in one batch)."""
    from comfyui_distributed_tpu_torch.utils.image import save_png
    _, changed = phase19_sources(docs["upscale"])
    with tempfile.TemporaryDirectory() as d:
        save_png(os.path.join(d, "tile_b.png"), changed)
        return phase19_in_process(tile_tier_doc(docs["upscale"],
                                                "tile_b.png"), False,
                                  input_dir=d)


def default_dispatch(docs, rows, refs):
    """Phase 19: the JAX package's default dispatch model through ``cli
    serve`` (SDXL at 1024^2 at full width and depth, virtual weights;
    a ``cli worker`` enabled only for the fan-out's tile tier): warmup,
    a coalesced burst, the three reuse tiers, the tile tier on the
    fan-out, the preview route and the surfaces.  ``refs``: the in-process images
    (``phase19_sdxl_references``' and, under ``"tiles"``,
    ``phase19_tile_reference``'s) and seconds.  Returns the report and
    the launches of its server's prompt lines."""
    import gc
    import socket

    import numpy as np
    import torch

    from comfyui_distributed_tpu_torch.models import registry
    from comfyui_distributed_tpu_torch.ops import tiling
    from comfyui_distributed_tpu_torch.utils.image import (
        decode_png,
        save_png,
    )
    from comfyui_distributed_tpu_torch.utils.net import get_json, post_json

    checked = {(r["B"], r["N"], r["M"], r["H"], r["D"], r["dtype"])
               for r in rows if not r.get("named")}
    txt = docs["txt2img"]
    base_text = next(n["inputs"]["text"] for n in txt.values()
                     if isinstance(n, dict)
                     and n["class_type"] == "CLIPTextEncode")
    report = {"card": card_line()}
    serial_refs, encode_ref = refs["sdxl"], refs["sdxl"]["encode"]
    serial_s = refs["serial_s"]
    encode_seed = PHASE19_ENCODE_SEED
    registry.clear_pipeline_cache()
    gc.collect()
    torch.cuda.empty_cache()
    free, _ = torch.cuda.mem_get_info()
    if free < PHASE19_MIN_FREE:
        fail(f"phase 19 needs {PHASE19_MIN_FREE} bytes free, {free} are")
    launches = {"variants": collections.Counter(),
                "shapes": collections.Counter()}
    _, out_size, tile, pad, _ = phase19_tile_geometry(docs["upscale"])
    src, changed = phase19_sources(docs["upscale"])
    with tempfile.TemporaryDirectory() as root:
        cluster = Cluster(root, {"serve": ("serve", {**PHASE19_ENV,
                                                     "DTPU_HEDGE": "0"}),
                                 "worker": ("worker", PHASE19_ENV)})
        url = cluster.url("serve")
        for role in cluster.roles:
            for name, img in (("tile_a.png", src), ("tile_b.png", changed),
                              ("tile_c.png", np.ascontiguousarray(
                                  src[::-1]))):
                save_png(os.path.join(cluster.dirs[role], "input", name),
                         img)
        out_dir = os.path.join(cluster.dirs["serve"], "output")

        def post(doc, client="chip_smoke"):
            return post_json(url + "/prompt", {"prompt": doc,
                                               "client_id": client})[
                "prompt_id"]

        def history(pids, poll_s=PHASE19_POLL_S):
            deadline = time.time() + FANOUT_REQUEST_S
            while True:
                hist = get_json(url + "/history")
                if all(p in hist for p in pids):
                    return {p: hist[p] for p in pids}
                if time.time() > deadline:
                    cluster.fail(f"phase 19: no history for {pids}")
                time.sleep(poll_s)

        def counters():
            return get_json(url + "/distributed/metrics")["pipeline"][
                "counters"]

        def lines_of(pids):
            deadline = time.time() + FANOUT_REQUEST_S
            while True:
                got = {ln["prompt_id"]: ln
                       for ln in cluster.prompt_lines("serve")
                       if ln["prompt_id"] in pids}
                if len(got) == len(pids):
                    return got
                if time.time() > deadline:
                    cluster.fail(f"phase 19: no prompt line for {pids}")
                time.sleep(0.05)

        def files_since(before):
            return sorted(set(os.listdir(out_dir)) - before) \
                if os.path.isdir(out_dir) else []

        def outputs():
            return set(os.listdir(out_dir)) if os.path.isdir(out_dir) \
                else set()

        try:
            t0 = time.perf_counter()
            cluster.start()
            report["server_start_s"] = time.perf_counter() - t0
            # 1. warmup
            t0 = time.perf_counter()
            # the request's own shape: its latent size and sampler
            lat = next(n["inputs"] for n in txt.values()
                       if isinstance(n, dict)
                       and n["class_type"] == "EmptyLatentImage")
            ks = next(n["inputs"] for n in txt.values()
                      if isinstance(n, dict)
                      and n["class_type"] == "KSampler")
            body = post_json(url + "/distributed/warmup", {
                "ckpt_name": txt["4"]["inputs"]["ckpt_name"],
                "width": lat["width"], "height": lat["height"], "batch": 1,
                **{k: ks[k] for k in ("steps", "cfg", "sampler_name",
                                      "scheduler")}}, timeout=600)
            report["warmup"] = {"post_s": time.perf_counter() - t0,
                                "timings": body["timings"]}
            if set(body["timings"]) != {"clip_s", "sample_s", "vae_s",
                                        "total_s"}:
                cluster.fail(f"phase 19: warmup answered {body}")
            t0 = time.perf_counter()
            first = post(plain_txt2img(txt, 1000))
            h = history([first])[first]
            report["first_request_s"] = {
                "post_to_history": time.perf_counter() - t0,
                "run": h["finished_at"] - h["started_at"]}
            # 2. coalescing: an occupier (another signature), the burst
            # of 4 behind it, and a queued prompt whose preview client
            # leaves (another signature again)
            c0 = counters()
            before = outputs()
            occupier = post(plain_txt2img(txt, 1000,
                                          text=base_text + ", occupier"))
            deadline = time.time() + FANOUT_REQUEST_S
            while counters().get("exec_runs", 0) \
                    <= c0.get("exec_runs", 0):
                if time.time() > deadline:
                    cluster.fail("phase 19: the occupier never started")
                time.sleep(0.02)
            burst = [post(plain_txt2img(txt, s)) for s in PHASE19_SEEDS]
            victim = post(plain_txt2img(txt, 1007, text=base_text
                                        + ", abandoned", save=False))
            watched = {}
            watcher = threading.Thread(
                target=lambda: watched.update(
                    events=sse_events(url, burst[0])), daemon=True)
            watcher.start()
            with socket.create_connection(("127.0.0.1",
                                           cluster.ports["serve"]),
                                          timeout=30) as sock:
                sock.sendall(f"GET /distributed/preview/{victim} "
                             f"HTTP/1.1\r\nHost: x\r\n\r\n".encode())
                head = sock.recv(4096)
            if b" 200 " not in head.split(b"\r\n", 1)[0]:
                cluster.fail(f"phase 19: preview answered {head[:80]!r}")
            hist = history([occupier, *burst, victim])
            watcher.join(FANOUT_REQUEST_S)
            c1 = counters()
            group = [hist[p] for p in burst]
            if any(h.get("status") != "success"
                   or h.get("coalesced") != PHASE19_BURST for h in group):
                cluster.fail(f"phase 19: the burst's history {group}")
            if c1.get("coalesced_batches", 0) \
                    - c0.get("coalesced_batches", 0) != 1:
                cluster.fail("phase 19: coalesced_batches did not rise "
                             "by 1")
            if hist[victim]["status"] != "abandoned" \
                    or c1.get("exec_runs", 0) - c0.get("exec_runs", 0) != 2:
                cluster.fail(f"phase 19: the abandoned prompt "
                             f"{hist[victim]}, exec runs "
                             f"{c1.get('exec_runs', 0) - c0.get('exec_runs', 0)}")
            ev = watched.get("events") or []
            if not ev or ev[-1][0] != "done" \
                    or ev[-1][1].get("status") not in ("ok", "success"):
                cluster.fail(f"phase 19: the running prompt's stream "
                             f"{ev[-3:]}")
            lines = lines_of([first, occupier, *burst, victim])
            if lines[victim]["launches"].get("sm90", 0) != 0:
                cluster.fail("phase 19: the abandoned prompt launched")
            # each saved PNG: its own seed, its serial run's image
            files = files_since(before)
            if len(files) != 1 + PHASE19_BURST:
                cluster.fail(f"phase 19: {len(files)} files saved")
            by_seed = {}
            for f in files:
                path = os.path.join(out_dir, f)
                prompt = json.loads(dict(png_text_chunks(path))["prompt"])
                seed = next(n["inputs"]["seed"] for n in prompt.values()
                            if n["class_type"] == "KSampler")
                by_seed.setdefault(seed, []).append(path)
            if sorted(by_seed) != sorted((1000, *PHASE19_SEEDS)) \
                    or any(len(v) != 1 for v in by_seed.values()):
                cluster.fail(f"phase 19: the PNGs' seeds {by_seed}")
            diffs = {}
            for s in PHASE19_SEEDS:
                diffs[s] = image_diff(by_seed[s][0], serial_refs[s])
                lim = FANOUT_ATOL["one_batch"]
                if diffs[s][0] > lim[0] or diffs[s][1] > lim[1]:
                    cluster.fail(f"phase 19: seed {s}'s coalesced image "
                                 f"differs {diffs[s]} from its serial run")
            t_group = max(h["finished_at"] for h in group) \
                - group[0]["started_at"]
            serial_server = [hist[occupier]["finished_at"]
                             - hist[occupier]["started_at"]]
            report["coalesce"] = {
                "group_s": t_group,
                "coalesced_s_per_image": t_group / PHASE19_BURST,
                "serial_s_per_image_server": serial_server,
                "serial_s_per_image_in_process": serial_s,
                "max_mean_diff": {str(s): d for s, d in diffs.items()},
                "head_launches": lines[burst[0]]["launches"],
                "node_seconds": {
                    "serial": lines[occupier].get("node_seconds"),
                    "group": lines[burst[0]].get("node_seconds")},
                "max_memory_allocated": lines[burst[0]][
                    "max_memory_allocated"]}
            # 3. the result tier: a PreviewImage graph twice
            replay_doc = plain_txt2img(txt, 1005, save=False)
            r1 = post(replay_doc)
            history([r1])
            t0 = time.perf_counter()
            r2 = post(replay_doc)
            entry = history([r2], poll_s=0.001)[r2]
            replay_s = time.perf_counter() - t0
            if set(entry) != {"status", "images", "duration_s",
                              "cache_hit", "finished_at"} \
                    or entry["cache_hit"] is not True \
                    or entry["status"] != "success" or entry["images"] != 1:
                cluster.fail(f"phase 19: the replay's history {entry}")
            root_attrs = next(
                s["attrs"] for s in get_json(
                    f"{url}/distributed/trace/{r2}")["spans"]
                if s["name"] == "job")
            if root_attrs.get("cache_hit") is not True:
                cluster.fail(f"phase 19: the replay's span {root_attrs}")
            report["replay_s"] = replay_s
            # 4. the encode tier: the same text, a new seed
            before = outputs()
            e1 = post(plain_txt2img(txt, encode_seed))
            history([e1])
            enc = [s for s in get_json(
                f"{url}/distributed/trace/{e1}")["spans"]
                if s["name"] == "CLIPTextEncode"]
            if len(enc) != 2 or not all(s["attrs"].get("cache_hit")
                                        for s in enc):
                cluster.fail(f"phase 19: the encode spans "
                             f"{[s['attrs'] for s in enc]}")
            (png,) = files_since(before)
            enc_diff = image_diff(os.path.join(out_dir, png), encode_ref)
            if enc_diff != (0.0, 0.0):
                cluster.fail(f"phase 19: the memoised encode's image "
                             f"differs {enc_diff} from DTPU_CACHE=0's")
            # 5. the tile tier: one source twice, then one tile changed
            tiles_before = counters().get("tiles_skipped", 0)
            before = outputs()
            up_a = tile_tier_doc(docs["upscale"], "tile_a.png")
            u1 = post(up_a)
            history([u1])
            u2 = post(copy.deepcopy(up_a))
            history([u2])
            skipped = counters().get("tiles_skipped", 0) - tiles_before
            u3 = post(tile_tier_doc(docs["upscale"], "tile_b.png"))
            history([u3])
            skipped_all = counters().get("tiles_skipped", 0) - tiles_before
            up_lines = lines_of([u1, u2, u3])
            saved = files_since(before)
            if len(saved) != 3:
                cluster.fail(f"phase 19: {len(saved)} upscale files")
            pngs = {}
            for pid, f in zip((u1, u2, u3), saved):
                with open(os.path.join(out_dir, f), "rb") as fh:
                    pngs[pid] = decode_png(fh.read())[0]
            n_tiles = len(tiling.calculate_tiles(out_size, out_size, tile,
                                                 tile))
            if skipped != n_tiles or not np.array_equal(pngs[u1], pngs[u2]):
                cluster.fail(f"phase 19: the re-run skipped {skipped} "
                             f"tiles; equal "
                             f"{np.array_equal(pngs[u1], pngs[u2])}")
            if skipped_all - skipped != n_tiles - len(PHASE19_DIRTY_TILES):
                cluster.fail(f"phase 19: the changed source skipped "
                             f"{skipped_all - skipped} tiles")
            dirty_b = sorted({s[0] for s in up_lines[u3][
                "launches_by_shape"]})
            if PHASE19_CHECK_BATCHES and (
                    dirty_b != [2 * len(PHASE19_DIRTY_TILES)]
                    or up_lines[u2]["launches"].get("sm90", 0) != 0):
                cluster.fail(f"phase 19: the changed run's batches "
                             f"{dirty_b}, the re-run's launches "
                             f"{up_lines[u2]['launches']}")
            # 5b. the tile tier on the fan-out: a fresh source split
            # with the worker, then its re-run from the tile tier
            post_json(url + "/distributed/config/update_worker",
                      {"id": "w0", "name": "w0",
                       "port": cluster.ports["worker"], "enabled": True})
            before = outputs()
            up_c = tile_tier_doc(docs["upscale"], "tile_c.png")
            fan = {}
            for run in ("cold", "rerun"):
                m0 = get_json(url + "/distributed/metrics")
                t0 = time.perf_counter()
                resp = post_json(url + "/prompt",
                                 {"prompt": copy.deepcopy(up_c),
                                  "client_id": "chip_smoke"})
                if resp.get("workers") != ["w0"]:
                    cluster.fail(f"phase 19: the fan-out upscale did not "
                                 f"fan out: {resp}")
                pid = resp["prompt_id"]
                entry = history([pid])[pid]
                seconds = time.perf_counter() - t0
                m1 = get_json(url + "/distributed/metrics")
                if entry.get("status") != "success":
                    cluster.fail(f"phase 19: the fan-out upscale's "
                                 f"{run} history {entry}")
                fan[run] = {
                    "pid": pid, "seconds": seconds,
                    "tiles_skipped": m1["pipeline"]["counters"].get(
                        "tiles_skipped", 0) - m0["pipeline"]["counters"].get(
                        "tiles_skipped", 0),
                    "tiles_received": m1["tiles_received"]
                    - m0["tiles_received"]}
            fan_lines = lines_of([fan["cold"]["pid"], fan["rerun"]["pid"]])
            saved = files_since(before)
            if len(saved) != 2:
                cluster.fail(f"phase 19: {len(saved)} fan-out files")
            fan_pngs = []
            for f in saved:
                with open(os.path.join(out_dir, f), "rb") as fh:
                    fan_pngs.append(decode_png(fh.read())[0])
            worker_part = len(tiling.partition_tiles(n_tiles, 1)[1])
            if fan["cold"]["tiles_skipped"] != 0 \
                    or fan["cold"]["tiles_received"] != worker_part \
                    or fan["rerun"]["tiles_skipped"] != n_tiles \
                    or not np.array_equal(fan_pngs[0], fan_pngs[1]) \
                    or np.array_equal(fan_pngs[0], pngs[u1]):
                cluster.fail(f"phase 19: the fan-out's tile tier {fan}, "
                             f"equal "
                             f"{np.array_equal(fan_pngs[0], fan_pngs[1])}")
            if PHASE19_CHECK_BATCHES and fan_lines[fan["rerun"]["pid"]][
                    "launches"].get("sm90", 0) != 0:
                cluster.fail(f"phase 19: the fan-out re-run's master "
                             f"launched {fan_lines[fan['rerun']['pid']]}")
            # 6. surfaces
            import contextlib
            import io

            from comfyui_distributed_tpu_torch import cli
            out = io.StringIO()
            with contextlib.redirect_stdout(out):
                rc = cli.main(["reuse", "--url", url])
            tiers = {ln.split()[0]: int(ln.split()[1])
                     for ln in out.getvalue().splitlines()
                     if ln.split()[:1] in (["result"], ["embed"], ["tile"])}
            if rc != 0 or len(tiers) != 3 or not all(tiers.values()):
                cluster.fail(f"phase 19: cli reuse: {out.getvalue()}")
            m = get_json(url + "/distributed/metrics")
            if m["pipeline"].get("overlap") is not True \
                    or m["pipeline"].get("coalesce") is not True \
                    or "reuse" not in m:
                cluster.fail(f"phase 19: metrics pipeline "
                             f"{m['pipeline'].get('overlap')} "
                             f"{m['pipeline'].get('coalesce')}")
            prom = urllib_text(url + "/distributed/metrics.prom")
            fams = [f for f in ("dtpu_cache_hits_total",
                                "dtpu_cache_misses_total",
                                "dtpu_cache_evictions_total",
                                "dtpu_cache_bytes",
                                "dtpu_cache_replays_total",
                                "dtpu_cache_tiles_skipped_total",
                                "dtpu_preview_clients",
                                "dtpu_preview_events_total",
                                "dtpu_jobs_abandoned_total")
                    if f"# TYPE {f} " not in prom]
            if fams:
                cluster.fail(f"phase 19: metrics.prom lacks {fams}")
            parse_prom(prom, "phase 19 metrics.prom")
            cleared = post_json(url + "/distributed/clear_memory", {})
            if not cleared.get("cache_freed_bytes", 0) > 0:
                cluster.fail(f"phase 19: clear_memory {cleared}")
            report["reuse"] = {"tiers": tiers,
                               "snapshot": m["reuse"],
                               "cache_freed_bytes":
                                   cleared["cache_freed_bytes"],
                               "freed_bytes": cleared["freed_bytes"]}
            all_lines = lines_of([first, occupier, *burst, victim, r1, e1,
                                  u1, u2, u3, fan["cold"]["pid"],
                                  fan["rerun"]["pid"]])
            # the worker's two shares: the re-run's line follows its
            # uploads' retries against the finished job
            deadline = time.time() + FANOUT_REQUEST_S
            while len(cluster.prompt_lines("worker")) < 2:
                if time.time() > deadline:
                    cluster.fail("phase 19: the worker's shares left no "
                                 "prompt line")
                time.sleep(0.1)
            worker_lines = cluster.prompt_lines("worker")
        finally:
            cluster.stop()
    for ln in [*all_lines.values(), *worker_lines]:
        for v, n in ln["launches"].items():
            if n:
                launches["variants"][v] += n
        for *shape, n in ln["launches_by_shape"]:
            launches["shapes"][tuple(shape)] += n
    if set(launches["variants"]) - {"sm90"}:
        fail(f"phase 19: launched {dict(launches['variants'])}")
    unchecked = [s for s in launches["shapes"] if s not in checked]
    if unchecked:
        fail(f"phase 19: shapes phase 3 did not check: {unchecked}")
    # the changed source in process with the plane off: the clean tiles
    # to the bit, the dirty one (refined at B = 2, not 32) within the
    # one-batch limits
    from comfyui_distributed_tpu_torch.utils.image import to_uint8
    want = to_uint8(refs["tiles"]).astype(np.float32) / 255.0
    got = pngs[u3]
    tiles = tiling.calculate_tiles(out_size, out_size, tile, tile)
    outside = np.ones(got.shape[:2], bool)
    for i in PHASE19_DIRTY_TILES:
        x1, y1, x2, y2 = tiling.extraction_region(
            *tiles[i], tile, tile, pad, out_size, out_size)
        outside[y1:y2, x1:x2] = False
    d = np.abs(got - want)
    tile_diff = {"outside_max": float(d[outside].max()),
                 "inside_max": float(d[~outside].max()),
                 "inside_mean": float(d[~outside].mean()),
                 "equal_to_the_bit": bool(d.max() == 0.0)}
    lim = FANOUT_ATOL["one_batch"]
    if tile_diff["outside_max"] != 0.0 or tile_diff["inside_max"] > lim[0] \
            or tile_diff["inside_mean"] > lim[1]:
        fail(f"phase 19: the changed upscale against DTPU_CACHE=0: "
             f"{tile_diff}")
    report["tiles"] = {"skipped_rerun": skipped,
                       "skipped_changed": skipped_all - skipped,
                       "dirty": PHASE19_DIRTY_TILES,
                       "changed_run_batches": dirty_b,
                       "against_cache_off": tile_diff,
                       "seconds": {k: all_lines[p]["seconds"] for k, p in
                                   (("cold", u1), ("rerun", u2),
                                    ("changed", u3))}}
    report["fanout_tiles"] = {
        run: {k: v for k, v in f.items() if k != "pid"}
        for run, f in fan.items()}
    report["fanout_tiles"]["worker_shares"] = [
        {"status": ln["status"], "seconds": ln["seconds"],
         "launches": ln["launches"]} for ln in worker_lines]
    report["sm90_launches"] = launches["variants"].get("sm90", 0)
    report["peak_memory"] = max(ln["max_memory_allocated"] or 0
                                for ln in all_lines.values())
    report["encode_tier_diff"] = enc_diff
    return report, launches


# --- phase 20: continuous batching -------------------------------------------

# one server for every drill: two slots and one pad (2), so every step
# of a bucket runs at attention batch B = 4 and a parked row's pads are
# its unparked run's; parking armed, the reuse plane off (every request
# recomputed), a preview frame every 5 steps, a deck ring longer than
# the phase's boundaries
PHASE20_ENV = {"DTPU_CB": "1", "DTPU_CB_PARK": "1", "DTPU_CACHE": "0",
               "DTPU_CB_SLOTS": "2", "DTPU_CB_PAD_BUCKETS": "2",
               "DTPU_PREVIEW_EVERY": "5", "DTPU_CB_DECK_RING": "1024"}
PHASE20_MIN_FREE = 40_000_000_000
# the late joiner posts once the first prompt's bucket stepped this often
PHASE20_JOIN_AT = 5
PHASE20_ANCESTRAL_SEEDS = (2001, 2002)
# the preemption drill: two batch-class prompts fill both slots, then a
# paid one (seed 1006: phase 19's encode-tier reference)
PHASE20_BATCH_SEEDS = (1003, 1004)
PHASE20_PAID_SEED = 1006
# the paid prompt posts once the batch bucket stepped this often
PHASE20_PREEMPT_AT = 4
# the sm90 launches of one SDXL step (70 blocks, self and cross)
SM90_PER_STEP = 140
# a CPU rehearsal launches no kernel: it sets this False to skip the
# launch count of each bucket
PHASE20_CHECK_LAUNCHES = True


def with_sampler(doc, name):
    out = copy.deepcopy(doc)
    for n in out.values():
        if isinstance(n, dict) and n["class_type"] == "KSampler":
            n["inputs"]["sampler_name"] = name
    return out


def phase20_noise_draw(reps=10):
    """Host seconds of one boundary's step-noise draw of phase 20's
    euler_ancestral bucket: ``samplers.step_noise_rows`` at its shape (4
    rows of 128 x 128 x 4, two live), ending in a synchronize."""
    import numpy as np
    import torch

    from comfyui_distributed_tpu_torch.models import samplers as smp
    from comfyui_distributed_tpu_torch.models.prng import sample_keys
    x = torch.zeros((4, 128, 128, 4), device=DEVICE)
    keys = sample_keys(np.asarray([2001, 2002, 0, 0], np.uint64),
                       np.zeros(4, np.uint32))
    live = np.asarray([True, True, False, False])
    out = []
    for i in range(reps):
        t0 = time.perf_counter()
        smp.step_noise_rows(keys, np.full(4, i), x, live)
        torch.cuda.synchronize()
        out.append(time.perf_counter() - t0)
    return out


def continuous_batching(docs, rows, refs):
    """Phase 20: continuous batching through ``cli serve`` (SDXL at
    1024^2, 20 steps, full width and depth, ``PHASE20_ENV``): a late
    joiner, a second signature's bucket, a preemption with its park and
    resume, preview frames and ``cli flightdeck``.  A generator
    (:func:`resumed`): its first step launches the server, so that its
    start overlaps phase 19.  ``refs``: phase 19's in-process images by
    seed.  Returns the report and the launches of the server (its
    buckets' and its prompt lines')."""
    import contextlib
    import gc
    import io

    import numpy as np
    import torch

    from comfyui_distributed_tpu_torch import cli
    from comfyui_distributed_tpu_torch.models import registry
    from comfyui_distributed_tpu_torch.utils.image import decode_png
    from comfyui_distributed_tpu_torch.utils.net import get_json, post_json

    checked = {(r["B"], r["N"], r["M"], r["H"], r["D"], r["dtype"])
               for r in rows if not r.get("named")}
    txt = docs["txt2img"]
    report = {"card": card_line()}
    lim = FANOUT_ATOL["one_batch"]
    launches = {"variants": collections.Counter(),
                "shapes": collections.Counter()}
    root = tempfile.mkdtemp(prefix="chip_smoke_phase20_")
    cluster = Cluster(root, {"serve": ("serve", PHASE20_ENV)})
    url = cluster.url("serve")
    out_dir = os.path.join(cluster.dirs["serve"], "output")

    def post(doc, priority=None):
        body = {"prompt": doc, "client_id": "chip_smoke"}
        if priority:
            body["priority"] = priority
        return post_json(url + "/prompt", body)["prompt_id"]

    def history(pids):
        deadline = time.time() + FANOUT_REQUEST_S
        while True:
            hist = get_json(url + "/history")
            if all(p in hist for p in pids):
                return {p: hist[p] for p in pids}
            if time.time() > deadline:
                cluster.fail(f"phase 20: no history for {pids}")
            time.sleep(PHASE19_POLL_S)

    def batching():
        return get_json(url + "/distributed/metrics")["batching"]

    def wait_steps(pred, what):
        deadline = time.time() + FANOUT_REQUEST_S
        while True:
            b = batching()
            if pred(b):
                return b
            if time.time() > deadline:
                cluster.fail(f"phase 20: {what}: {b}")
            time.sleep(0.02)

    def saved_by_seed(before):
        out = {}
        for f in sorted(set(os.listdir(out_dir)) - before):
            path = os.path.join(out_dir, f)
            prompt = json.loads(dict(png_text_chunks(path))["prompt"])
            seed = next(n["inputs"]["seed"] for n in prompt.values()
                        if n["class_type"] == "KSampler")
            out[seed] = path
        return out

    def outputs():
        return set(os.listdir(out_dir)) if os.path.isdir(out_dir) \
            else set()

    def spans(pid):
        return get_json(f"{url}/distributed/trace/{pid}")["spans"]

    def run_s(h):
        return h["finished_at"] - h["started_at"]

    try:
        t0 = time.perf_counter()
        cluster.launch("serve")
        yield
        registry.clear_pipeline_cache()
        gc.collect()
        torch.cuda.empty_cache()
        free, _ = torch.cuda.mem_get_info()
        if free < PHASE20_MIN_FREE:
            cluster.fail(f"phase 20 needs {PHASE20_MIN_FREE} bytes free, "
                         f"{free} are")
        report["noise_draw_s"] = phase20_noise_draw()
        t1 = time.perf_counter()
        cluster.wait_up(["serve"])
        report["server_up_after_launch_s"] = time.perf_counter() - t0
        report["server_wait_s"] = time.perf_counter() - t1
        lat = next(n["inputs"] for n in txt.values()
                   if isinstance(n, dict)
                   and n["class_type"] == "EmptyLatentImage")
        ks = next(n["inputs"] for n in txt.values()
                  if isinstance(n, dict)
                  and n["class_type"] == "KSampler")
        t0 = time.perf_counter()
        body = post_json(url + "/distributed/warmup", {
            "ckpt_name": txt["4"]["inputs"]["ckpt_name"],
            "width": lat["width"], "height": lat["height"], "batch": 1,
            **{k: ks[k] for k in ("steps", "cfg", "sampler_name",
                                  "scheduler")}}, timeout=600)
        report["warmup"] = {"post_s": time.perf_counter() - t0,
                            "timings": body["timings"]}
        # the serial yardstick on this server: dpmpp_2m (one model
        # call a step, as euler) has no extracted step, so it runs
        # on the fallback thread as one dispatch at B = 2
        before = outputs()
        serial = post(with_sampler(plain_txt2img(txt, 1000),
                                   "dpmpp_2m"))
        h_serial = history([serial])[serial]
        b0 = batching()
        if h_serial["status"] != "success" or b0["fallbacks"] != 1 \
                or b0["admits"] != 0:
            cluster.fail(f"phase 20: the fallback {h_serial} {b0}")
        report["serial_s"] = run_s(h_serial)
        # drill 1: a, b joining at step >= 5, previews of a
        a = post(plain_txt2img(txt, PHASE19_SEEDS[0]))
        watched = {}
        watcher = threading.Thread(
            target=lambda: watched.update(events=sse_events(url, a)),
            daemon=True)
        watcher.start()
        b_at = wait_steps(lambda b: any(
            k["steps"] >= PHASE20_JOIN_AT for k in b["buckets"]),
            "a never stepped")
        b = post(plain_txt2img(txt, PHASE19_SEEDS[1]))
        hist = history([a, b])
        watcher.join(FANOUT_REQUEST_S)
        mid = batching()
        if len(mid["buckets"]) != 1 or mid["buckets"][0]["admits"] != 2:
            cluster.fail(f"phase 20: b did not join a's bucket: {mid}")
        joined_at = b_at["buckets"][0]["steps"]
        euler_sig = mid["buckets"][0]["sig"]

        def euler_bucket(snap):
            return next(k for k in snap["buckets"]
                        if k["sig"] == euler_sig)
        b_admit = [s["attrs"] for s in spans(b)
                   if s["name"] == "cb_admit"]
        if [x.get("slot") for x in b_admit] != [1]:
            cluster.fail(f"phase 20: b's cb_admit spans {b_admit}")
        ab = [hist[a], hist[b]]
        report["late_join"] = {
            "joined_after_steps": joined_at,
            "bucket_steps": mid["buckets"][0]["steps"],
            "pair_s": max(h["finished_at"] for h in ab)
            - min(h["started_at"] for h in ab),
            "run_s": [run_s(h) for h in ab]}
        report["late_join"]["s_per_image"] = \
            report["late_join"]["pair_s"] / 2
        # drill 1, second signature: an euler_ancestral pair
        c, d = (post(with_sampler(plain_txt2img(txt, s),
                                  "euler_ancestral"))
                for s in PHASE20_ANCESTRAL_SEEDS)
        hist.update(history([c, d]))
        two = batching()
        if len(two["buckets"]) != 2 \
                or sorted(k["admits"] for k in two["buckets"]) != [2, 2]:
            cluster.fail(f"phase 20: the second bucket {two}")
        cd = [hist[c], hist[d]]
        report["second_bucket_s_per_image"] = (
            max(h["finished_at"] for h in cd)
            - min(h["started_at"] for h in cd)) / 2
        files = saved_by_seed(before)
        diffs = {}
        for seed in (*PHASE19_SEEDS[:2], *PHASE20_ANCESTRAL_SEEDS):
            if seed not in files:
                cluster.fail(f"phase 20: no image of seed {seed}")
            diffs[seed] = image_diff(files[seed], refs[seed])
            if diffs[seed][0] > lim[0] or diffs[seed][1] > lim[1]:
                cluster.fail(f"phase 20: seed {seed}'s image differs "
                             f"{diffs[seed]} from its serial run")
        report["late_join"]["max_mean_diff"] = {
            str(k): v for k, v in diffs.items()}
        # previews: 20 / 5 frames of a, each its latent's PNG
        ev = watched.get("events") or []
        frames = [e for name, e in ev if name == "preview"]
        steps = [e["step"] for e in frames]
        if steps != [5, 10, 15, 20] or ev[-1][0] != "done":
            cluster.fail(f"phase 20: a's preview stream {steps} "
                         f"{[n for n, _ in ev][-3:]}")
        import base64
        pngs = [decode_png(base64.b64decode(e["png_b64"]))[0]
                for e in frames]
        if any(p.shape[:2] != (lat["height"] // 8, lat["width"] // 8)
               for p in pngs) or any(
                np.array_equal(p, q) for p, q in zip(pngs, pngs[1:])):
            cluster.fail(f"phase 20: preview frames "
                         f"{[p.shape for p in pngs]}")
        report["previews"] = {"steps": steps,
                              "shape": list(pngs[0].shape)}
        # drill 2: preemption.  First the victim's unparked run
        # (alone, pad 2), then both batch prompts, then the paid one
        bseed = PHASE20_BATCH_SEEDS
        before = outputs()
        u = post(plain_txt2img(txt, bseed[1]), "batch")
        history([u])
        unparked = saved_by_seed(before)[bseed[1]]
        s0 = batching()
        before = outputs()
        # b2 is admitted after b1: the younger, so the one parked
        b1 = post(plain_txt2img(txt, bseed[0]), "batch")
        wait_steps(lambda b: b["admits"] == s0["admits"] + 1,
                   "b1 never admitted")
        b2 = post(plain_txt2img(txt, bseed[1]), "batch")
        steps0 = euler_bucket(s0)["steps"]
        wait_steps(lambda b: b["slots_active"] == 2
                   and b["admits"] == s0["admits"] + 2
                   and euler_bucket(b)["steps"] >= steps0
                   + PHASE20_PREEMPT_AT, "the batch pair never ran")
        w_paid = time.time()
        paid = post(plain_txt2img(txt, PHASE20_PAID_SEED), "paid")
        parked_seen = 0
        deadline = time.time() + FANOUT_REQUEST_S
        while True:
            snap = batching()
            parked_seen = max(parked_seen, snap["parked"])
            hist_now = get_json(url + "/history")
            if all(p in hist_now for p in (b1, b2, paid)):
                break
            if time.time() > deadline:
                cluster.fail("phase 20: the preemption drill never "
                             "finished")
            time.sleep(0.05)
        hist = history([b1, b2, paid])
        s1 = batching()
        moved = {k: s1[k] - s0[k] for k in ("parks", "preemptions",
                                            "resumes", "retires")}
        if moved != {"parks": 1, "preemptions": 1, "resumes": 1,
                     "retires": 3} or parked_seen != 1 \
                or s1["parked"] != 0 \
                or any(hist[p]["status"] != "success"
                       for p in (b1, b2, paid)) \
                or not hist[paid]["finished_at"] \
                < hist[b2]["finished_at"]:
            cluster.fail(f"phase 20: preemption {moved}, parked seen "
                         f"{parked_seen}, {hist}")
        park = [x for x in spans(b2) if x["name"] == "cb_park"]
        resume = [x for x in spans(b2) if x["name"] == "cb_resume"]
        if len(park) != 1 or len(resume) != 1 \
                or park[0]["attrs"].get("preempted_by") != "paid":
            cluster.fail(f"phase 20: b2's park spans {park} {resume}")
        files = saved_by_seed(before)
        pre_diffs = {}
        for seed, ref in ((bseed[0], refs[bseed[0]]),
                          (bseed[1], refs[bseed[1]]),
                          (PHASE20_PAID_SEED, refs["encode"])):
            pre_diffs[seed] = image_diff(files[seed], ref)
            if pre_diffs[seed][0] > lim[0] \
                    or pre_diffs[seed][1] > lim[1]:
                cluster.fail(f"phase 20: seed {seed}'s image differs "
                             f"{pre_diffs[seed]} from its serial run")
        with open(unparked, "rb") as f:
            want = decode_png(f.read())[0]
        with open(files[bseed[1]], "rb") as f:
            got = decode_png(f.read())[0]
        stages = get_json(url + "/distributed/metrics")["pipeline"][
            "stages"]
        report["preemption"] = {
            "parked_at_step": park[0]["attrs"].get("step"),
            "parked_s": resume[0]["start_s"] - park[0]["start_s"],
            "paid_post_to_done_s": hist[paid]["finished_at"] - w_paid,
            "paid_run_s": run_s(hist[paid]),
            "batch_run_s": [run_s(hist[b1]), run_s(hist[b2])],
            "park_op_s": stages.get("cb_park", {}).get("total_s"),
            "resume_op_s": stages.get("cb_resume", {}).get("total_s"),
            "max_mean_diff": {str(k): v for k, v in pre_diffs.items()},
            "resumed_vs_unparked_max": float(np.abs(got - want).max()),
            "resumed_equals_unparked": bool(np.array_equal(got, want))}
        # the flight deck against the drills
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            rc = cli.main(["flightdeck", "--url", url, "--json"])
        deck = json.loads(out.getvalue())
        rows_ = deck["deck"]
        total_steps = sum(k["steps"] for k in deck["buckets"])
        sums = {k: sum(r[k] for r in rows_)
                for k in ("admits", "retires", "preemptions")}
        if rc != 0 or len(rows_) != total_steps \
                or sums != {"admits": deck["admits"],
                            "retires": deck["retires"],
                            "preemptions": 1} \
                or deck["admits"] != 8 or deck["retires"] != 8:
            cluster.fail(f"phase 20: flightdeck {len(rows_)} rows, "
                         f"{total_steps} steps, sums {sums}, admits "
                         f"{deck['admits']}, retires {deck['retires']}")
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            cli.main(["flightdeck", "--url", url, "--last", "4"])
        print(out.getvalue(), flush=True)
        report["flightdeck"] = {
            "boundaries": len(rows_), **sums,
            "admit_to_first_step": deck["admit_to_first_step"]}
        # every step launched sm90 140 times, at shapes phase 3 checked
        for k in deck["buckets"]:
            if PHASE20_CHECK_LAUNCHES and k["launches"] != {
                    "sm90": SM90_PER_STEP * k["steps"]}:
                cluster.fail(f"phase 20: bucket {k['sig']} launched "
                             f"{k['launches']} in {k['steps']} steps")
            for *shape, n in k["launches_by_shape"]:
                launches["shapes"][tuple(shape)] += n
            launches["variants"]["sm90"] += k["launches"].get("sm90", 0)
        report["buckets"] = [{x: k[x] for x in (
            "sig", "admits", "retires", "steps", "retraces",
            "pad_transitions", "launches")} for k in deck["buckets"]]
        report["late_join"]["sm90"] = deck["buckets"][0]["launches"]
        for ln in cluster.prompt_lines("serve"):
            for v, n in ln["launches"].items():
                if n:
                    launches["variants"][v] += n
            for *shape, n in ln["launches_by_shape"]:
                launches["shapes"][tuple(shape)] += n
    finally:
        cluster.stop()
        shutil.rmtree(root, True)
    if report["late_join"]["bucket_steps"] >= 40:
        fail(f"phase 20: a and b took {report['late_join']['bucket_steps']} "
             f"boundaries: b did not share a's steps")
    if set(launches["variants"]) - {"sm90"}:
        fail(f"phase 20: launched {dict(launches['variants'])}")
    unchecked = [s for s in launches["shapes"] if s not in checked]
    if unchecked:
        fail(f"phase 20: shapes phase 3 did not check: {unchecked}")
    report["sm90_launches"] = launches["variants"].get("sm90", 0)
    return report, launches


# phase 21: the elastic fleet.  One cli serve master on SDXL with no
# workers and DTPU_AUTOSCALE=1 at a short tempo (two 0.5 s samples over
# 2 prompts a participant scale up, two under 0.5 scale down, 3 s
# cooldown, at most one worker: one SDXL worker beside its master bounds
# the card's memory); the reuse plane and coalescing off, so each prompt
# is its own dispatch and the queue depth is the burst's; the hedge off,
# so the worker's share is its own work.  The chaos spec faults only the
# worker's uploads (/prompt and the heartbeats stay clean); its seed
# makes the first upload a 503, then a corrupted payload (a 500), then a
# delivery (the first six uploads land within the sender's 5 attempts).
# The resource monitor samples every second (5 s by default), so the
# utilization the scale-down also needs under its bar reads an idle card
# a second after the last compute ends.
PHASE21_CHAOS = {"http_5xx_pct": 50, "corrupt_pct": 50,
                 "routes": ["/distributed/job_complete"], "seed": 55}
PHASE21_ENV = {"DTPU_CACHE": "0", "DTPU_COALESCE": "0", "DTPU_HEDGE": "0",
               "DTPU_AUTOSCALE": "1", "DTPU_AUTOSCALE_INTERVAL_S": "0.5",
               "DTPU_AUTOSCALE_WINDOW": "2", "DTPU_AUTOSCALE_UP_QUEUE": "2",
               "DTPU_AUTOSCALE_DOWN_QUEUE": "0.5",
               "DTPU_AUTOSCALE_COOLDOWN_S": "3", "DTPU_AUTOSCALE_MIN": "0",
               "DTPU_AUTOSCALE_MAX": "1", "DTPU_RES_INTERVAL_S": "1",
               "DTPU_CHAOS": json.dumps(PHASE21_CHAOS)}
PHASE21_BURST = 8
# the burst's seeds: SEEDS[0] + 1 .. + 8 (the first is phase 8's worker
# share image); the prompt after the worker is ready: SEEDS[0] (phase
# 8's two share images, the master's and the worker's)
PHASE21_MIN_FREE = 40_000_000_000
PHASE21_POLL_S = 0.075
# a CPU rehearsal sets this False to skip the launch counts
PHASE21_CHECK_LAUNCHES = True


def elastic_fleet(docs, txt_refs, rows):
    """Phase 21: the elastic fleet on one card: one ``cli serve`` master
    with ``PHASE21_ENV`` and no workers, in a directory of its own
    (``spawn/``: its managed workers' logs and default directories), the
    package on ``PYTHONPATH`` for the workers it launches.  A generator
    (:func:`resumed`): its first step launches the master, so that its
    start overlaps phase 20.  A burst of ``PHASE21_BURST`` txt2img
    prompts (full SDXL, 20 steps) at distinct seeds; the autoscaler
    scales up once and spawns an ``auto_*`` worker on the card; once the
    worker is ready a txt2img prompt fans out to it (its upload faulted
    by the chaos spec, retried to success); once the queue empties the
    worker is retired, drained clean and forgotten.  ``txt_refs``: phase
    8's in-process images at SEEDS[0] and SEEDS[0] + 1; ``rows``: phase
    3's checks.  Returns the report and the servers' launches."""
    import contextlib
    import gc
    import io

    import torch

    from comfyui_distributed_tpu_torch import cli
    from comfyui_distributed_tpu_torch.models import registry
    from comfyui_distributed_tpu_torch.utils.net import get_json, post_json

    checked = {(r["B"], r["N"], r["M"], r["H"], r["D"], r["dtype"])
               for r in rows if not r.get("named")}
    root = tempfile.mkdtemp(prefix="chip_smoke_phase21_")
    spawn_dir = os.path.join(root, "spawn")
    os.makedirs(spawn_dir)
    cluster = Cluster(root, {"serve": ("serve", {
        **PHASE21_ENV, "PYTHONPATH": os.pathsep.join(
            p for p in (ROOT, os.environ.get("PYTHONPATH")) if p)})},
        cwd=spawn_dir)
    config = os.path.join(cluster.dirs["serve"], "cluster_config.json")
    with open(config, "w") as f:
        json.dump({"master": {"host": "127.0.0.1",
                              "port": cluster.ports["serve"]},
                   "workers": [],
                   "settings": {"auto_launch_workers": False}}, f)
    url = cluster.url("serve")
    out_dir = os.path.join(cluster.dirs["serve"], "output")
    report = {"card": card_line(),
              "settings": {**{k: v for k, v in PHASE21_ENV.items()
                              if k != "DTPU_CHAOS"},
                           "chaos": PHASE21_CHAOS}}
    launches = {"variants": collections.Counter(),
                "shapes": collections.Counter()}
    seed = SEEDS[0]
    txt = with_save_image(docs["txt2img"])

    def prompt(s):
        doc = copy.deepcopy(txt)
        doc["13"]["inputs"]["seed"] = s
        return {"prompt": doc, "client_id": "chip_smoke"}

    def cli_out(args):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = cli.main(args)
        return rc, buf.getvalue()

    try:
        t0 = time.perf_counter()
        cluster.launch("serve")
        yield
        registry.clear_pipeline_cache()
        gc.collect()
        torch.cuda.empty_cache()
        free, _ = torch.cuda.mem_get_info()
        if free < PHASE21_MIN_FREE:
            cluster.fail(f"phase 21 needs {PHASE21_MIN_FREE} bytes free, "
                         f"{free} are")
        report["free_bytes_before"] = free
        t1 = time.perf_counter()
        cluster.wait_up(["serve"])
        report["server_up_after_launch_s"] = time.perf_counter() - t0
        report["server_wait_s"] = time.perf_counter() - t1
        m0 = get_json(url + "/distributed/metrics")
        t_burst = time.time()
        burst = []
        for k in range(PHASE21_BURST):
            resp = post_json(url + "/prompt", prompt(seed + 1 + k))
            if resp.get("workers"):
                cluster.fail(f"phase 21: burst prompt {k} fanned out: {resp}")
            burst.append(resp["prompt_id"])
        report["burst_post_s"] = time.time() - t_burst
        at = {}            # event -> seconds since the burst's first post
        util = {}          # decision -> utilization the autoscaler read
        wid = late = tree = log_file = top = None
        deadline = time.time() + FANOUT_REQUEST_S
        polls = 0
        while True:
            polls += 1
            fl = get_json(url + "/distributed/fleet")
            now = time.time() - t_burst
            a, workers = fl["autoscale"], fl["workers"]
            sig = a.get("signal") or {}
            for d in a.get("decisions", []):
                if d["action"] in ("up", "down") and d["action"] not in at:
                    at[d["action"]] = d["t"] - t_burst
                    util[d["action"]] = d.get("utilization")
                    if d["action"] == "up":
                        wid = d["worker_id"]
            if wid is not None and wid in workers \
                    and "registered" not in at:
                at["registered"] = now
            if wid is not None and late is None:
                managed = get_json(url + "/distributed/managed_workers")
                entry = managed.get(wid)
                if entry is not None and not entry["launching"] \
                        and workers.get(wid, {}).get("state") == "healthy":
                    at["healthy"] = now
                    tree = proc_tree(entry["pid"])
                    log_file = entry["log_file"]
                    rc, text = cli_out(["top", "--url", url, "--json"])
                    top = json.loads(text) if rc == 0 else None
                    if rc != 0 or wid not in top.get("participants", {}):
                        cluster.fail(f"phase 21: cli top --json rc {rc}, "
                                     f"{text[-1000:]}")
                    resp = post_json(url + "/prompt", prompt(seed))
                    at["share_dispatched"] = time.time() - t_burst
                    if resp.get("workers") != [wid] \
                            or resp.get("failed_workers"):
                        cluster.fail(f"phase 21: the prompt after the "
                                     f"worker's start fanned out to {resp}")
                    late = resp["prompt_id"]
            if sig.get("queue_depth") == 0 and "queue_empty" not in at:
                if late is None:
                    cluster.fail(f"phase 21: the queue emptied {now:.2f} s "
                                 f"after the burst, before the spawned "
                                 f"worker was ready ({at})")
                at["queue_empty"] = now
            if wid is not None and workers.get(wid, {}).get("state") \
                    == "retiring" and "retiring" not in at:
                at["retiring"] = now
            if "down" in at and wid not in workers \
                    and not a.get("retiring") and not a.get("spawned"):
                at["reaped"] = now
                break
            if time.time() > deadline:
                cluster.fail(f"phase 21: no reap after {FANOUT_REQUEST_S} s "
                             f"({at}, {a.get('decisions')})")
            time.sleep(PHASE21_POLL_S)
        report["seconds_from_burst"] = at
        report["utilization_at"] = util
        report["polls"] = polls
        missing = [e for e in ("up", "registered", "healthy",
                               "share_dispatched", "queue_empty", "down",
                               "retiring", "reaped") if e not in at]
        if missing:
            cluster.fail(f"phase 21: never saw {missing} ({at})")
        hist = get_json(url + "/history")
        for pid in burst + [late]:
            h = hist.get(pid, {})
            want = 2 if pid == late else 1
            if h.get("status") != "success" or h.get("images") != want:
                cluster.fail(f"phase 21: {pid}'s history {h}, expected "
                             f"success with {want} images")
        fl = get_json(url + "/distributed/fleet")
        a = fl["autoscale"]
        actions = [d["action"] for d in a["decisions"]
                   if d["action"] in ("up", "down")]
        if actions != ["up", "down"] or a["flaps"] != 0 \
                or a["scale_ups"] != 1 or a["scale_downs"] != 1:
            cluster.fail(f"phase 21: decisions {a['decisions']}, flaps "
                         f"{a['flaps']}")
        report["decisions"] = a["decisions"]
        # the reap: the tree gone, the config and the registry without it
        alive = [p for p in tree if pid_alive(p)]
        with open(config) as f:
            listed = [w["id"] for w in json.load(f).get("workers", [])]
        if alive or wid in listed:
            cluster.fail(f"phase 21: after the reap {alive} alive, config "
                         f"{listed}")
        report["worker"] = {"id": wid, "tree": len(tree)}
        # the chaos faults, each upload retried to success
        m1 = get_json(url + "/distributed/metrics")
        injected = m1["chaos"]["injected"]
        report["chaos"] = {"injected": injected,
                           "images_received": m1["images_received"]
                           - m0["images_received"]}
        if injected.get("5xx", 0) < 1 or injected.get("corrupt", 0) < 1 \
                or report["chaos"]["images_received"] != 1:
            cluster.fail(f"phase 21: chaos {report['chaos']}")
        rc, text = cli_out(["fleet", "--url", url, "--json"])
        if rc != 0 or [d["action"] for d in json.loads(text)["autoscale"][
                "decisions"]] != ["up", "down"]:
            cluster.fail(f"phase 21: cli fleet --json rc {rc}: "
                         f"{text[-1000:]}")
        rc, text = cli_out(["fleet", "--url", url])
        rc_top, text_top = cli_out(["top", "--url", url])
        if rc != 0 or rc_top != 0 or "CHAOS ARMED" not in text:
            cluster.fail(f"phase 21: cli fleet rc {rc}, cli top rc "
                         f"{rc_top}: {text[-1000:]}")
        print(text, flush=True)
        prom = parse_prom(urllib_text(url + "/distributed/metrics.prom"),
                          "phase 21 metrics.prom")
        counts = {n: prom.get((f"dtpu_autoscale_{n}_total", ()))
                  for n in ("scale_ups", "scale_downs", "flaps")}
        if counts != {"scale_ups": 1.0, "scale_downs": 1.0, "flaps": 0.0}:
            cluster.fail(f"phase 21: metrics.prom {counts}")
        # forgotten, and not brought back by a health probe since
        if wid in get_json(url + "/distributed/cluster")["workers"]:
            cluster.fail(f"phase 21: the registry still holds {wid}")
        # sm90 alone, 2800 a request and a share, at checked shapes
        lines = {"master": cluster.prompt_lines("serve")}
        with open(log_file, "r", errors="replace") as f:
            lines["worker"] = [json.loads(ln.split(" ", 2)[2]) for ln in f
                               if ln.startswith("dtpu-torch prompt ")]
        if len(lines["master"]) != PHASE21_BURST + 1 \
                or len(lines["worker"]) != 1:
            cluster.fail(f"phase 21: prompt lines "
                         f"{ {k: len(v) for k, v in lines.items()} }")
        for role, lns in lines.items():
            for ln in lns:
                by_shape = {tuple(x[:6]): x[6]
                            for x in ln["launches_by_shape"]}
                if ln["status"] != "success" or (
                        PHASE21_CHECK_LAUNCHES and ln["launches"] != {
                            "sm90": EXPECTED["txt2img"][1], "mma_sync": 0,
                            "fp32": 0}) \
                        or any(s not in checked for s in by_shape):
                    cluster.fail(f"phase 21: {role}'s prompt line {ln}")
                launches["variants"].update(ln["launches"])
                launches["shapes"].update(by_shape)
        report["sm90_launches"] = {
            role: sum(ln["launches"]["sm90"] for ln in lns)
            for role, lns in lines.items()}
        report["seconds_a_prompt"] = {
            "master": [ln["seconds"] for ln in lines["master"]],
            "worker": [ln["seconds"] for ln in lines["worker"]]}
        # the images: the burst's at SEEDS[0] + 1 and the fanned-out
        # prompt's two (the master's, the worker's at the seed offset)
        by_seed = collections.defaultdict(list)
        for name in sorted(os.listdir(out_dir)):
            path = os.path.join(out_dir, name)
            doc = json.loads(dict(png_text_chunks(path))["prompt"])
            by_seed[doc["13"]["inputs"]["seed"]].append(path)
        checks = [(by_seed[seed + 1][:1], txt_refs[1:], "burst"),
                  (by_seed[seed], txt_refs, "fan-out")]
        lim = FANOUT_ATOL["same"]
        diffs = {}
        for paths, refs, what in checks:
            if len(paths) != len(refs):
                cluster.fail(f"phase 21: {what} images {paths}")
            for k, (path, ref) in enumerate(zip(paths, refs)):
                d = image_diff(path, ref)
                diffs[f"{what} {k}"] = {"max": d[0], "mean": d[1]}
                if d[0] > lim[0] or d[1] > lim[1]:
                    cluster.fail(f"phase 21: {what} image {k} differs by "
                                 f"{d} from its in-process run")
        report["abs_diff"] = diffs
        report["images"] = sum(len(v) for v in by_seed.values())
    finally:
        cluster.stop()
        shutil.rmtree(root, True)
    unchecked = [s for s in launches["shapes"] if s not in checked]
    if set(launches["variants"]) - {"sm90", "mma_sync", "fp32"} \
            or launches["variants"]["mma_sync"] \
            or launches["variants"]["fp32"] or unchecked:
        fail(f"phase 21: launched {dict(launches['variants'])}, unchecked "
             f"shapes {unchecked}")
    return report, {"path": "phase 21",
                    "variants": {"sm90": launches["variants"]["sm90"]},
                    "shapes": dict(launches["shapes"])}


def patched_attention_shapes(patch, hw=(64, 64), batch=2, capture=False,
                             tokens=77):
    """The attention shapes ``(B, N, M, H, D, dtype)`` that one SD1.5
    UNet call on a ``batch`` x ``hw`` latent and a ``tokens``-long
    context under the UNet-config ``patch`` (HyperTile's folded tiles,
    deep shrink's shrunk levels, SAG's capture with ``capture``, ToMe's
    merged queries, GLIGEN's fusers over one grounding token) gives the
    kernel's wrapper, read off a forward on the meta device with the
    wrapper swapped for a recorder: the shapes the code gives, not a
    copy of its rule."""
    import dataclasses

    import torch

    from comfyui_distributed_tpu_torch.models import layers, registry
    from comfyui_distributed_tpu_torch.models import unet as unet_mod
    cfg = dataclasses.replace(registry.get_family("sd15").unet, **patch)
    seen = []

    def record(q, k, v):
        seen.append((int(q.shape[0]), int(q.shape[1]), int(k.shape[1]),
                     int(q.shape[2]), int(q.shape[3]), str(q.dtype)))
        return torch.empty_like(q)

    saved = layers.flash_attention
    layers.flash_attention = record
    try:
        with torch.device("meta"):
            unet = unet_mod.UNet(cfg)
            unet(torch.empty(batch, *hw, cfg.in_channels), torch.empty(batch),
                 torch.empty(batch, tokens, cfg.context_dim),
                 **({"capture": True} if capture else {}))
    finally:
        layers.flash_attention = saved
    return seen


def phase22_kernel_shapes():
    """Phase 3's rows for phase 22's own shapes: HyperTile's and deep
    shrink's (the shrunk branch) at 512^2, B = 2."""
    rows = []
    for patch, what in (({"hypertile": PHASE22_HYPERTILE[:1]
                          + PHASE22_HYPERTILE[2:]}, "HyperTile"),
                        ({"deep_shrink": (1, 2.0)}, "deep shrink")):
        for B, N, M, H, D, dt in sorted(set(patched_attention_shapes(patch))):
            rows.append((B, N, M, H, D, dt,
                         f"SD1.5 512^2 {what} {'self' if N == M else 'cross'}"
                         f" {N} tokens"))
    return rows


def phase23_kernel_shapes():
    """Phase 3's rows for phase 23's batches at 512^2: the 3-row
    guidances' B = 3 and SAG's uncond-only call and a BasicGuider step at
    B = 1.  The capture call's 31 launches at B = 2 are the plain B = 2
    shapes (its middle self-attention launches nothing), and the calls'
    counts must be the launch constants'."""
    rows = []
    for batch, what in ((3, "3-row guidance"), (1, "one-row call")):
        shapes = patched_attention_shapes({}, batch=batch)
        if len(shapes) != PHASE23_CALL_LAUNCHES:
            fail(f"phase 23: an SD1.5 call at B = {batch} gives "
                 f"{len(shapes)} attentions, not {PHASE23_CALL_LAUNCHES}")
        for B, N, M, H, D, dt in sorted(set(shapes)):
            rows.append((B, N, M, H, D, dt,
                         f"SD1.5 512^2 {what} {'self' if N == M else 'cross'}"
                         f" {N} tokens"))
    cap = patched_attention_shapes({"sag_capture": True}, capture=True)
    plain = patched_attention_shapes({})
    if len(cap) != PHASE23_CAPTURE_LAUNCHES \
            or not set(cap) <= set(plain):
        fail(f"phase 23: SAG's capture call gives {len(cap)} attentions "
             f"(expected {PHASE23_CAPTURE_LAUNCHES} of the plain call's "
             "shapes)")
    return rows


def phase24_kernel_shapes():
    """Phase 3's rows for phase 24's own shapes at 512^2, B = 2: ToMe's
    merged level-0 queries, the GLIGEN fusers' self-attention over the
    tokens and one box, and the cross-attention over a context with the
    style model's tokens appended (77 + 8)."""
    rows = []
    for patch, tokens, what in (
            ({"tome_ratio": PHASE24_TOME}, 77, "ToMe"),
            ({"gligen": 768}, 77, "GLIGEN"),
            ({}, 77 + PHASE24_STYLE_TOKENS, "style")):
        for B, N, M, H, D, dt in sorted(set(patched_attention_shapes(
                patch, tokens=tokens))):
            kind = "cross" if M == tokens else "self"
            rows.append((B, N, M, H, D, dt,
                         f"SD1.5 512^2 {what} {kind} {N} x {M} tokens"))
    return rows


class TeeStdout:
    """``sys.stdout`` copied into ``lines`` while it is entered (the
    port's log lines go to standard output)."""

    def __init__(self):
        self.lines = []

    def write(self, text):
        self.lines.append(text)
        return self.out.write(text)

    def flush(self):
        self.out.flush()

    def __enter__(self):
        self.out, sys.stdout = sys.stdout, self
        return self

    def __exit__(self, *exc):
        sys.stdout = self.out


def phase22_doc(ckpt, seed=PHASE22_SEED):
    """The plain SD1.5 txt2img graph of phase 22 (512^2, batch 1, 20
    euler/karras steps, cfg 7) and the hint's nodes: LoadImage of
    ``PHASE22_HINT`` through Canny(0.4, 0.8)."""
    return {
        "4": {"class_type": "CheckpointLoaderSimple",
              "inputs": {"ckpt_name": ckpt}},
        "5": {"class_type": "EmptyLatentImage",
              "inputs": {"width": 512, "height": 512,
                         "batch_size": 1}},
        "6": {"class_type": "CLIPTextEncode",
              "inputs": {"text": "a lighthouse on a cliff at dawn, "
                                 "volumetric light", "clip": ["4", 1]}},
        "7": {"class_type": "CLIPTextEncode",
              "inputs": {"text": "blurry, lowres", "clip": ["4", 1]}},
        "10": {"class_type": "LoadImage", "inputs": {"image": PHASE22_HINT}},
        "11": {"class_type": "Canny",
               "inputs": {"image": ["10", 0], "low_threshold": 0.4,
                          "high_threshold": 0.8}},
        "3": {"class_type": "KSampler",
              "inputs": {"seed": seed, "steps": 20, "cfg": 7.0,
                         "sampler_name": "euler", "scheduler": "karras",
                         "denoise": 1.0, "model": ["4", 0],
                         "positive": ["6", 0], "negative": ["7", 0],
                         "latent_image": ["5", 0]}},
        "8": {"class_type": "VAEDecode",
              "inputs": {"samples": ["3", 0], "vae": ["4", 2]}},
        "9": {"class_type": "PreviewImage", "inputs": {"images": ["8", 0]}},
    }


def phase22_variant(doc, control=(), advanced=None, patch=None):
    """``doc`` with ControlNets on its positive and a model patch:
    ``control`` a list of (loader, name), each net applied at strength 1
    after the one before (a ``DiffControlNetLoader`` takes the model);
    ``advanced`` (start, end): the first net through
    ControlNetApplyAdvanced on both sides instead; ``patch`` (op,
    widgets) between the checkpoint and the sampler."""
    doc = copy.deepcopy(doc)
    ks = doc["3"]["inputs"]
    cond = ["6", 0]
    for i, (loader, name) in enumerate(control):
        lid, aid = str(20 + 2 * i), str(21 + 2 * i)
        doc[lid] = {"class_type": loader,
                    "inputs": {"control_net_name": name}}
        if loader == "DiffControlNetLoader":
            doc[lid]["inputs"]["model"] = ["4", 0]
        if advanced is not None and i == 0:
            doc[aid] = {"class_type": "ControlNetApplyAdvanced",
                        "inputs": {"positive": cond, "negative": ["7", 0],
                                   "control_net": [lid, 0],
                                   "image": ["11", 0], "strength": 1.0,
                                   "start_percent": advanced[0],
                                   "end_percent": advanced[1]}}
            ks["negative"] = [aid, 1]
        else:
            doc[aid] = {"class_type": "ControlNetApply",
                        "inputs": {"conditioning": cond,
                                   "control_net": [lid, 0],
                                   "image": ["11", 0], "strength": 1.0}}
        cond = [aid, 0]
    ks["positive"] = cond
    if patch is not None:
        op, widgets = patch
        doc["30"] = {"class_type": op,
                     "inputs": {"model": ["4", 0], **widgets}}
        ks["model"] = ["30", 0]
    return doc


def write_phase22_nets(models_dir, pipe):
    """The two ControlNet files of phase 22 in ``models_dir``: the virtual
    net of ``PHASE22_VIRTUAL_CN`` (loaded already) with its projections
    drawn, as ``PHASE22_CN``, and (``PHASE22_DIFF_CN``) the
    same net less ``pipe``'s UNet leaves at the same flax path and shape
    (in float32, stored in bf16).  Returns each write's seconds and
    bytes."""
    import numpy as np
    import torch

    from comfyui_distributed_tpu_torch.models import checkpoints as ckpt
    from comfyui_distributed_tpu_torch.models import controlnet as cn_mod
    from comfyui_distributed_tpu_torch.models import registry, weights

    cfg = registry.get_family("sd15").unet
    virtual = registry.load_controlnet(PHASE22_VIRTUAL_CN, device=pipe.device)

    @torch.no_grad()
    def drawn(m):
        m.load_state_dict(virtual.state_dict())
        for leaf in weights.leaves(m):
            if cn_mod.is_zero_projection(leaf.flax_path[0]) \
                    and leaf.kind != "same":
                arr = weights.virtual_leaf(
                    PHASE22_PROJ_SEED, leaf.flax_path,
                    weights._flax_shape(leaf.kind, tuple(leaf.param.shape)))
                leaf.param.copy_(torch.from_numpy(np.ascontiguousarray(
                    weights._to_torch_layout(leaf.kind, arr))))

    net = registry._build(lambda: cn_mod.ControlNet(cfg), pipe.device,
                          cfg.dtype, drawn)
    unet = ckpt._by_path(pipe.unet)

    @torch.no_grad()
    def less_unet(m):
        src = ckpt._by_path(net)
        for path, leaf in ckpt._by_path(m).items():
            value = src[path].param
            base = unet.get(path)
            if base is not None and base.param.shape == value.shape:
                value = value.float() - base.param.float()
            leaf.param.copy_(value)

    diff = registry._build(lambda: cn_mod.ControlNet(cfg), pipe.device,
                           cfg.dtype, less_unet)
    report = {}
    for name, m in ((PHASE22_CN, net), (PHASE22_DIFF_CN, diff)):
        path = os.path.join(models_dir, name)
        t0 = time.perf_counter()
        ckpt.write_safetensors(ckpt.export_controlnet(m, cfg), path)
        report[name] = {"write_s": time.perf_counter() - t0,
                        "bytes": os.path.getsize(path)}
    del net, diff
    return report


def sd15_phase_dirs(docs):
    """Phases 22 and 23's directories: a models directory holding a link
    to phase 10's SD1.5 file (the checkpoint the upscale workflow names)
    and an input directory.  Released by :func:`release_phase_dirs`."""
    ckpt_name = docs["upscale"]["4"]["inputs"]["ckpt_name"]
    root, _ = models_dir_root()
    models_dir = tempfile.mkdtemp(prefix="chip_smoke_phase22_", dir=root)
    input_dir = tempfile.mkdtemp(prefix="chip_smoke_phase22_in_")
    src = None if SERVER_MODELS_DIR is None \
        else os.path.join(SERVER_MODELS_DIR, ckpt_name)
    if src is None or not os.path.exists(src):
        fail(f"phase 22: phase 10's SD1.5 file {ckpt_name} is missing")
    os.symlink(src, os.path.join(models_dir, ckpt_name))
    return {"ckpt": ckpt_name, "models_dir": models_dir,
            "input_dir": input_dir}


def release_phase_dirs(dirs):
    """Drop the pipelines and the device memory, remove the directories."""
    import gc

    import torch

    from comfyui_distributed_tpu_torch.models import registry
    registry.clear_pipeline_cache()
    gc.collect()
    torch.cuda.empty_cache()
    shutil.rmtree(dirs["models_dir"], ignore_errors=True)
    shutil.rmtree(dirs["input_dir"], ignore_errors=True)


class PhaseRequests:
    """The in-process requests of phases 22 and 23: each run's image, its
    launches (zeroed just before, read just after, held to the expected
    sm90 count and to shapes phase 3 checked, failing at once) and its
    line; and the image checks between runs, whose failures
    :meth:`report` prints with the phase's line before it fails."""

    def __init__(self, phase, dirs, shape_counts, rows):
        self.phase, self.dirs, self.shape_counts = phase, dirs, shape_counts
        self.checked = {(r["B"], r["N"], r["M"], r["H"], r["D"],
                         r["dtype"]): r for r in rows if not r.get("named")}
        self.requests, self.images, self.checks = [], {}, {}
        self.problems = []

    def run(self, tag, doc, want, sampler_nodes=("3",), results=None):
        import numpy as np
        import torch

        from comfyui_distributed_tpu_torch.ops.base import OpContext
        from comfyui_distributed_tpu_torch.ops.kernels import \
            flash_attention as fa
        from comfyui_distributed_tpu_torch.workflow import WorkflowExecutor
        torch.cuda.reset_peak_memory_stats()
        fa.reset_counts()
        t0 = time.perf_counter()
        res = WorkflowExecutor(OpContext(
            device=DEVICE, input_dir=self.dirs["input_dir"],
            models_dir=self.dirs["models_dir"],
            output_dir=self.dirs.get("output_dir"))).execute(
                copy.deepcopy(doc))
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        shapes = dict(fa.flash_attention.shapes)
        variants = dict(fa.flash_attention.variants)
        img = res.image_batch
        finite = bool(img is not None and np.isfinite(img).all())
        std = float(img.std()) if img is not None else 0.0
        if img is None or img.ndim != 4 or img.shape[0] != 1 or not finite \
                or not std > 0.0:
            fail(f"phase {self.phase} {tag}: image shape "
                 f"{None if img is None else img.shape}, finite {finite}, "
                 f"std {std}")
        if variants != {"sm90": want}:
            fail(f"phase {self.phase} {tag}: flash-attention launches "
                 f"{variants}; expected {want} sm90")
        missing = sorted(set(shapes).difference(self.checked))
        if missing:
            fail(f"phase {self.phase} {tag}: launched shapes phase 3 did "
                 f"not check: {missing}")
        self.shape_counts.update(shapes)
        # the request's attention: phase 3's times of its shapes times
        # its launches of each
        kernel = totals(shapes, self.checked,
                        ["ms", "plain_ms", "library_ms", "mma_sync_ms",
                         "exp2_ms"]) if shapes else None
        self.requests.append({
            "path": f"phase{self.phase}", "run": tag, "seconds": seconds,
            "kernel_ms": kernel,
            "node_seconds": {f"{k} {doc[k]['class_type']}": round(v, 4)
                             for k, v in res.timings.items()},
            "sampler_seconds": round(sum(res.timings[k]
                                         for k in sampler_nodes), 4),
            "launches": fa.flash_attention.launches, "variants": variants,
            "launches_by_shape": [[*k, n] for k, n in sorted(shapes.items())],
            "max_memory_allocated": torch.cuda.max_memory_allocated()})
        self.images[tag] = img[0]
        if results is not None:
            results[tag] = res
        return img[0]

    def diff(self, a, b):
        import numpy as np
        d = np.abs(self.images[a] - self.images[b])
        return {"max": float(d.max()), "mean": float(d.mean())}

    def same(self, a, b):
        import numpy as np
        self.checks[f"{a} == {b}"] = d = self.diff(a, b)
        if not np.array_equal(self.images[a], self.images[b]):
            self.problems.append(f"{a} differs from {b}: {d}")

    def within(self, a, b, limits=FANOUT_ATOL["one_batch"]):
        self.checks[f"{a} ~ {b}"] = d = self.diff(a, b)
        if not (d["max"] <= limits[0] and d["mean"] <= limits[1]):
            self.problems.append(f"{a} is beyond {limits} of {b}: {d}")

    def apart(self, a, b, limits=FANOUT_ATOL["one_batch"]):
        self.checks[f"{a} != {b}"] = d = self.diff(a, b)
        if not (d["max"] > limits[0] and d["mean"] > limits[1]):
            self.problems.append(f"{a} is not beyond {limits} of {b}: {d}")

    def report(self, t_phase, budget_s, extra=None):
        """The phase's line; with a failed check, printed and failed."""
        out = {"card": card_line(), "checks": self.checks,
               "requests": [{k: r[k] for k in (
                   "run", "seconds", "sampler_seconds", "node_seconds",
                   "launches", "kernel_ms", "max_memory_allocated")}
                   for r in self.requests],
               "seconds": time.perf_counter() - t_phase}
        out.update(extra or {})
        if self.problems:
            emit(f"phase{self.phase}", out)
            fail(f"phase {self.phase}: {'; '.join(self.problems)}")
        if out["seconds"] > budget_s:
            print(f"chip_smoke: phase {self.phase} took "
                  f"{out['seconds']:.1f} s, over its {budget_s} s budget",
                  file=sys.stderr, flush=True)
        return out


def controlnet_and_patches(dirs, shape_counts, rows):
    """Phase 22 (module docstring) on the SD1.5 checkpoint of ``dirs``
    (:func:`sd15_phase_dirs`): (report, requests, the plain image)."""
    import gc

    from comfyui_distributed_tpu_torch.models import registry
    from comfyui_distributed_tpu_torch.utils.image import save_png

    t_phase = time.perf_counter()
    ckpt_name, models_dir = dirs["ckpt"], dirs["models_dir"]
    input_dir = dirs["input_dir"]
    runs = PhaseRequests(22, dirs, shape_counts, rows)
    images, checks, report = runs.images, runs.checks, {}
    base = phase22_doc(ckpt_name)

    def run(tag, doc, nets):
        return runs.run(tag, doc, PHASE22_UNET_LAUNCHES
                        + nets * PHASE22_NET_LAUNCHES)

    diff, same, apart = runs.diff, runs.same, runs.apart
    try:
        run("plain", base, 0)
        save_png(os.path.join(input_dir, PHASE22_HINT), images["plain"])
        virtual = [("ControlNetLoader", PHASE22_VIRTUAL_CN)]
        run("virtual", phase22_variant(base, virtual), 1)
        same("virtual", "plain")
        run("window (0, 1)", phase22_variant(base, virtual, (0.0, 1.0)), 1)
        same("window (0, 1)", "virtual")
        run("window (1, 1)", phase22_variant(base, virtual, (1.0, 1.0)), 0)
        same("window (1, 1)", "plain")
        pipe = registry.load_pipeline(ckpt_name, models_dir=models_dir,
                                      device=DEVICE)
        report["files"] = write_phase22_nets(models_dir, pipe)
        del pipe
        from_file = [("ControlNetLoader", PHASE22_CN)]
        run("file", phase22_variant(base, from_file), 1)
        family = registry._cn_family_cache.get(
            os.path.join(models_dir, PHASE22_CN))
        if family != "sd15":
            fail(f"phase 22: ControlNetLoader took family {family!r} from "
                 f"{PHASE22_CN}; expected sd15")
        apart("file", "plain")
        run("file again", phase22_variant(base, from_file), 1)
        same("file again", "file")
        run("diff file", phase22_variant(
            base, [("DiffControlNetLoader", PHASE22_DIFF_CN)]), 1)
        runs.within("diff file", "file")
        run("two nets", phase22_variant(base, from_file + virtual), 2)
        same("two nets", "file")
        for tag, op, widgets in (
                ("FreeU", "FreeU", dict(zip(("b1", "b2", "s1", "s2"),
                                            PHASE22_FREEU))),
                ("FreeU_V2", "FreeU_V2", dict(zip(("b1", "b2", "s1", "s2"),
                                                  PHASE22_FREEU))),
                ("HyperTile", "HyperTile", dict(zip(
                    ("tile_size", "swap_size", "max_depth", "scale_depth"),
                    PHASE22_HYPERTILE))),
                ("deep shrink", "PatchModelAddDownscale", {})):
            run(tag, phase22_variant(base, patch=(op, widgets)), 0)
            checks[f"{tag} != plain"] = d = diff(tag, "plain")
            if not d["max"] > 0.0:
                fail(f"phase 22: {tag} gave the plain image")
        with TeeStdout() as tee:
            run("deep shrink under the file's net", phase22_variant(
                base, from_file, patch=("PatchModelAddDownscale", {})), 1)
        same("deep shrink under the file's net", "file")
        said = "".join(tee.lines)
        if "sampling WITHOUT the downscale patch" not in said:
            fail("phase 22: deep shrink under a ControlNet did not log its "
                 "drop")
        report["deep_shrink_log_seen"] = True
    finally:
        # phase 23 takes the SD1.5 pipeline on; the ControlNets go
        registry._controlnet_cache.clear()
        gc.collect()
    return (runs.report(t_phase, PHASE22_BUDGET_S, report), runs.requests,
            images["plain"])


def phase23_doc(base, variant):
    """Phase 23's graph ``variant`` on phase 22's plain graph ``base``
    (its hint nodes dropped): the same checkpoint, prompts, latent,
    seed, cfg, sampler and schedule, sampled through the slice's ops.
    Returns (doc, the sampler nodes)."""
    doc = {k: copy.deepcopy(v) for k, v in base.items()
           if k not in ("10", "11")}
    ks = doc["3"]["inputs"]
    seed, cfg = ks["seed"], ks["cfg"]
    model, pos, neg = ["4", 0], ["6", 0], ["7", 0]
    nodes = ("3",)

    def node(nid, class_type, **inputs):
        doc[nid] = {"class_type": class_type, "inputs": inputs}

    def custom(guider=None):
        node("20", "RandomNoise", noise_seed=seed)
        node("21", "KSamplerSelect", sampler_name=ks["sampler_name"])
        node("22", "BasicScheduler", model=model, scheduler=ks["scheduler"],
             steps=ks["steps"], denoise=1.0)
        node("23", "CFGGuider", model=model, positive=pos, negative=neg,
             cfg=cfg)
        if guider is not None:
            node("23", *guider[:1], **guider[1])
        node("3", "SamplerCustomAdvanced", noise=["20", 0],
             guider=["23", 0], sampler=["21", 0], sigmas=["22", 0],
             latent_image=["5", 0])

    def patch(class_type, **widgets):
        node("30", class_type, model=model, **widgets)
        ks["model"] = ["30", 0]

    empty_text = doc["7"]["inputs"]["text"]
    if variant == "SamplerCustomAdvanced":
        custom()
    elif variant == "SamplerCustom":
        custom()
        node("3", "SamplerCustom", model=model, add_noise=True,
             noise_seed=seed, cfg=cfg, positive=pos, negative=neg,
             latent_image=["5", 0], sampler=["21", 0], sigmas=["22", 0])
    elif variant == "ModelSamplingDiscrete eps":
        patch("ModelSamplingDiscrete", sampling="eps", zsnr=False)
    elif variant == "SplitSigmas":
        custom()
        node("25", "SplitSigmas", sigmas=["22", 0], step=PHASE23_SPLIT_AT)
        node("26", "DisableNoise")
        doc["3"]["inputs"]["sigmas"] = ["25", 0]
        node("27", "SamplerCustomAdvanced", noise=["26", 0],
             guider=["23", 0], sampler=["21", 0], sigmas=["25", 1],
             latent_image=["3", 0])
        doc["8"]["inputs"]["samples"] = ["27", 0]
        nodes = ("3", "27")
    elif variant == "DualCFGGuider":
        custom(("DualCFGGuider", dict(
            model=model, cond1=pos, cond2=neg, negative=neg, cfg_conds=cfg,
            cfg_cond2_negative=PHASE23_DUAL_CFG2)))
    elif variant == "PerpNegGuider":
        # the empty prompt's own encode, of the negative's text
        node("24", "CLIPTextEncode", text=empty_text, clip=["4", 1])
        custom(("PerpNegGuider", dict(
            model=model, positive=pos, negative=neg,
            empty_conditioning=["24", 0], cfg=cfg, neg_scale=1.0)))
    elif variant == "PerpNeg":
        node("24", "CLIPTextEncode", text=empty_text, clip=["4", 1])
        patch("PerpNeg", empty_conditioning=["24", 0], neg_scale=1.0)
    elif variant == "SAG 0":
        patch("SelfAttentionGuidance", scale=0.0,
              blur_sigma=PHASE23_SAG[1])
    elif variant == "SAG":
        patch("SelfAttentionGuidance", scale=PHASE23_SAG[0],
              blur_sigma=PHASE23_SAG[1])
    elif variant == "RescaleCFG":
        patch("RescaleCFG", multiplier=PHASE23_RESCALE)
    elif variant == "AlignYourSteps":
        custom()
        node("21", "KSamplerSelect", sampler_name="dpmpp_2m")
        node("22", "AlignYourStepsScheduler", model_type="SD1",
             steps=PHASE23_AYS_STEPS, denoise=1.0)
    elif variant == "SDTurbo":
        custom(("BasicGuider", dict(model=model, conditioning=pos)))
        node("22", "SDTurboScheduler", model=model, steps=1, denoise=1.0)
    else:
        raise ValueError(variant)
    return doc, nodes


def phase23_launches(variant):
    """sm90 launches of a phase 23 request: 32 a UNet call at B = 2 or 3
    (20 steps), SAG's capture call and its uncond call at B = 1 (31 + 32
    a step), AYS's 10 dpmpp_2m steps, SDTurbo's one step at B = 1."""
    call, steps = PHASE23_CALL_LAUNCHES, PHASE23_STEPS
    if variant in ("SAG 0", "SAG"):
        return steps * (PHASE23_CAPTURE_LAUNCHES + call)
    if variant == "AlignYourSteps":
        return PHASE23_AYS_STEPS * call
    if variant == "SDTurbo":
        return call
    return steps * call


def custom_sampling(dirs, plain, shape_counts, rows):
    """Phase 23 (module docstring) in phase 22's process, on its SD1.5
    file, seed and graph, with the reuse plane off; ``plain`` is phase
    22's plain image: (report, requests)."""
    t_phase = time.perf_counter()
    runs = PhaseRequests(23, dirs, shape_counts, rows)
    runs.images["phase 22 plain"] = plain
    base = phase22_doc(dirs["ckpt"])
    prev = os.environ.get("DTPU_CACHE")
    os.environ["DTPU_CACHE"] = "0"
    logs = {}
    try:
        for variant in ("SamplerCustomAdvanced", "SamplerCustom",
                        "ModelSamplingDiscrete eps", "SplitSigmas",
                        "DualCFGGuider", "PerpNegGuider", "PerpNeg",
                        "SAG 0", "SAG", "RescaleCFG", "AlignYourSteps",
                        "SDTurbo"):
            doc, nodes = phase23_doc(base, variant)
            with TeeStdout() as tee:
                runs.run(variant, doc, phase23_launches(variant), nodes)
            logs[variant] = "".join(tee.lines)
    finally:
        if prev is None:
            os.environ.pop("DTPU_CACHE", None)
        else:
            os.environ["DTPU_CACHE"] = prev
    plain_tag = "phase 22 plain"
    for variant in ("SamplerCustomAdvanced", "SamplerCustom",
                    "ModelSamplingDiscrete eps"):
        runs.same(variant, plain_tag)
    runs.same("SplitSigmas", "SamplerCustomAdvanced")
    for variant in ("DualCFGGuider", "PerpNegGuider", "SAG 0"):
        runs.within(variant, plain_tag)
    runs.same("PerpNeg", "PerpNegGuider")
    for variant in ("SAG", "AlignYourSteps", "SDTurbo"):
        runs.apart(variant, plain_tag)
    # RescaleCFG samples at plain's batch, so without the rescale it would
    # be plain to the bit: held beyond the same-batch limits
    runs.apart("RescaleCFG", plain_tag, FANOUT_ATOL["same"])
    dropped = [v for v, said in logs.items()
               if "WITHOUT self-attention guidance" in said]
    if dropped:
        runs.problems.append(f"SAG was dropped in {dropped}")
    return runs.report(t_phase, PHASE23_BUDGET_S), runs.requests


def phase24_doc(base, variant):
    """Phase 24's graph ``variant`` on phase 22's plain graph ``base`` (its
    Canny node dropped; its LoadImage of the hint feeds the style
    model's vision encode): the same checkpoint, prompts, latent, seed,
    cfg, sampler and schedule.  Returns (doc, expected sm90 launches)."""
    doc = {k: copy.deepcopy(v) for k, v in base.items() if k != "11"}
    ks = doc["3"]["inputs"]
    want = PHASE22_UNET_LAUNCHES

    def node(nid, class_type, **inputs):
        doc[nid] = {"class_type": class_type, "inputs": inputs}

    def patch(class_type, **widgets):
        node("30", class_type, model=["4", 0], **widgets)
        ks["model"] = ["30", 0]

    if variant.startswith("ToMe"):
        patch("TomePatchModel", ratio=float(variant.split()[1]))
    elif variant.startswith("hypernetwork"):
        patch("HypernetworkLoader",
              hypernetwork_name=PHASE24_HN_FILE if "file" in variant
              else PHASE24_HN, strength=0.0 if variant.endswith(" 0")
              else 1.0)
    elif variant.startswith("GLIGEN"):
        text, width, height, x, y = PHASE24_BOX
        node("40", "GLIGENLoader", gligen_name=PHASE24_GLIGEN)
        node("41", "GLIGENTextBoxApply", conditioning_to=["6", 0],
             clip=["4", 1], gligen_textbox_model=["40", 0], text=text,
             width=width, height=height, x=x, y=y)
        ks["positive"] = ["41", 0]
        # a fuser a transformer block: one more attention each
        want = PHASE22_UNET_LAUNCHES * 3 // 2
    elif variant == "style":
        node("50", "CLIPVisionLoader", clip_name=PHASE24_VISION)
        node("51", "CLIPVisionEncode", clip_vision=["50", 0],
             image=["10", 0], crop="center")
        node("52", "StyleModelLoader", style_model_name=PHASE24_STYLE)
        node("53", "StyleModelApply", conditioning=["6", 0],
             style_model=["52", 0], clip_vision_output=["51", 0])
        ks["positive"] = ["53", 0]
    elif variant.startswith("embedding"):
        name = PHASE24_EMBEDDING if variant == "embedding" \
            else PHASE24_EMBEDDING + "_missing"
        doc["6"]["inputs"]["text"] += f" embedding:{name}"
    else:
        raise ValueError(variant)
    if variant != "style":
        doc.pop("10")
    return doc, want


def write_phase24_files(models_dir, device):
    """Phase 24's files in ``models_dir``: the A1111 hypernetwork
    ``PHASE24_HN_FILE`` holding the virtual ``PHASE24_HN``'s 768-wide
    streams (the SD1.5 context's width), a ViT-L CLIP-vision file (the
    style adapter's width) of virtual weights, and the textual-inversion
    embedding ``PHASE24_EMBEDDING`` (``emb_params``, drawn from
    ``PHASE24_EMB_SEED``).  Returns each write's seconds and bytes."""
    import numpy as np
    import torch

    from comfyui_distributed_tpu_torch.models import checkpoints as ckpt
    from comfyui_distributed_tpu_torch.models import registry
    from comfyui_distributed_tpu_torch.models.hypernetwork import \
        load_hypernetwork

    def stream(layers):
        linears = [e for e in layers if e[0] == "linear"]
        out = {}
        for i, (_, w, b) in zip((0, 2), linears):
            out[f"linear.{i}.weight"] = torch.from_numpy(
                np.ascontiguousarray(np.asarray(w, np.float32).T))
            out[f"linear.{i}.bias"] = torch.from_numpy(
                np.asarray(b, np.float32))
        return out

    report = {}

    def timed(name, path, write):
        os.makedirs(os.path.dirname(path), exist_ok=True)
        t0 = time.perf_counter()
        write(path)
        report[name] = {"write_s": time.perf_counter() - t0,
                        "bytes": os.path.getsize(path)}

    k, v = load_hypernetwork(PHASE24_HN)[768]
    timed(PHASE24_HN_FILE,
          os.path.join(models_dir, "hypernetworks", PHASE24_HN_FILE),
          lambda p: torch.save({768: [stream(k), stream(v)],
                                "activation_func": "relu",
                                "activate_output": False}, p))
    tower = registry.load_clip_vision(PHASE24_VISION + ".virtual",
                                      config_name="vit_l", device=device)
    timed(PHASE24_VISION,
          os.path.join(models_dir, "clip_vision", PHASE24_VISION),
          lambda p: ckpt.save_part(p, tower.model, "clip_vision", tower.cfg))
    del tower
    registry._clip_vision_cache.clear()
    vecs = np.random.default_rng(PHASE24_EMB_SEED).standard_normal(
        PHASE24_EMB_SHAPE).astype(np.float32)
    timed(PHASE24_EMBEDDING,
          os.path.join(models_dir, "embeddings",
                       PHASE24_EMBEDDING + ".safetensors"),
          lambda p: ckpt.write_safetensors(
              {"emb_params": torch.from_numpy(vecs)}, p))
    return report


def unet_addons(dirs, plain, shape_counts, rows):
    """Phase 24 (module docstring) in phase 22's process, on its SD1.5
    file, seed and graph, with the reuse plane off; ``plain`` is phase
    22's plain image: (report, requests)."""
    import torch

    from comfyui_distributed_tpu_torch.models import registry
    from comfyui_distributed_tpu_torch.models.gligen import load_gligen
    from comfyui_distributed_tpu_torch.ops.basic import gligen_attach

    t_phase = time.perf_counter()
    runs = PhaseRequests(24, dirs, shape_counts, rows)
    plain_tag = "phase 22 plain"
    runs.images[plain_tag] = plain
    base = phase22_doc(dirs["ckpt"])
    report = {"files": write_phase24_files(dirs["models_dir"], DEVICE)}
    prev = os.environ.get("DTPU_CACHE")
    os.environ["DTPU_CACHE"] = "0"
    counts = {}
    tome_shape = (2, 4096 - int(4096 * PHASE24_TOME), 4096, 8, 40,
                  "torch.bfloat16")
    try:
        for variant in ("ToMe 0.3", "ToMe 0", "hypernetwork",
                        "hypernetwork file", "hypernetwork 0", "GLIGEN",
                        "GLIGEN gates", "GLIGEN gates again", "style",
                        "embedding", "embedding missing"):
            if variant == "GLIGEN gates":
                # the gates of the fuser pipeline, a copy derived from the
                # base: its fusers are its own, the base's weights shared
                pipe = registry.load_pipeline(
                    dirs["ckpt"], models_dir=dirs["models_dir"],
                    device=DEVICE)
                fused = gligen_attach(pipe, load_gligen(
                    PHASE24_GLIGEN, models_dir=dirs["models_dir"],
                    device=DEVICE))
                with torch.no_grad():
                    for name, p in fused.unet.named_parameters():
                        if name.endswith((".alpha_attn", ".alpha_dense")):
                            p.fill_(PHASE24_GATES)
                del pipe, fused
            doc, want = phase24_doc(base, variant)
            runs.run(variant, doc, want)
            shapes = runs.requests[-1]["launches_by_shape"]
            counts[variant] = {
                "tome_shape": sum(n for *k, n in shapes
                                  if tuple(k) == tome_shape),
                "style_cross": sum(n for *k, n in shapes
                                   if k[2] == 77 + PHASE24_STYLE_TOKENS)}
    finally:
        if prev is None:
            os.environ.pop("DTPU_CACHE", None)
        else:
            os.environ["DTPU_CACHE"] = prev
    report["shape_counts"] = counts
    # kept tokens are exact, only the merged ones move: a weaker bound
    runs.apart("ToMe 0.3", plain_tag, FANOUT_ATOL["same"])
    if counts["ToMe 0.3"]["tome_shape"] != 100:
        runs.problems.append(f"ToMe launched {counts['ToMe 0.3']} at "
                             f"{tome_shape}, not 100")
    runs.same("ToMe 0", plain_tag)
    # the virtual hypernetwork moves the image less than the one-batch
    # limits (max 0.060, mean 0.0075 on the card); it samples at plain's
    # batch, where without it the image is plain's to the bit: held
    # beyond the same-batch limits, as RescaleCFG in phase 23
    runs.apart("hypernetwork", plain_tag, FANOUT_ATOL["same"])
    runs.same("hypernetwork file", "hypernetwork")
    runs.same("hypernetwork 0", plain_tag)
    # the virtual fusers' gates are 0: the image is plain's
    runs.same("GLIGEN", plain_tag)
    runs.apart("GLIGEN gates", plain_tag, FANOUT_ATOL["same"])
    runs.same("GLIGEN gates again", "GLIGEN gates")
    runs.apart("style", plain_tag)
    if counts["style"]["style_cross"] != PHASE22_UNET_LAUNCHES // 2:
        runs.problems.append(f"style: {counts['style']['style_cross']} "
                             "cross-attentions over 85 tokens, not "
                             f"{PHASE22_UNET_LAUNCHES // 2}")
    runs.apart("embedding", plain_tag)
    runs.same("embedding missing", plain_tag)
    return runs.report(t_phase, PHASE24_BUDGET_S, report), runs.requests


PHASE25_SDXL = "sd_xl_base_1.0_inpainting_0.1.safetensors"
PHASE25_SD21 = "512-inpainting-ema.ckpt"
PHASE25_STEPS = 20
PHASE25_TILE = (512, 64)
# (image side, sm90 launches: blocks x 2 attentions x 20 steps, concat)
PHASE25_REQUESTS = {"sdxl": (PHASE25_SDXL, 1024, 2800, True),
                    "sd21": (PHASE25_SD21, 512, 640, False)}
# the tiled forms against the one-shot ones at 1024^2 (max, mean): the
# decode's on [0, 1] pixels, the encode's on scaled latents (PERF.md)
PHASE25_DECODE_LIMITS = (1.0, 0.2)
PHASE25_ENCODE_LIMITS = (1.0, 0.1)
PHASE25_BUDGET_S = 45.0
# phase 26: the second SD1.5 name (no file: a virtual fill), the files
# the 0.5 merge is saved to (in phase 22's models directory) and the
# animations' frame rate
PHASE26_B = "phase26_sd15_b.safetensors"
PHASE26_UNET = "phase26_unet"
PHASE26_CLIP = "phase26_clip"
PHASE26_VAE = "phase26_vae"
PHASE26_NATIVE = "phase26_native"
PHASE26_FPS = 6.0
PHASE26_BUDGET_S = 30.0


def phase25_anchoring(res):
    """The sampled latent against the encoded source under the latent
    mask: equal to the bit where it is 0, changed where it is 1."""
    import torch

    from comfyui_distributed_tpu_torch.ops.basic import (
        as_mask, image_mask_to_latent)
    out = res.outputs["11"][0]
    sampled = out["samples"].data
    source = res.outputs["10"][2]["samples"].data
    m = image_mask_to_latent(as_mask(out["noise_mask"], sampled.device),
                             sampled.shape[1], sampled.shape[2],
                             1).expand_as(sampled)
    keep, redo = m == 0, m == 1
    return {"kept_values": int(keep.sum()),
            "resampled_values": int(redo.sum()),
            "kept_equal_to_the_bit": bool(keep.any()) and bool(
                torch.equal(sampled[keep], source[keep])),
            "resampled_max_abs_change": float(
                (sampled[redo] - source[redo]).abs().max())
            if redo.any() else 0.0}


def phase25_tiled_vae(res):
    """The warm SDXL request's tiled decode and encode against their
    one-shot forms (VAEDecodeTiled at a tile of 1024 must fall through
    to VAEDecode to the bit), each timed on the card."""
    import torch

    from comfyui_distributed_tpu_torch.ops.base import OpContext, get_op

    ctx = OpContext(device=DEVICE)
    pipe, latent = res.outputs["1"][2], res.outputs["11"][0]
    pixels = res.outputs["2"][0]
    tile, overlap = PHASE25_TILE

    def timed(op, *args, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = get_op(op).execute(ctx, *args, **kw)[0]
        torch.cuda.synchronize()
        out = out["samples"] if isinstance(out, dict) else out
        return out.data, time.perf_counter() - t0

    def diff(a, b):
        d = (a - b).abs()
        return {"max": float(d.max()), "mean": float(d.mean())}

    plain, plain_s = timed("VAEDecode", latent, pipe)
    whole, whole_s = timed("VAEDecodeTiled", latent, pipe, 1024, overlap)
    tiled, tiled_s = timed("VAEDecodeTiled", latent, pipe, tile, overlap)
    enc, enc_s = timed("VAEEncode", pixels, pipe)
    enc_tiled, enc_tiled_s = timed("VAEEncodeTiled", pixels, pipe, tile,
                                   overlap)
    return {"decode_s": plain_s, "decode_tiled_1024_s": whole_s,
            "decode_tiled_s": tiled_s, "encode_s": enc_s,
            "encode_tiled_s": enc_tiled_s,
            "decode_tiled_1024_equal": bool(torch.equal(whole, plain)),
            "decode_tiled": diff(tiled, plain),
            "encode_tiled": diff(enc_tiled, enc)}


def inpaint_composites(shape_counts, rows):
    """Phase 25 (module docstring): SDXL inpaint at 1024^2 cold and warm,
    SD2.1 inpaint at 512^2 cold, from virtual weights with the reuse
    plane off; (report, requests)."""
    import gc

    import torch

    from comfyui_distributed_tpu_torch.models import registry

    def release():
        registry.clear_pipeline_cache()
        gc.collect()
        torch.cuda.empty_cache()

    t_phase = time.perf_counter()
    input_dir = tempfile.mkdtemp(prefix="chip_smoke_phase25_in_")
    dirs = {"input_dir": input_dir, "models_dir": None}
    runs = PhaseRequests(25, dirs, shape_counts, rows)
    prev = {k: os.environ.get(k) for k in ("DTPU_CACHE",
                                            "DTPU_DEFAULT_FAMILY")}
    os.environ["DTPU_CACHE"] = "0"
    os.environ.pop("DTPU_DEFAULT_FAMILY", None)
    report = {"anchoring": {}, "families": {}}
    results = {}
    try:
        t0 = time.perf_counter()
        for side in sorted({r[1] for r in PHASE25_REQUESTS.values()}):
            with open(os.path.join(input_dir, f"src16_{side}.png"),
                      "wb") as f:
                f.write(png16_rgba(side, side, side))
        report["inputs_write_s"] = time.perf_counter() - t0
        tile, overlap = PHASE25_TILE
        for key, runs_of in (("sdxl", ("cold", "warm")), ("sd21", ("cold",))):
            ckpt, side, want, concat = PHASE25_REQUESTS[key]
            doc = composite_doc(ckpt, f"src16_{side}.png", PHASE25_STEPS,
                                tile, overlap, concat=concat)
            release()
            for run in runs_of:
                tag = f"{key} {run}"
                runs.run(tag, doc, want, sampler_nodes=("11",),
                         results=results)
                if runs.images[tag].shape != (side, side, 3):
                    fail(f"phase 25 {tag}: image {runs.images[tag].shape}")
                report["anchoring"][tag] = a = phase25_anchoring(
                    results[tag])
                if not (a["kept_equal_to_the_bit"]
                        and a["resampled_max_abs_change"] > 0.0):
                    runs.problems.append(f"{tag}: anchoring {a}")
                report["families"][tag] = \
                    results[tag].outputs["1"][0].family.name
                if run == "cold":
                    results.pop(tag)
            if key == "sdxl":
                runs.same("sdxl warm", "sdxl cold")
                report["tiled_vae"] = v = phase25_tiled_vae(
                    results.pop("sdxl warm"))
                if not v["decode_tiled_1024_equal"]:
                    runs.problems.append("VAEDecodeTiled at 1024 differs "
                                         "from VAEDecode")
                for name, (mx, mean) in (
                        ("decode_tiled", PHASE25_DECODE_LIMITS),
                        ("encode_tiled", PHASE25_ENCODE_LIMITS)):
                    d = v[name]
                    if not (d["max"] <= mx and d["mean"] <= mean):
                        runs.problems.append(f"{name} {d} beyond "
                                             f"({mx}, {mean})")
        if report["families"] != {"sdxl cold": "sdxl_inpaint",
                                  "sdxl warm": "sdxl_inpaint",
                                  "sd21 cold": "sd21_inpaint"}:
            runs.problems.append(f"families {report['families']}")
    finally:
        results.clear()
        for k, v in prev.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        release()
        shutil.rmtree(input_dir, ignore_errors=True)
    return runs.report(t_phase, PHASE25_BUDGET_S, report), runs.requests


def phase26_doc(base, variant):
    """Phase 22's plain graph (``base``: A at node 4) with B at node 20
    and ``variant``'s merge, files or loaders; (doc, sm90 launches)."""
    doc = copy.deepcopy(base)
    doc["20"] = _node("CheckpointLoaderSimple", ckpt_name=PHASE26_B)
    model = {"B plain": ["20", 0]}
    if variant.startswith("merge "):
        doc["21"] = _node("ModelMergeSimple", model1=["4", 0],
                          model2=["20", 0], ratio=float(variant[6:]))
        model[variant] = ["21", 0]
    if variant == "merge 0.5":
        doc["22"] = _node("SaveLatent", samples=["3", 0],
                          filename_prefix="phase26/latent")
        doc["23"] = _node("ModelSave", model=["21", 0],
                          filename_prefix=f"diffusion_models/{PHASE26_UNET}")
        doc["24"] = _node("CLIPSave", clip=["4", 1],
                          filename_prefix=f"clip/{PHASE26_CLIP}")
        doc["25"] = _node("VAESave", vae=["4", 2],
                          filename_prefix=f"vae/{PHASE26_VAE}")
    elif variant == "subtract add":
        doc["21"] = _node("ModelMergeSubtract", model1=["4", 0],
                          model2=["20", 0], multiplier=1.0)
        doc["22"] = _node("ModelMergeAdd", model1=["21", 0],
                          model2=["20", 0])
        model[variant] = ["22", 0]
    elif variant == "blocks 1 0 1":
        doc["21"] = _node("ModelMergeBlocks", model1=["4", 0],
                          model2=["20", 0], input=1.0, middle=0.0, out=1.0)
        model[variant] = ["21", 0]
    elif variant == "clip 0.5":
        doc["21"] = _node("CLIPMergeSimple", clip1=["4", 1],
                          clip2=["20", 1], ratio=0.5)
        doc["6"]["inputs"]["clip"] = doc["7"]["inputs"]["clip"] = ["21", 0]
    elif variant == "files":
        del doc["4"], doc["20"]
        doc["30"] = _node("UNETLoader",
                          unet_name=f"{PHASE26_UNET}.safetensors")
        doc["31"] = _node("CLIPLoader",
                          clip_name=f"{PHASE26_CLIP}.safetensors",
                          type="stable_diffusion")
        doc["32"] = _node("VAELoader",
                          vae_name=f"vae/{PHASE26_VAE}.safetensors")
        model[variant] = ["30", 0]
        doc["6"]["inputs"]["clip"] = doc["7"]["inputs"]["clip"] = ["31", 0]
        doc["8"]["inputs"]["vae"] = ["32", 0]
    elif variant == "native":
        del doc["20"]
        doc["4"]["inputs"]["ckpt_name"] = PHASE26_NATIVE
    if variant in model:
        doc["3"]["inputs"]["model"] = model[variant]
    return doc, PHASE22_UNET_LAUNCHES


def phase26_frames_expected(frames):
    """The frame count and durations a WEBP or APNG of ``frames`` holds:
    a frame equal to the one before adds its duration to it."""
    import numpy as np
    ms = int(1000.0 / PHASE26_FPS)
    durations = []
    for i, f in enumerate(frames):
        if i and np.array_equal(f, frames[i - 1]):
            durations[-1] += ms
        else:
            durations.append(ms)
    return len(durations), durations


PHASE26_ANIMATIONS = (("apng", "SaveAnimatedPNG", {}, "png"),
                      ("webp lossless", "SaveAnimatedWEBP", {}, "webp"),
                      ("webp lossy", "SaveAnimatedWEBP",
                       {"lossless": False, "quality": 80}, "webp"))


def merges_and_files(dirs, plain, shape_counts, rows):
    """Phase 26 (module docstring) in phase 22's process, on its SD1.5
    file, seed and graph, with the reuse plane off; ``plain`` is phase
    22's plain image: (report, requests)."""
    import numpy as np
    import torch

    from comfyui_distributed_tpu_torch.models import registry
    from comfyui_distributed_tpu_torch.ops.base import (DeviceImage,
                                                        OpContext, get_op)
    from comfyui_distributed_tpu_torch.ops.basic import merge_block_section
    from comfyui_distributed_tpu_torch.runtime import checkpointing
    from comfyui_distributed_tpu_torch.utils.image import read_png, to_uint8
    from comfyui_distributed_tpu_torch.utils.webp import webp_frames
    from comfyui_distributed_tpu_torch.workflow import WorkflowExecutor

    t_phase = time.perf_counter()
    models_dir = dirs["models_dir"]
    # the savers write where the loaders read
    dirs = dict(dirs, output_dir=models_dir)
    runs = PhaseRequests(26, dirs, shape_counts, rows)
    runs.images["A plain"] = plain
    base = phase22_doc(dirs["ckpt"])
    report = {"files": {}}
    results = {}
    prev = os.environ.get("DTPU_CACHE")
    os.environ["DTPU_CACHE"] = "0"
    anim_dir = tempfile.mkdtemp(prefix="chip_smoke_phase26_anim_")
    try:
        for variant in ("B plain", "merge 1.0", "merge 0.0", "merge 0.5",
                        "subtract add", "blocks 1 0 1", "clip 0.5"):
            doc, want = phase26_doc(base, variant)
            runs.run(variant, doc, want, results=results)
        a = registry.load_pipeline(dirs["ckpt"], models_dir=models_dir,
                                   device=DEVICE)
        b = registry.load_pipeline(PHASE26_B, models_dir=models_dir,
                                   device=DEVICE)
        # ModelMergeBlocks(1, 0, 1): every middle-block weight is B's and
        # every other A's, to the bit
        (blocks,) = get_op("ModelMergeBlocks").execute(
            OpContext(device=DEVICE), a, b, input=1.0, middle=0.0, out=1.0)
        pa, pb = dict(a.unet.named_parameters()), \
            dict(b.unet.named_parameters())
        wrong = [n for n, w in blocks.unet.named_parameters()
                 if not torch.equal(w, (pb if merge_block_section(n)
                                        == "middle" else pa)[n])]
        report["blocks_weights"] = {
            "middle": sum(merge_block_section(n) == "middle" for n in pa),
            "all": len(pa), "wrong": wrong[:5]}
        if wrong:
            runs.problems.append(f"ModelMergeBlocks(1, 0, 1): {len(wrong)} "
                                 f"weights not from their section's model")
        del blocks, pa, pb
        # the bytes a merge adds at its peak, a fresh ratio
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        get_op("ModelMergeSimple").execute(OpContext(device=DEVICE), a, b,
                                           ratio=0.25)
        torch.cuda.synchronize()
        report["merge_alone"] = {
            "seconds": time.perf_counter() - t0,
            "peak_extra_bytes": torch.cuda.max_memory_allocated() - before,
            "kept_bytes": torch.cuda.memory_allocated() - before}
        # the 0.5 merge natively, then read back by its name
        (merged,) = get_op("ModelMergeSimple").execute(
            OpContext(device=DEVICE), a, b, ratio=0.5)
        native = os.path.join(models_dir, PHASE26_NATIVE)
        t0 = time.perf_counter()
        checkpointing.save_pipeline_checkpoint(
            native, merged.family.name, merged.unet, merged.clip_models,
            merged.vae)
        native_write_s = time.perf_counter() - t0
        del a, b, merged
        for variant in ("files", "native"):
            doc, want = phase26_doc(base, variant)
            runs.run(variant, doc, want, results=results)
        # the 0.5 merge's latent through LoadLatent and VAEDecode
        latent = os.path.join(models_dir, "phase26", "latent_00000.latent")
        t0 = time.perf_counter()
        res = WorkflowExecutor(OpContext(
            device=DEVICE, models_dir=models_dir)).execute({
                "4": _node("CheckpointLoaderSimple", ckpt_name=dirs["ckpt"]),
                "1": _node("LoadLatent", latent=latent),
                "2": _node("VAEDecode", samples=["1", 0], vae=["4", 2]),
                "3": _node("PreviewImage", images=["2", 0])})
        torch.cuda.synchronize()
        runs.images["latent"] = res.image_batch[0]
        report["files"]["latent"] = {
            "write_s": results["merge 0.5"].timings["22"],
            "load_s": res.timings["1"], "decode_s": res.timings["2"],
            "seconds": time.perf_counter() - t0,
            "bytes": os.path.getsize(latent)}
        frames = np.stack([runs.images[t] for t in (
            "merge 1.0", "merge 0.0", "merge 0.5", "subtract add")])
        quant = {"side": int(frames.shape[1])}
        for dither in ("none", "floyd-steinberg"):
            src = frames[2:3]
            outs = {}
            for dev in (DEVICE, "cpu"):
                t0 = time.perf_counter()
                (q,) = get_op("ImageQuantize").execute(
                    OpContext(device=dev),
                    DeviceImage(torch.from_numpy(src).to(dev)), colors=256,
                    dither=dither)
                outs[dev] = q.to_host()
                quant[f"{dither} {dev} s"] = time.perf_counter() - t0
            equal = np.array_equal(outs[DEVICE], outs["cpu"])
            quant[f"{dither} equal"] = equal
            quant[f"{dither} colours"] = int(len(np.unique(
                outs[DEVICE].reshape(-1, 3), axis=0)))
            if not equal:
                runs.problems.append(f"ImageQuantize ({dither}): the card's "
                                     "output differs from the CPU's")
        report["quantize"] = quant
        # the four images from the card, each animation written whole
        anims = {}
        card_frames = DeviceImage(torch.from_numpy(frames).to(DEVICE))
        want_n, want_ms = phase26_frames_expected(to_uint8(frames))
        for tag, op, widgets, ext in PHASE26_ANIMATIONS:
            t0 = time.perf_counter()
            get_op(op).execute(
                OpContext(device=DEVICE, output_dir=anim_dir), card_frames,
                filename_prefix=tag.replace(" ", "_"), fps=PHASE26_FPS,
                **widgets)
            anims[tag] = {"seconds": time.perf_counter() - t0}
            name = f"{tag.replace(' ', '_')}_00000.{ext}"
            with open(os.path.join(anim_dir, name), "rb") as f:
                data = f.read()
            anims[tag]["bytes"] = len(data)
            if ext == "png":
                ok = np.array_equal(read_png(data).pixels,
                                    to_uint8(frames[0]))
                anims[tag]["first_frame_equal"] = ok
                if not ok:
                    runs.problems.append("the APNG's default image is not "
                                         "the first frame")
            else:
                n, durations, loop = webp_frames(data)
                anims[tag].update(frames=n, durations=durations, loop=loop)
                if (n, durations, loop) != (want_n, want_ms, 0):
                    runs.problems.append(
                        f"{tag}: {n} frames of {durations} ms, loop "
                        f"{loop}; expected {want_n} of {want_ms}, loop 0")
        report["animations"] = anims
    finally:
        shutil.rmtree(anim_dir, ignore_errors=True)
        if prev is None:
            os.environ.pop("DTPU_CACHE", None)
        else:
            os.environ["DTPU_CACHE"] = prev
    runs.same("merge 1.0", "A plain")
    runs.same("merge 0.0", "B plain")
    runs.apart("merge 0.5", "A plain")
    runs.apart("merge 0.5", "B plain")
    runs.within("subtract add", "A plain")
    # swapping the middle block alone moves the virtual-weight image less
    # than the one-batch limits (max 0.060, mean 0.0070 on an NVIDIA H100
    # 80GB HBM3 at 700.00 W): it samples at plain's batch, and is held
    # beyond the same-batch limits, its weights to the bit above
    runs.apart("blocks 1 0 1", "A plain", FANOUT_ATOL["same"])
    runs.apart("clip 0.5", "A plain")
    for tag in ("files", "native", "latent"):
        runs.same(tag, "merge 0.5")
    t05, tf = results["merge 0.5"].timings, results["files"].timings
    for kind, (saver, loader, name) in {
            "unet": ("23", "30", f"diffusion_models/{PHASE26_UNET}"),
            "clip": ("24", "31", f"clip/{PHASE26_CLIP}"),
            "vae": ("25", "32", f"vae/{PHASE26_VAE}")}.items():
        report["files"][kind] = {
            "write_s": t05[saver], "load_s": tf[loader],
            "bytes": os.path.getsize(os.path.join(
                models_dir, f"{name}.safetensors"))}
    report["files"]["native"] = {
        "write_s": native_write_s,
        "load_s": results["native"].timings["4"],
        "bytes": sum(os.path.getsize(os.path.join(d, f))
                     for d, _, fs in os.walk(native) for f in fs),
        "lone_files_load_s": sum(tf[k] for k in ("30", "31", "32"))}
    # each merge node's own seconds (subtract add: both of its merges)
    report["merge_seconds"] = {
        tag: round(sum(results[tag].timings[k] for k in (
            ("21", "22") if tag == "subtract add" else ("21",))), 4)
        for tag in ("merge 1.0", "merge 0.0", "merge 0.5", "subtract add",
                    "blocks 1 0 1", "clip 0.5")}
    return runs.report(t_phase, PHASE26_BUDGET_S, report), runs.requests


def urllib_text(url):
    import urllib.request
    with urllib.request.urlopen(url, timeout=30) as r:
        return r.read().decode()


def main() -> int:
    global SERVER_MODELS_DIR
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

    def patch_shapes():
        t0 = time.perf_counter()
        out = (phase22_kernel_shapes(), phase23_kernel_shapes(),
               phase24_kernel_shapes())
        return out, time.perf_counter() - t0

    # phases 22-24's attention shapes come from meta-device forwards of
    # the host's CPU, which run while nvcc builds the kernels
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        shapes_job = pool.submit(patch_shapes)
        report = build.timed_build_all(force=True)
        t0 = time.perf_counter()
        patched, shapes_s = shapes_job.result()
        shapes_wait_s = time.perf_counter() - t0
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
        # phase 19: k coalesced SDXL prompts at B = 2k, k = 4 (its burst)
        # and 8 (DTPU_MAX_COALESCE's default); phase 20: a continuous-
        # batching bucket at pad 2 (B = 4)
        *[(b, n, m, h, 64, bf, f"SDXL coalesced B = {b} {kind}"
           if b != 4 else f"SDXL continuous batching pad 2 {kind}")
          for b in (4, 8, 16)
          for n, m, h, kind in (
              (4096, 4096, 10, "self 64x64"), (1024, 1024, 20, "self 32x32"),
              (4096, 77, 10, "cross 64x64"), (1024, 77, 20, "cross 32x32"))],
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
        # phase 25: SDXL inpaint's cross-attentions over ConditioningConcat's
        # 154 tokens, and SD2.1 inpaint at 512^2 (5/10/20 heads of 64)
        (2, 4096, 154, 10, 64, bf, "SDXL concat cross 64x64 latent"),
        (2, 1024, 154, 20, 64, bf, "SDXL concat cross 32x32 latent"),
        (2, 4096, 4096, 5, 64, bf, "SD2.1 512^2 self 64x64 latent"),
        (2, 4096, 77, 5, 64, bf, "SD2.1 512^2 cross 64x64 latent"),
        (2, 1024, 1024, 10, 64, bf, "SD2.1 512^2 self 32x32 latent"),
        (2, 1024, 77, 10, 64, bf, "SD2.1 512^2 cross 32x32 latent"),
        (2, 256, 256, 20, 64, bf, "SD2.1 512^2 self 16x16 latent"),
        (2, 256, 77, 20, 64, bf, "SD2.1 512^2 cross 16x16 latent"),
        (2, 64, 64, 20, 64, bf, "SD2.1 512^2 mid self 8x8 latent"),
        (2, 64, 77, 20, 64, bf, "SD2.1 512^2 mid cross 8x8 latent"),
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
    # phase 22: HyperTile's folded tiles and deep shrink's shrunk levels;
    # phase 23: the 3-row guidances at B = 3, SAG's uncond call and an
    # SDTurbo step at B = 1; phase 24: ToMe's merged queries, the GLIGEN
    # fusers and the style tokens' longer context
    for extra in patched:
        have = {r[:6] for r in main_shapes}
        new = [r for r in extra if r[:6] not in have]
        main_shapes += new
    rows = check_kernel(main_shapes + extra_shapes)
    emit("kernel_checks", rows)
    # the last loop's rows are phase 24's own
    p24 = [r for r in rows if r["role"] in {n[6] for n in new}]
    emit("phase3", {
        "rows": len(rows), "seconds": sum(r["seconds"] for r in rows),
        "rounds_saved_s": sum(r["rounds_saved_s"] for r in rows),
        "patch_shapes_s": shapes_s, "patch_shapes_wait_s": shapes_wait_s,
        "phase24_rows": [r["role"] for r in p24],
        "phase24_rows_s": sum(r["seconds"] for r in p24)})

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
        # phase 19's in-process references while SDXL, then SD1.5, is
        # warm here (its own launches are not counted)
        p19_refs, p19_serial_s = phase19_sdxl_references(docs)
        requests += run_requests("img2img", docs["img2img"], SEEDS[:1],
                                 input_dir, shape_counts)
        upscaled = {}
        requests += run_requests("upscale", docs["upscale"], (42, 43),
                                 input_dir, shape_counts, upscaled)
        p19_tiles = phase19_tile_reference(docs)
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
        disk_report, disk_reqs, kept_dir = from_disk(
            docs, input_dir, shape_counts, sdxl_img, upscaled[42])
        if kept_dir is not None:
            SERVER_MODELS_DIR = kept_dir
            atexit.register(shutil.rmtree, kept_dir, True)
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
        # each phase of 14-16 launches its servers while the phase
        # before it runs
        phase14 = fault_drills(docs, inpaint_dir, upscaled[42], rows)
        next(phase14)
        report13, reqs13 = phase13(docs, phase13_dir, shape_counts, rows)
        requests += reqs13
        emit("phase13_report", report13)
        phase15 = worker_management(docs, txt_refs, rows)
        next(phase15)
        report14, inpaint_refs = resumed(phase14)
        emit("phase14", report14)
        phase16 = master_failover(
            docs, inpaint_dir, upscaled[42], inpaint_refs,
            fanout_report["seconds"]["upscale warm"], rows)
        next(phase16)
        report15, interrupted = resumed(phase15)
        shape_counts.update(interrupted["shapes"])
        requests.append(interrupted)
        emit("phase15", report15)
        report16, failover = resumed(phase16)
        shape_counts.update(failover["shapes"])
        requests.append(failover)
        emit("phase16", report16)
        emit("phase17", {"card": card_line(), **report17})
        report18, sharded = sharded_masters(docs, inpaint_dir, upscaled[42],
                                            inpaint_refs, rows)
        shape_counts.update(sharded["shapes"])
        requests.append(sharded)
        emit("phase18", report18)
    # phase 20's server starts while phase 19 runs
    phase20 = continuous_batching(docs, rows, p19_refs)
    next(phase20)
    report19, dispatched = default_dispatch(
        docs, rows, {"sdxl": p19_refs, "serial_s": p19_serial_s,
                     "tiles": p19_tiles})
    shape_counts.update(dispatched["shapes"])
    requests.append(dispatched)
    emit("phase19", report19)
    # phase 21's master starts while phase 20 runs
    phase21 = elastic_fleet(docs, txt_refs, rows)
    next(phase21)
    report20, batched = resumed(phase20)
    shape_counts.update(batched["shapes"])
    requests.append(batched)
    emit("phase20", report20)
    report21, scaled = resumed(phase21)
    shape_counts.update(scaled["shapes"])
    requests.append(scaled)
    emit("phase21", report21)
    dirs22 = sd15_phase_dirs(docs)
    try:
        report22, reqs22, plain22 = controlnet_and_patches(
            dirs22, shape_counts, rows)
        requests += reqs22
        emit("phase22", report22)
        report23, reqs23 = custom_sampling(dirs22, plain22, shape_counts,
                                           rows)
        requests += reqs23
        emit("phase23", report23)
        report24, reqs24 = unet_addons(dirs22, plain22, shape_counts, rows)
        requests += reqs24
        emit("phase24", report24)
        report26, reqs26 = merges_and_files(dirs22, plain22, shape_counts,
                                            rows)
        requests += reqs26
        emit("phase26", report26)
    finally:
        release_phase_dirs(dirs22)
    report25, reqs25 = inpaint_composites(shape_counts, rows)
    requests += reqs25
    emit("phase25", report25)
    emit("timeline", TIMELINE)
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
