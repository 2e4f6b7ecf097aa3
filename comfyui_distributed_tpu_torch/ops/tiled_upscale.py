"""UltimateSDUpscaleDistributed: the counterpart of
``comfyui_distributed_tpu/ops/tiled_upscale.py``.

The upscaled image is cut into a row-major grid of tiles, each widened
by ``padding`` (edges repeat) and resized to the tile size; tiles are
refined as one batch (VAE-encode -> sampler at ``denoise`` -> VAE-decode,
tile ``i`` seeded ``seed + i`` with fold-in index 0, so a tile's result
does not depend on where it runs); each refined window is resized back,
cut to its clamped extraction region and alpha-blended into the image in
tile order through its blurred mask.  Every step but the masks (host
uint8, cached by geometry) runs on the run's device.  Three modes:

- one process (no ``multi_job_id``): every tile in one batch;
- a worker of the HTTP fan-out: it refines its contiguous range of
  ``tiling.partition_tiles`` (found by its own id in
  ``enabled_worker_ids``, or the explicit ``tile_indices``) and POSTs
  each tile, cut to its extraction region, to the master's
  ``/distributed/tile_complete``, tile k + 1 copied to the host and
  encoded while tile k is on the wire;
- the master: it refines ``parts[0]`` while the workers run, then drains
  the tile queue and blends every tile in index order.  With the control
  plane (``ctx.ledger``) the job's tiles are ledger units: the drain
  ends when none is pending, a dead owner's tiles go to a healthy worker
  (the exact unit list) or are refined on the master, overdue tiles are
  hedged on the master, the first completion of a tile wins, and tiles
  still pending at the end are refined on the master (``reassign``),
  kept as the image's pixels (``partial``) or raise (``fail``).  Without
  one, a deadline keeps what arrived: missing tiles keep the image's
  pixels.  With the write-ahead log each winning tile (the master's
  window, a worker's tile) is written to the unit store before it checks
  in (``wal_spill`` and ``wal_append`` seconds on the prompt line); a
  job a restarted master recovers blends the tiles that checked in
  before the crash from there, refines only its own pending tiles, and
  redispatches the workers' pending tiles at once.

Tracing, as in the JAX package: a worker's tile copies to the host are
``d2h`` stages and its encodes ``encode`` stages (on the pool thread, in
the job's span and transfer context), its POSTs ``upload`` stages with
the ``traceparent``, and its last tile ships its spans of the job.  The
master's drain is a ``collect`` span; a redispatch or a refine of lost
tiles on the master a ``reassign`` span, a hedge a ``hedge`` span.

Regional conditionings (siblings, area masks, timestep ranges) refine
with each entry's canvas mask cropped through the same padded tile
windows as the pixels.  A PerpNeg-patched pipeline refines its tiles
with its empty conditioning as the third row block (its tokens cut,
repeated or zero-padded to the prompt's), and with the primary prompts
only when the conditionings are regional, which it logs.

Changed-tile skipping (the reuse plane's tile tier, ``runtime/reuse.py``):
in one process and on the master, every extracted tile is hashed with
the pipeline's identity, the conditionings, the refine parameters and
its index before any refine; a tile whose key is stored takes its stored
refined window (the span's ``tiles_skipped`` and the process counter
count it) and only the others are refined.  On the master the cached
tiles check in to the ledger at once (owner ``cache``), so the drain
waits for the dirty tiles alone.  The tier is armed for plain
conditionings only (no regional entries, concat channels or unCLIP
vector) and with ``DTPU_CACHE`` on.
"""

from __future__ import annotations

import concurrent.futures
import json
import queue
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from comfyui_distributed_tpu_torch.ops import tiling
from comfyui_distributed_tpu_torch.ops.base import (
    CONTROL,
    Conditioning,
    DeviceImage,
    Op,
    OpContext,
    as_device_image,
    as_image_array,
    register_op,
    stage,
)
from comfyui_distributed_tpu_torch.ops.basic import (
    _sdxl_vector_cond,
    adm_cond_source,
    align_cond_tokens,
    cond_token_align,
    entry_sigma_range,
    image_mask_to_latent,
    materialize_area_mask,
)
from comfyui_distributed_tpu_torch.ops.distributed import (
    add_stage_seconds,
    pipelined_uploads,
    wire_payload,
)
from comfyui_distributed_tpu_torch.runtime import cluster as cluster_mod
from comfyui_distributed_tpu_torch.runtime import reuse as reuse_mod
from comfyui_distributed_tpu_torch.utils import constants as C
from comfyui_distributed_tpu_torch.utils import trace as trace_mod
from comfyui_distributed_tpu_torch.utils.log import log
from comfyui_distributed_tpu_torch.utils.image import resize_image
from comfyui_distributed_tpu_torch.utils.net import (
    FormData,
    in_context,
    negotiate_wire_format,
    post_form_with_retry,
    wire_codec,
)


def _is_regional(c: Conditioning) -> bool:
    return bool(c.siblings or c.area_mask is not None
                or c.timestep_range is not None)


def _align_to(c: torch.Tensor, tm: int) -> torch.Tensor:
    """A context [1, T, C] brought to ``tm`` tokens: repeated whole when T
    divides ``tm``, cut when longer, zero-padded when shorter (the JAX
    tile refine's rule for PerpNeg's empty conditioning)."""
    t = int(c.shape[1])
    if t == tm:
        return c
    if tm % t == 0:
        return c.repeat(1, tm // t, 1)
    if t > tm:
        return c[:, :tm]
    return torch.nn.functional.pad(c, (0, 0, 0, tm - t))


def _tile_cache_eligible(positive: Conditioning, negative: Conditioning,
                         pipe=None) -> bool:
    """The tile tier is armed for a plain refine only: canvas-wide single
    conditionings (a regional mask resolves by the tile's position,
    which its content key does not hold), no concat channels, unCLIP
    vector, ControlNet or GLIGEN grounding, and a pipeline without a
    sampling patch the key does not hold: deep shrink, SAG, PerpNeg,
    RescaleCFG or a hypernetwork.  The refine itself passes no control
    to the tile sampling, as the JAX package's does not."""
    if getattr(pipe, "perp_neg_cond", None) is not None:
        return False
    for attr in ("sag_params", "hypernets", "deep_shrink_spec",
                 "cfg_rescale"):
        if getattr(pipe, attr, None):
            return False
    return not any(_is_regional(c) or c.concat_latent is not None
                   or c.unclip is not None or c.control is not None
                   or c.gligen is not None
                   for c in (positive, negative))


def _window_payload(window: torch.Tensor):
    """A refined window's unit-store payload, made only when the ledger
    spills it (the copy to the host is part of the spill)."""
    return lambda: ([window.detach().float().cpu().numpy()],
                    {"form": "window"})


def _tile_payload(item: Dict[str, Any]):
    """A worker's tile as the unit store keeps it: the array at its
    extraction region's size and where it goes."""
    return lambda: ([as_image_array(item["tensor"])],
                    {"form": "tile", **{k: item[k] for k in (
                        "x", "y", "extracted_width", "extracted_height",
                        "padding")}})


@register_op
class UltimateSDUpscaleDistributed(Op):
    TYPE = "UltimateSDUpscaleDistributed"
    WIDGETS = ["seed", CONTROL, "steps", "cfg", "sampler_name", "scheduler",
               "denoise", "tile_width", "tile_height", "padding", "mask_blur",
               "force_uniform_tiles"]
    DEFAULTS = {"steps": 20, "cfg": 8.0, "denoise": 0.5, "tile_width": 512,
                "tile_height": 512, "padding": 32, "mask_blur": 8,
                "force_uniform_tiles": True}
    HIDDEN = ["multi_job_id", "is_worker", "master_url",
              "enabled_worker_ids", "worker_id", "tile_indices",
              "dispatch_attempt"]

    def execute(self, ctx: OpContext, upscaled_image, model,
                positive: Conditioning, negative: Conditioning, vae,
                seed, steps, cfg, sampler_name, scheduler, denoise,
                tile_width, tile_height, padding, mask_blur,
                force_uniform_tiles=True, multi_job_id="", is_worker=None,
                master_url="", enabled_worker_ids="[]", worker_id="",
                tile_indices="", dispatch_attempt=0):
        ctx.check_interrupt()
        image = as_device_image(upscaled_image, model.device)
        p = dict(seed=int(seed), steps=int(steps), cfg=float(cfg),
                 sampler_name=str(sampler_name), scheduler=str(scheduler),
                 denoise=float(denoise),
                 tile_w=tiling.round_to_multiple(int(tile_width)),
                 tile_h=tiling.round_to_multiple(int(tile_height)),
                 padding=int(padding), mask_blur=int(mask_blur))
        is_worker = ctx.is_worker if is_worker is None else is_worker
        if multi_job_id and is_worker:
            self._run_worker(ctx, image, model, positive, negative, p,
                             multi_job_id, master_url or ctx.master_url,
                             worker_id or ctx.worker_id, enabled_worker_ids,
                             tile_indices, int(dispatch_attempt or 0))
            return (DeviceImage(image),)
        if multi_job_id:
            return (DeviceImage(self._run_master_http(
                ctx, image, model, positive, negative, p, multi_job_id,
                enabled_worker_ids)),)
        return (DeviceImage(self._run(ctx, image, model, positive, negative,
                                      p)),)

    def _run(self, ctx: OpContext, image: torch.Tensor, pipe,
             positive: Conditioning, negative: Conditioning,
             p: Dict[str, Any]) -> torch.Tensor:
        h, w = image.shape[1:3]
        all_tiles = tiling.calculate_tiles(w, h, p["tile_w"], p["tile_h"])
        windows: Dict[int, torch.Tensor] = {}
        keys = self._tile_cache_probe(ctx, image, all_tiles, pipe, positive,
                                      negative, p, windows)
        dirty = [i for i in range(len(all_tiles)) if i not in windows]
        if windows:
            log(f"tiled upscale: {len(windows)}/{len(all_tiles)} tiles "
                f"unchanged (cache hits); refining {len(dirty)}")
        if dirty:
            fresh = self._refine_tiles(ctx, pipe, image, all_tiles, dirty,
                                       positive, negative, p)
            self._tile_cache_store(keys, fresh)
            windows.update(fresh)
        with stage(ctx, "tile_blend"):
            return self._blend_all(image, windows, all_tiles, p)

    # --- changed-tile skipping -----------------------------------------------

    def _tile_cache_probe(self, ctx: OpContext, image: torch.Tensor,
                          all_tiles: List[Tuple[int, int]], pipe,
                          positive: Conditioning, negative: Conditioning,
                          p: Dict[str, Any],
                          windows: Dict[int, torch.Tensor]
                          ) -> Optional[Dict[int, str]]:
        """Look every tile up in the tile tier: a tile's key is the
        pipeline's identity, the conditionings' fingerprint, the refine
        parameters, its index (its seed is ``seed + index``) and its
        extracted pixels.  Hits go into ``windows`` (the stored refined
        window, as the run that stored it blended it) and count in the
        ``tiles_skipped`` counter and span attribute.  Returns tile index
        -> key for storing the misses, or None when the tier is off or
        this refine is not eligible."""
        if not reuse_mod.reuse_enabled() \
                or not _tile_cache_eligible(positive, negative, pipe):
            return None
        plane = reuse_mod.get_reuse()
        salt = plane.model_salt(pipe)
        if salt is None:
            return None
        with stage(ctx, "tile_extract"):
            tiles = tiling.extract_tiles(image, all_tiles, p["tile_w"],
                                         p["tile_h"], p["padding"])
        indices = list(range(len(all_tiles)))
        keys = dict(zip(indices, reuse_mod.tile_keys(
            salt, reuse_mod.conditioning_fingerprint(positive, negative),
            p, tiles, indices)))
        hits = 0
        for i, key in keys.items():
            win = plane.tiles.get(key)
            if win is not None:
                windows[i] = win
                hits += 1
        if hits:
            trace_mod.GLOBAL_COUNTERS.bump("tiles_skipped", hits)
            sp = trace_mod.current_span()
            if sp is not None:
                sp.attrs["tiles_skipped"] = \
                    int(sp.attrs.get("tiles_skipped", 0)) + hits
        return keys

    @staticmethod
    def _tile_cache_store(keys: Optional[Dict[int, str]],
                          windows: Dict[int, torch.Tensor]) -> None:
        """Store refined windows under their keys (each its own copy, so
        an entry never holds a whole batch's storage)."""
        if keys is None:
            return
        plane = reuse_mod.get_reuse()
        for i, win in windows.items():
            key = keys.get(int(i))
            if key is not None:
                win = win.clone()
                plane.tiles.put(key, win, reuse_mod.tile_nbytes(win))

    def _refine_tiles(self, ctx: OpContext, pipe, image: torch.Tensor,
                      all_tiles: List[Tuple[int, int]],
                      indices: Sequence[int], positive: Conditioning,
                      negative: Conditioning,
                      p: Dict[str, Any]) -> Dict[int, torch.Tensor]:
        """Extract and refine tiles ``indices`` as one batch -> tile index
        -> refined window at the padded window size."""
        with stage(ctx, "tile_extract"):
            tiles = tiling.extract_tiles(image, [all_tiles[i] for i in indices],
                                         p["tile_w"], p["tile_h"],
                                         p["padding"])
        refined = self._refine_batch(
            ctx, pipe, tiles, indices, positive, negative, p,
            [all_tiles[i] for i in indices], (image.shape[2], image.shape[1]))
        pad = p["padding"]
        if pad > 0:
            with stage(ctx, "tile_resize"):
                refined = resize_image(refined, p["tile_w"] + 2 * pad,
                                       p["tile_h"] + 2 * pad)
        return {int(i): refined[k] for k, i in enumerate(indices)}

    def _canvas_area_mask(self, entry: Conditioning, img_w: int, img_h: int,
                          device) -> Optional[torch.Tensor]:
        """An entry's area -> its weights over the whole canvas [1, H, W,
        1], or None: resolved against this canvas's latent (a rectangle
        in its //8 units or fractions), row 0 of a batched mask, resized
        bilinear to the canvas and clipped to [0, 1]."""
        if entry.area_mask is None:
            return None
        cm = materialize_area_mask(entry, max(img_h // 8, 1),
                                   max(img_w // 8, 1), 1, device)[:1]
        return resize_image(cm, img_w, img_h, "bilinear").clamp(0.0, 1.0)

    def _regional_entries(self, pipe, src: Sequence[Conditioning], n: int,
                          positions: Sequence[Tuple[int, int]],
                          p: Dict[str, Any], img_size: Tuple[int, int],
                          tiles_hw: Tuple[int, int], t_align: int,
                          positive: Conditioning):
        """One CFG side's conditionings -> the sampler's entries for a
        tile batch, each canvas mask cut through the tiles' padded
        windows (``tiling.extract_tiles``, bilinear) and taken to the
        tile latent, and (on an ADM family) one vector an entry."""
        th, tw = tiles_hw
        ds = pipe.family.vae.downscale
        dev = pipe.device
        entries, ys = [], []
        for e in src:
            am = None
            cm = self._canvas_area_mask(e, *img_size, dev)
            if cm is not None:
                wins = tiling.extract_tiles(cm, positions, p["tile_w"],
                                            p["tile_h"], p["padding"],
                                            resize_method="bilinear")
                am = image_mask_to_latent(wins[..., 0], th // ds, tw // ds,
                                          n)
            entries.append((
                align_cond_tokens(e.context, t_align).to(dev).repeat(
                    n, 1, 1),
                am, float(e.area_strength),
                entry_sigma_range(pipe.schedule, e)))
            if pipe.family.unet.adm_in_channels is not None:
                ys.append(_sdxl_vector_cond(
                    pipe, adm_cond_source(pipe.family, e, positive), n, th,
                    tw))
        return entries, ys

    def _refine_batch(self, ctx: OpContext, pipe, tiles: torch.Tensor,
                      tile_indices: Sequence[int], positive: Conditioning,
                      negative: Conditioning, p: Dict[str, Any],
                      positions: Sequence[Tuple[int, int]],
                      img_size: Tuple[int, int]) -> torch.Tensor:
        """VAE-encode -> sample(denoise) -> decode a [N, th, tw, C] tile
        batch in one go; tile ``i`` takes seed ``seed + i`` and fold-in
        index 0, as if it were a batch of one.  Regional conditionings
        refine with their masks cropped to the tiles (``positions`` in
        the canvas of ``img_size``); under PerpNeg, whose three row
        blocks take one plain entry a side, with the primary prompts
        only (logged).  A PerpNeg pipeline's empty conditioning is the
        middle block, its tokens aligned to the positive's as the JAX
        package aligns them."""
        n = tiles.shape[0]
        seeds = np.asarray([p["seed"] + int(t) for t in tile_indices],
                           np.uint64)
        idx = np.zeros((n,), np.uint32)
        dev = pipe.device
        pn = getattr(pipe, "perp_neg_cond", None)
        regional = _is_regional(positive) or _is_regional(negative)
        if regional and pn is not None:
            log("tiled upscale: regional conditioning cannot be mapped "
                "into this tile refine (PerpNeg-patched model); using "
                "the primary prompt only")
            regional = False
        mid, guidance, cfg2 = None, "dual", 1.0
        if regional:
            pos = [positive, *positive.siblings]
            neg = [negative, *negative.siblings]
            t_align = cond_token_align(pos + neg)
            tiles_hw = (tiles.shape[1], tiles.shape[2])
            context, y_conds = self._regional_entries(
                pipe, pos, n, positions, p, img_size, tiles_hw, t_align,
                positive)
            uncond, y_unconds = self._regional_entries(
                pipe, neg, n, positions, p, img_size, tiles_hw, t_align,
                positive)
            y = (y_conds + y_unconds) if y_conds else None
        else:
            context = positive.context.to(dev).repeat(n, 1, 1)
            uncond = negative.context.to(dev).repeat(n, 1, 1)
            y = None
            if pipe.family.unet.adm_in_channels is not None:
                y = _sdxl_vector_cond(pipe, positive, n, tiles.shape[1],
                                      tiles.shape[2])
            if pn is not None:
                mid = _align_to(pn.context.to(dev),
                                int(positive.context.shape[1])).repeat(
                                    n, 1, 1)
                guidance = "perp_neg"
                cfg2 = float(getattr(pipe, "perp_neg_scale", 1.0))
        with stage(ctx, "tile_encode"):
            lat = pipe.vae_encode(tiles)
        with stage(ctx, "tile_sample"):
            lat = pipe.sample(
                lat, context, uncond, seeds, steps=p["steps"], cfg=p["cfg"],
                sampler_name=p["sampler_name"], scheduler=p["scheduler"],
                denoise=p["denoise"], y=y, add_noise=True, sample_idx=idx,
                middle_context=mid, cfg2=cfg2, guidance=guidance)
        # an interrupted sample returns its latent part-way: end the
        # prompt here, so no noisy tile is blended or sent to the master
        ctx.check_interrupt()
        with stage(ctx, "tile_decode"):
            # clamped at the decode boundary, as the JAX package does
            return pipe.vae_decode(lat).clamp(0.0, 1.0)

    def _window_to_extracted(self, window: torch.Tensor,
                             pos: Tuple[int, int], p: Dict[str, Any],
                             img_size: Tuple[int, int]
                             ) -> Tuple[torch.Tensor,
                                        Tuple[int, int, int, int]]:
        """A refined window at the padded window size -> (its clamped
        extraction region at natural size, the region's bounds).  The one
        transform from a window to what is blended and what goes on the
        wire.  Without padding the tile is returned whole and resized to
        its region at the blend."""
        w, h = img_size
        x, y = pos
        tw, th, pad = p["tile_w"], p["tile_h"], p["padding"]
        x1, y1, x2, y2 = tiling.extraction_region(x, y, tw, th, pad, w, h)
        if pad > 0:
            ox, oy = x1 - (x - pad), y1 - (y - pad)
            window = window[oy:oy + (y2 - y1), ox:ox + (x2 - x1), :]
        return window, (x1, y1, x2, y2)

    def _blend_all(self, image: torch.Tensor,
                   windows: Dict[int, torch.Tensor],
                   all_tiles: List[Tuple[int, int]],
                   p: Dict[str, Any]) -> torch.Tensor:
        """Blend the refined windows into a copy of the image in tile
        index order, each through the mask of its grid rectangle; a tile
        with no window (a worker's that never came) keeps the image's
        pixels."""
        h, w = image.shape[1:3]
        canvas = image[0].clone()
        for i in sorted(windows):
            x, y = all_tiles[i]
            tile, (x1, y1, x2, y2) = self._window_to_extracted(
                windows[i], (x, y), p, (w, h))
            tiling.blend_tile(canvas, tile, x1, y1, (x, y), p["tile_w"],
                              p["tile_h"], (x2 - x1, y2 - y1), p["mask_blur"])
        return canvas.clamp(0.0, 1.0)[None]

    # --- worker --------------------------------------------------------------

    def _run_worker(self, ctx: OpContext, image: torch.Tensor, pipe,
                    positive: Conditioning, negative: Conditioning,
                    p: Dict[str, Any], multi_job_id: str, master_url: str,
                    worker_id: str, enabled_worker_ids: str,
                    tile_indices: str = "", attempt: int = 0) -> None:
        h, w = image.shape[1:3]
        all_tiles = tiling.calculate_tiles(w, h, p["tile_w"], p["tile_h"])
        if tile_indices:
            mine = [int(i) for i in json.loads(tile_indices)
                    if 0 <= int(i) < len(all_tiles)]
        else:
            workers = [str(x) for x in json.loads(enabled_worker_ids or "[]")]
            if str(worker_id) not in workers:
                return   # not a participant of this job: nothing to do
            parts = tiling.partition_tiles(len(all_tiles), len(workers))
            mine = parts[1 + workers.index(str(worker_id))]
        if not mine:
            return
        windows = self._refine_tiles(ctx, pipe, image, all_tiles, mine,
                                     positive, negative, p)
        with stage(ctx, "tile_send"):
            add_stage_seconds(ctx, self._send_tiles(
                windows, mine, all_tiles, p, multi_job_id, master_url,
                worker_id, (w, h), attempt, ctx.fault_inject))

    def _send_tiles(self, windows: Dict[int, torch.Tensor],
                    indices: Sequence[int], all_tiles, p: Dict[str, Any],
                    multi_job_id: str, master_url: str, worker_id: str,
                    img_size: Tuple[int, int], attempt: int = 0,
                    fault_inject: Optional[Dict[str, Any]] = None
                    ) -> Dict[str, float]:
        """POST each tile cut to its clamped extraction region at natural
        size (the form the master blends), with the JAX package's form
        fields; tile k + 1's copy to the host and encode run while tile
        k is on the wire.  ``fault_inject`` (tests and drills):
        ``stall_s`` delays the first send, ``drop_tiles_after`` stops
        after that many tiles, as a worker that died would.  Returns
        the encode and POST seconds."""
        inject = fault_inject or {}
        stall_s = float(inject.get("stall_s", 0) or 0)
        drop_after = inject.get("drop_tiles_after")
        if stall_s > 0:
            log(f"FAULT INJECTION: worker {worker_id} stalling {stall_s}s "
                f"before sending")
            time.sleep(stall_s)
        n_send = len(indices)
        if drop_after is not None and int(drop_after) < n_send:
            log(f"FAULT INJECTION: worker {worker_id} dying after "
                f"{int(drop_after)} of {n_send} tiles")
            n_send = max(int(drop_after), 0)
        fmt = negotiate_wire_format(master_url)
        codec = wire_codec(master_url)
        sp = trace_mod.current_span()

        def prep(k: int):
            tile, region = self._window_to_extracted(
                windows[indices[k]], all_tiles[indices[k]], p, img_size)
            with trace_mod.stage("d2h"):
                arr = as_image_array(tile[None])
            with trace_mod.stage("encode"):
                return wire_payload(arr, fmt, codec), region

        def post(k: int, prepped) -> None:
            (payload, ctype, ext), (x1, y1, x2, y2) = prepped
            tile_idx = indices[k]
            last = k == len(indices) - 1

            def make_form() -> FormData:
                form = FormData()
                form.add_field("multi_job_id", multi_job_id)
                form.add_field("worker_id", str(worker_id))
                form.add_field("tile_idx", str(tile_idx))
                form.add_field("x", str(x1))
                form.add_field("y", str(y1))
                form.add_field("extracted_width", str(x2 - x1))
                form.add_field("extracted_height", str(y2 - y1))
                form.add_field("padding", str(p["padding"]))
                form.add_field("idem_key",
                               f"{worker_id}:{tile_idx}:{attempt}")
                form.add_field("is_last", "true" if last else "false")
                if last and sp is not None:
                    # the worker's spans of the job ride its last tile
                    form.add_field("spans", json.dumps(
                        trace_mod.GLOBAL_TRACES.export(sp.trace_id)))
                form.add_field("tile", payload,
                               filename=f"tile_{tile_idx}.{ext}",
                               content_type=ctype)
                return form

            post_form_with_retry(f"{master_url}/distributed/tile_complete",
                                 make_form, timeout=C.TILE_TRANSFER_TIMEOUT,
                                 what="tile_complete",
                                 headers=trace_mod.traceparent_headers())

        return pipelined_uploads(n_send, prep, post)

    # --- master --------------------------------------------------------------

    def _run_master_http(self, ctx: OpContext, image: torch.Tensor, pipe,
                         positive: Conditioning, negative: Conditioning,
                         p: Dict[str, Any], multi_job_id: str,
                         enabled_worker_ids: str) -> torch.Tensor:
        h, w = image.shape[1:3]
        all_tiles = tiling.calculate_tiles(w, h, p["tile_w"], p["tile_h"])
        workers = [str(x) for x in json.loads(enabled_worker_ids or "[]")]
        if not workers:
            return self._run(ctx, image, pipe, positive, negative, p)
        parts = tiling.partition_tiles(len(all_tiles), len(workers))
        active_workers = sum(1 for part in parts[1:] if part)
        mj = multi_job_id
        # the tile tier first: the cached tiles check in before any work,
        # so the drain waits for the dirty tiles alone, and a worker's
        # send of a cached tile loses the first-wins check-in
        cached: Dict[int, torch.Tensor] = {}
        keys = self._tile_cache_probe(ctx, image, all_tiles, pipe, positive,
                                      negative, p, cached)
        if cached:
            log(f"tiled upscale master: {len(cached)}/{len(all_tiles)} "
                f"tiles unchanged (cache hits)")
        # the work ledger: who owns which tile, before any work happens
        ledger = ctx.ledger
        if ledger is not None:
            owners: Dict[int, str] = {int(i): "master" for i in parts[0]}
            for wi, part in enumerate(parts[1:]):
                for i in part:
                    owners[int(i)] = workers[wi]
            ledger.create_job(mj, owners, kind="tile")
            for i, win in cached.items():
                ledger.check_in(mj, i, "cache", payload=_window_payload(win))

        def refine_units(units: Sequence[int]) -> Dict[int, torch.Tensor]:
            """The master's own refine of any units (recovery and
            hedges): tile i takes seed + i, so it is the tile its lost
            or late owner would have sent."""
            out = self._refine_tiles(ctx, pipe, image, all_tiles,
                                     [int(u) for u in units], positive,
                                     negative, p)
            self._tile_cache_store(keys, out)
            return out

        if active_workers and ctx.job_store is not None:
            # a worker may finish first: its tiles need the queue now
            ctx.job_store.prepare_tile_job(mj)
        try:
            windows: Dict[int, torch.Tensor] = dict(cached)
            mine = [i for i in parts[0] if int(i) not in cached]
            if ledger is not None:
                # a recovered job: the tiles that checked in before the
                # crash blend from their payloads, never refined again,
                # and the master's range shrinks to what is pending
                for u, (arrays, meta) in ledger.load_payloads(mj).items():
                    windows[int(u)] = self._stored_window(
                        arrays, meta, all_tiles[int(u)], p, (w, h),
                        image.device)
                pending = set(ledger.pending(mj, owner="master"))
                mine = [i for i in mine if i in pending]
            if mine:
                for i, window in refine_units(mine).items():
                    if ledger is None or ledger.check_in(
                            mj, i, "master", payload=_window_payload(window),
                            spent=ctx.stage_seconds):
                        windows[i] = window
            if active_workers and ctx.job_store is not None:
                with stage(ctx, "tile_collect"), \
                        trace_mod.span("collect", job=mj,
                                       n_workers=active_workers):
                    collected = self._collect_tiles(
                        ctx, mj, active_workers, refine_window=refine_units)
                for i, item in collected.items():
                    if i in cached:
                        # without a ledger a worker's send of a cached
                        # tile is dropped here
                        continue
                    # the master's own recovery is at the window size;
                    # a worker's tile at its extraction region's
                    if "window_tensor" in item:
                        windows[i] = item["window_tensor"]
                    else:
                        windows[i] = self._worker_tile_to_window(
                            item, all_tiles[i], p, (w, h), image.device)
                        self._tile_cache_store(keys, {i: windows[i]})
            if ledger is not None:
                self._settle_pending(ctx, mj, refine_units, windows)
            with stage(ctx, "tile_blend"):
                return self._blend_all(image, windows, all_tiles, p)
        finally:
            if ctx.job_store is not None:
                ctx.job_store.remove_tile_queue(mj)
            if ledger is not None:
                summary = ledger.finish_job(mj)
                if summary and (summary["reassigned_units"]
                                or summary["hedged_units"]):
                    log(f"job {mj}: {summary['done_units']}/"
                        f"{summary['total_units']} units, "
                        f"{summary['reassigned_units']} reassigned, "
                        f"{summary['hedged_units']} hedged")

    @staticmethod
    def _settle_pending(ctx: OpContext, mj: str, refine_units,
                        windows: Dict[int, torch.Tensor]) -> None:
        """Units still pending after the drain (a deadline fired, or a
        recovery failed) by the fault policy: refined here
        (``reassign``), kept as the image's pixels (``partial``), or
        ``ClusterFaultError`` (``fail``)."""
        ledger = ctx.ledger
        pending = ledger.pending(mj)
        if not pending:
            return
        policy = cluster_mod.fault_policy()
        if policy == "fail":
            raise cluster_mod.ClusterFaultError(
                f"job {mj}: units {pending} unfinished at collection end "
                f"({C.FAULT_POLICY_ENV}=fail)")
        if policy == "partial":
            log(f"tiled upscale master: units {pending} lost; blending "
                f"partial ({C.FAULT_POLICY_ENV}=partial)")
            return
        moved = ledger.reassign(mj, pending, "master")
        if moved:
            log(f"tiled upscale master: reassigning units {moved} to "
                f"master (job {mj})")
            with trace_mod.span("reassign", job=mj, units=len(moved),
                                to="master"):
                out = refine_units(moved)
            for i, window in out.items():
                if ledger.check_in(mj, i, "master",
                                   payload=_window_payload(window),
                                   spent=ctx.stage_seconds):
                    windows[i] = window

    def _stored_window(self, arrays, meta: Dict[str, Any],
                       pos: Tuple[int, int], p: Dict[str, Any],
                       img_size: Tuple[int, int], device) -> torch.Tensor:
        """A unit store payload -> the padded window the blend takes: a
        worker's tile is widened as on arrival, a window is put back on
        the device."""
        if meta.get("form") == "tile":
            return self._worker_tile_to_window(
                {**meta, "tensor": arrays[0]}, pos, p, img_size, device)
        return torch.from_numpy(arrays[0]).to(device)

    def _worker_tile_to_window(self, item: Dict[str, Any],
                               pos: Tuple[int, int], p: Dict[str, Any],
                               img_size: Tuple[int, int],
                               device) -> torch.Tensor:
        """A worker's tile at its extraction region's size -> the padded
        window (edges repeated), so every tile blends alike; the blend
        cuts the same region back out."""
        w, h = img_size
        x, y = pos
        tw, th, pad = p["tile_w"], p["tile_h"], p["padding"]
        x1, y1, x2, y2 = tiling.extraction_region(x, y, tw, th, pad, w, h)
        tile = as_device_image(item["tensor"], device)[0]
        want_w, want_h = x2 - x1, y2 - y1
        if (tile.shape[1], tile.shape[0]) != (want_w, want_h):
            tile = resize_image(tile, want_w, want_h)
        ox, oy = x1 - (x - pad), y1 - (y - pad)
        rows = (torch.arange(th + 2 * pad, device=device) - oy).clamp_(
            0, want_h - 1)
        cols = (torch.arange(tw + 2 * pad, device=device) - ox).clamp_(
            0, want_w - 1)
        return tile[rows][:, cols]

    def _collect_tiles(self, ctx: OpContext, multi_job_id: str,
                       num_workers: int, refine_window=None
                       ) -> Dict[int, Dict[str, Any]]:
        """Drain the tile queue; returns what arrived, by tile index.

        With the control plane (``ctx.ledger`` planned this job) the
        drain ends when no unit is pending.  Each poll it asks the
        registry for dead owners, so a lease expiry starts recovery at
        once: the exact unit list is redispatched to a healthy worker
        (when the orchestrator registered a redispatcher), else refined
        on the master by ``refine_window`` on a pool thread while the
        drain goes on.  Past the progress gate, overdue tiles are hedged
        on the master the same way; the first completion of a tile wins
        through the ledger, a late one is dropped.  Without a ledger it
        drains until every worker sent its last tile,
        ``TILE_WAIT_TIMEOUT`` passes without a tile, or the overall
        ``TILE_COLLECTION_TIMEOUT`` fires."""
        mj = multi_job_id
        ledger = ctx.ledger if (ctx.ledger is not None
                                and ctx.ledger.has_job(mj)) else None
        registry = ctx.cluster
        policy = cluster_mod.fault_policy()
        can_refine = ledger is not None and refine_window is not None
        hedge_on = cluster_mod.hedge_armed() and can_refine
        q = ctx.job_store.get_tile_queue(mj)
        collected: Dict[int, Dict[str, Any]] = {}
        done, handled_dead = set(), set()
        # (future, reason, units) of the master's own refines in flight
        recovery: List[Tuple[concurrent.futures.Future, str, list]] = []
        start = time.monotonic()
        deadline = start + C.TILE_COLLECTION_TIMEOUT
        # redispatches extend the deadline up to here
        hard_deadline = start + 2 * C.TILE_COLLECTION_TIMEOUT \
            + C.TILE_WAIT_TIMEOUT
        last_progress = start
        # short polls only when the control plane can act between tiles
        poll_s = C.CLUSTER_POLL_S if (ledger is not None and (
            registry is not None or hedge_on)) else C.TILE_WAIT_TIMEOUT
        pool = concurrent.futures.ThreadPoolExecutor(
            1, thread_name_prefix="dtpu-recover") if can_refine else None

        def recover(units, reason: str, lost: Optional[str] = None) -> None:
            """The master's own refine of ``units`` on the pool thread,
            a ``reassign`` or ``hedge`` span under the drain's."""
            attrs: Dict[str, Any] = {"job": mj, "units": len(units),
                                     "to": "master"}
            if lost:
                attrs["lost"] = str(lost)

            @in_context
            def run(units):
                with trace_mod.span(reason, **attrs):
                    return refine_window(units)
            recovery.append((pool.submit(run, list(units)), reason,
                             list(units)))

        def harvest(wait: bool = False) -> None:
            """Check the finished refines in (``wait``: all of them)."""
            keep = []
            for fut, reason, units in recovery:
                if not (wait or fut.done()):
                    keep.append((fut, reason, units))
                    continue
                try:
                    out = fut.result()
                except Exception as e:  # noqa: BLE001 - the post-drain
                    # refine still covers these units
                    log(f"tiled upscale master: {reason} of {units} "
                        f"failed: {type(e).__name__}: {e}")
                    if reason == "hedge":
                        # still hedge-marked they would be skipped by the
                        # dead-owner scan
                        ledger.unmark_hedged(mj, units)
                    continue
                for idx, window in out.items():
                    if ledger.check_in(mj, idx, "master",
                                       payload=_window_payload(window),
                                       spent=ctx.stage_seconds):
                        collected[int(idx)] = {"window_tensor": window}
            recovery[:] = keep

        def handle_lost(owner: str, units: List[int]) -> bool:
            """Redispatch a lost owner's units, else refine them here;
            True when a redispatch went out."""
            redone = False
            if ledger.has_redispatcher(mj):
                with trace_mod.span("reassign", job=mj, units=len(units),
                                    lost=str(owner), to="remote") as rsp:
                    redone = ledger.redispatch(mj, sorted(units), owner)
                    if rsp is not None and not redone:
                        rsp.attrs["to"] = "none"
            if not redone and refine_window is not None:
                moved = ledger.reassign(mj, sorted(units), "master")
                if moved:
                    recover(moved, "reassign", lost=owner)
            return redone

        def finished() -> bool:
            if ledger is not None:
                return not ledger.pending(mj)
            return len(done) >= num_workers

        def extend_deadline() -> None:
            """Room for a replacement; the post-drain refine still backs
            it up."""
            nonlocal deadline, last_progress
            now = time.monotonic()
            deadline = min(max(deadline, now + C.TILE_COLLECTION_TIMEOUT / 2),
                           hard_deadline)
            last_progress = now

        try:
            # a recovered job's workers' pending tiles were dispatched by
            # the dead master: they never come here, so they move now
            # instead of after the no-progress timeout
            stale = ledger.take_recovered_lost(mj) \
                if ledger is not None and policy != "partial" else {}
            for owner, units in stale.items():
                if policy == "fail":
                    raise cluster_mod.ClusterFaultError(
                        f"recovered job {mj} lost units {sorted(units)} "
                        f"with the old master ({C.FAULT_POLICY_ENV}=fail)")
                log(f"tiled upscale master: recovered job {mj}: re-issuing "
                    f"units {sorted(units)} stranded on {owner}")
                if handle_lost(owner, units):
                    extend_deadline()
            while True:
                if pool is not None:
                    harvest()
                if finished():
                    break
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    log("tiled upscale master: collection deadline; "
                        + ("handing leftovers to the fault policy"
                           if ledger is not None
                           else "blending partial results"))
                    break
                if ledger is not None and registry is not None \
                        and policy != "partial":
                    # a dead worker's pending units move now, not at the
                    # deadline
                    by_owner: Dict[str, List[int]] = {}
                    for u, o in ledger.owners_of_pending(
                            mj, skip_hedged=True).items():
                        if o != "master" and o not in handled_dead \
                                and registry.state(o) == cluster_mod.DEAD:
                            by_owner.setdefault(o, []).append(u)
                    for owner, units in by_owner.items():
                        handled_dead.add(owner)
                        if policy == "fail":
                            raise cluster_mod.ClusterFaultError(
                                f"worker {owner} died with units "
                                f"{sorted(units)} outstanding "
                                f"({C.FAULT_POLICY_ENV}=fail)")
                        log(f"tiled upscale master: worker {owner} lease "
                            f"expired; recovering units {sorted(units)}")
                        if handle_lost(owner, units):
                            extend_deadline()
                if hedge_on:
                    overdue = ledger.overdue_units(mj)
                    units = sorted(u for u, o in overdue.items()
                                   if o != "master")
                    hedged = ledger.mark_hedged(mj, units, "master") \
                        if units else []
                    if hedged:
                        log(f"tiled upscale master: hedging overdue units "
                            f"{hedged}")
                        recover(hedged, "hedge")
                try:
                    item = q.get(timeout=max(min(poll_s, remaining), 0.01))
                except queue.Empty:
                    if recovery:
                        continue   # the master's own refine is running
                    if time.monotonic() - last_progress \
                            > C.TILE_WAIT_TIMEOUT:
                        log("tiled upscale master: timeout waiting for "
                            "tiles; " + ("handing leftovers to the fault "
                                         "policy" if ledger is not None
                                         else "blending partial results"))
                        break
                    continue
                last_progress = time.monotonic()
                idx = int(item["tile_idx"])
                wid = str(item["worker_id"])
                if registry is not None:
                    registry.touch(wid)
                if ledger is None or ledger.check_in(
                        mj, idx, wid, payload=_tile_payload(item),
                        spent=ctx.stage_seconds):
                    collected[idx] = item
                if item.get("is_last"):
                    done.add(wid)
        finally:
            if pool is not None:
                # the refines in flight land before the blend
                harvest(wait=True)
                pool.shutdown()
        return collected
