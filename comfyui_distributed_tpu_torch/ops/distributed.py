"""Distributed ops: the counterparts of ``DistributedSeed`` and
``DistributedCollector`` in ``comfyui_distributed_tpu/ops/distributed.py``.

The seed: the master passes it through; worker ``i`` uses
``seed + i + 1``.  The collector runs one of three ways:

- in one process (no ``multi_job_id``): the batch is already complete
  and is returned as it stands on the device;
- on a worker of the HTTP fan-out (``is_worker`` and a ``master_url``):
  each image is POSTed to the master's ``/distributed/job_complete``, in
  the wire format the master advertises, with retries; image i + 1 is
  encoded on a pool thread while image i is on the wire
  (:func:`pipelined_uploads`);
- on the master (a ``multi_job_id``): the job's queue is drained and
  images are keyed by (worker, image_index) and ordered master first,
  then by worker index.  With the control plane (``ctx.ledger``) each
  worker's seed slice is a ledger unit that checks in with its last
  image, a slice whose owner's lease expires is redispatched to a
  healthy worker, an overdue slice is hedged, and the fault policy
  decides what a lost slice costs (``partial`` keeps the batch that
  arrived, ``fail`` raises).  Without one, the drain ends when every
  worker sent its last image or a deadline fires, keeping what arrived.
  With the write-ahead log, a slice that checks in is written to the
  unit store first; a job a restarted master recovers loads the slices
  that checked in before the crash from there, not rendering them
  again, and redispatches its other pending slices at once (their
  dispatches died with the old master).

Downstream of a distributed upscaler it is ``pass_through`` and returns
its input.  Fan-out over several GPUs (NCCL) waits.

Tracing, as in the JAX package: a worker's encodes are ``encode`` stages
(on the pool thread, in the job's span and transfer context) and its
POSTs ``upload`` stages carrying the ``traceparent``; its last upload
ships the worker's spans of the job (``spans`` form field), which the
master's route ingests into its flight recorder.  The master's drain is
a ``collect`` span, each recovery a ``reassign`` or ``hedge`` span.
"""

from __future__ import annotations

import concurrent.futures
import json
import queue
import time
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch

from comfyui_distributed_tpu_torch.ops.base import (
    CONTROL,
    DeviceImage,
    Op,
    OpContext,
    SeedValue,
    as_device_image,
    as_image_array,
    register_op,
)
from comfyui_distributed_tpu_torch.runtime import cluster as cluster_mod
from comfyui_distributed_tpu_torch.utils import constants as C
from comfyui_distributed_tpu_torch.utils import trace as trace_mod
from comfyui_distributed_tpu_torch.utils.log import Timer, log
from comfyui_distributed_tpu_torch.utils.image import (
    encode_png,
    encode_tensor,
)
from comfyui_distributed_tpu_torch.utils.net import (
    FormData,
    in_context,
    negotiate_wire_format,
    post_form_with_retry,
    wire_codec,
)


def parse_worker_index(worker_id: str) -> int:
    """'worker_3' -> 3."""
    try:
        return int(str(worker_id).rsplit("_", 1)[-1])
    except (ValueError, IndexError):
        return 0


def wire_payload(arr: np.ndarray, fmt: str, codec: str
                 ) -> Tuple[bytes, str, str]:
    """One [1, H, W, C] image -> (bytes, content type, file extension) in
    the negotiated format."""
    if fmt == C.TENSOR_WIRE_CONTENT_TYPE:
        return encode_tensor(arr, codec), fmt, "dtt"
    return encode_png(arr), "image/png", "png"


def pipelined_uploads(n: int, prep: Callable[[int], Any],
                      post: Callable[[int, Any], None]) -> Dict[str, float]:
    """Upload ``n`` items in order, ``prep(k)`` (the device-to-host copy
    and the encode) of item k + 1 on a pool thread, in the caller's span
    and transfer context, while ``post(k, prepped)`` sends item k as an
    ``upload`` stage.  Returns the seconds summed over the items:
    ``wire_encode`` (in ``prep``, on the pool thread) and ``wire_post``;
    with both busy at once their sum exceeds the wall time."""
    spent = {"wire_encode": 0.0, "wire_post": 0.0}
    if n <= 0:
        return spent
    prep = in_context(prep)

    def timed(k: int):
        t0 = time.perf_counter()
        out = prep(k)
        return out, time.perf_counter() - t0

    with concurrent.futures.ThreadPoolExecutor(
            1, thread_name_prefix="dtpu-encode") as ex:
        nxt = ex.submit(timed, 0)
        for k in range(n):
            prepped, enc_s = nxt.result()
            spent["wire_encode"] += enc_s
            if k + 1 < n:
                nxt = ex.submit(timed, k + 1)
            t0 = time.perf_counter()
            with trace_mod.stage("upload"):
                post(k, prepped)
            spent["wire_post"] += time.perf_counter() - t0
    return spent


def add_stage_seconds(ctx: OpContext, spent: Dict[str, float]) -> None:
    for k, v in spent.items():
        ctx.stage_seconds[k] = ctx.stage_seconds.get(k, 0.0) + v


@register_op
class DistributedSeed(Op):
    """Master passes the seed through; worker ``i`` gets ``seed + i + 1``.
    On the master it returns a SeedValue marked ``distributed``: replica 0
    (the only one at fanout 1) keeps the base seed."""
    TYPE = "DistributedSeed"
    WIDGETS = ["seed", CONTROL]
    HIDDEN = ["is_worker", "worker_id"]

    def execute(self, ctx: OpContext, seed, is_worker=None, worker_id=None):
        base = int(seed)
        is_worker = ctx.is_worker if is_worker is None else is_worker
        worker_id = ctx.worker_id if worker_id is None else worker_id
        if is_worker:
            return (SeedValue(base + parse_worker_index(worker_id) + 1),)
        return (SeedValue(base, distributed=True),)


@register_op
class DistributedCollector(Op):
    TYPE = "DistributedCollector"
    # worker_batch_size is kept for the schema: a worker's last image
    # says is_last, so no count is needed
    HIDDEN = ["multi_job_id", "is_worker", "master_url",
              "enabled_worker_ids", "worker_batch_size", "worker_id",
              "pass_through", "dispatch_attempt"]

    def execute(self, ctx: OpContext, images, multi_job_id="",
                is_worker=None, master_url="", enabled_worker_ids="[]",
                worker_batch_size=1, worker_id="", pass_through=False,
                dispatch_attempt=0):
        if pass_through:
            return (images,)
        is_worker = ctx.is_worker if is_worker is None else is_worker
        master_url = master_url or ctx.master_url
        if is_worker and master_url:
            arr = as_image_array(images)
            add_stage_seconds(ctx, self._send_to_master(
                arr, multi_job_id, master_url, worker_id or ctx.worker_id,
                attempt=int(dispatch_attempt or 0),
                fault_inject=ctx.fault_inject))
            return (images,)
        if multi_job_id and ctx.job_store is not None:
            return (self._collect_http(ctx, images, multi_job_id,
                                       enabled_worker_ids),)
        return (images,)

    # --- worker --------------------------------------------------------------

    def _send_to_master(self, arr: np.ndarray, multi_job_id: str,
                        master_url: str, worker_id: str,
                        attempt: int = 0,
                        fault_inject: Optional[Dict[str, Any]] = None
                        ) -> Dict[str, float]:
        """POST each image, image i + 1 encoded while image i is on the
        wire; returns the encode and POST seconds.  ``fault_inject``
        (tests and drills): ``stall_s`` delays the first send."""
        stall_s = float((fault_inject or {}).get("stall_s", 0) or 0)
        if stall_s > 0:
            log(f"FAULT INJECTION: worker {worker_id} stalling {stall_s}s "
                f"before sending")
            time.sleep(stall_s)
        fmt = negotiate_wire_format(master_url)
        codec = wire_codec(master_url)
        n = arr.shape[0]
        sp = trace_mod.current_span()

        def prep(i: int):
            with trace_mod.stage("encode"):
                return wire_payload(arr[i:i + 1], fmt, codec)

        def post(i: int, prepped) -> None:
            payload, ctype, ext = prepped

            def make_form() -> FormData:
                form = FormData()
                form.add_field("multi_job_id", multi_job_id)
                form.add_field("worker_id", str(worker_id))
                form.add_field("image_index", str(i))
                # the same for every retry of this send, new for a new
                # dispatch attempt: the master counts the image once
                form.add_field("idem_key", f"{worker_id}:{i}:{attempt}")
                form.add_field("is_last", "true" if i == n - 1 else "false")
                if i == n - 1 and sp is not None:
                    # this process's spans of the job ride the last
                    # upload (the open ones provisional), so the master's
                    # recorder holds the whole fan-out
                    form.add_field("spans", json.dumps(
                        trace_mod.GLOBAL_TRACES.export(sp.trace_id)))
                form.add_field("image", payload, filename=f"img_{i}.{ext}",
                               content_type=ctype)
                return form

            post_form_with_retry(f"{master_url}/distributed/job_complete",
                                 make_form, timeout=C.TILE_SEND_TIMEOUT,
                                 what="job_complete",
                                 headers=trace_mod.traceparent_headers())

        return pipelined_uploads(n, prep, post)

    # --- master --------------------------------------------------------------

    def _collect_http(self, ctx: OpContext, images, multi_job_id: str,
                      enabled_worker_ids: str) -> DeviceImage:
        worker_ids = [str(w) for w in json.loads(enabled_worker_ids or "[]")]
        # the wire carries positional labels ("worker_i"); the ledger and
        # the registry speak config ids, mapped by the enabled order
        pos_map = {f"worker_{i}": wid for i, wid in enumerate(worker_ids)}
        ledger, registry = ctx.ledger, ctx.cluster
        policy = cluster_mod.fault_policy()
        if ledger is not None:
            # one unit a seed slice, done when its last image checks in
            ledger.create_job(multi_job_id, {w: w for w in worker_ids},
                              kind="image")
        # a recovered job's slices that checked in before the crash; one
        # whose file is unreadable goes back to pending here, before the
        # drain decides what is missing
        recovered = ledger.load_payloads(multi_job_id) \
            if ledger is not None else {}
        try:
            # the master-side half of the fan-out's trace: the workers'
            # shipped spans hang beside it under the same trace id
            with Timer("collector_http_drain"), \
                    trace_mod.span("collect", job=multi_job_id,
                                   n_workers=len(worker_ids)):
                results = self._drain_images(ctx, multi_job_id, worker_ids,
                                             pos_map, policy)
            if ledger is not None and policy == "fail":
                lost = ledger.pending(multi_job_id)
                if lost:
                    raise cluster_mod.ClusterFaultError(
                        f"slices {lost} of {multi_job_id} never arrived "
                        f"({C.FAULT_POLICY_ENV}=fail)")
        finally:
            # late arrivals get 404 instead of a queue that never drains
            ctx.job_store.remove_job(multi_job_id)
            if ledger is not None:
                summary = ledger.finish_job(multi_job_id)
                if summary and summary["pending_units"]:
                    log(f"collector: job {multi_job_id} finished with lost "
                        f"slices {summary['pending_units']} "
                        f"(policy={policy})")
        # the recovered slices under their wire labels; a fresh arrival
        # (a redispatched redo) wins over the stored one
        for arrays, meta in recovered.values():
            slot = results.setdefault(str(meta["wid"]), {})
            for k, t in zip(meta.get("keys", []), arrays):
                slot.setdefault(tuple(k), t)
        ordered = [as_device_image(images, ctx.device)]
        for wid in sorted(results, key=lambda w: (parse_worker_index(w), w)):
            ordered.extend(as_device_image(results[wid][k], ctx.device)
                           for k in sorted(results[wid]))
        return DeviceImage(torch.cat(ordered, dim=0))

    def _drain_images(self, ctx: OpContext, multi_job_id: str,
                      worker_ids, pos_map: Dict[str, str],
                      policy: str) -> Dict[str, Dict[tuple, Any]]:
        """Drain the job's queue: worker label -> {(0, image_index) or
        (1, arrival): image}.  A retried POST that got through twice
        overwrites, never adds; an indexless sender's images keep their
        arrival order."""
        mj = multi_job_id
        ledger, registry = ctx.ledger, ctx.cluster
        q = ctx.job_store.get_queue(mj)
        results: Dict[str, Dict[tuple, Any]] = {}
        arrival: Dict[str, int] = {}
        done, handled_dead = set(), set()
        start = time.monotonic()
        deadline = start + C.JOB_COMPLETION_TIMEOUT
        # redispatches extend the deadline up to here
        hard_deadline = start + 2 * C.JOB_COMPLETION_TIMEOUT \
            + C.WORKER_JOB_TIMEOUT
        last_progress = start
        # the master cannot render another participant's slice itself:
        # recovery is redispatch only, so short polls need a redispatcher
        can_recover = (ledger is not None and registry is not None
                       and policy != "partial"
                       and ledger.has_redispatcher(mj))
        hedge_on = (cluster_mod.hedge_armed() and ledger is not None
                    and ledger.has_redispatcher(mj))
        poll_s = C.CLUSTER_POLL_S if (can_recover or hedge_on) \
            else C.WORKER_JOB_TIMEOUT

        def missing():
            return set(worker_ids) - {pos_map.get(w, w) for w in done}

        def recover(units, owner, reason: str) -> bool:
            with trace_mod.span(reason, job=mj, lost=str(owner)):
                return ledger.redispatch(mj, list(units), owner)

        def redispatched(units, owner) -> None:
            """Redispatch a lost owner's slices; a success gives the
            replacement room before the deadline."""
            nonlocal deadline, last_progress
            if recover(units, owner, "reassign"):
                now = time.monotonic()
                deadline = min(max(deadline,
                                   now + C.JOB_COMPLETION_TIMEOUT / 2),
                               hard_deadline)
                last_progress = now
            else:
                log(f"collector: no healthy participant for {owner}'s "
                    f"slice; will keep a partial batch")

        # a recovered job's pending slices were dispatched by the dead
        # master: their owners never send here, so they go out again now
        # instead of after the no-progress timeout
        stale = ledger.take_recovered_lost(mj) if can_recover else {}
        for owner, units in stale.items():
            if policy == "fail":
                raise cluster_mod.ClusterFaultError(
                    f"recovered job {mj} lost slices {sorted(units)} with "
                    f"the old master ({C.FAULT_POLICY_ENV}=fail)")
            log(f"collector: recovered job {mj}: re-issuing slices "
                f"{sorted(units)} stranded on {owner}")
            redispatched(units, owner)

        while True:
            if ledger is not None:
                if not ledger.pending(mj):
                    break
            elif len(done) >= len(worker_ids):
                break
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                log(f"collector: collection deadline, missing {missing()}; "
                    f"continuing partial")
                break
            if ledger is not None and registry is not None \
                    and policy != "partial":
                # pending units by their CURRENT owner (a reassigned
                # unit's key is its slice, not its owner)
                dead_units: Dict[str, list] = {}
                for u, o in ledger.owners_of_pending(
                        mj, skip_hedged=True).items():
                    if o not in handled_dead \
                            and registry.state(o) == cluster_mod.DEAD:
                        dead_units.setdefault(o, []).append(u)
                for owner, units in dead_units.items():
                    handled_dead.add(owner)
                    if policy == "fail":
                        raise cluster_mod.ClusterFaultError(
                            f"worker {owner} died before delivering slices "
                            f"{sorted(units)} of {mj} "
                            f"({C.FAULT_POLICY_ENV}=fail)")
                    log(f"collector: worker {owner} lease expired; "
                        f"redispatching its slice")
                    redispatched(units, owner)
            if hedge_on:
                for unit, owner in sorted(ledger.overdue_units(mj).items(),
                                          key=str):
                    if not ledger.mark_hedged(mj, [unit]):
                        continue
                    if recover([unit], owner, "hedge"):
                        log(f"collector: hedged straggler {owner}'s slice")
                    else:
                        # a hedge that never launched must not pin the
                        # unit out of the dead-owner scan
                        ledger.unmark_hedged(mj, [unit])
            try:
                item = q.get(timeout=max(min(poll_s, remaining), 0.01))
            except queue.Empty:
                if time.monotonic() - last_progress > C.WORKER_JOB_TIMEOUT:
                    log(f"collector: timeout, missing workers {missing()}; "
                        f"continuing with partial results")
                    break
                continue
            last_progress = time.monotonic()
            wid = str(item["worker_id"])
            if registry is not None:
                # the RAW wire label only: a positional label is unknown
                # to the registry, and mapping it to the config id would
                # let a replacement posting as the dead owner renew the
                # dead worker's lease
                registry.touch(wid)
            if "image_index" in item:
                key = (0, int(item["image_index"]))
            else:
                arrival[wid] = arrival.get(wid, 0) + 1
                key = (1, arrival[wid])
            results.setdefault(wid, {})[key] = item["tensor"]
            if item.get("is_last"):
                done.add(wid)
                if ledger is not None:
                    # the whole slice with its keys, so a recovered master
                    # orders the images as this drain would
                    cfg_id = pos_map.get(wid, wid)
                    slot = results[wid]
                    keys = sorted(slot)
                    ledger.check_in(
                        mj, cfg_id, cfg_id,
                        payload=([as_image_array(slot[k]) for k in keys],
                                 {"form": "slice", "wid": wid,
                                  "keys": [list(k) for k in keys]}),
                        spent=ctx.stage_seconds)
        return results
