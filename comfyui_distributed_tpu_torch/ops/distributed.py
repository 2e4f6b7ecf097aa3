"""Distributed ops: the counterparts of ``DistributedSeed`` and
``DistributedCollector`` in ``comfyui_distributed_tpu/ops/distributed.py``.

The seed: the master passes it through; worker ``i`` uses
``seed + i + 1``.  The collector runs one of three ways:

- in one process (no ``multi_job_id``): the batch is already complete
  and is returned as it stands on the device;
- on a worker of the HTTP fan-out (``is_worker`` and a ``master_url``):
  each image is POSTed to the master's ``/distributed/job_complete``, in
  the wire format the master advertises, with retries;
- on the master (a ``multi_job_id``): the job's queue is drained until
  every worker sent its last image, or a deadline fires and the partial
  batch is kept; images are keyed by (worker, image_index) and ordered
  master first, then by worker index.

Downstream of a distributed upscaler it is ``pass_through`` and returns
its input.  The JAX package's work ledger, worker registry, hedging and
crash recovery wait; so does fan-out over several GPUs (NCCL).
"""

from __future__ import annotations

import json
import queue
import time
from typing import Any, Dict, Tuple

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
from comfyui_distributed_tpu_torch.utils import constants as C
from comfyui_distributed_tpu_torch.utils.image import (
    encode_png,
    encode_tensor,
)
from comfyui_distributed_tpu_torch.utils.net import (
    FormData,
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
            self._send_to_master(arr, multi_job_id, master_url,
                                 worker_id or ctx.worker_id,
                                 attempt=int(dispatch_attempt or 0))
            return (images,)
        if multi_job_id and ctx.job_store is not None:
            return (self._collect_http(ctx, images, multi_job_id,
                                       enabled_worker_ids),)
        return (images,)

    # --- worker --------------------------------------------------------------

    def _send_to_master(self, arr: np.ndarray, multi_job_id: str,
                        master_url: str, worker_id: str,
                        attempt: int = 0) -> None:
        fmt = negotiate_wire_format(master_url)
        codec = wire_codec(master_url)
        n = arr.shape[0]
        for i in range(n):
            payload, ctype, ext = wire_payload(arr[i:i + 1], fmt, codec)

            def make_form(i=i, payload=payload, ctype=ctype, ext=ext):
                form = FormData()
                form.add_field("multi_job_id", multi_job_id)
                form.add_field("worker_id", str(worker_id))
                form.add_field("image_index", str(i))
                # the same for every retry of this send, new for a new
                # dispatch attempt: the master counts the image once
                form.add_field("idem_key", f"{worker_id}:{i}:{attempt}")
                form.add_field("is_last", "true" if i == n - 1 else "false")
                form.add_field("image", payload, filename=f"img_{i}.{ext}",
                               content_type=ctype)
                return form

            post_form_with_retry(f"{master_url}/distributed/job_complete",
                                 make_form, timeout=C.TILE_SEND_TIMEOUT,
                                 what="job_complete")

    # --- master --------------------------------------------------------------

    def _collect_http(self, ctx: OpContext, images, multi_job_id: str,
                      enabled_worker_ids: str) -> DeviceImage:
        worker_ids = [str(w) for w in json.loads(enabled_worker_ids or "[]")]
        q = ctx.job_store.get_queue(multi_job_id)
        # worker label -> {(0, image_index) or (1, arrival): image}; a
        # retried POST that got through twice overwrites, never adds
        results: Dict[str, Dict[tuple, Any]] = {}
        arrival: Dict[str, int] = {}
        done = set()
        deadline = time.monotonic() + C.JOB_COMPLETION_TIMEOUT
        last_progress = time.monotonic()
        try:
            while len(done) < len(worker_ids):
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    break   # the deadline keeps what arrived
                try:
                    item = q.get(timeout=max(min(C.WORKER_JOB_TIMEOUT,
                                                 remaining), 0.01))
                except queue.Empty:
                    if time.monotonic() - last_progress \
                            > C.WORKER_JOB_TIMEOUT:
                        break
                    continue
                last_progress = time.monotonic()
                wid = str(item["worker_id"])
                if "image_index" in item:
                    key = (0, int(item["image_index"]))
                else:
                    arrival[wid] = arrival.get(wid, 0) + 1
                    key = (1, arrival[wid])
                results.setdefault(wid, {})[key] = item["tensor"]
                if item.get("is_last"):
                    done.add(wid)
        finally:
            # late arrivals get 404 instead of a queue that never drains
            ctx.job_store.remove_job(multi_job_id)
        ordered = [as_device_image(images, ctx.device)]
        for wid in sorted(results, key=lambda w: (parse_worker_index(w), w)):
            ordered.extend(as_device_image(results[wid][k], ctx.device)
                           for k in sorted(results[wid]))
        return DeviceImage(torch.cat(ordered, dim=0))
