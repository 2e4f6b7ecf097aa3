"""Distributed ops on one process and one card: the counterparts of
``DistributedSeed`` and ``DistributedCollector`` in
``comfyui_distributed_tpu/ops/distributed.py`` at fanout 1.

The master passes the seed through and worker ``i`` uses ``seed + i + 1``;
the collector returns the batch, master first, as it stands on the
device.  Fan-out over several GPUs (NCCL) waits for a later slice.
"""

from __future__ import annotations

from comfyui_distributed_tpu_torch.ops.base import (
    CONTROL,
    Op,
    OpContext,
    SeedValue,
    register_op,
)


def parse_worker_index(worker_id: str) -> int:
    """'worker_3' -> 3."""
    try:
        return int(str(worker_id).rsplit("_", 1)[-1])
    except (ValueError, IndexError):
        return 0


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
    """Gathers the fanned-out batch; with one card the batch is already
    complete and is returned as it stands on the device."""
    TYPE = "DistributedCollector"
    HIDDEN = ["multi_job_id", "is_worker", "master_url",
              "enabled_worker_ids", "worker_batch_size", "worker_id",
              "pass_through", "dispatch_attempt"]

    def execute(self, ctx: OpContext, images, multi_job_id="",
                is_worker=None, master_url="", enabled_worker_ids="[]",
                worker_batch_size=1, worker_id="", pass_through=False,
                dispatch_attempt=0):
        is_worker = ctx.is_worker if is_worker is None else is_worker
        if multi_job_id or master_url or is_worker:
            raise NotImplementedError(
                "multi-process collection is not ported yet; the torch "
                "package runs one process on one card")
        return (images,)
