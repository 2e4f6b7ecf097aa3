"""Workflow executor: topo-ordered op execution on one device, the
counterpart of ``comfyui_distributed_tpu/workflow/executor.py`` at fanout
1.

Each node runs under ``utils.trace.node_scope`` (its device copies are
attributed to it) and a span named for its ``class_type`` in the active
request trace (none outside a job), and its seconds go to the per-type
``GLOBAL_NODES`` histogram.  A run's copies between host and device are
also kept in a run-local ledger, ``ExecutionResult.transfers``.  Reuse
keys and the per-node memory attribution of the resource plane wait.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from comfyui_distributed_tpu_torch.ops.base import OpContext, get_op
from comfyui_distributed_tpu_torch.utils import trace as trace_mod
from comfyui_distributed_tpu_torch.utils.log import debug_log
from comfyui_distributed_tpu_torch.workflow.graph import Graph, parse_workflow


@dataclasses.dataclass
class ExecutionResult:
    outputs: Dict[str, Tuple]            # node id -> op outputs
    images: List[np.ndarray]             # Preview/SaveImage-collected
    timings: Dict[str, float]            # node id -> seconds
    total_s: float = 0.0
    # named stages inside ops -> seconds (``ops.base.stage``)
    stages: Dict[str, float] = dataclasses.field(default_factory=dict)
    # on a card: node id -> torch.cuda.max_memory_allocated() after the
    # node, so the node where it rises to the request's peak set it
    node_max_memory: Dict[str, int] = dataclasses.field(
        default_factory=dict)
    # node id (or "_unattributed") -> {d2h,h2d}_{bytes,calls} of this run
    transfers: Dict[str, Dict[str, float]] = dataclasses.field(
        default_factory=dict)

    @property
    def image_batch(self) -> Optional[np.ndarray]:
        if not self.images:
            return None
        return np.stack(self.images, axis=0)


class WorkflowExecutor:
    def __init__(self, ctx: Optional[OpContext] = None):
        self.ctx = ctx or OpContext()

    def execute(self, workflow: Any) -> ExecutionResult:
        """Run a workflow (path, JSON, dict or Graph).  Node timings end in
        a device synchronize, so each is the node's own device time."""
        graph = workflow if isinstance(workflow, Graph) \
            else parse_workflow(workflow)
        self.ctx.saved_images = []
        self.ctx.stage_seconds = {}
        self.ctx.prompt_json = graph.to_api_format()
        on_cuda = torch.device(self.ctx.device).type == "cuda"
        outputs: Dict[str, Tuple] = {}
        timings: Dict[str, float] = {}
        max_memory: Dict[str, int] = {}
        order = graph.topo_order()
        # an unported node type fails the run before any node runs
        ops = {nid: get_op(graph.nodes[nid].class_type) for nid in order}
        run_transfers = trace_mod.TransferStats()
        t_start = time.perf_counter()
        with trace_mod.transfer_sink(run_transfers):
            for nid in order:
                node = graph.nodes[nid]
                op = ops[nid]
                kwargs: Dict[str, Any] = {}
                for name, value in node.inputs.items():
                    if isinstance(value, (list, tuple)) and len(value) == 2 \
                            and not isinstance(value[0], (list, dict)) \
                            and isinstance(value[1], int) \
                            and str(value[0]) in graph.nodes:
                        kwargs[name] = outputs[str(value[0])][int(value[1])]
                    else:
                        kwargs[name] = value
                for hname, hval in node.hidden.items():
                    if hname in op.HIDDEN:
                        kwargs[hname] = hval
                debug_log(f"exec node {nid} ({node.class_type})")
                t0 = time.perf_counter()
                with trace_mod.node_scope(nid), \
                        trace_mod.span(node.class_type, node=nid), \
                        torch.no_grad():
                    outputs[nid] = op.execute(self.ctx, **kwargs)
                    if on_cuda:
                        # inside the span, so the node's span ends with
                        # its device work
                        torch.cuda.synchronize(self.ctx.device)
                        max_memory[nid] = torch.cuda.max_memory_allocated(
                            self.ctx.device)
                timings[nid] = time.perf_counter() - t0
                trace_mod.GLOBAL_NODES.record(node.class_type, timings[nid])
        total = time.perf_counter() - t_start
        self.ctx.node_timings.update(timings)
        return ExecutionResult(outputs=outputs,
                               images=list(self.ctx.saved_images),
                               timings=timings, total_s=total,
                               stages=dict(self.ctx.stage_seconds),
                               node_max_memory=max_memory,
                               transfers=run_transfers.snapshot())
