"""Workflow executor: topo-ordered op execution on one device, the
counterpart of ``comfyui_distributed_tpu/workflow/executor.py`` at fanout
1.

Each node runs under ``utils.trace.node_scope`` (its device copies are
attributed to it) and a span named for its ``class_type`` in the active
request trace (none outside a job), and its seconds go to the per-type
``GLOBAL_NODES`` histogram.  A run's copies between host and device are
also kept in a run-local ledger, ``ExecutionResult.transfers``.

``hidden`` maps node ids to per-run hidden-input overrides (the
coalescing scheduler's ``coalesced_seeds``); they reach the ops and
``OpContext.hidden_overrides`` and never change the graph.  With the
reuse plane on (``DTPU_CACHE``), one pass before the run computes each
addressable node's input sub-graph key (``runtime/reuse.subgraph_keys``),
set as ``OpContext.content_key`` while the node runs: the encode memo's
key.  Output nodes run on the context's host pool when it has one; the
result's ``images`` are then whole after :meth:`ExecutionResult.wait_host`.
With the resource plane on (``DTPU_RESOURCE``), each node's span gets
``mem_peak_mb``, the rise of the device's peak memory over the node
(``utils/resource.device_memory_snapshot``: the card's, or this
process's resident set on the CPU) where it rose, as the JAX executor
sets it; ``cli trace`` prints it.

Continuous batching drives two runs of its own: ``cb_capture`` runs a
graph up to its KSampler, which records its inputs and stops the walk
(``ops.base.CBCapture``), and a decode tail passes the finished latent
as the KSampler's ``cb_latent`` with ``prompt_json`` the client's whole
graph for the PNGs.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from comfyui_distributed_tpu_torch.ops.base import CBCapture, OpContext, get_op
from comfyui_distributed_tpu_torch.runtime import reuse as reuse_mod
from comfyui_distributed_tpu_torch.utils import resource as resource_mod
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
    # output nodes' host work still on the host pool, one future a
    # collecting node in topological order; ``images`` is whole after
    # wait_host()
    image_futures: List[Any] = dataclasses.field(default_factory=list)
    # prompts the coalescing scheduler merged into this run
    coalesced: int = 1
    # the run's live transfer ledger: deferred copies count into it after
    # the run's snapshot, so wait_host takes it again
    _transfer_stats: Any = None

    def wait_host(self, timeout: Optional[float] = None
                  ) -> "ExecutionResult":
        """Join the deferred host work into ``images``; raises what it
        raised."""
        futures, self.image_futures = self.image_futures, []
        for f in futures:
            out = f.result(timeout)
            if out:
                self.images.extend(out)
        if futures and self._transfer_stats is not None:
            self.transfers = self._transfer_stats.snapshot()
        return self

    @property
    def image_batch(self) -> Optional[np.ndarray]:
        if not self.images:
            return None
        return np.stack(self.images, axis=0)


class WorkflowExecutor:
    def __init__(self, ctx: Optional[OpContext] = None):
        self.ctx = ctx or OpContext()

    def execute(self, workflow: Any,
                hidden: Optional[Dict[str, Dict[str, Any]]] = None,
                cb_capture: Optional[Dict[str, Any]] = None,
                prompt_json: Optional[Any] = None) -> ExecutionResult:
        """Run a workflow (path, JSON, dict or Graph), with ``hidden``
        (node id -> hidden-input overrides) for this run.  Node timings
        end in a device synchronize, so each is the node's own device
        time.  ``cb_capture``: a dict arms the bucket build's run (see
        the module docstring), whose result holds the outputs before the
        KSampler; ``prompt_json``: the graph SaveImage embeds (default:
        this one)."""
        graph = workflow if isinstance(workflow, Graph) \
            else parse_workflow(workflow)
        hidden = hidden or {}
        reuse_keys: Dict[str, str] = {}
        if reuse_mod.reuse_enabled():
            reuse_keys = reuse_mod.subgraph_keys(
                graph, hidden, input_dir=self.ctx.input_dir,
                models_dir=self.ctx.models_dir)
        # fresh lists: an earlier result keeps its own
        self.ctx.saved_images = []
        self.ctx.image_futures = []
        self.ctx.stage_seconds = {}
        self.ctx.prompt_json = prompt_json if prompt_json is not None \
            else graph.to_api_format()
        self.ctx.hidden_overrides = dict(hidden)
        self.ctx.cb_capture = cb_capture
        on_cuda = torch.device(self.ctx.device).type == "cuda"
        outputs: Dict[str, Tuple] = {}
        timings: Dict[str, float] = {}
        max_memory: Dict[str, int] = {}
        order = graph.topo_order()
        # an unported node type fails the run before any node runs
        ops = {nid: get_op(graph.nodes[nid].class_type) for nid in order}
        run_transfers = trace_mod.TransferStats()
        # one memory probe a node boundary: a node's start is the
        # previous node's end
        res_on = resource_mod.resource_enabled()
        prev_mem = resource_mod.device_memory_snapshot(self.ctx.device) \
            if res_on else None
        t_start = time.perf_counter()
        with trace_mod.transfer_sink(run_transfers):
            for nid in order:
                node = graph.nodes[nid]
                op = ops[nid]
                self.ctx.content_key = reuse_keys.get(nid)
                kwargs: Dict[str, Any] = {}
                for name, value in node.inputs.items():
                    if isinstance(value, (list, tuple)) and len(value) == 2 \
                            and not isinstance(value[0], (list, dict)) \
                            and isinstance(value[1], int) \
                            and str(value[0]) in graph.nodes:
                        kwargs[name] = outputs[str(value[0])][int(value[1])]
                    else:
                        kwargs[name] = value
                # the graph's hidden inputs, then this run's overrides
                for hname, hval in {**node.hidden,
                                    **hidden.get(nid, {})}.items():
                    if hname in op.HIDDEN:
                        kwargs[hname] = hval
                debug_log(f"exec node {nid} ({node.class_type})")
                t0 = time.perf_counter()
                try:
                    with trace_mod.node_scope(nid), \
                            trace_mod.span(node.class_type, node=nid) as nsp, \
                            torch.no_grad():
                        outputs[nid] = op.execute(self.ctx, **kwargs)
                        if on_cuda:
                            # inside the span, so the node's span ends
                            # with its device work
                            torch.cuda.synchronize(self.ctx.device)
                            max_memory[nid] = \
                                torch.cuda.max_memory_allocated(
                                    self.ctx.device)
                        if res_on:
                            mem = resource_mod.device_memory_snapshot(
                                self.ctx.device)
                            rise = mem["peak_bytes_in_use"] \
                                - prev_mem["peak_bytes_in_use"]
                            prev_mem = mem
                            if nsp is not None and rise > 0:
                                nsp.attrs["mem_peak_mb"] = round(
                                    rise / 1e6, 2)
                except CBCapture:
                    # the bucket build: the sampler's inputs are in
                    # ctx.cb_capture, and the tail must not run
                    break
                timings[nid] = time.perf_counter() - t0
                trace_mod.GLOBAL_NODES.record(node.class_type, timings[nid])
        total = time.perf_counter() - t_start
        self.ctx.content_key = None
        self.ctx.cb_capture = None
        self.ctx.node_timings.update(timings)
        return ExecutionResult(outputs=outputs,
                               images=list(self.ctx.saved_images),
                               timings=timings, total_s=total,
                               stages=dict(self.ctx.stage_seconds),
                               node_max_memory=max_memory,
                               transfers=run_transfers.snapshot(),
                               image_futures=list(self.ctx.image_futures),
                               coalesced=max(int(self.ctx.coalesce), 1),
                               _transfer_stats=run_transfers)
