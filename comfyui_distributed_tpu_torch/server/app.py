"""The master/worker HTTP server of the port: the subset of
``comfyui_distributed_tpu/server/app.py`` that the fan-out needs, on the
standard library's ``ThreadingHTTPServer`` (no ``aiohttp``).

Same routes, JSON bodies, multipart field names and status codes as the
JAX package's, so a worker of either package keeps to a master of the
other:

- ``GET /prompt`` (the preflight probe), ``POST /prompt`` (queue a
  graph; on a master, a graph with distributed nodes and no
  ``multi_job_id`` fans out to the enabled workers: the headless
  interceptor), ``GET /history``;
- ``POST /distributed/prepare_job``, ``GET /distributed/queue_status``,
  ``GET /distributed/wire_formats``, ``POST /distributed/job_complete``
  and ``/distributed/tile_complete`` (404 for an unknown job, so the
  sender retries), ``POST /distributed/load_image``,
  ``POST /upload/image``;
- ``GET /distributed/config``, ``POST /distributed/config/update_worker``
  and ``/distributed/config/delete_worker``;
- ``GET /distributed/metrics``: ``prompts_executed``, ``prompts_failed``,
  ``images_received``, ``tiles_received``, the messages and bytes
  received by wire format, the seconds spent decoding them
  (``wire_decode_s``), and the JAX package's ``phases``, ``nodes``,
  ``tracing``, ``pipeline`` (stages, event counters, gauges),
  ``cluster``, ``durability``, ``shard``, ``admission``, ``slo``,
  ``analysis``, ``reuse``, ``resources``, ``batching`` (``{"enabled":
  false}`` without continuous batching), ``autoscale`` (the autoscaler's
  snapshot, or ``{"enabled": false}`` unarmed) and ``chaos`` (the armed
  spec and its injection counters) blocks and ``transfers``;
- observability (``utils/trace.py``, ``trace_export.py``,
  ``trace_analysis.py``, ``resource.py``): ``GET
  /distributed/metrics.prom`` (Prometheus text), ``/distributed/traces``
  (the flight recorder's index), ``/distributed/trace/<prompt_id>`` (one
  job's spans and their tree), ``/distributed/analysis`` (critical-path
  profiles, the straggler scorecard, clock skews), ``/distributed/resource``
  (this process's sample), ``/distributed/cluster/metrics`` and
  ``/distributed/cluster/metrics.prom`` (the federated resource view of
  the master and its workers) and ``POST /distributed/profile/start``,
  ``/stop`` and ``GET /distributed/profile/status`` (a
  ``torch.profiler`` Chrome trace of whatever runs in between);
- the control plane: ``POST /distributed/register`` and
  ``/distributed/heartbeat`` (a worker's lease; unknown workers join),
  ``GET /distributed/cluster`` (lease states, the work ledger's active
  and finished jobs, the fault and hedge policy), with the JAX package's
  bodies and keys;
- worker management (``runtime/manager.py``): ``POST
  /distributed/launch_worker`` (404 for an id not in the config, 409
  when it runs), ``/distributed/stop_worker`` (404 when not managed),
  ``GET /distributed/managed_workers``, ``GET /distributed/worker_log``
  (``?id=`` and ``?bytes=``), ``POST /distributed/worker/clear_launching``;
- control: ``POST /interrupt`` (the running prompt stops at its next
  sampler step and ends as an error), ``/distributed/cluster/interrupt``
  (every enabled worker too), ``/distributed/clear_memory`` (the
  pipeline caches, the garbage collector and ``torch.cuda.empty_cache``,
  with the bytes freed) and ``/distributed/cluster/clear_memory``,
  ``/distributed/config/update_setting`` and ``/update_master``, ``GET
  /distributed/network_info``, ``/distributed/status``,
  ``/distributed/workers_status`` (the health poller's last round),
  ``POST /distributed/metrics/reset`` (the counters and the aggregates;
  ``{"include_traces": true}`` the flight recorder too; 403 under
  ``DTPU_METRICS_RESET=0``) and ``GET /panel``, the page that drives
  them;
- the durability plane (``runtime/durable.py``): ``GET
  /distributed/durability`` (the lease, the log's size and sync lag,
  the recovery; ``{"enabled": false}`` without ``DTPU_WAL_DIR``), ``POST
  /distributed/takeover`` (a standby takes the expired lease, or a live
  one with ``{"force": true}``; 409 while another master's lives) and a
  worker's ``POST /distributed/rehome`` (its heartbeat follows a new
  master);
- admission and SLOs (``workflow/scheduler.py``, ``utils/slo.py``): a
  prompt's tenant class (``priority``, untagged = paid), the 429 ladder
  on the queued count (``DTPU_MAX_QUEUE``, per-class shed bars and token
  buckets) with a ``Retry-After`` header, 503 while draining, ``GET
  /distributed/slo`` (the burn rates of ``DTPU_SLO_SPEC``) and a
  request's ``slo_s`` deadline for its fan-out's hedging;
- sharded masters (``runtime/shard.py``, ``DTPU_SHARD_ID``): ``GET
  /distributed/ring``, ``POST /distributed/ring/gossip``; a prompt id
  another shard owns is forwarded one hop;
- the elastic fleet (``runtime/autoscale.py``, ``utils/chaos.py``): ``GET
  /distributed/fleet`` (the autoscaler's snapshot and decision ring with
  its live signal, the admission block, the registry's workers and the
  chaos spec; ``{"enabled": false, "armed_env": ...}`` on a worker or
  without ``DTPU_AUTOSCALE=1``); under ``DTPU_CHAOS`` a request on a
  scoped route may get a 503 or a delay before its handler runs, and an
  upload a corruption that fails its decode with a 500;
- ``POST /distributed/warmup`` (one txt2img-shaped request of a
  checkpoint on zeros, its seconds by stage; ``DTPU_WARMUP`` runs one at
  :func:`serve`'s start) and ``GET /distributed/preview/<prompt_id>``
  (server-sent events: the terminal ``done`` event; a queued prompt
  whose last client disconnects is abandoned and never runs; 403 under
  ``DTPU_PREVIEW=0``, 429 past ``DTPU_PREVIEW_MAX_CLIENTS``, 404 for an
  unknown id, with the JAX package's bodies).

With continuous batching on (``DTPU_CB=1`` or ``ServerState(cb=True)``;
``workflow/batch_executor.py``) its step executor consumes the queue
instead: an eligible prompt (``quick_eligible``, decided at enqueue)
joins its signature's running batch at a step boundary and leaves it,
decoded on a tail thread, when its schedule ends, parked to the host
under a higher class's arrival with ``DTPU_CB_PARK=1``; an ineligible
one runs as below on the executor's fallback thread; the queue depth
counts the slots and the decodes in flight.

Without it, the JAX package's default dispatch model: one execution thread runs the
queue through the port's ``WorkflowExecutor`` on the server's device,
the tenant classes in weighted fair order (FIFO within a class), handler
threads answering while it runs.  It pops a group: the head prompt and
the contiguous run of its class's signature-equal plain graphs behind
it, up to ``DTPU_MAX_COALESCE`` (8), run as one batched dispatch
(``DTPU_COALESCE=0``: one prompt a dispatch); history entries of a
merged group carry ``coalesced``.  Each group's finalize (the wait for
its images' copies, PNG encodes and writes on a ``HostIOPool``, history,
the log record, the prompt lines, the sealed traces) runs on a finalize
thread while the next group computes (``DTPU_OVERLAP=0``: inline).  The
reuse plane (``runtime/reuse.py``, ``DTPU_CACHE=0`` turns it off): a
byte-identical plain re-submission is settled from the exact-hit tier
at its admission (history ``cache_hit``, ``prompts_replayed``), the
encode memo and the tile tier work inside the run, and
``clear_memory`` empties all three.

Every prompt gets a trace: a ``job`` root span from its admission to
its end (a worker's takes the ``traceparent`` of the
master's ``dispatch`` span as its parent; a master's fan-out root covers
the ``preflight`` and ``dispatch`` spans too), a ``queue_wait`` event, an
``execute`` span over the run and a ``finalize`` span over the wait for
its host work; the root is committed to the flight recorder under the
prompt id, and to the capture files and the live analyzer behind it.
Each finished prompt logs one line, ``dtpu-torch prompt {...}``, with
its kernel launches by variant and by shape, its copies between host and
card by direction and ``torch.cuda.max_memory_allocated()``; in a merged
group the head's line carries the run's counts and each other's line
zeros and ``coalesced_into``.  A master owns a ``ClusterRegistry``
seeded from its config, a ``WorkLedger`` and a ``HealthPoller`` (started
by :func:`serve`) and a ``WorkerProcessManager``; a worker started with
``DTPU_MASTER_URL`` and ``DTPU_WORKER_ID`` heartbeats its master.  With
``DTPU_WAL_DIR`` a master takes the master lease (or, with
``DTPU_STANDBY=1``, watches it) and replays its write-ahead log before
the execution thread starts: each admission is logged before its prompt
id is answered and each finished prompt after its run, and :func:`serve`
resumes the interrupted prompts once the port is bound; a server's
resource monitor starts there too.  A sharded master's log is
``DTPU_SHARD_WAL_ROOT/<id>`` with its shard id as the lease owner, and
its peers' shards are watched for a takeover.  On SIGINT or SIGTERM
:func:`serve` drains: new prompts get 503, the queue, the running group,
the pending finalizes and the host pool run within
``DTPU_DRAIN_TIMEOUT_S`` and what is left is cancelled, its admission
left open in the log for a restart or the shard's absorbing peer.
"""

from __future__ import annotations

import base64
import collections
import concurrent.futures
import dataclasses
import gc
import http.client
import inspect
import itertools
import json
import math
import os
import queue
import select
import signal
import socket
import sys
import threading
import time
import traceback
import urllib.error
import urllib.parse
import urllib.request
import uuid
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from comfyui_distributed_tpu_torch.models import registry
from comfyui_distributed_tpu_torch.ops.base import OpContext
from comfyui_distributed_tpu_torch.ops.kernels import flash_attention as fa
from comfyui_distributed_tpu_torch.runtime import autoscale as autoscale_mod
from comfyui_distributed_tpu_torch.runtime import cluster as cluster_mod
from comfyui_distributed_tpu_torch.runtime import durable as durable_mod
from comfyui_distributed_tpu_torch.runtime import reuse as reuse_mod
from comfyui_distributed_tpu_torch.runtime import shard as shard_mod
from comfyui_distributed_tpu_torch.runtime.health import HealthPoller
from comfyui_distributed_tpu_torch.runtime import interrupt
from comfyui_distributed_tpu_torch.runtime.jobs import JobStore
from comfyui_distributed_tpu_torch.runtime.manager import (
    WorkerProcessManager,
    auto_launch_workers,
    install_exit_hooks,
)
from comfyui_distributed_tpu_torch.utils import chaos as chaos_mod
from comfyui_distributed_tpu_torch.utils import config as cfg_mod
from comfyui_distributed_tpu_torch.utils import constants as C
from comfyui_distributed_tpu_torch.utils import resource
from comfyui_distributed_tpu_torch.utils import slo as slo_mod
from comfyui_distributed_tpu_torch.utils import trace as trace_mod
from comfyui_distributed_tpu_torch.utils import trace_analysis as analysis_mod
from comfyui_distributed_tpu_torch.utils import trace_export as export_mod
from comfyui_distributed_tpu_torch.utils.image import (
    decode_png,
    decode_tensor,
    tensor_codecs,
)
from comfyui_distributed_tpu_torch.utils.log import debug_log, log
from comfyui_distributed_tpu_torch.utils.net import (
    FormPart,
    HostIOPool,
    get_json,
    network_info,
    parse_multipart,
    request_json,
)
from comfyui_distributed_tpu_torch.workflow import WorkflowExecutor
from comfyui_distributed_tpu_torch.workflow import scheduler as sched_mod
from comfyui_distributed_tpu_torch.workflow.dispatcher import worker_url
from comfyui_distributed_tpu_torch.workflow.orchestrate import (
    is_dispatched_share,
    run_distributed,
)

# (status, body) or (status, body, the answer's extra headers)
Response = Tuple[Any, ...]
PROM_CONTENT_TYPE = "text/plain; version=0.0.4; charset=utf-8"
PANEL_HTML = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          "panel.html")


def _env_flag(name: str, default: str = "1") -> bool:
    return os.environ.get(name, default).lower() not in ("0", "false",
                                                         "off")


class QueueFullError(RuntimeError):
    """``enqueue_prompt`` met the ``DTPU_MAX_QUEUE`` cap."""


class ShedError(QueueFullError):
    """Admission shed the prompt (its class's bar or its client's token
    bucket); the rejection says why and for how long to back off."""

    def __init__(self, rejection: Dict[str, Any]):
        self.rejection = dict(rejection)
        super().__init__(
            f"shed ({rejection.get('reason')}) for tenant class "
            f"{rejection.get('tenant')!r}")


class UploadDecodeError(RuntimeError):
    """An upload's payload did not decode (a 500: the sender retries)."""


class DrainingError(RuntimeError):
    """``enqueue_prompt`` refused: the server is shutting down."""


@dataclasses.dataclass
class Raw:
    """A response body sent as it is (a route's payload is otherwise
    sent as JSON)."""
    data: bytes
    content_type: str


@dataclasses.dataclass
class Stream:
    """A streamed response: the handler sends the headers (no length,
    the connection closes at the end), then ``run(write, gone)``;
    ``write`` sends one chunk at once and raises ``OSError`` once the
    client is gone, and ``gone()`` says whether the client has closed
    its side (an end of file on a connection that sends nothing more)."""
    run: Callable[[Callable[[bytes], None], Callable[[], bool]], None]
    content_type: str


class ServerState:
    """Queue, history, metrics and result queues of one server."""

    def __init__(self, config_path: Optional[str] = None,
                 is_worker: bool = False,
                 input_dir: Optional[str] = None,
                 output_dir: Optional[str] = None,
                 models_dir: Optional[str] = None,
                 device: str = "cuda",
                 start_exec_thread: bool = True,
                 overlap: Optional[bool] = None,
                 coalesce: Optional[bool] = None,
                 cb: Optional[bool] = None):
        self.config_path = config_path
        self.is_worker = is_worker
        self.port: Optional[int] = None   # set by serve()
        self.input_dir = input_dir or os.path.join(os.getcwd(), "input")
        self.output_dir = output_dir or os.path.join(os.getcwd(), "output")
        self.models_dir = models_dir
        self.device = device
        self.jobs = JobStore()
        # the control plane: leases fed by the health poller, heartbeats
        # and data-plane POSTs; the collectors read both through OpContext
        self.cluster = cluster_mod.ClusterRegistry()
        self.ledger = cluster_mod.WorkLedger()
        if not is_worker:
            self.cluster.seed_from_config(
                cfg_mod.load_config(config_path).get("workers", []))
        self.manager = WorkerProcessManager(config_path=config_path,
                                            models_dir=models_dir)
        self.health = HealthPoller(config_path=config_path,
                                   manager=self.manager,
                                   registry=self.cluster)
        self.heartbeat: Optional[cluster_mod.HeartbeatSender] = None
        # the elastic fleet's reconciliation loop: serve() arms it on a
        # master under DTPU_AUTOSCALE=1 (runtime/autoscale.install)
        self.autoscaler: Optional[autoscale_mod.FleetAutoscaler] = None
        # the process-wide resource monitor; serve() starts it
        self.resources: Optional[resource.ResourceMonitor] = None
        self.fault_inject = cluster_mod.fault_injection()
        self.metrics: Dict[str, Any] = {
            "prompts_executed": 0, "prompts_failed": 0,
            "images_received": 0, "tiles_received": 0,
            "wire_tensor_msgs": 0, "wire_tensor_bytes": 0,
            "wire_png_msgs": 0, "wire_png_bytes": 0,
            "wire_decode_s": 0.0,
            "prompts_replayed": 0, "prompts_abandoned": 0,
        }
        self._history: Dict[str, Dict[str, Any]] = {}
        self._queue: list = []                        # guarded-by: _cond
        self._running = False                         # guarded-by: _cond
        self._draining = False                        # guarded-by: _cond
        # every admitted prompt not yet finalized (queued, running or in
        # its finalize): the preview route's liveness check
        self._inflight: set = set()                   # guarded-by: _cond
        self._finalize_pending = 0                    # guarded-by: _cond
        self._exec_started = bool(start_exec_thread)
        self._cond = threading.Condition()
        # held by a dispatch from its kernel-count reset to its read and
        # by a warmup: the counts and the peak memory are process-wide,
        # so a prompt line counts its own group's work alone
        self._device_lock = threading.Lock()
        # the default dispatch model: coalesced groups, finalized on
        # their own thread while the next group runs
        self.overlap_enabled = _env_flag(C.OVERLAP_ENV) \
            if overlap is None else bool(overlap)
        self.coalesce_enabled = _env_flag(C.COALESCE_ENV) \
            if coalesce is None else bool(coalesce)
        self.coalesce_max = max(1, int(os.environ.get(
            C.COALESCE_MAX_ENV, C.COALESCE_MAX_DEFAULT)))
        # continuous batching: the step executor (batch_executor.py)
        # takes the queue; off by default
        self.cb_enabled = _env_flag(C.CB_ENV, "0") if cb is None \
            else bool(cb)
        self.cb: Optional[Any] = None
        self.host_pool = HostIOPool() if self.overlap_enabled else None
        # (group, result, error, t0, run stats) for the finalize thread,
        # in execution order
        self._finalize_q: "queue.Queue" = queue.Queue()
        # a test hook: the execution thread waits here before each pop,
        # so a caller can clear it, queue a burst and set it again
        self._exec_gate = threading.Event()
        self._exec_gate.set()
        self._metrics_lock = threading.Lock()
        self._id_counter = itertools.count()
        self.max_queue = int(os.environ.get(C.MAX_QUEUE_ENV,
                                            C.MAX_QUEUE_DEFAULT))
        # tenant classes: the shed ladder, token buckets and the weighted
        # fair dequeue; untagged traffic rides the highest class
        self.admission = sched_mod.AdmissionController()
        # the burn rates of DTPU_SLO_SPEC (record() does nothing without)
        self.slo = slo_mod.SLOEngine.from_env()
        # the monotonic time of each finalize: the drain rate the 429's
        # Retry-After is estimated from
        self._completions: collections.deque = collections.deque(
            maxlen=128)
        # a sharded master's config resolves before the log attaches:
        # its log is DTPU_SHARD_WAL_ROOT/<id>, its shard id the lease
        # owner, and its idempotency keys are scoped by the shard
        shard_cfg = None if is_worker else shard_mod.shard_config()
        shard_dir = shard_owner = None
        if shard_cfg is not None:
            self.jobs.set_scope(shard_cfg["id"])
            shard_owner = shard_cfg["id"]
            if shard_cfg.get("wal_root"):
                shard_dir = os.path.join(shard_cfg["wal_root"],
                                         shard_cfg["id"])
        # the durability plane: the lease taken (or watched), the log
        # replayed and the ledger and keys preloaded before the execution
        # thread can pop anything; a lease another master holds refuses
        # the start
        try:
            self.durable = durable_mod.DurableMaster.attach(
                self, dirpath=shard_dir, owner=shard_owner)
        except durable_mod.WalError as e:
            raise RuntimeError(f"durable master start refused: {e}") \
                from None
        # the ring, gossip and peer-lease watch attach after the log, so
        # an absorb merges into live planes; one client's rate splits
        # over the members
        self.shard = shard_mod.ShardManager.attach(
            self, cfg=shard_cfg, start_threads=start_exec_thread)
        if self.shard is not None:
            self.admission.set_rate_scale(1.0 / self.shard.n_members())
        if start_exec_thread:
            if self.cb_enabled:
                from comfyui_distributed_tpu_torch.workflow import \
                    batch_executor as cb_mod
                self.cb = cb_mod.ContinuousBatchExecutor(self)
                self.cb.start()
            else:
                threading.Thread(target=self._exec_loop, name="dtpu-exec",
                                 daemon=True).start()
            if self.overlap_enabled:
                threading.Thread(target=self._finalize_loop,
                                 name="dtpu-finalize", daemon=True).start()

    # --- queue ---------------------------------------------------------------

    def enqueue_prompt(self, prompt: Dict[str, Any],
                       extra_data: Optional[Dict[str, Any]] = None,
                       client_id: str = "unknown",
                       pid: Optional[str] = None,
                       _recovered: bool = False,
                       trace_parent: Optional[Tuple[str, str]] = None,
                       trace_span: Optional[trace_mod.Span] = None,
                       tenant: Optional[str] = None,
                       span_attrs: Optional[Dict[str, Any]] = None,
                       _preadmitted: bool = False,
                       _absorbed: bool = False) -> str:
        """Queue a prompt; returns its id.  With the log on, the admission
        is durable before the id is returned (a crash after it runs the
        prompt again on recovery).  ``pid`` and ``_recovered``: a prompt
        resumed from the log under its original id, whose record is
        there already and whose result queues are made here, as
        ``post_prompt`` makes them for a prepared graph; ``_absorbed``: a
        dead peer shard's, logged again here since its record lives in
        that shard's log.  Without ``pid`` a sharded master makes an id
        its own shard owns.

        The prompt is admitted here under the queue lock: refused while
        draining (:class:`DrainingError`), shed by its class's bar on the
        queued count or its client's bucket (:class:`ShedError`), refused
        at ``DTPU_MAX_QUEUE`` (:class:`QueueFullError`).  Recovered
        prompts and ``_preadmitted`` ones (a fan-out admitted before it
        dispatched, a master's dispatched share) skip the shed, not the
        cap.  ``tenant`` (else ``extra_data["priority"]``) is its class.

        The prompt's ``job`` span lives from here to the end of its run:
        ``trace_parent`` (trace id, parent span id) from an inbound
        ``traceparent`` makes it a child of the caller's trace (a
        dispatched worker share); ``trace_span`` is an open span adopted
        as the job span (a master's fan-out root); ``span_attrs`` are
        set on it."""
        if pid is None:
            pid = self.shard.local_pid(self._id_counter) \
                if self.shard is not None else uuid.uuid4().hex
        tenant = self.admission.classify(
            tenant or (extra_data or {}).get("priority"))
        sp = trace_span
        if sp is None:
            tid, par = trace_parent if trace_parent else (None, None)
            sp = trace_mod.start_span(
                "job", trace_id=tid, parent_id=par,
                attrs={"prompt_id": pid, "client_id": str(client_id),
                       "tenant": tenant,
                       "role": "worker" if self.is_worker else "master"})
        else:
            sp.attrs.setdefault("prompt_id", pid)
            sp.attrs.setdefault("tenant", tenant)
        if sp is not None:
            if self.shard is not None:
                sp.attrs["shard"] = self.shard.id
                sp.attrs["ring_epoch"] = self.shard.ring_epoch()
            sp.attrs.update(span_attrs or {})
        if _recovered:
            for kind, mj in _master_jobs(prompt):
                if kind == "tile":
                    self.jobs.prepare_tile_job(mj)
                else:
                    self.jobs.prepare_job(mj)
        # the signature and the step executor's screen are computed
        # outside the lock (they walk the graph); the pop only compares
        sig = sched_mod.coalesce_signature(prompt) \
            if (self.coalesce_enabled or self.cb_enabled) else None
        cb_ok = False
        if self.cb_enabled and sig is not None:
            from comfyui_distributed_tpu_torch.workflow import \
                batch_executor as cb_mod
            cb_ok = cb_mod.quick_eligible(prompt)
        # the exact-hit tier: a byte-identical re-submission is settled
        # from the stored images and never queued; a recovered prompt
        # always runs (its first run may not have stored)
        rkey = None
        if not self.is_worker and not _recovered \
                and reuse_mod.reuse_enabled():
            rkey = reuse_mod.result_key(prompt, input_dir=self.input_dir,
                                        models_dir=self.models_dir,
                                        scope=self.shard_cache_scope())
            if rkey is not None:
                entry = reuse_mod.get_reuse().result.get(rkey)
                if entry is not None:
                    self._replay_cached(pid, sp, entry)
                    return pid
        # a recovered prompt's record is in the log already, an absorbed
        # one's in the dead shard's
        to_log = threading.Event() if self.durable is not None and (
            not _recovered or _absorbed) else None
        reject: Optional[Tuple[Exception, str]] = None
        with self._cond:
            if self._draining:
                reject = (DrainingError("server is draining; not "
                                        "accepting prompts"),
                          "rejected: draining")
            elif not _recovered and not _preadmitted:
                rejection = self.admission.admit(
                    tenant, str(client_id), len(self._queue),
                    self.max_queue)
                if rejection is not None:
                    reject = (ShedError(rejection),
                              f"rejected: shed ({rejection['reason']}, "
                              f"{tenant})")
            if reject is None and len(self._queue) >= self.max_queue:
                reject = (QueueFullError(
                    f"prompt queue full ({self.max_queue})"),
                    "rejected: queue full")
            if reject is None:
                item = {"id": pid, "prompt": prompt,
                        "extra_data": extra_data or {}, "tenant": tenant,
                        "sig": sig, "cb": cb_ok, "rkey": rkey,
                        "span": sp, "t_enq": time.perf_counter(),
                        "logged": to_log}
                self._queue.append(item)
                self._inflight.add(pid)
                self._cond.notify()
        if reject is not None:
            self._abandon_span(sp, pid, reject[1])
            raise reject[0]
        if to_log is not None:
            # the admission record is durable before the id is answered,
            # written outside the queue lock (an fsync would stall every
            # pop and reader); the execution thread waits on ``logged``,
            # so no finalize is logged before its admission
            try:
                self.durable.log_enqueue(pid, prompt, client_id, extra_data)
            except Exception as e:
                with self._cond:
                    self._queue = [it for it in self._queue
                                   if it is not item]
                    self._inflight.discard(pid)
                item["log_error"] = e
                to_log.set()
                self._abandon_span(sp, pid, f"rejected: not logged ({e})")
                raise
            to_log.set()
        return pid

    def shard_cache_scope(self) -> Optional[str]:
        """The exact-hit tier's key scope on a sharded master: its shard
        id and log epoch, so shards never replay each other's entries
        and a deposed epoch's go cold after a takeover.  None (keys
        unchanged) without sharding."""
        if self.shard is None:
            return None
        epoch = self.durable.epoch if self.durable is not None else 0
        return f"{self.shard.id}:e{epoch}"

    def _replay_cached(self, pid: str, sp: Optional[trace_mod.Span],
                       entry: Dict[str, Any]) -> None:
        """Settle an exact hit now from its stored images: a success
        history entry marked ``cache_hit``, the job span marked
        ``cache_hit``/``cache_tier``.  It counts as ``prompts_replayed``
        alone: nothing ran, nothing was admitted, no slot freed."""
        done_t = time.time()
        self.bump(prompts_replayed=1)
        trace_mod.GLOBAL_COUNTERS.bump("cache_result_replays")
        trace_mod.GLOBAL_STAGES.record("cache_replay", 0.0)
        self._history[pid] = {
            "status": "success",
            "images": len(entry.get("images", ())),
            "duration_s": 0.0,
            "cache_hit": True,
            "finished_at": done_t,
        }
        if sp is not None:
            sp.attrs["cache_hit"] = True
            sp.attrs["cache_tier"] = "result"
            sp.end()
            trace_mod.GLOBAL_TRACES.commit(
                pid, sp.trace_id, status="ok", root_span_id=sp.span_id,
                duration_s=round(done_t - sp.start_s, 6))

    def _abandon_span(self, sp: Optional[trace_mod.Span], pid: str,
                      why: str) -> None:
        """End and commit the job span of a prompt that never ran."""
        if sp is None or sp.end_s is not None:
            return
        sp.set_status("error", why)
        sp.end()
        trace_mod.GLOBAL_TRACES.commit(
            pid, sp.trace_id, status="error", root_span_id=sp.span_id,
            duration_s=round(time.time() - sp.start_s, 6))

    def queue_remaining(self) -> int:
        """Prompts queued or executing; with continuous batching the
        slots and the decodes in flight count too (not the parked
        rows)."""
        with self._cond:
            n = len(self._queue) + (1 if self._running else 0)
        if self.cb is not None:
            n += self.cb.active_prompts()
        return n

    def queued_by_class(self) -> Dict[str, int]:
        """Queued (not yet running) prompts by tenant class."""
        out = {cls: 0 for cls in self.admission.classes}
        with self._cond:
            for item in self._queue:
                cls = item.get("tenant") or self.admission.default_class
                out[cls] = out.get(cls, 0) + 1
        return out

    def drain_rate(self, window_s: float = 30.0) -> float:
        """Prompts finalized per second over the recent window (0.0
        before any finished)."""
        now = time.monotonic()
        recent = [t for t in list(self._completions) if now - t <= window_s]
        if not recent:
            return 0.0
        return len(recent) / max(now - min(recent), 0.5)

    def retry_after_hint(self, floor_s: float = 1.0) -> int:
        """Whole seconds a shed client should wait: about when a quarter
        of the backlog will have drained at the measured rate, in [1,
        30]; it spreads the retries, it reserves nothing."""
        depth = self.queue_remaining()
        rate = self.drain_rate()
        hint = 5.0 if rate <= 0 else max(depth, 1) / (4.0 * rate)
        return int(min(max(math.ceil(max(hint, floor_s)), 1), 30))

    def drain(self, timeout: Optional[float] = None) -> bool:
        """Graceful shutdown: refuse new prompts (503), let the queue, the
        running group, the pending finalizes and the host pool finish
        within ``timeout`` (default ``DTPU_DRAIN_TIMEOUT_S``), then
        cancel what is still queued (``cancelled: server drain
        timeout``, its admission left open in the log), interrupt the
        running group and stop the pool.  True when everything finished
        in time.  A sharded master first stops its gossip and its watch,
        so it absorbs no peer on its way out."""
        if timeout is None:
            timeout = float(os.environ.get(C.DRAIN_TIMEOUT_ENV,
                                           C.DRAIN_TIMEOUT_DEFAULT))
        if self.autoscaler is not None:
            # a reconciliation during the shutdown would spawn workers
            # into a dying fleet
            self.autoscaler.stop()
        if self.shard is not None:
            self.shard.stop()
        with self._cond:
            self._draining = True
        deadline = time.monotonic() + max(timeout, 0.0)
        while True:
            with self._cond:
                # without an execution thread only the running work can
                # drain
                idle = (not self._running and self._finalize_pending == 0
                        and (not self._queue or not self._exec_started))
            if idle and self.cb is not None:
                # slots, decodes, parked rows and fallback groups are
                # work in flight too
                idle = self.cb.idle()
            if idle and (self.host_pool is None
                         or self.host_pool.pending == 0):
                if self.cb is not None:
                    self.cb.stop()
                return True
            if time.monotonic() >= deadline:
                break
            time.sleep(0.05)
        # the queue goes first, or the execution thread would go on
        # popping (and clearing the interrupt) through the shutdown
        with self._cond:
            purged, self._queue = self._queue, []
            for item in purged:
                self._inflight.discard(item["id"])
        # their admission records stay open, so a restart or the shard's
        # absorbing peer runs them again
        done_t = time.time()
        for item in purged:
            self._abandon_span(item.get("span"), item["id"],
                               "cancelled: server drain timeout")
            self._history[item["id"]] = {
                "status": "error", "error": "cancelled: server drain timeout",
                "finished_at": done_t}
        self.bump(prompts_failed=len(purged))
        log(f"drain timeout after {timeout:.1f}s; cancelled {len(purged)} "
            f"queued prompt(s), interrupting the running one")
        interrupt.request_interrupt()
        if self.cb is not None:
            # a beat for the driver to abort its slots on the flag, then
            # its threads stop
            stop_by = time.monotonic() + 2.0
            while time.monotonic() < stop_by and not self.cb.idle():
                time.sleep(0.02)
            self.cb.stop()
        if self.host_pool is not None:
            self.host_pool.shutdown(wait=False)
        return False

    def warmup(self, ckpt_name: str, **kwargs: Any) -> Dict[str, float]:
        """Load ``ckpt_name`` and run one txt2img-shaped request on zeros
        (``DiffusionPipeline.warmup``), between dispatches: a running
        group's kernel counts and peak memory never take its work."""
        with self._device_lock:
            pipe = registry.load_pipeline(ckpt_name,
                                          models_dir=self.models_dir,
                                          device=self.device)
            return pipe.warmup(**kwargs)

    def bump(self, **counts: int) -> None:
        with self._metrics_lock:
            for k, v in counts.items():
                self.metrics[k] += v

    def _exec_loop(self) -> None:
        while True:
            with self._cond:
                while not self._queue:
                    self._cond.wait()
            # the test hook: a caller holding the gate stages a burst
            # that one pop then sees whole
            self._exec_gate.wait()
            self._purge_abandoned()
            group = self._pop_group()
            if not group:
                continue
            try:
                if len(group) == 1:
                    self._execute(group[0])
                else:
                    self._execute_group(group)
            finally:
                with self._cond:
                    self._running = False

    def _pop_group(self) -> list:
        """Pop the next dispatch group (``pop_fair_group``): the scheduled
        class's head prompt and, with coalescing on, the contiguous run
        of its class's signature-equal prompts behind it, up to
        ``DTPU_MAX_COALESCE``.  Each item waits for its own admission
        record (an item whose record failed was answered so, and drops
        out), and its wait goes into its trace."""
        with self._cond:
            if not self._queue:
                return []
            group = sched_mod.pop_fair_group(
                self._queue, self.admission,
                coalesce_max=self.coalesce_max if self.coalesce_enabled
                else 1)
            self._running = True
        for item in group:
            if item.get("logged") is not None:
                item["logged"].wait()
        # an item whose admission failed to log was answered so
        kept = [item for item in group if "log_error" not in item]
        now = time.perf_counter()
        now_wall = time.time()
        for item in kept:
            wait = now - item["t_enq"]
            trace_mod.GLOBAL_STAGES.record("queue_wait", wait)
            if item["span"] is not None:
                trace_mod.event_span("queue_wait", now_wall - wait,
                                     now_wall, parent=item["span"])
        if not kept:
            with self._cond:
                self._running = False
        return kept

    def _execute(self, item: Dict[str, Any]) -> None:
        """One prompt's dispatch."""
        self._execute_group([item])

    def _execute_group(self, group: list) -> None:
        """Run one dispatch group: a coalesced group as one merged run
        (``build_coalesced``, ``OpContext.coalesce``) under the head
        prompt's job span (each follower's span names its head in
        ``coalesced_into``), then hand the finalize over: to the
        finalize thread with the overlap on, so the next group starts at
        once, else inline.  The run's kernel counts and peak memory are
        read here, before the next group resets them."""
        with self._device_lock:
            # the process-wide flag (``runtime/interrupt.py``), as in the
            # JAX package: /interrupt sets it, each dispatch clears it at
            # its start
            interrupt.clear_interrupt()
            res, err, t0, stats = self._run_group(group)
        self._finalize_hand(group, res, err, t0, stats)

    def _run_group(self, group: list) -> tuple:
        """The group's run: ``(result, error, t0, run stats)``."""
        on_cuda = torch.device(self.device).type == "cuda"
        fa.reset_counts()
        if on_cuda:
            torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        first = group[0]
        k = len(group)
        ctx = OpContext(device=self.device, models_dir=self.models_dir,
                        input_dir=self.input_dir, output_dir=self.output_dir,
                        is_worker=self.is_worker, job_store=self.jobs,
                        cluster=self.cluster, ledger=self.ledger,
                        fault_inject=self.fault_inject,
                        host_pool=self.host_pool,
                        extra_pnginfo=first["extra_data"].get(
                            "extra_pnginfo"))
        started = time.time()
        for item in group:
            item["started_at"] = started
        res, err = None, None
        trace_mod.GLOBAL_COUNTERS.bump("exec_runs")
        try:
            # the run executes under the head prompt's job span: the node
            # and stage spans made inside attach to its trace
            with trace_mod.use_span(first["span"]), \
                    trace_mod.span("execute", coalesced=k):
                if k > 1:
                    graph, hidden = sched_mod.build_coalesced(
                        [it["prompt"] for it in group])
                    ctx.coalesce = k
                    trace_mod.GLOBAL_COUNTERS.bump("coalesced_batches")
                    trace_mod.GLOBAL_COUNTERS.bump("coalesced_prompts", k)
                    debug_log(f"coalesced {k} prompts into one dispatch "
                              f"({first['id']}..)")
                    for item in group[1:]:
                        if item["span"] is not None:
                            item["span"].attrs["coalesced_into"] = \
                                first["id"]
                    with trace_mod.stage("coalesced_batch"):
                        res = WorkflowExecutor(ctx).execute(graph,
                                                            hidden=hidden)
                else:
                    res = WorkflowExecutor(ctx).execute(first["prompt"])
            trace_mod.GLOBAL_STAGES.record("compute", res.total_s)
        except Exception as e:  # noqa: BLE001 - a bad group fails alone
            err = e
            traceback.print_exc()
        stats = {"launches": {v: fa.flash_attention.variants.get(v, 0)
                              for v in fa.VARIANTS},
                 "launches_by_shape": [[*key, n] for key, n in sorted(
                     fa.flash_attention.shapes.items())],
                 "max_memory_allocated": (torch.cuda.max_memory_allocated()
                                          if on_cuda else None)}
        return res, err, t0, stats

    def _finalize_hand(self, group: list, res, err, t0: float,
                       stats: Optional[Dict[str, Any]] = None) -> None:
        """Book a pending finalize and run it on the finalize thread (the
        overlap, when that thread runs) or here; the continuous-batching
        executor's entry too (its decodes, aborts and drops)."""
        with self._cond:
            self._finalize_pending += 1
        if self.overlap_enabled and self._exec_started:
            self._finalize_q.put((group, res, err, t0, stats))
        else:
            self._finalize_group(group, res, err, t0, stats)

    def _finalize_loop(self) -> None:
        while True:
            # no local keeps the job: its result holds the run's outputs
            # (the pipelines) and its error a traceback over the
            # executor's frames, which clear_memory must be able to free
            try:
                self._finalize_group(*self._finalize_q.get())
            except Exception:  # noqa: BLE001 - the next group still settles
                traceback.print_exc()

    def _purge_abandoned(self) -> int:
        """Client-gone cancellation of prompts still queued: each whose
        last preview client left is taken out before the pop and
        finalized ``abandoned`` (history, log record, sealed trace); it
        never runs."""
        bus = reuse_mod.PREVIEWS
        with self._cond:
            doomed = [it for it in self._queue
                      if bus.is_abandoned(it["id"])]
            if not doomed:
                return 0
            gone = {id(it) for it in doomed}
            self._queue = [it for it in self._queue if id(it) not in gone]
        err = reuse_mod.AbandonedError(
            "client disconnected before execution")
        for item in doomed:
            self._finalize_hand([item], None, err, time.perf_counter())
        return len(doomed)

    def _finalize_group(self, group: list, res, err, t0: float,
                        stats: Optional[Dict[str, Any]] = None) -> None:
        """Join the run's deferred host work, split the images per
        prompt, then for each prompt of the group: its history entry
        (``coalesced`` when merged), metrics, result-tier store, log
        record, SLO record, prompt line and sealed trace; the preview
        bus gets each terminal event."""
        stats = stats or _no_launches()
        try:
            if res is not None and err is None:
                try:
                    # under the head's span: the wait for the host edge
                    # shows in its trace
                    with trace_mod.use_span(group[0]["span"]), \
                            trace_mod.span("finalize"):
                        res.wait_host()
                except Exception as e:  # noqa: BLE001 - a host edge failed
                    err = e
                    traceback.print_exc()
            k = len(group)
            abandoned = isinstance(err, reuse_mod.AbandonedError)
            status = "ok" if err is None \
                else ("abandoned" if abandoned else "error")
            per_prompt = sched_mod.split_images(res.images, k) \
                if err is None else [[] for _ in group]
            reuse_on = reuse_mod.reuse_enabled()
            for j, (item, imgs) in enumerate(zip(group, per_prompt)):
                self._finalize_item(item, res, err, status, imgs, t0,
                                    stats if j == 0 else None, group,
                                    reuse_on)
            if abandoned:
                # not "prompt ...": that prefix is the prompt line's
                log(f"group {group[0]['id']} (x{k}) abandoned: {err}")
        finally:
            with self._cond:
                self._finalize_pending -= 1
                for item in group:
                    self._inflight.discard(item["id"])

    def _finalize_item(self, item: Dict[str, Any], res, err, status: str,
                       imgs: list, t0: float,
                       stats: Optional[Dict[str, Any]], group: list,
                       reuse_on: bool) -> None:
        """One prompt's share of a finalize.  ``stats`` (the run's kernel
        counts and peak memory) ride the head prompt's line alone, so
        the lines of a group sum to its run."""
        k = len(group)
        # a queue prepared before the run for a run that never reached
        # its collector or upscaler would take uploads for ever
        for kind, mj in _master_jobs(item["prompt"]):
            if kind == "tile":
                self.jobs.remove_tile_queue(mj)
            else:
                self.jobs.remove_job(mj)
        if self.durable is not None:
            # closes the admission record: a crash before this runs the
            # prompt again on recovery, one after it leaves it settled
            self.durable.log_exec_done(item["id"], status)
        done = {"prompt_id": item["id"],
                "status": {"ok": "success"}.get(status, status),
                "seconds": time.perf_counter() - t0}
        done.update(stats if stats is not None
                    else {**_no_launches(), "coalesced_into": group[0]["id"]})
        if k > 1:
            done["coalesced"] = k
        # metrics before history: a client that sees the prompt done
        # also sees it counted
        self._record_slo(item, err is None, t0)
        entry: Dict[str, Any] = {"tenant": item["tenant"],
                                 "started_at": item.get("started_at"),
                                 "finished_at": time.time()}
        if k > 1:
            entry["coalesced"] = k
        if err is None:
            self.bump(prompts_executed=1)
            entry.update(status="success", images=len(imgs),
                         duration_s=res.total_s)
            if reuse_on and item.get("rkey") and imgs:
                # the exact-hit tier: a byte-identical re-submission
                # replays these images
                reuse_mod.store_result(item["rkey"], imgs, res.total_s)
            if stats is not None:
                types = {n: node.get("class_type", "")
                         for n, node in item["prompt"].items()
                         if isinstance(node, dict)}
                done.update(node_seconds={f"{n} {types.get(n, '')}": v
                                          for n, v in res.timings.items()},
                            stage_seconds=res.stages,
                            transfers=_transfer_totals(res.transfers))
            done["images"] = len(imgs)
        elif status == "abandoned":
            self.bump(prompts_abandoned=1)
            entry.update(status="abandoned", error=str(err))
            done["error"] = str(err)
        else:
            self.bump(prompts_failed=1)
            entry.update(status="error", error=str(err))
            done["error"] = str(err)
        self._history[item["id"]] = {"status": entry.pop("status"),
                                     **entry}
        # a finished prompt frees a slot (the Retry-After estimate); the
        # class counts its completion
        self._completions.append(time.monotonic())
        if err is None:
            self.admission.on_complete(item["tenant"])
        log(f"prompt {json.dumps(done)}")
        self._seal_trace(item, status, err)
        reuse_mod.PREVIEWS.finish(item["id"], status)

    def _record_slo(self, item: Dict[str, Any], ok: bool,
                    t0: float) -> None:
        """Feed the SLO windows (every finished prompt, traced or not)
        with its seconds from admission, and mark a prompt over its
        class's latency bar with an ``slo_breach`` event span."""
        done_t = time.time()
        sp = item["span"]
        dur = round(done_t - sp.start_s, 6) if sp is not None \
            else max(time.perf_counter() - t0, 0.0)
        tenant = item["tenant"]
        self.slo.record(tenant, dur, ok)
        if sp is None:
            return
        thr = self.slo.latency_threshold(tenant)
        if thr is not None and dur > thr:
            trace_mod.event_span("slo_breach", done_t, done_t, parent=sp,
                                 attrs={"tenant": tenant,
                                        "threshold_s": thr})

    def _seal_trace(self, item: Dict[str, Any], status: str,
                    err: Optional[BaseException]) -> None:
        """End the prompt's job span and commit its trace to the flight
        recorder (the capture files and the live analyzer behind it),
        with the slow-job line past ``DTPU_SLOW_JOB_S``."""
        sp = item["span"]
        if sp is None:
            return
        if err is not None:
            sp.set_status(status, str(err))
        dur = round(time.time() - sp.start_s, 6)
        sp.end()
        # the end-to-end histogram with an exemplar: the bucket this job
        # landed in points at its trace
        trace_mod.GLOBAL_STAGES.record("job_e2e", dur, trace_id=sp.trace_id)
        trace_mod.GLOBAL_TRACES.commit(item["id"], sp.trace_id,
                                       status=status,
                                       root_span_id=sp.span_id,
                                       duration_s=dur)
        try:
            slow_thr = float(os.environ.get(C.SLOW_JOB_ENV, "0") or 0)
        except ValueError:
            slow_thr = 0.0
        if slow_thr > 0 and dur > slow_thr:
            stages = trace_mod.GLOBAL_TRACES.breakdown(sp.trace_id)
            stages.pop("job", None)
            top = sorted(stages.items(), key=lambda kv: -kv[1])[:8]
            mem = resource.device_memory_snapshot(self.device)
            log(f"SLOW job {item['id']} ({status}): {dur:.2f}s > "
                f"{slow_thr:g}s threshold; trace {sp.trace_id}; "
                f"mem device_peak={mem['peak_bytes_in_use'] / 1e6:.1f}MB "
                f"rss={resource.host_rss_bytes() / 1e6:.1f}MB "
                f"({mem['source']}); stages "
                + ", ".join(f"{n}={s:.2f}s" for n, s in top))

    # --- the interceptor -----------------------------------------------------

    def orchestration_config(self, prompt: Dict[str, Any]
                             ) -> Optional[Dict[str, Any]]:
        """The config when this prompt fans out, else None: this server is
        a master, the graph has distributed nodes that no orchestrator
        prepared yet, and a worker is enabled."""
        if self.is_worker or is_dispatched_share(prompt) or not any(
                isinstance(node, dict)
                and node.get("class_type") in C.DISTRIBUTED_NODE_TYPES
                for node in prompt.values()):
            return None
        cfg = cfg_mod.load_config(self.config_path)
        return cfg if cfg_mod.enabled_workers(cfg) else None

    def post_prompt(self, data: Dict[str, Any],
                    traceparent: Optional[str] = None,
                    forwarded_from: Optional[str] = None) -> Response:
        """``POST /prompt``: admit the prompt and queue it, or fan it out
        when this master orchestrates it.  ``traceparent`` (the request's
        header) parents the prompt's trace under the caller's span;
        malformed or absent, the prompt gets a trace of its own.

        ``priority`` (or ``extra_data.priority``) names the tenant class
        and ``slo_s`` a deadline for the fan-out's jobs; both ride
        ``extra_data``, which the log keeps.  A shed answers 429 with a
        ``Retry-After`` header, a draining server 503.  On a sharded
        master a ``prompt_id`` another shard owns is forwarded there
        once; ``forwarded_from`` (the header of such a hop) is never
        forwarded again."""
        prompt = data.get("prompt")
        if not isinstance(prompt, dict) or not prompt:
            return 400, {"error": "missing prompt"}
        with self._cond:
            draining = self._draining
        if draining:
            # refused before a fan-out could dispatch worker shares
            return 503, {"error": "server is draining; not accepting "
                                  "prompts"}
        pid_hint = str(data.get("prompt_id") or "") or None
        span_attrs = {"forwarded_from": forwarded_from} \
            if forwarded_from else None
        if self.shard is not None and pid_hint and not forwarded_from \
                and not self.shard.is_mine(pid_hint):
            fwd = self._forward_prompt(pid_hint, data, traceparent)
            if fwd is not None:
                return fwd
            # the owner is unreachable: taken here, where the span says
            # it landed, while the ring heals by gossip and absorb
            trace_mod.GLOBAL_COUNTERS.bump("shard_forward_fallbacks")
        # a master sent an already prepared graph: its tile queues exist
        # before execution starts, or a fast worker's tiles 404 through
        # every retry
        for kind, mj in _master_jobs(prompt):
            if kind == "tile":
                self.jobs.prepare_tile_job(mj)
        client_id = data.get("client_id", "unknown")
        extra_data = data.get("extra_data") or {}
        priority = data.get("priority") or extra_data.get("priority")
        tenant = self.admission.classify(priority)
        if priority:
            # the class rides extra_data, which the log keeps: a
            # recovered prompt runs at the same priority
            extra_data = {**extra_data, "priority": tenant}
        slo_s = data.get("slo_s") or extra_data.get("slo_s")
        try:
            slo_s = float(slo_s) if slo_s is not None else None
        except (TypeError, ValueError):
            slo_s = None
        if slo_s is not None and slo_s > 0:
            extra_data = {**extra_data, "slo_s": slo_s}
        trace_parent = trace_mod.parse_traceparent(traceparent)
        try:
            cfg = self.orchestration_config(prompt)
            if cfg is not None:
                # admitted before the fan-out: a prompt that will be shed
                # never reaches the workers; its master share is then
                # pre-admitted
                with self._cond:
                    depth = len(self._queue)
                rejection = self.admission.admit(
                    tenant, str(client_id), depth, self.max_queue)
                if rejection is not None:
                    return self._shed_response(rejection)
                return self._fan_out(prompt, cfg, client_id, extra_data,
                                     trace_parent, tenant, span_attrs,
                                     pid_hint)
            # a share a master dispatched was admitted where it entered
            # the cluster: a worker never sheds it
            pid = self.enqueue_prompt(
                prompt, extra_data, client_id, pid=pid_hint,
                trace_parent=trace_parent, tenant=tenant,
                span_attrs=span_attrs,
                _preadmitted=is_dispatched_share(prompt))
        except ShedError as e:
            return self._shed_response(e.rejection)
        except QueueFullError as e:
            retry_after = self.retry_after_hint()
            return (429, {"error": str(e),
                          "queue_remaining": self.queue_remaining(),
                          "retry_after_s": retry_after,
                          "max_queue": self.max_queue},
                    {"Retry-After": str(retry_after)})
        except DrainingError as e:
            return 503, {"error": str(e)}
        except Exception as e:  # noqa: BLE001 - reported to the client
            return 400, {"error": str(e)}
        return 200, {"prompt_id": pid, "number": self.queue_remaining()}

    def _shed_response(self, rejection: Dict[str, Any]) -> Response:
        """A shed's 429: why, for which class, and ``Retry-After``, the
        larger of the rejection's floor and the drain-rate estimate."""
        retry_after = max(int(rejection.get("retry_after_s", 1)),
                          self.retry_after_hint())
        return (429, {"error": f"shed ({rejection['reason']}): tenant "
                               f"class {rejection['tenant']!r}",
                      "tenant": rejection["tenant"],
                      "reason": rejection["reason"],
                      "retry_after_s": retry_after,
                      "queue_remaining": self.queue_remaining(),
                      "max_queue": self.max_queue},
                {"Retry-After": str(retry_after)})

    def _forward_prompt(self, pid: str, data: Dict[str, Any],
                        traceparent: Optional[str]) -> Optional[Response]:
        """Relay a prompt to the shard that owns its id, marked with
        ``SHARD_FORWARD_HEADER`` so the owner never forwards it again;
        the owner's answer (a 429's ``Retry-After`` too).  None when the
        owner cannot be reached."""
        owner = self.shard.owner_of(pid)
        url = self.shard.member_url(owner)
        if not url:
            return None
        headers = {C.SHARD_FORWARD_HEADER: self.shard.id}
        if traceparent:
            headers[C.TRACEPARENT_HEADER] = traceparent
        try:
            status, body, hdrs = request_json("POST", f"{url}/prompt", data,
                                              timeout=120, headers=headers)
        except Exception as e:  # noqa: BLE001 - taken here instead
            debug_log(f"shard: forward to {owner} failed: {e}")
            return None
        self.shard.forwards += 1
        trace_mod.GLOBAL_COUNTERS.bump("shard_forwarded")
        if isinstance(body, dict):
            body.setdefault("shard", owner)
            body["forwarded_from"] = self.shard.id
        ra = hdrs.get("Retry-After")
        return status, body, ({"Retry-After": ra} if ra is not None else {})

    def _fan_out(self, prompt: Dict[str, Any], cfg: Dict[str, Any],
                 client_id: str, extra_data: Dict[str, Any],
                 trace_parent: Optional[Tuple[str, str]],
                 tenant: Optional[str] = None,
                 span_attrs: Optional[Dict[str, Any]] = None,
                 pid: Optional[str] = None) -> Response:
        """The headless interceptor: one ``job`` root span covers the
        whole fan-out (the preflight and dispatch spans, the master's
        share, which adopts it, and the workers' shipped spans)."""
        tid, par = trace_parent if trace_parent else (None, None)
        root = trace_mod.start_span(
            "job", trace_id=tid, parent_id=par,
            attrs={"client_id": str(client_id), "role": "master",
                   "tenant": tenant, "fanout": True})
        host = cfg.get("master", {}).get("host") or "127.0.0.1"
        try:
            with trace_mod.use_span(root):
                out = run_distributed(
                    prompt, f"http://{host}:{self.port or 8288}",
                    lambda g: self.enqueue_prompt(
                        g.to_api_format(), extra_data, client_id, pid=pid,
                        trace_span=root, tenant=tenant,
                        span_attrs=span_attrs, _preadmitted=True),
                    cfg_mod.enabled_workers(cfg), job_store=self.jobs,
                    client_id=client_id, extra_data=extra_data,
                    cluster=self.cluster, ledger=self.ledger)
        except Exception:
            # the fan-out died before the execution thread adopted the
            # root: seal it here, so the failure leaves a trace
            if root is not None and root.end_s is None \
                    and not root.attrs.get("prompt_id"):
                root.set_status("error", "fan-out failed before enqueue")
                root.end()
                trace_mod.GLOBAL_TRACES.commit(
                    f"failed_{root.trace_id[:12]}", root.trace_id,
                    status="error", root_span_id=root.span_id,
                    duration_s=round(time.time() - root.start_s, 6))
            raise
        return 200, {"prompt_id": out["result"],
                     "number": self.queue_remaining(),
                     "workers": out["workers"],
                     "failed_workers": out["failed"]}

    def resume_recovered(self) -> int:
        """Queue again the prompts a crash interrupted (replayed from the
        log when this state was made); :func:`serve` calls it once the
        port is bound, since the recovery graphs name this master's URL.
        A second call does nothing."""
        return self.durable.resume() if self.durable is not None else 0

    # --- data plane ----------------------------------------------------------

    def decode_upload(self, part: FormPart):
        """An image or tile part -> [B, H, W, C] float32, by the part's
        content type (raw tensor or PNG), counted by format and timed.
        The chaos harness may corrupt the payload here: the decode then
        fails (a 500, :class:`UploadDecodeError`), the sender's retry
        delivers it clean, and the idempotency key counts it once."""
        t0 = time.perf_counter()
        data = part.data
        cm = chaos_mod.get_chaos()
        if cm.active:
            data = cm.corrupt(data, what="tile/image upload")
        tensor = (part.content_type or "").split(";")[0].strip() \
            == C.TENSOR_WIRE_CONTENT_TYPE
        try:
            out = decode_tensor(data) if tensor else decode_png(data)
        except Exception as e:  # noqa: BLE001 - any decode failure is a 500
            raise UploadDecodeError(
                f"upload decode failed: {type(e).__name__}: {e}") from e
        kind = "tensor" if tensor else "png"
        self.bump(**{f"wire_{kind}_msgs": 1,
                     f"wire_{kind}_bytes": len(data)},
                  wire_decode_s=time.perf_counter() - t0)
        trace_mod.GLOBAL_COUNTERS.bump(f"wire_{kind}_msgs")
        trace_mod.GLOBAL_COUNTERS.bump(f"wire_{kind}_bytes", len(data))
        return out

    def ingest_remote_trace(self, form: Dict[str, FormPart], name: str,
                            t_recv: float, traceparent: Optional[str],
                            attrs: Dict[str, Any]) -> None:
        """Stitch a data-plane POST into the job's trace: the peer's
        shipped spans (its last upload) go into the flight recorder,
        moved onto this master's clock by the registry's skew estimate
        for the sender, and the receive is an event span under the
        sender's span named in its ``traceparent``."""
        offset = 0.0
        wid = str(attrs.get("worker") or "")
        if wid and analysis_mod.skew_correction_enabled():
            offset = self.cluster.skew(wid)
        if "spans" in form:
            try:
                shipped = json.loads(form["spans"].text)
                if offset and isinstance(shipped, list):
                    for sd in shipped:
                        if not isinstance(sd, dict):
                            continue
                        for k in ("start_s", "end_s"):
                            if isinstance(sd.get(k), (int, float)):
                                sd[k] = sd[k] + offset
                trace_mod.GLOBAL_TRACES.ingest(shipped)
            except (ValueError, TypeError) as e:
                debug_log(f"bad spans field on {name}: {e}")
        tp = trace_mod.parse_traceparent(traceparent)
        if tp is not None:
            if offset:
                attrs = {**attrs, "skew_ms": round(offset * 1e3, 3)}
            trace_mod.event_span(name, t_recv, time.time(),
                                 trace_id=tp[0], parent_id=tp[1],
                                 attrs=attrs)


def _master_jobs(prompt: Dict[str, Any]):
    """(``"tile"`` or ``"image"``, ``multi_job_id``) of each master-side
    tiled upscaler and collecting collector of a prepared graph."""
    for node in prompt.values():
        if not isinstance(node, dict) \
                or node.get("class_type") not in C.DISTRIBUTED_NODE_TYPES:
            continue
        h = {**node.get("inputs", {}), **node.get("hidden", {})}
        if h.get("multi_job_id") and not h.get("is_worker") \
                and not h.get("pass_through"):
            yield ("tile" if node["class_type"] in C.UPSCALER_NODE_TYPES
                   else "image"), str(h["multi_job_id"])


def _no_launches() -> Dict[str, Any]:
    """A prompt line's kernel counts for a prompt that ran no kernel of
    its own (purged, or a coalesced group's follower)."""
    return {"launches": {v: 0 for v in fa.VARIANTS},
            "launches_by_shape": [], "max_memory_allocated": None}


def _transfer_totals(transfers: Dict[str, Dict[str, float]]
                     ) -> Dict[str, int]:
    """A run's transfer ledger summed over its nodes, by direction."""
    out = {"d2h_bytes": 0, "d2h_calls": 0, "h2d_bytes": 0, "h2d_calls": 0}
    for v in transfers.values():
        for k in out:
            out[k] += int(v.get(k, 0))
    return out


def _package_version() -> str:
    from comfyui_distributed_tpu_torch import __version__
    return __version__


def _form_text(form: Dict[str, FormPart], key: str, default: str = "") -> str:
    part = form.get(key)
    return part.text if part is not None else default


def routes(state: ServerState
           ) -> Dict[Tuple[str, str], Callable[..., Response]]:
    """(method, path) -> handler(body bytes, content type, query, the
    client's address) -> (status, JSON body or :class:`Raw`), or with a
    third item, the answer's extra headers.  A handler
    that takes ``headers`` gets the request's; a ``{name}`` segment of a
    path matches any one segment and comes in the query under ``name``."""

    def ok(**kw) -> Response:
        return 200, {"status": "ok", **kw}

    def json_body(body: bytes) -> Dict[str, Any]:
        data = json.loads(body or b"{}")
        if not isinstance(data, dict):
            raise ValueError("a JSON object is expected")
        return data

    def get_prompt(body, ctype, query, remote=None):
        return 200, {"exec_info": {"queue_remaining":
                                   state.queue_remaining()}}

    def post_prompt(body, ctype, query, remote=None, headers=None):
        headers = headers or {}
        return state.post_prompt(
            json_body(body),
            traceparent=headers.get(C.TRACEPARENT_HEADER),
            forwarded_from=headers.get(C.SHARD_FORWARD_HEADER))

    def history(body, ctype, query, remote=None):
        return 200, dict(state._history)

    def prepare_job(body, ctype, query, remote=None, headers=None):
        t_recv = time.time()
        data = json_body(body)
        mj = data.get("multi_job_id")
        if not mj:
            return 400, {"error": "missing multi_job_id"}
        if data.get("kind") == "tile":
            state.jobs.prepare_tile_job(str(mj))
        else:
            state.jobs.prepare_job(str(mj))
        tp = trace_mod.parse_traceparent(
            (headers or {}).get(C.TRACEPARENT_HEADER))
        if tp is not None:
            trace_mod.event_span("prepare_job", t_recv, time.time(),
                                 trace_id=tp[0], parent_id=tp[1],
                                 attrs={"job": str(mj)})
        return ok()

    def queue_status(body, ctype, query, remote=None):
        mj = query.get("multi_job_id", "")
        return 200, {"exists": state.jobs.has_tile_job(mj)
                     or state.jobs.has_job(mj),
                     "queue_remaining": state.queue_remaining()}

    def wire_formats(body, ctype, query, remote=None):
        return 200, {"formats": [C.TENSOR_WIRE_CONTENT_TYPE, "image/png"],
                     "tensor_codecs": tensor_codecs()}

    def job_complete(body, ctype, query, remote=None, headers=None):
        t_recv = time.time()
        form = parse_multipart(body, ctype)
        mj = _form_text(form, "multi_job_id")
        if not mj or "image" not in form:
            return 400, {"error": "missing fields"}
        item = {"worker_id": _form_text(form, "worker_id"),
                "is_last": _form_text(form, "is_last", "false").lower()
                == "true",
                "tensor": state.decode_upload(form["image"])}
        # an indexless sender's images keep their arrival order
        if "image_index" in form:
            item["image_index"] = int(_form_text(form, "image_index"))
        # the spans land before the item is queued: the drain may end
        # and the job's trace be committed the moment it is (a job with
        # no queue answers 404 below, and its sender retries)
        if state.jobs.has_job(mj):
            state.ingest_remote_trace(
                form, "receive_image", t_recv,
                (headers or {}).get(C.TRACEPARENT_HEADER),
                {"job": mj, "worker": item["worker_id"]})
        if not state.jobs.put_result(
                mj, item, idem_key=_form_text(form, "idem_key") or None):
            return 404, {"error": f"unknown job {mj}"}
        # a data-plane POST proves the sender alive: renew its lease
        state.cluster.touch(item["worker_id"])
        state.bump(images_received=1)
        return ok()

    def tile_complete(body, ctype, query, remote=None, headers=None):
        t_recv = time.time()
        form = parse_multipart(body, ctype)
        mj = _form_text(form, "multi_job_id")
        if not mj or "tile" not in form:
            return 400, {"error": "missing fields"}
        item = {"worker_id": _form_text(form, "worker_id"),
                "is_last": _form_text(form, "is_last", "false").lower()
                == "true",
                "tensor": state.decode_upload(form["tile"])}
        for key in ("tile_idx", "x", "y", "extracted_width",
                    "extracted_height", "padding"):
            item[key] = int(_form_text(form, key, "0"))
        if state.jobs.has_tile_job(mj):
            state.ingest_remote_trace(
                form, "receive_tile", t_recv,
                (headers or {}).get(C.TRACEPARENT_HEADER),
                {"job": mj, "worker": item["worker_id"],
                 "tile_idx": item["tile_idx"]})
        if not state.jobs.put_tile(
                mj, item, idem_key=_form_text(form, "idem_key") or None):
            return 404, {"error": f"unknown tile job {mj}"}
        state.cluster.touch(item["worker_id"])
        state.bump(tiles_received=1)
        return ok()

    def load_image(body, ctype, query, remote=None):
        name = str(json_body(body).get("image_name", ""))
        safe = os.path.normpath(name).lstrip(os.sep)
        if safe.startswith(".."):
            return 400, {"error": "bad path"}
        path = os.path.join(state.input_dir, safe)
        if not os.path.exists(path):
            return 404, {"error": f"not found: {name}"}
        with open(path, "rb") as f:
            return 200, {"image_data": base64.b64encode(f.read()).decode(),
                         "name": name}

    def upload_image(body, ctype, query, remote=None):
        img = parse_multipart(body, ctype).get("image")
        if img is None:
            return 400, {"error": "missing image"}
        name = os.path.basename(img.filename or "upload.png")
        os.makedirs(state.input_dir, exist_ok=True)
        with open(os.path.join(state.input_dir, name), "wb") as f:
            f.write(img.data)
        return 200, {"name": name, "subfolder": "", "type": "input"}

    def get_config(body, ctype, query, remote=None):
        return 200, cfg_mod.load_config(state.config_path)

    def update_worker(body, ctype, query, remote=None):
        data = json_body(body)
        if "id" not in data:
            return 400, {"error": "missing worker id"}
        result: Dict[str, Any] = {}
        cfg_mod.mutate_config(
            lambda cfg: result.update(cfg_mod.upsert_worker(cfg, data)),
            state.config_path)
        # the worker's lease described its old entry: a worker disabled
        # (so never probed) until its lease ran out would otherwise be
        # skipped as dead when enabled again; it starts over as unknown
        # and the preflight probes it
        state.cluster.forget(str(data["id"]))
        return ok(worker=result)

    def delete_worker(body, ctype, query, remote=None):
        wid = str(json_body(body).get("id"))
        found = []
        cfg_mod.mutate_config(
            lambda cfg: found.append(cfg_mod.delete_worker(cfg, wid)),
            state.config_path)
        if not found[0]:
            return 404, {"error": "worker not found"}
        state.cluster.forget(wid)
        return ok()

    def durability() -> Dict[str, Any]:
        return state.durable.stats() if state.durable is not None \
            else {"enabled": False}

    def metrics(body, ctype, query, remote=None):
        with state._metrics_lock:
            out = dict(state.metrics)
        tr = trace_mod.GLOBAL_TRACES
        return 200, {
            **out,
            "phases": trace_mod.GLOBAL_PHASES.snapshot(),
            # per-node-type op latency histograms
            "nodes": trace_mod.GLOBAL_NODES.snapshot(),
            # request tracing's health and the capture files' counters
            "tracing": {"enabled": trace_mod.tracing_enabled(),
                        "ring_size": tr.size(), "ring_max": tr.max_traces,
                        "dropped_spans": tr.dropped_spans,
                        "evictions": tr.eviction_count(),
                        "export": export_mod.stats()},
            # the stage timeline (queue_wait, compute, d2h, encode,
            # upload, job_e2e, ...), the event counters and gauges
            "pipeline": {**trace_mod.pipeline_snapshot(),
                         "overlap": state.overlap_enabled,
                         "coalesce": state.coalesce_enabled,
                         "max_queue": state.max_queue},
            # continuous batching: slots, buckets, parking, the flight
            # deck (cli flightdeck)
            "batching": (state.cb.snapshot() if state.cb is not None
                         else {"enabled": False}),
            "cluster": {**state.cluster.snapshot(),
                        "ledger": state.ledger.snapshot(),
                        "policy": cluster_mod.fault_policy(),
                        "hedge_armed": cluster_mod.hedge_armed()},
            "durability": durability(),
            # the ring, owned and absorbed shards, forwards
            "shard": (state.shard.snapshot() if state.shard is not None
                      else {"enabled": False}),
            # per-class admitted, shed and completed counts, the weights
            # and bars, the queue by class and the drain rate
            "admission": {**state.admission.snapshot(),
                          "queued_by_class": state.queued_by_class(),
                          "drain_rate_per_s": round(state.drain_rate(), 4),
                          "max_queue": state.max_queue},
            # the elastic fleet: the decision ring and its counters
            "autoscale": (state.autoscaler.snapshot()
                          if state.autoscaler is not None
                          else {"enabled": autoscale_mod.autoscale_armed()}),
            # the armed chaos spec and its injections (zeros unarmed)
            "chaos": chaos_mod.get_chaos().snapshot(),
            "slo": state.slo.evaluate(),
            # the live anomaly plane and the workers' clock skews
            "analysis": {**analysis_mod.LIVE.snapshot(),
                         "skew": state.cluster.skew_snapshot()},
            # the reuse plane's tiers (hits, misses, evictions, bytes
            # against their budgets) and the preview channel's gauges
            "reuse": {**reuse_mod.get_reuse().snapshot(),
                      "previews": reuse_mod.PREVIEWS.snapshot()},
            "resources": (state.resources.snapshot()
                          if state.resources is not None
                          else {"enabled": False}),
            # host<->device bytes per node
            **trace_mod.counters_snapshot()}

    def cluster_info(body, ctype, query, remote=None):
        return 200, {
            **state.cluster.snapshot(),
            "ledger": state.ledger.snapshot(),
            "policy": cluster_mod.fault_policy(),
            "hedge": {"armed": cluster_mod.hedge_armed(),
                      "min_progress_pct": cluster_mod.hedge_pct(),
                      "factor": cluster_mod.hedge_factor()}}

    def feed_skew(wid: str, data: Dict[str, Any]) -> None:
        """A clock-offset sample from a heartbeat or registration: this
        server's wall clock now less the body's ``sent_at`` (the
        worker's at send); the registry keeps the least-delayed one."""
        sent = data.get("sent_at")
        if sent is None:
            return
        try:
            state.cluster.update_skew(wid, time.time() - float(sent))
        except (TypeError, ValueError):
            pass

    def lease(renew: Callable[..., Dict[str, Any]]):
        """The register and heartbeat routes: the worker's id and
        address into the registry, its resource snapshot and a clock
        sample; the reply carries this server's clock, as the JAX
        package's does."""
        def handler(body, ctype, query, remote=None):
            data = json_body(body)
            wid = data.get("worker_id") or data.get("id")
            if not wid:
                return 400, {"error": "missing worker_id"}
            info = {k: data[k] for k in ("host", "port", "name")
                    if k in data}
            if remote:
                info.setdefault("host", remote)
            out = renew(str(wid), info=info)
            if isinstance(data.get("resources"), dict):
                state.cluster.update_resources(str(wid), data["resources"])
            feed_skew(str(wid), data)
            return ok(**out, master_time=time.time())
        return handler

    # --- worker management -------------------------------------------------

    def launch_worker(body, ctype, query, remote=None):
        wid = str(json_body(body).get("id"))
        cfg = cfg_mod.load_config(state.config_path)
        worker = next((w for w in cfg["workers"] if str(w.get("id")) == wid),
                      None)
        if worker is None:
            return 404, {"error": "worker not found"}
        try:
            entry = state.manager.launch_worker(
                worker, stop_on_master_exit=cfg["settings"].get(
                    "stop_workers_on_master_exit", True))
        except RuntimeError as e:
            return 409, {"error": str(e)}
        return ok(worker=entry)

    def stop_worker(body, ctype, query, remote=None):
        if not state.manager.stop_worker(str(json_body(body).get("id"))):
            return 404, {"error": "not managed"}
        return ok()

    def managed_workers(body, ctype, query, remote=None):
        return 200, state.manager.get_managed_workers()

    def worker_log(body, ctype, query, remote=None):
        try:
            text = state.manager.tail_log(
                query.get("id", ""),
                max_bytes=int(query.get("bytes", C.LOG_TAIL_BYTES)))
        except FileNotFoundError as e:
            return 404, {"error": str(e)}
        return 200, {"log": text}

    def clear_launching(body, ctype, query, remote=None):
        state.manager.clear_launching(str(json_body(body).get("id")))
        return ok()

    # --- control ---------------------------------------------------------------

    def to_workers(path: str, bodies: Optional[Dict[str, Any]] = None
                   ) -> Dict[str, Any]:
        """POST ``path`` on every enabled worker at once: worker id ->
        its status code, or the error's text when none came back;
        ``bodies`` collects each 200 answer's JSON."""
        results: Dict[str, Any] = {}

        def hit(w):
            wid = str(w["id"])
            req = urllib.request.Request(
                worker_url(w) + path, data=b"{}", method="POST",
                headers={"Content-Type": "application/json"})
            try:
                with urllib.request.urlopen(req, timeout=10) as r:
                    results[wid] = r.status
                    raw = r.read()
            except urllib.error.HTTPError as e:
                results[wid] = e.code
                return
            except (OSError, http.client.HTTPException) as e:
                results[wid] = str(e)
                return
            if bodies is not None:
                try:
                    bodies[wid] = json.loads(raw)
                except ValueError:
                    pass   # a body that is not JSON counts no bytes

        threads = [threading.Thread(target=hit, args=(w,)) for w in
                   cfg_mod.enabled_workers(cfg_mod.load_config(
                       state.config_path))]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        return results

    def interrupt_route(body, ctype, query, remote=None):
        interrupt.request_interrupt()
        log("interrupt requested")
        return ok()

    def cluster_interrupt(body, ctype, query, remote=None):
        results = to_workers("/interrupt")
        interrupt.request_interrupt()
        return ok(workers=results)

    def clear_memory(body, ctype, query, remote=None):
        before = resource.device_memory_snapshot(state.device)
        rss_before = resource.host_rss_bytes()
        registry.clear_pipeline_cache()
        # the reuse plane goes too, before the allocator gives memory
        # back: a reloaded checkpoint never meets an old entry, and the
        # encode tier's device bytes count in the freed ones
        cache_freed = reuse_mod.get_reuse().clear()
        for _ in range(3):
            gc.collect()
        if torch.device(state.device).type == "cuda":
            torch.cuda.empty_cache()
        after = resource.device_memory_snapshot(state.device)
        freed = max(before["bytes_in_use"] - after["bytes_in_use"], 0)
        log(f"cleared the pipeline caches (freed {freed / 1e6:.1f} MB, "
            f"reuse caches {cache_freed / 1e6:.1f} MB, "
            f"source={after['source']})")
        return ok(freed_bytes=freed, cache_freed_bytes=cache_freed,
                  device_bytes_before=before["bytes_in_use"],
                  device_bytes_after=after["bytes_in_use"],
                  host_rss_before=rss_before,
                  host_rss_after=resource.host_rss_bytes(),
                  source=after["source"])

    def cluster_clear_memory(body, ctype, query, remote=None):
        bodies: Dict[str, Any] = {}
        results = to_workers("/distributed/clear_memory", bodies)
        freed_by = {"master": clear_memory(body, ctype, query)[1][
            "freed_bytes"]}
        for wid, b in bodies.items():
            if isinstance(b, dict) and "freed_bytes" in b:
                freed_by[wid] = int(b["freed_bytes"])
        return ok(workers=results, freed_bytes=freed_by,
                  freed_bytes_total=sum(freed_by.values()))

    def update_setting(body, ctype, query, remote=None):
        data = json_body(body)
        if "key" not in data:
            return 400, {"error": "missing key"}
        cfg_mod.mutate_config(lambda cfg: cfg_mod.update_setting(
            cfg, data["key"], data.get("value")), state.config_path)
        return ok()

    def update_master(body, ctype, query, remote=None):
        data = json_body(body)
        # an explicit null deletes a field, an absent key leaves it alone
        fields = {k: data[k] for k in ("host", "port", "extra_args")
                  if k in data}
        cfg_mod.mutate_config(lambda cfg: cfg_mod.update_master(
            cfg, **fields), state.config_path)
        return ok()

    def get_network_info(body, ctype, query, remote=None):
        return 200, network_info()

    def status(body, ctype, query, remote=None):
        # the JAX package's mesh keys: a torch server is one device
        return 200, {"enabled": True,
                     "axes": {"data": 1, "tensor": 1, "seq": 1},
                     "num_participants": 1,
                     **resource.describe_devices(state.device),
                     "jobs": state.jobs.snapshot(),
                     "queue_remaining": state.queue_remaining(),
                     "is_worker": state.is_worker}

    def workers_status(body, ctype, query, remote=None):
        return 200, state.health.snapshot()

    def metrics_reset(body, ctype, query, remote=None):
        """Zero the metric counters and clear the aggregates (phases,
        stages, nodes, event counters, transfers), the capture files'
        counters, the live analyzer and the clock-skew estimates; with
        ``{"include_traces": true}`` the flight recorder too.  The prompt
        history and the capture files stay."""
        if os.environ.get(C.METRICS_RESET_ENV, "1").lower() \
                in ("0", "false", "off"):
            return 403, {"error": "metrics reset disabled "
                                  f"({C.METRICS_RESET_ENV}=0)"}
        data = json_body(body)
        with state._metrics_lock:
            for k, v in state.metrics.items():
                state.metrics[k] = type(v)()
        cleared = {"metrics": True, **trace_mod.reset_aggregate_metrics()}
        export_mod.reset_counters()
        cleared["export_counters"] = True
        analysis_mod.reset_live()
        cleared["analysis"] = True
        cleared["skew_estimates"] = state.cluster.reset_skew()
        state.slo.reset()
        cleared["slo_windows"] = True
        if data.get("include_traces"):
            trace_mod.GLOBAL_TRACES.reset()
            cleared["traces"] = True
        log(f"aggregate metrics reset (by {remote or 'unknown'})")
        return ok(cleared=cleared)

    # --- durability --------------------------------------------------------

    def durability_info(body, ctype, query, remote=None):
        return 200, durability()

    def takeover(body, ctype, query, remote=None):
        """Make this server the master: take the lease (expired, or any
        with ``{"force": true}``), replay the shared log, resume the
        interrupted prompts and re-home the workers.  A standby's watcher
        takes the same path when the lease expires."""
        if state.durable is None:
            return 409, {"error": f"durability off (set {C.WAL_DIR_ENV})"}
        data = json_body(body)
        try:
            out = state.durable.takeover(force=bool(data.get("force")))
        except durable_mod.LeaseHeldError as e:
            return 409, {"error": str(e)}
        return ok(**out)

    def rehome(body, ctype, query, remote=None):
        """A worker's side of a failover: a new master announces itself,
        the heartbeat follows it and registers there at once."""
        data = json_body(body)
        url = str(data.get("master_url", "")).rstrip("/")
        if not url:
            return 400, {"error": "missing master_url"}
        wid = str(data.get("worker_id", "")
                  or os.environ.get(C.WORKER_ID_ENV, ""))
        os.environ[C.MASTER_URL_ENV] = url
        if wid:
            os.environ.setdefault(C.WORKER_ID_ENV, wid)
        hb = state.heartbeat
        if hb is None and wid:
            hb = state.heartbeat = cluster_mod.HeartbeatSender(
                url, wid, port=state.port)
            hb.start()
        beat = hb.rehome(url) if hb is not None else False
        log(f"re-homed to master {url}"
            + ("" if beat else " (first heartbeat pending)"))
        return ok(master_url=url, heartbeat=hb is not None,
                  registered=beat)

    # --- observability ------------------------------------------------------

    def self_sample() -> Dict[str, Any]:
        """This process's resource sample, the queue depth read from
        this state (the process-wide monitor may be bound to another)."""
        return {**resource.fleet_sample(state.device),
                "queue_depth": state.queue_remaining()}

    def metrics_prom(body, ctype, query, remote=None):
        """Prometheus text: the stage, phase and node histograms, the
        event and transfer counters and the recorder's gauges, then this
        server's prompt and image counters, queue and worker gauges, the
        log's and the capture files' counters, the anomaly counter, the
        clock skews and the resource gauges."""
        with state._metrics_lock:
            m = dict(state.metrics)
        extra = [
            ("dtpu_build_info", "gauge",
             "Build identity (constant 1; labels carry the info).",
             [({"version": _package_version(), "torch": torch.__version__,
                "platform": "gpu" if torch.device(state.device).type
                == "cuda" else "cpu"}, 1)]),
            ("dtpu_prompts_executed_total", "counter",
             "Prompts executed to success.", [({}, m["prompts_executed"])]),
            ("dtpu_prompts_failed_total", "counter",
             "Prompts that finished in error.", [({}, m["prompts_failed"])]),
            ("dtpu_images_received_total", "counter",
             "Worker images received on /distributed/job_complete.",
             [({}, m["images_received"])]),
            ("dtpu_tiles_received_total", "counter",
             "Worker tiles received on /distributed/tile_complete.",
             [({}, m["tiles_received"])]),
            ("dtpu_queue_remaining", "gauge",
             "Prompts queued or executing.",
             [({}, state.queue_remaining())]),
            ("dtpu_queue_capacity", "gauge",
             "DTPU_MAX_QUEUE backpressure cap.", [({}, state.max_queue)]),
        ]
        queued = state.queued_by_class()
        adm = state.admission.snapshot()["per_class"]
        extra.extend([
            ("dtpu_tenant_queued", "gauge",
             "Queued prompts by tenant class.",
             [({"tenant": cls}, n) for cls, n in sorted(queued.items())]),
            ("dtpu_tenant_admitted_total", "counter",
             "Prompts admitted by tenant class.",
             [({"tenant": cls}, v["admitted"])
              for cls, v in sorted(adm.items())]),
            ("dtpu_tenant_shed_total", "counter",
             "Prompts shed (429) by tenant class and reason.",
             [({"tenant": cls, "reason": reason}, v[f"shed_{reason}"])
              for cls, v in sorted(adm.items())
              for reason in ("rate", "overload")]),
            ("dtpu_tenant_completed_total", "counter",
             "Prompts completed by tenant class.",
             [({"tenant": cls}, v["completed"])
              for cls, v in sorted(adm.items())]),
            ("dtpu_queue_drain_rate", "gauge",
             "Prompts finalized per second (recent window).",
             [({}, round(state.drain_rate(), 4))]),
        ])
        if state.cb is not None:
            # continuous batching: slots by state, the step executor's
            # counters, each bucket's step callables built (the JAX
            # package's retraces: one a pad, then none) and parking
            bsnap = state.cb.snapshot()
            extra.extend([
                ("dtpu_batch_slots", "gauge",
                 "Continuous-batching slots by state (all shape "
                 "buckets).",
                 [({"state": "active"}, bsnap["slots_active"]),
                  ({"state": "free"}, bsnap["slots_free"])]),
                ("dtpu_cb_admits_total", "counter",
                 "Prompts admitted into a running batch at a step "
                 "boundary.", [({}, bsnap["admits"])]),
                ("dtpu_cb_retires_total", "counter",
                 "Slots retired (prompt finished its steps and moved "
                 "to decode).", [({}, bsnap["retires"])]),
                ("dtpu_cb_steps_total", "counter",
                 "Batched denoise steps executed.",
                 [({}, bsnap["steps"])]),
                ("dtpu_cb_fallback_total", "counter",
                 "Prompts dispatched through the legacy fallback "
                 "executor.", [({}, bsnap["fallbacks"])]),
                ("dtpu_cb_bucket_retraces_total", "counter",
                 "Step callables a bucket built (one a pad; none in "
                 "steady state).",
                 [({"bucket": b["sig"]}, b["retraces"])
                  for b in bsnap["buckets"]]),
                ("dtpu_cb_parked", "gauge",
                 "Continuous-batching rows parked to host (started "
                 "jobs waiting on slot residency).",
                 [({}, bsnap["parked"])]),
                ("dtpu_cb_parks_total", "counter",
                 "Slots parked to host at a step boundary.",
                 [({}, bsnap["parks"])]),
                ("dtpu_cb_resumes_total", "counter",
                 "Parked rows resumed into a slot.",
                 [({}, bsnap["resumes"])]),
                ("dtpu_cb_preemptions_total", "counter",
                 "Parks forced by a higher-class admit (SLO "
                 "preemption; subset of parks).",
                 [({}, bsnap["preemptions"])]),
            ])
        # the reuse plane and the preview channel
        rs = reuse_mod.get_reuse().snapshot()
        pv = reuse_mod.PREVIEWS.snapshot()
        tiers = ("result", "embed", "tile")
        extra.extend([
            ("dtpu_cache_hits_total", "counter",
             "Reuse-cache hits by tier.",
             [({"tier": t}, rs[t]["hits"]) for t in tiers]),
            ("dtpu_cache_misses_total", "counter",
             "Reuse-cache misses by tier.",
             [({"tier": t}, rs[t]["misses"]) for t in tiers]),
            ("dtpu_cache_evictions_total", "counter",
             "Reuse-cache LRU evictions by tier.",
             [({"tier": t}, rs[t]["evictions"]) for t in tiers]),
            ("dtpu_cache_bytes", "gauge",
             "Bytes resident in the reuse cache by tier.",
             [({"tier": t}, rs[t]["bytes"]) for t in tiers]),
            ("dtpu_cache_replays_total", "counter",
             "Prompts settled by exact-hit replay.",
             [({}, m["prompts_replayed"])]),
            ("dtpu_cache_tiles_skipped_total", "counter",
             "Upscale tiles skipped via per-tile content hashes.",
             [({}, trace_mod.GLOBAL_COUNTERS.get("tiles_skipped"))]),
            ("dtpu_preview_clients", "gauge",
             "Attached SSE preview clients.",
             [({}, pv["clients"])]),
            ("dtpu_preview_events_total", "counter",
             "Progressive preview frames published.",
             [({}, trace_mod.GLOBAL_COUNTERS.get("preview_events"))]),
            ("dtpu_jobs_abandoned_total", "counter",
             "Jobs abandoned by client disconnect (queue purges + "
             "freed CB slots).",
             [({}, m["prompts_abandoned"])]),
        ])
        workers = state.cluster.snapshot()["workers"].values()
        extra.append(
            ("dtpu_cluster_workers", "gauge",
             "Registered workers by lease state.",
             [({"state": st}, sum(1 for w in workers if w["state"] == st))
              for st in (cluster_mod.HEALTHY, cluster_mod.SUSPECT,
                         cluster_mod.DEAD, cluster_mod.UNKNOWN,
                         cluster_mod.RETIRING)]))
        if state.durable is not None:
            ds = state.durable.stats()
            wal = ds.get("wal") or {}
            lease = ds.get("lease") or {}
            extra.extend([
                ("dtpu_wal_records_total", "counter",
                 "Records appended to the write-ahead job log.",
                 [({}, wal.get("records_appended", 0))]),
                ("dtpu_wal_bytes", "gauge",
                 "Live WAL segment bytes on disk.",
                 [({}, wal.get("bytes", 0))]),
                ("dtpu_wal_segments", "gauge",
                 "Live WAL segment files.", [({}, wal.get("segments", 0))]),
                ("dtpu_wal_unsynced_records", "gauge",
                 "Appended records not yet fsync'd (sync lag).",
                 [({}, wal.get("unsynced_records", 0))]),
                ("dtpu_wal_last_sync_age_seconds", "gauge",
                 "Seconds since the last WAL fsync.",
                 [({}, wal.get("last_sync_age_s", 0) or 0)]),
                ("dtpu_master_epoch", "gauge",
                 "This process's master-lease epoch (fencing token); "
                 "0 = standby.", [({}, ds.get("epoch", 0))]),
                ("dtpu_master_lease_remaining_seconds", "gauge",
                 "Seconds until the observed master lease expires.",
                 [({}, max(lease.get("expires_in_s", 0) or 0, 0))]),
                ("dtpu_master_takeovers_total", "counter",
                 "Lease takeovers performed by this process.",
                 [({}, ds.get("takeovers", 0))]),
            ])
        if state.shard is not None:
            ssnap = state.shard.snapshot()
            extra.extend([
                ("dtpu_shard_owner", "gauge",
                 "Shards owned by this master (1 per owned shard; an "
                 "absorbed peer's shard appears after takeover).",
                 [({"shard": sh}, 1) for sh in ssnap["owned"]]),
                ("dtpu_ring_epoch", "gauge",
                 "Consistent-hash ring membership epoch.",
                 [({}, ssnap["ring_epoch"])]),
                ("dtpu_shard_members", "gauge",
                 "Members in this master's ring view.",
                 [({}, len(ssnap["members"]))]),
                ("dtpu_shard_forwards_total", "counter",
                 "Mis-routed /prompt submissions forwarded to their "
                 "owning shard.", [({}, ssnap["forwards"])]),
                ("dtpu_shard_takeovers_total", "counter",
                 "Dead peer shards absorbed by this master.",
                 [({}, ssnap["takeovers"])]),
            ])
        if state.autoscaler is not None:
            asnap = state.autoscaler.snapshot()
            extra.extend([
                ("dtpu_autoscale_scale_ups_total", "counter",
                 "Autoscaler scale-up actions.",
                 [({}, asnap["scale_ups"])]),
                ("dtpu_autoscale_scale_downs_total", "counter",
                 "Autoscaler scale-down actions.",
                 [({}, asnap["scale_downs"])]),
                ("dtpu_autoscale_flaps_total", "counter",
                 "Direction reversals inside the flap window "
                 "(should stay 0).", [({}, asnap["flaps"])]),
                ("dtpu_autoscale_retiring", "gauge",
                 "Workers currently draining toward retirement.",
                 [({}, len(asnap["retiring"]))]),
            ])
        exp = export_mod.stats()
        if exp.get("enabled"):
            extra.extend([
                ("dtpu_trace_export_traces_total", "counter",
                 "Committed traces appended to capture segments.",
                 [({}, exp["exported"])]),
                ("dtpu_trace_export_dropped_total", "counter",
                 "Capture records dropped (disk errors or "
                 "unserializable payloads).", [({}, exp["dropped"])]),
                ("dtpu_trace_export_bytes_total", "counter",
                 "Bytes appended to capture segments.",
                 [({}, exp["bytes_written"])]),
                ("dtpu_trace_export_rotations_total", "counter",
                 "Capture segment rotations.", [({}, exp["rotations"])]),
                ("dtpu_trace_export_retired_total", "counter",
                 "Oldest capture segments deleted by the retention cap.",
                 [({}, exp["retired_segments"])]),
            ])
        extra.extend(state.slo.prom_families())
        extra.append(
            ("dtpu_analysis_anomalies_total", "counter",
             "Per-trace category blame exceeding the armed baseline "
             "profile's tolerance.", [({}, analysis_mod.anomalies_total())]))
        skews = state.cluster.skew_snapshot()
        if skews:
            extra.append(
                ("dtpu_clock_skew_seconds", "gauge",
                 "Estimated worker-clock offset vs this master "
                 "(min-filtered heartbeat one-way samples).",
                 [({"worker_id": w}, sk["offset_s"])
                  for w, sk in sorted(skews.items())]))
        extra.extend(resource.resource_prom_families({"": self_sample()}))
        return 200, Raw(trace_mod.prometheus_text(extra=extra).encode(),
                        PROM_CONTENT_TYPE)

    def list_traces(body, ctype, query, remote=None):
        """The flight recorder's index, newest first."""
        return 200, {"traces": trace_mod.GLOBAL_TRACES.index(),
                     "ring_max": trace_mod.GLOBAL_TRACES.max_traces,
                     "tracing_enabled": trace_mod.tracing_enabled()}

    def get_trace(body, ctype, query, remote=None):
        """One finished job's spans and their tree."""
        pid = query.get("prompt_id", "")
        rec = trace_mod.GLOBAL_TRACES.get(pid)
        if rec is None:
            return 404, {"error": f"no recorded trace for {pid!r} "
                                  "(completed jobs only; ring keeps the "
                                  "most recent "
                                  f"{trace_mod.GLOBAL_TRACES.max_traces})"}
        rec["tree"] = trace_mod.build_span_tree(rec["spans"])
        return 200, rec

    def analysis(body, ctype, query, remote=None):
        """Critical-path profiles over the flight recorder's ring (``cli
        analyze``), with the ledger's hedging estimates, the live
        anomaly plane and the clock skews."""
        report = analysis_mod.analyze_records(
            trace_mod.GLOBAL_TRACES.records())
        ledger = state.ledger.snapshot()
        return 200, {**report,
                     "hedging_latency_ema_s": {
                         jid: j.get("latency_estimate_s")
                         for jid, j in ledger.get("active_jobs", {}).items()},
                     "live": analysis_mod.LIVE.snapshot(),
                     "skew": state.cluster.skew_snapshot()}

    def resource_info(body, ctype, query, remote=None):
        """This participant's resource sample and monitor state: what
        the master's federation pulls when a heartbeat's is stale."""
        return 200, {"resources": self_sample(),
                     "monitor": (state.resources.snapshot()
                                 if state.resources is not None
                                 else {"enabled": False})}

    # worker id -> monotonic time of its last failed pull
    pull_failed_at: Dict[str, float] = {}

    def fleet_resources() -> Dict[str, Any]:
        """The master's and its workers' resources merged: each worker's
        last heartbeat snapshot, pulled live from its
        ``/distributed/resource`` when older than ``DTPU_RES_FED_TTL_S``
        (a failed pull is not tried again within the TTL); a dead
        worker keeps its last snapshot, marked stale."""
        try:
            ttl = float(os.environ.get(C.RES_FED_TTL_ENV,
                                       C.RES_FED_TTL_DEFAULT))
        except ValueError:
            ttl = C.RES_FED_TTL_DEFAULT
        now = time.monotonic()
        reg = state.cluster.resource_snapshots()
        to_pull = [(wid, v) for wid, v in reg.items()
                   if v.get("host") and v.get("port")
                   and v["state"] != cluster_mod.DEAD
                   and (v["age_s"] is None or v["age_s"] > ttl)
                   and now - pull_failed_at.get(wid, -1e9) > ttl]

        def pull(item):
            wid, v = item
            try:
                got = get_json(f"http://{v['host']}:{v['port']}"
                               "/distributed/resource", timeout=2)
                if isinstance(got.get("resources"), dict):
                    state.cluster.update_resources(wid, got["resources"])
                    pull_failed_at.pop(wid, None)
                    return
            except (OSError, ValueError, http.client.HTTPException) as e:
                debug_log(f"resource pull from {wid} failed: {e}")
            pull_failed_at[wid] = time.monotonic()

        if to_pull:
            with concurrent.futures.ThreadPoolExecutor(len(to_pull)) as ex:
                list(ex.map(pull, to_pull))
            reg = state.cluster.resource_snapshots()
        self_id = "master" if not state.is_worker \
            else os.environ.get(C.WORKER_ID_ENV, "self")
        participants: Dict[str, Any] = {
            self_id: {"state": "self", "resources": self_sample(),
                      "age_s": 0.0, "stale": False}}
        for wid, v in reg.items():
            if wid == self_id:
                wid = f"{wid}@registry"
            participants[wid] = {
                "state": v["state"], "host": v.get("host"),
                "port": v.get("port"), "resources": v["resources"],
                "age_s": v["age_s"],
                "stale": v["age_s"] is None or v["age_s"] > ttl}
        return {"participants": participants, "ttl_s": ttl}

    def cluster_metrics(body, ctype, query, remote=None):
        return 200, fleet_resources()

    def cluster_metrics_prom(body, ctype, query, remote=None):
        """The federated view as Prometheus gauges, one series a
        participant (``worker_id``)."""
        parts = fleet_resources()["participants"]
        fams = resource.resource_prom_families(
            {wid: p.get("resources") for wid, p in parts.items()},
            ages={wid: p.get("age_s") for wid, p in parts.items()})
        fams.append(("dtpu_res_participants", "gauge",
                     "Participants in the federated resource view.",
                     [({}, len(parts))]))
        return 200, Raw(trace_mod.render_prom_families(fams).encode(),
                        PROM_CONTENT_TYPE)

    def profile_start(body, ctype, query, remote=None):
        """Start a ``torch.profiler`` trace (``{"dir": ...}`` optional);
        409 while one runs."""
        data = json_body(body)
        try:
            out = trace_mod.start_device_trace(data.get("dir"))
        except RuntimeError as e:
            return 409, {"error": str(e)}
        return ok(dir=out)

    def profile_stop(body, ctype, query, remote=None):
        """Stop it and write ``<dir>/trace.json``; 409 when none runs."""
        try:
            out = trace_mod.stop_device_trace()
        except RuntimeError as e:
            return 409, {"error": str(e)}
        return ok(dir=out, file=os.path.join(out, trace_mod.TRACE_FILE))

    def profile_status(body, ctype, query, remote=None):
        return 200, trace_mod.trace_status()

    # --- SLOs and the ring ---------------------------------------------------

    def slo_view(body, ctype, query, remote=None):
        """Per-class objectives with each window's stats, burn rates and
        the budget left (``cli slo`` reads this)."""
        return 200, state.slo.evaluate()

    def ring_info(body, ctype, query, remote=None):
        """The ring: members, epoch, vnodes, what a router or a client
        needs to place a prompt id."""
        if state.shard is None:
            return 200, {"enabled": False}
        return 200, state.shard.ring_snapshot()

    def ring_gossip(body, ctype, query, remote=None):
        """A peer's ring view merged; the answer is this master's."""
        if state.shard is None:
            return 409, {"error": f"sharding off (set {C.SHARD_ID_ENV})"}
        return 200, state.shard.merge_gossip(json_body(body))

    # --- warmup and previews ---------------------------------------------

    def warmup(body, ctype, query, remote=None):
        """Run one txt2img-shaped request on zeros for a checkpoint
        (``DiffusionPipeline.warmup``), so the next matching prompt pays
        no first-use cost.  Body: ``ckpt_name`` and optionally
        ``width``, ``height``, ``batch``, ``steps``, ``cfg``,
        ``sampler_name``, ``scheduler``, ``denoise``."""
        data = json_body(body)
        ckpt = data.get("ckpt_name", "model.safetensors")
        kwargs = {k: data[k] for k in
                  ("height", "width", "batch", "steps", "cfg",
                   "sampler_name", "scheduler", "denoise") if k in data}
        return ok(ckpt_name=ckpt, timings=state.warmup(ckpt, **kwargs))

    def prompt_live(pid: str) -> bool:
        """Admitted and not yet finalized (an unknown id must never arm
        an abandonment or pin a client slot)."""
        with state._cond:
            return pid in state._inflight

    def preview_stream(body, ctype, query, remote=None):
        """Server-sent events for one prompt: ``event: preview`` frames
        when a publisher sends them, then one ``event: done`` with its
        status.  The stream is also the cancellation channel: when the
        last client of a queued prompt disconnects, the prompt is
        abandoned and purged before it runs."""
        if not reuse_mod.previews_enabled():
            return 403, {"error": f"previews disabled "
                                  f"({C.PREVIEW_ENV}=0)"}
        pid = query.get("prompt_id", "")
        if pid not in state._history and not prompt_live(pid):
            return 404, {"error": f"unknown prompt {pid!r} (not queued, "
                                  "not executing, not in history)"}
        bus = reuse_mod.PREVIEWS
        q = bus.subscribe(pid)
        if q is None:
            return 429, {"error": "too many preview clients"}

        def run(write: Callable[[bytes], None],
                gone: Callable[[], bool]) -> None:
            disconnected = False
            try:
                last_beat = time.monotonic()
                while True:
                    if gone():
                        raise ConnectionResetError("client closed")
                    try:
                        ev = q.get_nowait()
                    except queue.Empty:
                        ev = None
                    if ev is None:
                        hist = state._history.get(pid)
                        if hist is not None:
                            ev = {"type": "done", "prompt_id": pid,
                                  "status": hist.get("status", "done")}
                        else:
                            if time.monotonic() - last_beat >= 1.0:
                                # a comment between frames: a write to a
                                # closed connection raises
                                write(b": ping\n\n")
                                last_beat = time.monotonic()
                            time.sleep(0.05)
                            continue
                    write(f"event: {ev['type']}\n"
                          f"data: {json.dumps(ev)}\n\n".encode())
                    if ev.get("type") == "done":
                        break
            except OSError:
                # BrokenPipeError, ConnectionResetError: the client left
                disconnected = True
            finally:
                remaining = bus.unsubscribe(pid, q)
                if disconnected and remaining == 0 \
                        and pid not in state._history and prompt_live(pid):
                    bus.abandon(pid)
                    with state._cond:
                        state._cond.notify()
                    if pid in state._history:
                        # the prompt settled between the check and the
                        # flag: nothing else would consume it
                        bus.clear_abandoned(pid)

        return 200, Stream(run, "text/event-stream")

    def fleet_info(body, ctype, query, remote=None):
        """The elastic fleet: the autoscaler's snapshot with the live
        signal it scales on, the admission block, the registry's
        workers and the chaos spec (``cli fleet`` renders it)."""
        scaler = state.autoscaler
        snap = {"enabled": False,
                "armed_env": autoscale_mod.autoscale_armed()}
        signal = None
        if scaler is not None:
            snap = scaler.snapshot()
            signal = scaler.fleet_signal()
        return 200, {
            "autoscale": {**snap, "signal": signal},
            "admission": {
                **state.admission.snapshot(),
                "queued_by_class": state.queued_by_class(),
                "drain_rate_per_s": round(state.drain_rate(), 4),
                "max_queue": state.max_queue,
            },
            "workers": state.cluster.snapshot()["workers"],
            "chaos": chaos_mod.get_chaos().snapshot(),
        }

    def panel(body, ctype, query, remote=None):
        with open(PANEL_HTML, "rb") as f:
            return 200, Raw(f.read(), "text/html; charset=utf-8")

    return {
        ("GET", "/prompt"): get_prompt,
        ("POST", "/prompt"): post_prompt,
        ("GET", "/history"): history,
        ("POST", "/distributed/prepare_job"): prepare_job,
        ("GET", "/distributed/queue_status"): queue_status,
        ("GET", "/distributed/wire_formats"): wire_formats,
        ("POST", "/distributed/job_complete"): job_complete,
        ("POST", "/distributed/tile_complete"): tile_complete,
        ("POST", "/distributed/load_image"): load_image,
        ("POST", "/upload/image"): upload_image,
        ("GET", "/distributed/config"): get_config,
        ("POST", "/distributed/config/update_worker"): update_worker,
        ("POST", "/distributed/config/delete_worker"): delete_worker,
        ("GET", "/distributed/metrics"): metrics,
        ("GET", "/distributed/cluster"): cluster_info,
        ("POST", "/distributed/register"): lease(state.cluster.register),
        ("POST", "/distributed/heartbeat"): lease(state.cluster.heartbeat),
        ("POST", "/distributed/launch_worker"): launch_worker,
        ("POST", "/distributed/stop_worker"): stop_worker,
        ("GET", "/distributed/managed_workers"): managed_workers,
        ("GET", "/distributed/worker_log"): worker_log,
        ("POST", "/distributed/worker/clear_launching"): clear_launching,
        ("POST", "/interrupt"): interrupt_route,
        ("POST", "/distributed/cluster/interrupt"): cluster_interrupt,
        ("POST", "/distributed/clear_memory"): clear_memory,
        ("POST", "/distributed/cluster/clear_memory"): cluster_clear_memory,
        ("POST", "/distributed/config/update_setting"): update_setting,
        ("POST", "/distributed/config/update_master"): update_master,
        ("GET", "/distributed/network_info"): get_network_info,
        ("GET", "/distributed/status"): status,
        ("GET", "/distributed/workers_status"): workers_status,
        ("POST", "/distributed/metrics/reset"): metrics_reset,
        ("GET", "/panel"): panel,
        ("GET", "/distributed/durability"): durability_info,
        ("POST", "/distributed/takeover"): takeover,
        ("POST", "/distributed/rehome"): rehome,
        ("GET", "/distributed/metrics.prom"): metrics_prom,
        ("GET", "/distributed/traces"): list_traces,
        ("GET", "/distributed/trace/{prompt_id}"): get_trace,
        ("GET", "/distributed/analysis"): analysis,
        ("GET", "/distributed/resource"): resource_info,
        ("GET", "/distributed/cluster/metrics"): cluster_metrics,
        ("GET", "/distributed/cluster/metrics.prom"): cluster_metrics_prom,
        ("POST", "/distributed/profile/start"): profile_start,
        ("POST", "/distributed/profile/stop"): profile_stop,
        ("GET", "/distributed/profile/status"): profile_status,
        ("GET", "/distributed/slo"): slo_view,
        ("GET", "/distributed/ring"): ring_info,
        ("POST", "/distributed/ring/gossip"): ring_gossip,
        ("POST", "/distributed/warmup"): warmup,
        ("GET", "/distributed/preview/{prompt_id}"): preview_stream,
        ("GET", "/distributed/fleet"): fleet_info,
    }


def _match(table, method: str, path: str
           ) -> Tuple[Optional[Callable[..., Response]], Dict[str, str]]:
    """The route for ``path`` and its ``{name}`` segments' values."""
    fn = table.get((method, path))
    if fn is not None:
        return fn, {}
    parts = path.split("/")
    for (m, pattern), f in table.items():
        if m != method or "{" not in pattern:
            continue
        pp = pattern.split("/")
        if len(pp) != len(parts):
            continue
        params = {}
        for want, got in zip(pp, parts):
            if want.startswith("{") and want.endswith("}"):
                if not got:
                    break
                params[want[1:-1]] = urllib.parse.unquote(got)
            elif want != got:
                break
        else:
            return f, params
    return None, {}


def make_handler(state: ServerState) -> type:
    table = routes(state)
    takes_headers = {fn for fn in table.values()
                     if "headers" in inspect.signature(fn).parameters}

    class Handler(BaseHTTPRequestHandler):
        def _dispatch(self, method: str) -> None:
            url = urllib.parse.urlsplit(self.path)
            query = dict(urllib.parse.parse_qsl(url.query))
            fn, params = _match(table, method, url.path)
            query.update(params)
            extra: Dict[str, str] = {}
            try:
                body = self.rfile.read(int(
                    self.headers.get("Content-Length") or 0))
                # the server's half of a flaky network, before the handler
                cm = chaos_mod.get_chaos()
                chaos_status, delay = cm.server_edge(url.path) \
                    if cm.active else (None, 0.0)
                if delay > 0:
                    time.sleep(delay)
                if chaos_status is not None:
                    status, payload = chaos_status, {
                        "error": "chaos: injected failure"}
                elif fn is None:
                    status, payload = 404, {"error": f"no route {method} "
                                                     f"{url.path}"}
                else:
                    kw = {"headers": {k.lower(): v for k, v in
                                      self.headers.items()}} \
                        if fn in takes_headers else {}
                    status, payload, *more = fn(
                        body, self.headers.get("Content-Type", ""), query,
                        self.client_address[0], **kw)
                    # a third item: headers of the answer (Retry-After)
                    extra = more[0] if more else {}
            except ValueError as e:
                status, payload = 400, {"error": str(e)}
            except Exception as e:  # noqa: BLE001 - a 500, not a dead thread
                traceback.print_exc()
                status, payload = 500, {"error": str(e)}
            if isinstance(payload, Stream):
                self._stream(status, payload)
                return
            if isinstance(payload, Raw):
                data, content_type = payload.data, payload.content_type
            else:
                data = json.dumps(payload).encode()
                content_type = "application/json"
            self.send_response(status)
            self.send_header("Content-Type", content_type)
            self.send_header("Content-Length", str(len(data)))
            for k, v in extra.items():
                self.send_header(k, v)
            self.end_headers()
            self.wfile.write(data)

        def _stream(self, status: int, payload: Stream) -> None:
            self.close_connection = True
            try:
                self.send_response(status)
                self.send_header("Content-Type", payload.content_type)
                self.send_header("Cache-Control", "no-cache")
                self.send_header("X-Accel-Buffering", "no")
                self.send_header("Connection", "close")
                self.end_headers()
                self.wfile.flush()
            except OSError:
                pass

            def write(data: bytes) -> None:
                self.wfile.write(data)
                self.wfile.flush()

            def gone() -> bool:
                try:
                    ready, _, _ = select.select([self.connection], [], [], 0)
                    return bool(ready) and not self.connection.recv(
                        1, socket.MSG_PEEK)
                except OSError:
                    return True

            payload.run(write, gone)

        def do_GET(self) -> None:
            self._dispatch("GET")

        def do_POST(self) -> None:
            self._dispatch("POST")

        def log_message(self, fmt: str, *args) -> None:
            pass

    return Handler


def make_server(state: ServerState, host: str = "127.0.0.1",
                port: int = 8288) -> ThreadingHTTPServer:
    """Bind (port 0 takes a free one) and record the port on the
    state; ``serve_forever()`` serves."""
    server = ThreadingHTTPServer((host, port), make_handler(state))
    server.daemon_threads = True
    state.port = server.server_address[1]
    return server


def serve(state: ServerState, host: str = "127.0.0.1",
          port: int = 8288) -> None:
    """Serve until SIGINT or SIGTERM: a master polls its workers' health,
    launches its enabled local workers when the config's
    ``settings.auto_launch_workers`` is true and stops its managed
    workers when it exits (so it must run on the main thread, which
    signal handlers need); a worker renews its lease at
    ``DTPU_MASTER_URL`` (or each of ``DTPU_MASTER_URLS``) as
    ``DTPU_WORKER_ID`` when both are set.  A durable master resumes its
    interrupted prompts once bound, on a thread (it probes the workers
    first).  The signal drains the server while it goes on answering
    (:meth:`ServerState.drain`: 503 to new prompts, the queue run within
    ``DTPU_DRAIN_TIMEOUT_S``), then stops it and closes the log."""
    server = make_server(state, host, port)
    role = "worker" if state.is_worker else "master"
    warmup_spec = os.environ.get(C.WARMUP_ENV)
    if warmup_spec and not state.is_worker:
        # DTPU_WARMUP='{"ckpt_name": ..., "width": ..., ...}': one
        # request's shapes run on zeros while the server already answers
        def startup_warmup() -> None:
            try:
                spec = json.loads(warmup_spec)
                state.warmup(spec.pop("ckpt_name", "model.safetensors"),
                             **spec)
            except Exception as e:  # noqa: BLE001 - warmup is best-effort
                log(f"startup warmup failed: {type(e).__name__}: {e}")

        threading.Thread(target=startup_warmup, daemon=True,
                         name="dtpu-warmup").start()
    state.resources = resource.install_monitor(
        queue_depth_fn=state.queue_remaining, device=state.device)
    if state.is_worker:
        state.heartbeat = cluster_mod.maybe_start_heartbeat(port=state.port)
    else:
        # the managed workers stop at exit, after the drain below
        install_exit_hooks(state.manager)
        state.health.start()
        # the elastic fleet under DTPU_AUTOSCALE=1: spawn on sustained
        # pressure, retire by drain and lease non-renewal
        state.autoscaler = autoscale_mod.install(state)
        auto_launch_workers(state.manager)
        if state.durable is not None:
            threading.Thread(target=state.resume_recovered,
                             name="dtpu-resume", daemon=True).start()
    draining: list = []

    def drain_then_stop() -> None:
        t0 = time.monotonic()
        ok = state.drain()
        log(f"drained in {time.monotonic() - t0:.3f}s"
            + ("" if ok else " (timed out)"))
        server.shutdown()

    def on_signal(signum, frame) -> None:
        # the drain runs while the server answers: /history stays
        # readable and a new /prompt gets 503
        if not draining:
            log(f"signal {signum}: draining")
            draining.append(threading.Thread(target=drain_then_stop,
                                             name="dtpu-drain"))
            draining[0].start()

    for sig in (signal.SIGINT, signal.SIGTERM):
        signal.signal(sig, on_signal)
    log(f"{role} listening on {host}:{state.port} (device {state.device})")
    sys.stdout.flush()
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        state.health.stop()
        if state.autoscaler is not None:
            state.autoscaler.stop()
        if state.heartbeat is not None:
            state.heartbeat.stop()
        if state.durable is not None:
            state.durable.close()
        server.server_close()
