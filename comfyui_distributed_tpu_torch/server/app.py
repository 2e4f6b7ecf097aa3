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
  (``wire_decode_s``) and the control plane's event counts
  (``cluster_counters``);
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
  ``POST /distributed/metrics/reset`` (403 under
  ``DTPU_METRICS_RESET=0``) and ``GET /panel``, the page that drives
  them;
- the durability plane (``runtime/durable.py``): ``GET
  /distributed/durability`` (the lease, the log's size and sync lag,
  the recovery; ``{"enabled": false}`` without ``DTPU_WAL_DIR``), ``POST
  /distributed/takeover`` (a standby takes the expired lease, or a live
  one with ``{"force": true}``; 409 while another master's lives) and a
  worker's ``POST /distributed/rehome`` (its heartbeat follows a new
  master).

One execution thread runs the queue in FIFO order through the port's
``WorkflowExecutor`` on the server's device; handler threads answer
while it runs.  Each finished prompt logs one line,
``dtpu-torch prompt {...}``, with its kernel launches by variant and by
shape and ``torch.cuda.max_memory_allocated()``.  A master owns a
``ClusterRegistry`` seeded from its config, a ``WorkLedger`` and a
``HealthPoller`` (started by :func:`serve`) and a
``WorkerProcessManager``; a worker started with ``DTPU_MASTER_URL`` and
``DTPU_WORKER_ID`` heartbeats its master.  With ``DTPU_WAL_DIR`` a
master takes the master lease (or, with ``DTPU_STANDBY=1``, watches it)
and replays its write-ahead log before the execution thread starts: each
admission is logged before its prompt id is answered and each finished
prompt after its run, and :func:`serve` resumes the interrupted prompts
once the port is bound.  Admission control, tracing and previews wait.
"""

from __future__ import annotations

import base64
import collections
import dataclasses
import gc
import http.client
import json
import os
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
from comfyui_distributed_tpu_torch.runtime import cluster as cluster_mod
from comfyui_distributed_tpu_torch.runtime import durable as durable_mod
from comfyui_distributed_tpu_torch.runtime.health import HealthPoller
from comfyui_distributed_tpu_torch.runtime import interrupt
from comfyui_distributed_tpu_torch.runtime.jobs import JobStore
from comfyui_distributed_tpu_torch.runtime.manager import (
    WorkerProcessManager,
    auto_launch_workers,
    install_exit_hooks,
)
from comfyui_distributed_tpu_torch.utils import config as cfg_mod
from comfyui_distributed_tpu_torch.utils import constants as C
from comfyui_distributed_tpu_torch.utils import resource
from comfyui_distributed_tpu_torch.utils.image import (
    decode_png,
    decode_tensor,
    tensor_codecs,
)
from comfyui_distributed_tpu_torch.utils.log import log
from comfyui_distributed_tpu_torch.utils.net import (
    FormPart,
    network_info,
    parse_multipart,
)
from comfyui_distributed_tpu_torch.workflow import WorkflowExecutor
from comfyui_distributed_tpu_torch.workflow.dispatcher import worker_url
from comfyui_distributed_tpu_torch.workflow.orchestrate import (
    is_dispatched_share,
    run_distributed,
)

Response = Tuple[int, Any]
PANEL_HTML = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          "panel.html")


@dataclasses.dataclass
class Raw:
    """A response body sent as it is (a route's payload is otherwise
    sent as JSON)."""
    data: bytes
    content_type: str


class ServerState:
    """Queue, history, metrics and result queues of one server."""

    def __init__(self, config_path: Optional[str] = None,
                 is_worker: bool = False,
                 input_dir: Optional[str] = None,
                 output_dir: Optional[str] = None,
                 models_dir: Optional[str] = None,
                 device: str = "cuda",
                 start_exec_thread: bool = True):
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
        self.fault_inject = cluster_mod.fault_injection()
        self.metrics: Dict[str, Any] = {
            "prompts_executed": 0, "prompts_failed": 0,
            "images_received": 0, "tiles_received": 0,
            "wire_tensor_msgs": 0, "wire_tensor_bytes": 0,
            "wire_png_msgs": 0, "wire_png_bytes": 0,
            "wire_decode_s": 0.0,
        }
        self._history: Dict[str, Dict[str, Any]] = {}
        self._queue: collections.deque = collections.deque()
        self._running = False
        self._cond = threading.Condition()
        self._metrics_lock = threading.Lock()
        # the durability plane: the lease taken (or watched), the log
        # replayed and the ledger and keys preloaded before the execution
        # thread can pop anything; a lease another master holds refuses
        # the start
        try:
            self.durable = durable_mod.DurableMaster.attach(self)
        except durable_mod.WalError as e:
            raise RuntimeError(f"durable master start refused: {e}") \
                from None
        if start_exec_thread:
            threading.Thread(target=self._exec_loop, name="dtpu-exec",
                             daemon=True).start()

    # --- queue ---------------------------------------------------------------

    def enqueue_prompt(self, prompt: Dict[str, Any],
                       extra_data: Optional[Dict[str, Any]] = None,
                       client_id: str = "unknown",
                       pid: Optional[str] = None,
                       _recovered: bool = False) -> str:
        """Queue a prompt; returns its id.  With the log on, the admission
        is durable before the id is returned (a crash after it runs the
        prompt again on recovery).  ``pid`` and ``_recovered``: a prompt
        resumed from the log under its original id, whose record is
        there already and whose result queues are made here, as
        ``post_prompt`` makes them for a prepared graph."""
        pid = pid or uuid.uuid4().hex
        if _recovered:
            for kind, mj in _master_jobs(prompt):
                if kind == "tile":
                    self.jobs.prepare_tile_job(mj)
                else:
                    self.jobs.prepare_job(mj)
        elif self.durable is not None:
            self.durable.log_enqueue(pid, prompt, client_id, extra_data)
        with self._cond:
            self._queue.append({"id": pid, "prompt": prompt,
                                "extra_data": extra_data or {}})
            self._cond.notify()
        return pid

    def queue_remaining(self) -> int:
        with self._cond:
            return len(self._queue) + (1 if self._running else 0)

    def bump(self, **counts: int) -> None:
        with self._metrics_lock:
            for k, v in counts.items():
                self.metrics[k] += v

    def _exec_loop(self) -> None:
        while True:
            with self._cond:
                while not self._queue:
                    self._cond.wait()
                item = self._queue.popleft()
                self._running = True
            try:
                self._execute(item)
            finally:
                with self._cond:
                    self._running = False

    def _execute(self, item: Dict[str, Any]) -> None:
        # the process-wide flag (``runtime/interrupt.py``), as in the JAX
        # package: /interrupt sets it, each prompt clears it at its start
        interrupt.clear_interrupt()
        on_cuda = torch.device(self.device).type == "cuda"
        fa.reset_counts()
        if on_cuda:
            torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        ctx = OpContext(device=self.device, models_dir=self.models_dir,
                        input_dir=self.input_dir, output_dir=self.output_dir,
                        is_worker=self.is_worker, job_store=self.jobs,
                        cluster=self.cluster, ledger=self.ledger,
                        fault_inject=self.fault_inject,
                        extra_pnginfo=item["extra_data"].get(
                            "extra_pnginfo"))
        res, err = None, None
        try:
            res = WorkflowExecutor(ctx).execute(item["prompt"])
        except Exception as e:  # noqa: BLE001 - a bad prompt fails alone
            err = e
            traceback.print_exc()
        finally:
            # a queue prepared before the run for a run that never
            # reached its collector or upscaler would take uploads for ever
            for kind, mj in _master_jobs(item["prompt"]):
                if kind == "tile":
                    self.jobs.remove_tile_queue(mj)
                else:
                    self.jobs.remove_job(mj)
        if self.durable is not None:
            # closes the admission record: a crash before this runs the
            # prompt again on recovery, one after it leaves it settled
            self.durable.log_exec_done(item["id"],
                                       "ok" if err is None else "error")
        done = {"prompt_id": item["id"],
                "status": "success" if err is None else "error",
                "seconds": time.perf_counter() - t0,
                "launches": {v: fa.flash_attention.variants.get(v, 0)
                             for v in fa.VARIANTS},
                "launches_by_shape": [[*k, n] for k, n in sorted(
                    fa.flash_attention.shapes.items())],
                "max_memory_allocated": (torch.cuda.max_memory_allocated()
                                         if on_cuda else None)}
        # metrics before history: a client that sees the prompt done
        # also sees it counted
        if err is None:
            self.bump(prompts_executed=1)
            self._history[item["id"]] = {
                "status": "success", "images": len(res.images),
                "duration_s": res.total_s, "finished_at": time.time()}
            types = {k: n.get("class_type", "")
                     for k, n in item["prompt"].items() if isinstance(n, dict)}
            done.update(images=len(res.images),
                        node_seconds={f"{k} {types.get(k, '')}": v
                                      for k, v in res.timings.items()},
                        stage_seconds=res.stages)
        else:
            self.bump(prompts_failed=1)
            self._history[item["id"]] = {
                "status": "error", "error": str(err),
                "finished_at": time.time()}
            done["error"] = str(err)
        log(f"prompt {json.dumps(done)}")

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

    def post_prompt(self, data: Dict[str, Any]) -> Response:
        prompt = data.get("prompt")
        if not isinstance(prompt, dict) or not prompt:
            return 400, {"error": "missing prompt"}
        # a master sent an already prepared graph: its tile queues exist
        # before execution starts, or a fast worker's tiles 404 through
        # every retry
        for kind, mj in _master_jobs(prompt):
            if kind == "tile":
                self.jobs.prepare_tile_job(mj)
        client_id = data.get("client_id", "unknown")
        extra_data = data.get("extra_data") or {}
        try:
            cfg = self.orchestration_config(prompt)
            if cfg is not None:
                host = cfg.get("master", {}).get("host") or "127.0.0.1"
                out = run_distributed(
                    prompt, f"http://{host}:{self.port or 8288}",
                    lambda g: self.enqueue_prompt(g.to_api_format(),
                                                  extra_data, client_id),
                    cfg_mod.enabled_workers(cfg), job_store=self.jobs,
                    client_id=client_id, extra_data=extra_data,
                    cluster=self.cluster, ledger=self.ledger)
                return 200, {"prompt_id": out["result"],
                             "number": self.queue_remaining(),
                             "workers": out["workers"],
                             "failed_workers": out["failed"]}
            pid = self.enqueue_prompt(prompt, extra_data, client_id)
        except Exception as e:  # noqa: BLE001 - reported to the client
            return 400, {"error": str(e)}
        return 200, {"prompt_id": pid, "number": self.queue_remaining()}

    def resume_recovered(self) -> int:
        """Queue again the prompts a crash interrupted (replayed from the
        log when this state was made); :func:`serve` calls it once the
        port is bound, since the recovery graphs name this master's URL.
        A second call does nothing."""
        return self.durable.resume() if self.durable is not None else 0

    # --- data plane ----------------------------------------------------------

    def decode_upload(self, part: FormPart):
        """An image or tile part -> [B, H, W, C] float32, by the part's
        content type (raw tensor or PNG), counted by format and timed."""
        t0 = time.perf_counter()
        if (part.content_type or "").split(";")[0].strip() \
                == C.TENSOR_WIRE_CONTENT_TYPE:
            out = decode_tensor(part.data)
            self.bump(wire_tensor_msgs=1, wire_tensor_bytes=len(part.data),
                      wire_decode_s=time.perf_counter() - t0)
            return out
        out = decode_png(part.data)
        self.bump(wire_png_msgs=1, wire_png_bytes=len(part.data),
                  wire_decode_s=time.perf_counter() - t0)
        return out


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


def _form_text(form: Dict[str, FormPart], key: str, default: str = "") -> str:
    part = form.get(key)
    return part.text if part is not None else default


def routes(state: ServerState
           ) -> Dict[Tuple[str, str], Callable[..., Response]]:
    """(method, path) -> handler(body bytes, content type, query, the
    client's address) -> (status, JSON body or :class:`Raw`)."""

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

    def post_prompt(body, ctype, query, remote=None):
        return state.post_prompt(json_body(body))

    def history(body, ctype, query, remote=None):
        return 200, dict(state._history)

    def prepare_job(body, ctype, query, remote=None):
        data = json_body(body)
        mj = data.get("multi_job_id")
        if not mj:
            return 400, {"error": "missing multi_job_id"}
        if data.get("kind") == "tile":
            state.jobs.prepare_tile_job(str(mj))
        else:
            state.jobs.prepare_job(str(mj))
        return ok()

    def queue_status(body, ctype, query, remote=None):
        mj = query.get("multi_job_id", "")
        return 200, {"exists": state.jobs.has_tile_job(mj)
                     or state.jobs.has_job(mj),
                     "queue_remaining": state.queue_remaining()}

    def wire_formats(body, ctype, query, remote=None):
        return 200, {"formats": [C.TENSOR_WIRE_CONTENT_TYPE, "image/png"],
                     "tensor_codecs": tensor_codecs()}

    def job_complete(body, ctype, query, remote=None):
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
        if not state.jobs.put_result(
                mj, item, idem_key=_form_text(form, "idem_key") or None):
            return 404, {"error": f"unknown job {mj}"}
        # a data-plane POST proves the sender alive: renew its lease
        state.cluster.touch(item["worker_id"])
        state.bump(images_received=1)
        return ok()

    def tile_complete(body, ctype, query, remote=None):
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
        return 200, {**out,
                     "cluster_counters": cluster_mod.COUNTERS.snapshot(),
                     "durability": durability()}

    def cluster_info(body, ctype, query, remote=None):
        return 200, {
            **state.cluster.snapshot(),
            "ledger": state.ledger.snapshot(),
            "policy": cluster_mod.fault_policy(),
            "hedge": {"armed": cluster_mod.hedge_armed(),
                      "min_progress_pct": cluster_mod.hedge_pct(),
                      "factor": cluster_mod.hedge_factor()}}

    def lease(renew: Callable[..., Dict[str, Any]]):
        """The register and heartbeat routes: the worker's id and
        address into the registry; the reply carries this server's
        clock, as the JAX package's does."""
        def handler(body, ctype, query, remote=None):
            data = json_body(body)
            wid = data.get("worker_id") or data.get("id")
            if not wid:
                return 400, {"error": "missing worker_id"}
            info = {k: data[k] for k in ("host", "port", "name")
                    if k in data}
            if remote:
                info.setdefault("host", remote)
            return ok(**renew(str(wid), info=info),
                      master_time=time.time())
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
        for _ in range(3):
            gc.collect()
        if torch.device(state.device).type == "cuda":
            torch.cuda.empty_cache()
        after = resource.device_memory_snapshot(state.device)
        freed = max(before["bytes_in_use"] - after["bytes_in_use"], 0)
        log(f"cleared the pipeline caches (freed {freed / 1e6:.1f} MB, "
            f"source={after['source']})")
        # cache_freed_bytes: the JAX package's reuse plane, not ported
        return ok(freed_bytes=freed, cache_freed_bytes=0,
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
        """Zero the metric counters and ``cluster_counters``; the prompt
        history stays."""
        if os.environ.get(C.METRICS_RESET_ENV, "1").lower() \
                in ("0", "false", "off"):
            return 403, {"error": "metrics reset disabled "
                                  f"({C.METRICS_RESET_ENV}=0)"}
        json_body(body)
        with state._metrics_lock:
            for k, v in state.metrics.items():
                state.metrics[k] = type(v)()
        cleared = {"metrics": True,
                   "cluster_counters": cluster_mod.COUNTERS.reset()}
        log(f"metrics reset (by {remote or 'unknown'})")
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
    }


def make_handler(state: ServerState) -> type:
    table = routes(state)

    class Handler(BaseHTTPRequestHandler):
        def _dispatch(self, method: str) -> None:
            url = urllib.parse.urlsplit(self.path)
            query = dict(urllib.parse.parse_qsl(url.query))
            fn = table.get((method, url.path))
            try:
                body = self.rfile.read(int(
                    self.headers.get("Content-Length") or 0))
                if fn is None:
                    status, payload = 404, {"error": f"no route {method} "
                                                     f"{url.path}"}
                else:
                    status, payload = fn(body,
                                         self.headers.get("Content-Type", ""),
                                         query, self.client_address[0])
            except ValueError as e:
                status, payload = 400, {"error": str(e)}
            except Exception as e:  # noqa: BLE001 - a 500, not a dead thread
                traceback.print_exc()
                status, payload = 500, {"error": str(e)}
            if isinstance(payload, Raw):
                data, content_type = payload.data, payload.content_type
            else:
                data = json.dumps(payload).encode()
                content_type = "application/json"
            self.send_response(status)
            self.send_header("Content-Type", content_type)
            self.send_header("Content-Length", str(len(data)))
            self.end_headers()
            self.wfile.write(data)

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
    """Serve until interrupted: a master polls its workers' health,
    launches its enabled local workers when the config's
    ``settings.auto_launch_workers`` is true and stops its managed
    workers when it exits (so it must run on the main thread, which
    signal handlers need); a worker renews its lease at
    ``DTPU_MASTER_URL`` as ``DTPU_WORKER_ID`` when both are set.  A
    durable master resumes its interrupted prompts once bound, on a
    thread (it probes the workers first), and closes its log on the way
    out (SIGINT, or SIGTERM through the exit hooks)."""
    server = make_server(state, host, port)
    role = "worker" if state.is_worker else "master"
    if state.is_worker:
        state.heartbeat = cluster_mod.maybe_start_heartbeat(port=state.port)
    else:
        install_exit_hooks(state.manager)
        state.health.start()
        auto_launch_workers(state.manager)
        if state.durable is not None:
            threading.Thread(target=state.resume_recovered,
                             name="dtpu-resume", daemon=True).start()
    log(f"{role} listening on {host}:{state.port} (device {state.device})")
    sys.stdout.flush()
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        state.health.stop()
        if state.heartbeat is not None:
            state.heartbeat.stop()
        if state.durable is not None:
            state.durable.close()
        server.server_close()
