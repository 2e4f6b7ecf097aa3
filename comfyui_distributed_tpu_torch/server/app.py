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
  ``images_received``, ``tiles_received`` and the bytes received by wire
  format.

One execution thread runs the queue in FIFO order through the port's
``WorkflowExecutor`` on the server's device; handler threads answer
while it runs.  Each finished prompt logs one line,
``dtpu-torch prompt {...}``, with its kernel launches by variant and by
shape and ``torch.cuda.max_memory_allocated()``.  Admission control,
the cluster registry, tracing, the write-ahead log, previews and
``/interrupt`` wait.
"""

from __future__ import annotations

import base64
import collections
import json
import os
import sys
import threading
import time
import traceback
import urllib.parse
import uuid
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from comfyui_distributed_tpu_torch.ops.base import OpContext
from comfyui_distributed_tpu_torch.ops.kernels import flash_attention as fa
from comfyui_distributed_tpu_torch.runtime.jobs import JobStore
from comfyui_distributed_tpu_torch.utils import config as cfg_mod
from comfyui_distributed_tpu_torch.utils import constants as C
from comfyui_distributed_tpu_torch.utils.image import (
    decode_png,
    decode_tensor,
    tensor_codecs,
)
from comfyui_distributed_tpu_torch.utils.net import FormPart, parse_multipart
from comfyui_distributed_tpu_torch.workflow import WorkflowExecutor
from comfyui_distributed_tpu_torch.workflow.orchestrate import (
    is_dispatched_share,
    run_distributed,
)

Response = Tuple[int, Any]


def log(msg: str) -> None:
    print(f"dtpu-torch {msg}", flush=True)


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
        self.metrics: Dict[str, Any] = {
            "prompts_executed": 0, "prompts_failed": 0,
            "images_received": 0, "tiles_received": 0,
            "wire_tensor_msgs": 0, "wire_tensor_bytes": 0,
            "wire_png_msgs": 0, "wire_png_bytes": 0,
        }
        self._history: Dict[str, Dict[str, Any]] = {}
        self._queue: collections.deque = collections.deque()
        self._running = False
        self._cond = threading.Condition()
        self._metrics_lock = threading.Lock()
        if start_exec_thread:
            threading.Thread(target=self._exec_loop, name="dtpu-exec",
                             daemon=True).start()

    # --- queue ---------------------------------------------------------------

    def enqueue_prompt(self, prompt: Dict[str, Any],
                       extra_data: Optional[Dict[str, Any]] = None) -> str:
        pid = uuid.uuid4().hex
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
        on_cuda = torch.device(self.device).type == "cuda"
        fa.reset_counts()
        if on_cuda:
            torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        ctx = OpContext(device=self.device, models_dir=self.models_dir,
                        input_dir=self.input_dir, output_dir=self.output_dir,
                        is_worker=self.is_worker, job_store=self.jobs,
                        extra_pnginfo=item["extra_data"].get(
                            "extra_pnginfo"))
        res, err = None, None
        try:
            res = WorkflowExecutor(ctx).execute(item["prompt"])
        except Exception as e:  # noqa: BLE001 - a bad prompt fails alone
            err = e
            traceback.print_exc()
        finally:
            # a tile queue prepared at /prompt time for a run that never
            # reached its upscaler would take tiles for ever
            for mj in _master_tile_jobs(item["prompt"]):
                self.jobs.remove_tile_queue(mj)
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
        for mj in _master_tile_jobs(prompt):
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
                                                  extra_data),
                    cfg_mod.enabled_workers(cfg), job_store=self.jobs,
                    client_id=client_id, extra_data=extra_data)
                return 200, {"prompt_id": out["result"],
                             "number": self.queue_remaining(),
                             "workers": out["workers"],
                             "failed_workers": out["failed"]}
            pid = self.enqueue_prompt(prompt, extra_data)
        except Exception as e:  # noqa: BLE001 - reported to the client
            return 400, {"error": str(e)}
        return 200, {"prompt_id": pid, "number": self.queue_remaining()}

    # --- data plane ----------------------------------------------------------

    def decode_upload(self, part: FormPart):
        """An image or tile part -> [B, H, W, C] float32, by the part's
        content type (raw tensor or PNG), counted by format."""
        if (part.content_type or "").split(";")[0].strip() \
                == C.TENSOR_WIRE_CONTENT_TYPE:
            self.bump(wire_tensor_msgs=1, wire_tensor_bytes=len(part.data))
            return decode_tensor(part.data)
        self.bump(wire_png_msgs=1, wire_png_bytes=len(part.data))
        return decode_png(part.data)


def _master_tile_jobs(prompt: Dict[str, Any]):
    """The ``multi_job_id`` of each master-side tiled upscaler of a
    prepared graph."""
    for node in prompt.values():
        if isinstance(node, dict) \
                and node.get("class_type") in C.UPSCALER_NODE_TYPES:
            h = {**node.get("inputs", {}), **node.get("hidden", {})}
            if h.get("multi_job_id") and not h.get("is_worker"):
                yield str(h["multi_job_id"])


def _form_text(form: Dict[str, FormPart], key: str, default: str = "") -> str:
    part = form.get(key)
    return part.text if part is not None else default


def routes(state: ServerState
           ) -> Dict[Tuple[str, str], Callable[..., Response]]:
    """(method, path) -> handler(body bytes, content type, query) ->
    (status, JSON body)."""

    def ok(**kw) -> Response:
        return 200, {"status": "ok", **kw}

    def json_body(body: bytes) -> Dict[str, Any]:
        data = json.loads(body or b"{}")
        if not isinstance(data, dict):
            raise ValueError("a JSON object is expected")
        return data

    def get_prompt(body, ctype, query):
        return 200, {"exec_info": {"queue_remaining":
                                   state.queue_remaining()}}

    def post_prompt(body, ctype, query):
        return state.post_prompt(json_body(body))

    def history(body, ctype, query):
        return 200, dict(state._history)

    def prepare_job(body, ctype, query):
        data = json_body(body)
        mj = data.get("multi_job_id")
        if not mj:
            return 400, {"error": "missing multi_job_id"}
        if data.get("kind") == "tile":
            state.jobs.prepare_tile_job(str(mj))
        else:
            state.jobs.prepare_job(str(mj))
        return ok()

    def queue_status(body, ctype, query):
        mj = query.get("multi_job_id", "")
        return 200, {"exists": state.jobs.has_tile_job(mj)
                     or state.jobs.has_job(mj),
                     "queue_remaining": state.queue_remaining()}

    def wire_formats(body, ctype, query):
        return 200, {"formats": [C.TENSOR_WIRE_CONTENT_TYPE, "image/png"],
                     "tensor_codecs": tensor_codecs()}

    def job_complete(body, ctype, query):
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
        state.bump(images_received=1)
        return ok()

    def tile_complete(body, ctype, query):
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
        state.bump(tiles_received=1)
        return ok()

    def load_image(body, ctype, query):
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

    def upload_image(body, ctype, query):
        img = parse_multipart(body, ctype).get("image")
        if img is None:
            return 400, {"error": "missing image"}
        name = os.path.basename(img.filename or "upload.png")
        os.makedirs(state.input_dir, exist_ok=True)
        with open(os.path.join(state.input_dir, name), "wb") as f:
            f.write(img.data)
        return 200, {"name": name, "subfolder": "", "type": "input"}

    def get_config(body, ctype, query):
        return 200, cfg_mod.load_config(state.config_path)

    def update_worker(body, ctype, query):
        data = json_body(body)
        if "id" not in data:
            return 400, {"error": "missing worker id"}
        result: Dict[str, Any] = {}
        cfg_mod.mutate_config(
            lambda cfg: result.update(cfg_mod.upsert_worker(cfg, data)),
            state.config_path)
        return ok(worker=result)

    def delete_worker(body, ctype, query):
        wid = str(json_body(body).get("id"))
        found = []
        cfg_mod.mutate_config(
            lambda cfg: found.append(cfg_mod.delete_worker(cfg, wid)),
            state.config_path)
        if not found[0]:
            return 404, {"error": "worker not found"}
        return ok()

    def metrics(body, ctype, query):
        with state._metrics_lock:
            return 200, dict(state.metrics)

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
                                         query)
            except ValueError as e:
                status, payload = 400, {"error": str(e)}
            except Exception as e:  # noqa: BLE001 - a 500, not a dead thread
                traceback.print_exc()
                status, payload = 500, {"error": str(e)}
            data = json.dumps(payload).encode()
            self.send_response(status)
            self.send_header("Content-Type", "application/json")
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
    server = make_server(state, host, port)
    role = "worker" if state.is_worker else "master"
    log(f"{role} listening on {host}:{state.port} (device {state.device})")
    sys.stdout.flush()
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        server.server_close()
