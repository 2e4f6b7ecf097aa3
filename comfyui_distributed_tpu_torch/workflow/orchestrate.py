"""The fan-out of one workflow over the master and its HTTP workers: the
counterpart of ``run_distributed`` in
``comfyui_distributed_tpu/workflow/orchestrate.py``, on threads.

In order:
1. preflight every enabled worker and drop those that do not answer;
   with none alive the master runs the graph alone;
2. map each distributed node to a ``multi_job_id``;
3. stage the input images the graph names onto every remote worker at
   once, each image read from the master once for all of them (a 30 s
   cache); a staging error fails the request here, before anything is
   queued;
4. prepare the result queues on the master (image queues for
   collectors, tile queues for upscalers);
5. build each participant's graph and dispatch the workers' in parallel
   while the master runs its own share.

The JAX package's cluster registry, work ledger and SLO deadlines wait.
"""

from __future__ import annotations

import base64
import concurrent.futures
import os
import re
import threading
import time
import urllib.error
import urllib.request
from typing import Any, Callable, Dict, List, Optional, Tuple

from comfyui_distributed_tpu_torch.utils import constants as C
from comfyui_distributed_tpu_torch.utils.net import FormData, post_json
from comfyui_distributed_tpu_torch.workflow import dispatcher as dsp
from comfyui_distributed_tpu_torch.workflow.graph import Graph, parse_workflow

# filename-valued image inputs, with ComfyUI's "name.png [input]" suffix
# and subfolder paths
_IMAGE_REF = re.compile(
    r"^[\w\-. /\\]+\.(png|jpg|jpeg|webp|bmp|gif)(\s*\[\w+\])?$",
    re.IGNORECASE)


def is_dispatched_share(prompt: Dict[str, Any]) -> bool:
    """True for a graph an orchestrator already prepared: a distributed
    node with a hidden (or inline) ``multi_job_id``."""
    for node in prompt.values():
        if not isinstance(node, dict) or node.get("class_type") \
                not in C.DISTRIBUTED_NODE_TYPES:
            continue
        h = {**node.get("inputs", {}), **node.get("hidden", {})}
        if h.get("multi_job_id"):
            return True
    return False


def find_image_references(graph: Graph) -> List[str]:
    """Filename-valued ``image`` inputs: the files a remote worker needs
    before it can run its share."""
    return [val.strip() for node in graph.nodes.values()
            for name, val in node.inputs.items()
            if name == "image" and isinstance(val, str)
            and _IMAGE_REF.match(val.strip())]


def _is_remote(worker: Dict[str, Any]) -> bool:
    return worker.get("host") not in (None, "", "localhost", "127.0.0.1")


# one master read per image for all of a dispatch's workers: entries
# hold a future, so parallel stagers share one read in flight
STAGE_CACHE_TTL_S = 30.0
_stage_cache: Dict[Tuple[str, str],
                   Tuple[float, concurrent.futures.Future]] = {}
_stage_lock = threading.Lock()


def _load_master_image(master_url: str, name: str) -> Optional[bytes]:
    """One input image's bytes from the master
    (``/distributed/load_image``), through the 30 s cache; None when the
    master does not have it (not cached: it may be uploaded later)."""
    key, now = (master_url, name), time.monotonic()
    with _stage_lock:
        for k in [k for k, (t, f) in _stage_cache.items()
                  if now - t >= STAGE_CACHE_TTL_S and f.done()]:
            del _stage_cache[k]
        ent = _stage_cache.get(key)
        if ent is not None and now - ent[0] < STAGE_CACHE_TTL_S:
            return ent[1].result()
        fut: concurrent.futures.Future = concurrent.futures.Future()
        _stage_cache[key] = (now, fut)
    try:
        data = post_json(f"{master_url}/distributed/load_image",
                         {"image_name": name}, timeout=30)
    except RuntimeError:    # an HTTP error status: the master lacks it
        blob = None
    except BaseException as e:
        with _stage_lock:
            _stage_cache.pop(key, None)
        fut.set_exception(e)
        raise
    else:
        blob = base64.b64decode(data["image_data"])
    if blob is None:
        with _stage_lock:
            _stage_cache.pop(key, None)
    fut.set_result(blob)
    return blob


def stage_images_on_worker(master_url: str, worker: Dict[str, Any],
                           refs: List[str]) -> None:
    """Copy each referenced input image from the master (through the
    cache) to the worker's ``/upload/image``; an image the master does
    not have is skipped, an upload the worker refuses raises."""
    for ref in refs:
        name = re.sub(r"\s*\[\w+\]$", "", ref)
        blob = _load_master_image(master_url, name)
        if blob is None:
            continue
        form = FormData()
        form.add_field("image", blob, filename=os.path.basename(name),
                       content_type="image/png")
        req = urllib.request.Request(
            f"{dsp.worker_url(worker)}/upload/image", data=form.encode(),
            headers={"Content-Type": form.content_type})
        try:
            with urllib.request.urlopen(req, timeout=30) as r:
                r.read()
        except urllib.error.HTTPError as e:
            raise RuntimeError(f"image staging to {worker.get('id')} "
                               f"failed: {e.code}") from None


def run_distributed(graph_or_doc: Any, master_url: str,
                    master_dispatch: Callable[[Graph], Any],
                    workers: List[Dict[str, Any]],
                    job_store=None,
                    client_id: str = "dtpu-orchestrator",
                    extra_data: Optional[Dict[str, Any]] = None
                    ) -> Dict[str, Any]:
    """Fan a workflow out to the master and the enabled ``workers``.

    ``master_dispatch(graph)`` runs (or queues) the master's share and
    its result is returned under ``result``; ``job_store`` is the
    master's own queue store when the caller is the master process, else
    the queues are prepared over ``master_url``.  Returns ``{"result",
    "workers": ids dispatched to, "failed": ids whose dispatch failed,
    "job_ids": node id -> multi_job_id}``.
    """
    graph = graph_or_doc if isinstance(graph_or_doc, Graph) \
        else parse_workflow(graph_or_doc)
    alive = dsp.preflight_check(workers)
    if not alive or not graph.find_by_type(*dsp.DISTRIBUTED_TYPES):
        return {"result": master_dispatch(graph), "workers": [],
                "failed": [], "job_ids": {}}

    refs = find_image_references(graph)
    remote = [w for w in alive if _is_remote(w)]
    if refs and remote:
        with concurrent.futures.ThreadPoolExecutor(len(remote)) as ex:
            for fut in [ex.submit(stage_images_on_worker, master_url, w,
                                  refs) for w in remote]:
                fut.result()

    job_id_map = dsp.make_job_id_map(graph)
    for nid, mj in job_id_map.items():
        kind = "tile" if graph.nodes[nid].class_type in dsp.UPSCALER_TYPES \
            else "image"
        if job_store is None:
            dsp.prepare_job_on(master_url, mj, kind=kind)
        elif kind == "tile":
            job_store.prepare_tile_job(mj)
        else:
            job_store.prepare_job(mj)

    enabled_ids = [str(w["id"]) for w in alive]
    master_graph = dsp.prepare_for_participant(
        graph, "master", job_id_map, enabled_ids, master_url=master_url)

    def dispatch(worker: Dict[str, Any], index: int) -> Any:
        wgraph = dsp.prepare_for_participant(
            graph, "worker", job_id_map, enabled_ids, master_url=master_url,
            worker_index=index)
        return dsp.dispatch_to_worker(worker, wgraph, client_id=client_id,
                                      extra_data=extra_data)

    with concurrent.futures.ThreadPoolExecutor(len(alive)) as ex:
        futures = [ex.submit(dispatch, w, i) for i, w in enumerate(alive)]
        # the master's share runs while the dispatches are in flight; its
        # collector or upscaler drains the queues prepared above
        result = master_dispatch(master_graph)
        ok_workers, failed = [], []
        for w, fut in zip(alive, futures):
            try:
                fut.result()
                ok_workers.append(str(w["id"]))
            except Exception:  # noqa: BLE001 - reported as a failed worker
                failed.append(str(w["id"]))
    return {"result": result, "workers": ok_workers, "failed": failed,
            "job_ids": job_id_map}
