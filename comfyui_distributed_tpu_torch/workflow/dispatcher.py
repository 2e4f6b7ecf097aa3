"""Per-participant graph rewriting and the dispatch requests of the HTTP
fan-out: the counterpart of ``comfyui_distributed_tpu/workflow/
dispatcher.py``, over ``urllib``.

Rewrite rules, the same as the JAX package's:
- a worker gets the graph pruned to the connected component of the
  distributed nodes;
- ``DistributedSeed``: ``is_worker``, and on a worker
  ``worker_id="worker_<index>"``;
- ``DistributedCollector``: ``multi_job_id`` and ``is_worker``; the
  master adds ``enabled_worker_ids``, a worker ``master_url``,
  ``worker_id`` and ``worker_batch_size``; downstream of a distributed
  upscaler it is set to ``pass_through`` instead;
- ``UltimateSDUpscaleDistributed``: ``multi_job_id``, ``is_worker`` and
  ``enabled_worker_ids`` on both sides (each side computes the tile
  partition); a worker adds ``master_url`` and its config id as
  ``worker_id``, which it finds in ``enabled_worker_ids``.

The dispatch and prepare requests carry the current span's W3C
``traceparent``.
"""

from __future__ import annotations

import concurrent.futures
import copy
import http.client
import json
import time
from typing import Any, Dict, List, Optional, Tuple

from comfyui_distributed_tpu_torch.runtime import cluster as cl
from comfyui_distributed_tpu_torch.utils import constants as C
from comfyui_distributed_tpu_torch.utils import trace as trace_mod
from comfyui_distributed_tpu_torch.utils.log import log
from comfyui_distributed_tpu_torch.utils.net import get_json, post_json
from comfyui_distributed_tpu_torch.workflow.graph import (
    Graph,
    connected_component,
)

SEED_TYPES = C.SEED_NODE_TYPES
COLLECTOR_TYPES = C.COLLECTOR_NODE_TYPES
UPSCALER_TYPES = C.UPSCALER_NODE_TYPES
DISTRIBUTED_TYPES = C.DISTRIBUTED_NODE_TYPES


def _copy(graph: Graph, keep=None) -> Graph:
    return Graph(nodes={nid: copy.deepcopy(n) for nid, n in graph.nodes.items()
                        if keep is None or nid in keep})


def prune_for_worker(graph: Graph) -> Graph:
    """A copy of the connected component of the distributed nodes, with
    links to pruned nodes dropped (the whole graph when it has none)."""
    roots = graph.find_by_type(*DISTRIBUTED_TYPES)
    if not roots:
        return _copy(graph)
    g = _copy(graph, connected_component(graph, roots))
    for n in g.nodes.values():
        for name, (src, _slot) in list(n.link_inputs().items()):
            if str(src) not in g.nodes:
                del n.inputs[name]
    return g


def has_upstream_type(graph: Graph, node_id: str, types: Tuple[str, ...],
                      _seen: Optional[set] = None) -> bool:
    """True if any transitive input of ``node_id`` is of one of
    ``types``."""
    _seen = _seen if _seen is not None else set()
    if node_id in _seen:
        return False
    _seen.add(node_id)
    node = graph.nodes.get(node_id)
    if node is None:
        return False
    for src, _ in node.link_inputs().values():
        up = graph.nodes.get(str(src))
        if up is None:
            continue
        if up.class_type in types \
                or has_upstream_type(graph, str(src), types, _seen):
            return True
    return False


def make_job_id_map(graph: Graph, prefix: Optional[str] = None
                    ) -> Dict[str, str]:
    """One ``multi_job_id`` per distributed node:
    ``exec_<milliseconds>_<node id>``."""
    prefix = prefix or f"exec_{int(time.time() * 1000)}"
    return {nid: f"{prefix}_{nid}"
            for nid in graph.find_by_type(*DISTRIBUTED_TYPES)}


def prepare_for_participant(graph: Graph, participant: str,
                            job_id_map: Dict[str, str],
                            enabled_worker_ids: List[str],
                            master_url: str = "",
                            worker_index: int = 0,
                            batch_size: int = 1) -> Graph:
    """A copy of ``graph`` with the hidden inputs of ``participant``
    ("master" or "worker"; a worker's graph is pruned)."""
    is_worker = participant == "worker"
    g = prune_for_worker(graph) if is_worker else _copy(graph)
    worker_id = f"worker_{worker_index}"
    ids_json = json.dumps([str(w) for w in enabled_worker_ids])
    for nid, node in g.nodes.items():
        h = node.hidden
        if node.class_type in SEED_TYPES:
            h["is_worker"] = is_worker
            if is_worker:
                h["worker_id"] = worker_id
        elif node.class_type in COLLECTOR_TYPES:
            if has_upstream_type(g, nid, UPSCALER_TYPES):
                h["pass_through"] = True
                continue
            h["multi_job_id"] = job_id_map.get(nid, "")
            h["is_worker"] = is_worker
            if is_worker:
                h["master_url"] = master_url
                h["worker_id"] = worker_id
                h["worker_batch_size"] = batch_size
            else:
                h["enabled_worker_ids"] = ids_json
        elif node.class_type in UPSCALER_TYPES:
            h["multi_job_id"] = job_id_map.get(nid, "")
            h["is_worker"] = is_worker
            h["enabled_worker_ids"] = ids_json
            if is_worker:
                h["master_url"] = master_url
                h["worker_id"] = (str(enabled_worker_ids[worker_index])
                                  if worker_index < len(enabled_worker_ids)
                                  else worker_id)
    return g


# --- network (master side) ---------------------------------------------------


def worker_url(worker: Dict[str, Any]) -> str:
    host = worker.get("host") or "127.0.0.1"
    return f"http://{host}:{worker['port']}"


def preflight_check(workers: List[Dict[str, Any]],
                    timeout: float = C.PREFLIGHT_TIMEOUT,
                    registry=None) -> List[Dict[str, Any]]:
    """``GET /prompt`` on every worker at once; the ones that do not
    answer 200 within ``timeout`` are dropped, in order.

    With a ``registry`` (``runtime/cluster.py``) a worker it holds DEAD
    is dropped without a probe (one that died between jobs, or whose
    socket outlives its process, gets no work), so is a RETIRING one
    (the autoscaler drains it), a SUSPECT one is dispatched with a
    warning, and every probe's result feeds the registry."""
    def probe(w: Dict[str, Any]) -> bool:
        wid = str(w.get("id"))
        if registry is not None:
            st = registry.state(wid)
            if st == cl.DEAD:
                log(f"preflight: skipping worker {wid}: the registry "
                    f"holds it dead (lease expired)")
                return False
            if st == cl.RETIRING:
                # alive and finishing its units in flight, but drained
                log(f"preflight: skipping worker {wid}: retiring "
                    f"(autoscaler drain)")
                return False
            if st == cl.SUSPECT:
                log(f"preflight: worker {wid} is suspect (failed "
                    f"probes); dispatching anyway")
        try:
            get_json(worker_url(w) + "/prompt", timeout=timeout)
            ok = True
        except (OSError, ValueError, http.client.HTTPException):
            ok = False
        if registry is not None:
            registry.observe_probe(
                wid, ok, info={"host": w.get("host") or "127.0.0.1",
                               "port": w.get("port"),
                               "name": w.get("name")})
        return ok

    if not workers:
        return []
    with concurrent.futures.ThreadPoolExecutor(len(workers)) as ex:
        alive = list(ex.map(probe, workers))
    return [w for w, ok in zip(workers, alive) if ok]


def dispatch_to_worker(worker: Dict[str, Any], graph: Graph,
                       client_id: str = "dtpu-master",
                       extra_data: Optional[Dict[str, Any]] = None
                       ) -> Dict[str, Any]:
    """POST the prepared graph to the worker's ``/prompt``; raises
    ``RuntimeError`` on any status but 200.  The current span's W3C
    ``traceparent`` rides the request, so the worker's execution joins
    this job's trace."""
    payload: Dict[str, Any] = {"prompt": graph.to_api_format(),
                               "client_id": client_id}
    if extra_data:
        payload["extra_data"] = extra_data
    try:
        return post_json(worker_url(worker) + "/prompt", payload, timeout=30,
                         headers=trace_mod.traceparent_headers())
    except RuntimeError as e:
        raise RuntimeError(f"worker {worker.get('id')} rejected prompt: "
                           f"{e}") from None


def prepare_job_on(url: str, multi_job_id: str, kind: str = "image") -> None:
    """Create the image or tile queue of a job on the master at ``url``
    before anything is dispatched."""
    post_json(f"{url}/distributed/prepare_job",
              {"multi_job_id": multi_job_id, "kind": kind}, timeout=5,
              headers=trace_mod.traceparent_headers())
