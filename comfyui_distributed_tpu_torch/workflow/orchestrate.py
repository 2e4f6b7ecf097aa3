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

With the control plane (``cluster`` and ``ledger``, from
``runtime/cluster.py``) the preflight skips workers the registry holds
dead, and each distributed job gets a redispatcher on the ledger, so a
collector can re-issue a dead or straggling participant's units to a
healthy worker.  A master that resumes a prompt from its write-ahead log
registers the same redispatchers from the prompt's prepared graph
(:func:`register_recovery_redispatchers`).  A request's ``slo_s`` (in
``extra_data``) stamps its jobs with a deadline on the ledger, which
hedges on the budget left.

Under the caller's span (the master's ``job`` root) the preflight is a
``preflight`` span, each worker's dispatch a ``dispatch`` span whose
``traceparent`` the worker's job span takes as its parent, and each
redispatch a ``redispatch`` span.  The dispatch and staging pools are
threads: each call carries the captured span onto its thread.
"""

from __future__ import annotations

import base64
import concurrent.futures
import json
import os
import re
import threading
import time
import urllib.error
import urllib.request
from typing import Any, Callable, Dict, List, Optional, Tuple

from comfyui_distributed_tpu_torch.runtime import cluster as cluster_mod
from comfyui_distributed_tpu_torch.utils import config as cfg_mod
from comfyui_distributed_tpu_torch.utils import constants as C
from comfyui_distributed_tpu_torch.utils import trace as trace_mod
from comfyui_distributed_tpu_torch.utils.log import debug_log, log
from comfyui_distributed_tpu_torch.utils.net import (
    FormData,
    in_context,
    post_json,
)
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


def _register_redispatchers(graph: Graph, job_id_map: Dict[str, str],
                            enabled_ids: List[str],
                            alive: List[Dict[str, Any]], master_url: str,
                            client_id: str,
                            extra_data: Optional[Dict[str, Any]],
                            cluster, ledger) -> None:
    """One ``(units, lost_owner) -> bool`` callback a distributed job on
    the ledger.  A tile job re-issues the exact lost unit list through
    the upscaler's ``tile_indices`` input; an image job re-issues each
    lost seed slice's pruned graph under the slice's own positional
    identity, so its seeds and upload labels are the lost slice's.  The
    target is a registry-HEALTHY worker with the shortest known queue.
    Units are re-owned on the ledger only after the dispatch succeeded,
    and only true reassignments: a hedged unit stays with its owner."""
    by_id = {str(w["id"]): w for w in alive}

    def pick_target(lost_owner: str) -> Optional[Dict[str, Any]]:
        snap = cluster.snapshot()["workers"] if cluster is not None else {}
        candidates = []
        for wid, w in by_id.items():
            if wid == str(lost_owner):
                continue
            depth = 0
            if cluster is not None:
                info = snap.get(wid, {})
                if info.get("state") != cluster_mod.HEALTHY:
                    continue
                depth = info.get("queue_remaining") or 0
            candidates.append((depth, wid, w))
        return min(candidates, key=lambda c: (c[0], c[1]))[2] \
            if candidates else None

    for nid, mj in job_id_map.items():
        kind = "tile" if graph.nodes[nid].class_type in dsp.UPSCALER_TYPES \
            else "image"
        if kind == "image" and dsp.has_upstream_type(graph, nid,
                                                     dsp.UPSCALER_TYPES):
            # a pass-through collector never collects: its job never
            # reaches the ledger
            continue

        def redispatch(units, lost_owner, nid=nid, mj=mj, kind=kind):
            pending = set(ledger.pending(mj))
            units = [u for u in units if u in pending]
            if not units:
                return False
            target = pick_target(lost_owner)
            if target is None:
                return False
            tid = str(target["id"])
            attempt = 1 + max(ledger.attempts(mj, u) for u in units)

            def send(wgraph: Graph, batch: List[Any]) -> None:
                log(f"cluster: redispatching {kind} units {batch} of {mj} "
                    f"({lost_owner} -> {tid})")
                with trace_mod.span("redispatch", job=mj, worker=tid,
                                    lost=str(lost_owner), units=len(batch)):
                    dsp.dispatch_to_worker(target, wgraph,
                                           client_id=client_id,
                                           extra_data=extra_data)
                moved = [u for u in batch if not ledger.is_hedged(mj, u)]
                if moved:
                    ledger.reassign(mj, moved, tid)

            if kind == "tile":
                wgraph = dsp.prepare_for_participant(
                    graph, "worker", job_id_map, enabled_ids,
                    master_url=master_url,
                    worker_index=enabled_ids.index(tid))
                node = wgraph.nodes.get(str(nid))
                if node is None:
                    return False
                node.hidden["tile_indices"] = json.dumps(
                    [int(u) for u in units])
                node.hidden["dispatch_attempt"] = attempt
                send(wgraph, list(units))
                return True
            # an image unit's key is its slice's config id: the identity
            # follows the unit, not its current owner (after a first
            # reassignment they differ)
            sent = 0
            for u in units:
                if str(u) not in enabled_ids:
                    continue
                wgraph = dsp.prepare_for_participant(
                    graph, "worker", job_id_map, enabled_ids,
                    master_url=master_url,
                    worker_index=enabled_ids.index(str(u)))
                for n2 in wgraph.nodes.values():
                    if n2.class_type in dsp.COLLECTOR_TYPES:
                        n2.hidden["dispatch_attempt"] = attempt
                send(wgraph, [u])
                sent += 1
            return sent > 0

        ledger.set_redispatcher(mj, redispatch)


def register_recovery_redispatchers(state, prompt: Dict[str, Any]) -> int:
    """The redispatchers of a prompt that a master resumes from its
    write-ahead log.  The log holds the master's prepared graph, whose
    distributed nodes carry their ``multi_job_id`` and
    ``enabled_worker_ids`` as hidden inputs, so the unfinished units can
    go out again to live workers with exact unit lists, without running
    the orchestration again.  Returns how many jobs got one."""
    graph = parse_workflow(prompt)
    job_id_map: Dict[str, str] = {}
    enabled_ids: List[str] = []
    for nid, node in graph.nodes.items():
        if node.class_type not in dsp.DISTRIBUTED_TYPES:
            continue
        h = node.hidden
        mj = h.get("multi_job_id")
        if not mj or h.get("is_worker"):
            continue
        job_id_map[nid] = str(mj)
        if h.get("enabled_worker_ids"):
            try:
                enabled_ids = [str(x) for x in
                               json.loads(h["enabled_worker_ids"])]
            except (ValueError, TypeError):
                pass
    if not job_id_map or not enabled_ids:
        return 0
    cfg = cfg_mod.load_config(state.config_path)
    alive = [w for w in cfg_mod.enabled_workers(cfg)
             if str(w.get("id")) in enabled_ids]
    if not alive:
        return 0
    host = cfg.get("master", {}).get("host") or "127.0.0.1"
    _register_redispatchers(graph, job_id_map, enabled_ids, alive,
                            f"http://{host}:{state.port or 8288}",
                            "dtpu-recovery", None, state.cluster,
                            state.ledger)
    debug_log(f"recovery: redispatchers for {sorted(job_id_map.values())}")
    return len(job_id_map)


def run_distributed(graph_or_doc: Any, master_url: str,
                    master_dispatch: Callable[[Graph], Any],
                    workers: List[Dict[str, Any]],
                    job_store=None,
                    client_id: str = "dtpu-orchestrator",
                    extra_data: Optional[Dict[str, Any]] = None,
                    cluster=None, ledger=None) -> Dict[str, Any]:
    """Fan a workflow out to the master and the enabled ``workers``.

    ``master_dispatch(graph)`` runs (or queues) the master's share and
    its result is returned under ``result``; ``job_store`` is the
    master's own queue store when the caller is the master process, else
    the queues are prepared over ``master_url``; ``cluster`` and
    ``ledger`` opt into the control plane.  Returns ``{"result",
    "workers": ids dispatched to, "failed": ids whose dispatch failed,
    "job_ids": node id -> multi_job_id}``.
    """
    graph = graph_or_doc if isinstance(graph_or_doc, Graph) \
        else parse_workflow(graph_or_doc)
    with trace_mod.span("preflight", n_workers=len(workers or [])):
        alive = dsp.preflight_check(workers, registry=cluster) \
            if workers else []
    if not alive or not graph.find_by_type(*dsp.DISTRIBUTED_TYPES):
        return {"result": master_dispatch(graph), "workers": [],
                "failed": [], "job_ids": {}}

    refs = find_image_references(graph)
    remote = [w for w in alive if _is_remote(w)]
    if refs and remote:
        with concurrent.futures.ThreadPoolExecutor(len(remote)) as ex:
            for fut in [ex.submit(in_context(stage_images_on_worker),
                                  master_url, w, refs) for w in remote]:
                fut.result()

    job_id_map = dsp.make_job_id_map(graph)
    # a request's SLO budget stamps each of its jobs with a deadline: the
    # ledger's hedging keys on the budget left
    slo_s = (extra_data or {}).get("slo_s")
    if ledger is not None and slo_s:
        try:
            deadline = time.monotonic() + float(slo_s)
        except (TypeError, ValueError):
            deadline = None
        if deadline is not None:
            for mj in job_id_map.values():
                ledger.set_deadline(mj, deadline)
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
    # before the master starts collecting, so a collector that sees a
    # lease expire can re-issue the lost units
    if ledger is not None:
        _register_redispatchers(graph, job_id_map, enabled_ids, alive,
                                master_url, client_id, extra_data,
                                cluster, ledger)

    @in_context
    def dispatch(worker: Dict[str, Any], index: int) -> Any:
        wgraph = dsp.prepare_for_participant(
            graph, "worker", job_id_map, enabled_ids, master_url=master_url,
            worker_index=index)
        # the worker's job span takes this span as its parent, through
        # the traceparent dispatch_to_worker sends
        with trace_mod.span("dispatch", worker=str(worker.get("id"))):
            return dsp.dispatch_to_worker(worker, wgraph,
                                          client_id=client_id,
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
            except Exception as e:  # noqa: BLE001 - a failed worker
                log(f"orchestrator: dispatch to {w.get('id')} failed: {e}")
                failed.append(str(w["id"]))
    return {"result": result, "workers": ok_workers, "failed": failed,
            "job_ids": job_id_map}
