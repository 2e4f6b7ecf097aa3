"""Command-line interface of the torch package.

  python -m comfyui_distributed_tpu_torch.cli serve  [--port 8288]
  python -m comfyui_distributed_tpu_torch.cli worker --port 8289
  python -m comfyui_distributed_tpu_torch.cli run workflow.json \\
      [--out DIR] [--models-dir DIR] [--input-dir DIR] [--device cuda|cpu]
  python -m comfyui_distributed_tpu_torch.cli run workflow.json --via URL
  python -m comfyui_distributed_tpu_torch.cli cluster --url URL [--json]
  python -m comfyui_distributed_tpu_torch.cli workers [--config C]
  python -m comfyui_distributed_tpu_torch.cli launch|stop|log ID \\
      [--config C | --url URL]
  python -m comfyui_distributed_tpu_torch.cli status [--url URL]
  python -m comfyui_distributed_tpu_torch.cli router --masters URL,URL \
      [--host H] [--port 8290]
  python -m comfyui_distributed_tpu_torch.cli slo [--url URL] [--json]
  python -m comfyui_distributed_tpu_torch.cli top [--url URL] [--json]
  python -m comfyui_distributed_tpu_torch.cli fleet [--url URL] [--json]
  python -m comfyui_distributed_tpu_torch.cli reuse [--url URL] [--json]
  python -m comfyui_distributed_tpu_torch.cli flightdeck [--url URL] \\
      [--last N] [--json]
  python -m comfyui_distributed_tpu_torch.cli devices
  python -m comfyui_distributed_tpu_torch.cli wal [--dir D] [--job S] [--json]
  python -m comfyui_distributed_tpu_torch.cli trace [PROMPT_ID] \\
      [--url URL | --export-dir DIR] [--perfetto [--out FILE]]
  python -m comfyui_distributed_tpu_torch.cli why PROMPT_ID \\
      [--url URL | --export-dir DIR] [--json]
  python -m comfyui_distributed_tpu_torch.cli analyze [--url URL | \\
      --export-dir DIR | --diff DIR_A DIR_B [--seed N]] \\
      [--baseline-out FILE] [--json]

``serve`` starts a master and ``worker`` a worker of the HTTP fan-out
(``server/app.py``); both take ``--host``, ``--port``, ``--config`` (the
cluster config, else ``DISTRIBUTED_TPU_CONFIG`` or
``./cluster_config.json``), ``--models-dir``, ``--input-dir``,
``--output-dir`` and ``--device`` (``cuda`` unless the caller asks for
``cpu``; asked for ``cuda`` without a card, they exit with an error).
A worker whose environment has ``DTPU_MASTER_URL`` and
``DTPU_WORKER_ID`` registers at that master and renews its lease
(``runtime/cluster.py``); the control plane's other knobs are
``DTPU_LEASE_S``, ``DTPU_SUSPECT_PROBES``, ``DTPU_FAULT_POLICY`` and
``DTPU_HEDGE*``.  A ``serve`` master with ``DTPU_WAL_DIR`` keeps its
queue and work ledger in a write-ahead log there (``runtime/durable.py``;
``DTPU_WAL_SYNC``, ``DTPU_MASTER_LEASE_S``, ``DTPU_MASTER_ID``) and
resumes what a crash interrupted when it starts again; with
``DTPU_STANDBY=1`` as well it waits as a standby and takes over when the
master's lease expires.  A start refused for a live lease exits 1.
With ``DTPU_SHARD_ID``, ``DTPU_SHARD_PEERS`` (``id=url,...``, itself
included) and ``DTPU_SHARD_WAL_ROOT`` a ``serve`` master is one of
several active masters, each owning a share of the prompt ids
(``runtime/shard.py``); its log is ``DTPU_SHARD_WAL_ROOT/<id>``, and it
absorbs a dead peer's shard.  A worker with ``DTPU_MASTER_URLS`` (a
comma list) heartbeats every master.  Admission (``DTPU_MAX_QUEUE``,
``DTPU_TENANT_*``), the SLO spec (``DTPU_SLO_SPEC``) and the drain
(``DTPU_DRAIN_TIMEOUT_S``, on SIGINT or SIGTERM) apply to both roles.
The dispatch model is the JAX package's default: coalesced groups of
signature-equal plain graphs (``DTPU_COALESCE``, ``DTPU_MAX_COALESCE``),
the finalize overlapped with the next group (``DTPU_OVERLAP``,
``DTPU_HOSTIO_THREADS``, ``DTPU_HOSTIO_PENDING``), the reuse plane's
three tiers (``DTPU_CACHE``, ``DTPU_CACHE_BYTES``,
``DTPU_CACHE_DEVICE_BYTES``, ``DTPU_CACHE_TILE_BYTES``,
``DTPU_CACHE_ENTRIES``), the preview route (``DTPU_PREVIEW``,
``DTPU_PREVIEW_MAX_CLIENTS``) and a startup warmup (``DTPU_WARMUP``, a
JSON body of ``POST /distributed/warmup``).  A ``serve`` master with
``DTPU_AUTOSCALE=1`` runs the elastic fleet (``runtime/autoscale.py``:
``DTPU_AUTOSCALE_*``): it spawns ``auto_*`` workers under sustained
queue, utilization or paid-burn pressure and retires them by drain and
lease non-renewal; ``DTPU_CHAOS`` (``utils/chaos.py``) injects faults.

``router`` runs the stateless admission router over the masters
(``--masters`` or ``DTPU_ROUTER_MASTERS``): each ``/prompt`` goes to the
shard that owns its id, a 429's ``Retry-After`` is relayed, and
``/history``, ``/distributed/cluster``, ``/distributed/cluster/
metrics`` and ``/distributed/fleet`` are merged over the shards.  It imports no torch and opens no
card.  ``slo`` prints a server's burn rates (``GET /distributed/slo``):
each class's objectives, its fast and slow windows and the budget left.
``reuse`` prints the reuse plane of a server's ``GET
/distributed/metrics``: each tier's entries, bytes against its budget,
hits, misses and evictions, the replays and abandonments and the
preview channel's clients.  ``top`` prints the federated resource
table of ``GET /distributed/cluster/metrics`` and ``fleet`` the
autoscaler's decisions and signal, the admission counters and an armed
chaos spec of ``GET /distributed/fleet``.

``run`` executes an API-format workflow in this process, writes every
collected image as ``DIR/run_NNNNN.png`` and prints one JSON summary
line, as ``python -m comfyui_distributed_tpu.cli run`` does; with
``--via`` it queues the workflow on a running master instead (which fans
it out to its enabled workers), polls ``/history`` and prints the
prompt's entry.

``cluster`` prints a master's control plane (``GET
/distributed/cluster``): each worker's lease state, the work ledger's
active and finished jobs with their recovered units, and the policy.

``workers`` prints the config's workers with one health probe each and
their managed processes; ``launch``, ``stop`` and ``log`` start, stop
or tail one managed worker (``runtime/manager.py``) from this process,
or through a running master's routes with ``--url``.  A worker
launched from here is not tied to this short-lived process (no
master-death monitor).  ``status`` prints a server's ``GET
/distributed/status``, or at a router's URL the merged view (the ring
and every shard's workers and jobs); ``devices`` the cards torch sees (``platform``,
``kind`` and ``count``, 0 without a card, beside the JAX package's
keys).  ``wal`` verifies a write-ahead log's directory (``--dir`` or
``DTPU_WAL_DIR``; either package's): each segment's checksums, the
snapshots, the lease, the records by type and by job and what a
recovering master would resume; it exits 1 on corruption (a torn last
record is what a crash leaves, not corruption).

``trace``, ``why`` and ``analyze`` are the JAX package's readers of
traces, over a running server's flight recorder (``--url``) or the
capture files of either package (``--export-dir``): ``trace`` lists the
recorded jobs or prints one job's span tree (``--perfetto``: Chrome
trace-event JSON); ``why`` cuts one job's end-to-end seconds into blame
categories and the unattributed gap, and prints the critical path;
``analyze`` prints profiles by tenant, signature and worker and the
straggler scorecard, ``--diff`` tests two capture directories for a
regression (exit 3 on one) and ``--baseline-out`` writes the profile
that arms ``DTPU_ANALYSIS_BASELINE``.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
import urllib.parse


def _check_device(device: str) -> None:
    """Refuse ``cuda`` without a card, and keep fp32 layers (the VAE) in
    fp32 on it: no TF32 in cuBLAS or cuDNN, the numerics ``chip_smoke.py``
    checks the port with."""
    import torch
    if torch.device(device).type == "cuda" and not torch.cuda.is_available():
        raise SystemExit(f"--device {device}: torch.cuda.is_available() is "
                         "false (pass --device cpu to run on the CPU)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _serve(args, is_worker: bool) -> int:
    _check_device(args.device)
    from comfyui_distributed_tpu_torch.server.app import ServerState, serve
    try:
        state = ServerState(config_path=args.config, is_worker=is_worker,
                            input_dir=args.input_dir,
                            output_dir=args.output_dir,
                            models_dir=args.models_dir, device=args.device)
    except RuntimeError as e:   # a live master lease held by another
        print(f"dtpu-torch {e}", file=sys.stderr)
        return 1
    serve(state, host=args.host, port=args.port)
    return 0


def cmd_serve(args) -> int:
    return _serve(args, is_worker=False)


def cmd_worker(args) -> int:
    return _serve(args, is_worker=True)


def cmd_run(args) -> int:
    if args.via:
        return _run_via_server(args)
    _check_device(args.device)
    from comfyui_distributed_tpu_torch.ops.base import OpContext
    from comfyui_distributed_tpu_torch.utils.image import save_png
    from comfyui_distributed_tpu_torch.workflow import WorkflowExecutor
    ctx = OpContext(device=args.device, models_dir=args.models_dir,
                    input_dir=args.input_dir,
                    output_dir=args.out or os.path.join(os.getcwd(),
                                                        "output"))
    res = WorkflowExecutor(ctx).execute(args.workflow)
    os.makedirs(ctx.output_dir, exist_ok=True)
    for i, img in enumerate(res.images):
        save_png(os.path.join(ctx.output_dir, f"run_{i:05d}.png"), img)
    print(json.dumps({
        "images": len(res.images),
        "total_s": round(res.total_s, 3),
        "timings": {k: round(v, 3) for k, v in res.timings.items()},
        "output_dir": ctx.output_dir,
    }))
    return 0


def _run_via_server(args) -> int:
    """Queue the workflow on the master at ``--via`` and poll its
    ``/history`` until the prompt is there or ``--timeout`` passes."""
    from comfyui_distributed_tpu_torch.utils.net import get_json, post_json
    from comfyui_distributed_tpu_torch.workflow.graph import parse_workflow
    prompt = parse_workflow(args.workflow).to_api_format()
    res = post_json(f"{args.via}/prompt", {"prompt": prompt,
                                           "client_id": "dtpu-cli"})
    pid = res["prompt_id"]
    if res.get("workers"):
        print(f"dispatched to workers: {res['workers']}", file=sys.stderr)
    deadline = time.time() + args.timeout
    while time.time() < deadline:
        hist = get_json(f"{args.via}/history")
        if pid in hist:
            print(json.dumps({"prompt_id": pid, **hist[pid]}))
            return 0 if hist[pid].get("status") == "success" else 1
        time.sleep(1.0)
    print(json.dumps({"prompt_id": pid, "status": "timeout"}))
    return 1


def cmd_cluster(args) -> int:
    """The lease states, the ledger's jobs and the fault and hedge
    policy of the master at ``--url``, as the JAX package's ``cli
    cluster`` prints them."""
    from comfyui_distributed_tpu_torch.utils.net import get_json
    data = get_json(f"{args.url}/distributed/cluster", timeout=10)
    if args.json:
        print(json.dumps(data, indent=2))
        return 0
    hedge = data["hedge"]
    print(f"policy={data['policy']}  lease={data['lease_s']}s  "
          f"suspect_after={data['suspect_probes']} probes  "
          f"hedge={'armed' if hedge['armed'] else 'off'} "
          f"(>= {hedge['min_progress_pct']:g}% done, "
          f"{hedge['factor']:g}x latency)")
    workers = data.get("workers", {})
    if not workers:
        print("(no registered workers)")
    for wid, w in sorted(workers.items()):
        age, lease = w.get("last_seen_age_s"), w.get("lease_remaining_s")
        print(f"  {wid:16s} {w['state']:8s} "
              f"last_seen={'never' if age is None else f'{age:.1f}s ago'}"
              f"  lease_remaining={'-' if lease is None else f'{lease:.1f}s'}"
              f"  failed_probes={w['failed_probes']}"
              + (f"  {w.get('host')}:{w.get('port')}"
                 if w.get("port") else ""))
    ledger = data.get("ledger", {})
    for jid, job in sorted(ledger.get("active_jobs", {}).items()):
        print(f"  job {jid}: {job['done_units']}/{job['total_units']} "
              f"{job['kind']} units, {job['reassigned_units']} "
              f"reassigned, {job['hedged_units']} hedged")
    for job in ledger.get("completed_jobs", [])[-5:]:
        extra = ""
        if job["reassigned_units"] or job["hedged_units"]:
            extra = (f", {job['reassigned_units']} reassigned, "
                     f"{job['hedged_units']} hedged")
        if job["pending_units"]:
            extra += f", LOST {job['pending_units']}"
        print(f"  done {job['job_id']}: {job['done_units']}/"
              f"{job['total_units']} in {job['duration_s']}s{extra}")
    for t in data.get("transitions", [])[-8:]:
        print(f"  transition {t['worker_id']}: {t['from']} -> {t['to']}")
    return 0


def cmd_devices(args) -> int:
    from comfyui_distributed_tpu_torch.utils.resource import describe_devices
    view = describe_devices("cuda")
    print(json.dumps({**view, "kind": (view["devices"][0]["kind"]
                                       if view["devices"] else None),
                      "count": view["num_devices"]}, indent=2))
    return 0


def cmd_worker_ctl(args) -> int:
    """``launch``, ``stop`` or ``log`` of one worker: here, or through the
    master at ``--url``."""
    from comfyui_distributed_tpu_torch.utils.net import get_json, post_json
    if args.url:
        if args.action == "log":
            print(get_json(f"{args.url}/distributed/worker_log?id="
                           f"{urllib.parse.quote(args.id)}")["log"])
        else:
            print(json.dumps(post_json(
                f"{args.url}/distributed/{args.action}_worker",
                {"id": args.id})))
        return 0
    from comfyui_distributed_tpu_torch.runtime.manager import (
        WorkerProcessManager)
    from comfyui_distributed_tpu_torch.utils import config as cfg_mod
    manager = WorkerProcessManager(config_path=args.config)
    if args.action == "log":
        print(manager.tail_log(args.id))
        return 0
    if args.action == "stop":
        stopped = manager.stop_worker(args.id)
        print(json.dumps({"stopped": stopped}))
        return 0 if stopped else 1
    worker = next((w for w in cfg_mod.load_config(args.config)["workers"]
                   if str(w.get("id")) == str(args.id)), None)
    if worker is None:
        print(json.dumps({"error": f"worker {args.id} not in config"}))
        return 1
    # the monitor would end the worker as soon as this command exits
    print(json.dumps(manager.launch_worker(worker,
                                           stop_on_master_exit=False)))
    return 0


def cmd_workers(args) -> int:
    """The config's workers, each with one health probe and its managed
    process."""
    from comfyui_distributed_tpu_torch.runtime.health import HealthPoller
    from comfyui_distributed_tpu_torch.runtime.manager import (
        WorkerProcessManager)
    from comfyui_distributed_tpu_torch.utils import config as cfg_mod
    cfg = cfg_mod.load_config(args.config)
    managed = WorkerProcessManager(
        config_path=args.config).get_managed_workers()
    health = HealthPoller(config_path=args.config).poll_once()
    out = []
    for w in cfg.get("workers", []):
        wid = str(w.get("id"))
        out.append({
            "id": wid, "name": w.get("name", wid),
            "host": w.get("host") or "127.0.0.1", "port": w.get("port"),
            "enabled": bool(w.get("enabled")),
            "health": health.get(wid, {}).get("status", "unknown"),
            "queue_remaining": health.get(wid, {}).get("queue_remaining"),
            "managed": managed.get(wid)})
    print(json.dumps({"master": cfg.get("master", {}), "workers": out},
                     indent=2))
    return 0


def cmd_status(args) -> int:
    """A server's ``/distributed/status``; at a router's URL the merged
    view: its ring and the shards' workers and jobs."""
    from comfyui_distributed_tpu_torch.utils.net import get_json, request_json
    url = args.url.rstrip("/")
    try:
        code, ring, _ = request_json("GET", f"{url}/distributed/ring",
                                     timeout=5)
    except OSError:
        code, ring = 0, None
    if code == 200 and isinstance(ring, dict) and ring.get("router"):
        cluster = get_json(f"{url}/distributed/cluster", timeout=10)
        print(json.dumps({"router": ring, "shards": cluster.get("shards"),
                          "workers": cluster.get("workers"),
                          "ledger": cluster.get("ledger")}))
        return 0
    print(json.dumps(get_json(f"{url}/distributed/status", timeout=5)))
    return 0


def cmd_router(args) -> int:
    """The stateless admission router: ``/prompt`` spread by prompt-id
    hash over the masters' ring, the read views merged over the shards.
    No queue, no log, no lease: any number may run."""
    from comfyui_distributed_tpu_torch.runtime.shard import make_router_server
    from comfyui_distributed_tpu_torch.utils import constants as C
    masters = [u for u in (args.masters or os.environ.get(
        C.ROUTER_MASTERS_ENV, "")).split(",") if u.strip()]
    if not masters:
        print(f"no masters: pass --masters or set {C.ROUTER_MASTERS_ENV}",
              file=sys.stderr)
        return 2
    server = make_router_server(masters, host=args.host, port=args.port)
    print(f"dtpu-torch router listening on {args.host}:"
          f"{server.server_address[1]} over {len(masters)} seed "
          f"master(s)", flush=True)
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        server.server_close()
    return 0


def cmd_slo(args) -> int:
    """Per-class objectives, each window's count, ok ratio, p95 and burn
    rate, and the slow window's budget left, as the JAX package's ``cli
    slo`` prints them."""
    from comfyui_distributed_tpu_torch.utils.net import get_json
    data = get_json(f"{args.url}/distributed/slo", timeout=10)
    if args.json:
        print(json.dumps(data, indent=2))
        return 0
    if not data.get("enabled"):
        print("slo engine off (set DTPU_SLO_SPEC, e.g. "
              "'paid:p95<2s,completion>0.999')")
        return 0
    print(f"slo windows: fast={data['fast_window_s']:g}s "
          f"slow={data['slow_window_s']:g}s")
    for cls, t in sorted(data.get("tenants", {}).items()):
        objs = ", ".join(o["raw"] for o in t["objectives"]) or "-"
        print(f"  {cls}: {objs}  "
              f"budget_remaining={t['budget_remaining']:.2%}")
        for wname in ("fast", "slow"):
            w = t["windows"][wname]
            flag = "  BURNING" if w["burn_rate"] > 1.0 else ""
            print(f"    {wname:4s} n={w['count']:4d} "
                  f"ok={w['ok_ratio']:.3f} p95={w['p95_s']:.3f}s "
                  f"burn={w['burn_rate']:.2f}{flag}")
    return 0


def cmd_top(args) -> int:
    """The fleet's resource table from the master's federated ``GET
    /distributed/cluster/metrics``, one row a participant (device memory
    in use and peak, host RSS, utilization, queue depth, the snapshot's
    age), as the JAX package's ``cli top`` prints it."""
    from comfyui_distributed_tpu_torch.utils.net import get_json
    data = get_json(f"{args.url}/distributed/cluster/metrics", timeout=10)
    if args.json:
        print(json.dumps(data, indent=2))
        return 0
    parts = data.get("participants", {})
    print(f"{'participant':16s} {'state':8s} {'mem_mb':>9s} "
          f"{'peak_mb':>9s} {'rss_mb':>9s} {'util':>5s} {'queue':>5s} "
          f"{'age_s':>6s}  source")

    def mb(v):
        return f"{v / 1e6:.1f}" if isinstance(v, (int, float)) else "-"
    for wid, p in sorted(parts.items(),
                         key=lambda kv: (kv[1].get("state") != "self",
                                         kv[0])):
        res = p.get("resources") or {}
        util = res.get("utilization")
        qd = res.get("queue_depth")
        age = p.get("age_s")
        print(f"{wid:16s} {p.get('state', '?'):8s} "
              f"{mb(res.get('device_bytes_in_use')):>9s} "
              f"{mb(res.get('device_peak_bytes')):>9s} "
              f"{mb(res.get('host_rss_bytes')):>9s} "
              f"{f'{util:.0%}' if isinstance(util, (int, float)) else '-':>5s} "
              f"{qd if isinstance(qd, int) else '-':>5} "
              f"{f'{age:.1f}' if isinstance(age, (int, float)) else '-':>6s}  "
              f"{res.get('source', '?')}"
              + ("  STALE" if p.get("stale") else ""))
    if not parts:
        print("(no participants reported)")
    return 0


def cmd_fleet(args) -> int:
    """The elastic fleet from ``GET /distributed/fleet``: the
    autoscaler's state, bars and recent decisions, the signal it scales
    on, the admission counters by class and an armed chaos spec, as the
    JAX package's ``cli fleet`` prints them."""
    from comfyui_distributed_tpu_torch.utils.net import get_json
    data = get_json(f"{args.url}/distributed/fleet", timeout=10)
    if args.json:
        print(json.dumps(data, indent=2))
        return 0
    a = data.get("autoscale", {})
    if a.get("enabled"):
        th = a.get("thresholds", {})
        b = a.get("bounds", {})
        sig = a.get("signal") or {}
        print(f"autoscaler {'RUNNING' if a.get('running') else 'stopped'}"
              f"  workers[{b.get('min_workers')},{b.get('max_workers')}]"
              f"  up>q/p {th.get('up_queue_per_participant')} or util "
              f"{th.get('up_utilization')}  down<q/p "
              f"{th.get('down_queue_per_participant')}"
              f"  window={a.get('window')} cooldown={a.get('cooldown_s')}s")
        util = sig.get("utilization")
        print(f"  signal: queue={sig.get('queue_depth')} "
              f"({sig.get('queue_per_participant')}/participant), "
              f"util={f'{util:.0%}' if isinstance(util, (int, float)) else '-'}, "
              f"{sig.get('live_workers')} live workers")
        print(f"  actions: {a.get('scale_ups', 0)} up, "
              f"{a.get('scale_downs', 0)} down, "
              f"{a.get('flaps', 0)} flaps"
              + (f", retiring {a['retiring']}" if a.get("retiring")
                 else ""))
        for d in a.get("decisions", [])[-8:]:
            print(f"    {d['action']:4s} {d.get('reason', '')}"
                  + (f"  worker={d['worker_id']}" if d.get("worker_id")
                     else ""))
    else:
        print("autoscaler off"
              + (" (DTPU_AUTOSCALE=1 set but not installed — worker "
                 "or embedded server?)" if a.get("armed_env") else
                 " (set DTPU_AUTOSCALE=1 on the master to arm)"))
    adm = data.get("admission", {})
    per = adm.get("per_class", {})
    queued = adm.get("queued_by_class", {})
    print(f"admission: default={adm.get('default_class')}  weights="
          f"{adm.get('weights')}  shed_bars={adm.get('shed_thresholds')}"
          f"  drain={adm.get('drain_rate_per_s')}/s")
    for cls in adm.get("classes", sorted(per)):
        v = per.get(cls, {})
        print(f"  {cls:6s} queued={queued.get(cls, 0):3d}  "
              f"admitted={v.get('admitted', 0):5d}  "
              f"completed={v.get('completed', 0):5d}  "
              f"shed={v.get('shed_overload', 0)} overload"
              f"/{v.get('shed_rate', 0)} rate")
    chaos = data.get("chaos", {})
    if chaos.get("active"):
        print(f"CHAOS ARMED: {chaos}")
    return 0


def cmd_flightdeck(args) -> int:
    """The continuous-batching flight deck, as the JAX package's ``cli
    flightdeck`` prints it: the step-boundary timeline (busy, free and
    parked slots, the admits, retires and preemptions a boundary) and
    the admit-to-first-step histogram."""
    from comfyui_distributed_tpu_torch.utils.net import get_json
    b = get_json(f"{args.url}/distributed/metrics",
                 timeout=10).get("batching") or {}
    if args.json:
        print(json.dumps(b, indent=2))
        return 0
    if not b.get("enabled"):
        print("(no batching block reported — continuous batching off?)")
        return 1
    print(f"flight deck: running={b.get('running')} "
          f"admits={b.get('admits', 0)} retires={b.get('retires', 0)} "
          f"preemptions={b.get('preemptions', 0)} "
          f"retraces={b.get('retraces', 0)} "
          f"parked={b.get('parked', 0)}")
    h = b.get("admit_to_first_step") or {}
    if h.get("count"):
        print(f"admit->first step: n={h['count']} "
              f"p50={h.get('p50_s', 0):.3f}s p95={h.get('p95_s', 0):.3f}s "
              f"max={h.get('max_s', 0):.3f}s")
    deck = b.get("deck") or []
    rows = deck[-args.last:] if args.last else deck
    if rows:
        print(f"{'seq':>6s} {'bucket':8s} {'occupancy':18s} "
              f"{'park':>4s} {'adm':>4s} {'ret':>4s} {'pre':>4s}")
    for r in rows:
        bar = "#" * r["busy"] + "." * r["free"]
        print(f"{r['seq']:>6d} {r['bucket']:8s} {bar:18s} "
              f"{r['parked']:>4d} {r['admits']:>4d} {r['retires']:>4d} "
              f"{r['preemptions']:>4d}")
    if not rows:
        print("(deck timeline empty — no step boundaries yet)")
    return 0


def cmd_reuse(args) -> int:
    """The reuse plane's tiers, replays and preview channel, as the JAX
    package's ``cli reuse`` prints them."""
    from comfyui_distributed_tpu_torch.utils.net import get_json
    data = get_json(f"{args.url}/distributed/metrics", timeout=10)
    reuse = data.get("reuse") or {}
    if args.json:
        print(json.dumps(reuse, indent=2))
        return 0
    if not reuse:
        print("(no reuse block reported — older server?)")
        return 1
    print(f"reuse plane: enabled={reuse.get('enabled')} "
          f"total={reuse.get('bytes_total', 0) / 1e6:.1f}MB "
          f"generation={reuse.get('generation', 0)}")
    print(f"{'tier':8s} {'entries':>7s} {'mb':>9s} {'budget_mb':>9s} "
          f"{'hits':>7s} {'misses':>7s} {'evict':>6s}")
    for tier in ("result", "embed", "tile"):
        t = reuse.get(tier) or {}
        print(f"{tier:8s} {t.get('entries', 0):>7d} "
              f"{t.get('bytes', 0) / 1e6:>9.1f} "
              f"{t.get('max_bytes', 0) / 1e6:>9.1f} "
              f"{t.get('hits', 0):>7d} {t.get('misses', 0):>7d} "
              f"{t.get('evictions', 0):>6d}")
    print(f"replays={data.get('prompts_replayed', 0)} "
          f"abandoned={data.get('prompts_abandoned', 0)}")
    pv = reuse.get("previews") or {}
    print(f"previews: enabled={pv.get('enabled')} "
          f"clients={pv.get('clients', 0)} "
          f"watched={pv.get('watched_prompts', 0)} "
          f"abandon_pending={pv.get('abandoned_pending', 0)}")
    return 0


def cmd_wal(args) -> int:
    """Verify a write-ahead log's directory and print what it holds, as
    the JAX package's ``cli wal`` does; exit 1 on corruption."""
    from comfyui_distributed_tpu_torch.runtime import durable
    wal_dir = args.dir or durable.wal_dir()
    if not wal_dir:
        print("no log directory: pass --dir or set DTPU_WAL_DIR",
              file=sys.stderr)
        return 2
    if not os.path.isdir(wal_dir):
        print(f"not a directory: {wal_dir}", file=sys.stderr)
        return 2
    report = durable.verify(wal_dir)
    if args.json:
        print(json.dumps(report, indent=2))
        return 0 if report["ok"] else 1
    lease = report["lease"]
    print(f"wal {wal_dir}: {'OK' if report['ok'] else 'CORRUPT'}  lease="
          + (f"held by {lease.get('owner')}" if lease.get("held")
             else "expired/free")
          + f"  epoch={lease.get('epoch', 0)}")
    for seg in report["segments"]:
        print(f"  {seg['segment']:26s} {seg['bytes']:>9d} B  "
              f"{seg['records']:>5d} rec  {seg['checksum']}")
    if not report["segments"]:
        print("  (no segments)")
    for snap in report["snapshots"]:
        print(f"  {snap}  (snapshot)")
    if report["records_by_type"]:
        print("  records: " + ", ".join(
            f"{k}={v}" for k, v in sorted(report["records_by_type"].items())))
    rp = report["replay"]
    for jid, n in sorted(report["records_by_job"].items()):
        if args.job and args.job not in jid:
            continue
        live = rp["active_jobs"].get(jid)
        print(f"  job {jid}: {n} record(s), "
              + (f"OPEN {live['done']}/{live['total']} {live['kind']}"
                 if live else "finished"))
    print(f"  replay: {rp['records_replayed']} record(s) past "
          f"{'snapshot' if rp.get('snapshot') else 'genesis'}, "
          f"{len(rp['pending_prompts'])} in-flight prompt(s), "
          f"{len(rp['active_jobs'])} open job(s), idem keys "
          f"{rp['idem_keys']}")
    if rp["torn"]:
        print(f"  torn tail(s): {rp['torn']} (expected after a crash; "
              f"the partial record is ignored)")
    return 0 if report["ok"] else 1


def cmd_trace(args) -> int:
    """Flight-recorder reader: no id lists recent job traces; with an id,
    pretty-prints the job's span tree (indent = parent/child, one line
    per span with duration and status) — the headless way to answer
    "where did THIS job spend its time, across processes".  With
    --export-dir, reads durable capture files instead of a live server
    (post-mortem: the server may be gone); --perfetto emits
    Chrome/Perfetto trace-event JSON for chrome://tracing / ui.perfetto.dev.
    """
    import urllib.error
    import urllib.request
    from comfyui_distributed_tpu_torch.utils import trace_export

    def emit(rec) -> int:
        if args.perfetto:
            doc = trace_export.to_perfetto(rec)
            if args.out:
                with open(args.out, "w", encoding="utf-8") as f:
                    json.dump(doc, f)
                print(f"wrote {len(doc['traceEvents'])} events to "
                      f"{args.out}", file=sys.stderr)
            else:
                print(json.dumps(doc))
            return 0
        n_spans = rec.get("n_spans", len(rec.get("spans", ())))
        print(f"trace {rec['trace_id']}  job {rec['prompt_id']}  "
              f"status={rec['status']}  {rec.get('duration_s')}s  "
              f"{n_spans} spans")

        def walk(node, depth):
            mark = "" if node.get("status") == "ok" else \
                f"  !{node.get('status')}"
            attrs = node.get("attrs") or {}
            extra = "".join(f"  {k}={v}" for k, v in attrs.items()
                            if k in ("worker", "node", "coalesced", "job",
                                     "mem_peak_mb", "mem_peak_delta_mb",
                                     "device_peak_mb", "rss_mb"))
            print(f"{'  ' * depth}{node['name']}  "
                  f"{node['duration_s'] * 1e3:.1f}ms{extra}{mark}")
            for child in node.get("children", []):
                walk(child, depth + 1)

        tree = rec.get("tree")
        if tree is None:
            tree = trace_export.load_forest(rec)
        for root in tree:
            walk(root, 0)
        return 0

    if args.export_dir:
        # offline path: the durable capture files, no server required
        if not args.prompt_id:
            n = 0
            for rec in trace_export.iter_records(args.export_dir):
                dur = rec.get("duration_s")
                print(f"{rec['prompt_id']}  {rec['status']:5s}  "
                      f"{dur if dur is not None else '?':>8}s  "
                      f"{len(rec.get('spans', ())):3d} spans  "
                      f"trace={rec['trace_id']}")
                n += 1
            if not n:
                print("(no captured traces in "
                      f"{args.export_dir})")
            return 0
        rec = trace_export.load_trace(args.export_dir,
                                      prompt_id=args.prompt_id)
        if rec is None:
            print(f"no captured trace for {args.prompt_id!r} in "
                  f"{args.export_dir}", file=sys.stderr)
            return 1
        return emit(rec)
    if not args.prompt_id:
        with urllib.request.urlopen(f"{args.url}/distributed/traces",
                                    timeout=10) as r:
            data = json.loads(r.read())
        for t in data.get("traces", []):
            dur = t.get("duration_s")
            print(f"{t['prompt_id']}  {t['status']:5s}  "
                  f"{dur if dur is not None else '?':>8}s  "
                  f"{t['n_spans']:3d} spans  trace={t['trace_id']}")
        if not data.get("traces"):
            print("(no completed job traces recorded)")
        return 0
    try:
        with urllib.request.urlopen(
                f"{args.url}/distributed/trace/{args.prompt_id}",
                timeout=10) as r:
            rec = json.loads(r.read())
    except urllib.error.HTTPError as e:
        # error bodies may be plain text (older servers, proxies) — never
        # let the JSON parse mask the real status
        try:
            msg = json.loads(e.read()).get("error", str(e))
        except (ValueError, AttributeError):
            msg = str(e)
        print(msg, file=sys.stderr)
        return 1
    return emit(rec)


def cmd_why(args) -> int:
    """Latency autopsy for ONE job (`cli why <pid>`): the critical-path
    blame decomposition — every instant of the end-to-end interval
    attributed to the deepest covering span's category (queue_wait /
    admission / dispatch / compute / d2h / encode / upload / blend /
    park), with the uncovered remainder reported honestly as an
    unattributed gap instead of silently inflating a category.  Reads
    the live flight recorder, or durable capture files with
    --export-dir (post-mortem)."""
    import urllib.error
    import urllib.request
    from comfyui_distributed_tpu_torch.utils import trace_analysis
    from comfyui_distributed_tpu_torch.utils import trace_export
    if args.export_dir:
        rec = trace_export.load_trace(args.export_dir,
                                      prompt_id=args.prompt_id)
        if rec is None:
            print(f"no captured trace for {args.prompt_id!r} in "
                  f"{args.export_dir}", file=sys.stderr)
            return 1
    else:
        try:
            with urllib.request.urlopen(
                    f"{args.url}/distributed/trace/{args.prompt_id}",
                    timeout=10) as r:
                rec = json.loads(r.read())
        except urllib.error.HTTPError as e:
            try:
                msg = json.loads(e.read()).get("error", str(e))
            except (ValueError, AttributeError):
                msg = str(e)
            print(msg, file=sys.stderr)
            return 1
    bd = trace_analysis.critical_path(rec)
    if args.json:
        print(json.dumps(bd, indent=2))
        return 0
    e2e = bd["e2e_s"]
    print(f"job {bd['prompt_id']}  trace {bd['trace_id']}  "
          f"e2e={e2e:.3f}s")
    if e2e <= 0:
        print("(empty or zero-length trace — nothing to blame)")
        return 0
    print(f"{'category':14s} {'seconds':>9s} {'share':>7s}")
    for cat, secs in sorted(bd["categories"].items(),
                            key=lambda kv: -kv[1]):
        print(f"{cat:14s} {secs:>9.3f} {secs / e2e:>6.1%}")
    print(f"{'(unattributed)':14s} {bd['unattributed_s']:>9.3f} "
          f"{bd['unattributed_pct'] / 100:>6.1%}")
    if bd.get("negative_edges"):
        print(f"! {bd['negative_edges']} negative parent->child edges "
              "(cross-process clock skew; is DTPU_SKEW_CORRECTION on?)")
    print("critical path:")
    for seg in bd["path"]:
        who = f"  @{seg['worker']}" if seg.get("worker") else ""
        print(f"  +{seg['start_s']:>8.3f}s {seg['dur_s']:>8.3f}s  "
              f"{seg['name']} [{seg['category']}]{who}")
    return 0


def _print_analysis_report(report) -> None:
    """Shared pretty-printer for `cli analyze` (live route and offline
    capture dirs produce the same report shape)."""
    print(f"traces analysed: {report.get('n_traces', 0)}  "
          f"mean unattributed "
          f"{report.get('unattributed_pct_mean', 0.0):.1f}%  "
          f"negative_edges={report.get('negative_edges', 0)}")
    for group_by, groups in sorted(
            (report.get("profiles") or {}).items()):
        print(f"by {group_by}:")
        for key, prof in sorted(groups.items()):
            cats = "  ".join(
                f"{c}={v['mean_s']:.3f}s({v['share_pct']:.0f}%)"
                for c, v in sorted(
                    prof.get("categories", {}).items(),
                    key=lambda kv: -kv[1]["mean_s"])
                if v["mean_s"] > 0)
            print(f"  {key}: n={prof['n']} "
                  f"p50={prof['e2e_p50_s']:.3f}s "
                  f"p95={prof['e2e_p95_s']:.3f}s  {cats}")
    sc = report.get("stragglers") or {}
    workers = sc.get("workers") or {}
    if workers:
        print(f"straggler scorecard (fleet compute p95 median "
              f"{sc.get('fleet_median_p95_s', 0.0):.3f}s, "
              f"threshold {sc.get('threshold_x')}x):")
        for w, row in sorted(workers.items()):
            flag = "  STRAGGLER" if row["straggler"] else ""
            print(f"  {w}: n={row['n_spans']} "
                  f"p95={row['compute_p95_s']:.3f}s "
                  f"{row['vs_fleet_median_x']:.2f}x{flag}")
    hedging = report.get("hedging_latency_ema_s") or {}
    if hedging:
        ema = "  ".join(f"{j}={v}" for j, v in sorted(hedging.items()))
        print(f"ledger hedging EMA (active jobs): {ema}")
    skews = report.get("skew") or {}
    if skews:
        offs = "  ".join(f"{w}={s['offset_s'] * 1e3:+.1f}ms"
                         for w, s in sorted(skews.items()))
        print(f"clock skew: {offs}")
    live = report.get("live") or {}
    if live.get("armed"):
        print(f"anomaly plane armed (baseline {live.get('baseline')}): "
              f"{live.get('anomalies_total', 0)} anomalies over "
              f"{live.get('traces_analyzed', 0)} traces")


def cmd_analyze(args) -> int:
    """Cross-trace analytics (`cli analyze`): blame profiles grouped by
    tenant / structural signature / worker plus the per-worker
    straggler scorecard, over the live ring (GET /distributed/analysis)
    or durable capture dirs (--export-dir).  --diff A B runs the
    anomaly-gated regression diff between two capture dirs (permutation
    significance test; exit 3 when a regression is flagged);
    --baseline-out writes the profile JSON that arms the live anomaly
    plane via DTPU_ANALYSIS_BASELINE."""
    import urllib.request
    from comfyui_distributed_tpu_torch.utils import trace_analysis
    from comfyui_distributed_tpu_torch.utils import trace_export

    def offline_breakdowns(dir_path):
        stats: dict = {}
        records = list(trace_export.iter_records(dir_path, stats=stats))
        bds = trace_analysis.collect_breakdowns(records)
        skipped = stats.get("torn_lines", 0) \
            + stats.get("unknown_schema", 0)
        if skipped or stats.get("io_errors"):
            print(f"loader: {dir_path}: {stats['records']} records, "
                  f"{stats['torn_lines']} torn lines, "
                  f"{stats['unknown_schema']} unknown-schema, "
                  f"{stats['io_errors']} io errors", file=sys.stderr)
        return bds

    if args.diff:
        dir_a, dir_b = args.diff
        diff = trace_analysis.diff_breakdowns(
            offline_breakdowns(dir_a), offline_breakdowns(dir_b),
            seed=args.seed)
        if args.json:
            print(json.dumps(diff, indent=2))
        else:
            print(f"diff {dir_a} -> {dir_b}  "
                  f"(n={diff['n_a']} vs {diff['n_b']}, "
                  f"{diff['n_resamples']} resamples)")
            print(f"{'category':14s} {'mean_a':>9s} {'mean_b':>9s} "
                  f"{'delta':>8s} {'p':>6s}")
            for cat, row in diff["categories"].items():
                mark = "  REGRESSED" if row["flagged"] else (
                    "  (significant)" if row["significant"] else "")
                # delta_pct is None when the category was absent (mean
                # 0) in arm A -- the relative change is unbounded
                dp = (f"{row['delta_pct']:>+7.1f}%"
                      if row["delta_pct"] is not None else f"{'new':>8s}")
                print(f"{cat:14s} {row['mean_a_s']:>9.3f} "
                      f"{row['mean_b_s']:>9.3f} "
                      f"{dp} "
                      f"{row['p_value']:>6.3f}{mark}")
            print("verdict: " + ("REGRESSED in "
                                 + ", ".join(diff["flagged"])
                                 if diff["regressed"] else "clean"))
        return 3 if diff["regressed"] else 0

    if args.export_dir:
        records = [bd["_rec"]
                   for bd in offline_breakdowns(args.export_dir)]
        report = trace_analysis.analyze_records(records)
    else:
        with urllib.request.urlopen(
                f"{args.url}/distributed/analysis", timeout=10) as r:
            report = json.loads(r.read())
    if args.baseline_out:
        profile = report.get("fleet_profile")
        if not profile or not profile.get("n"):
            print("no traces to build a baseline from", file=sys.stderr)
            return 1
        trace_analysis.save_baseline(profile, args.baseline_out)
        print(f"wrote baseline profile ({profile['n']} traces) to "
              f"{args.baseline_out}", file=sys.stderr)
    if args.json:
        print(json.dumps(report, indent=2))
        return 0
    _print_analysis_report(report)
    return 0


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="comfyui_distributed_tpu_torch")
    sub = p.add_subparsers(dest="cmd", required=True)

    def common(q, device_help: str) -> None:
        q.add_argument("--models-dir", default=None)
        q.add_argument("--input-dir", default=None,
                       help="where LoadImage finds its files")
        q.add_argument("--device", default="cuda", help=device_help)

    for name, role, port, fn in (
            ("serve", "a master", 8288, cmd_serve),
            ("worker", "a worker", 8289, cmd_worker)):
        s = sub.add_parser(name, help=f"run {role} of the HTTP fan-out")
        common(s, "torch device (default cuda; exits if there is no card)")
        s.add_argument("--host", default="0.0.0.0")
        s.add_argument("--port", type=int, default=port)
        s.add_argument("--config", default=None,
                       help="cluster config JSON (default "
                            "$DISTRIBUTED_TPU_CONFIG or ./cluster_config.json)")
        s.add_argument("--output-dir", default=None,
                       help="where SaveImage writes (default ./output)")
        s.set_defaults(fn=fn)

    r = sub.add_parser("run", help="run an API-format workflow")
    r.add_argument("workflow")
    common(r, "torch device (default cuda; cpu runs each kernel's plain "
              "version)")
    r.add_argument("--out", default=None)
    r.add_argument("--via", default=None, metavar="URL",
                   help="queue on a running master (it fans out to its "
                        "workers) instead of running in this process")
    r.add_argument("--timeout", type=float, default=600.0,
                   help="seconds to wait for the prompt with --via")
    r.set_defaults(fn=cmd_run)

    c = sub.add_parser("cluster", help="print a master's lease states and "
                                       "work ledger")
    c.add_argument("--url", default="http://127.0.0.1:8288")
    c.add_argument("--json", action="store_true",
                   help="the raw /distributed/cluster body")
    c.set_defaults(fn=cmd_cluster)

    d = sub.add_parser("devices", help="the cards torch sees")
    d.set_defaults(fn=cmd_devices)

    w = sub.add_parser("workers", help="the config's workers: health and "
                                       "managed processes")
    w.add_argument("--config", default=None)
    w.set_defaults(fn=cmd_workers)

    for action in ("launch", "stop", "log"):
        a = sub.add_parser(action, help=f"{action} a managed worker")
        a.add_argument("id")
        a.add_argument("--config", default=None)
        a.add_argument("--url", default=None,
                       help="act through the running master at URL")
        a.set_defaults(fn=cmd_worker_ctl, action=action)

    def master_alias(q) -> None:
        # --master names a master or a router, whose URL gives the
        # merged view over the shards
        q.add_argument("--master", dest="url", default=argparse.SUPPRESS,
                       metavar="URL",
                       help="master (or router) base URL (alias of --url)")

    master_alias(c)
    st = sub.add_parser("status", help="a running server's status, or a "
                                       "router's merged view")
    st.add_argument("--url", default="http://127.0.0.1:8288")
    master_alias(st)
    st.set_defaults(fn=cmd_status)

    ro = sub.add_parser("router", help="stateless admission router over "
                                       "sharded masters: /prompt by "
                                       "prompt-id hash, merged read views")
    ro.add_argument("--host", default="0.0.0.0")
    ro.add_argument("--port", type=int, default=8290)
    ro.add_argument("--masters", default=None,
                    help="comma-separated master URLs (default "
                         "$DTPU_ROUTER_MASTERS)")
    ro.set_defaults(fn=cmd_router)

    so = sub.add_parser("slo", help="SLO burn rates: each class's "
                                    "objectives over the fast and slow "
                                    "windows, the budget left")
    so.add_argument("--url", default="http://127.0.0.1:8288")
    so.add_argument("--json", action="store_true",
                    help="the raw /distributed/slo body")
    so.set_defaults(fn=cmd_slo)

    tp = sub.add_parser("top", help="fleet resource table: device memory/"
                                    "utilization per participant from the "
                                    "master's federated metrics")
    tp.add_argument("--url", default="http://127.0.0.1:8288")
    master_alias(tp)
    tp.add_argument("--json", action="store_true",
                    help="raw JSON instead of the table")
    tp.set_defaults(fn=cmd_top)

    fl = sub.add_parser("fleet", help="elastic-fleet status: autoscaler "
                                      "decisions + signal, per-tenant "
                                      "admission counters, chaos spec")
    fl.add_argument("--url", default="http://127.0.0.1:8288")
    master_alias(fl)
    fl.add_argument("--json", action="store_true",
                    help="raw JSON instead of the pretty report")
    fl.set_defaults(fn=cmd_fleet)

    ru = sub.add_parser("reuse", help="cross-request reuse status: "
                                      "per-tier cache counters and "
                                      "residency, exact-hit replays, "
                                      "preview clients")
    ru.add_argument("--url", default="http://127.0.0.1:8288")
    ru.add_argument("--json", action="store_true",
                    help="the raw reuse block")
    ru.set_defaults(fn=cmd_reuse)

    fd = sub.add_parser("flightdeck", help="continuous-batching flight "
                                           "deck: step-boundary occupancy "
                                           "timeline + admit-to-first-"
                                           "step latency")
    fd.add_argument("--url", default="http://127.0.0.1:8288")
    fd.add_argument("--last", type=int, default=32, metavar="N",
                    help="show only the last N timeline rows (0 = all)")
    fd.add_argument("--json", action="store_true",
                    help="raw JSON batching block instead of the table")
    fd.set_defaults(fn=cmd_flightdeck)

    wl = sub.add_parser("wal", help="verify a write-ahead log: segments, "
                                    "checksums, lease, records, replay")
    wl.add_argument("--dir", default=None,
                    help="the log's directory (default $DTPU_WAL_DIR)")
    wl.add_argument("--job", default=None,
                    help="list only the jobs whose id holds this text")
    wl.add_argument("--json", action="store_true",
                    help="the raw report")
    wl.set_defaults(fn=cmd_wal)

    tr = sub.add_parser("trace", help="read a job's distributed trace "
                                     "from a server's flight recorder "
                                     "or durable capture files")
    tr.add_argument("prompt_id", nargs="?", default=None,
                   help="prompt id to print (omit to list recent traces)")
    tr.add_argument("--url", default="http://127.0.0.1:8288")
    tr.add_argument("--export-dir", default=None, metavar="DIR",
                   help="read durable capture files from DIR instead of "
                        "a live server (post-mortem)")
    tr.add_argument("--perfetto", action="store_true",
                   help="emit Chrome/Perfetto trace-event JSON instead "
                        "of the pretty tree (load in ui.perfetto.dev)")
    tr.add_argument("--out", default=None, metavar="FILE",
                   help="write --perfetto JSON to FILE instead of stdout")
    tr.set_defaults(fn=cmd_trace)

    wh = sub.add_parser("why", help="latency autopsy for one job: "
                                   "critical-path blame per category + "
                                   "the unattributed gap")
    wh.add_argument("prompt_id", help="prompt id to autopsy")
    wh.add_argument("--url", default="http://127.0.0.1:8288")
    wh.add_argument("--export-dir", default=None, metavar="DIR",
                   help="read durable capture files from DIR instead of "
                        "a live server (post-mortem)")
    wh.add_argument("--json", action="store_true",
                   help="raw breakdown dict instead of the blame table")
    wh.set_defaults(fn=cmd_why)

    an = sub.add_parser("analyze", help="cross-trace analytics: blame "
                                       "profiles by tenant/signature/"
                                       "worker, straggler scorecard, "
                                       "regression diffs")
    an.add_argument("--url", default="http://127.0.0.1:8288")
    an.add_argument("--export-dir", default=None, metavar="DIR",
                   help="analyse durable capture files from DIR instead "
                        "of the live flight-recorder ring")
    an.add_argument("--diff", nargs=2, default=None,
                   metavar=("DIR_A", "DIR_B"),
                   help="regression diff between two capture dirs "
                        "(baseline A vs candidate B); exit 3 when a "
                        "significant regression is flagged")
    an.add_argument("--baseline-out", default=None, metavar="FILE",
                   help="write the fleet blame profile as the baseline "
                        "JSON that arms DTPU_ANALYSIS_BASELINE")
    an.add_argument("--seed", type=int, default=0,
                   help="resampling seed for the --diff significance "
                        "test (deterministic)")
    an.add_argument("--json", action="store_true",
                   help="the raw report")
    an.set_defaults(fn=cmd_analyze)
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
