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
  python -m comfyui_distributed_tpu_torch.cli devices
  python -m comfyui_distributed_tpu_torch.cli wal [--dir D] [--job S] [--json]

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
/distributed/status``; ``devices`` the cards torch sees (``platform``,
``kind`` and ``count``, 0 without a card, beside the JAX package's
keys).  ``wal`` verifies a write-ahead log's directory (``--dir`` or
``DTPU_WAL_DIR``; either package's): each segment's checksums, the
snapshots, the lease, the records by type and by job and what a
recovering master would resume; it exits 1 on corruption (a torn last
record is what a crash leaves, not corruption).
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
    from comfyui_distributed_tpu_torch.utils.net import get_json
    print(json.dumps(get_json(f"{args.url}/distributed/status", timeout=5)))
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

    st = sub.add_parser("status", help="a running server's status")
    st.add_argument("--url", default="http://127.0.0.1:8288")
    st.set_defaults(fn=cmd_status)

    wl = sub.add_parser("wal", help="verify a write-ahead log: segments, "
                                    "checksums, lease, records, replay")
    wl.add_argument("--dir", default=None,
                    help="the log's directory (default $DTPU_WAL_DIR)")
    wl.add_argument("--job", default=None,
                    help="list only the jobs whose id holds this text")
    wl.add_argument("--json", action="store_true",
                    help="the raw report")
    wl.set_defaults(fn=cmd_wal)
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
