"""Command-line interface of the torch package.

  python -m comfyui_distributed_tpu_torch.cli serve  [--port 8288]
  python -m comfyui_distributed_tpu_torch.cli worker --port 8289
  python -m comfyui_distributed_tpu_torch.cli run workflow.json \\
      [--out DIR] [--models-dir DIR] [--input-dir DIR] [--device cuda|cpu]
  python -m comfyui_distributed_tpu_torch.cli run workflow.json --via URL

``serve`` starts a master and ``worker`` a worker of the HTTP fan-out
(``server/app.py``); both take ``--host``, ``--port``, ``--config`` (the
cluster config, else ``DISTRIBUTED_TPU_CONFIG`` or
``./cluster_config.json``), ``--models-dir``, ``--input-dir``,
``--output-dir`` and ``--device`` (``cuda`` unless the caller asks for
``cpu``; asked for ``cuda`` without a card, they exit with an error).

``run`` executes an API-format workflow in this process, writes every
collected image as ``DIR/run_NNNNN.png`` and prints one JSON summary
line, as ``python -m comfyui_distributed_tpu.cli run`` does; with
``--via`` it queues the workflow on a running master instead (which fans
it out to its enabled workers), polls ``/history`` and prints the
prompt's entry.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time


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
    state = ServerState(config_path=args.config, is_worker=is_worker,
                        input_dir=args.input_dir, output_dir=args.output_dir,
                        models_dir=args.models_dir, device=args.device)
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
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
