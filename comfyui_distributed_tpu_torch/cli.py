"""Command-line interface of the torch package: ``run`` only.

  python -m comfyui_distributed_tpu_torch.cli run workflow.json \\
      [--out DIR] [--models-dir DIR] [--input-dir DIR] [--device cuda|cpu]

Runs an API-format workflow through the port's executor, writes every
collected image as ``DIR/run_NNNNN.png`` and prints one JSON summary
line, as ``python -m comfyui_distributed_tpu.cli run`` does.
"""

from __future__ import annotations

import argparse
import json
import os
import sys


def cmd_run(args) -> int:
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


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="comfyui_distributed_tpu_torch")
    sub = p.add_subparsers(dest="cmd", required=True)
    r = sub.add_parser("run", help="run an API-format workflow")
    r.add_argument("workflow")
    r.add_argument("--out", default=None)
    r.add_argument("--models-dir", default=None)
    r.add_argument("--input-dir", default=None,
                   help="where LoadImage finds its files")
    r.add_argument("--device", default="cuda",
                   help="torch device (default cuda; cpu runs each "
                        "kernel's plain version)")
    r.set_defaults(fn=cmd_run)
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
