"""The master-death monitor: the wrapper a master starts each managed
worker under, the counterpart of
``comfyui_distributed_tpu/runtime/monitor.py``.

It starts the worker command, then polls the master's PID every
``WORKER_CHECK_INTERVAL`` seconds.  When the master is gone it kills the
worker's process tree and exits 0; when the worker exits on its own it
exits with the worker's code.  TERM or INT to the monitor kill the
worker's tree first.

    python -m comfyui_distributed_tpu_torch.runtime.monitor \\
        --master-pid PID -- WORKER COMMAND...
"""

from __future__ import annotations

import argparse
import signal
import subprocess
import sys
import time

from comfyui_distributed_tpu_torch.utils.constants import WORKER_CHECK_INTERVAL
from comfyui_distributed_tpu_torch.utils.process import (
    is_process_alive,
    kill_process_tree,
    terminate_process,
)


def monitor_and_run(master_pid: int, cmd: list) -> int:
    child = subprocess.Popen(cmd)

    def cleanup(signum=None, _frame=None):
        kill_process_tree(child.pid)
        sys.exit(0 if signum is None else 128 + signum)

    for sig in (signal.SIGINT, signal.SIGTERM):
        signal.signal(sig, cleanup)

    while True:
        code = child.poll()
        if code is not None:
            return code   # the worker exited on its own
        if not is_process_alive(master_pid):
            print(f"[monitor] master {master_pid} died; stopping worker "
                  f"{child.pid}", file=sys.stderr, flush=True)
            # the tree before the reap: a reaped worker's children
            # would be orphans no listing finds
            _, branch = kill_process_tree(child.pid)
            terminate_process(child)
            print(f"[monitor] worker {child.pid} stopped ({branch})",
                  file=sys.stderr, flush=True)
            return 0
        time.sleep(WORKER_CHECK_INTERVAL)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--master-pid", type=int, required=True)
    ap.add_argument("cmd", nargs=argparse.REMAINDER)
    args = ap.parse_args()
    cmd = args.cmd
    if cmd and cmd[0] == "--":
        cmd = cmd[1:]
    if not cmd:
        ap.error("no worker command given")
    return monitor_and_run(args.master_pid, cmd)


if __name__ == "__main__":
    sys.exit(main())
