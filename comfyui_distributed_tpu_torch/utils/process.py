"""Process helpers of the worker manager: the counterpart of
``comfyui_distributed_tpu/utils/process.py``.

Liveness, terminate-then-kill, the kill of a whole process tree and the
start of a child in a session of its own.  psutil is used where it is
installed to list a tree and to read liveness; without it the POSIX
branch runs: one ``ps -Ao pid=,ppid=`` snapshot of the process table
lists the tree.  Either way every process
of the tree gets TERM, and what is left after the timeout KILL.

Two differences from the JAX package's copy:

- a zombie (a child that exited and that nobody reaped yet) is dead in
  the POSIX branch too, read from ``/proc/<pid>/stat``, as psutil's
  branch has it; without that, a managed worker's monitor, a child of
  the master, would read alive after its kill;
- a tree that ``ps`` cannot list raises ``OSError`` instead of
  reporting the root's liveness alone, which would call a stop complete
  while the children run on.

:func:`kill_process_tree` returns the branch it took beside the result,
so a caller can log it.
"""

from __future__ import annotations

import os
import signal
import subprocess
import sys
import time
from typing import Dict, List, Optional, Tuple

try:
    import psutil
except ImportError:
    psutil = None

from comfyui_distributed_tpu_torch.utils.constants import (
    PROCESS_TERMINATION_TIMEOUT,
    PROCESS_WAIT_TIMEOUT,
)


def _is_zombie(pid: int) -> bool:
    """Linux: the state field of ``/proc/<pid>/stat`` is ``Z``.  The
    command name before it is in parentheses and may hold spaces."""
    try:
        with open(f"/proc/{pid}/stat", "r", encoding="utf-8",
                  errors="replace") as f:
            stat = f.read()
    except OSError:
        return False
    fields = stat.rsplit(")", 1)[-1].split()
    return bool(fields) and fields[0] == "Z"


def is_process_alive(pid: Optional[int]) -> bool:
    """True while ``pid`` runs: signal 0 reaches it and it is no
    zombie."""
    if pid is None or pid <= 0:
        return False
    if psutil is not None:
        try:
            p = psutil.Process(pid)
            return p.is_running() and p.status() != psutil.STATUS_ZOMBIE
        except psutil.Error:
            return False
    try:
        os.kill(pid, 0)
    except PermissionError:
        return True   # it exists, owned by another user
    except OSError:
        return False
    return not _is_zombie(pid)


def terminate_process(proc: subprocess.Popen,
                      timeout: float = PROCESS_TERMINATION_TIMEOUT) -> None:
    """TERM, wait up to ``timeout``, then KILL and reap."""
    if proc.poll() is not None:
        return
    proc.terminate()
    try:
        proc.wait(timeout=timeout)
    except subprocess.TimeoutExpired:
        proc.kill()
        try:
            proc.wait(timeout=PROCESS_WAIT_TIMEOUT)
        except subprocess.TimeoutExpired:
            pass


def _descendants(root: int) -> List[int]:
    """Every descendant of ``root`` in one ``ps`` snapshot (Linux and
    BSD alike, unlike GNU-only ``--ppid``).  Raises OSError when ``ps``
    is missing or fails."""
    res = subprocess.run(["ps", "-Ao", "pid=,ppid="], capture_output=True,
                         text=True, check=False)
    if res.returncode != 0:
        raise OSError(f"ps exited {res.returncode}: {res.stderr.strip()}")
    children: Dict[int, List[int]] = {}
    for line in res.stdout.splitlines():
        parts = line.split()
        if len(parts) == 2 and parts[0].isdigit() and parts[1].isdigit():
            children.setdefault(int(parts[1]), []).append(int(parts[0]))
    out: List[int] = []
    frontier = [root]
    while frontier:
        kids = children.get(frontier.pop(), [])
        out.extend(kids)
        frontier.extend(kids)
    return out


def _wait_dead(pids: List[int], timeout: float) -> bool:
    deadline = time.monotonic() + timeout
    while True:
        if not any(is_process_alive(p) for p in pids):
            return True
        if time.monotonic() >= deadline:
            return False
        time.sleep(0.05)


def kill_process_tree(pid: int, timeout: float = PROCESS_TERMINATION_TIMEOUT
                      ) -> Tuple[bool, str]:
    """Kill ``pid`` and all its descendants: TERM to each, then KILL to
    what is alive after ``timeout``.  Returns (no process of the tree
    is alive, the branch that listed it: ``"gone"`` when ``pid`` was not
    alive, ``"psutil"`` or ``"ps"``).  Raises OSError when the tree
    cannot be listed."""
    if not is_process_alive(pid):
        return True, "gone"
    if psutil is not None:
        try:
            tree = [c.pid for c in psutil.Process(pid).children(
                recursive=True)] + [pid]
        except psutil.NoSuchProcess:
            return True, "gone"
        branch = "psutil"
    else:
        tree, branch = _descendants(pid) + [pid], "ps"
    for p in tree:
        try:
            os.kill(p, signal.SIGTERM)
        except OSError:
            pass
    if _wait_dead(tree, timeout):
        return True, branch
    for p in tree:
        if is_process_alive(p):
            try:
                os.kill(p, signal.SIGKILL)
            except OSError:
                pass
    return _wait_dead(tree, PROCESS_WAIT_TIMEOUT), branch


def get_python_executable() -> str:
    return sys.executable or "python3"


def popen_detached(cmd, env=None, stdout=None, stderr=None,
                   cwd: Optional[str] = None) -> subprocess.Popen:
    """Start a child in a session of its own, so a signal to the
    master's process group does not reach it."""
    return subprocess.Popen(
        [str(c) for c in cmd], env=env, stdout=stdout, stderr=stderr,
        cwd=cwd, start_new_session=True)
