"""The worker process manager: the counterpart of
``WorkerProcessManager``, ``auto_launch_workers`` and
``install_exit_hooks`` in ``comfyui_distributed_tpu/runtime/manager.py``.
The server and the CLI each build their own manager over their config,
so the JAX package's process-wide ``get_manager`` has no counterpart.

A master starts worker servers on its own host, each as
``python -m comfyui_distributed_tpu_torch.cli worker --port N`` (with
the master's ``--config`` and ``--models-dir`` and the worker's
``extra_args``), under the master-death monitor
(``runtime/monitor.py``) unless asked not to.  Each worker writes a
daily log, ``{name}_{YYYYMMDD}.log`` under ``logs/workers/``, and each
session in it starts with a ``=== session ... cmd=... ===`` header.  The
PIDs live in the config's ``managed_processes``: a manager that loads
them keeps the live ones and purges the rest.  A stop kills the
worker's whole process tree.

A worker inherits the master's environment plus ``DTPU_MASTER_PID``,
``DTPU_WORKER_ID`` and, when the config's ``master`` section names a
port, ``DTPU_MASTER_URL``, so it heartbeats its lease back to the master
(``runtime/cluster.py``).  What the JAX package adds for JAX (the
persistent compile cache, the mesh and batching checks, dropping the
pod's process identity) is not ported.
"""

from __future__ import annotations

import atexit
import datetime
import os
import signal
import sys
import threading
from typing import Any, Dict, List, Optional

from comfyui_distributed_tpu_torch.utils import config as cfg_mod
from comfyui_distributed_tpu_torch.utils import constants as C
from comfyui_distributed_tpu_torch.utils import process as proc
from comfyui_distributed_tpu_torch.utils.log import log


class WorkerProcessManager:
    """The locally started workers of one master, by worker id."""

    def __init__(self, config_path: Optional[str] = None,
                 log_dir: Optional[str] = None,
                 models_dir: Optional[str] = None):
        self.config_path = config_path
        self.models_dir = models_dir
        self.log_dir = log_dir or os.path.join(os.getcwd(), "logs", "workers")
        self.processes: Dict[str, Dict[str, Any]] = {}  # guarded-by: _lock
        self._lock = threading.Lock()
        self.load_processes()

    # --- launch --------------------------------------------------------------

    def build_launch_command(self, worker: Dict[str, Any]) -> List[str]:
        cmd = [proc.get_python_executable(), "-m",
               "comfyui_distributed_tpu_torch.cli", "worker",
               "--port", str(worker["port"])]
        if self.config_path:
            cmd.extend(["--config", self.config_path])
        if self.models_dir:
            cmd.extend(["--models-dir", self.models_dir])
        extra = worker.get("extra_args")
        if extra:
            cmd.extend(str(extra).split())
        return cmd

    def _log_file(self, name: str) -> str:
        os.makedirs(self.log_dir, exist_ok=True)
        day = datetime.date.today().strftime("%Y%m%d")
        return os.path.join(self.log_dir, f"{name}_{day}.log")

    def _worker_env(self, wid: str) -> Dict[str, str]:
        env = dict(os.environ)
        env[C.MASTER_PID_ENV] = str(os.getpid())
        env[C.WORKER_ID_ENV] = wid
        if C.MASTER_URL_ENV not in env:
            master = cfg_mod.load_config(self.config_path).get("master", {})
            if master.get("port"):
                env[C.MASTER_URL_ENV] = (
                    f"http://{master.get('host') or '127.0.0.1'}"
                    f":{master['port']}")
        return env

    def launch_worker(self, worker: Dict[str, Any],
                      stop_on_master_exit: bool = True) -> Dict[str, Any]:
        """Start ``worker`` (a config entry); its entry, without the
        process object.  RuntimeError when it is running already or a
        stop came while it started."""
        wid = str(worker["id"])
        with self._lock:
            existing = self.processes.get(wid)
            if existing and (existing.get("pid") is None   # launch in flight
                             or proc.is_process_alive(existing["pid"])):
                raise RuntimeError(
                    f"worker {wid} already running (pid {existing['pid']})")
            # the slot is reserved before the lock is released: the
            # auto-launch timer and the route cannot both start it
            self.processes[wid] = {"pid": None, "launching": True}
        try:
            env = self._worker_env(wid)
            # a malformed continuous-batching knob fails this launch,
            # naming it, not the worker's first admission
            if any(env.get(k) for k in (
                    C.CB_ENV, C.CB_PARK_ENV, C.CB_SLOTS_ENV,
                    C.CB_PARK_MAX_ENV, C.CB_PARK_HBM_FRACTION_ENV)):
                from comfyui_distributed_tpu_torch.workflow.batch_executor \
                    import validate_cb_env
                validate_cb_env(env)
                if env.get(C.CB_PARK_ENV):
                    log(f"worker {wid}: continuous batching with latent "
                        f"paging ({C.CB_PARK_ENV}={env[C.CB_PARK_ENV]}, "
                        f"max parked="
                        f"{env.get(C.CB_PARK_MAX_ENV) or C.CB_PARK_MAX_DEFAULT})")
            cmd = self.build_launch_command(worker)
            if stop_on_master_exit:
                cmd = [proc.get_python_executable(), "-m",
                       "comfyui_distributed_tpu_torch.runtime.monitor",
                       "--master-pid", str(os.getpid()), "--"] + cmd
            log_path = self._log_file(worker.get("name", wid))
            with open(log_path, "a", encoding="utf-8") as logf:
                logf.write(f"\n=== session "
                           f"{datetime.datetime.now().isoformat()} "
                           f"cmd={' '.join(cmd)} ===\n")
                logf.flush()
                # the child keeps its own copy of the descriptor
                p = proc.popen_detached(cmd, env=env,
                                        stdout=logf, stderr=logf)
        except BaseException:
            with self._lock:   # give the reservation back
                self.processes.pop(wid, None)
            raise
        entry = {
            "pid": p.pid,
            "process": p,
            "log_file": log_path,
            "started_at": datetime.datetime.now().isoformat(),
            "config": {k: v for k, v in worker.items() if k != "process"},
            "launching": True,
        }
        with self._lock:
            stopped = wid not in self.processes
            if not stopped:
                self.processes[wid] = entry
        if stopped:
            # stop_worker took the reservation while the process started:
            # the stop stands, and the new process goes
            proc.kill_process_tree(p.pid)
            p.poll()
            raise RuntimeError(f"worker {wid} stopped during launch")
        self.save_processes()
        log(f"launched worker {wid} (pid {p.pid}, port {worker['port']}, "
            f"log {log_path})")
        return {k: v for k, v in entry.items() if k != "process"}

    # --- stop ----------------------------------------------------------------

    def stop_worker(self, worker_id: str) -> bool:
        """Kill a managed worker's process tree; False when ``worker_id``
        is not managed.  Raises (and keeps the worker managed) when the
        tree cannot be listed or a process of it outlives the kill."""
        wid = str(worker_id)
        with self._lock:
            entry = self.processes.pop(wid, None)
        if entry is None:
            return False
        pid = entry.get("pid")
        try:
            ok, branch = proc.kill_process_tree(pid) if pid \
                else (True, "gone")
            if not ok:
                raise RuntimeError(f"worker {wid}: a process of pid {pid}'s "
                                   "tree outlived its kill")
        except (OSError, RuntimeError):
            with self._lock:
                self.processes.setdefault(wid, entry)
            raise
        if entry.get("process") is not None:
            entry["process"].poll()   # reap our own child
        self.save_processes()
        log(f"stopped worker {wid} (pid {pid}, kill branch {branch})")
        return True

    def clear_launching(self, worker_id: str) -> None:
        with self._lock:
            if str(worker_id) in self.processes:
                self.processes[str(worker_id)]["launching"] = False

    def get_managed_workers(self) -> Dict[str, Dict[str, Any]]:
        """Each managed worker's entry with its liveness."""
        with self._lock:
            items = list(self.processes.items())
        return {wid: {"pid": entry.get("pid"),
                      "alive": proc.is_process_alive(entry.get("pid")),
                      "launching": entry.get("launching", False),
                      "started_at": entry.get("started_at"),
                      "log_file": entry.get("log_file"),
                      "config": entry.get("config", {})}
                for wid, entry in items}

    def cleanup_all(self) -> None:
        """Stop every managed worker."""
        with self._lock:
            wids = list(self.processes)
        for wid in wids:
            self.stop_worker(wid)

    # --- persistence ---------------------------------------------------------

    def load_processes(self) -> None:
        managed = cfg_mod.load_config(self.config_path).get(
            "managed_processes", {}) or {}
        revived = purged = 0
        with self._lock:
            for wid, entry in managed.items():
                if proc.is_process_alive(entry.get("pid")):
                    self.processes[str(wid)] = dict(entry)
                    revived += 1
                else:
                    purged += 1
        if revived or purged:
            log(f"managed workers: revived {revived}, purged {purged} stale")
        if purged:
            self.save_processes()

    def save_processes(self) -> None:
        with self._lock:
            snapshot = {wid: {k: v for k, v in entry.items()
                              if k != "process"}
                        for wid, entry in self.processes.items()}

        def mutate(cfg):
            cfg["managed_processes"] = snapshot

        # read-modify-write under the config's lock: a whole-file write
        # would drop worker edits made meanwhile through the config routes
        cfg_mod.mutate_config(mutate, self.config_path)

    # --- log -----------------------------------------------------------------

    def tail_log(self, worker_id: str,
                 max_bytes: int = C.LOG_TAIL_BYTES) -> str:
        """The last ``max_bytes`` of the worker's log; FileNotFoundError
        when it has none."""
        with self._lock:
            entry = self.processes.get(str(worker_id))
        path = entry.get("log_file") if entry else None
        if not path or not os.path.exists(path):
            raise FileNotFoundError(f"no log for worker {worker_id}")
        size = os.path.getsize(path)
        with open(path, "rb") as f:
            f.seek(max(0, size - max_bytes))
            return f.read().decode("utf-8", errors="replace")


def auto_launch_workers(manager: WorkerProcessManager,
                        delay: float = C.WORKER_STARTUP_DELAY
                        ) -> threading.Timer:
    """After ``delay`` seconds, launch every enabled local worker when the
    config's ``settings.auto_launch_workers`` is true; remote workers and
    running ones are skipped.  Returns the timer (a caller may cancel
    it)."""

    def run():
        cfg = cfg_mod.load_config(manager.config_path)
        if not cfg["settings"].get("auto_launch_workers"):
            return
        for w in cfg_mod.enabled_workers(cfg):
            if w.get("host") not in (None, "", "localhost", "127.0.0.1"):
                continue
            wid = str(w["id"])
            with manager._lock:
                entry = manager.processes.get(wid)
            if entry and proc.is_process_alive(entry.get("pid")):
                continue
            try:
                manager.launch_worker(
                    w, stop_on_master_exit=cfg["settings"].get(
                        "stop_workers_on_master_exit", True))
            except RuntimeError as e:
                log(f"auto-launch {wid}: {e}")

    t = threading.Timer(delay, run)
    t.daemon = True
    t.start()
    return t


def install_exit_hooks(manager: WorkerProcessManager) -> None:
    """Stop the managed workers when the master exits (atexit, INT, TERM,
    HUP), unless ``settings.stop_workers_on_master_exit`` is false.  A
    signal the process ignores (HUP under nohup) stays ignored; the main
    thread must call this."""

    def cleanup(*_a):
        cfg = cfg_mod.load_config(manager.config_path)
        if cfg["settings"].get("stop_workers_on_master_exit", True):
            manager.cleanup_all()

    atexit.register(cleanup)
    for sig in (signal.SIGINT, signal.SIGTERM, signal.SIGHUP):
        prev = signal.getsignal(sig)
        if prev == signal.SIG_IGN:
            continue

        def handler(signum, frame, _prev=prev):
            cleanup()
            if callable(_prev):
                _prev(signum, frame)
            else:   # SIG_DFL: end as the default action would
                sys.exit(128 + signum)

        signal.signal(sig, handler)
