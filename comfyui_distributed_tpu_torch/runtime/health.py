"""The master's worker health poller: the counterpart of
``probe_worker`` and ``HealthPoller`` in
``comfyui_distributed_tpu/runtime/health.py``.

A daemon thread probes every enabled worker's ``GET /prompt`` each
``interval`` seconds; each result (online, processing or offline) feeds
the registry's lease state machine (``ClusterRegistry.observe_probe``),
the first successful contact with a managed worker clears its
``launching`` flag (``runtime/manager.py``), and the last round is kept
for ``GET /distributed/workers_status`` (:meth:`HealthPoller.snapshot`).
"""

from __future__ import annotations

import http.client
import threading
import time
from typing import Any, Dict, List, Optional

from comfyui_distributed_tpu_torch.utils import config as cfg_mod
from comfyui_distributed_tpu_torch.utils.constants import WORKER_CHECK_INTERVAL
from comfyui_distributed_tpu_torch.utils.log import log
from comfyui_distributed_tpu_torch.utils.net import get_json


def probe_worker(worker: Dict[str, Any], timeout: float = 2.0
                 ) -> Dict[str, Any]:
    """One status probe: offline on any error, processing while the
    worker's ``queue_remaining`` is above 0, else online."""
    host = worker.get("host") or "127.0.0.1"
    try:
        data = get_json(f"http://{host}:{worker['port']}/prompt",
                        timeout=timeout)
        remaining = int(data.get("exec_info", {}).get("queue_remaining", 0))
        return {"status": "processing" if remaining > 0 else "online",
                "queue_remaining": remaining, "last_seen": time.time()}
    except (OSError, ValueError, http.client.HTTPException):
        return {"status": "offline", "queue_remaining": None,
                "last_seen": None}


class HealthPoller:
    """Daemon polling thread and the last round's statuses."""

    def __init__(self, config_path: Optional[str] = None, manager=None,
                 interval: float = WORKER_CHECK_INTERVAL,
                 registry=None):
        self.config_path = config_path
        self.manager = manager
        self.registry = registry
        self.interval = interval
        self._status: Dict[str, Dict[str, Any]] = {}   # guarded-by: _lock
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def start(self) -> None:
        if self._thread is not None:
            return
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="dtpu-health")
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()

    def _run(self) -> None:
        while not self._stop.wait(self.interval):
            try:
                self.poll_once()
            except Exception as e:  # noqa: BLE001 - the poller survives
                log(f"health poll error: {e}")

    def poll_once(self) -> Dict[str, Dict[str, Any]]:
        """Probe every configured worker once; worker id -> status."""
        cfg = cfg_mod.load_config(self.config_path)
        workers: List[Dict[str, Any]] = cfg.get("workers", [])
        snapshot: Dict[str, Dict[str, Any]] = {}
        for w in workers:
            wid = str(w.get("id"))
            st = probe_worker(w) if w.get("enabled") else {
                "status": "disabled", "queue_remaining": None,
                "last_seen": None}
            st["enabled"] = bool(w.get("enabled"))
            snapshot[wid] = st
            if self.registry is not None and w.get("enabled"):
                self.registry.observe_probe(
                    wid, st["status"] in ("online", "processing"),
                    info={"host": w.get("host") or "127.0.0.1",
                          "port": w.get("port"), "name": w.get("name"),
                          "queue_remaining": st.get("queue_remaining")})
            if st["status"] in ("online", "processing") \
                    and self.manager is not None:
                self.manager.clear_launching(wid)
        with self._lock:
            self._status = snapshot
        return snapshot

    def snapshot(self) -> Dict[str, Dict[str, Any]]:
        """The last round: worker id -> status, as ``poll_once``
        returned it."""
        with self._lock:
            return {k: dict(v) for k, v in self._status.items()}
