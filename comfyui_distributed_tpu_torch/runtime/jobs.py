"""Per-job result queues of the HTTP fan-out: the counterpart of
``JobStore`` in ``comfyui_distributed_tpu/runtime/jobs.py`` on
thread-safe queues (the port's server runs handler threads and one
execution thread, not an event loop).

A master prepares a job's queue before it dispatches the job, so a
worker's result can never arrive first; a result for a job with no queue
is refused (``put_*`` returns False and the route answers 404, so the
sender retries).  Each upload carries an idempotency key
``worker_id:unit:attempt``; a key seen before for the job is acknowledged
but not queued again (counted as ``idem_dropped`` in
``utils.trace.GLOBAL_COUNTERS``), so a retried POST counts once.  The
keys go with the queue.  With the write-ahead log attached
(``runtime/durable.py``) a new key is logged before the upload is
answered, and a restarted master takes the replayed keys back
(``attach_wal``), so an upload answered before a crash still counts
once after it.  A sharded master namespaces its keys by its shard id
(``set_scope``), and the keys of a dead peer's shard it absorbs keep
that shard's namespace (``merge_idem(..., scope=)``), so a takeover
never mistakes another master's acknowledged unit for its own.  An
unscoped store keys as before.

:class:`ParkedStore` holds the continuous-batching rows parked to the
host (``workflow/batch_executor.py``).
"""

from __future__ import annotations

import queue
import threading
from typing import Any, Callable, Dict, List, Optional, Set

from comfyui_distributed_tpu_torch.utils.log import debug_log
from comfyui_distributed_tpu_torch.utils.trace import GLOBAL_COUNTERS


class JobStore:
    """Image-job and tile-job queues under one lock."""

    def __init__(self) -> None:
        self._jobs: Dict[str, queue.Queue] = {}        # guarded-by: _lock
        self._tile_jobs: Dict[str, queue.Queue] = {}   # guarded-by: _lock
        self._seen: Dict[str, Set[str]] = {}           # guarded-by: _lock
        self._tile_seen: Dict[str, Set[str]] = {}      # guarded-by: _lock
        self._lock = threading.Lock()
        self._wal = None                               # guarded-by: _lock
        # the owning shard's id ("" unsharded: keys unprefixed) and, for
        # an absorbed shard's jobs, that shard's id
        self._scope = ""                               # guarded-by: _lock
        self._job_scope: Dict[str, str] = {}           # guarded-by: _lock

    def set_scope(self, scope: Optional[str]) -> None:
        with self._lock:
            self._scope = str(scope or "")

    def _scoped(self, job_id: str, idem_key: str) -> str:
        """The key as kept: prefixed by the job's shard when sharded.
        The caller holds the lock."""
        s = self._job_scope.get(str(job_id), self._scope)
        return f"{s}|{idem_key}" if s else str(idem_key)

    def attach_wal(self, wal, recovered_idem: Optional[Dict[str, Any]]
                   = None) -> None:
        """Log new keys from now on, and take back the replayed ones
        (``{"image": {job: [keys]}, "tile": {...}}``)."""
        with self._lock:
            self._wal = wal
        self.merge_idem(recovered_idem)

    def merge_idem(self, recovered_idem: Optional[Dict[str, Any]],
                   scope: Optional[str] = None) -> None:
        """Add replayed keys: an upload answered before a crash and
        retried after it is answered again, not queued.  ``scope`` names
        the shard they came from (an absorbed peer's); by default this
        store's own."""
        idem = recovered_idem or {}
        with self._lock:
            scope = self._scope if scope is None else str(scope)
            pfx = f"{scope}|" if scope else ""
            for seen, kind in ((self._seen, "image"),
                               (self._tile_seen, "tile")):
                for job, keys in (idem.get(kind) or {}).items():
                    if scope != self._scope:
                        self._job_scope[str(job)] = scope
                    seen.setdefault(str(job), set()).update(
                        f"{pfx}{k}" for k in keys)

    def _log_idem(self, scope: str, job_id: str, idem_key: str) -> None:
        """Log an accepted key (fsync'd per ``DTPU_WAL_SYNC``) before the
        upload is answered.  A fenced or crashed log raises, so a deposed
        master's handlers stop answering 200."""
        with self._lock:
            wal = self._wal
        if wal is None:
            return
        from comfyui_distributed_tpu_torch.runtime import durable
        try:
            wal.append("idem", scope=scope, job=str(job_id),
                       key=str(idem_key))
        except (durable.FencedError, durable.WalCrashedError):
            raise
        except Exception as e:  # noqa: BLE001 - durability is best effort
            debug_log(f"jobstore: idempotency key not logged: {e}")

    def _put(self, scope: str, jobs: Dict[str, queue.Queue],
             seen: Dict[str, Set[str]], job_id: str, item: Dict[str, Any],
             require_existing: bool, idem_key: Optional[str]) -> bool:
        """Queue ``item`` unless its key was seen; the key is logged
        outside the lock, before the item is queued and answered."""
        with self._lock:
            q = jobs.get(job_id)
            if q is None:
                if require_existing:
                    return False
                q = jobs[job_id] = queue.Queue()
            if idem_key:
                keys = seen.setdefault(job_id, set())
                scoped = self._scoped(job_id, idem_key)
                if scoped in keys:
                    GLOBAL_COUNTERS.bump("idem_dropped")
                    return True
                keys.add(scoped)
        if idem_key:
            self._log_idem(scope, job_id, idem_key)
        q.put(item)
        return True

    # --- image jobs ----------------------------------------------------------

    def prepare_job(self, job_id: str) -> None:
        with self._lock:
            self._jobs.setdefault(job_id, queue.Queue())

    def get_queue(self, job_id: str) -> queue.Queue:
        with self._lock:
            return self._jobs.setdefault(job_id, queue.Queue())

    def has_job(self, job_id: str) -> bool:
        with self._lock:
            return job_id in self._jobs

    def put_result(self, job_id: str, item: Dict[str, Any],
                   require_existing: bool = True,
                   idem_key: Optional[str] = None) -> bool:
        """Queue a worker's image; False for an unknown job."""
        return self._put("image", self._jobs, self._seen, job_id, item,
                         require_existing, idem_key)

    def remove_job(self, job_id: str) -> None:
        with self._lock:
            self._jobs.pop(job_id, None)
            self._seen.pop(job_id, None)

    # --- tile jobs -----------------------------------------------------------

    def prepare_tile_job(self, job_id: str) -> None:
        with self._lock:
            self._tile_jobs.setdefault(job_id, queue.Queue())

    def get_tile_queue(self, job_id: str) -> queue.Queue:
        with self._lock:
            return self._tile_jobs.setdefault(job_id, queue.Queue())

    def has_tile_job(self, job_id: str) -> bool:
        with self._lock:
            return job_id in self._tile_jobs

    def put_tile(self, job_id: str, item: Dict[str, Any],
                 require_existing: bool = True,
                 idem_key: Optional[str] = None) -> bool:
        """Queue a worker's tile; False for an unknown job, so a late
        tile cannot bring back a queue the master has dropped."""
        return self._put("tile", self._tile_jobs, self._tile_seen, job_id,
                         item, require_existing, idem_key)

    def remove_tile_queue(self, job_id: str) -> None:
        with self._lock:
            self._tile_jobs.pop(job_id, None)
            self._tile_seen.pop(job_id, None)

    def snapshot(self) -> Dict[str, Any]:
        with self._lock:
            return {"image_jobs": sorted(self._jobs),
                    "tile_jobs": sorted(self._tile_jobs)}


class ParkedStore:
    """The continuous-batching rows parked to the host, the counterpart
    of the JAX package's ``ParkedStore``.  A record is a started prompt
    whose slot a higher class took: its latent rows, its sigma index and
    its admit time, the whole slot, so its resume continues it exactly
    (its keys are rebuilt from its seed).  ``DTPU_CB_SLOTS`` stays the
    device's cap; admission may count ``room()`` more started prompts.

    The store reads only ``pid`` (the double-park guard, the client-gone
    lookup), ``sig`` (a row resumes into a bucket of its signature),
    ``rank`` (its class: highest resumes first) and ``t_park`` (FIFO in
    a class).  Its own lock: the driver thread parks and resumes, the
    metrics routes read ``count()``."""

    def __init__(self, capacity: int) -> None:
        self._capacity = max(0, int(capacity))
        self._rows: List[Any] = []            # guarded-by: self._lock
        self._pids: Set[str] = set()          # guarded-by: self._lock
        self._lock = threading.Lock()

    def park(self, records: List[Any]) -> None:
        """Register parked rows; ``ValueError`` past the capacity (check
        :meth:`room` first) or for a prompt parked already (its slot
        would fork in two), and then nothing is registered."""
        with self._lock:
            if len(self._rows) + len(records) > self._capacity:
                raise ValueError(
                    f"parked-store overflow: {len(self._rows)} resident + "
                    f"{len(records)} new > capacity {self._capacity}")
            for rec in records:
                if str(rec.pid) in self._pids:
                    raise ValueError(f"double-park of prompt {rec.pid}")
            for rec in records:
                self._pids.add(str(rec.pid))
                self._rows.append(rec)

    def _take(self, picked: List[Any]) -> List[Any]:
        for rec in picked:
            self._rows.remove(rec)
            self._pids.discard(str(rec.pid))
        return picked

    def pop_for(self, sig: Any, k: int) -> List[Any]:
        """Up to ``k`` records of signature ``sig``: highest class
        first, then the longest parked."""
        if k <= 0:
            return []
        with self._lock:
            cands = sorted((r for r in self._rows if r.sig == sig),
                           key=lambda r: (-int(r.rank), float(r.t_park)))
            return self._take(cands[:k])

    def pop_abandoned(self, is_abandoned: Callable[[str], bool]
                      ) -> List[Any]:
        """Take out the records whose client left: freed, never
        resumed."""
        with self._lock:
            return self._take([r for r in self._rows
                               if is_abandoned(str(r.pid))])

    def drain_all(self) -> List[Any]:
        with self._lock:
            rows, self._rows = self._rows, []
            self._pids.clear()
            return rows

    def has(self, pid: str) -> bool:
        with self._lock:
            return str(pid) in self._pids

    def count(self) -> int:
        with self._lock:
            return len(self._rows)

    def room(self) -> int:
        with self._lock:
            return max(0, self._capacity - len(self._rows))

    def sigs(self) -> List[Any]:
        """The signatures of the parked rows, in resume order."""
        with self._lock:
            out: List[Any] = []
            for r in sorted(self._rows,
                            key=lambda r: (-int(r.rank), float(r.t_park))):
                if r.sig not in out:
                    out.append(r.sig)
            return out
