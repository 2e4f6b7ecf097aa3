"""The fan-out's fault-tolerant control plane: the counterpart of
``comfyui_distributed_tpu/runtime/cluster.py``, on threads.

- :class:`ClusterRegistry`: worker liveness from leases.  Workers are
  seeded from the config or register over HTTP and renew by heartbeat;
  the health poller (``runtime/health.py``) and the data-plane POSTs
  feed it too.  The state, ``unknown -> healthy -> suspect -> dead``, is
  computed when it is read, so a stalled poller cannot hold a dead
  worker healthy.
- :class:`WorkLedger`: which participant owns which tile index or seed
  slice of a job, exactly-once check-in (a retried POST or a hedge's
  loser is dropped at the blend), reassignment, a moving per-unit
  latency estimate that arms hedging, and a redispatch callback per job
  that the orchestrator registers so lost units go to a healthy worker.
- :class:`HeartbeatSender`: a worker's lease renewal at its master.

Each transition (suspect, dead, reassign, hedge win or loss, a failed
redispatch) bumps a counter of :data:`COUNTERS`, served by
``GET /distributed/cluster`` and ``/distributed/metrics``.

Not ported yet: the write-ahead log and crash recovery (``attach_wal``,
``merge_recovered``, ``load_payloads``, ``take_recovered_lost``), SLO
deadlines (``set_deadline``, ``deadline``), clock skew and resource
feeds, the autoscaler's retiring state, ``MultiHeartbeatSender`` and
``rehome``.  The ledger's jobs are never recovered, so the drains take
the JAX package's "nothing recovered" branch.  ``redispatch`` is a
plain call here (the JAX package's is a coroutine): the port's drains
run on threads.
"""

from __future__ import annotations

import collections
import json
import os
import threading
import time
from typing import Any, Callable, Dict, List, Optional

from comfyui_distributed_tpu_torch.utils import clock as clock_mod
from comfyui_distributed_tpu_torch.utils import constants as C
from comfyui_distributed_tpu_torch.utils.log import log
from comfyui_distributed_tpu_torch.utils.net import post_json

HEALTHY = "healthy"
SUSPECT = "suspect"
DEAD = "dead"
UNKNOWN = "unknown"       # registered but never contacted


class ClusterFaultError(RuntimeError):
    """DTPU_FAULT_POLICY=fail: a participant died mid-job."""


class Counters:
    """Named event counts under one lock."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._counts: Dict[str, int] = collections.Counter()  # guarded-by: _lock

    def bump(self, name: str, n: int = 1) -> None:
        with self._lock:
            self._counts[name] += int(n)

    def get(self, name: str) -> int:
        with self._lock:
            return self._counts.get(name, 0)

    def snapshot(self) -> Dict[str, int]:
        with self._lock:
            return dict(self._counts)


COUNTERS = Counters()


# --- policy and hedge knobs (read per call: tests set the environment) ------

def fault_policy() -> str:
    p = os.environ.get(C.FAULT_POLICY_ENV,
                       C.FAULT_POLICY_DEFAULT).strip().lower()
    if p not in C.FAULT_POLICIES:
        log(f"unknown {C.FAULT_POLICY_ENV}={p!r}; using "
            f"{C.FAULT_POLICY_DEFAULT!r}")
        return C.FAULT_POLICY_DEFAULT
    return p


def hedge_armed() -> bool:
    return os.environ.get(C.HEDGE_ENV, "1").lower() \
        not in ("0", "false", "off")


def _env_float(name: str, default: float) -> float:
    try:
        return float(os.environ.get(name, default))
    except ValueError:
        return default


def hedge_pct() -> float:
    return _env_float(C.HEDGE_PCT_ENV, C.HEDGE_PCT_DEFAULT)


def hedge_factor() -> float:
    return _env_float(C.HEDGE_FACTOR_ENV, C.HEDGE_FACTOR_DEFAULT)


def hedge_min_wait() -> float:
    return _env_float(C.HEDGE_MIN_WAIT_ENV, C.HEDGE_MIN_WAIT_DEFAULT)


def fault_injection(raw: Optional[str] = None) -> Dict[str, Any]:
    """The fault-injection spec (``DTPU_FAULT_INJECT`` or ``raw``): a
    JSON object, else {}."""
    raw = raw if raw is not None else os.environ.get(C.FAULT_INJECT_ENV, "")
    if not raw:
        return {}
    try:
        spec = json.loads(raw)
        return spec if isinstance(spec, dict) else {}
    except ValueError:
        log(f"bad {C.FAULT_INJECT_ENV}={raw!r}; ignoring")
        return {}


# --- worker registry with leases --------------------------------------------

class ClusterRegistry:
    """Lease-based worker liveness, fed by heartbeats, health probes and
    data-plane contact.  A transition is recorded (ring and counter)
    when the state computed at a read or write differs from the last."""

    def __init__(self, lease_s: Optional[float] = None,
                 suspect_probes: Optional[int] = None,
                 clock: Optional[Any] = None):
        self._clock = clock if clock is not None else clock_mod.WALL
        if lease_s is None:
            lease_s = _env_float(C.LEASE_ENV, C.LEASE_DEFAULT)
        if suspect_probes is None:
            try:
                suspect_probes = int(os.environ.get(
                    C.SUSPECT_PROBES_ENV, C.SUSPECT_PROBES_DEFAULT))
            except ValueError:
                suspect_probes = C.SUSPECT_PROBES_DEFAULT
        self.lease_s = max(float(lease_s), 0.05)
        self.suspect_probes = max(int(suspect_probes), 1)
        self._lock = threading.Lock()
        self._workers: Dict[str, Dict[str, Any]] = {}  # guarded-by: _lock
        self._transitions: collections.deque = collections.deque(
            maxlen=C.CLUSTER_TRANSITIONS_KEPT)         # guarded-by: _lock

    # -- writes ---------------------------------------------------------------

    def _record_locked(self, wid: str, info: Optional[Dict[str, Any]],
                       now: float) -> Dict[str, Any]:
        rec = self._workers.get(wid)
        if rec is None:
            rec = self._workers[wid] = {
                "info": dict(info or {}), "registered_at": now,
                "last_seen": None, "failed_probes": 0, "state": UNKNOWN}
        elif info:
            rec["info"].update(info)
        return rec

    def register(self, worker_id: str, info: Optional[Dict[str, Any]] = None,
                 alive: bool = True) -> Dict[str, Any]:
        """Upsert a worker.  ``alive`` (a registration or heartbeat)
        counts as contact and starts or renews the lease; without it
        (config seeding) the worker stays UNKNOWN until its first probe,
        so a configured worker that never started is never healthy."""
        wid = str(worker_id)
        now = self._clock.monotonic()
        with self._lock:
            rec = self._record_locked(wid, info, now)
            if alive:
                rec["last_seen"] = now
                rec["failed_probes"] = 0
            self._refresh_locked(wid, rec, now)
            return {"worker_id": wid, "state": rec["state"],
                    "lease_s": self.lease_s}

    def heartbeat(self, worker_id: str,
                  info: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
        """Lease renewal; an unknown worker is registered (a worker that
        knows only the master's URL joins this way)."""
        return self.register(worker_id, info=info, alive=True)

    def observe_probe(self, worker_id: str, ok: bool,
                      info: Optional[Dict[str, Any]] = None) -> None:
        """A health probe's result: success renews the lease, failure
        advances the suspect count."""
        wid = str(worker_id)
        now = self._clock.monotonic()
        with self._lock:
            rec = self._record_locked(wid, info, now)
            if ok:
                rec["last_seen"] = now
                rec["failed_probes"] = 0
            else:
                rec["failed_probes"] += 1
            self._refresh_locked(wid, rec, now)

    def touch(self, worker_id: str) -> None:
        """Data-plane contact (a tile or image arrived) renews the lease
        of a KNOWN id only: the image path's positional ``worker_N``
        labels must not add phantom workers."""
        wid = str(worker_id)
        now = self._clock.monotonic()
        with self._lock:
            rec = self._workers.get(wid)
            if rec is None:
                return
            rec["last_seen"] = now
            rec["failed_probes"] = 0
            self._refresh_locked(wid, rec, now)

    def seed_from_config(self, workers: List[Dict[str, Any]]) -> None:
        """Pre-register the enabled config workers, not alive."""
        for w in workers or []:
            if not w.get("enabled"):
                continue
            self.register(str(w.get("id")),
                          info={"host": w.get("host") or "127.0.0.1",
                                "port": w.get("port"),
                                "name": w.get("name")},
                          alive=False)

    def forget(self, worker_id: str) -> bool:
        """Drop a worker from the registry."""
        with self._lock:
            return self._workers.pop(str(worker_id), None) is not None

    # -- reads ----------------------------------------------------------------

    def _compute_locked(self, rec: Dict[str, Any], now: float) -> str:
        if rec["last_seen"] is None:
            return UNKNOWN
        if now - rec["last_seen"] > self.lease_s:
            return DEAD
        if rec["failed_probes"] >= self.suspect_probes:
            return SUSPECT
        return HEALTHY

    def _refresh_locked(self, wid: str, rec: Dict[str, Any],
                        now: float) -> str:
        new = self._compute_locked(rec, now)
        old = rec["state"]
        if new != old:
            rec["state"] = new
            self._transitions.append({"worker_id": wid, "from": old,
                                      "to": new, "t": self._clock.time()})
            COUNTERS.bump(f"cluster_{new}_transitions")
            if new in (SUSPECT, DEAD):
                log(f"cluster: worker {wid} {old} -> {new}")
        return new

    def state(self, worker_id: str) -> str:
        """The state now; UNKNOWN for an id never registered."""
        wid = str(worker_id)
        now = self._clock.monotonic()
        with self._lock:
            rec = self._workers.get(wid)
            if rec is None:
                return UNKNOWN
            return self._refresh_locked(wid, rec, now)

    def healthy_ids(self) -> List[str]:
        now = self._clock.monotonic()
        with self._lock:
            return [wid for wid, rec in self._workers.items()
                    if self._refresh_locked(wid, rec, now) == HEALTHY]

    def snapshot(self) -> Dict[str, Any]:
        now = self._clock.monotonic()
        with self._lock:
            workers = {}
            for wid, rec in self._workers.items():
                st = self._refresh_locked(wid, rec, now)
                seen = rec["last_seen"]
                workers[wid] = {
                    "state": st,
                    # the autoscaler's drain flag waits for its slice
                    "retiring": False,
                    "last_seen_age_s": (None if seen is None
                                        else round(now - seen, 3)),
                    "failed_probes": rec["failed_probes"],
                    "lease_remaining_s": (
                        None if seen is None
                        else round(self.lease_s - (now - seen), 3)),
                    **{k: v for k, v in rec["info"].items()
                       if k in ("host", "port", "name", "queue_remaining")},
                }
            return {"lease_s": self.lease_s,
                    "suspect_probes": self.suspect_probes,
                    "workers": workers,
                    "transitions": list(self._transitions)}


# --- per-job work ledger -----------------------------------------------------

class WorkLedger:
    """Which participant owns which unit, with exactly-once check-in.  A
    unit is a tile index (tiled upscale) or a seed slice (the image
    collector, keyed by the slice's config id); an owner is "master" or
    a worker's config id."""

    def __init__(self, clock: Optional[Any] = None) -> None:
        self._clock = clock if clock is not None else clock_mod.WALL
        self._lock = threading.Lock()
        self._jobs: Dict[str, Dict[str, Any]] = {}      # guarded-by: _lock
        self._redispatch: Dict[str, Callable] = {}      # guarded-by: _lock
        self._completed: collections.deque = collections.deque(
            maxlen=C.LEDGER_COMPLETED_KEPT)             # guarded-by: _lock

    # -- lifecycle ------------------------------------------------------------

    def create_job(self, job_id: str, owners: Dict[Any, str],
                   kind: str = "tile") -> None:
        now = self._clock.monotonic()
        units = {u: {"owner": str(o), "state": "pending", "attempts": 1,
                     "hedged": False, "hedge_owner": None, "done_by": None}
                 for u, o in owners.items()}
        with self._lock:
            self._jobs[str(job_id)] = {
                "kind": kind, "created_at": now, "units": units,
                # each owner's last check-in, for the latency estimate
                "owner_last": {}, "latency_ema": None,
                "reassigned": 0, "hedged": 0}

    def has_job(self, job_id: str) -> bool:
        with self._lock:
            return str(job_id) in self._jobs

    def finish_job(self, job_id: str) -> Optional[Dict[str, Any]]:
        """Seal a job: its live state goes, a summary stays in a ring
        (``GET /distributed/cluster``)."""
        jid = str(job_id)
        with self._lock:
            job = self._jobs.pop(jid, None)
            self._redispatch.pop(jid, None)
            if job is None:
                return None
            units = job["units"]
            summary = {
                "job_id": jid, "kind": job["kind"],
                "total_units": len(units),
                "done_units": sum(1 for u in units.values()
                                  if u["state"] == "done"),
                "pending_units": sorted(str(u) for u, rec in units.items()
                                        if rec["state"] != "done"),
                "reassigned_units": job["reassigned"],
                "hedged_units": job["hedged"],
                # crash recovery waits for the write-ahead log
                "recovered": False, "preloaded_units": 0,
                "duration_s": round(self._clock.monotonic()
                                    - job["created_at"], 4),
                "finished_at": self._clock.time(),
            }
            self._completed.append(summary)
        return summary

    # -- check-in (exactly-once) ----------------------------------------------

    def check_in(self, job_id: str, unit: Any, worker_id: str) -> bool:
        """Record a unit's completion: True once a unit, for the first
        completion; a retried POST or a hedge's loser gets False and is
        dropped.  A job or unit the ledger never planned gets True (the
        ledger is opt-in)."""
        now = self._clock.monotonic()
        with self._lock:
            job = self._jobs.get(str(job_id))
            rec = None if job is None else job["units"].get(unit)
            if rec is None:
                return True
            if rec["state"] == "done":
                COUNTERS.bump("cluster_duplicate_checkins")
                return False
            rec["state"] = "done"
            rec["done_by"] = str(worker_id)
            if rec["hedge_owner"]:
                # attributed only where the hedge has its own identity
                # (the master's local refine); a redispatched hedge
                # posts as the owner and is not counted
                won = str(worker_id) == rec["hedge_owner"]
                COUNTERS.bump("cluster_hedge_wins" if won
                              else "cluster_hedge_losses")
            # EMA of each owner's interval between check-ins (the first
            # from the job's creation)
            last = job["owner_last"].get(str(worker_id), job["created_at"])
            sample = max(now - last, 1e-6)
            ema = job["latency_ema"]
            job["latency_ema"] = sample if ema is None \
                else 0.7 * ema + 0.3 * sample
            job["owner_last"][str(worker_id)] = now
            return True

    # -- queries --------------------------------------------------------------

    def pending(self, job_id: str, owner: Optional[str] = None) -> List[Any]:
        with self._lock:
            job = self._jobs.get(str(job_id))
            if job is None:
                return []
            return sorted((u for u, rec in job["units"].items()
                           if rec["state"] != "done"
                           and (owner is None or rec["owner"] == str(owner))),
                          key=str)

    def owners_of_pending(self, job_id: str,
                          skip_hedged: bool = False) -> Dict[Any, str]:
        """Pending units and their owners; ``skip_hedged`` leaves out
        units a hedge is already racing."""
        with self._lock:
            job = self._jobs.get(str(job_id))
            if job is None:
                return {}
            return {u: rec["owner"] for u, rec in job["units"].items()
                    if rec["state"] != "done"
                    and not (skip_hedged and rec["hedged"])}

    def progress(self, job_id: str) -> tuple:
        with self._lock:
            job = self._jobs.get(str(job_id))
            if job is None:
                return (0, 0)
            units = job["units"]
            return (sum(1 for u in units.values() if u["state"] == "done"),
                    len(units))

    def latency_estimate(self, job_id: str) -> Optional[float]:
        with self._lock:
            job = self._jobs.get(str(job_id))
            return None if job is None else job["latency_ema"]

    def attempts(self, job_id: str, unit: Any) -> int:
        with self._lock:
            job = self._jobs.get(str(job_id))
            rec = None if job is None else job["units"].get(unit)
            return 0 if rec is None else rec["attempts"]

    # -- recovery -------------------------------------------------------------

    def reassign(self, job_id: str, units: List[Any],
                 new_owner: str) -> List[Any]:
        """Move still-pending units to ``new_owner``; returns the units
        moved (one done in the meantime stays)."""
        moved = []
        with self._lock:
            job = self._jobs.get(str(job_id))
            if job is None:
                return moved
            for u in units:
                rec = job["units"].get(u)
                if rec is None or rec["state"] == "done":
                    continue
                rec["owner"] = str(new_owner)
                rec["attempts"] += 1
                moved.append(u)
            job["reassigned"] += len(moved)
        if moved:
            COUNTERS.bump("cluster_reassigned_units", len(moved))
        return moved

    def mark_hedged(self, job_id: str, units: List[Any],
                    hedge_owner: Optional[str] = None) -> List[Any]:
        """Record a speculative re-issue; the owner keeps the unit and
        the first completion wins.  ``hedge_owner`` names the hedge's
        runner for the win/loss count (None: a redispatch, which posts
        as the owner)."""
        hedged = []
        with self._lock:
            job = self._jobs.get(str(job_id))
            if job is None:
                return hedged
            for u in units:
                rec = job["units"].get(u)
                if rec is None or rec["state"] == "done" or rec["hedged"]:
                    continue
                rec["hedged"] = True
                rec["hedge_owner"] = (None if hedge_owner is None
                                      else str(hedge_owner))
                rec["attempts"] += 1
                hedged.append(u)
            job["hedged"] += len(hedged)
        if hedged:
            COUNTERS.bump("cluster_hedges", len(hedged))
        return hedged

    def is_hedged(self, job_id: str, unit: Any) -> bool:
        with self._lock:
            job = self._jobs.get(str(job_id))
            rec = None if job is None else job["units"].get(unit)
            return bool(rec and rec["hedged"])

    def unmark_hedged(self, job_id: str, units: List[Any]) -> None:
        """Roll back a hedge that never launched, so the unit stays
        eligible for dead-owner recovery and later hedges."""
        with self._lock:
            job = self._jobs.get(str(job_id))
            if job is None:
                return
            n = 0
            for u in units:
                rec = job["units"].get(u)
                if rec is not None and rec["hedged"] \
                        and rec["state"] != "done":
                    rec["hedged"] = False
                    rec["hedge_owner"] = None
                    rec["attempts"] = max(rec["attempts"] - 1, 1)
                    n += 1
            job["hedged"] -= n

    def overdue_units(self, job_id: str, factor: Optional[float] = None,
                      min_progress_pct: Optional[float] = None,
                      min_wait_s: Optional[float] = None) -> Dict[Any, str]:
        """Hedge candidates: pending, not hedged, whose owner has been
        silent longer than ``max(factor x the latency estimate,
        min_wait_s)``, once the job is ``min_progress_pct`` % done (hedge
        the last stragglers, not the whole job)."""
        factor = hedge_factor() if factor is None else factor
        min_pct = hedge_pct() if min_progress_pct is None \
            else min_progress_pct
        min_wait = hedge_min_wait() if min_wait_s is None else min_wait_s
        now = self._clock.monotonic()
        with self._lock:
            job = self._jobs.get(str(job_id))
            if job is None or job["latency_ema"] is None \
                    or not job["units"]:
                return {}
            units = job["units"]
            threshold = max(factor * job["latency_ema"], min_wait)
            done = sum(1 for u in units.values() if u["state"] == "done")
            if 100.0 * done / len(units) < min_pct:
                return {}
            out = {}
            for u, rec in units.items():
                if rec["state"] == "done" or rec["hedged"]:
                    continue
                last = job["owner_last"].get(rec["owner"],
                                             job["created_at"])
                if now - last > threshold:
                    out[u] = rec["owner"]
            return out

    # -- redispatch (registered by the orchestrator) --------------------------

    def set_redispatcher(self, job_id: str, fn: Callable) -> None:
        """``fn(units, lost_owner) -> bool`` re-issues units to a
        healthy worker.  A bounded map: ``finish_job`` pops an entry,
        and a run that fails before its collector would leak it."""
        with self._lock:
            self._redispatch[str(job_id)] = fn
            while len(self._redispatch) > 512:
                self._redispatch.pop(next(iter(self._redispatch)))

    def has_redispatcher(self, job_id: str) -> bool:
        with self._lock:
            return str(job_id) in self._redispatch

    def redispatch(self, job_id: str, units: List[Any],
                   lost_owner: str) -> bool:
        """Run the job's redispatcher; False without one, when it finds
        no target, or when it raises (logged and counted)."""
        with self._lock:
            fn = self._redispatch.get(str(job_id))
        if fn is None:
            return False
        try:
            ok = bool(fn(units, lost_owner))
        except Exception as e:  # noqa: BLE001 - recovery must not crash
            log(f"ledger: redispatch for {job_id} failed: "
                f"{type(e).__name__}: {e}")
            COUNTERS.bump("cluster_redispatch_failures")
            return False
        COUNTERS.bump("cluster_redispatches" if ok
                      else "cluster_redispatch_failures")
        return ok

    # -- introspection --------------------------------------------------------

    def snapshot(self) -> Dict[str, Any]:
        now = self._clock.monotonic()
        with self._lock:
            active = {}
            for jid, job in self._jobs.items():
                units = job["units"]
                ema = job["latency_ema"]
                active[jid] = {
                    "kind": job["kind"],
                    "total_units": len(units),
                    "done_units": sum(1 for u in units.values()
                                      if u["state"] == "done"),
                    # SLO deadlines wait for their slice
                    "slo_deadline_remaining_s": None,
                    "reassigned_units": job["reassigned"],
                    "hedged_units": job["hedged"],
                    "latency_estimate_s": (None if ema is None
                                           else round(ema, 4)),
                    "age_s": round(now - job["created_at"], 3),
                }
            return {"active_jobs": active,
                    "completed_jobs": list(self._completed)}


# --- worker-side heartbeat ---------------------------------------------------

class HeartbeatSender:
    """A worker's daemon thread renewing its lease at the master
    (``POST /distributed/heartbeat``) every lease / 3.  Best-effort: a
    master that is down is tried again at the next beat."""

    def __init__(self, master_url: str, worker_id: str,
                 interval: Optional[float] = None,
                 port: Optional[int] = None):
        self.master_url = master_url.rstrip("/")
        self.worker_id = str(worker_id)
        self.port = port
        if interval is None:
            lease = _env_float(C.LEASE_ENV, C.LEASE_DEFAULT)
            interval = max(lease / C.HEARTBEAT_FRACTION, 0.05)
        self.interval = interval
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.beats_sent = 0

    def beat_once(self, timeout: float = 3.0) -> bool:
        payload: Dict[str, Any] = {"worker_id": self.worker_id}
        if self.port:
            payload["port"] = self.port
        payload["sent_at"] = time.time()
        try:
            post_json(f"{self.master_url}/distributed/heartbeat", payload,
                      timeout=timeout)
        except Exception:  # noqa: BLE001 - the next beat tries again
            return False
        self.beats_sent += 1
        return True

    def start(self) -> None:
        if self._thread is not None:
            return
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="dtpu-heartbeat")
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()

    def _run(self) -> None:
        while not self._stop.wait(self.interval):
            self.beat_once()


def maybe_start_heartbeat(port: Optional[int] = None
                          ) -> Optional[HeartbeatSender]:
    """Start the worker's heartbeat when ``DTPU_MASTER_URL`` and
    ``DTPU_WORKER_ID`` are set."""
    master = os.environ.get(C.MASTER_URL_ENV)
    wid = os.environ.get(C.WORKER_ID_ENV)
    if not wid or not master:
        return None
    hb = HeartbeatSender(master, wid, port=port)
    hb.start()
    log(f"heartbeat: renewing lease for {wid!r} at {master} every "
        f"{hb.interval:.1f}s")
    return hb
