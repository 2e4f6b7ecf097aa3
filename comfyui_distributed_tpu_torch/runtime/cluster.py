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
- :class:`HeartbeatSender`: a worker's lease renewal at its master;
  :class:`MultiHeartbeatSender` holds one per master shard
  (``DTPU_MASTER_URLS``), so each master sees the worker's death on its
  own.

Each transition (suspect, dead, reassign, hedge win or loss, a failed
redispatch) bumps an event counter of ``utils.trace.GLOBAL_COUNTERS``,
where the JAX package bumps it, served in ``/distributed/metrics``'
``pipeline.counters`` and ``metrics.prom``'s ``dtpu_events_total``.  The
registry also keeps each worker's last resource snapshot (carried by its
heartbeats, for the federated ``/distributed/cluster/metrics``) and a
min-filtered estimate of its clock's offset from the heartbeats'
``sent_at``, by which the master shifts the worker's shipped spans.

With the write-ahead log (``runtime/durable.py``) attached, every
ownership transition is a record, a winning check-in's payload is
written to the unit store before its record, and ``create_job`` merges
a crash-recovered job, so a resumed job refines only its unfinished
units (``load_payloads``, ``take_recovered_lost``); a worker's
``HeartbeatSender.rehome`` follows a new master.  A sharded master that
absorbs a dead peer's shard adds its replayed jobs with
``merge_recovered``; each such job blends its preloaded units from the
dead shard's unit store.

A request's SLO budget (``slo_s``) stamps its jobs with a deadline
(``set_deadline``); under deadline pressure ``overdue_units`` hedges a
unit silent longer than ``max(DTPU_SLO_HEDGE_FRACTION x the budget
left, 0.25 s)``, with no min-progress gate.

The autoscaler (``runtime/autoscale.py``) retires a worker it spawned
by draining it: ``set_retiring`` keeps its lease but reads it as
``retiring``, so the dispatcher hands it no new work, and ``forget``
drops its record once it drained clean.  A worker's
``HeartbeatSender`` skips its beats while the chaos harness
(``utils/chaos.py``) freezes them.
``redispatch`` is a plain call here (the JAX package's is a coroutine):
the port's drains run on threads.
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
from comfyui_distributed_tpu_torch.utils import trace as trace_mod
from comfyui_distributed_tpu_torch.utils.log import debug_log, log
from comfyui_distributed_tpu_torch.utils.net import post_json

HEALTHY = "healthy"
SUSPECT = "suspect"
DEAD = "dead"
UNKNOWN = "unknown"       # registered but never contacted
RETIRING = "retiring"     # lease fresh, draining: not dispatchable


class ClusterFaultError(RuntimeError):
    """DTPU_FAULT_POLICY=fail: a participant died mid-job."""




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


def slo_hedge_fraction() -> float:
    return _env_float(C.SLO_HEDGE_FRACTION_ENV, C.SLO_HEDGE_FRACTION_DEFAULT)


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
        # ids dropped by forget(): a failed probe does not bring them
        # back (the health poller may have read the config before a
        # retired worker left it); any live contact does
        self._forgotten: set = set()                   # guarded-by: _lock
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
            self._forgotten.discard(wid)
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
            if ok:
                self._forgotten.discard(wid)
            elif wid in self._forgotten:
                return
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

    def update_resources(self, worker_id: str,
                         snapshot: Dict[str, Any]) -> None:
        """Retain a worker's latest resource snapshot: fed by heartbeats
        (which carry one) and by the federation endpoint's pull-through.  Only known ids retain — same phantom
        guard as :meth:`touch`."""
        wid = str(worker_id)
        if not isinstance(snapshot, dict):
            return
        with self._lock:
            rec = self._workers.get(wid)
            if rec is None:
                return
            rec["resources"] = dict(snapshot)
            rec["resources_at"] = self._clock.monotonic()

    def update_skew(self, worker_id: str, offset_s: float) -> None:
        """Feed one clock-offset sample: ``master wall clock
        at receive − worker wall clock at send`` for a heartbeat or
        registration round trip.  Each sample is the true offset plus a
        non-negative uplink delay, so the retained estimate is the
        MINIMUM over a sliding window (NTP's insight: the least-delayed
        sample is the most truthful).  Only known ids retain — same
        phantom guard as :meth:`touch`."""
        wid = str(worker_id)
        try:
            offset = float(offset_s)
        except (TypeError, ValueError):
            return
        with self._lock:
            rec = self._workers.get(wid)
            if rec is None:
                return
            samples = rec.get("skew_samples")
            if samples is None:
                samples = rec["skew_samples"] = collections.deque(
                    maxlen=C.SKEW_SAMPLES_KEPT)
            samples.append(offset)
            rec["skew_s"] = min(samples)
            rec["skew_at"] = self._clock.monotonic()

    def skew(self, worker_id: str) -> float:
        """Current offset estimate to ADD to a worker's wall-clock
        timestamps to land them on this master's clock; 0.0 when no
        estimate exists."""
        with self._lock:
            rec = self._workers.get(str(worker_id))
            if rec is None:
                return 0.0
            return float(rec.get("skew_s") or 0.0)

    def skew_snapshot(self) -> Dict[str, Dict[str, Any]]:
        """Per-worker skew estimates with sample counts and age — the
        /distributed/analysis + prom gauge feed."""
        now = self._clock.monotonic()
        with self._lock:
            out = {}
            for wid, rec in self._workers.items():
                if rec.get("skew_s") is None:
                    continue
                at = rec.get("skew_at")
                out[wid] = {
                    "offset_s": round(float(rec["skew_s"]), 6),
                    "samples": len(rec.get("skew_samples") or ()),
                    "age_s": (None if at is None
                              else round(now - at, 3)),
                }
            return out

    def reset_skew(self) -> int:
        """Drop every skew estimate (POST /distributed/metrics/reset);
        returns how many workers had one."""
        with self._lock:
            n = 0
            for rec in self._workers.values():
                if rec.pop("skew_s", None) is not None:
                    n += 1
                rec.pop("skew_samples", None)
                rec.pop("skew_at", None)
            return n

    def resource_snapshots(self) -> Dict[str, Dict[str, Any]]:
        """Latest retained resource snapshot per worker with its age
        and the worker's address/state — the federation merge input."""
        now = self._clock.monotonic()
        with self._lock:
            out = {}
            for wid, rec in self._workers.items():
                st = self._refresh_locked(wid, rec, now)
                at = rec.get("resources_at")
                out[wid] = {
                    "state": st,
                    "host": rec["info"].get("host"),
                    "port": rec["info"].get("port"),
                    "resources": (dict(rec["resources"])
                                  if rec.get("resources") else None),
                    "age_s": (None if at is None
                              else round(now - at, 3)),
                }
            return out

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

    # -- reads ----------------------------------------------------------------

    def set_retiring(self, worker_id: str, retiring: bool = True) -> bool:
        """The autoscaler's drain flag: a retiring worker keeps its lease
        (its units in flight still check in) but reads as RETIRING, so
        the dispatcher gives it no new work.  False for an unknown id."""
        wid = str(worker_id)
        now = self._clock.monotonic()
        with self._lock:
            rec = self._workers.get(wid)
            if rec is None:
                return False
            rec["retiring"] = bool(retiring)
            self._refresh_locked(wid, rec, now)
            return True

    def forget(self, worker_id: str) -> bool:
        """Drop a worker from the registry (a retired worker's process is
        gone; its record would stay a DEAD tombstone in every snapshot).
        Until a registration or a successful probe, a failed probe of
        the id records nothing."""
        wid = str(worker_id)
        with self._lock:
            self._forgotten.add(wid)
            return self._workers.pop(wid, None) is not None

    def _compute_locked(self, rec: Dict[str, Any], now: float) -> str:
        if rec["last_seen"] is None:
            return UNKNOWN
        if now - rec["last_seen"] > self.lease_s:
            return DEAD
        if rec.get("retiring"):
            return RETIRING
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
            trace_mod.GLOBAL_COUNTERS.bump(f"cluster_{new}_transitions")
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
                    "retiring": bool(rec.get("retiring")),
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
        # the durability plane (runtime/durable.py), None while off: the
        # log, the unit store, and the replayed jobs create_job merges
        self._wal = None                                # guarded-by: _lock
        self._unit_store = None                         # guarded-by: _lock
        self._recovered_jobs: Dict[str, Dict[str, Any]] = {}  # guarded-by: _lock
        # an absorbed shard's job -> that shard's unit store
        self._recovered_stores: Dict[str, Any] = {}     # guarded-by: _lock
        # job -> its SLO deadline on the monotonic clock
        self._deadlines: Dict[str, float] = {}          # guarded-by: _lock

    def attach_wal(self, wal, unit_store,
                   recovered_jobs: Optional[Dict[str, Any]] = None) -> None:
        """Wire the durability plane in.  ``recovered_jobs`` is the
        replayed log's jobs by id; ``create_job`` takes each one."""
        # under the lock: a standby attaches on its watcher thread while
        # a drain may read the recovered state
        with self._lock:
            self._wal = wal
            self._unit_store = unit_store
            if recovered_jobs is not None:
                self._recovered_jobs = dict(recovered_jobs)

    def merge_recovered(self, recovered_jobs: Dict[str, Any],
                        unit_store: Any = None) -> None:
        """Add a dead peer shard's replayed jobs (a sharded master's
        absorb): unlike :meth:`attach_wal` the recovered set is not
        replaced, and each merged job keeps the dead shard's unit store,
        so its preloaded payloads blend from that disk."""
        with self._lock:
            for jid, job in (recovered_jobs or {}).items():
                self._recovered_jobs[str(jid)] = job
                if unit_store is not None:
                    self._recovered_stores[str(jid)] = unit_store

    def _wal_append(self, rtype: str, **fields) -> None:
        """Append an ownership record.  A fenced or crashed log raises
        (a deposed master must stop changing job state); any other
        failure leaves the state in memory only."""
        with self._lock:
            wal = self._wal
        if wal is None:
            return
        from comfyui_distributed_tpu_torch.runtime import durable
        try:
            wal.append(rtype, **fields)
        except (durable.FencedError, durable.WalCrashedError):
            raise
        except Exception as e:  # noqa: BLE001 - durability is best effort
            debug_log(f"ledger: log append {rtype} failed: {e}")

    # -- lifecycle ------------------------------------------------------------

    def create_job(self, job_id: str, owners: Dict[Any, str],
                   kind: str = "tile") -> None:
        """Plan a job.  A job the log recovered keeps the units that were
        done and whose payload survived (``preloaded``: blended from the
        store, never refined again) and its pending units' last owners."""
        jid = str(job_id)
        now = self._clock.monotonic()
        preloaded = []
        with self._lock:
            recovered = self._recovered_jobs.pop(jid, None)
            # an absorbed job reads its preloaded payloads from the dead
            # shard's store, every other job from this master's
            store = self._recovered_stores.pop(jid, None) \
                or self._unit_store
            rec_units = (recovered or {}).get("units", {})
            units = {}
            for u, o in owners.items():
                ru = rec_units.get(str(u))
                if ru is not None and ru.get("done") and ru.get("spilled") \
                        and store is not None and store.has(jid, u):
                    units[u] = {"owner": str(ru.get("by") or o),
                                "state": "done", "attempts": 1,
                                "hedged": False, "hedge_owner": None,
                                "done_by": str(ru.get("by") or o)}
                    preloaded.append(u)
                else:
                    # pending, or done with its payload lost (recomputed:
                    # a unit's seed makes the redo the same); a recovered
                    # reassignment keeps its last owner
                    owner = str(ru["owner"]) if ru is not None \
                        and not ru.get("done") and ru.get("owner") \
                        else str(o)
                    units[u] = {"owner": owner, "state": "pending",
                                "attempts": 1, "hedged": False,
                                "hedge_owner": None, "done_by": None}
            self._jobs[jid] = {
                "kind": kind, "created_at": now, "units": units,
                # each owner's last check-in, for the latency estimate
                "owner_last": {}, "latency_ema": None,
                "reassigned": 0, "hedged": 0,
                "recovered": recovered is not None,
                "recovered_handled": False,
                "preloaded": preloaded, "store": store}
        if preloaded:
            log(f"ledger: job {jid} recovered with {len(preloaded)}/"
                f"{len(owners)} unit(s) already on disk; only the rest is "
                f"refined again")
            trace_mod.GLOBAL_COUNTERS.bump("wal_preloaded_units", len(preloaded))
        self._wal_append("job_create", job=jid, kind=kind,
                         owners={str(u): str(o) for u, o in owners.items()})

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
            self._deadlines.pop(jid, None)
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
                "recovered": job["recovered"],
                "preloaded_units": len(job["preloaded"]),
                "duration_s": round(self._clock.monotonic()
                                    - job["created_at"], 4),
                "finished_at": self._clock.time(),
            }
            self._completed.append(summary)
            store = self._unit_store
        self._wal_append("job_finish", job=jid)
        if store is not None:
            # the finish record is durable: the payloads (and the job's
            # idempotency keys, dropped by the log's state) are not
            # needed for a recovery any more
            store.drop_job(jid)
        if job["store"] is not None and job["store"] is not store:
            # an absorbed job's preloads lived in the dead shard's store
            job["store"].drop_job(jid)
        return summary

    # -- check-in (exactly-once) ----------------------------------------------

    def check_in(self, job_id: str, unit: Any, worker_id: str,
                 payload: Optional[tuple] = None,
                 spent: Optional[Dict[str, float]] = None) -> bool:
        """Record a unit's completion: True once a unit, for the first
        completion; a retried POST or a hedge's loser gets False and is
        dropped.  A job or unit the ledger never planned gets True (the
        ledger is opt-in).

        With the log attached, a winner's ``payload`` (``(arrays,
        meta)`` of host numpy, or a function that makes them, called only
        here) goes to the unit store before the check-in record, so a
        recovered master blends the unit instead of refining it; a crash
        between leaves an orphan file.  ``spent`` gets the seconds of the
        two, ``wal_spill`` and ``wal_append``."""
        status, wal, store = self._check_in_locked(job_id, unit, worker_id)
        if status != "won" or wal is None:
            return status != "dup"
        spilled = False
        t0 = time.perf_counter()
        if payload is not None and store is not None:
            arrays, meta = payload() if callable(payload) else payload
            try:
                store.put(str(job_id), unit, arrays, meta)
                spilled = True
            except OSError as e:
                log(f"ledger: spill of {job_id}/{unit} failed ({e}); the "
                    f"unit is recomputed if the master dies")
        t1 = time.perf_counter()
        self._wal_append("unit_checkin", job=str(job_id), unit=str(unit),
                         by=str(worker_id), spilled=spilled)
        if spent is not None:
            spent["wal_spill"] = spent.get("wal_spill", 0.0) + t1 - t0
            spent["wal_append"] = spent.get("wal_append", 0.0) \
                + time.perf_counter() - t1
        return True

    def _check_in_locked(self, job_id: str, unit: Any,
                         worker_id: str) -> tuple:
        """(``"won"``, ``"dup"`` or ``"untracked"``, the log, the unit
        store), the state change made under the lock."""
        now = self._clock.monotonic()
        with self._lock:
            wal, store = self._wal, self._unit_store
            job = self._jobs.get(str(job_id))
            rec = None if job is None else job["units"].get(unit)
            if rec is None:
                return "untracked", wal, store
            if rec["state"] == "done":
                trace_mod.GLOBAL_COUNTERS.bump("cluster_duplicate_checkins")
                return "dup", wal, store
            rec["state"] = "done"
            rec["done_by"] = str(worker_id)
            if rec["hedge_owner"]:
                # attributed only where the hedge has its own identity
                # (the master's local refine); a redispatched hedge
                # posts as the owner and is not counted
                won = str(worker_id) == rec["hedge_owner"]
                trace_mod.GLOBAL_COUNTERS.bump("cluster_hedge_wins" if won
                              else "cluster_hedge_losses")
            # EMA of each owner's interval between check-ins (the first
            # from the job's creation)
            last = job["owner_last"].get(str(worker_id), job["created_at"])
            sample = max(now - last, 1e-6)
            ema = job["latency_ema"]
            job["latency_ema"] = sample if ema is None \
                else 0.7 * ema + 0.3 * sample
            job["owner_last"][str(worker_id)] = now
            return "won", wal, store

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
            trace_mod.GLOBAL_COUNTERS.bump("cluster_reassigned_units", len(moved))
            self._wal_append("unit_reassign", job=str(job_id),
                             units=[str(u) for u in moved],
                             to=str(new_owner))
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
            trace_mod.GLOBAL_COUNTERS.bump("cluster_hedges", len(hedged))
            self._wal_append("unit_hedge", job=str(job_id),
                             units=[str(u) for u in hedged],
                             by=(None if hedge_owner is None
                                 else str(hedge_owner)))
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

    def set_deadline(self, job_id: str, deadline_monotonic: float) -> None:
        """Stamp a job's SLO deadline (monotonic clock).  The orchestrator
        stamps it at dispatch, before the op creates the job; it re-keys
        :meth:`overdue_units` on the budget left."""
        with self._lock:
            self._deadlines[str(job_id)] = float(deadline_monotonic)
            while len(self._deadlines) > 512:
                self._deadlines.pop(next(iter(self._deadlines)))

    def deadline(self, job_id: str) -> Optional[float]:
        with self._lock:
            return self._deadlines.get(str(job_id))

    def overdue_units(self, job_id: str, factor: Optional[float] = None,
                      min_progress_pct: Optional[float] = None,
                      min_wait_s: Optional[float] = None) -> Dict[Any, str]:
        """Hedge candidates: pending, not hedged, whose owner has been
        silent longer than ``max(factor x the latency estimate,
        min_wait_s)``, once the job is ``min_progress_pct`` % done (hedge
        the last stragglers, not the whole job).

        A job with an SLO deadline (:meth:`set_deadline`) hedges on its
        budget left once that bar is the tighter: ``max(
        DTPU_SLO_HEDGE_FRACTION x budget left, SLO_MIN_WAIT_S)``, with
        the min-progress gate waived, so a job about to miss its deadline
        hedges its first straggler."""
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
            slo_pressed = False
            dl = self._deadlines.get(str(job_id))
            if dl is not None:
                slo_threshold = max(max(dl - now, 0.0) * slo_hedge_fraction(),
                                    C.SLO_MIN_WAIT_S)
                if slo_threshold < threshold:
                    threshold = slo_threshold
                    slo_pressed = True
            done = sum(1 for u in units.values() if u["state"] == "done")
            if not slo_pressed and 100.0 * done / len(units) < min_pct:
                return {}
            out = {}
            for u, rec in units.items():
                if rec["state"] == "done" or rec["hedged"]:
                    continue
                last = job["owner_last"].get(rec["owner"],
                                             job["created_at"])
                if now - last > threshold:
                    out[u] = rec["owner"]
        if out and slo_pressed:
            trace_mod.GLOBAL_COUNTERS.bump("cluster_slo_overdue", len(out))
        return out

    # -- crash recovery (the durability plane) --------------------------------

    def load_payloads(self, job_id: str) -> Dict[Any, tuple]:
        """The stored ``(arrays, meta)`` of this job's preloaded units:
        what the blend takes in place of a refine.  A unit whose file
        became unreadable since ``create_job`` goes back to pending here,
        so the drain recomputes it instead of blending a hole."""
        jid = str(job_id)
        with self._lock:
            job = self._jobs.get(jid)
            preloaded = list(job["preloaded"]) if job else []
            store = (job["store"] if job else None) or self._unit_store
        if not preloaded or store is None:
            return {}
        out: Dict[Any, tuple] = {}
        lost = []
        for u in preloaded:
            payload = store.get(jid, u)
            if payload is None:
                lost.append(u)
            else:
                out[u] = payload
        if lost:
            with self._lock:
                job = self._jobs.get(jid)
                if job is not None:
                    for u in lost:
                        rec = job["units"].get(u)
                        if rec is not None:
                            rec["state"] = "pending"
                            rec["done_by"] = None
                    job["preloaded"] = [u for u in job["preloaded"]
                                        if u not in lost]
            log(f"ledger: {len(lost)} recovered payload(s) of {jid} "
                f"unreadable; recomputing them")
        return out

    def take_recovered_lost(self, job_id: str) -> Dict[str, List[Any]]:
        """Once a recovered job: its pending units whose owner is not the
        master, by owner.  Their dispatches died with the old master, so
        the drains treat them as a dead owner's: redispatched with the
        exact unit lists, else refined on the master."""
        with self._lock:
            job = self._jobs.get(str(job_id))
            if job is None or not job["recovered"] \
                    or job["recovered_handled"]:
                return {}
            job["recovered_handled"] = True
            out: Dict[str, List[Any]] = {}
            for u, rec in job["units"].items():
                if rec["state"] != "done" and rec["owner"] != "master":
                    out.setdefault(rec["owner"], []).append(u)
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
            trace_mod.GLOBAL_COUNTERS.bump("cluster_redispatch_failures")
            return False
        trace_mod.GLOBAL_COUNTERS.bump("cluster_redispatches" if ok
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
                dl = self._deadlines.get(jid)
                active[jid] = {
                    "kind": job["kind"],
                    "total_units": len(units),
                    "done_units": sum(1 for u in units.values()
                                      if u["state"] == "done"),
                    "slo_deadline_remaining_s": (
                        None if dl is None else round(dl - now, 3)),
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
        from comfyui_distributed_tpu_torch.utils import chaos as chaos_mod
        cm = chaos_mod.get_chaos()
        if cm.active and cm.heartbeat_frozen(self.worker_id):
            # a frozen heartbeat ages the lease out while the process
            # lives: the suspect, dead and rehome edge
            debug_log(f"chaos: heartbeat for {self.worker_id} frozen")
            return False
        payload: Dict[str, Any] = {"worker_id": self.worker_id}
        if self.port:
            payload["port"] = self.port
        # the beat carries this worker's resource snapshot (the master's
        # federated view) unless DTPU_RESOURCE=0; a failed probe must
        # not skip a beat
        try:
            from comfyui_distributed_tpu_torch.utils import resource
            if resource.resource_enabled():
                payload["resources"] = resource.fleet_sample()
        except Exception as e:  # noqa: BLE001 - liveness first
            debug_log(f"heartbeat resource snapshot failed: {e}")
        # and its wall clock, stamped last so the probe above adds no
        # delay to the master's clock-offset sample
        payload["sent_at"] = time.time()
        try:
            post_json(f"{self.master_url}/distributed/heartbeat", payload,
                      timeout=timeout)
        except Exception:  # noqa: BLE001 - the next beat tries again
            return False
        self.beats_sent += 1
        return True

    def rehome(self, master_url: str, attempts: int = 3) -> bool:
        """Point the heartbeat at a new master and register there now.
        The first beat can meet the dying master's sockets, and a lost
        one would leave this worker unregistered (read as dead) for a
        whole interval, so a short burst of retries follows."""
        self.master_url = master_url.rstrip("/")
        for i in range(max(attempts, 1)):
            if self.beat_once():
                return True
            time.sleep(min(0.2 * (2 ** i), 1.0))
        return False

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


class MultiHeartbeatSender:
    """A worker's heartbeats to several master shards: one
    :class:`HeartbeatSender`, one lease, per master, so each master sees
    and recovers this worker's death on its own.  ``rehome`` adds a
    master and keeps the others, as a single sender's route expects."""

    def __init__(self, master_urls: List[str], worker_id: str,
                 port: Optional[int] = None):
        self.worker_id = str(worker_id)
        self.port = port
        self._lock = threading.Lock()
        self._senders: Dict[str, HeartbeatSender] = {  # guarded-by: _lock
            u.rstrip("/"): HeartbeatSender(u, worker_id, port=port)
            for u in dict.fromkeys(
                x.strip() for x in master_urls if x.strip())}

    @property
    def master_urls(self) -> List[str]:
        with self._lock:
            return sorted(self._senders)

    def _all(self) -> List[HeartbeatSender]:
        with self._lock:
            return list(self._senders.values())

    def start(self) -> None:
        for hb in self._all():
            hb.start()

    def stop(self) -> None:
        for hb in self._all():
            hb.stop()

    def beat_once(self) -> int:
        return sum(1 for hb in self._all() if hb.beat_once())

    def rehome(self, master_url: str, attempts: int = 3) -> bool:
        """A master announced itself: make sure a heartbeat goes to it
        and register there now."""
        url = master_url.rstrip("/")
        with self._lock:
            hb = self._senders.get(url)
            fresh = hb is None
            if fresh:
                hb = self._senders[url] = HeartbeatSender(
                    url, self.worker_id, port=self.port)
        if fresh:
            hb.start()
        for i in range(max(attempts, 1)):
            if hb.beat_once():
                return True
            time.sleep(min(0.2 * (2 ** i), 1.0))
        return False


def maybe_start_heartbeat(port: Optional[int] = None):
    """Start the worker's heartbeat when ``DTPU_WORKER_ID`` and a master
    are set: ``DTPU_MASTER_URLS`` (a comma list, one lease per master
    shard) or ``DTPU_MASTER_URL``."""
    multi = os.environ.get(C.MASTER_URLS_ENV, "")
    master = os.environ.get(C.MASTER_URL_ENV)
    wid = os.environ.get(C.WORKER_ID_ENV)
    if not wid or not (multi or master):
        return None
    if multi:
        mhb = MultiHeartbeatSender(multi.split(","), wid, port=port)
        mhb.start()
        log(f"heartbeat: renewing {len(mhb.master_urls)} master-shard "
            f"lease(s) for {wid!r} ({', '.join(mhb.master_urls)})")
        return mhb
    hb = HeartbeatSender(master, wid, port=port)
    hb.start()
    log(f"heartbeat: renewing lease for {wid!r} at {master} every "
        f"{hb.interval:.1f}s")
    return hb
