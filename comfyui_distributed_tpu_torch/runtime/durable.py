"""Durable job state and master failover: the counterpart of
``comfyui_distributed_tpu/runtime/durable.py``, copied, not imported.

A fan-out survives a dead worker through the work ledger
(``runtime/cluster.py``); this module makes it survive a dead master.
The log's files are the JAX package's, byte for byte in their format,
so each package replays and verifies the other's directory.

- :class:`WriteAheadLog`: every queue admission, ledger ownership
  transition, unit check-in and idempotency key is appended as one
  checksummed line (``crc32 json``) to segment files under
  ``DTPU_WAL_DIR`` (``DTPU_WAL_SYNC`` picks the fsync policy).  A full
  segment rotates: the materialised state is snapshotted and the older
  segments deleted, so replay reads one segment, not the job history.
- :class:`ReplayState`: the one materialiser.  The log applies every
  append to it live, a snapshot is it serialised, and recovery replays
  snapshot and segments through the same ``apply``.
- :class:`UnitStore`: finished units' payloads (refined tile windows,
  worker tiles, collected seed slices) as ``.npz`` files beside the
  log, so a recovered job refines only its unfinished units; a done unit
  whose file is missing goes back to pending.  It takes and gives numpy:
  a caller copies a device tensor to the host before ``put`` and puts
  what ``get`` returns on its device.
- :class:`MasterLease`: a lease file whose epoch only grows, the fencing
  token.  A standby (``DTPU_STANDBY=1``) takes over when it expires, and
  an append from a deposed epoch raises :class:`FencedError`.  Each
  epoch writes its own segment files.
- :class:`DurableMaster`: what ``ServerState`` owns: take (or watch)
  the lease, replay, preload the ledger and the idempotency keys,
  resume the interrupted prompts, renew the lease, re-home the workers
  after a takeover.

The order that makes a crash safe at any point (the crash-point tests):
a record is fsync'd before its effect is answered (an idempotency key
before the upload's 200, an admission before the prompt id reaches the
client); a unit's payload is written (temporary file, rename) before
its check-in record, so a crash between leaves an orphan file that
replay ignores; replaying any prefix twice gives the same state.  Its counters
(``wal_records``, ``wal_fenced``, ``wal_recovered_*``,
``wal_resumed_prompts``, ``master_takeovers``) go to
``utils.trace.GLOBAL_COUNTERS`` under the JAX package's names.
"""

from __future__ import annotations

import base64
import io
import json
import os
import re
import shutil
import threading
import time
import zlib
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np

from comfyui_distributed_tpu_torch.utils import config as cfg_mod
from comfyui_distributed_tpu_torch.utils import constants as C
from comfyui_distributed_tpu_torch.utils.trace import GLOBAL_COUNTERS
from comfyui_distributed_tpu_torch.utils.log import debug_log, log
from comfyui_distributed_tpu_torch.utils.net import post_json

_SEGMENT_RE = re.compile(r"^wal-(\d{6})-(\d{6})\.log$")
_SNAPSHOT_RE = re.compile(r"^snapshot-(\d{6})-(\d{6})\.json$")


class WalError(RuntimeError):
    """Base class of the durability failures."""


class FencedError(WalError):
    """A newer epoch holds the master lease: this writer was deposed."""


class WalCrashedError(WalError):
    """The injected crash point was reached: the log refuses every
    further append, as a dead process would."""


class LeaseHeldError(WalError):
    """The master lease is live and another owner holds it."""


def wal_dir() -> Optional[str]:
    d = os.environ.get(C.WAL_DIR_ENV, "").strip()
    return os.path.expanduser(d) if d else None


def _sync_policy() -> Any:
    raw = os.environ.get(C.WAL_SYNC_ENV, C.WAL_SYNC_DEFAULT).strip().lower()
    if raw in ("always", ""):
        return "always"
    if raw in ("off", "0", "false", "no"):
        return "off"
    try:
        return max(float(raw), 0.0)
    except ValueError:
        log(f"bad {C.WAL_SYNC_ENV}={raw!r}; using always")
        return "always"


def _segment_bytes() -> int:
    try:
        return max(int(os.environ.get(C.WAL_SEGMENT_BYTES_ENV,
                                      C.WAL_SEGMENT_BYTES_DEFAULT)), 4096)
    except ValueError:
        return C.WAL_SEGMENT_BYTES_DEFAULT


def master_lease_s() -> float:
    try:
        return max(float(os.environ.get(C.MASTER_LEASE_ENV,
                                        C.MASTER_LEASE_DEFAULT)), 0.2)
    except ValueError:
        return C.MASTER_LEASE_DEFAULT


def encode_record(rec: Dict[str, Any]) -> bytes:
    body = json.dumps(rec, separators=(",", ":"), sort_keys=True)
    payload = body.encode("utf-8")
    return b"%08x %s\n" % (zlib.crc32(payload), payload)


def decode_line(line: bytes) -> Optional[Dict[str, Any]]:
    """One record, or None for a torn or corrupt line."""
    if not line.endswith(b"\n") or b" " not in line:
        return None
    crc_hex, _, payload = line.rstrip(b"\n").partition(b" ")
    try:
        if int(crc_hex, 16) != zlib.crc32(payload):
            return None
        rec = json.loads(payload)
    except (ValueError, TypeError):
        return None
    return rec if isinstance(rec, dict) else None


def read_segment(path: str) -> Tuple[List[Dict[str, Any]], Optional[int]]:
    """The valid records and the byte offset of the first bad line (None
    for a clean segment).  Replay stops at the first bad line: nothing
    after a torn write is trusted."""
    records: List[Dict[str, Any]] = []
    offset = 0
    with open(path, "rb") as f:
        for line in f:
            rec = decode_line(line)
            if rec is None:
                return records, offset
            records.append(rec)
            offset += len(line)
    return records, None


def _list_by(dirpath: str, pattern: re.Pattern) -> List[Tuple[int, int, str]]:
    try:
        names = os.listdir(dirpath)
    except OSError:
        return []
    out = []
    for name in names:
        m = pattern.match(name)
        if m:
            out.append((int(m.group(1)), int(m.group(2)),
                        os.path.join(dirpath, name)))
    return sorted(out)


def list_segments(dirpath: str) -> List[Tuple[int, int, str]]:
    """[(epoch, seq, path)] in replay order."""
    return _list_by(dirpath, _SEGMENT_RE)


def list_snapshots(dirpath: str) -> List[Tuple[int, int, str]]:
    return _list_by(dirpath, _SNAPSHOT_RE)


def _fsync_dir(dirpath: str) -> None:
    try:
        fd = os.open(dirpath, os.O_RDONLY)
        try:
            os.fsync(fd)
        finally:
            os.close(fd)
    except OSError:
        pass


def _atomic_write(path: str, data: bytes) -> None:
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "wb") as f:
        f.write(data)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)
    _fsync_dir(os.path.dirname(path))


# --- the materialised master state -------------------------------------------

class ReplayState:
    """What the log materialises: pending prompts, open ledger jobs (each
    unit's owner and whether it is done), each job's idempotency keys.
    The live log and crash recovery both go through :meth:`apply`; a
    snapshot is this object serialised."""

    def __init__(self) -> None:
        # pid -> {prompt, client_id, extra}
        self.prompts: Dict[str, Dict[str, Any]] = {}
        # job -> {kind, units: {unit (str): {owner, done, by, spilled}}}
        self.jobs: Dict[str, Dict[str, Any]] = {}
        # scope ("image" | "tile") -> job -> [keys]
        self.idem: Dict[str, Dict[str, List[str]]] = {"image": {},
                                                      "tile": {}}
        self.counts: Dict[str, int] = {}
        self.applied = 0

    def apply(self, rec: Dict[str, Any]) -> None:
        t = rec.get("t")
        self.applied += 1
        self.counts[t] = self.counts.get(t, 0) + 1
        if t == "enqueue":
            self.prompts[str(rec["pid"])] = {
                "prompt": rec.get("prompt"),
                "client_id": rec.get("client_id", "recovered"),
                "extra": rec.get("extra") or {},
            }
        elif t == "exec_done":
            self.prompts.pop(str(rec["pid"]), None)
        elif t == "job_create":
            jid = str(rec["job"])
            job = self.jobs.get(jid)
            owners = {str(u): str(o)
                      for u, o in (rec.get("owners") or {}).items()}
            if job is None:
                self.jobs[jid] = {
                    "kind": rec.get("kind", "tile"),
                    "units": {u: {"owner": o, "done": False,
                                  "by": None, "spilled": False}
                              for u, o in owners.items()}}
            else:
                # a recovered run registers the job again: pending
                # owners are refreshed, done units never forgotten
                units = job["units"]
                for u, o in owners.items():
                    cur = units.get(u)
                    if cur is None:
                        units[u] = {"owner": o, "done": False,
                                    "by": None, "spilled": False}
                    elif not cur["done"]:
                        cur["owner"] = o
        elif t == "unit_checkin":
            job = self.jobs.get(str(rec["job"]))
            if job is not None:
                u = job["units"].setdefault(
                    str(rec["unit"]), {"owner": str(rec.get("by", "")),
                                       "done": False, "by": None,
                                       "spilled": False})
                u["done"] = True
                u["by"] = str(rec.get("by", ""))
                u["spilled"] = bool(rec.get("spilled"))
        elif t == "unit_reassign":
            job = self.jobs.get(str(rec["job"]))
            if job is not None:
                for u in rec.get("units", []):
                    cur = job["units"].get(str(u))
                    if cur is not None and not cur["done"]:
                        cur["owner"] = str(rec["to"])
        elif t == "unit_hedge":
            # kept for the record only: a hedge is speculation, not
            # ownership, and a recovered job decides its hedges anew
            pass
        elif t == "job_finish":
            self.jobs.pop(str(rec["job"]), None)
            for scope in self.idem.values():
                scope.pop(str(rec["job"]), None)
        elif t == "idem":
            scope = self.idem.setdefault(str(rec.get("scope", "image")), {})
            keys = scope.setdefault(str(rec["job"]), [])
            k = str(rec["key"])
            if k not in keys:
                keys.append(k)

    # -- the snapshot codec -----------------------------------------------------

    def to_json(self) -> Dict[str, Any]:
        return {"prompts": self.prompts, "jobs": self.jobs,
                "idem": self.idem, "counts": self.counts,
                "applied": self.applied}

    @classmethod
    def from_json(cls, data: Dict[str, Any]) -> "ReplayState":
        st = cls()
        st.prompts = dict(data.get("prompts") or {})
        st.jobs = dict(data.get("jobs") or {})
        idem = data.get("idem") or {}
        st.idem = {"image": dict(idem.get("image") or {}),
                   "tile": dict(idem.get("tile") or {})}
        st.counts = dict(data.get("counts") or {})
        st.applied = int(data.get("applied") or 0)
        return st


def replay(dirpath: str) -> Tuple[ReplayState, Dict[str, Any]]:
    """The newest readable snapshot and the segments from its watermark
    on -> the materialised state, and what was read (for the logs and
    ``cli wal``)."""
    state = ReplayState()
    watermark = (-1, -1)
    snap_used = None
    for epoch, seq, path in reversed(list_snapshots(dirpath)):
        try:
            with open(path, "r", encoding="utf-8") as f:
                state = ReplayState.from_json(json.load(f))
            watermark, snap_used = (epoch, seq), path
            break
        except (OSError, ValueError) as e:
            log(f"wal: snapshot {os.path.basename(path)} unreadable "
                f"({e}); trying the one before")
    segments = [s for s in list_segments(dirpath)
                if (s[0], s[1]) >= watermark]
    torn = []
    records = 0
    for _epoch, _seq, path in segments:
        recs, bad = read_segment(path)
        for rec in recs:
            state.apply(rec)
        records += len(recs)
        if bad is not None:
            torn.append({"segment": os.path.basename(path), "offset": bad})
    return state, {"snapshot": snap_used,
                   "segments_replayed": len(segments),
                   "records_replayed": records,
                   "torn": torn}


# --- finished units' payloads --------------------------------------------------

def _unit_token(unit: Any) -> str:
    return base64.urlsafe_b64encode(
        str(unit).encode("utf-8")).decode("ascii").rstrip("=")


def _unit_from_token(token: str) -> str:
    pad = "=" * (-len(token) % 4)
    return base64.urlsafe_b64decode(token + pad).decode("utf-8")


class UnitStore:
    """Finished units' payloads on disk, ``units/<job>/<unit>.npz``: the
    arrays and a JSON ``meta`` field (``np.savez_compressed``, the JAX
    package's format).  A write is atomic and comes before the unit's
    check-in record, so a crash between leaves an orphan file."""

    def __init__(self, root: str) -> None:
        self.root = os.path.join(root, "units")

    def _job_dir(self, job: str) -> str:
        return os.path.join(self.root, _unit_token(job))

    def path(self, job: str, unit: Any) -> str:
        return os.path.join(self._job_dir(str(job)),
                            f"{_unit_token(unit)}.npz")

    def put(self, job: str, unit: Any, tensors: List[np.ndarray],
            meta: Dict[str, Any]) -> None:
        d = self._job_dir(str(job))
        os.makedirs(d, exist_ok=True)
        buf = io.BytesIO()
        arrays = {f"t{i}": np.asarray(t) for i, t in enumerate(tensors)}
        np.savez_compressed(buf, meta=np.frombuffer(
            json.dumps({**meta, "n": len(tensors)}).encode(), np.uint8),
            **arrays)
        _atomic_write(self.path(str(job), unit), buf.getvalue())

    def has(self, job: str, unit: Any) -> bool:
        return os.path.exists(self.path(str(job), unit))

    def get(self, job: str, unit: Any
            ) -> Optional[Tuple[List[np.ndarray], Dict[str, Any]]]:
        p = self.path(str(job), unit)
        try:
            with np.load(p) as z:
                meta = json.loads(bytes(z["meta"]).decode())
                tensors = [z[f"t{i}"] for i in range(int(meta.pop("n", 0)))]
            return tensors, meta
        except (OSError, ValueError, KeyError) as e:
            debug_log(f"unit store: {p} unreadable ({e}); the unit will be "
                      f"recomputed")
            return None

    def drop_job(self, job: str) -> None:
        shutil.rmtree(self._job_dir(str(job)), ignore_errors=True)

    def jobs(self) -> List[str]:
        try:
            return [_unit_from_token(n) for n in os.listdir(self.root)]
        except OSError:
            return []

    def prune(self, keep_jobs) -> int:
        """At recovery: drop the directories of jobs the replayed state
        does not hold (a crash between the job_finish record and
        ``drop_job`` strands them) and the temporary files of a crash
        mid-spill; returns how many job directories went."""
        keep = {str(j) for j in keep_jobs}
        dropped = 0
        for job in self.jobs():
            if job not in keep:
                self.drop_job(job)
                dropped += 1
        for dirpath, _dirs, files in os.walk(self.root):
            for name in files:
                if ".tmp." in name:
                    try:
                        os.remove(os.path.join(dirpath, name))
                    except OSError:
                        pass
        return dropped


# --- the master lease (election and fencing) ----------------------------------

class MasterLease:
    """A lease file in the log's directory, changed under an flock'd lock
    file, so that acquire and renew races resolve on one host or one
    shared filesystem.  The epoch only grows: it is the fencing token
    every append carries and checks."""

    def __init__(self, dirpath: str):
        self.dir = dirpath
        self.path = os.path.join(dirpath, "master.lease")
        self._lock_path = os.path.join(dirpath, "master.lock")

    def _with_lock(self, fn: Callable[[], Any]) -> Any:
        os.makedirs(self.dir, exist_ok=True)
        with open(self._lock_path, "a+") as f:
            try:
                import fcntl
                fcntl.flock(f.fileno(), fcntl.LOCK_EX)
            except (ImportError, OSError):
                pass  # no flock: the atomic rename still holds
            return fn()

    def read(self) -> Optional[Dict[str, Any]]:
        try:
            with open(self.path, "r", encoding="utf-8") as f:
                data = json.load(f)
            return data if isinstance(data, dict) else None
        except (OSError, ValueError):
            return None

    def current_epoch(self) -> int:
        cur = self.read()
        return int(cur.get("epoch", 0)) if cur else 0

    @staticmethod
    def expired(rec: Optional[Dict[str, Any]]) -> bool:
        return rec is None or time.time() > float(rec.get("expires_at", 0))

    def acquire(self, owner: str, lease_s: float,
                force: bool = False) -> int:
        """Take the lease, one epoch up.  Refused while another owner's
        lease lives; the same owner takes it back at once (a restart:
        the holder was this owner, and it is not running any more)."""
        def go():
            cur = self.read()
            if cur and not force and str(cur.get("owner")) != str(owner) \
                    and not self.expired(cur):
                raise LeaseHeldError(
                    f"master lease held by {cur.get('owner')!r} for "
                    f"another "
                    f"{float(cur.get('expires_at', 0)) - time.time():.1f}s")
            epoch = (int(cur.get("epoch", 0)) if cur else 0) + 1
            now = time.time()
            _atomic_write(self.path, json.dumps({
                "owner": str(owner), "epoch": epoch,
                "lease_s": float(lease_s), "acquired_at": now,
                "expires_at": now + float(lease_s)}).encode())
            return epoch
        return self._with_lock(go)

    def renew(self, owner: str, epoch: int, lease_s: float) -> bool:
        """Extend the lease; False once it was lost (a newer epoch)."""
        def go():
            cur = self.read()
            if not cur or int(cur.get("epoch", 0)) != int(epoch) \
                    or str(cur.get("owner")) != str(owner):
                return False
            now = time.time()
            _atomic_write(self.path, json.dumps({
                **cur, "expires_at": now + float(lease_s),
                "renewed_at": now}).encode())
            return True
        return self._with_lock(go)

    def snapshot(self) -> Dict[str, Any]:
        cur = self.read()
        if cur is None:
            return {"held": False, "epoch": 0}
        return {"held": not self.expired(cur),
                "owner": cur.get("owner"),
                "epoch": int(cur.get("epoch", 0)),
                "expires_in_s": round(
                    float(cur.get("expires_at", 0)) - time.time(), 3)}


# --- the log -------------------------------------------------------------------

class WriteAheadLog:
    """Append-only checksummed records in segment files of this epoch,
    a snapshot and truncation at rotation, the fsync policy, lease
    fencing, and the crash hook of the recovery tests."""

    def __init__(self, dirpath: str, epoch: int = 1,
                 lease: Optional[MasterLease] = None,
                 tracker: Optional[ReplayState] = None,
                 sync: Optional[Any] = None,
                 segment_bytes: Optional[int] = None):
        self.dir = dirpath
        self.epoch = int(epoch)
        self.lease = lease
        self.tracker = tracker if tracker is not None else ReplayState()
        self.sync_policy = _sync_policy() if sync is None else sync
        self.segment_bytes = _segment_bytes() if segment_bytes is None \
            else int(segment_bytes)
        self._lock = threading.Lock()
        # one writer at a time, and stats() reads from handler threads:
        # everything below is read and written under the lock
        self._f: Optional[Any] = None       # guarded-by: _lock
        self._seq = max([s for _e, s, _p in list_segments(dirpath)],
                        default=0) + 1      # guarded-by: _lock
        self._size = 0                      # guarded-by: _lock
        self._unsynced = 0                  # guarded-by: _lock
        self._last_sync = time.monotonic()  # guarded-by: _lock
        self._last_fence_check = 0.0        # guarded-by: _lock
        self.fenced = False
        self.crashed = False                # guarded-by: _lock
        self.records_appended = 0           # guarded-by: _lock
        self.fsyncs = 0                     # guarded-by: _lock
        # the crash hook: {"type": record type or None, "point":
        # pre_append | torn | post_sync, "after": n matching appends}
        self._crash: Optional[Dict[str, Any]] = None  # guarded-by: _lock
        os.makedirs(dirpath, exist_ok=True)
        self._open_segment()

    # -- segments ---------------------------------------------------------------

    def _segment_path(self) -> str:
        return os.path.join(self.dir,
                            f"wal-{self.epoch:06d}-{self._seq:06d}.log")

    def _open_segment(self) -> None:
        if self._f is not None:
            self._f.close()
        self._f = open(self._segment_path(), "ab")
        self._size = self._f.tell()

    def _rotate_locked(self) -> None:
        """Close the full segment, snapshot the materialised state and
        delete what the snapshot covers."""
        self._fsync_locked()
        self._seq += 1
        self._open_segment()
        snap_path = os.path.join(
            self.dir, f"snapshot-{self.epoch:06d}-{self._seq:06d}.json")
        try:
            _atomic_write(snap_path,
                          json.dumps(self.tracker.to_json()).encode())
        except OSError as e:
            log(f"wal: snapshot failed ({e}); keeping the whole log")
            return
        watermark = (self.epoch, self._seq)
        for e, s, path in list_segments(self.dir) + list_snapshots(self.dir):
            if (e, s) < watermark:
                try:
                    os.remove(path)
                except OSError:
                    pass
        debug_log(f"wal: rotated to segment {self._seq}, snapshot written "
                  f"and older files deleted")

    def _fsync_locked(self) -> None:
        if self._f is None:
            return
        self._f.flush()
        os.fsync(self._f.fileno())
        self.fsyncs += 1
        self._unsynced = 0
        self._last_sync = time.monotonic()

    # -- fencing and the crash hook ---------------------------------------------

    def _check_fence_locked(self) -> None:
        if self.fenced:
            raise FencedError(f"epoch {self.epoch} was deposed")
        if self.lease is None:
            return
        now = time.monotonic()
        if now - self._last_fence_check < C.WAL_FENCE_CHECK_S:
            return
        self._last_fence_check = now
        cur = self.lease.current_epoch()
        if cur > self.epoch:
            self.fenced = True
            GLOBAL_COUNTERS.bump("wal_fenced")
            raise FencedError(
                f"epoch {self.epoch} fenced: the lease is at epoch {cur}")

    def inject_crash(self, point: str, rtype: Optional[str] = None,
                     after: int = 0) -> None:
        """Arm the crash hook: crash at ``point`` ("pre_append": nothing
        written; "torn": half a record written, no fsync; "post_sync":
        the record durable, its answer never given) on the ``after``-th
        append of type ``rtype`` (None: any)."""
        with self._lock:
            self._crash = {"point": point, "type": rtype,
                           "after": int(after)}

    def simulate_crash(self) -> None:
        """From now on behave as a dead process's log: every append and
        sync raises, and nothing more is written."""
        with self._lock:
            self.crashed = True

    # -- the append path ----------------------------------------------------------

    def append(self, rtype: str, **fields: Any) -> Dict[str, Any]:
        rec = {"t": rtype, "e": self.epoch,
               "ts": round(time.time(), 3), **fields}
        with self._lock:
            if self.crashed:
                raise WalCrashedError("the log has crashed")
            self._check_fence_locked()
            hook = self._crash
            if hook is not None and (hook["type"] is None
                                     or hook["type"] == rtype):
                if hook["after"] > 0:
                    hook["after"] -= 1
                    hook = None
            else:
                hook = None
            if hook is not None and hook["point"] == "pre_append":
                self.crashed = True
                raise WalCrashedError(f"injected pre_append crash at {rtype}")
            data = encode_record(rec)
            if hook is not None and hook["point"] == "torn":
                self._f.write(data[:max(len(data) // 2, 1)])
                self._f.flush()
                self.crashed = True
                raise WalCrashedError(f"injected torn write at {rtype}")
            self._f.write(data)
            self._size += len(data)
            self.records_appended += 1
            self._unsynced += 1
            pol = self.sync_policy
            if pol == "always":
                self._fsync_locked()
            elif pol != "off" \
                    and time.monotonic() - self._last_sync >= float(pol):
                self._fsync_locked()
            else:
                self._f.flush()
            if hook is not None and hook["point"] == "post_sync":
                self._fsync_locked()
                self.crashed = True
                raise WalCrashedError(f"injected post_sync crash at {rtype} "
                                      f"(the record is durable, its answer "
                                      f"lost)")
            self.tracker.apply(rec)
            GLOBAL_COUNTERS.bump("wal_records")
            if self._size >= self.segment_bytes:
                self._rotate_locked()
        return rec

    def sync(self) -> None:
        with self._lock:
            if not self.crashed:
                self._fsync_locked()

    def close(self) -> None:
        with self._lock:
            if self._f is not None:
                try:
                    if not self.crashed:
                        self._fsync_locked()
                finally:
                    self._f.close()
                    self._f = None

    def stats(self) -> Dict[str, Any]:
        segs = list_segments(self.dir)
        with self._lock:
            return {
                "dir": self.dir,
                "epoch": self.epoch,
                "fenced": self.fenced,
                "segments": len(segs),
                "segment_seq": self._seq,
                "bytes": sum(os.path.getsize(p) for _, _, p in segs
                             if os.path.exists(p)),
                "records_appended": self.records_appended,
                "records_materialized": self.tracker.applied,
                "unsynced_records": self._unsynced,
                "last_sync_age_s": round(
                    time.monotonic() - self._last_sync, 3),
                "fsyncs": self.fsyncs,
                "sync_policy": str(self.sync_policy),
                "pending_prompts": len(self.tracker.prompts),
                "active_jobs": len(self.tracker.jobs),
            }


# --- offline verification (cli wal) -------------------------------------------

def verify(dirpath: str) -> Dict[str, Any]:
    """Walk the log: each segment's record count and checksum status, the
    snapshots, the records by job and by type, the replayed summary.  A
    bad line at the very end of a segment is a torn write (what a crash
    leaves); one with a valid line after it is corruption."""
    segs = list_segments(dirpath)
    seg_reports = []
    per_job: Dict[str, int] = {}
    per_type: Dict[str, int] = {}
    corrupt = False
    for epoch, seq, path in segs:
        recs, bad = read_segment(path)
        size = os.path.getsize(path)
        for rec in recs:
            per_type[rec.get("t", "?")] = per_type.get(rec.get("t", "?"),
                                                       0) + 1
            if "job" in rec:
                jid = str(rec["job"])
                per_job[jid] = per_job.get(jid, 0) + 1
        tail_bad = bad is not None
        is_torn_tail = False
        if tail_bad:
            # a torn write is a partial last record: nothing shaped like
            # a line follows the bad offset
            with open(path, "rb") as f:
                f.seek(bad)
                rest = f.read()
            is_torn_tail = b"\n" not in rest
        if tail_bad and not is_torn_tail:
            corrupt = True
        seg_reports.append({
            "segment": os.path.basename(path), "epoch": epoch,
            "seq": seq, "bytes": size, "records": len(recs),
            "checksum": ("ok" if not tail_bad else
                         "torn-tail" if is_torn_tail else
                         f"CORRUPT@{bad}"),
        })
    state, info = replay(dirpath)
    return {
        "dir": dirpath,
        "ok": not corrupt,
        "segments": seg_reports,
        "snapshots": [os.path.basename(p)
                      for _, _, p in list_snapshots(dirpath)],
        "lease": MasterLease(dirpath).snapshot(),
        "records_by_type": per_type,
        "records_by_job": per_job,
        "replay": {**info,
                   "pending_prompts": sorted(state.prompts),
                   "active_jobs": {
                       jid: {"kind": j["kind"],
                             "done": sum(1 for u in j["units"].values()
                                         if u["done"]),
                             "total": len(j["units"])}
                       for jid, j in state.jobs.items()},
                   "idem_keys": {s: sum(len(v) for v in m.values())
                                 for s, m in state.idem.items()}},
    }


def rehome_workers(master_url: str, config_path: Optional[str]) -> None:
    """Tell every enabled worker of the config to heartbeat
    ``master_url`` now (``POST /distributed/rehome``), best effort: a
    worker that misses it registers when a redispatched graph names this
    master."""
    for w in cfg_mod.enabled_workers(cfg_mod.load_config(config_path)):
        target = (f"http://{w.get('host') or '127.0.0.1'}:"
                  f"{w['port']}/distributed/rehome")
        try:
            post_json(target, {"master_url": master_url,
                               "worker_id": str(w["id"])}, timeout=3)
            debug_log(f"durable: re-homed worker {w['id']} to {master_url}")
        except Exception as e:  # noqa: BLE001 - best effort
            debug_log(f"durable: re-home of {w.get('id')} failed: {e}")


# --- what ServerState owns -------------------------------------------------------

class DurableMaster:
    """The lease, the log and the recovered state of one master process.
    :meth:`attach` is the entry point: None when durability is off (no
    ``DTPU_WAL_DIR``) or for a worker."""

    def __init__(self, dirpath: str, owner: str, standby: bool = False):
        self.dir = dirpath
        self.owner = owner
        self.standby = standby
        self.lease = MasterLease(dirpath)
        self.lease_s = master_lease_s()
        self.unit_store = UnitStore(dirpath)
        self.wal: Optional[WriteAheadLog] = None
        self.epoch = 0
        self.recovered: Optional[ReplayState] = None
        self.recovery_info: Dict[str, Any] = {}
        self._pending_prompts: List[Tuple[str, Dict[str, Any]]] = []
        self._resumed = False
        self._stop = threading.Event()
        self._heartbeat_thread: Optional[threading.Thread] = None
        self._watcher_thread: Optional[threading.Thread] = None
        # the standby's watcher and POST /distributed/takeover may race
        self._takeover_lock = threading.Lock()
        self._state = None   # the ServerState, set by attach
        self.takeovers = 0

    # -- construction -------------------------------------------------------------

    @classmethod
    def attach(cls, state, dirpath: Optional[str] = None,
               owner: Optional[str] = None) -> Optional["DurableMaster"]:
        """``dirpath`` and ``owner``: a sharded master's own log under the
        shared root, with its shard id as the lease owner (a restart of
        the shard takes its lease back; a peer's absorb is a new owner,
        one epoch up)."""
        d = dirpath or wal_dir()
        if not d or state.is_worker:
            return None
        standby = os.environ.get(C.STANDBY_ENV, "").lower() \
            in ("1", "true", "on", "yes")
        # a same-owner acquire is the restart's path, so a standby must
        # not share the primary's default identity: it could take a
        # live lease
        owner = owner or os.environ.get(C.WAL_OWNER_ENV, "").strip() \
            or (f"standby_{os.getpid()}" if standby else "master")
        dm = cls(d, owner=owner, standby=standby)
        dm._state = state
        os.makedirs(d, exist_ok=True)
        if standby:
            dm._start_watcher()
            log(f"durable: standby {owner!r} watching the master lease in "
                f"{d} (takes over when it expires)")
        else:
            dm._activate()
        return dm

    def _activate(self, epoch: Optional[int] = None) -> None:
        """Take the lease (unless ``epoch`` was already taken), replay
        the log, preload the ledger and the idempotency keys."""
        self.epoch = self.lease.acquire(self.owner, self.lease_s) \
            if epoch is None else epoch
        self.recovered, self.recovery_info = replay(self.dir)
        self.unit_store.prune(self.recovered.jobs)
        self.wal = WriteAheadLog(self.dir, epoch=self.epoch,
                                 lease=self.lease, tracker=self.recovered)
        st = self._state
        st.ledger.attach_wal(self.wal, self.unit_store,
                             dict(self.recovered.jobs))
        st.jobs.attach_wal(self.wal, self.recovered.idem)
        self._pending_prompts = [
            (pid, dict(p)) for pid, p in self.recovered.prompts.items()]
        self._resumed = False
        self._start_heartbeat()
        n_jobs = len(self.recovered.jobs)
        n_done = sum(sum(1 for u in j["units"].values() if u["done"])
                     for j in self.recovered.jobs.values())
        torn = self.recovery_info.get("torn")
        log(f"durable: epoch {self.epoch} holds the lease; replayed "
            f"{self.recovery_info.get('records_replayed', 0)} records "
            f"({len(self._pending_prompts)} in-flight prompt(s), "
            f"{n_jobs} open job(s), {n_done} unit(s) already done"
            + (f", a torn tail in {len(torn)} segment(s)" if torn else "")
            + ")")
        GLOBAL_COUNTERS.bump("wal_recovered_prompts",
                             len(self._pending_prompts))
        GLOBAL_COUNTERS.bump("wal_recovered_done_units", n_done)

    # -- resuming the interrupted prompts ---------------------------------------

    def resume(self) -> int:
        """Queue the prompts the crash interrupted again, under their
        original ids (a client polling ``/history`` finds them), after
        registering the redispatchers their unfinished units need.
        Called once the server is bound (the redispatched graphs name
        this master's URL); a second call does nothing."""
        if self._resumed or not self._pending_prompts:
            self._resumed = True
            return 0
        self._resumed = True
        st = self._state
        try:
            # a redispatch goes to a probed-healthy worker, not an
            # unknown one: probe before the drains ask the registry
            st.health.poll_once()
        except Exception as e:  # noqa: BLE001 - the probe is best effort
            debug_log(f"durable: the recovery's health poll failed: {e}")
        from comfyui_distributed_tpu_torch.workflow.orchestrate import (
            register_recovery_redispatchers)
        n = 0
        for pid, p in self._pending_prompts:
            prompt = p.get("prompt")
            if not isinstance(prompt, dict):
                continue
            try:
                register_recovery_redispatchers(st, prompt)
            except Exception as e:  # noqa: BLE001 - the master's own
                # refine still recovers every tile without them
                debug_log(f"durable: recovery redispatchers for {pid} "
                          f"skipped: {e}")
            st.enqueue_prompt(prompt, p.get("extra") or {},
                              client_id=p.get("client_id", "recovered"),
                              pid=pid, _recovered=True)
            n += 1
        self._pending_prompts = []
        if n:
            log(f"durable: resumed {n} in-flight prompt(s) from the log")
            GLOBAL_COUNTERS.bump("wal_resumed_prompts", n)
        return n

    # -- the queue's records --------------------------------------------------------

    def log_enqueue(self, pid: str, prompt: Dict[str, Any],
                    client_id: str, extra: Optional[Dict[str, Any]]) -> None:
        if self.wal is None:
            return
        safe_extra = None
        if extra:
            try:
                safe_extra = json.loads(json.dumps(extra))
            except (TypeError, ValueError):
                safe_extra = None
        self.wal.append("enqueue", pid=str(pid), prompt=prompt,
                        client_id=str(client_id), extra=safe_extra)

    def log_exec_done(self, pid: str, status: str) -> None:
        if self.wal is not None:
            try:
                self.wal.append("exec_done", pid=str(pid), status=str(status))
            except WalError as e:
                debug_log(f"durable: exec_done of {pid} not logged ({e})")

    # -- the lease's renewal and the standby's watch -------------------------------

    def _start_heartbeat(self) -> None:
        if self._heartbeat_thread is not None:
            return
        interval = max(self.lease_s / C.MASTER_LEASE_FRACTION, 0.05)

        def run():
            while not self._stop.wait(interval):
                try:
                    if not self.lease.renew(self.owner, self.epoch,
                                            self.lease_s):
                        log(f"durable: lost the master lease (epoch "
                            f"{self.epoch} superseded); fencing the log")
                        if self.wal is not None:
                            self.wal.fenced = True
                        return
                except OSError as e:
                    debug_log(f"durable: lease renewal failed: {e}")

        self._heartbeat_thread = threading.Thread(
            target=run, daemon=True, name="dtpu-master-lease")
        self._heartbeat_thread.start()

    def _start_watcher(self) -> None:
        if self._watcher_thread is not None:
            return
        interval = max(self.lease_s / C.MASTER_LEASE_FRACTION, 0.05)

        def run():
            while not self._stop.wait(interval):
                try:
                    if self.lease.expired(self.lease.read()):
                        log("durable: master lease expired; the standby "
                            "takes over")
                        self.takeover()
                        return
                except LeaseHeldError:
                    continue   # another took it first: keep watching
                except Exception as e:  # noqa: BLE001 - keep watching
                    log(f"durable: standby takeover failed: "
                        f"{type(e).__name__}: {e}")

        self._watcher_thread = threading.Thread(
            target=run, daemon=True, name="dtpu-standby-watch")
        self._watcher_thread.start()

    def takeover(self, force: bool = False) -> Dict[str, Any]:
        """Standby to master: take the lease one epoch up (the fencing
        event), replay the shared log, resume the interrupted prompts and
        re-home the workers to this server.  ``force`` takes a live
        lease."""
        with self._takeover_lock:
            if self.wal is not None and not self.wal.fenced:
                return {"ok": True, "epoch": self.epoch,
                        "note": "already active"}
            if force:
                self._activate(self.lease.acquire(self.owner, self.lease_s,
                                                  force=True))
            else:
                self._activate()   # LeaseHeldError while the lease lives
            self.takeovers += 1
            GLOBAL_COUNTERS.bump("master_takeovers")
            resumed = self.resume()
            url = self.master_url()
            if url is not None:
                rehome_workers(url, self._state.config_path)
            return {"ok": True, "epoch": self.epoch,
                    "resumed_prompts": resumed,
                    "recovered_jobs": len(self.recovered.jobs)
                    if self.recovered else 0}

    def master_url(self) -> Optional[str]:
        st = self._state
        if st is None or st.port is None:
            return None
        host = cfg_mod.load_config(st.config_path).get(
            "master", {}).get("host") or "127.0.0.1"
        return f"http://{host}:{st.port}"

    # -- lifetime and introspection ---------------------------------------------------

    def simulate_crash(self) -> None:
        """For tests: behave as this master's dead process would, no
        renewal of the lease and no further append.  The ServerState in
        memory is left as a killed process leaves its memory."""
        self._stop.set()
        if self.wal is not None:
            self.wal.simulate_crash()

    def close(self) -> None:
        self._stop.set()
        if self.wal is not None:
            self.wal.close()

    def stats(self) -> Dict[str, Any]:
        return {
            "enabled": True,
            "role": ("standby" if self.standby and self.wal is None
                     else "active"),
            "owner": self.owner,
            "epoch": self.epoch,
            "takeovers": self.takeovers,
            "lease": self.lease.snapshot(),
            "recovery": {
                "records_replayed":
                    self.recovery_info.get("records_replayed", 0),
                "resumed": self._resumed,
            },
            "wal": self.wal.stats() if self.wal is not None else None,
        }
