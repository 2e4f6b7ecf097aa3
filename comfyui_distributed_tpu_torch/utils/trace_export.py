"""Capture files: the counterpart of
``comfyui_distributed_tpu/utils/trace_export.py``, in its file format.

The flight recorder is a bounded ring in memory; with
``DTPU_TRACE_EXPORT_DIR`` set, every committed trace also streams to
rotating, size-bounded JSONL *capture segments* there
(``capture-NNNNNNNN.jsonl``, schema 1), so either package reads the
other's directory (``cli trace --export-dir``, ``cli why``, ``cli
analyze``).

- Appends are flushed, never fsynced, on the thread that commits the
  trace (the execution thread here), outside the recorder's lock.
- The active segment closes once the next record would push it past
  ``DTPU_TRACE_EXPORT_SEGMENT_BYTES``; a record larger than that still
  lands, alone, in a segment of its own.
- After each rotation the oldest closed segments go until the directory
  fits ``DTPU_TRACE_EXPORT_RETAIN_BYTES``.
- Disk errors count into ``dropped`` and log once per
  ``TRACE_EXPORT_DROP_LOG_EVERY``.

Each line is one JSON object::

    {"schema": 1, "prompt_id": ..., "trace_id": ..., "status": ...,
     "root_span_id": ..., "duration_s": ..., "finished_at": ...,
     "spans": [<Span.to_dict()>, ...]}

:func:`iter_records` and :func:`load_trace` read them back,
:func:`load_forest` nests the spans, and :func:`to_perfetto` converts
one record to Chrome/Perfetto trace-event JSON with one lane per
participant.
"""

from __future__ import annotations

import json
import os
import threading
from typing import Any, Dict, Iterator, List, Optional

from comfyui_distributed_tpu_torch.utils import constants as C
from comfyui_distributed_tpu_torch.utils.log import log

SCHEMA_VERSION = C.TRACE_EXPORT_SCHEMA
_SUFFIX = ".jsonl"


def _env_bytes(name: str, default: int) -> int:
    try:
        return max(1, int(os.environ.get(name, default)))
    except ValueError:
        return default


def _seg_seq(path: str) -> int:
    """Sequence number encoded in a segment filename (-1 if foreign)."""
    base = os.path.basename(path)
    if not base.startswith(C.TRACE_EXPORT_PREFIX) \
            or not base.endswith(_SUFFIX):
        return -1
    try:
        return int(base[len(C.TRACE_EXPORT_PREFIX):-len(_SUFFIX)])
    except ValueError:
        return -1


def segment_paths(dir_path: str) -> List[str]:
    """Capture segments under ``dir_path``, oldest first."""
    try:
        names = os.listdir(dir_path)
    except OSError:
        return []
    segs = [(seq, os.path.join(dir_path, n))
            for n, seq in ((n, _seg_seq(n)) for n in names) if seq >= 0]
    return [p for _, p in sorted(segs)]


class TraceExporter:
    """One capture directory's rotating JSONL sink (thread-safe)."""

    def __init__(self, dir_path: str,
                 segment_bytes: Optional[int] = None,
                 retain_bytes: Optional[int] = None):
        self.dir = str(dir_path)
        self.segment_bytes = segment_bytes if segment_bytes is not None \
            else _env_bytes(C.TRACE_EXPORT_SEGMENT_ENV,
                            C.TRACE_EXPORT_SEGMENT_DEFAULT)
        self.retain_bytes = retain_bytes if retain_bytes is not None \
            else _env_bytes(C.TRACE_EXPORT_RETAIN_ENV,
                            C.TRACE_EXPORT_RETAIN_DEFAULT)
        self._lock = threading.Lock()
        self._fh = None                 # guarded-by: self._lock
        self._seg_bytes = 0             # guarded-by: self._lock
        # resume numbering after what's already on disk (a restarted
        # process must not overwrite an older run's segments)
        existing = segment_paths(self.dir)
        self._next_seq = (_seg_seq(existing[-1]) + 1) if existing else 0
        self.exported = 0               # guarded-by: self._lock
        self.dropped = 0                # guarded-by: self._lock
        self.bytes_written = 0          # guarded-by: self._lock
        self.rotations = 0              # guarded-by: self._lock
        self.retired_segments = 0       # guarded-by: self._lock

    # dtpu-lint: holds[self._lock]
    def _open_next_locked(self) -> None:
        os.makedirs(self.dir, exist_ok=True)
        path = os.path.join(
            self.dir, f"{C.TRACE_EXPORT_PREFIX}{self._next_seq:08d}"
                      f"{_SUFFIX}")
        self._next_seq += 1
        self._fh = open(path, "ab")
        self._seg_bytes = 0

    # dtpu-lint: holds[self._lock]
    def _rotate_locked(self) -> None:
        if self._fh is not None:
            try:
                self._fh.close()
            except OSError:
                pass
            self._fh = None
            self.rotations += 1
        self._retain_locked()
        self._open_next_locked()

    # dtpu-lint: holds[self._lock]
    def _retain_locked(self) -> None:
        """Delete oldest closed segments until the dir fits the budget
        (the active segment — none right now, we rotate closed — plus
        the upcoming one are what the headroom is for)."""
        segs = segment_paths(self.dir)
        sizes = []
        for p in segs:
            try:
                sizes.append(os.path.getsize(p))
            except OSError:
                sizes.append(0)
        total = sum(sizes)
        for p, sz in zip(segs, sizes):
            if total + self.segment_bytes <= self.retain_bytes:
                break
            try:
                os.remove(p)
                self.retired_segments += 1
                total -= sz
            except OSError:
                # an external pruner won the race; counted as retired
                # all the same — the segment is gone either way
                self.retired_segments += 1
                total -= sz

    def export(self, rec: Dict[str, Any]) -> bool:
        """Append one committed-trace record; False when dropped."""
        try:
            line = json.dumps({"schema": SCHEMA_VERSION, **rec},
                              separators=(",", ":"), default=str)
            data = line.encode("utf-8") + b"\n"
        except (TypeError, ValueError) as e:
            self._count_drop(f"unserializable trace record: {e}")
            return False
        with self._lock:
            try:
                if self._fh is None or (
                        self._seg_bytes > 0
                        and self._seg_bytes + len(data)
                        > self.segment_bytes):
                    self._rotate_locked()
                self._fh.write(data)
                self._fh.flush()
                self._seg_bytes += len(data)
                self.exported += 1
                self.bytes_written += len(data)
                return True
            except OSError as e:
                err = f"{type(e).__name__}: {e}"
                drops = self.dropped = self.dropped + 1
        self._log_drop(drops, err)
        return False

    def _count_drop(self, why: str) -> None:
        with self._lock:
            self.dropped += 1
            drops = self.dropped
        self._log_drop(drops, why)

    @staticmethod
    def _log_drop(drops: int, why: str) -> None:
        # no-silent-caps: first drop logs immediately, then once per N
        if drops % C.TRACE_EXPORT_DROP_LOG_EVERY == 1:
            log(f"trace export: {drops} records dropped ({why})")

    def stats(self) -> Dict[str, Any]:
        with self._lock:
            return {"enabled": True, "dir": self.dir,
                    "segment_bytes": self.segment_bytes,
                    "retain_bytes": self.retain_bytes,
                    "exported": self.exported,
                    "dropped": self.dropped,
                    "bytes_written": self.bytes_written,
                    "rotations": self.rotations,
                    "retired_segments": self.retired_segments}

    def reset_counters(self) -> None:
        with self._lock:
            self.exported = 0
            self.dropped = 0
            self.bytes_written = 0
            self.rotations = 0
            self.retired_segments = 0

    def close(self) -> None:
        with self._lock:
            if self._fh is not None:
                try:
                    self._fh.close()
                except OSError:
                    pass
                self._fh = None


# --- process-wide exporter (env-driven) --------------------------------------

_STATE_LOCK = threading.Lock()
_EXPORTER: Optional[TraceExporter] = None   # guarded-by: _STATE_LOCK
_EXPORTER_DIR: Optional[str] = None         # guarded-by: _STATE_LOCK


def current() -> Optional[TraceExporter]:
    """The exporter for the current ``DTPU_TRACE_EXPORT_DIR`` value, or
    None when export is off.  Re-reading the env on every call keeps
    tests and late-configured servers honest; the exporter itself is
    swapped only when the dir actually changes."""
    global _EXPORTER, _EXPORTER_DIR
    d = (os.environ.get(C.TRACE_EXPORT_DIR_ENV) or "").strip()
    with _STATE_LOCK:
        if d != _EXPORTER_DIR:
            if _EXPORTER is not None:
                _EXPORTER.close()
            _EXPORTER = TraceExporter(d) if d else None
            _EXPORTER_DIR = d
        return _EXPORTER


def on_commit(rec: Dict[str, Any]) -> None:
    """FlightRecorder.commit tap: stream one sealed trace to the capture
    files.  A cheap no-op (one env read) when export is off."""
    exp = current()
    if exp is not None:
        exp.export(rec)


def stats() -> Dict[str, Any]:
    exp = current()
    return exp.stats() if exp is not None else {"enabled": False}


def reset_counters() -> None:
    exp = current()
    if exp is not None:
        exp.reset_counters()


# --- loader ------------------------------------------------------------------

def iter_records(dir_path: str,
                 stats: Optional[Dict[str, int]] = None,
                 ) -> Iterator[Dict[str, Any]]:
    """Yield capture records oldest-segment-first; lines that fail to
    parse or carry an unknown schema are skipped (a torn final line
    after a crash is expected, not fatal).  Pass a dict as ``stats`` to
    learn how much was skipped — ``torn_lines`` (JSON parse failures),
    ``unknown_schema`` and ``io_errors`` are accumulated into it so
    ``cli analyze`` can report loader health instead of silently
    narrowing the sample."""
    if stats is not None:
        for k in ("records", "torn_lines", "unknown_schema", "io_errors"):
            stats.setdefault(k, 0)
    for path in segment_paths(dir_path):
        try:
            with open(path, "rb") as fh:
                for raw in fh:
                    raw = raw.strip()
                    if not raw:
                        continue
                    try:
                        rec = json.loads(raw)
                    except ValueError:
                        if stats is not None:
                            stats["torn_lines"] += 1
                        continue
                    if not isinstance(rec, dict) \
                            or rec.get("schema") != SCHEMA_VERSION:
                        if stats is not None:
                            stats["unknown_schema"] += 1
                        continue
                    if stats is not None:
                        stats["records"] += 1
                    yield rec
        except OSError:
            if stats is not None:
                stats["io_errors"] += 1
            continue


def load_trace(dir_path: str, prompt_id: Optional[str] = None,
               trace_id: Optional[str] = None) -> Optional[Dict[str, Any]]:
    """The newest capture record matching ``prompt_id`` and/or
    ``trace_id`` (last write wins, mirroring the recorder's dual-commit
    semantics)."""
    found = None
    for rec in iter_records(dir_path):
        if prompt_id is not None \
                and str(rec.get("prompt_id")) != str(prompt_id):
            continue
        if trace_id is not None and rec.get("trace_id") != trace_id:
            continue
        found = rec
    return found


def load_forest(rec: Dict[str, Any]) -> List[Dict[str, Any]]:
    """Reconstruct the span forest of one capture record — the same
    nesting ``GET /distributed/trace/<pid>`` serves from memory."""
    from comfyui_distributed_tpu_torch.utils import trace as trace_mod
    return trace_mod.build_span_tree(list(rec.get("spans") or []))


# --- Chrome/Perfetto conversion ----------------------------------------------

def to_perfetto(rec: Dict[str, Any]) -> Dict[str, Any]:
    """One capture/flight-recorder record as Chrome trace-event JSON
    (``chrome://tracing`` / ui.perfetto.dev).  Spans become complete
    ("X") events; zero-duration event spans become instant ("i")
    markers so they stay visible instead of rendering as invisible
    slivers.  Each participant (the span's ``worker`` attr, master when
    absent) gets its own lane, decorated with the shard id and tenant
    class when the spans carry them, so a fan-out reads as parallel
    attributable tracks."""
    lanes: Dict[str, int] = {}
    events: List[Dict[str, Any]] = []
    spans = sorted(list(rec.get("spans") or []),
                   key=lambda s: s.get("start_s", 0.0))
    for s in spans:
        attrs = dict(s.get("attrs") or {})
        lane = str(attrs.get("worker") or "master")
        if attrs.get("shard") is not None:
            lane += f" shard={attrs['shard']}"
        if attrs.get("tenant"):
            lane += f" [{attrs['tenant']}]"
        tid = lanes.setdefault(lane, len(lanes) + 1)
        args: Dict[str, Any] = {"trace_id": s.get("trace_id"),
                                "span_id": s.get("span_id"),
                                "status": s.get("status")}
        args.update(attrs)
        dur_us = round(float(s.get("duration_s") or 0.0) * 1e6, 3)
        ev = {
            "name": s.get("name", "?"), "cat": "dtpu", "ph": "X",
            "ts": round(float(s.get("start_s") or 0.0) * 1e6, 3),
            "dur": dur_us, "pid": 1, "tid": tid, "args": args,
        }
        if dur_us <= 0:
            # instant event, thread-scoped — perfetto drops "X" slices
            # with zero duration
            ev["ph"] = "i"
            ev["s"] = "t"
            del ev["dur"]
        events.append(ev)
    meta: List[Dict[str, Any]] = [{
        "name": "process_name", "ph": "M", "pid": 1,
        "args": {"name": f"dtpu job {rec.get('prompt_id', '?')} "
                         f"({str(rec.get('trace_id', ''))[:8]})"}}]
    for lane, tid in sorted(lanes.items(), key=lambda kv: kv[1]):
        meta.append({"name": "thread_name", "ph": "M", "pid": 1,
                     "tid": tid, "args": {"name": lane}})
    return {"displayTimeUnit": "ms", "traceEvents": meta + events}
