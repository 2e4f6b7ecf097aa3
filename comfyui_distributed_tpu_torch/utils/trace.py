"""Request tracing, latency histograms, transfer accounting and the
device profile: the counterpart of ``comfyui_distributed_tpu/utils/trace.py``.

- phase, stage and node wall-clock aggregation (:class:`PhaseStats` over
  fixed-bucket :class:`LatencyHistogram` with p50/p95/p99), fed by
  ``utils.log.Timer``, :func:`stage` and the executor, served on
  ``GET /distributed/metrics`` and rendered as Prometheus text by
  :func:`prometheus_text` for ``/distributed/metrics.prom``;
- request-scoped distributed tracing: a :class:`Span` model
  (``trace_id``/``span_id``/``parent_id``) whose current span rides a
  contextvar, :func:`capture_span_context`/:func:`use_span` to carry it
  onto another thread (the port's drains and pools are threads where the
  JAX package's are coroutines), the W3C ``traceparent`` helpers of the
  HTTP edges, and the bounded :class:`FlightRecorder` behind
  ``GET /distributed/trace/<prompt_id>``;
- host<->device transfer accounting (:class:`TransferStats`): the ops
  layer reports every copy between host and card through
  :func:`record_transfer`, attributed to the executing workflow node
  (:func:`node_scope`);
- the device profile: ``torch.profiler`` with the CPU and CUDA
  activities where the JAX package runs ``jax.profiler``, driven by
  ``POST /distributed/profile/start`` and ``/stop``; it writes a Chrome
  trace (``trace.json``) into the directory, where each CUDA kernel
  shows by name.

Left out, because they belong to JAX's jit: ``RetraceStats`` and
``install_jax_monitoring`` (``counters_snapshot`` keeps ``transfers``
only, and the Prometheus text has no jit-trace or XLA-compile family).
Spans and histograms are host-side Python around the device work, never
inside it: tracing on and off give the same images.
"""

from __future__ import annotations

import contextvars
import os
import threading
import time
from collections import OrderedDict
from contextlib import contextmanager
from typing import Any, Dict, List, Optional, Tuple

from comfyui_distributed_tpu_torch.utils import constants as C
from comfyui_distributed_tpu_torch.utils.log import log


class LatencyHistogram:
    """Fixed-bucket latency histogram with percentile estimation.

    Prometheus-shaped: per-bucket counts over
    :data:`constants.HISTOGRAM_BUCKETS_S` plus an overflow (+Inf) bucket,
    with sum/count/max — enough for ``_bucket``/``_sum``/``_count`` series
    AND interpolated p50/p95/p99 without storing samples (thread-safe).

    Buckets optionally carry OpenMetrics exemplars: ``record(...,
    trace_id=...)`` remembers the latest (trace_id, value, wall-clock)
    that landed in each bucket, so the ``.prom`` exposition can link a
    slow bucket straight to a flight-recorder / capture-file trace."""

    __slots__ = ("bounds", "counts", "overflow", "count", "sum_s", "max_s",
                 "exemplars", "_lock")

    def __init__(self, bounds: Tuple[float, ...] = C.HISTOGRAM_BUCKETS_S):
        self.bounds = tuple(bounds)
        self.counts = [0] * len(self.bounds)  # guarded-by: self._lock
        self.overflow = 0                     # guarded-by: self._lock
        self.count = 0                        # guarded-by: self._lock
        self.sum_s = 0.0                      # guarded-by: self._lock
        self.max_s = 0.0                      # guarded-by: self._lock
        # bucket index (len(bounds) = overflow) -> (trace_id, value, ts)
        self.exemplars: Dict[int, Tuple[str, float, float]] = {}  # guarded-by: self._lock
        self._lock = threading.Lock()

    def record(self, seconds: float,
               trace_id: Optional[str] = None) -> None:
        s = max(float(seconds), 0.0)
        with self._lock:
            self.count += 1
            self.sum_s += s
            self.max_s = max(self.max_s, s)
            idx = len(self.bounds)
            for i, le in enumerate(self.bounds):
                if s <= le:
                    self.counts[i] += 1
                    idx = i
                    break
            else:
                self.overflow += 1
            if trace_id:
                self.exemplars[idx] = (str(trace_id), s, time.time())

    def cumulative(self) -> List[Tuple[float, int]]:
        """``[(le, cumulative_count), ..., (inf, total)]`` — the
        Prometheus ``_bucket`` series."""
        return self.prom_series()[0]

    def prom_series(self) -> Tuple[List[Tuple[float, int]], float, int]:
        """``(buckets, sum, count)`` read under ONE lock acquisition —
        the Prometheus invariant (+Inf bucket == _count) must hold even
        against a concurrent record() mid-scrape."""
        with self._lock:
            out, cum = [], 0
            for le, n in zip(self.bounds, self.counts):
                cum += n
                out.append((le, cum))
            out.append((float("inf"), cum + self.overflow))
            return out, self.sum_s, self.count

    def exemplars_snapshot(self) -> Dict[int, Tuple[str, float, float]]:
        """Bucket-index -> (trace_id, value, unix_ts) under the lock."""
        with self._lock:
            return dict(self.exemplars)

    # dtpu-lint: holds[self._lock]
    def _percentile(self, q: float) -> float:
        """Caller holds the lock.  Linear interpolation inside the bucket
        holding the target rank; the overflow bucket interpolates toward
        the observed max."""
        if self.count == 0:
            return 0.0
        target = max(min(q, 1.0), 0.0) * self.count
        cum, lo = 0, 0.0
        for le, n in zip(self.bounds, self.counts):
            if n and cum + n >= target:
                frac = (target - cum) / n
                hi = min(le, self.max_s) if self.max_s > 0 else le
                return min(lo + (max(hi, lo) - lo) * frac, self.max_s)
            cum += n
            lo = le
        if self.overflow:
            frac = (target - cum) / self.overflow
            hi = max(self.max_s, lo)
            return lo + (hi - lo) * frac
        return self.max_s

    def percentile(self, q: float) -> float:
        """Estimated q-quantile (q in [0, 1])."""
        with self._lock:
            return self._percentile(q)

    def snapshot(self) -> Dict[str, float]:
        with self._lock:
            count, sum_s, max_s = self.count, self.sum_s, self.max_s
            return {"count": count, "total_s": sum_s, "max_s": max_s,
                    "mean_s": sum_s / count if count else 0.0,
                    "p50_s": self._percentile(0.50),
                    "p95_s": self._percentile(0.95),
                    "p99_s": self._percentile(0.99)}


class PhaseStats:
    """Aggregated per-phase wall-clock (thread-safe).

    Historically count/total/max only; each phase now carries a
    :class:`LatencyHistogram`, so ``snapshot()`` additionally reports
    mean and p50/p95/p99 and :meth:`histograms` feeds the Prometheus
    ``_bucket`` series.  The legacy keys (``count``/``total_s``/``max_s``)
    are kept, as the JAX package's readers expect them."""

    def __init__(self) -> None:
        self._stats: Dict[str, LatencyHistogram] = {}  # guarded-by: self._lock
        self._lock = threading.Lock()

    def _hist(self, phase: str) -> LatencyHistogram:
        with self._lock:
            h = self._stats.get(phase)
            if h is None:
                h = self._stats[phase] = LatencyHistogram()
            return h

    def record(self, phase: str, seconds: float,
               trace_id: Optional[str] = None) -> None:
        self._hist(phase).record(seconds, trace_id=trace_id)

    def snapshot(self) -> Dict[str, Dict[str, float]]:
        with self._lock:
            items = list(self._stats.items())
        return {k: h.snapshot() for k, h in items}

    def histograms(self) -> Dict[str, LatencyHistogram]:
        with self._lock:
            return dict(self._stats)

    def reset(self) -> None:
        with self._lock:
            self._stats.clear()


# process-wide sink the Timer class reports into
GLOBAL_PHASES = PhaseStats()


@contextmanager
def phase(name: str):
    t0 = time.perf_counter()
    try:
        yield
    finally:
        GLOBAL_PHASES.record(name, time.perf_counter() - t0)


# --- pipeline stage timeline -------------------------------------------------

# Per-job stage wall-clock for the overlapped serving pipeline
# (queue_wait / coalesced_batch / compute / d2h / encode / upload).
# Separate from GLOBAL_PHASES so /distributed/metrics can expose the
# pipeline timeline as its own coherent block: stage totals here overlap
# in wall-clock (that is the point), so summing them against a run's
# wall time yields a device-idle-fraction estimate.
GLOBAL_STAGES = PhaseStats()


# Per-node-type op wall-clock (the executor records every node execution
# here by class_type): the latency histogram behind the
# dtpu_node_seconds Prometheus family and the "nodes" metrics block.
GLOBAL_NODES = PhaseStats()


@contextmanager
def stage(name: str):
    """Time one pipeline stage into :data:`GLOBAL_STAGES`.

    When a request trace is active (``current_span()``), the stage is ALSO
    recorded as a child span of the same name, so the flight recorder's
    per-job tree shows exactly where the wall-clock went — the aggregate
    histogram and the per-job trace are fed by one instrumentation
    point."""
    t0 = time.perf_counter()
    sp = _begin_span(name)
    try:
        yield
    except BaseException:
        if sp is not None:
            sp.set_status("error")
        raise
    finally:
        GLOBAL_STAGES.record(name, time.perf_counter() - t0)
        _end_span(sp)


class CounterStats:
    """Named monotonic counters (thread-safe) — scheduler/wire events."""

    def __init__(self) -> None:
        self._counts: Dict[str, int] = {}  # guarded-by: self._lock
        self._lock = threading.Lock()

    def bump(self, name: str, n: int = 1) -> None:
        with self._lock:
            self._counts[name] = self._counts.get(name, 0) + int(n)

    def get(self, name: str) -> int:
        with self._lock:
            return int(self._counts.get(name, 0))

    def snapshot(self) -> Dict[str, int]:
        with self._lock:
            return dict(self._counts)

    def reset(self) -> None:
        with self._lock:
            self._counts.clear()


# coalesced_batches / coalesced_prompts / exec_runs / wire_tensor_msgs /
# wire_png_msgs / wire_bytes / tiles_skipped / preview_events /
# preview_clients / jobs_abandoned / cache_<tier>_{hits,misses,evictions}
# / cache_result_replays / cb_{admits,retires,steps,retraces,parks,
# resumes,preemptions,abandoned} ... — the scheduler, wire, reuse and
# continuous-batching layers bump, /distributed/metrics reads
GLOBAL_COUNTERS = CounterStats()


class GaugeStats:
    """Named level gauges (thread-safe) — current-state values the
    counters can't express (a monotonic bump has no "now there are N"):
    parked continuous-batching rows, residency occupancy, ...  Setters
    publish, the metrics surfaces read."""

    def __init__(self) -> None:
        self._values: Dict[str, float] = {}  # guarded-by: self._lock
        self._lock = threading.Lock()

    def set(self, name: str, value: float) -> None:
        with self._lock:
            self._values[name] = float(value)

    def get(self, name: str, default: float = 0.0) -> float:
        with self._lock:
            return float(self._values.get(name, default))

    def snapshot(self) -> Dict[str, float]:
        with self._lock:
            return dict(self._values)

    def reset(self) -> None:
        with self._lock:
            self._values.clear()


# cb_parked (continuous-batching rows parked to the host) ... — level
# views next to the monotonic counters on the same metrics surfaces.
# The continuous-batching spans of a prompt's trace
# (workflow/batch_executor.py) are instant events at its admit into a
# bucket (cb_admit), its exit (cb_exit: finished, dropped or abandoned),
# a park (cb_park) and a resume (cb_resume), and the decode tail's span
# (cb_decode); cb_admit_to_first_step is a stage histogram.
# utils/trace_analysis.py files each under its category.
GLOBAL_GAUGES = GaugeStats()


def pipeline_snapshot() -> Dict[str, Any]:
    """The serving-pipeline block of /distributed/metrics."""
    return {"stages": GLOBAL_STAGES.snapshot(),
            "counters": GLOBAL_COUNTERS.snapshot(),
            "gauges": GLOBAL_GAUGES.snapshot()}


# --- the device profile (torch.profiler) -------------------------------------
#
# ``start`` and ``stop`` arrive on different HTTP handler threads while
# the kernels launch on the execution thread, and torch's profiler is
# entered and left on one thread: it runs on a thread of its own here,
# one process-wide profile under the module's lock.  The CUDA activity is
# collected for the whole device, whichever thread launches.

_trace_lock = threading.Lock()
_trace_dir: Optional[str] = None           # guarded-by: _trace_lock
_trace_run: Optional["_ProfileRun"] = None  # guarded-by: _trace_lock

TRACE_FILE = "trace.json"


class _ProfileRun:
    """One ``torch.profiler.profile`` held open on its own thread until
    :meth:`finish`, which writes the Chrome trace into ``out_dir``."""

    def __init__(self, out_dir: str):
        self.out_dir = out_dir
        self._started = threading.Event()
        self._stop = threading.Event()
        self._done = threading.Event()
        self.error: Optional[Exception] = None
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="dtpu-profiler")

    def start(self) -> None:
        self._thread.start()
        self._started.wait()
        if self.error is not None:
            raise RuntimeError(f"profiler did not start: {self.error}")

    def _run(self) -> None:
        import torch
        from torch.profiler import ProfilerActivity, profile
        try:
            acts = [ProfilerActivity.CPU]
            if torch.cuda.is_available():
                acts.append(ProfilerActivity.CUDA)
            kw: Dict[str, Any] = {}
            try:
                # every thread's CPU ops, where this torch offers it; the
                # CUDA kernels are collected device-wide either way
                from torch._C._profiler import _ExperimentalConfig
                kw["experimental_config"] = _ExperimentalConfig(
                    profile_all_threads=True)
            except (ImportError, TypeError):
                pass
            prof = profile(activities=acts, **kw)
            prof.__enter__()
        except Exception as e:  # noqa: BLE001 - reported to start()
            self.error = e
            return
        finally:
            self._started.set()
        self._stop.wait()
        try:
            prof.__exit__(None, None, None)
            prof.export_chrome_trace(os.path.join(self.out_dir, TRACE_FILE))
        except Exception as e:  # noqa: BLE001 - reported to finish()
            self.error = e
        finally:
            self._done.set()

    def finish(self, timeout: float = 600.0) -> None:
        self._stop.set()
        if not self._done.wait(timeout):
            raise RuntimeError("profiler did not stop in time")
        if self.error is not None:
            raise RuntimeError(f"profiler stop failed: {self.error}")


def start_device_trace(out_dir: Optional[str] = None) -> str:
    """Begin a ``torch.profiler`` trace (CPU and, on a card, CUDA
    activity) that :func:`stop_device_trace` writes to
    ``<out_dir>/trace.json``."""
    global _trace_dir, _trace_run
    with _trace_lock:
        if _trace_dir is not None:
            raise RuntimeError(f"trace already running -> {_trace_dir}")
        out_dir = out_dir or os.path.join(
            os.getcwd(), "traces", time.strftime("%Y%m%d-%H%M%S"))
        os.makedirs(out_dir, exist_ok=True)
        run = _ProfileRun(out_dir)
        run.start()
        _trace_run, _trace_dir = run, out_dir
        log(f"device trace started -> {out_dir}")
        return out_dir


def stop_device_trace() -> str:
    global _trace_dir, _trace_run
    with _trace_lock:
        if _trace_dir is None:
            raise RuntimeError("no trace running")
        out, run = _trace_dir, _trace_run
        try:
            run.finish()
        finally:
            # a raising stop must still clear the state: leaving
            # _trace_dir set would refuse every later start with "trace
            # already running" for the life of the process
            _trace_dir, _trace_run = None, None
        log(f"device trace stopped -> {out}")
        return out


def trace_status() -> Dict[str, Any]:
    with _trace_lock:
        return {"running": _trace_dir is not None, "dir": _trace_dir}


@contextmanager
def device_trace(out_dir: Optional[str] = None):
    d = start_device_trace(out_dir)
    try:
        yield d
    finally:
        stop_device_trace()


# --- host<->device transfer accounting ---------------------------------------

class TransferStats:
    """Per-label host<->device transfer byte/call counters (thread-safe).

    Labels are workflow node ids when a :func:`node_scope` is active,
    ``"_unattributed"`` otherwise.  Directions: ``d2h`` (device fetch —
    the expensive edge the tensor plane exists to eliminate) and ``h2d``
    (host put)."""

    def __init__(self) -> None:
        self._stats: Dict[str, Dict[str, float]] = {}  # guarded-by: self._lock
        self._lock = threading.Lock()

    def record(self, direction: str, nbytes: int,
               label: Optional[str] = None) -> None:
        key = label or "_unattributed"
        with self._lock:
            s = self._stats.setdefault(
                key, {"d2h_bytes": 0, "d2h_calls": 0,
                      "h2d_bytes": 0, "h2d_calls": 0})
            s[f"{direction}_bytes"] += int(nbytes)
            s[f"{direction}_calls"] += 1

    def snapshot(self) -> Dict[str, Dict[str, float]]:
        with self._lock:
            return {k: dict(v) for k, v in self._stats.items()}

    def total(self, direction: str) -> int:
        with self._lock:
            return sum(int(v[f"{direction}_bytes"])
                       for v in self._stats.values())

    def reset(self) -> None:
        with self._lock:
            self._stats.clear()


# process-wide sink (feeds /distributed/metrics); executors push a per-run
# sink on top so ExecutionResult can report per-node transfers for just
# that run
GLOBAL_TRANSFERS = TransferStats()

_transfer_state = threading.local()


def _sinks() -> List[TransferStats]:
    return getattr(_transfer_state, "sinks", None) or []


@contextmanager
def transfer_sink(sink: TransferStats):
    """Additionally record this thread's transfers into ``sink`` (the
    executor's per-run accounting)."""
    stack = getattr(_transfer_state, "sinks", None)
    if stack is None:
        stack = _transfer_state.sinks = []
    stack.append(sink)
    try:
        yield sink
    finally:
        stack.remove(sink)


@contextmanager
def node_scope(node_id: str):
    """Attribute transfers recorded inside the block to a workflow node."""
    prev = getattr(_transfer_state, "node", None)
    _transfer_state.node = str(node_id)
    try:
        yield
    finally:
        _transfer_state.node = prev


def current_node() -> Optional[str]:
    return getattr(_transfer_state, "node", None)


def capture_transfer_context() -> tuple:
    """Snapshot this thread's transfer attribution (node label + per-run
    sinks) so deferred host work keeps reporting into the run that
    spawned it.  The sinks/node state is thread-local; without this, a
    d2h fetch moved onto the encoder pool would vanish from the
    run-local ``ExecutionResult.transfers`` ledger."""
    return (current_node(), list(_sinks()))


@contextmanager
def transfer_context(captured: tuple):
    """Re-enter a :func:`capture_transfer_context` snapshot on another
    thread (the host-IO pool's worker)."""
    node, sinks = captured
    prev_node = getattr(_transfer_state, "node", None)
    stack = getattr(_transfer_state, "sinks", None)
    if stack is None:
        stack = _transfer_state.sinks = []
    added = [s for s in sinks if s not in stack]
    stack.extend(added)
    _transfer_state.node = node
    try:
        yield
    finally:
        _transfer_state.node = prev_node
        for s in added:
            stack.remove(s)


def record_transfer(direction: str, nbytes: int) -> None:
    """Report one host<->device edge (``direction`` in {"d2h", "h2d"}) from
    the ops layer; attribution and per-run fan-out happen here."""
    label = current_node()
    GLOBAL_TRANSFERS.record(direction, nbytes, label)
    for sink in _sinks():
        sink.record(direction, nbytes, label)


def counters_snapshot() -> Dict[str, Any]:
    """The transfer payload of /distributed/metrics."""
    return {"transfers": GLOBAL_TRANSFERS.snapshot()}


# --- request-scoped distributed tracing (spans) ------------------------------
#
# Dapper-lite: always-on, low-overhead, propagated through RPC metadata.
# A span is a named timed interval with a trace_id shared by every span of
# one job (across processes) and a parent_id forming the tree.  The
# current span rides a contextvar — correct across task
# boundaries (each task gets a context copy at creation) and explicit
# across thread handoffs via capture_span_context()/use_span(), the span
# analog of capture_transfer_context.

_tracing_enabled = os.environ.get(C.TRACE_ENV, "1").lower() \
    not in ("0", "false", "off")


def set_tracing(enabled: bool) -> None:
    """Process-wide span-creation switch (env ``DTPU_TRACE`` start value).
    Aggregate metrics (phases/stages/counters) are unaffected — this
    gates only the per-request span machinery."""
    global _tracing_enabled
    _tracing_enabled = bool(enabled)


def tracing_enabled() -> bool:
    return _tracing_enabled


def new_trace_id() -> str:
    return os.urandom(16).hex()


def new_span_id() -> str:
    return os.urandom(8).hex()


class Span:
    """One timed interval of a request trace.

    ``parent`` is the in-process parent Span (None for a local root);
    ``parent_id`` may be set without a parent object when the parent
    lives in another process (the inbound traceparent case)."""

    __slots__ = ("trace_id", "span_id", "parent", "parent_id", "name",
                 "attrs", "start_s", "end_s", "status", "error", "_token")

    def __init__(self, name: str, trace_id: Optional[str] = None,
                 parent: Optional["Span"] = None,
                 parent_id: Optional[str] = None,
                 attrs: Optional[Dict[str, Any]] = None):
        self.name = str(name)
        self.parent = parent
        if parent is not None:
            self.trace_id = parent.trace_id
            self.parent_id = parent.span_id
        else:
            self.trace_id = trace_id or new_trace_id()
            self.parent_id = parent_id
        self.span_id = new_span_id()
        self.attrs: Dict[str, Any] = dict(attrs or {})
        self.start_s = time.time()
        self.end_s: Optional[float] = None
        self.status = "ok"
        self.error: Optional[str] = None
        self._token: Any = None  # contextvar token while current

    def set_status(self, status: str, error: Optional[str] = None) -> None:
        self.status = status
        if error is not None:
            self.error = str(error)[:500]

    def end(self, status: Optional[str] = None) -> None:
        if self.end_s is not None:
            return  # idempotent: double-end keeps the first timing
        if status is not None:
            self.status = status
        self.end_s = time.time()
        GLOBAL_TRACES.on_end(self)

    def to_dict(self, provisional: bool = False) -> Dict[str, Any]:
        end = self.end_s if self.end_s is not None else time.time()
        d = {"trace_id": self.trace_id, "span_id": self.span_id,
             "parent_id": self.parent_id, "name": self.name,
             "start_s": round(self.start_s, 6), "end_s": round(end, 6),
             "duration_s": round(end - self.start_s, 6),
             "status": self.status}
        if self.attrs:
            d["attrs"] = dict(self.attrs)
        if self.error:
            d["error"] = self.error
        if provisional and self.end_s is None:
            d["provisional"] = True
        return d


_SPAN_VAR: "contextvars.ContextVar[Optional[Span]]" = \
    contextvars.ContextVar("dtpu_current_span", default=None)


def current_span() -> Optional[Span]:
    return _SPAN_VAR.get()


def current_trace_ids() -> Optional[Dict[str, str]]:
    """``{"trace_id", "span_id", "prompt_id"?}`` for the active span — the
    correlation fields the JSON log mode stamps on every line."""
    sp = _SPAN_VAR.get()
    if sp is None:
        return None
    out = {"trace_id": sp.trace_id, "span_id": sp.span_id}
    node: Optional[Span] = sp
    while node is not None:
        pid = node.attrs.get("prompt_id")
        if pid:
            out["prompt_id"] = str(pid)
            break
        node = node.parent
    return out


def start_span(name: str, trace_id: Optional[str] = None,
               parent: Optional[Span] = None,
               parent_id: Optional[str] = None,
               attrs: Optional[Dict[str, Any]] = None) -> Optional[Span]:
    """Open a span (a root when no parent is given).  Returns None with
    tracing disabled — every consumer treats the span as optional."""
    if not _tracing_enabled:
        return None
    sp = Span(name, trace_id=trace_id, parent=parent, parent_id=parent_id,
              attrs=attrs)
    GLOBAL_TRACES.on_start(sp)
    return sp


def _begin_span(name: str, **attrs: Any) -> Optional[Span]:
    """Child of the current span, set as current; None when no trace is
    active (stray stages outside a job never create orphan spans)."""
    parent = _SPAN_VAR.get()
    if parent is None or not _tracing_enabled:
        return None
    sp = Span(name, parent=parent, attrs=attrs or None)
    GLOBAL_TRACES.on_start(sp)
    sp._token = _SPAN_VAR.set(sp)
    return sp


def _end_span(sp: Optional[Span]) -> None:
    if sp is None:
        return
    token, sp._token = sp._token, None
    if token is not None:
        try:
            _SPAN_VAR.reset(token)
        except ValueError:
            # reset from a different context (thread/task migrated the
            # span) — clearing by value keeps the var consistent
            if _SPAN_VAR.get() is sp:
                _SPAN_VAR.set(sp.parent)
    sp.end()


@contextmanager
def span(name: str, **attrs: Any):
    """Child span of the current span, current within the block; yields
    None (and records nothing) when no trace is active."""
    sp = _begin_span(name, **attrs)
    try:
        yield sp
    except BaseException as e:
        if sp is not None:
            sp.set_status("error", repr(e))
        raise
    finally:
        _end_span(sp)


@contextmanager
def use_span(sp: Optional[Span]):
    """Make ``sp`` the current span for the block WITHOUT ending it on
    exit (the span's owner ends it) — the reattach half of the
    cross-thread handoff, and how the exec loop parents a run under the
    job span created at enqueue time."""
    if sp is None:
        yield None
        return
    token = _SPAN_VAR.set(sp)
    try:
        yield sp
    finally:
        _SPAN_VAR.reset(token)


def capture_span_context() -> Optional[Span]:
    """Snapshot this thread's/task's span context for reattachment on
    another thread (``with use_span(captured): ...``) — mirrors
    :func:`capture_transfer_context` for a pool thread's handoff."""
    return _SPAN_VAR.get()


def event_span(name: str, start_s: float, end_s: float,
               parent: Optional[Span] = None,
               trace_id: Optional[str] = None,
               parent_id: Optional[str] = None,
               attrs: Optional[Dict[str, Any]] = None,
               status: str = "ok") -> Optional[Dict[str, Any]]:
    """Record an already-finished interval as a span (queue_wait measured
    at pop time, an inbound upload measured by the handler).  Accepts a
    parent Span or raw (trace_id, parent_id) for remote parents."""
    if not _tracing_enabled:
        return None
    if parent is not None:
        trace_id, parent_id = parent.trace_id, parent.span_id
    if not trace_id:
        return None
    d = {"trace_id": trace_id, "span_id": new_span_id(),
         "parent_id": parent_id, "name": str(name),
         "start_s": round(start_s, 6), "end_s": round(end_s, 6),
         "duration_s": round(max(end_s - start_s, 0.0), 6),
         "status": status}
    if attrs:
        d["attrs"] = dict(attrs)
    GLOBAL_TRACES.add(trace_id, d)
    return d


# --- W3C traceparent (the propagation header) --------------------------------

def format_traceparent(sp: Span) -> str:
    """``00-<trace_id>-<span_id>-01`` (W3C trace-context, sampled)."""
    return f"00-{sp.trace_id}-{sp.span_id}-01"


def traceparent_headers(sp: Optional[Span] = None) -> Dict[str, str]:
    """Headers dict carrying the current (or given) span's traceparent;
    empty when no trace is active — callers merge unconditionally."""
    sp = sp if sp is not None else _SPAN_VAR.get()
    if sp is None or not _tracing_enabled:
        return {}
    return {C.TRACEPARENT_HEADER: format_traceparent(sp)}


def parse_traceparent(header: Optional[str]
                      ) -> Optional[Tuple[str, str]]:
    """``(trace_id, parent_span_id)`` from a traceparent header, or None
    on anything malformed (propagation must never fail a request)."""
    if not header:
        return None
    parts = str(header).strip().split("-")
    if len(parts) < 4:
        return None
    _, trace_id, span_id = parts[0], parts[1], parts[2]
    if len(trace_id) != 32 or len(span_id) != 16:
        return None
    try:
        int(trace_id, 16), int(span_id, 16)
    except ValueError:
        return None
    if trace_id == "0" * 32 or span_id == "0" * 16:
        return None
    return trace_id, span_id


# --- flight recorder ---------------------------------------------------------

class FlightRecorder:
    """Bounded ring of recent completed job traces + the accumulation
    buffer for in-flight ones.

    Spans land here as they finish (``on_end``) or arrive from a peer
    (``ingest`` — the worker ships its spans on the final data-plane
    POST); ``commit(prompt_id, trace_id)`` moves a trace into the ring
    when its job finalizes.  Late arrivals for a committed trace are
    appended to the ring entry, so a straggler tile's spans still reach
    the postmortem.  Everything is bounded: spans per trace
    (``TRACE_MAX_SPANS``), in-flight traces, and the ring itself
    (``DTPU_TRACE_RING``)."""

    def __init__(self, max_traces: Optional[int] = None,
                 max_spans: int = C.TRACE_MAX_SPANS):
        self._lock = threading.Lock()
        self.max_traces = max_traces if max_traces is not None else \
            max(1, int(os.environ.get(C.TRACE_RING_ENV,
                                      C.TRACE_RING_DEFAULT)))
        self.max_spans = max_spans
        # trace_id -> {span_id: span dict} for in-flight traces
        self._active: "OrderedDict[str, Dict[str, Dict]]" = \
            OrderedDict()                       # guarded-by: self._lock
        # trace_id -> [open Span] (exported provisionally mid-flight)
        self._open: Dict[str, List[Span]] = {}  # guarded-by: self._lock
        # prompt_id -> committed record (the ring)
        self._jobs: "OrderedDict[str, Dict[str, Any]]" = \
            OrderedDict()                       # guarded-by: self._lock
        # committed trace -> prompt
        self._by_trace: Dict[str, str] = {}     # guarded-by: self._lock
        self.dropped_spans = 0                  # guarded-by: self._lock
        self.evictions = 0                      # guarded-by: self._lock

    # -- span sinks ---------------------------------------------------------

    def on_start(self, sp: Span) -> None:
        with self._lock:
            self._open.setdefault(sp.trace_id, []).append(sp)

    def on_end(self, sp: Span) -> None:
        with self._lock:
            opens = self._open.get(sp.trace_id)
            if opens is not None:
                try:
                    opens.remove(sp)
                except ValueError:
                    pass
                if not opens:
                    del self._open[sp.trace_id]
        self.add(sp.trace_id, sp.to_dict())

    def add(self, trace_id: str, span_dict: Dict[str, Any]) -> None:
        """Insert/replace one span dict (keyed by span_id: a provisional
        remote span is superseded by its final version)."""
        with self._lock:
            pid = self._by_trace.get(trace_id)
            if pid is not None:
                rec = self._jobs.get(pid)
                if rec is not None and (
                        span_dict["span_id"] in rec["_ids"]
                        or len(rec["spans"]) < self.max_spans):
                    if span_dict["span_id"] in rec["_ids"]:
                        rec["spans"] = [span_dict
                                        if s["span_id"] ==
                                        span_dict["span_id"] else s
                                        for s in rec["spans"]]
                    else:
                        rec["spans"].append(span_dict)
                        rec["_ids"].add(span_dict["span_id"])
                else:
                    self.dropped_spans += 1
                return
            spans = self._active.get(trace_id)
            if spans is None:
                # bound the in-flight buffer too: a flood of orphan
                # traces (e.g. remote spans for jobs this process never
                # commits) must not grow without limit
                while len(self._active) >= 4 * self.max_traces:
                    self._active.popitem(last=False)
                spans = self._active[trace_id] = {}
            if span_dict["span_id"] in spans \
                    or len(spans) < self.max_spans:
                spans[span_dict["span_id"]] = span_dict
            else:
                self.dropped_spans += 1

    def ingest(self, span_dicts: List[Dict[str, Any]]) -> int:
        """Merge spans shipped from a peer process (dicts with their own
        trace_id); malformed entries are skipped, count kept is
        returned."""
        kept = 0
        for d in span_dicts or []:
            if not isinstance(d, dict):
                continue
            tid, sid = d.get("trace_id"), d.get("span_id")
            if not tid or not sid:
                continue
            self.add(str(tid), d)
            kept += 1
        return kept

    def export(self, trace_id: str,
               include_open: bool = True) -> List[Dict[str, Any]]:
        """The trace's spans as dicts — finished ones plus (optionally)
        still-open ones with a provisional end, for shipping to the
        master before the local job span closes."""
        with self._lock:
            pid = self._by_trace.get(trace_id)
            if pid is not None and pid in self._jobs:
                out = list(self._jobs[pid]["spans"])
            else:
                out = list(self._active.get(trace_id, {}).values())
            opens = list(self._open.get(trace_id, ())) if include_open \
                else []
        out.extend(sp.to_dict(provisional=True) for sp in opens)
        return out

    # -- job lifecycle ------------------------------------------------------

    def commit(self, prompt_id: str, trace_id: str, status: str = "ok",
               root_span_id: Optional[str] = None,
               duration_s: Optional[float] = None) -> None:
        """Seal a job's trace into the ring under its prompt id.

        A trace_id may legitimately commit under more than one prompt id
        in ONE process (single-process loopback: the worker-role job and
        the master's fan-out job share the trace and the recorder) — the
        later commit absorbs the earlier record's spans so whichever
        prompt id the client holds resolves to the full tree."""
        evicted_total = 0
        with self._lock:
            by_id = dict(self._active.pop(trace_id, {}))
            prev_pid = self._by_trace.get(trace_id)
            if prev_pid is not None and prev_pid != str(prompt_id):
                prev = self._jobs.get(prev_pid)
                if prev is not None:
                    for s in prev["spans"]:
                        by_id.setdefault(s["span_id"], s)
            spans = list(by_id.values())
            rec = {"prompt_id": str(prompt_id), "trace_id": trace_id,
                   "status": status, "root_span_id": root_span_id,
                   "duration_s": duration_s, "finished_at": time.time(),
                   "spans": spans,
                   "_ids": set(by_id)}
            self._jobs[str(prompt_id)] = rec
            self._jobs.move_to_end(str(prompt_id))
            self._by_trace[trace_id] = str(prompt_id)
            # snapshot for the exporter inside the lock: a late-arrival
            # add() may mutate rec["spans"] the moment we release
            export_rec = {k: v for k, v in rec.items() if k != "_ids"}
            export_rec["spans"] = list(spans)
            while len(self._jobs) > self.max_traces:
                _, old = self._jobs.popitem(last=False)
                # only unmap the trace if the mapping still points at the
                # evicted record: after a dual-commit (loopback), the
                # newer prompt's record owns the mapping and must keep
                # receiving late arrivals
                if self._by_trace.get(old["trace_id"]) \
                        == old["prompt_id"]:
                    self._by_trace.pop(old["trace_id"], None)
                self.evictions += 1
                evicted_total = self.evictions
        if evicted_total:
            GLOBAL_COUNTERS.bump("trace_evictions")
            # no-silent-caps: the ring forgetting history is normal but
            # must be visible — one line per N, not one per trace
            if evicted_total % C.TRACE_EVICT_LOG_EVERY == 0:
                log(f"flight recorder: {evicted_total} committed traces "
                    f"evicted from the {self.max_traces}-entry ring "
                    f"(raise {C.TRACE_RING_ENV} or set "
                    f"{C.TRACE_EXPORT_DIR_ENV} for durable capture)")
        # durable capture plane: committed traces stream to
        # the capture files; a no-op unless DTPU_TRACE_EXPORT_DIR is set.
        # It runs on the committing thread, outside the recorder lock —
        # the exporter has its own.
        from comfyui_distributed_tpu_torch.utils import trace_export
        trace_export.on_commit(export_rec)
        # critical-path analytics plane: armed only while a
        # baseline profile is configured; disarmed it costs one env read
        from comfyui_distributed_tpu_torch.utils import trace_analysis
        trace_analysis.on_commit(export_rec)

    def get(self, prompt_id: str) -> Optional[Dict[str, Any]]:
        with self._lock:
            rec = self._jobs.get(str(prompt_id))
            if rec is None:
                return None
            out = {k: v for k, v in rec.items() if k != "_ids"}
            out["spans"] = sorted(rec["spans"],
                                  key=lambda s: s.get("start_s", 0.0))
            out["n_spans"] = len(out["spans"])
            return out

    def index(self) -> List[Dict[str, Any]]:
        """Newest-first job summaries for ``GET /distributed/traces``."""
        with self._lock:
            return [{"prompt_id": rec["prompt_id"],
                     "trace_id": rec["trace_id"],
                     "status": rec["status"],
                     "duration_s": rec["duration_s"],
                     "finished_at": rec["finished_at"],
                     "n_spans": len(rec["spans"])}
                    for rec in reversed(self._jobs.values())]

    def records(self) -> List[Dict[str, Any]]:
        """All committed job records, oldest first, shaped like
        :meth:`get` (sorted span-dict lists) — the cross-trace
        analytics plane's bulk read."""
        with self._lock:
            out = []
            for rec in self._jobs.values():
                r = {k: v for k, v in rec.items() if k != "_ids"}
                r["spans"] = sorted(rec["spans"],
                                    key=lambda s: s.get("start_s", 0.0))
                out.append(r)
            return out

    def breakdown(self, trace_id: str) -> Dict[str, float]:
        """Per-span-name total seconds for one trace — the slow-job log's
        one-line stage summary."""
        out: Dict[str, float] = {}
        for s in self.export(trace_id, include_open=False):
            out[s["name"]] = round(
                out.get(s["name"], 0.0) + float(s.get("duration_s", 0.0)),
                6)
        return out

    def size(self) -> int:
        with self._lock:
            return len(self._jobs)

    def eviction_count(self) -> int:
        with self._lock:
            return self.evictions

    def reset(self) -> None:
        with self._lock:
            self._active.clear()
            self._open.clear()
            self._jobs.clear()
            self._by_trace.clear()
            self.dropped_spans = 0
            self.evictions = 0


GLOBAL_TRACES = FlightRecorder()


def build_span_tree(spans: List[Dict[str, Any]]) -> List[Dict[str, Any]]:
    """Nest span dicts by parent_id: returns the root list, each node a
    copy with a ``children`` list (start-time ordered).  Spans whose
    parent is unknown (a remote hop that never shipped) surface as
    additional roots rather than vanishing."""
    nodes = {s["span_id"]: {**s, "children": []}
             for s in sorted(spans, key=lambda s: s.get("start_s", 0.0))}
    roots: List[Dict[str, Any]] = []
    for node in nodes.values():
        parent = nodes.get(node.get("parent_id") or "")
        if parent is not None and parent is not node:
            parent["children"].append(node)
        else:
            roots.append(node)
    return roots


# --- Prometheus text exposition ----------------------------------------------

def _prom_escape(value: Any) -> str:
    return (str(value).replace("\\", r"\\").replace("\n", r"\n")
            .replace('"', r'\"'))


def _prom_labels(labels: Dict[str, Any]) -> str:
    if not labels:
        return ""
    inner = ",".join(f'{k}="{_prom_escape(v)}"'
                     for k, v in sorted(labels.items()))
    return "{" + inner + "}"


def _prom_num(v: float) -> str:
    f = float(v)
    if f == int(f) and abs(f) < 1e15:
        return str(int(f))
    return repr(f)


def _render_histogram_family(lines: List[str], family: str, help_text: str,
                             stats: PhaseStats, label_key: str) -> None:
    hists = stats.histograms()
    lines.append(f"# HELP {family} {help_text}")
    lines.append(f"# TYPE {family} histogram")
    for name in sorted(hists):
        base = {label_key: name}
        h = hists[name]
        buckets, sum_s, count = h.prom_series()
        exemplars = h.exemplars_snapshot()
        for i, (le, cum) in enumerate(buckets):
            le_s = "+Inf" if le == float("inf") else _prom_num(le)
            line = (f"{family}_bucket"
                    f"{_prom_labels({**base, 'le': le_s})} {cum}")
            ex = exemplars.get(i)
            if ex is not None:
                # OpenMetrics exemplar: the last sample that landed in
                # THIS (non-cumulative) bucket, linking it to a trace
                tid, val, ts = ex
                line += (f' # {{trace_id="{_prom_escape(tid)}"}} '
                         f"{_prom_num(val)} {round(ts, 3)}")
            lines.append(line)
        lines.append(f"{family}_sum{_prom_labels(base)} {repr(sum_s)}")
        lines.append(f"{family}_count{_prom_labels(base)} {count}")


def prometheus_text(extra: Optional[List[Tuple[str, str, str,
                                               List[Tuple[Dict, float]]]]]
                    = None) -> str:
    """Render the telemetry state as Prometheus text exposition format
    (v0.0.4): stage/phase/node latency histograms (``_bucket``/``_sum``/
    ``_count``), event counters, transfer byte counters and the
    flight-recorder gauges (the JAX package's jit-trace and XLA-compile
    counters have no counterpart here).  ``extra`` adds
    caller families as ``(name, type, help, [(labels, value), ...])`` —
    the server layer appends its prompt/image counters and queue gauge."""
    lines: List[str] = []
    _render_histogram_family(
        lines, "dtpu_stage_seconds",
        "Serving-pipeline stage wall-clock (overlapping stages).",
        GLOBAL_STAGES, "stage")
    _render_histogram_family(
        lines, "dtpu_phase_seconds",
        "Internal phase wall-clock (Timer sink).",
        GLOBAL_PHASES, "phase")
    _render_histogram_family(
        lines, "dtpu_node_seconds",
        "Per-workflow-node-type op execution seconds.",
        GLOBAL_NODES, "node_type")

    lines.append("# HELP dtpu_events_total Scheduler/wire/pipeline event "
                 "counters.")
    lines.append("# TYPE dtpu_events_total counter")
    for name, value in sorted(GLOBAL_COUNTERS.snapshot().items()):
        lines.append(f"dtpu_events_total{_prom_labels({'event': name})} "
                     f"{int(value)}")

    lines.append("# HELP dtpu_transfer_bytes_total Host<->device transfer "
                 "bytes by direction.")
    lines.append("# TYPE dtpu_transfer_bytes_total counter")
    for direction in ("d2h", "h2d"):
        lines.append(
            f"dtpu_transfer_bytes_total"
            f"{_prom_labels({'direction': direction})} "
            f"{GLOBAL_TRANSFERS.total(direction)}")

    lines.append("# HELP dtpu_trace_ring_size Completed job traces held "
                 "by the flight recorder.")
    lines.append("# TYPE dtpu_trace_ring_size gauge")
    lines.append(f"dtpu_trace_ring_size {GLOBAL_TRACES.size()}")

    lines.append("# HELP dtpu_trace_evictions_total Committed traces "
                 "pushed out of the flight-recorder ring.")
    lines.append("# TYPE dtpu_trace_evictions_total counter")
    lines.append(f"dtpu_trace_evictions_total "
                 f"{GLOBAL_TRACES.eviction_count()}")

    _append_prom_families(lines, extra or [])
    return "\n".join(lines) + "\n"


def _append_prom_families(lines: List[str],
                          families: List[Tuple[str, str, str,
                                               List[Tuple[Dict, float]]]]
                          ) -> None:
    for name, typ, help_text, samples in families:
        lines.append(f"# HELP {name} {help_text}")
        lines.append(f"# TYPE {name} {typ}")
        for labels, value in samples:
            lines.append(f"{name}{_prom_labels(labels)} {_prom_num(value)}")


def render_prom_families(families: List[Tuple[str, str, str,
                                              List[Tuple[Dict, float]]]]
                         ) -> str:
    """Standalone Prometheus text for caller-supplied families only (the
    federated cluster exposition renders fleet gauges without duplicating
    this process's histograms)."""
    lines: List[str] = []
    _append_prom_families(lines, families)
    return "\n".join(lines) + "\n"


def reset_aggregate_metrics() -> Dict[str, Any]:
    """POST /distributed/metrics/reset core: clear the process-wide
    aggregate sinks (phases, stages, node timings, counters, transfers)
    so multi-phase runs stop inheriting cross-run
    telemetry.  The flight recorder keeps its per-job history unless
    asked."""
    before = {"phases": len(GLOBAL_PHASES.snapshot()),
              "stages": len(GLOBAL_STAGES.snapshot()),
              "nodes": len(GLOBAL_NODES.snapshot()),
              "counters": len(GLOBAL_COUNTERS.snapshot()),
              "transfer_labels": len(GLOBAL_TRANSFERS.snapshot())}
    GLOBAL_PHASES.reset()
    GLOBAL_STAGES.reset()
    GLOBAL_NODES.reset()
    GLOBAL_COUNTERS.reset()
    GLOBAL_TRANSFERS.reset()
    return before
