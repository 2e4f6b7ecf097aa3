"""Resource telemetry: the counterpart of
``comfyui_distributed_tpu/utils/resource.py``.

- :func:`device_memory_snapshot`: on a card, ``torch.cuda.memory_stats``
  (bytes allocated now and their peak) and ``torch.cuda.mem_get_info``
  (the card's total) summed over the visible cards, where the JAX
  package walks ``jax.local_devices()``; on the CPU this process's
  resident bytes (``source: "host_rss"``), as the JAX package reports a
  backend without memory stats;
- :func:`host_rss_bytes`: psutil, else ``/proc/self/statm``, else the
  peak from ``getrusage``;
- :class:`RingTimeseries`: a bounded (t, value) ring a series;
- :class:`ResourceMonitor`: a daemon thread (``DTPU_RES_INTERVAL_S``)
  sampling device memory, host RSS, the queue depth and a utilization
  estimate into the rings.  The utilization is the JAX package's: the
  ``compute`` stage's seconds over the sample interval;
- :func:`fleet_sample`: the snapshot a heartbeat carries to the master;
- :func:`resource_prom_families`: the gauge families of
  ``/distributed/metrics.prom`` (unlabelled) and of the federated
  ``/distributed/cluster/metrics.prom`` (``worker_id``-labelled);
- :func:`describe_devices`: the device view of ``/distributed/status``
  and ``cli devices``.

``cache_bytes`` is the reuse plane's residency over its three tiers
(``runtime/reuse.cache_bytes_total``).
"""

from __future__ import annotations

import os
import resource as _res
import threading
import time
from collections import deque
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

from comfyui_distributed_tpu_torch.utils import constants as C
from comfyui_distributed_tpu_torch.utils.log import debug_log

try:
    import psutil
except ImportError:
    psutil = None

# series names every monitor samples (rings + gauges + prom families)
SERIES = ("device_bytes_in_use", "device_peak_bytes", "host_rss_bytes",
          "utilization", "queue_depth", "cache_bytes")


# --- probes ------------------------------------------------------------------

def host_rss_bytes() -> int:
    """This process's resident set size: psutil where installed, else
    ``/proc/self/statm``, else the peak from ``getrusage``."""
    if psutil is not None:
        return int(psutil.Process().memory_info().rss)
    try:
        with open("/proc/self/statm", "r", encoding="ascii") as f:
            return int(f.read().split()[1]) * os.sysconf("SC_PAGE_SIZE")
    except (OSError, ValueError, IndexError):
        # ru_maxrss: the peak, in KB on Linux
        return host_rss_peak_bytes()


def host_rss_peak_bytes() -> int:
    """Peak RSS (``ru_maxrss``), the host-side high-water mark."""
    return int(_res.getrusage(_res.RUSAGE_SELF).ru_maxrss) * 1024


def _on_cuda(device: Optional[str]) -> bool:
    if device is None:
        return torch.cuda.is_available()
    return torch.device(device).type == "cuda"


def device_memory_snapshot(device: Optional[str] = None) -> Dict[str, Any]:
    """``{"bytes_in_use", "peak_bytes_in_use", "bytes_limit",
    "n_devices", "source"}`` for ``device`` (None: a card when torch sees
    one).  On ``cuda``: torch's allocated bytes, their peak and each
    card's total, summed over the visible cards (``source:
    "memory_stats"``).  On the CPU the device's memory is the host's:
    this process's resident bytes (``source: "host_rss"``)."""
    if _on_cuda(device):
        in_use = peak = limit = 0
        n = torch.cuda.device_count()
        for i in range(n):
            ms = torch.cuda.memory_stats(i)
            in_use += int(ms.get("allocated_bytes.all.current", 0))
            peak += int(ms.get("allocated_bytes.all.peak", 0))
            limit += int(torch.cuda.mem_get_info(i)[1])
        return {"bytes_in_use": in_use, "peak_bytes_in_use": peak,
                "bytes_limit": limit or None, "n_devices": n,
                "source": "memory_stats"}
    rss = host_rss_bytes()
    return {"bytes_in_use": rss,
            "peak_bytes_in_use": max(host_rss_peak_bytes(), rss),
            "bytes_limit": None, "n_devices": 0, "source": "host_rss"}


def describe_devices(device: str = "cuda") -> Dict[str, Any]:
    """The devices a server on ``device`` runs on, with the keys of the
    JAX package's ``describe_devices``: ``platform`` (``gpu``, ``cpu``,
    or ``none`` when torch sees no card), ``num_devices``,
    ``num_local_devices``, ``num_processes``, ``process_index`` and
    ``devices`` (``id``, ``platform``, ``kind``, ``process_index``
    each).  Nothing is computed on a device."""
    if torch.device(device).type == "cuda":
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        devices = [{"id": i, "platform": "gpu",
                    "kind": torch.cuda.get_device_name(i),
                    "process_index": 0} for i in range(n)]
    else:
        devices = [{"id": 0, "platform": "cpu", "kind": "cpu",
                    "process_index": 0}]
    return {"platform": devices[0]["platform"] if devices else "none",
            "num_devices": len(devices), "num_local_devices": len(devices),
            "num_processes": 1, "process_index": 0, "devices": devices}


def _cache_bytes() -> int:
    """Bytes in the cross-request reuse caches (0 before any was made)."""
    from comfyui_distributed_tpu_torch.runtime.reuse import cache_bytes_total
    return cache_bytes_total()


def snapshot_now(queue_depth: Optional[int] = None,
                 utilization: Optional[float] = None,
                 device: Optional[str] = None) -> Dict[str, Any]:
    """One full resource sample (the heartbeat/federation wire shape)."""
    mem = device_memory_snapshot(device)
    return {
        "t": time.time(),
        "device_bytes_in_use": mem["bytes_in_use"],
        "device_peak_bytes": mem["peak_bytes_in_use"],
        "device_bytes_limit": mem["bytes_limit"],
        "host_rss_bytes": host_rss_bytes(),
        "utilization": utilization,
        "queue_depth": queue_depth,
        "cache_bytes": _cache_bytes(),
        "source": mem["source"],
    }


# --- bounded ring timeseries -------------------------------------------------

class RingTimeseries:
    """Bounded (t, value) ring for one series (thread-safe).

    Fixed memory, newest-wins: the Gorilla in-memory block model without
    the XOR codec (at our sample rates the floats are already cheap; the
    bounded-ring + recent-window query semantics are what matter)."""

    __slots__ = ("name", "maxlen", "_ring", "_lock", "total_samples")

    def __init__(self, name: str, maxlen: int):
        self.name = str(name)
        self.maxlen = max(int(maxlen), 1)
        self._ring: deque = deque(maxlen=self.maxlen)  # guarded-by: self._lock
        self._lock = threading.Lock()
        self.total_samples = 0                         # guarded-by: self._lock

    def append(self, t: float, value: float) -> None:
        with self._lock:
            self._ring.append((float(t), float(value)))
            self.total_samples += 1

    def values(self) -> List[Tuple[float, float]]:
        with self._lock:
            return list(self._ring)

    def last(self) -> Optional[Tuple[float, float]]:
        with self._lock:
            return self._ring[-1] if self._ring else None

    def __len__(self) -> int:
        with self._lock:
            return len(self._ring)

    def stats(self) -> Dict[str, Any]:
        with self._lock:
            vals = [v for _, v in self._ring]
        if not vals:
            return {"n": 0, "last": None, "min": None, "max": None,
                    "mean": None}
        return {"n": len(vals), "last": vals[-1], "min": min(vals),
                "max": max(vals),
                "mean": round(sum(vals) / len(vals), 4)}


# --- the monitor -------------------------------------------------------------

class ResourceMonitor:
    """Periodic resource sampler feeding bounded ring timeseries.

    ``queue_depth_fn`` (optional) supplies the serving queue depth;
    utilization is derived from :data:`trace.GLOBAL_STAGES`'s ``compute``
    total between consecutive samples.  ``start()``/``stop()`` manage a
    daemon thread; ``sample_once()`` works without one (tests, one-shot
    probes).  Restartable: stop() then start() spawns a fresh thread."""

    def __init__(self, interval: Optional[float] = None,
                 ring: Optional[int] = None,
                 queue_depth_fn: Optional[Callable[[], int]] = None,
                 device: Optional[str] = None):
        if interval is None:
            try:
                interval = float(os.environ.get(C.RES_INTERVAL_ENV,
                                                C.RES_INTERVAL_DEFAULT))
            except ValueError:
                interval = C.RES_INTERVAL_DEFAULT
        if ring is None:
            try:
                ring = int(os.environ.get(C.RES_RING_ENV,
                                          C.RES_RING_DEFAULT))
            except ValueError:
                ring = C.RES_RING_DEFAULT
        self.interval = max(float(interval), 0.01)
        self.ring_max = max(int(ring), 1)
        self.queue_depth_fn = queue_depth_fn
        self.device = device
        self.series: Dict[str, RingTimeseries] = {
            name: RingTimeseries(name, self.ring_max) for name in SERIES}
        # sample_once runs on BOTH the monitor thread and on-demand
        # callers (latest() from the heartbeat thread before the first
        # interval) — the sample state below is lock-guarded
        self._latest: Optional[Dict[str, Any]] = None  # guarded-by: self._lock
        self._util_mark: Optional[Tuple[float, float]] = None  # guarded-by: self._lock
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.n_samples = 0                             # guarded-by: self._lock

    # -- sampling -------------------------------------------------------------

    def _utilization(self, now: float) -> Optional[float]:
        """Compute-stage wall-clock delta over the sample interval —
        the device-busy-fraction estimate the stage timeline
        makes possible.  None until two samples exist."""
        from comfyui_distributed_tpu_torch.utils.trace import GLOBAL_STAGES
        hist = GLOBAL_STAGES.histograms().get("compute")
        total = 0.0
        if hist is not None:
            _, total, _ = hist.prom_series()
        # swap under the lock: two concurrent sample_once calls (monitor
        # thread + a heartbeat's on-demand latest()) racing the unguarded
        # swap could both anchor on the same mark and double-count the
        # compute delta
        with self._lock:
            mark, self._util_mark = self._util_mark, (now, total)
        if mark is None:
            return None
        dt = now - mark[0]
        if dt <= 0:
            return None
        return max(0.0, min(1.0, (total - mark[1]) / dt))

    def sample_once(self) -> Dict[str, Any]:
        now = time.monotonic()
        qd = None
        if self.queue_depth_fn is not None:
            try:
                qd = int(self.queue_depth_fn())
            except Exception:  # noqa: BLE001 - depth source may be torn down
                qd = None
        snap = snapshot_now(queue_depth=qd,
                            utilization=self._utilization(now),
                            device=self.device)
        t = snap["t"]
        self.series["device_bytes_in_use"].append(
            t, snap["device_bytes_in_use"])
        self.series["device_peak_bytes"].append(t, snap["device_peak_bytes"])
        self.series["host_rss_bytes"].append(t, snap["host_rss_bytes"])
        self.series["cache_bytes"].append(t, snap["cache_bytes"])
        if snap["utilization"] is not None:
            self.series["utilization"].append(t, snap["utilization"])
        if qd is not None:
            self.series["queue_depth"].append(t, qd)
        with self._lock:
            self._latest = snap
            self.n_samples += 1
        return snap

    def latest(self) -> Dict[str, Any]:
        """Most recent sample; samples on demand when none exists yet
        (a heartbeat must never ship an empty snapshot)."""
        with self._lock:
            snap = self._latest
        return snap if snap is not None else self.sample_once()

    # -- thread lifecycle -----------------------------------------------------

    def start(self) -> None:
        t = self._thread
        if t is not None and t.is_alive():
            if not self._stop.is_set():
                return
            # stop() doesn't join: the old thread may still be draining
            # its final wait().  Join it here so a stop();start() pair
            # can't see the dying thread as "alive", skip the spawn, and
            # leave the monitor permanently dead.
            t.join(timeout=self.interval + 2.0)
            if t.is_alive():
                # Still blocked in a probe (a CUDA context can take
                # seconds to come up).  Spawning now would put two
                # samplers on the same rings; leave the stop flag set so
                # the old thread exits after its probe and a later
                # start() completes the restart.
                debug_log("resource monitor restart deferred: "
                          "old sampler still draining")
                return
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="dtpu-resmon")
        self._thread.start()

    def stop(self, join: bool = False) -> None:
        self._stop.set()
        t = self._thread
        if join and t is not None and t.is_alive():
            t.join(timeout=2.0)

    @property
    def running(self) -> bool:
        return self._thread is not None and self._thread.is_alive()

    def _run(self) -> None:
        stop = self._stop
        # first sample up front: it may initialize the CUDA context, and
        # paying that here keeps it off whoever calls latest() first —
        # e.g. the heartbeat thread, whose first beat races this
        # thread's first interval
        try:
            self.sample_once()
        except Exception as e:  # noqa: BLE001 - monitor must survive
            debug_log(f"resource sample failed: {e}")
        while not stop.wait(self.interval):
            try:
                self.sample_once()
            except Exception as e:  # noqa: BLE001 - monitor must survive
                debug_log(f"resource sample failed: {e}")

    # -- introspection --------------------------------------------------------

    def snapshot(self) -> Dict[str, Any]:
        """The JSON metrics block: config, counters, latest sample, and
        per-series ring stats (not the raw points — see series_tail)."""
        with self._lock:
            latest = dict(self._latest) if self._latest else None
            n = self.n_samples
        return {"interval_s": self.interval, "ring_max": self.ring_max,
                "running": self.running, "n_samples": n,
                "latest": latest,
                "series": {name: ring.stats()
                           for name, ring in self.series.items()}}

    def series_tail(self, name: str,
                    n: Optional[int] = None) -> List[Tuple[float, float]]:
        ring = self.series.get(name)
        if ring is None:
            return []
        vals = ring.values()
        return vals[-n:] if n else vals


# --- process-global monitor --------------------------------------------------

_MONITOR: Optional[ResourceMonitor] = None
_monitor_lock = threading.Lock()


def resource_enabled() -> bool:
    return os.environ.get(C.RESOURCE_ENV, "1").lower() \
        not in ("0", "false", "off")


def _weak_callable(fn: Optional[Callable[[], int]]
                   ) -> Optional[Callable[[], int]]:
    """Bound methods are held via WeakMethod so the process-global
    monitor never pins a dead owner (ServerStates come and go; the
    monitor doesn't).  A collected owner raises, which sample_once
    treats as "no depth source".  Plain callables pass through."""
    if fn is None or not hasattr(fn, "__self__"):
        return fn
    import weakref
    ref = weakref.WeakMethod(fn)

    def call() -> int:
        m = ref()
        if m is None:
            raise ReferenceError("queue-depth source was collected")
        return m()
    return call


def install_monitor(queue_depth_fn: Optional[Callable[[], int]] = None,
                    device: Optional[str] = None
                    ) -> Optional[ResourceMonitor]:
    """Start (or return) the process-global monitor.  ONE sampling
    thread per process regardless of how many ServerStates exist
    (loopback tests/benches run several): memory and RSS are process
    facts; only the queue-depth callback is rebound to the most recent
    caller, and so is ``device`` when given.  ``DTPU_RESOURCE=0``
    disables entirely (returns None)."""
    global _MONITOR
    if not resource_enabled():
        return None
    queue_depth_fn = _weak_callable(queue_depth_fn)
    with _monitor_lock:
        if _MONITOR is None:
            _MONITOR = ResourceMonitor(queue_depth_fn=queue_depth_fn,
                                       device=device)
            _MONITOR.start()
        else:
            if queue_depth_fn is not None:
                _MONITOR.queue_depth_fn = queue_depth_fn
            if device is not None:
                _MONITOR.device = device
        if not _MONITOR.running:
            _MONITOR.start()
        return _MONITOR


def get_monitor() -> Optional[ResourceMonitor]:
    return _MONITOR


def _host_only_snapshot() -> Dict[str, Any]:
    """A sample that cannot touch the device: host RSS stands in for the
    device fields, the same regime the CPU reports.  Used when a caller
    must not risk blocking behind a CUDA context coming up."""
    rss = host_rss_bytes()
    return {
        "t": time.time(),
        "device_bytes_in_use": rss,
        "device_peak_bytes": max(host_rss_peak_bytes(), rss),
        "device_bytes_limit": None,
        "host_rss_bytes": rss,
        "utilization": None,
        "queue_depth": None,
        "cache_bytes": _cache_bytes(),
        "source": "host_rss",
    }


def fleet_sample(device: Optional[str] = None) -> Dict[str, Any]:
    """The snapshot a heartbeat ships / the federation merge uses for
    "self": the monitor's latest when one exists; a device-free host
    snapshot while a running monitor hasn't produced its first sample
    yet (its thread may be seconds deep in a CUDA context's start — the
    heartbeat thread must never block behind that inline); a fresh
    sample of ``device`` only when no monitor thread exists to race."""
    mon = _MONITOR
    if mon is not None:
        try:
            with mon._lock:
                snap = mon._latest
            if snap is not None:
                return dict(snap)
            if mon.running:
                return _host_only_snapshot()
            return mon.latest()
        except Exception as e:  # noqa: BLE001 - never fail a heartbeat
            debug_log(f"fleet sample via monitor failed: {e}")
    return snapshot_now(device=device)


# --- Prometheus gauge families -----------------------------------------------

def resource_prom_families(
        snapshots: Dict[str, Optional[Dict[str, Any]]],
        ages: Optional[Dict[str, Optional[float]]] = None
) -> List[Tuple[str, str, str, List[Tuple[Dict, float]]]]:
    """Gauge families for one or many participants, in the ``extra``
    shape :func:`trace.prometheus_text` renders.  Key ``""`` emits
    unlabelled series (the per-process exposition); any other key
    becomes a ``worker_id`` label (the federated exposition)."""
    gauges = [
        ("dtpu_res_device_bytes_in_use",
         "Device (HBM) bytes in use; host RSS on backends without "
         "memory_stats.", "device_bytes_in_use"),
        ("dtpu_res_device_peak_bytes",
         "Peak device bytes in use (high-water mark).",
         "device_peak_bytes"),
        ("dtpu_res_host_rss_bytes",
         "Host resident set size in bytes.", "host_rss_bytes"),
        ("dtpu_res_utilization_ratio",
         "Device-busy fraction estimated from the compute-stage "
         "timeline.", "utilization"),
        ("dtpu_res_queue_depth",
         "Prompts queued or executing at sample time.", "queue_depth"),
        ("dtpu_res_cache_bytes",
         "Bytes resident in the cross-request reuse caches.",
         "cache_bytes"),
    ]
    fams = []
    for fam, help_text, key in gauges:
        samples = []
        for wid, snap in sorted(snapshots.items()):
            if not snap or snap.get(key) is None:
                continue
            # snapshots arrive over the wire from workers (heartbeats,
            # pull-through) — one version-skewed peer shipping "n/a"
            # must cost its row, not the whole fleet exposition
            try:
                value = float(snap[key])
            except (TypeError, ValueError):
                continue
            labels = {"worker_id": wid} if wid else {}
            samples.append((labels, value))
        if samples:
            fams.append((fam, "gauge", help_text, samples))
    if ages:
        samples = [({"worker_id": wid} if wid else {}, round(float(age), 3))
                   for wid, age in sorted(ages.items()) if age is not None]
        if samples:
            fams.append(
                ("dtpu_res_snapshot_age_seconds", "gauge",
                 "Age of the participant's retained resource snapshot.",
                 samples))
    return fams
