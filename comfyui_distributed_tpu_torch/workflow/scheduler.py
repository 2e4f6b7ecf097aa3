"""Multi-tenant admission and fair dequeue of the serving queue: the
counterpart of ``_parse_kv_floats``, ``TokenBucket``,
``AdmissionController`` and ``pop_fair_group`` in
``comfyui_distributed_tpu/workflow/scheduler.py``, with the same rules
and numbers, so both packages' masters shed and order the same traffic
the same way.

Three mechanisms:

- per-client **token buckets** (sustained rate and burst, off by
  default) refuse one client's flood before it takes a queue slot;
- **class-aware shedding** maps the queued count to a per-class 429 bar
  (batch at half full, free at 85%, paid only at a full queue);
- **weighted fair dequeue** (stride scheduling) interleaves the classes
  that were admitted; within a class the order stays FIFO.

The batch-coalescing half of the JAX module (``coalesce_signature``,
``build_coalesced``, ``pop_cb_admit``, ``split_images``) and the
controller's ``peek_class``, which only ``pop_cb_admit`` calls, belong
to continuous batching and are not here: no queued item has a ``sig``,
so :func:`pop_fair_group` pops one prompt at a time.
"""

from __future__ import annotations

import math
import os
import threading
import time
from collections import OrderedDict
from typing import Any, Dict, List, Optional

from comfyui_distributed_tpu_torch.utils import clock as clock_mod
from comfyui_distributed_tpu_torch.utils import constants as C
from comfyui_distributed_tpu_torch.utils import trace as trace_mod


def _parse_kv_floats(raw: Optional[str],
                     default: Dict[str, float]) -> Dict[str, float]:
    """``"paid=6,free=3,batch=1"`` -> dict, falling back to ``default``
    per key (and entirely on a malformed string)."""
    out = dict(default)
    if not raw:
        return out
    try:
        for part in raw.split(","):
            if not part.strip():
                continue
            k, v = part.split("=", 1)
            out[k.strip()] = float(v)
    except ValueError:
        return dict(default)
    return out


class TokenBucket:
    """Sustained ``rate`` tokens/s with a ``burst`` cap; starts full.
    ``rate <= 0`` means unlimited."""

    def __init__(self, rate: float, burst: float):
        self.rate = float(rate)
        self.burst = max(float(burst), 1.0)
        self.level = self.burst
        # anchored on first use, so a caller may drive the time itself
        self._t: Optional[float] = None

    def try_take(self, now: Optional[float] = None) -> bool:
        if self.rate <= 0:
            return True
        now = time.monotonic() if now is None else now
        if self._t is not None:
            self.level = min(self.burst,
                             self.level + (now - self._t) * self.rate)
        self._t = now
        if self.level >= 1.0:
            self.level -= 1.0
            return True
        return False

    def seconds_until_token(self, now: Optional[float] = None) -> float:
        if self.rate <= 0 or self.level >= 1.0:
            return 0.0
        return (1.0 - self.level) / self.rate


class AdmissionController:
    """Tenant classification, admission and fair-dequeue state of one
    serving queue.  Thread-safe (handler threads admit, the execution
    thread dequeues); the environment is read at construction, so a
    test pins each instance."""

    def __init__(self,
                 weights: Optional[Dict[str, float]] = None,
                 shed: Optional[Dict[str, float]] = None,
                 rate: Optional[Dict[str, float]] = None,
                 burst: Optional[Dict[str, float]] = None,
                 default_class: Optional[str] = None,
                 clock: Optional[Any] = None):
        # the token buckets refill on this clock
        self._clock = clock if clock is not None else clock_mod.WALL
        self.classes = C.TENANT_CLASSES
        self.weights = weights if weights is not None else _parse_kv_floats(
            os.environ.get(C.TENANT_WEIGHTS_ENV), C.TENANT_WEIGHTS_DEFAULT)
        self.shed = shed if shed is not None else _parse_kv_floats(
            os.environ.get(C.TENANT_SHED_ENV), C.TENANT_SHED_DEFAULT)

        # rate and burst: a bare number applies to every class, the
        # key=value form per class; 0 = unlimited
        def _rates(env, default_each):
            raw = os.environ.get(env, "")
            if raw and "=" not in raw:
                try:
                    return {cls: float(raw) for cls in self.classes}
                except ValueError:
                    raw = ""
            return _parse_kv_floats(
                raw, {cls: default_each for cls in self.classes})
        self.rate = rate if rate is not None \
            else _rates(C.TENANT_RATE_ENV, 0.0)
        self.burst = burst if burst is not None \
            else _rates(C.TENANT_BURST_ENV, C.TENANT_BURST_DEFAULT)
        self.default_class = default_class or os.environ.get(
            C.TENANT_DEFAULT_CLASS_ENV, C.TENANT_DEFAULT_CLASS)
        if self.default_class not in self.classes:
            self.default_class = C.TENANT_DEFAULT_CLASS
        self._lock = threading.Lock()
        # with N sharded masters one client's traffic spreads over the
        # shards by prompt-id hash, so each shard refills its buckets at
        # rate / N; the shed bars stay per shard
        self._rate_scale = 1.0                   # guarded-by: self._lock
        # stride scheduling: each class's virtual finish time; the next
        # class is the non-empty one with the smallest pass, which then
        # advances by 1 / weight
        self._pass: Dict[str, float] = {
            cls: 0.0 for cls in self.classes}    # guarded-by: self._lock
        self._active_prev: set = set()           # guarded-by: self._lock
        # (class, client) -> bucket, LRU-bounded
        self._buckets: "OrderedDict[str, TokenBucket]" = \
            OrderedDict()                        # guarded-by: self._lock
        self.counters: Dict[str, Dict[str, int]] = {
            cls: {"admitted": 0, "shed_rate": 0, "shed_overload": 0,
                  "completed": 0}
            for cls in self.classes}             # guarded-by: self._lock

    # -- classification -------------------------------------------------------

    def classify(self, priority: Any) -> str:
        """The request's class: its ``priority`` when it names one, else
        the default (highest) class, so untagged traffic is never shed
        before tagged lower classes."""
        p = str(priority or "").strip().lower()
        return p if p in self.classes else self.default_class

    # -- admission ------------------------------------------------------------

    def admit(self, tenant: str, client_id: str, depth: int,
              max_queue: int) -> Optional[Dict[str, Any]]:
        """One prompt's admission.  None = admitted; else a rejection
        with ``reason`` (``rate`` or ``overload``), ``tenant`` and a
        ``retry_after_s`` floor the caller refines with its drain rate."""
        with self._lock:
            rate = self.rate.get(tenant, 0.0) * self._rate_scale
            if rate > 0:
                key = f"{tenant}:{client_id}"
                bucket = self._buckets.get(key)
                if bucket is None or bucket.rate != rate:
                    bucket = TokenBucket(
                        rate, self.burst.get(
                            tenant, C.TENANT_BURST_DEFAULT))
                    self._buckets[key] = bucket
                self._buckets.move_to_end(key)
                while len(self._buckets) > C.TENANT_BUCKETS_KEPT:
                    self._buckets.popitem(last=False)
                if not bucket.try_take(now=self._clock.monotonic()):
                    self.counters[tenant]["shed_rate"] += 1
                    trace_mod.GLOBAL_COUNTERS.bump(
                        f"tenant_shed_rate_{tenant}")
                    return {"reason": "rate", "tenant": tenant,
                            "retry_after_s": max(
                                bucket.seconds_until_token(), 1.0)}
            bar = self.shed.get(tenant, 1.0)
            if max_queue > 0 and depth >= math.ceil(bar * max_queue):
                self.counters[tenant]["shed_overload"] += 1
                trace_mod.GLOBAL_COUNTERS.bump(
                    f"tenant_shed_overload_{tenant}")
                return {"reason": "overload", "tenant": tenant,
                        "retry_after_s": 1.0}
            self.counters[tenant]["admitted"] += 1
            return None

    def set_rate_scale(self, scale: float) -> None:
        """Re-apply the shard split (on a ring membership change); a
        bucket is rebuilt at its next admit, its rate no longer
        matching."""
        with self._lock:
            self._rate_scale = max(float(scale), 1e-9)

    def rate_scale(self) -> float:
        with self._lock:
            return self._rate_scale

    def on_complete(self, tenant: str) -> None:
        with self._lock:
            if tenant in self.counters:
                self.counters[tenant]["completed"] += 1

    # -- weighted fair dequeue ------------------------------------------------

    def next_class(self, queued: Dict[str, int]) -> Optional[str]:
        """Stride scheduling over the classes with queued work: the
        smallest virtual finish time wins and advances by 1 / weight.  A
        class back from idle is clamped up to the active minimum, so its
        banked credit buys no starvation burst."""
        with self._lock:
            active = [cls for cls in self.classes if queued.get(cls)]
            if not active:
                return None
            carried = [cls for cls in active if cls in self._active_prev]
            if carried:
                base = min(self._pass[cls] for cls in carried)
                for cls in active:
                    if cls not in self._active_prev:
                        self._pass[cls] = max(self._pass[cls], base)
            self._active_prev = set(active)
            pick = min(active, key=lambda cls: (self._pass[cls],
                                                self.classes.index(cls)))
            self._pass[pick] += 1.0 / max(self.weights.get(pick, 1.0),
                                          1e-9)
            return pick

    def snapshot(self) -> Dict[str, Any]:
        with self._lock:
            return {
                "classes": list(self.classes),
                "default_class": self.default_class,
                "weights": dict(self.weights),
                "shed_thresholds": dict(self.shed),
                "rate_limits": {cls: r for cls, r in self.rate.items()
                                if r > 0},
                "rate_scale": self._rate_scale,
                "tracked_clients": len(self._buckets),
                "per_class": {cls: dict(v)
                              for cls, v in self.counters.items()},
            }


def pop_fair_group(queue: List[Dict[str, Any]],
                   admission: AdmissionController,
                   coalesce_max: int = 1) -> List[Dict[str, Any]]:
    """Pop the next dispatch group from a tenant-tagged queue under
    weighted fair scheduling.  The head is the first queued item of the
    scheduled class (FIFO within a class); items of that class whose
    ``sig`` matches the head's extend the group up to ``coalesce_max``.
    The caller holds the queue lock."""
    if not queue:
        return []
    counts: Dict[str, int] = {}
    for item in queue:
        cls = item.get("tenant") or admission.default_class
        counts[cls] = counts.get(cls, 0) + 1
    cls = admission.next_class(counts) or admission.default_class
    idx = next((i for i, item in enumerate(queue)
                if (item.get("tenant") or admission.default_class)
                == cls), 0)
    group = [queue.pop(idx)]
    sig = group[0].get("sig")
    j = idx
    while sig is not None and len(group) < coalesce_max:
        while j < len(queue) and (queue[j].get("tenant")
                                  or admission.default_class) != cls:
            j += 1
        if j >= len(queue) or queue[j].get("sig") != sig:
            break
        group.append(queue.pop(j))
    return group
