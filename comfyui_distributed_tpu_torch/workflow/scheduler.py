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

The batch-coalescing half: queued prompts that differ only in their
KSampler seed run as one batched dispatch.  Their **signature**
(:func:`coalesce_signature`) hashes the graph with the seed masked out;
:func:`pop_fair_group` takes the scheduled class's head prompt and the
contiguous run of its class's signature-equal prompts behind it (so no
prompt overtakes another of its class), :func:`build_coalesced` makes
the merged run (the first prompt's graph, ``EmptyLatentImage`` laying
out ``batch_size * k`` rows prompt-major through ``OpContext.coalesce``,
each KSampler given the per-prompt seeds as its ``coalesced_seeds``
hidden input) and :func:`split_images` gives each prompt its images
back.  Each prompt's rows draw the noise of its serial run, so
coalescing changes latencies, not images.  Only graphs of
``COALESCE_SAFE_NODE_TYPES`` coalesce.

Continuous batching (``workflow/batch_executor.py``) pops through
:func:`pop_cb_admit`: the same stride decision, but a step-batchable
head joins a running bucket with its class's same-signature prompts
from anywhere behind it; the controller's ``peek_class`` lets a blocked
class be passed over without charging its stride.
"""

from __future__ import annotations

import hashlib
import json
import math
import os
import threading
import time
from collections import OrderedDict
from typing import Any, Callable, Dict, List, Optional, Tuple

from comfyui_distributed_tpu_torch.utils import clock as clock_mod
from comfyui_distributed_tpu_torch.utils import constants as C
from comfyui_distributed_tpu_torch.utils import trace as trace_mod
from comfyui_distributed_tpu_torch.workflow.graph import Graph, parse_workflow

# class_type -> widget names that are per-prompt data, not program shape:
# masked out of the signature and handed on per prompt at merge time
_MASKED_WIDGETS: Dict[str, Tuple[str, ...]] = {
    "KSampler": ("seed",),
}


def _canonical(prompt: Dict[str, Any]) -> Optional[Dict[str, Any]]:
    """The signature view of an API-format prompt: its nodes with the
    masked widgets replaced by a sentinel.  None when the prompt does
    not coalesce (an unsafe node type, hidden inputs, no
    EmptyLatentImage and KSampler to batch over)."""
    has_latent_source = False
    has_sampler = False
    out: Dict[str, Any] = {}
    for nid, node in prompt.items():
        if not isinstance(node, dict) or "class_type" not in node:
            continue  # metadata keys ride along untouched
        ct = node.get("class_type")
        if ct not in C.COALESCE_SAFE_NODE_TYPES:
            return None
        if node.get("hidden"):
            # a dispatched share carries its participant's hidden state
            return None
        has_latent_source |= ct == "EmptyLatentImage"
        has_sampler |= ct == "KSampler"
        inputs = dict(node.get("inputs", {}))
        for w in _MASKED_WIDGETS.get(ct, ()):
            if w in inputs:
                inputs[w] = "__coalesced__"
        out[str(nid)] = {"class_type": ct, "inputs": inputs}
    if not out or not has_latent_source or not has_sampler:
        return None
    return out


def coalesce_signature(prompt: Dict[str, Any]) -> Optional[str]:
    """The prompt's coalescing signature (the JAX package's string for
    the same graph), or None when it runs alone.  Signature-equal
    prompts differ only in masked widgets."""
    canon = _canonical(prompt)
    if canon is None:
        return None
    try:
        blob = json.dumps(canon, sort_keys=True, default=str)
    except (TypeError, ValueError):
        return None
    return hashlib.sha1(blob.encode()).hexdigest()


def build_coalesced(prompts: List[Dict[str, Any]]
                    ) -> Tuple[Graph, Dict[str, Dict[str, Any]]]:
    """Merge signature-equal prompts into one run: ``(graph, hidden)``,
    the first prompt's graph and per-node hidden overrides with the
    per-prompt values of each masked widget (``coalesced_seeds``: JSON
    ints, which SaveImage writes into each prompt's PNG)."""
    graph = parse_workflow(prompts[0])
    hidden: Dict[str, Dict[str, Any]] = {}
    for nid, node in graph.nodes.items():
        for widget in _MASKED_WIDGETS.get(node.class_type, ()):
            per_prompt = [
                int(p[nid]["inputs"].get(widget, node.inputs.get(widget, 0)))
                for p in prompts]
            hidden.setdefault(nid, {})[f"coalesced_{widget}s"] = per_prompt
    return graph, hidden


def split_images(images: List[Any], k: int) -> List[List[Any]]:
    """A merged run's prompt-major images back per prompt: EmptyLatentImage
    lays out ``[prompt0 x b, prompt1 x b, ...]`` and every coalescable op
    keeps the batch order, so even chunks are the prompts'.  A count
    that does not divide goes all to the first prompt."""
    if k <= 1:
        return [list(images)]
    n = len(images)
    per = n // k if k and n % k == 0 else None
    if per is None:
        return [list(images)] + [[] for _ in range(k - 1)]
    return [list(images[i * per:(i + 1) * per]) for i in range(k)]


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

    def peek_class(self, queued: Dict[str, int]) -> Optional[str]:
        """The class :meth:`next_class` would pick, charging nothing and
        leaving the idle-return state as it is: the continuous-batching
        pop commits the charge only when it dequeues (a class blocked on
        a full bucket is not skipping its turn)."""
        with self._lock:
            active = [cls for cls in self.classes if queued.get(cls)]
            if not active:
                return None
            carried = [cls for cls in active if cls in self._active_prev]
            base = min(self._pass[cls] for cls in carried) \
                if carried else None
            best, best_key = None, None
            for cls in active:
                p = self._pass[cls]
                if base is not None and cls not in self._active_prev:
                    p = max(p, base)
                key = (p, self.classes.index(cls))
                if best_key is None or key < best_key:
                    best, best_key = cls, key
            return best

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


def pop_cb_admit(queue: List[Dict[str, Any]],
                 admission: AdmissionController,
                 room_for: Callable[[Dict[str, Any]], int],
                 fallback_ok: bool = True,
                 legacy_max: int = 1) -> Tuple[str, List[Dict[str, Any]]]:
    """The continuous-batching pop: :func:`pop_fair_group`'s stride
    decision, so the classes dequeue in the same ratios whichever model
    runs the queue, but the scheduled class's head may join a running
    bucket.  ``room_for(item)``: > 0, batchable with that many slots
    free; 0, not batchable (the one-dispatch path); < 0, batchable but
    full (it waits for a slot exit).  Outcomes:

    - ``("cb", items)``: the head and up to ``room - 1`` more of its
      class and signature from anywhere behind it (passed-over items
      keep their places);
    - ``("fallback", group)``: the head is not batchable: the legacy
      group pop (its class's contiguous same-signature run, up to
      ``legacy_max``);
    - ``("defer", [])``: every queued class is blocked (full, or not
      batchable while ``fallback_ok`` is False): nothing popped, no
      stride charged.

    A blocked class drops out of the counts and the stride peeks again,
    so a paid prompt admits (by preemption, with parking on) while the
    batch class's head waits for a slot.  The caller holds the queue
    lock."""
    if not queue:
        return "defer", []

    def cls_of(item: Dict[str, Any]) -> str:
        return item.get("tenant") or admission.default_class

    counts_all: Dict[str, int] = {}
    for item in queue:
        counts_all[cls_of(item)] = counts_all.get(cls_of(item), 0) + 1
    blocked: set = set()
    while True:
        counts = {c: n for c, n in counts_all.items() if c not in blocked}
        if not counts:
            return "defer", []
        # peek, then charge only on a dequeue: next_class() on the same
        # counts picks the peeked class again
        cls = admission.peek_class(counts) or admission.default_class
        idx = next((i for i, item in enumerate(queue)
                    if cls_of(item) == cls), None)
        if idx is None:
            # the default class has nothing queued: the first unblocked
            # item's class instead
            idx = next(i for i, item in enumerate(queue)
                       if cls_of(item) not in blocked)
            cls = cls_of(queue[idx])
        head = queue[idx]
        room = int(room_for(head) or 0)
        if room > 0:
            admission.next_class(counts)
            sig = head.get("sig")
            take = [idx]
            for j in range(idx + 1, len(queue)):
                if sig is None or len(take) >= room:
                    break
                if cls_of(queue[j]) == cls and queue[j].get("sig") == sig:
                    take.append(j)
            items = [queue[i] for i in take]
            for i in reversed(take):
                queue.pop(i)
            return "cb", items
        if room == 0 and fallback_ok:
            admission.next_class(counts)
            group = [queue.pop(idx)]
            sig = group[0].get("sig")
            j = idx
            while sig is not None and len(group) < max(legacy_max, 1):
                while j < len(queue) and cls_of(queue[j]) != cls:
                    j += 1
                if j >= len(queue) or queue[j].get("sig") != sig:
                    break
                group.append(queue.pop(j))
            return "fallback", group
        blocked.add(cls)
