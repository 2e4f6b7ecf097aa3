"""The SLO burn-rate engine: the counterpart of
``comfyui_distributed_tpu/utils/slo.py``, with the same spec grammar,
windows and numbers, so both packages' ``GET /distributed/slo`` agree on
the same samples.

Per-tenant-class objectives (``DTPU_SLO_SPEC``) are evaluated over two
rolling windows, fed by the server's finalize path.  The grammar, one
line::

    DTPU_SLO_SPEC = class:obj[,obj...][;class:obj...]
    obj           = pNN<DUR | completion>RATIO
    DUR           = float seconds, optional 's'/'ms' suffix

e.g. ``paid:p95<2s,completion>0.999;free:p95<10s``.  ``pNN<T`` means "at
most (100-NN)% of requests may take longer than T"; ``completion>R``
means "at least fraction R of requests finalize ok".  A malformed part
is logged and skipped.

The burn rate is the bad fraction over a window divided by the
budgeted bad fraction: 1.0 spends the budget exactly as fast as
allowed, above 1.0 the objective fails if the window's behaviour
persists.  Each class has a fast (~5 min) and a slow (~1 h) window,
each a bounded ring pruned by age.

Surfaces: ``GET /distributed/slo``, the ``slo`` block of
``/distributed/metrics``, the ``dtpu_slo_burn_rate`` and
``dtpu_slo_budget_remaining`` gauges of ``/distributed/metrics.prom``
and ``cli slo``.  Under :func:`autoscale_slo_armed`
(``DTPU_AUTOSCALE_SLO=1``) the autoscaler (``runtime/autoscale.py``)
reads the paid class's fast :meth:`SLOEngine.burn_rate` as a third
scale-up trigger.
"""

from __future__ import annotations

import os
import re
import threading
import time
from collections import deque
from typing import Any, Dict, List, Optional, Tuple

from comfyui_distributed_tpu_torch.utils import constants as C
from comfyui_distributed_tpu_torch.utils.log import log

_OBJ_RE = re.compile(r"^p(\d{1,2}(?:\.\d+)?)<([0-9.]+)(ms|s)?$")
_COMPLETION_RE = re.compile(r"^completion>(0?\.\d+|1(?:\.0+)?)$")


class Objective:
    """One parsed objective (plain record)."""

    __slots__ = ("kind", "quantile", "threshold_s", "min_ratio",
                 "budget_frac", "raw")

    def __init__(self, kind: str, raw: str,
                 quantile: float = 0.0, threshold_s: float = 0.0,
                 min_ratio: float = 0.0):
        self.kind = kind              # "latency" | "completion"
        self.raw = raw
        self.quantile = quantile      # latency: target quantile in (0,1)
        self.threshold_s = threshold_s
        self.min_ratio = min_ratio    # completion: required ok fraction
        # the budgeted bad fraction the burn rate divides by
        self.budget_frac = (1.0 - quantile) if kind == "latency" \
            else (1.0 - min_ratio)

    def to_dict(self) -> Dict[str, Any]:
        out: Dict[str, Any] = {"kind": self.kind, "raw": self.raw,
                               "budget_frac": round(self.budget_frac, 6)}
        if self.kind == "latency":
            out["quantile"] = self.quantile
            out["threshold_s"] = self.threshold_s
        else:
            out["min_ratio"] = self.min_ratio
        return out


def _parse_objective(part: str) -> Optional[Objective]:
    part = part.strip()
    m = _OBJ_RE.match(part)
    if m is not None:
        q = float(m.group(1)) / 100.0
        if not 0.0 < q < 1.0:
            return None
        thr = float(m.group(2))
        if m.group(3) == "ms":
            thr /= 1000.0
        if thr <= 0.0:
            return None
        return Objective("latency", part, quantile=q, threshold_s=thr)
    m = _COMPLETION_RE.match(part)
    if m is not None:
        ratio = float(m.group(1))
        if not 0.0 < ratio < 1.0:
            return None
        return Objective("completion", part, min_ratio=ratio)
    return None


def parse_slo_spec(raw: Optional[str]) -> Dict[str, List[Objective]]:
    """``DTPU_SLO_SPEC`` -> {tenant_class: [Objective, ...]}; malformed
    pieces are logged once and skipped."""
    out: Dict[str, List[Objective]] = {}
    for clause in (raw or "").split(";"):
        clause = clause.strip()
        if not clause:
            continue
        cls, sep, body = clause.partition(":")
        cls = cls.strip()
        if not sep or not cls:
            log(f"slo: ignoring malformed spec clause {clause!r}")
            continue
        objs: List[Objective] = []
        for part in body.split(","):
            if not part.strip():
                continue
            obj = _parse_objective(part)
            if obj is None:
                log(f"slo: ignoring malformed objective {part!r} "
                    f"for class {cls!r}")
                continue
            objs.append(obj)
        if objs:
            out.setdefault(cls, []).extend(objs)
    return out


class _WindowRing:
    """Bounded recent-completions ring for ONE (tenant, window): samples
    ``(t_mono, duration_s, ok)`` pruned by age on every read/write.
    Caller (the engine) holds the engine lock."""

    __slots__ = ("window_s", "samples")

    def __init__(self, window_s: float, maxlen: int = C.SLO_RING_MAX):
        self.window_s = float(window_s)
        self.samples: deque = deque(maxlen=maxlen)

    def record(self, now: float, duration_s: float, ok: bool) -> None:
        self.prune(now)
        self.samples.append((now, float(duration_s), bool(ok)))

    def prune(self, now: float) -> None:
        cutoff = now - self.window_s
        dq = self.samples
        while dq and dq[0][0] < cutoff:
            dq.popleft()

    def stats(self, now: float) -> Dict[str, Any]:
        self.prune(now)
        durs = sorted(d for _, d, _ in self.samples)
        n = len(durs)
        ok = sum(1 for _, _, o in self.samples if o)

        def pct(q: float) -> float:
            if not n:
                return 0.0
            return durs[min(int(q * n), n - 1)]

        return {"count": n, "ok": ok,
                "ok_ratio": (ok / n) if n else 1.0,
                "p50_s": round(pct(0.50), 6),
                "p95_s": round(pct(0.95), 6),
                "p99_s": round(pct(0.99), 6),
                "durations": durs}


WINDOW_NAMES = ("fast", "slow")


class SLOEngine:
    """Multi-window burn-rate evaluation over the parsed spec
    (thread-safe: finalizer threads record, scrape surfaces read)."""

    def __init__(self, spec: Dict[str, List[Objective]],
                 fast_s: Optional[float] = None,
                 slow_s: Optional[float] = None):
        self.spec = spec
        try:
            self.fast_s = float(
                os.environ.get(C.SLO_FAST_WINDOW_ENV,
                               C.SLO_FAST_WINDOW_DEFAULT)) \
                if fast_s is None else float(fast_s)
        except ValueError:
            self.fast_s = C.SLO_FAST_WINDOW_DEFAULT
        try:
            self.slow_s = float(
                os.environ.get(C.SLO_SLOW_WINDOW_ENV,
                               C.SLO_SLOW_WINDOW_DEFAULT)) \
                if slow_s is None else float(slow_s)
        except ValueError:
            self.slow_s = C.SLO_SLOW_WINDOW_DEFAULT
        self._lock = threading.Lock()
        # tenant -> {"fast": ring, "slow": ring}
        self._rings: Dict[str, Dict[str, _WindowRing]] = {}  # guarded-by: self._lock

    @classmethod
    def from_env(cls) -> "SLOEngine":
        return cls(parse_slo_spec(os.environ.get(C.SLO_SPEC_ENV)))

    @property
    def enabled(self) -> bool:
        return bool(self.spec)

    # the caller holds self._lock
    def _tenant_rings(self, tenant: str) -> Dict[str, _WindowRing]:
        rings = self._rings.get(tenant)
        if rings is None:
            rings = self._rings[tenant] = {
                "fast": _WindowRing(self.fast_s),
                "slow": _WindowRing(self.slow_s)}
        return rings

    def record(self, tenant: str, duration_s: float, ok: bool,
               now: Optional[float] = None) -> None:
        """One finalized prompt (any status) into both windows.  A cheap
        no-op when no spec is configured."""
        if not self.enabled:
            return
        now = time.monotonic() if now is None else now
        with self._lock:
            for ring in self._tenant_rings(str(tenant)).values():
                ring.record(now, duration_s, ok)

    def latency_threshold(self, tenant: str) -> Optional[float]:
        """The tightest latency objective threshold for ``tenant`` (the
        slo_breach trace-event bar), or None."""
        thrs = [o.threshold_s for o in self.spec.get(str(tenant), ())
                if o.kind == "latency"]
        return min(thrs) if thrs else None

    @staticmethod
    def _objective_burn(obj: Objective, stats: Dict[str, Any]) -> float:
        n = stats["count"]
        if not n or obj.budget_frac <= 0.0:
            return 0.0
        if obj.kind == "latency":
            bad = sum(1 for d in stats["durations"]
                      if d > obj.threshold_s)
        else:
            bad = n - stats["ok"]
        return (bad / n) / obj.budget_frac

    def evaluate(self, now: Optional[float] = None) -> Dict[str, Any]:
        """Full snapshot for ``GET /distributed/slo`` / ``cli slo``."""
        now = time.monotonic() if now is None else now
        tenants: Dict[str, Any] = {}
        with self._lock:
            classes = set(self.spec) | set(self._rings)
            for cls in sorted(classes):
                objs = self.spec.get(cls, [])
                rings = self._tenant_rings(cls)
                windows: Dict[str, Any] = {}
                for wname in WINDOW_NAMES:
                    stats = rings[wname].stats(now)
                    burns = {o.raw: round(self._objective_burn(o, stats),
                                          4)
                             for o in objs}
                    stats.pop("durations")
                    windows[wname] = {
                        **stats,
                        "window_s": rings[wname].window_s,
                        "burn_rates": burns,
                        "burn_rate": max(burns.values()) if burns
                        else 0.0}
                slow_burn = windows["slow"]["burn_rate"]
                tenants[cls] = {
                    "objectives": [o.to_dict() for o in objs],
                    "windows": windows,
                    "budget_remaining": round(
                        max(0.0, 1.0 - slow_burn), 4)}
        return {"enabled": self.enabled,
                "fast_window_s": self.fast_s,
                "slow_window_s": self.slow_s,
                "tenants": tenants}

    def burn_rate(self, tenant: str, window: str = "fast",
                  now: Optional[float] = None) -> float:
        """Max objective burn for one tenant/window (autoscaler hook);
        0.0 when unconfigured or sample-free."""
        objs = self.spec.get(str(tenant))
        if not objs:
            return 0.0
        now = time.monotonic() if now is None else now
        with self._lock:
            stats = self._tenant_rings(str(tenant))[window].stats(now)
        return max(self._objective_burn(o, stats) for o in objs)

    def prom_families(self) -> List[Tuple[str, str, str,
                                          List[Tuple[Dict, float]]]]:
        """The gauge families ``/distributed/metrics.prom`` appends."""
        if not self.enabled:
            return []
        snap = self.evaluate()
        burn_samples: List[Tuple[Dict, float]] = []
        budget_samples: List[Tuple[Dict, float]] = []
        for cls, t in snap["tenants"].items():
            if not t["objectives"]:
                continue
            for wname in WINDOW_NAMES:
                burn_samples.append((
                    {"tenant": cls, "window": wname},
                    round(t["windows"][wname]["burn_rate"], 6)))
            budget_samples.append(({"tenant": cls},
                                   t["budget_remaining"]))
        return [
            ("dtpu_slo_burn_rate", "gauge",
             "Error-budget burn rate per tenant class and window "
             "(>1: objective failing at this window's rate).",
             burn_samples),
            ("dtpu_slo_budget_remaining", "gauge",
             "Remaining slow-window error budget fraction per tenant "
             "class.", budget_samples),
        ]

    def reset(self) -> None:
        with self._lock:
            self._rings.clear()


def autoscale_slo_armed() -> bool:
    return str(os.environ.get(C.AUTOSCALE_SLO_ENV, "0")).strip().lower() \
        in ("1", "true", "yes", "on")
