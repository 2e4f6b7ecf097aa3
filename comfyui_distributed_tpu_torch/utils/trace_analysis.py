"""Critical-path analysis of traces: the counterpart of
``comfyui_distributed_tpu/utils/trace_analysis.py``, after The Mystery
Machine (Chow et al., OSDI 2014) and Canopy (Kaldor et al., SOSP 2017).

- :func:`critical_path`: one trace's end-to-end latency cut into blame
  categories (queue_wait, admission, dispatch, compute, d2h, encode,
  upload, blend, park, other) plus the unattributed gap.  Every instant
  of the root interval is blamed on the deepest category-bearing span
  covering it, and instants no span covers are the gap, so the
  categories and the gap sum to the root's duration.
- :func:`aggregate` and :func:`collect_breakdowns`: profiles over the
  flight-recorder ring or capture files, grouped by tenant, structural
  signature or worker.
- :func:`straggler_scorecard`: each worker's p95 compute against the
  fleet median.
- :func:`diff_breakdowns`: per-category deltas between two capture
  directories with a seeded permutation test (``cli analyze --diff``).
- the live plane: a baseline profile (``DTPU_ANALYSIS_BASELINE``) arms
  an on-commit tap (:class:`LiveAnalyzer`) that scores each sealed trace
  and counts category regressions.  The skew correction of shipped
  worker spans (``DTPU_SKEW_CORRECTION``) is applied by the server when
  it ingests them, from the registry's heartbeat estimate.

Pure standard library; the same over live records and capture files of
either package.
"""

from __future__ import annotations

import json
import os
import random
import threading
from typing import Any, Dict, Iterable, List, Optional, Tuple

from comfyui_distributed_tpu_torch.utils import constants as C
from comfyui_distributed_tpu_torch.utils.log import log

# Canonical blame categories, in report order.  "other" absorbs named
# spans outside the mapping below (a new span name degrades to a
# visible bucket, never to silence); the unattributed gap is reported
# separately because it is the *absence* of instrumentation.
CATEGORIES = ("queue_wait", "admission", "dispatch", "compute", "d2h",
              "encode", "upload", "blend", "park", "other")

# span name -> blame category.  Names mapped to None never claim
# timeline cover (the job roots span the whole interval — letting them
# cover would define the gap away).
CATEGORY_OF = {
    "job": None, "job_e2e": None,
    "queue_wait": "queue_wait",
    "preflight": "admission",
    "cb_admit": "admission",
    "cb_admit_to_first_step": "admission",
    "prepare_job": "dispatch",
    "dispatch": "dispatch",
    "redispatch": "dispatch",
    "reassign": "dispatch",
    "receive_image": "dispatch",
    "receive_tile": "dispatch",
    "execute": "compute",
    "compute": "compute",
    "coalesced_batch": "compute",
    "cb_decode": "compute",
    "cache_replay": "compute",
    "d2h": "d2h",
    "encode": "encode",
    "upload": "upload",
    "collect": "blend",
    "finalize": "blend",
    "blend": "blend",
    "cb_exit": "blend",
    "cb_park": "park",
    "slo_breach": None,          # instant marker, not an interval
}


def _max_traces() -> int:
    try:
        return max(1, int(os.environ.get(C.ANALYSIS_MAX_TRACES_ENV,
                                         C.ANALYSIS_MAX_TRACES_DEFAULT)))
    except ValueError:
        return C.ANALYSIS_MAX_TRACES_DEFAULT


def anomaly_pct() -> float:
    try:
        return float(os.environ.get(C.ANALYSIS_ANOMALY_PCT_ENV,
                                    C.ANALYSIS_ANOMALY_PCT_DEFAULT))
    except ValueError:
        return C.ANALYSIS_ANOMALY_PCT_DEFAULT


def straggler_x() -> float:
    try:
        return float(os.environ.get(C.ANALYSIS_STRAGGLER_X_ENV,
                                    C.ANALYSIS_STRAGGLER_X_DEFAULT))
    except ValueError:
        return C.ANALYSIS_STRAGGLER_X_DEFAULT


def skew_correction_enabled() -> bool:
    return os.environ.get(C.SKEW_CORRECTION_ENV, "1").lower() \
        not in ("0", "false", "off")


def _percentile(sorted_vals: List[float], q: float) -> float:
    if not sorted_vals:
        return 0.0
    idx = min(int(q * len(sorted_vals)), len(sorted_vals) - 1)
    return sorted_vals[idx]


# --- per-trace critical-path extraction --------------------------------------

def _find_root(rec: Dict[str, Any]) -> Optional[Dict[str, Any]]:
    spans = list(rec.get("spans") or [])
    if not spans:
        return None
    rid = rec.get("root_span_id")
    if rid:
        for s in spans:
            if s.get("span_id") == rid:
                return s
    # fall back to the longest parentless span (hand-built forests and
    # partial captures don't always carry a root id)
    ids = {s.get("span_id") for s in spans}
    roots = [s for s in spans
             if not s.get("parent_id") or s.get("parent_id") not in ids]
    pool = roots or spans
    return max(pool, key=lambda s: float(s.get("duration_s") or 0.0))


def _depths(spans: List[Dict[str, Any]]) -> Dict[str, int]:
    """Nesting depth per span id (unknown parents read as roots); a
    parent-cycle in a corrupt record terminates at the span cap."""
    by_id = {s.get("span_id"): s for s in spans if s.get("span_id")}
    depths: Dict[str, int] = {}
    for sid in by_id:
        d, cur, hops = 0, by_id[sid], 0
        while cur is not None and hops <= len(by_id):
            pid = cur.get("parent_id")
            cur = by_id.get(pid) if pid else None
            if cur is not None:
                d += 1
            hops += 1
        depths[sid] = d
    return depths


def critical_path(rec: Dict[str, Any]) -> Dict[str, Any]:
    """Blame decomposition of one committed trace record.

    Returns category seconds that sum (with the unattributed gap) to
    the root interval exactly, the blamed timeline segments, and a
    ``negative_edges`` count — cross-process spans that still start
    before their parent after skew correction (must be 0 on a healthy
    clock-corrected ingest)."""
    spans = list(rec.get("spans") or [])
    root = _find_root(rec)
    if root is None:
        return {"prompt_id": rec.get("prompt_id"),
                "trace_id": rec.get("trace_id"),
                "e2e_s": 0.0, "categories": {}, "unattributed_s": 0.0,
                "unattributed_pct": 0.0, "path": [], "negative_edges": 0}
    t0 = float(root.get("start_s") or 0.0)
    t1 = float(root.get("end_s") or t0)
    e2e = max(t1 - t0, 0.0)
    depths = _depths(spans)
    by_id = {s.get("span_id"): s for s in spans if s.get("span_id")}
    negative_edges = 0
    covers: List[Tuple[float, float, int, float, Dict[str, Any], str]] = []
    for s in spans:
        cat = CATEGORY_OF.get(str(s.get("name")), "other")
        if cat is None or s is root:
            continue
        ss = float(s.get("start_s") or 0.0)
        se = float(s.get("end_s") or ss)
        parent = by_id.get(s.get("parent_id"))
        if parent is not None \
                and ss < float(parent.get("start_s") or ss) - 1e-6:
            # a child starting before its parent is the clock-skew
            # signature (a worker span on an uncorrected clock)
            negative_edges += 1
        ss, se = max(ss, t0), min(se, t1)
        if se <= ss:
            continue
        covers.append((ss, se, depths.get(s.get("span_id"), 0),
                       float(s.get("start_s") or 0.0), s, cat))
    # elementary segments between all clipped boundaries; each blamed
    # on the deepest covering span (ties: latest start)
    bounds = sorted({t0, t1} | {c[0] for c in covers}
                    | {c[1] for c in covers})
    cat_s = {c: 0.0 for c in CATEGORIES}
    path: List[Dict[str, Any]] = []
    gap = 0.0
    for a, b in zip(bounds, bounds[1:]):
        if b <= a:
            continue
        mid = (a + b) / 2.0
        best = None
        for ss, se, depth, start, s, cat in covers:
            if ss <= mid < se:
                key = (depth, start)
                if best is None or key > best[0]:
                    best = (key, s, cat)
        if best is None:
            gap += b - a
            seg = {"name": None, "category": "unattributed",
                   "start_s": a, "dur_s": b - a}
        else:
            _, s, cat = best
            cat_s[cat] += b - a
            seg = {"name": s.get("name"), "category": cat,
                   "start_s": a, "dur_s": b - a}
            w = (s.get("attrs") or {}).get("worker")
            if w is not None:
                seg["worker"] = str(w)
        if path and path[-1]["name"] == seg["name"] \
                and path[-1]["category"] == seg["category"] \
                and path[-1].get("worker") == seg.get("worker"):
            path[-1]["dur_s"] += seg["dur_s"]
        else:
            path.append(seg)
    for seg in path:
        seg["start_s"] = round(seg["start_s"] - t0, 6)
        seg["dur_s"] = round(seg["dur_s"], 6)
    return {
        "prompt_id": rec.get("prompt_id"),
        "trace_id": rec.get("trace_id"),
        "e2e_s": round(e2e, 6),
        "categories": {k: round(v, 6) for k, v in cat_s.items() if v > 0},
        "unattributed_s": round(gap, 6),
        "unattributed_pct": round(gap / e2e * 100.0, 3) if e2e else 0.0,
        "path": path,
        "negative_edges": negative_edges,
    }


# --- cross-trace aggregation -------------------------------------------------

def _group_key(rec: Dict[str, Any], group_by: str) -> str:
    """tenant / signature / worker key for one record, read off the
    span attrs (the root carries tenant; CB spans carry the bucket
    signature; compute spans carry workers)."""
    spans = rec.get("spans") or []
    if group_by == "worker":
        workers = sorted({str((s.get("attrs") or {}).get("worker"))
                          for s in spans
                          if (s.get("attrs") or {}).get("worker")})
        return ",".join(workers) if workers else "master"
    attr = "tenant" if group_by == "tenant" else "bucket"
    for s in spans:
        v = (s.get("attrs") or {}).get(attr)
        if v:
            return str(v)
    return "unknown"


def collect_breakdowns(records: Iterable[Dict[str, Any]],
                       limit: Optional[int] = None) \
        -> List[Dict[str, Any]]:
    """Critical-path breakdowns for up to ``limit`` records (newest
    bias is the caller's ordering; the live ring hands newest-first)."""
    limit = limit if limit is not None else _max_traces()
    out = []
    for rec in records:
        if len(out) >= limit:
            break
        bd = critical_path(rec)
        if bd["e2e_s"] <= 0:
            continue
        bd["_rec"] = rec
        out.append(bd)
    return out


def aggregate(breakdowns: List[Dict[str, Any]],
              group_by: str = "tenant") -> Dict[str, Any]:
    """Per-group critical-path profiles: count, e2e percentiles, and
    mean seconds + share per blame category."""
    groups: Dict[str, Dict[str, Any]] = {}
    for bd in breakdowns:
        key = _group_key(bd.get("_rec") or {}, group_by)
        g = groups.setdefault(key, {"n": 0, "e2e": [], "gap": [],
                                    "cats": {}})
        g["n"] += 1
        g["e2e"].append(bd["e2e_s"])
        g["gap"].append(bd["unattributed_s"])
        for cat, v in bd["categories"].items():
            g["cats"].setdefault(cat, []).append(v)
    out: Dict[str, Any] = {}
    for key, g in sorted(groups.items()):
        e2e = sorted(g["e2e"])
        mean_e2e = sum(e2e) / len(e2e)
        cats = {}
        for cat in CATEGORIES:
            vals = g["cats"].get(cat)
            if not vals:
                continue
            mean = sum(vals) / g["n"]   # absent = 0 for that trace
            cats[cat] = {"mean_s": round(mean, 6),
                         "share_pct": round(mean / mean_e2e * 100.0, 2)
                         if mean_e2e else 0.0}
        out[key] = {
            "n": g["n"],
            "e2e_p50_s": round(_percentile(e2e, 0.50), 6),
            "e2e_p95_s": round(_percentile(e2e, 0.95), 6),
            "e2e_mean_s": round(mean_e2e, 6),
            "unattributed_mean_s": round(sum(g["gap"]) / g["n"], 6),
            "unattributed_pct": round(
                sum(g["gap"]) / sum(e2e) * 100.0, 3) if sum(e2e) else 0.0,
            "categories": cats,
        }
    return out


def straggler_scorecard(breakdowns: List[Dict[str, Any]],
                        threshold_x: Optional[float] = None) \
        -> Dict[str, Any]:
    """Per-worker compute health: p95 of per-span compute seconds vs
    the fleet-median worker's p95.  A worker past ``threshold_x`` times
    the median is flagged — the offline counterpart of the WorkLedger's
    hedging EMA (which reacts per-job, in-flight)."""
    threshold_x = threshold_x if threshold_x is not None \
        else straggler_x()
    per_worker: Dict[str, List[float]] = {}
    for bd in breakdowns:
        for s in (bd.get("_rec") or {}).get("spans") or []:
            cat = CATEGORY_OF.get(str(s.get("name")), "other")
            w = (s.get("attrs") or {}).get("worker")
            if cat != "compute" or not w:
                continue
            dur = float(s.get("duration_s") or 0.0)
            if dur > 0:
                per_worker.setdefault(str(w), []).append(dur)
    cards = {}
    p95s = []
    for w, vals in per_worker.items():
        vals.sort()
        p95s.append(_percentile(vals, 0.95))
    p95s.sort()
    fleet_median = _percentile(p95s, 0.50)
    for w, vals in sorted(per_worker.items()):
        p95 = _percentile(vals, 0.95)
        ratio = (p95 / fleet_median) if fleet_median else 1.0
        cards[w] = {"n_spans": len(vals),
                    "compute_p95_s": round(p95, 6),
                    "vs_fleet_median_x": round(ratio, 3),
                    "straggler": bool(ratio > threshold_x)}
    return {"fleet_median_p95_s": round(fleet_median, 6),
            "threshold_x": threshold_x, "workers": cards}


# --- regression diffing ------------------------------------------------------

def _cat_samples(breakdowns: List[Dict[str, Any]]) \
        -> Dict[str, List[float]]:
    out: Dict[str, List[float]] = {c: [] for c in CATEGORIES}
    out["e2e"] = []
    for bd in breakdowns:
        out["e2e"].append(bd["e2e_s"])
        for c in CATEGORIES:
            out[c].append(bd["categories"].get(c, 0.0))
    return out


def diff_breakdowns(a: List[Dict[str, Any]], b: List[Dict[str, Any]],
                    n_resamples: int = 500, seed: int = 0,
                    min_delta_pct: float = 10.0,
                    alpha: float = 0.05) -> Dict[str, Any]:
    """Per-category latency deltas A -> B with a permutation
    significance test.  A category is *flagged* when its mean moved
    more than ``min_delta_pct`` AND the permutation p-value (fraction
    of label-shuffled resamples with at least the observed |delta|)
    is below ``alpha``.  Seeded: the same two dirs always produce the
    same verdict."""
    sa, sb = _cat_samples(a), _cat_samples(b)
    rng = random.Random(seed)
    cats: Dict[str, Any] = {}
    flagged: List[str] = []
    for cat in ("e2e",) + CATEGORIES:
        va, vb = sa[cat], sb[cat]
        if not va or not vb:
            continue
        ma, mb = sum(va) / len(va), sum(vb) / len(vb)
        if ma <= 0 and mb <= 0:
            continue
        delta = mb - ma
        delta_pct = (delta / ma * 100.0) if ma else float("inf")
        pooled = va + vb
        hits = 0
        for _ in range(max(n_resamples, 1)):
            rng.shuffle(pooled)
            pa = pooled[:len(va)]
            pb = pooled[len(va):]
            d = sum(pb) / len(pb) - sum(pa) / len(pa)
            if abs(d) >= abs(delta):
                hits += 1
        p = hits / max(n_resamples, 1)
        entry = {"mean_a_s": round(ma, 6), "mean_b_s": round(mb, 6),
                 "delta_s": round(delta, 6),
                 "delta_pct": round(delta_pct, 3)
                 if delta_pct != float("inf") else None,
                 "p_value": round(p, 4),
                 "significant": bool(p < alpha)}
        entry["flagged"] = bool(
            entry["significant"] and delta > 0
            and (delta_pct == float("inf")
                 or abs(delta_pct) > min_delta_pct))
        cats[cat] = entry
        if entry["flagged"]:
            flagged.append(cat)
    return {"n_a": len(a), "n_b": len(b), "n_resamples": n_resamples,
            "categories": cats, "flagged": flagged,
            "regressed": bool(flagged)}


# --- baseline profiles + the live anomaly plane ------------------------------

def profile_from_breakdowns(breakdowns: List[Dict[str, Any]]) \
        -> Dict[str, Any]:
    """A committable baseline profile: fleet-wide mean seconds per
    category plus e2e stats (the live plane compares per-commit
    breakdowns against these means)."""
    if not breakdowns:
        return {"n": 0, "e2e_mean_s": 0.0, "categories": {}}
    n = len(breakdowns)
    e2e = sorted(bd["e2e_s"] for bd in breakdowns)
    cats = {}
    for cat in CATEGORIES:
        total = sum(bd["categories"].get(cat, 0.0) for bd in breakdowns)
        if total > 0:
            cats[cat] = round(total / n, 6)
    return {"n": n,
            "e2e_mean_s": round(sum(e2e) / n, 6),
            "e2e_p95_s": round(_percentile(e2e, 0.95), 6),
            "categories": cats}


def save_baseline(profile: Dict[str, Any], path: str) -> None:
    with open(path, "w", encoding="utf-8") as f:
        json.dump({"schema": 1, "kind": "dtpu_analysis_baseline",
                   **profile}, f, indent=1, sort_keys=True)
        f.write("\n")


def load_baseline(path: str) -> Optional[Dict[str, Any]]:
    try:
        with open(path, encoding="utf-8") as f:
            prof = json.load(f)
    except (OSError, ValueError) as e:
        log(f"analysis: unreadable baseline {path!r}: {e}")
        return None
    if not isinstance(prof, dict) or not prof.get("categories"):
        log(f"analysis: baseline {path!r} has no category profile")
        return None
    return prof


def detect_anomalies(breakdown: Dict[str, Any],
                     baseline: Dict[str, Any],
                     tolerance_pct: Optional[float] = None) \
        -> List[Dict[str, Any]]:
    """Category-level anomalies of one trace vs the baseline profile:
    a category whose blame seconds exceed the baseline mean by more
    than ``tolerance_pct`` (categories absent from the baseline are
    judged against the baseline's unclaimed e2e headroom, so a brand
    new cost center still flags)."""
    tol = tolerance_pct if tolerance_pct is not None else anomaly_pct()
    base_cats = baseline.get("categories") or {}
    base_e2e = float(baseline.get("e2e_mean_s") or 0.0)
    out = []
    for cat, v in (breakdown.get("categories") or {}).items():
        base = float(base_cats.get(cat, 0.0))
        if base <= 0:
            # unknown category: flag once it's a visible share of the
            # baseline's whole e2e (tol% of e2e, not of 0)
            if base_e2e > 0 and v > base_e2e * tol / 100.0:
                out.append({"category": cat, "baseline_s": 0.0,
                            "observed_s": v, "change_pct": None})
            continue
        change = (v - base) / base * 100.0
        if change > tol:
            out.append({"category": cat, "baseline_s": base,
                        "observed_s": v,
                        "change_pct": round(change, 2)})
    return out


# anomaly log rate limit: first flagged trace, then once per window
_ANOMALY_LOG_EVERY = 25


class LiveAnalyzer:
    """Process-wide on-commit analyzer.  Disarmed (no baseline) it is
    a cheap no-op on the commit path — one env read; armed, it scores
    each sealed trace against the baseline and accumulates anomaly
    counts + a rolling live profile for the metrics surfaces."""

    def __init__(self):
        self._lock = threading.Lock()
        self._baseline_path: Optional[str] = None  # guarded-by: self._lock
        self._baseline: Optional[Dict[str, Any]] = None  # guarded-by: self._lock
        self.anomalies_total = 0           # guarded-by: self._lock
        self.traces_analyzed = 0           # guarded-by: self._lock
        self._by_category: Dict[str, int] = {}   # guarded-by: self._lock
        self._cat_sums: Dict[str, float] = {}    # guarded-by: self._lock
        self._e2e_sum = 0.0                # guarded-by: self._lock
        self._gap_sum = 0.0                # guarded-by: self._lock
        self._last_anomalies: List[Dict[str, Any]] = []  # guarded-by: self._lock
        self._flagged_traces = 0           # guarded-by: self._lock

    def _baseline_locked(self) -> Optional[Dict[str, Any]]:
        path = (os.environ.get(C.ANALYSIS_BASELINE_ENV) or "").strip()
        if path != self._baseline_path:
            self._baseline_path = path
            self._baseline = load_baseline(path) if path else None
        return self._baseline

    def armed(self) -> bool:
        with self._lock:
            return self._baseline_locked() is not None

    def on_commit(self, rec: Dict[str, Any]) -> None:
        # fast path: one env read under the lock, no span walk
        with self._lock:
            baseline = self._baseline_locked()
        if baseline is None:
            return
        bd = critical_path(rec)
        if bd["e2e_s"] <= 0:
            return
        anomalies = detect_anomalies(bd, baseline)
        flagged_traces = 0
        with self._lock:
            self.traces_analyzed += 1
            self._e2e_sum += bd["e2e_s"]
            self._gap_sum += bd["unattributed_s"]
            for cat, v in bd["categories"].items():
                self._cat_sums[cat] = self._cat_sums.get(cat, 0.0) + v
            if anomalies:
                self.anomalies_total += len(anomalies)
                for a in anomalies:
                    self._by_category[a["category"]] = \
                        self._by_category.get(a["category"], 0) + 1
                self._last_anomalies = anomalies
                self._flagged_traces += 1
                flagged_traces = self._flagged_traces
        if anomalies and flagged_traces % _ANOMALY_LOG_EVERY == 1:
            # a sustained regression flags EVERY trace — log the first
            # then once per window; the counters and /distributed/
            # analysis carry the full story
            cats = ", ".join(
                f"{a['category']}"
                + (f"+{a['change_pct']}%" if a["change_pct"] is not None
                   else "(new)")
                for a in anomalies)
            log(f"analysis: anomaly on {rec.get('prompt_id')!r}: {cats}"
                f" ({flagged_traces} flagged trace(s) so far)")

    def snapshot(self) -> Dict[str, Any]:
        with self._lock:
            baseline = self._baseline_locked()
            n = self.traces_analyzed
            return {
                "armed": baseline is not None,
                "baseline": self._baseline_path or None,
                "traces_analyzed": n,
                "anomalies_total": self.anomalies_total,
                "anomalies_by_category": dict(sorted(
                    self._by_category.items())),
                "last_anomalies": list(self._last_anomalies),
                "live_profile": {
                    "e2e_mean_s": round(self._e2e_sum / n, 6) if n else 0.0,
                    "unattributed_mean_s": round(self._gap_sum / n, 6)
                    if n else 0.0,
                    "categories": {k: round(v / n, 6) for k, v
                                   in sorted(self._cat_sums.items())}
                    if n else {},
                },
            }

    def reset(self) -> None:
        with self._lock:
            self.anomalies_total = 0
            self.traces_analyzed = 0
            self._by_category = {}
            self._cat_sums = {}
            self._e2e_sum = 0.0
            self._gap_sum = 0.0
            self._last_anomalies = []
            self._flagged_traces = 0

    def total(self) -> int:
        with self._lock:
            return self.anomalies_total


LIVE = LiveAnalyzer()


def on_commit(rec: Dict[str, Any]) -> None:
    """FlightRecorder.commit tap (mirrors trace_export.on_commit):
    score one sealed trace against the committed baseline.  Runs on
    the thread that commits the trace."""
    try:
        LIVE.on_commit(rec)
    except Exception as e:  # noqa: BLE001 - analytics must never kill a commit
        log(f"analysis: on_commit failed: {type(e).__name__}: {e}")


def anomalies_total() -> int:
    return LIVE.total()


def reset_live() -> None:
    LIVE.reset()


def analyze_records(records: Iterable[Dict[str, Any]],
                    group_bys: Tuple[str, ...] = ("tenant", "signature",
                                                  "worker"),
                    limit: Optional[int] = None) -> Dict[str, Any]:
    """The full analytics pass `cli analyze` and the
    /distributed/analysis route share: breakdowns, per-group profiles,
    the straggler scorecard and gap health."""
    bds = collect_breakdowns(records, limit=limit)
    profiles = {g: aggregate(bds, group_by=g) for g in group_bys}
    gaps = [bd["unattributed_pct"] for bd in bds]
    neg = sum(bd["negative_edges"] for bd in bds)
    return {
        "n_traces": len(bds),
        "profiles": profiles,
        "stragglers": straggler_scorecard(bds),
        "fleet_profile": profile_from_breakdowns(bds),
        "unattributed_pct_mean": round(sum(gaps) / len(gaps), 3)
        if gaps else 0.0,
        "negative_edges": neg,
    }
