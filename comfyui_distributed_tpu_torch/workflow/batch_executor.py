"""Continuous batching: the step-granular denoise executor, the
counterpart of ``comfyui_distributed_tpu/workflow/batch_executor.py``.

The unit of scheduling is one denoise step of a padded batch, not a
whole prompt:

- **Buckets.**  Each coalescing signature (``scheduler.
  coalesce_signature``: one model, size, step count and sampler) gets a
  bucket, a padded batch on the card whose row count comes from a fixed
  pad set (``DTPU_CB_PAD_BUCKETS``), stepped by one callable a pad
  (``registry.denoise_step_fn``).
- **Slots.**  A slot holds one prompt's place in its schedule and its
  ``(seed, fold-in index)`` keys: the keys, initial noise and step
  expressions of its serial run (the step callable is the serial
  sampler's own, ``samplers.SAMPLER_STEPS``).
- **Joins at a step boundary.**  Between steps the driver pops through
  ``scheduler.pop_cb_admit`` (the stride order of the tenant classes)
  and a prompt joins its signature's running bucket, with the same
  class's same-signature prompts from anywhere in the queue.
- **Exit without draining.**  A finished prompt's rows leave at the
  boundary, the batch compacts along the pad set, and the rows go to
  the tail thread for decode and save while the bucket steps on.
- **Park and resume** (``DTPU_CB_PARK=1``).  A higher class's prompt
  arriving at a full bucket parks the youngest lowest-class row to the
  host (``runtime/jobs.ParkedStore``); so does device memory above
  ``DTPU_CB_PARK_HBM_FRACTION``.  A parked row resumes into a free slot
  at a later boundary, highest class first.
- **Fallback.**  A prompt the step model cannot serve (several
  samplers, masks, a sampler without an extracted step, an orchestrated
  share) runs through the one-dispatch path (``ServerState.
  _execute_group``) on the fallback thread.

Threads: the *driver* owns every bucket (admit, step, retire, park and
resume happen between its steps); the *tail* decodes retired slots; the
*fallback* runs ineligible groups.  Only the counters the metrics routes
read cross threads, under ``self._lock``.  Each step holds the server's
device lock and adds the attention launches it made to its bucket's
counts (``snapshot()``'s ``launches``), as a one-dispatch group's run
counts its own; the JAX package's per-bucket retrace counter counts the
step callables a bucket had built (one a pad, then none).

On the card cuBLAS and cuDNN choose algorithms by batch, so a row stepped
at pad p is not equal to the bit to its serial run at batch 1; within
one pad a row's arithmetic depends on its own inputs alone.

Off by default; ``DTPU_CB=1`` (or ``ServerState(cb=True)``) turns it on.
"""

from __future__ import annotations

import collections
import os
import queue as queue_mod
import threading
import time
from collections import deque
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from comfyui_distributed_tpu_torch.ops.base import (
    DeviceLatent,
    OpContext,
    as_device_array,
)
from comfyui_distributed_tpu_torch.ops.kernels import flash_attention as fa
from comfyui_distributed_tpu_torch.runtime import interrupt
from comfyui_distributed_tpu_torch.runtime import reuse as reuse_mod
from comfyui_distributed_tpu_torch.runtime.jobs import ParkedStore
from comfyui_distributed_tpu_torch.utils import constants as C
from comfyui_distributed_tpu_torch.utils import resource as resource_mod
from comfyui_distributed_tpu_torch.utils import trace as trace_mod
from comfyui_distributed_tpu_torch.utils.log import debug_log, log
from comfyui_distributed_tpu_torch.workflow import scheduler as sched_mod
from comfyui_distributed_tpu_torch.workflow.executor import WorkflowExecutor
from comfyui_distributed_tpu_torch.workflow.graph import parse_workflow
from comfyui_distributed_tpu_torch.workflow.orchestrate import (
    is_dispatched_share,
)


class CBIneligible(Exception):
    """The prompt passed the enqueue screen but not the bucket build's
    checks (a mask, regional or unCLIP conditioning, a non-plain seed):
    its signature goes to the fallback from then on."""


def _class_rank(cls: str) -> int:
    """Preemption rank: the position in ``CB_PREEMPT_ORDER`` (batch 0,
    free 1); a class outside it (paid) ranks above every one in it, so
    it is never parked."""
    try:
        return C.CB_PREEMPT_ORDER.index(str(cls))
    except ValueError:
        return len(C.CB_PREEMPT_ORDER)


def validate_cb_env(env: Dict[str, str]) -> None:
    """Refuse a malformed continuous-batching knob at a worker's launch,
    naming it, instead of in the driver's first admission."""

    def int_knob(name: str, lo: int, what: str) -> None:
        raw = env.get(name)
        if raw in (None, ""):
            return
        try:
            v = int(str(raw).strip())
        except ValueError:
            raise ValueError(
                f"{name}={raw!r}: not an integer ({what})") from None
        if v < lo:
            raise ValueError(f"{name}={raw!r}: must be >= {lo} ({what})")

    int_knob(C.CB_SLOTS_ENV, 1, "slots per bucket")
    int_knob(C.CB_PARK_MAX_ENV, 0, "max parked rows; 0 disables "
             "preemption while leaving DTPU_CB_PARK armed")
    raw = env.get(C.CB_PARK_ENV)
    if raw not in (None, "") and str(raw).strip().lower() not in (
            "0", "1", "true", "false", "yes", "no", "on", "off"):
        raise ValueError(f"{C.CB_PARK_ENV}={raw!r}: expected a boolean "
                         "('1'/'0')")
    raw = env.get(C.CB_PARK_HBM_FRACTION_ENV)
    if raw not in (None, ""):
        try:
            f = float(str(raw).strip())
        except ValueError:
            raise ValueError(
                f"{C.CB_PARK_HBM_FRACTION_ENV}={raw!r}: not a float "
                "(HBM residency gate)") from None
        if not 0.0 < f <= 1.0:
            raise ValueError(
                f"{C.CB_PARK_HBM_FRACTION_ENV}={raw!r}: must be in "
                "(0, 1] (fraction of the device memory limit)")


class _ParkedRow:
    """A parked slot on the host: its latent rows, the sigma index to
    resume at and its admit time (latency spans the parked gap).  Its
    keys are a function of its seed and are rebuilt at the resume."""

    __slots__ = ("pid", "item", "sig", "rank", "step", "t_admit",
                 "t_park", "x_rows")

    def __init__(self, item: Dict[str, Any], sig: str, rank: int,
                 step: int, t_admit: float, x_rows: np.ndarray,
                 t_park: float):
        self.pid = str(item["id"])
        self.item = item
        self.sig = sig
        self.rank = int(rank)
        self.step = int(step)
        self.t_admit = float(t_admit)
        self.t_park = float(t_park)
        self.x_rows = x_rows


def quick_eligible(prompt: Dict[str, Any]) -> bool:
    """The enqueue-time screen, on top of a coalescing signature (which
    already means the safe node set and an EmptyLatentImage source):
    one KSampler and one EmptyLatentImage, a sampler with an extracted
    step, integer widgets, not an orchestrated share.  The bucket build
    checks the conditioning once a signature."""
    ks = None
    n_ks = n_el = 0
    for node in prompt.values():
        if not isinstance(node, dict):
            continue
        ct = node.get("class_type")
        if ct == "KSampler":
            n_ks += 1
            ks = node
        elif ct == "EmptyLatentImage":
            n_el += 1
    if n_ks != 1 or n_el != 1 or ks is None:
        return False
    ins = ks.get("inputs", {})
    if str(ins.get("sampler_name")) not in C.CB_SAFE_SAMPLERS:
        return False
    try:
        if int(ins.get("steps", 0)) < 1:
            return False
        if float(ins.get("denoise", 1.0)) <= 0.0:
            return False
        int(ins.get("seed", 0))
    except (TypeError, ValueError):
        return False
    return not is_dispatched_share(prompt)


_KS_LINK_INPUTS = ("model", "positive", "negative", "latent_image")


def _links(node) -> List[str]:
    return [str(v[0]) for v in node.inputs.values()
            if isinstance(v, (list, tuple)) and len(v) == 2]


def tail_nodes(graph, ks_node: str) -> set:
    """The nodes a retired slot's decode needs: the KSampler, everything
    downstream of it and those nodes' other ancestors (the VAE's
    loader), not the sampler's own upstream (the encodes, the latent
    source), which its ``cb_latent`` stands in for."""
    down = {ks_node}
    changed = True
    while changed:
        changed = False
        for nid, node in graph.nodes.items():
            if nid not in down and any(s in down for s in _links(node)):
                down.add(nid)
                changed = True
    need = set(down)
    stack = [s for nid in down if nid != ks_node
             for s in _links(graph.nodes[nid])
             if s in graph.nodes and s not in need]
    while stack:
        nid = stack.pop()
        if nid in need:
            continue
        need.add(nid)
        stack.extend(s for s in _links(graph.nodes[nid])
                     if s in graph.nodes)
    return need


def build_tail_prompt(prompt: Dict[str, Any], keep: set,
                      ks_node: str) -> Dict[str, Any]:
    """A retired slot's decode graph (API format): the ``keep`` nodes,
    the KSampler without its upstream links.  Widgets, this prompt's
    seed among them, stay; the PNG embeds the whole prompt (the tail
    run's ``prompt_json``)."""
    out: Dict[str, Any] = {}
    for nid, node in prompt.items():
        if not isinstance(node, dict) or nid not in keep:
            continue
        node = dict(node)
        if nid == ks_node:
            node["inputs"] = {k: v for k, v
                              in dict(node.get("inputs", {})).items()
                              if k not in _KS_LINK_INPUTS}
        out[nid] = node
    return out


def _pad_set(max_slots: int) -> List[int]:
    """The pads a bucket steps at: ``DTPU_CB_PAD_BUCKETS`` within [1,
    max_slots], max_slots always among them."""
    raw = os.environ.get(C.CB_PAD_BUCKETS_ENV, C.CB_PAD_BUCKETS_DEFAULT)
    pads = set()
    for part in str(raw).split(","):
        try:
            p = int(part.strip())
        except ValueError:
            continue
        if 1 <= p <= max_slots:
            pads.add(p)
    pads.add(max_slots)
    return sorted(pads)


def _launch_counts() -> Tuple[Dict[str, int], Dict[tuple, int]]:
    return (dict(fa.flash_attention.variants),
            dict(fa.flash_attention.shapes))


class _Slot:
    """One admitted prompt's place in its schedule (driver thread)."""

    __slots__ = ("item", "step", "t_admit")

    def __init__(self, item: Dict[str, Any], t_admit: float):
        self.item = item
        self.step = 0            # the next sigma pair to run
        self.t_admit = t_admit


class _Bucket:
    """The padded batch of one signature; the driver thread owns it.
    Slot i holds rows [i*b, (i+1)*b) of ``x`` (on the card) and of
    ``keys`` (on the host, where the noise is hashed)."""

    def __init__(self, sig: str, item: Dict[str, Any], ctx: OpContext,
                 max_slots: int):
        from comfyui_distributed_tpu_torch.models import samplers as smp
        from comfyui_distributed_tpu_torch.models import schedules as sch
        from comfyui_distributed_tpu_torch.ops.basic import \
            _prepare_sample_inputs

        self.sig = sig
        graph = parse_workflow(item["prompt"])
        capture: Dict[str, Any] = {}
        # the encodes run for real; the KSampler records its inputs and
        # stops the run
        WorkflowExecutor(ctx).execute(graph, cb_capture=capture)
        if not capture:
            raise CBIneligible("graph never reached a KSampler")
        self.ks_node = next(nid for nid, n in graph.nodes.items()
                            if n.class_type == "KSampler")
        self.tail_keep = tail_nodes(graph, self.ks_node)
        pipe = capture["model"]
        seed = capture["seed"]
        if isinstance(seed, bool) or not isinstance(seed,
                                                    (int, np.integer)):
            raise CBIneligible("non-plain seed (SeedValue/distributed)")
        lat = capture["latent_image"]
        if lat.get("noise_mask") is not None \
                or lat.get("seed_fixed_batch"):
            raise CBIneligible("masked or fixed-seed-batch latent")
        dev = pipe.device
        samples = as_device_array(lat["samples"], dev)
        self.b = int(samples.shape[0])
        self.lat_shape = tuple(int(d) for d in samples.shape[1:])
        self.sampler_name = str(capture["sampler_name"])
        self.cfg = float(capture["cfg"])
        smp.get_sampler_step(self.sampler_name)   # raises on non-step
        for attr in ("sag_params", "hypernets", "deep_shrink_spec",
                     "perp_neg_cond"):
            if getattr(pipe, attr, None):
                raise CBIneligible(f"model patch present: {attr}")
        if float(getattr(pipe, "cfg_rescale", 0.0) or 0.0):
            raise CBIneligible("cfg_rescale patch present")
        self.sigmas_np = np.asarray(sch.compute_sigmas(
            pipe.schedule, str(capture["scheduler"]),
            int(capture["steps"]), float(capture["denoise"])), np.float32)
        if self.sigmas_np.shape[0] < 2:
            raise CBIneligible("degenerate sigma schedule")
        self.n_steps = int(self.sigmas_np.shape[0]) - 1
        self.pipe = pipe
        self.device = dev
        self.capacity = int(max_slots)
        self.pads = _pad_set(self.capacity)
        rows_max = self.capacity * self.b
        # the conditioning of every row at the largest pad, by the serial
        # sampler's own preamble: a slot's rows equal its serial run's
        prep = _prepare_sample_inputs(
            pipe, 0, {"samples": torch.zeros((rows_max,) + self.lat_shape,
                                             device=dev),
                      "local_batch": rows_max},
            capture["positive"], capture["negative"])
        if prep.control is not None or prep.noise_mask is not None \
                or prep.c_concat is not None \
                or prep.gligen_objs is not None \
                or isinstance(prep.y, (list, tuple)) \
                or isinstance(prep.context, list) \
                or isinstance(prep.uncond, list):
            raise CBIneligible("conditioning shape outside the plain "
                               "single-entry CFG case")
        self._ctx_full = prep.context
        self._unc_full = prep.uncond
        self._y_full = prep.y
        self.has_y = prep.y is not None
        self._per_pad: Dict[int, tuple] = {}
        self.slots: List[_Slot] = []
        self.pad = self.pads[0]
        with torch.inference_mode():
            self.x = torch.zeros((self.pad * self.b,) + self.lat_shape,
                                 device=dev)
        self.keys = np.zeros((self.pad * self.b, 2), np.uint32)
        self.admits = 0
        self.retires = 0
        self.steps_done = 0
        self.retraces = 0
        self.pad_transitions = 0
        self.launches: collections.Counter = collections.Counter()
        self.launches_by_shape: collections.Counter = collections.Counter()
        self.last_active = time.monotonic()

    @property
    def n_active(self) -> int:
        return len(self.slots)

    def _pad_for(self, n: int) -> int:
        for p in self.pads:
            if p >= max(n, 1):
                return p
        return self.pads[-1]

    def _rows_of(self, slots: List[int]) -> np.ndarray:
        return np.concatenate(
            [np.arange(i * self.b, (i + 1) * self.b, dtype=np.int64)
             for i in slots]) if slots else np.zeros((0,), np.int64)

    @torch.inference_mode()
    def _repad(self, keep: List[int],
               target: Optional[int] = None) -> None:
        """Rebuild the batch with ``keep``'s slots (old indices, in
        order) dense at the front, padded for ``target`` slots (default
        ``len(keep)``; an admit counts its incoming slots).  Pad rows
        copy row 0: inactive, they only fill the shape."""
        new_pad = self._pad_for(target if target is not None
                                else len(keep))
        perm = np.zeros(new_pad * self.b, np.int64)
        kept = self._rows_of(keep)
        perm[:kept.shape[0]] = kept
        self.x = self.x.index_select(
            0, torch.from_numpy(perm).to(self.device))
        self.keys = self.keys[perm]
        if new_pad != self.pad:
            self.pad_transitions += 1
        self.pad = new_pad

    def _write(self, n: int, x_rows: torch.Tensor,
               keys_rows: np.ndarray) -> None:
        lo, hi = n * self.b, n * self.b + int(x_rows.shape[0])
        self.x.index_copy_(0, torch.arange(lo, hi, device=self.device),
                           x_rows)
        self.keys[lo:hi] = keys_rows

    def _keys_for(self, items: List[Dict[str, Any]]) -> np.ndarray:
        """Each slot's keys, its serial run's: ``sample_keys(full(b,
        seed), arange(b))``."""
        from comfyui_distributed_tpu_torch.models.prng import sample_keys
        seeds = np.repeat(np.asarray(
            [int(it["prompt"][self.ks_node]["inputs"].get("seed", 0))
             for it in items], np.uint64), self.b)
        idx = np.tile(np.arange(self.b, dtype=np.uint32), len(items))
        return sample_keys(seeds, idx)

    def admit(self, item: Dict[str, Any]) -> int:
        """Join one prompt at the current boundary; its slot index."""
        return self.admit_many([item])

    @torch.inference_mode()
    def admit_many(self, items: List[Dict[str, Any]]) -> int:
        """Join a same-signature group at the current boundary with one
        key build, one noise draw and one write; the first slot index.
        Each slot starts as its serial run: zeros plus its initial noise
        times the first sigma."""
        from comfyui_distributed_tpu_torch.models.prng import (
            INIT_NOISE_INDEX,
            batch_normal,
        )
        k = len(items)
        n = self.n_active
        if n + k > self.capacity:
            raise RuntimeError("bucket full (driver admitted past room)")
        if n + k > self.pad:
            self._repad(list(range(n)), target=n + k)
        keys_rows = self._keys_for(items)
        noise = batch_normal(keys_rows, INIT_NOISE_INDEX, self.lat_shape,
                             self.device)
        x_rows = torch.zeros((k * self.b,) + self.lat_shape,
                             device=self.device) \
            + noise * float(self.sigmas_np[0])
        self._write(n, x_rows, keys_rows)
        now = time.perf_counter()
        for it in items:
            self.slots.append(_Slot(it, now))
        self.admits += k
        self.last_active = time.monotonic()
        return n

    def step_once(self) -> None:
        """Advance every slot one step of its own schedule: one call over
        the padded batch with per-row sigma and step vectors; pad rows
        pass through unchanged."""
        rows = self.pad * self.b
        sigma = np.ones((rows,), np.float32)
        sigma_next = np.ones((rows,), np.float32)
        step_v = np.zeros((rows,), np.int64)
        active = np.zeros((rows,), bool)
        for i, slot in enumerate(self.slots):
            lo, hi = i * self.b, (i + 1) * self.b
            sigma[lo:hi] = self.sigmas_np[slot.step]
            sigma_next[lo:hi] = self.sigmas_np[slot.step + 1]
            step_v[lo:hi] = slot.step
            active[lo:hi] = True
        cached = self._per_pad.get(rows)
        if cached is None:
            fn, built = self.pipe.denoise_step_fn(
                self.sampler_name, self.cfg, rows, self.lat_shape[:2],
                has_y=self.has_y)
            if built:
                self.retraces += 1
            cached = (self._ctx_full[:rows], self._unc_full[:rows],
                      self._y_full[:rows] if self.has_y else None, fn)
            self._per_pad[rows] = cached
        ctx_r, unc_r, y_r, fn = cached
        self.x = fn(self.x, ctx_r, unc_r, y_r, self.keys, sigma,
                    sigma_next, step_v, active)
        for slot in self.slots:
            slot.step += 1
        self.steps_done += 1
        self.last_active = time.monotonic()

    @torch.inference_mode()
    def take_finished(self) -> List[tuple]:
        """Take the finished slots' rows out and compact the batch: one
        cohort ``(items, rows, t_admit_first)``, its rows in item order,
        for one batched decode.  The rest keep stepping."""
        done = [i for i, s in enumerate(self.slots)
                if s.step >= self.n_steps]
        if not done:
            return []
        rows = self.x.index_select(
            0, torch.from_numpy(self._rows_of(done)).to(self.device))
        items = [self.slots[i].item for i in done]
        t0 = min(self.slots[i].t_admit for i in done)
        keep = [i for i, s in enumerate(self.slots)
                if s.step < self.n_steps]
        self.slots = [self.slots[i] for i in keep]
        self._repad(keep)
        self.retires += len(done)
        return [(items, rows, t0)]

    def drop_slots(self, drop: List[int]) -> List[Dict[str, Any]]:
        """Take slots out at a boundary (their clients left); the rest
        keep stepping.  Returns the dropped items."""
        doomed = set(drop)
        items = [self.slots[i].item for i in sorted(doomed)]
        keep = [i for i in range(len(self.slots)) if i not in doomed]
        self.slots = [self.slots[i] for i in keep]
        self._repad(keep)
        return items

    @torch.inference_mode()
    def park_slots(self, park: List[int]) -> List[tuple]:
        """Park: take ``park``'s slots out with their rows copied to the
        host: ``[(item, step, t_admit, x_rows), ...]``.  A repeated or
        unknown index raises (a double park would fork a slot)."""
        if len(set(park)) != len(park):
            raise ValueError(f"double-park of slot(s) {sorted(park)}")
        for i in park:
            if not 0 <= i < len(self.slots):
                raise ValueError(f"park of unknown slot {i} "
                                 f"({len(self.slots)} active)")
        order = sorted(park)
        rows = self.x.index_select(0, torch.from_numpy(
            self._rows_of(order)).to(self.device)).cpu().numpy()
        out = []
        for n, i in enumerate(order):
            s = self.slots[i]
            out.append((s.item, s.step, s.t_admit,
                        rows[n * self.b:(n + 1) * self.b]))
        keep = [i for i in range(len(self.slots)) if i not in set(order)]
        self.slots = [self.slots[i] for i in keep]
        self._repad(keep)
        return out

    @torch.inference_mode()
    def resume_parked(self, recs: List[Any]) -> int:
        """Resume: :meth:`park_slots` undone at a later boundary, the rows
        written back from the host and the keys rebuilt from each seed as
        at the admit.  The first slot index."""
        k = len(recs)
        n = self.n_active
        if n + k > self.capacity:
            raise RuntimeError("bucket full (driver resumed past room)")
        if n + k > self.pad:
            self._repad(list(range(n)), target=n + k)
        x_rows = torch.from_numpy(np.concatenate(
            [np.asarray(r.x_rows, np.float32) for r in recs])).to(
            self.device)
        self._write(n, x_rows, self._keys_for([r.item for r in recs]))
        for r in recs:
            slot = _Slot(r.item, r.t_admit)
            slot.step = int(r.step)
            self.slots.append(slot)
        self.last_active = time.monotonic()
        return n

    def abort_all(self) -> List[Dict[str, Any]]:
        items = [s.item for s in self.slots]
        self.slots = []
        self._repad([])
        return items


class ContinuousBatchExecutor:
    """The ``DTPU_CB=1`` queue consumer over one ``ServerState``: driver,
    tail and fallback threads (module docstring)."""

    def __init__(self, state: Any):
        self.state = state
        self.max_slots = max(1, int(os.environ.get(
            C.CB_SLOTS_ENV, C.CB_SLOTS_DEFAULT)))
        self.max_buckets = max(1, int(os.environ.get(
            C.CB_MAX_BUCKETS_ENV, C.CB_MAX_BUCKETS_DEFAULT)))
        try:
            self.admit_window = max(0.0, float(os.environ.get(
                C.CB_ADMIT_WINDOW_ENV, C.CB_ADMIT_WINDOW_DEFAULT)))
        except ValueError:
            self.admit_window = C.CB_ADMIT_WINDOW_DEFAULT
        self.park_enabled = str(os.environ.get(
            C.CB_PARK_ENV, "0")).strip().lower() in ("1", "true", "yes",
                                                     "on")
        try:
            park_max = max(0, int(os.environ.get(
                C.CB_PARK_MAX_ENV, C.CB_PARK_MAX_DEFAULT)))
        except ValueError:
            park_max = C.CB_PARK_MAX_DEFAULT
        try:
            self.park_hbm_fraction = float(os.environ.get(
                C.CB_PARK_HBM_FRACTION_ENV,
                C.CB_PARK_HBM_FRACTION_DEFAULT))
        except ValueError:
            self.park_hbm_fraction = C.CB_PARK_HBM_FRACTION_DEFAULT
        # capacity 0 while parking is off: every park path sees no room
        self.parked = ParkedStore(park_max if self.park_enabled else 0)
        self._mem_probe = None    # a test seam; None: the device's memory
        self._buckets: Dict[str, _Bucket] = {}     # driver thread only
        self._bad_sigs: set = set()                # driver thread only
        self._rr = 0                               # round-robin cursor
        self._tail_q: "queue_mod.Queue" = queue_mod.Queue()
        self._fallback_q: "queue_mod.Queue" = queue_mod.Queue()
        self._fallback_busy = False                # driver + fallback
        self._stop = False
        self._threads: List[threading.Thread] = []
        self._lock = threading.Lock()
        self._stats = {"admits": 0, "retires": 0, "steps": 0,
                       "fallbacks": 0, "retraces": 0,
                       "pad_transitions": 0, "abandoned": 0,
                       "parks": 0, "resumes": 0,
                       "preemptions": 0}           # guarded-by: self._lock
        self._bucket_stats: Dict[str, Dict[str, Any]] = {}  # guarded-by: self._lock
        self._active = 0                           # guarded-by: self._lock
        self._tailing = 0                          # guarded-by: self._lock
        # popped for a bucket, not in a slot yet (the bucket build)
        self._admitting = 0                        # guarded-by: self._lock
        # the flight deck: a row a step boundary and the admit-to-first-
        # step histogram (cli flightdeck)
        try:
            deck_ring = max(1, int(os.environ.get(
                C.CB_DECK_RING_ENV, C.CB_DECK_RING_DEFAULT)))
        except ValueError:
            deck_ring = C.CB_DECK_RING_DEFAULT
        self._deck: deque = deque(maxlen=deck_ring)  # guarded-by: self._lock
        self._deck_seq = 0                         # guarded-by: self._lock
        self._deck_prev = {"admits": 0, "retires": 0,
                           "preemptions": 0}       # driver thread only
        self.admit_to_first_step = trace_mod.LatencyHistogram()

    # -- lifecycle ------------------------------------------------------------

    def start(self) -> None:
        for name, target in (("dtpu-cb-drive", self._drive),
                             ("dtpu-cb-tail", self._tail_loop),
                             ("dtpu-cb-fallback", self._fallback_loop)):
            t = threading.Thread(target=target, daemon=True, name=name)
            t.start()
            self._threads.append(t)

    def stop(self) -> None:
        """Stop the driver; the tail and fallback threads end after what
        they hold."""
        if self._stop:
            return
        self._stop = True
        self._tail_q.put(None)
        self._fallback_q.put(None)

    # -- views (any thread) ---------------------------------------------------

    def active_prompts(self) -> int:
        """Prompts in slots or decoding (not the parked ones)."""
        with self._lock:
            return self._active + self._tailing + self._admitting

    def parked_count(self) -> int:
        """The parked backlog, the autoscaler's reader (any thread: the
        store locks itself)."""
        return self.parked.count()

    def idle(self) -> bool:
        with self._lock:
            busy = self._active or self._tailing or self._admitting \
                or self._fallback_busy
        return not busy and self._fallback_q.empty() \
            and self._tail_q.empty() and self.parked.count() == 0

    def snapshot(self) -> Dict[str, Any]:
        with self._lock:
            stats = dict(self._stats)
            buckets = [dict(v) for v in self._bucket_stats.values()]
            active = self._active
            tailing = self._tailing
            deck = [dict(r) for r in self._deck]
            deck_ring = self._deck.maxlen
        launches: collections.Counter = collections.Counter()
        for b in buckets:
            launches.update(b["launches"])
        slots_total = self.max_buckets * self.max_slots
        return {
            "enabled": True,
            "running": bool(active or tailing),
            "max_slots": self.max_slots,
            "max_buckets": self.max_buckets,
            "pad_buckets": _pad_set(self.max_slots),
            "slots_active": active,
            "slots_free": max(slots_total - active, 0),
            "buckets": buckets,
            "launches": dict(launches),
            "park_enabled": self.park_enabled,
            "parked": self.parked.count(),
            "park_room": self.parked.room(),
            "deck": deck,
            "deck_ring": deck_ring,
            "admit_to_first_step": self.admit_to_first_step.snapshot(),
            **stats,
        }

    def _deck_record(self, bkt: _Bucket) -> None:
        """One step boundary's row: busy, free and parked slots and the
        admits, retires and preemptions since the previous row."""
        parked = self.parked.count()
        with self._lock:
            cur = {k: self._stats[k] for k in self._deck_prev}
            self._deck.append({
                "seq": self._deck_seq, "t": round(time.time(), 3),
                "bucket": bkt.sig[:8],
                "busy": bkt.n_active,
                "free": max(bkt.capacity - bkt.n_active, 0),
                "parked": parked,
                "admits": cur["admits"] - self._deck_prev["admits"],
                "retires": cur["retires"] - self._deck_prev["retires"],
                "preemptions": cur["preemptions"]
                - self._deck_prev["preemptions"],
            })
            self._deck_seq += 1
        self._deck_prev = cur

    def _mirror_stats(self) -> None:
        """The driver's bucket numbers into the view the routes read."""
        per = {
            b.sig: {"sig": b.sig[:8], "slots_active": b.n_active,
                    "slots_max": b.capacity, "pad": b.pad,
                    "batch_rows": b.pad * b.b, "admits": b.admits,
                    "retires": b.retires, "steps": b.steps_done,
                    "retraces": b.retraces,
                    "pad_transitions": b.pad_transitions,
                    "launches": dict(b.launches),
                    "launches_by_shape": [[*key, n] for key, n in
                                          sorted(b.launches_by_shape
                                                 .items())]}
            for b in self._buckets.values()}
        active = sum(b.n_active for b in self._buckets.values())
        with self._lock:
            self._bucket_stats = per
            self._active = active
            self._stats["pad_transitions"] = sum(
                b.pad_transitions for b in self._buckets.values())

    # -- admission (driver thread) --------------------------------------------

    def _class_of(self, item: Dict[str, Any]) -> str:
        return str(item.get("tenant")
                   or self.state.admission.default_class)

    def _preemptible(self, bkt: _Bucket, item: Dict[str, Any]) -> int:
        """``bkt``'s slots whose class ranks below ``item``'s."""
        new_rank = _class_rank(self._class_of(item))
        return sum(1 for s in bkt.slots
                   if _class_rank(self._class_of(s.item)) < new_rank)

    def room_for(self, item: Dict[str, Any]) -> int:
        """``pop_cb_admit``'s capacity oracle: > 0 admit that many now,
        -1 batchable but full (a slot exit frees room), 0 not batchable
        (the fallback).  With parking on, a full bucket takes as many of
        a higher class as it holds lower-class rows (bounded by the
        parked store's room); the park happens in :meth:`_admit_cb`."""
        sig = item.get("sig")
        if not item.get("cb") or sig is None or sig in self._bad_sigs:
            return 0
        bkt = self._buckets.get(sig)
        if bkt is not None:
            free = bkt.capacity - bkt.n_active
            if free > 0:
                return free
            if self.park_enabled:
                k = min(self._preemptible(bkt, item), self.parked.room())
                if k > 0:
                    return k
            return -1
        if len(self._buckets) < self.max_buckets:
            return self.max_slots
        if any(b.n_active == 0 for b in self._buckets.values()):
            return self.max_slots
        return -1

    def _evict_idle_bucket(self) -> None:
        # a bucket whose rows are all parked is idle but kept: its
        # conditioning is what they resume into
        parked_sigs = set(self.parked.sigs())
        idle = [(b.last_active, sig) for sig, b in self._buckets.items()
                if b.n_active == 0 and sig not in parked_sigs]
        if idle:
            _, sig = min(idle)
            self._buckets.pop(sig, None)
            debug_log(f"cb: evicted idle bucket {sig[:8]}")

    def _fresh_ctx(self, item: Optional[Dict[str, Any]] = None
                   ) -> OpContext:
        st = self.state
        return OpContext(
            device=st.device, models_dir=st.models_dir,
            input_dir=st.input_dir, output_dir=st.output_dir,
            is_worker=st.is_worker, job_store=st.jobs,
            cluster=st.cluster, ledger=st.ledger,
            fault_inject=st.fault_inject, host_pool=st.host_pool,
            extra_pnginfo=(item or {}).get("extra_data", {}).get(
                "extra_pnginfo"))

    @staticmethod
    def _record_queue_wait(items: List[Dict[str, Any]]) -> None:
        now = time.perf_counter()
        now_wall = time.time()
        for item in items:
            wait = now - item.get("t_enq", now)
            trace_mod.GLOBAL_STAGES.record("queue_wait", wait)
            if item.get("span") is not None:
                trace_mod.event_span("queue_wait", now_wall - wait,
                                     now_wall, parent=item["span"])

    def _to_fallback(self, items: List[Dict[str, Any]]) -> None:
        with self._lock:
            self._stats["fallbacks"] += len(items)
        self._fallback_busy = True
        with self.state._cond:
            self.state._running = True
        self._fallback_q.put(items)

    def _admit_boundary(self) -> bool:
        """Pop and admit at a step boundary until the queue, the room or
        the stride says stop.  True when anything was dispatched."""
        st = self.state
        st._purge_abandoned()
        got = False
        while not self._stop:
            if not st._exec_gate.is_set():
                break
            with st._cond:
                if not st._queue:
                    break
                kind, items = sched_mod.pop_cb_admit(
                    st._queue, st.admission, self.room_for,
                    fallback_ok=not self._fallback_busy,
                    legacy_max=st.coalesce_max
                    if st.coalesce_enabled else 1)
                if kind == "fallback":
                    st._running = True
                    self._fallback_busy = True
                elif kind == "cb":
                    with self._lock:
                        self._admitting += len(items)
            if kind == "defer" or not items:
                break
            try:
                got = self._dispatch(kind, items) or got
            finally:
                if kind == "cb":
                    self._mirror_stats()
                    with self._lock:
                        self._admitting -= len(items)
        if got:
            self._mirror_stats()
        return got

    def _dispatch(self, kind: str, items: List[Dict[str, Any]]) -> bool:
        """One popped group: to a bucket or to the fallback."""
        st = self.state
        # each item waits for its admission record; one that failed
        # to log was answered so
        for item in items:
            if item.get("logged") is not None:
                item["logged"].wait()
        items = [it for it in items if "log_error" not in it]
        if not items:
            if kind == "fallback":
                self._fallback_busy = False
                with st._cond:
                    st._running = False
            return False
        self._record_queue_wait(items)
        if kind == "fallback":
            with self._lock:
                self._stats["fallbacks"] += len(items)
            self._fallback_q.put(items)
        else:
            self._admit_cb(items)
        return True

    def _admit_cb(self, items: List[Dict[str, Any]]) -> None:
        sig = items[0]["sig"]
        bkt = self._buckets.get(sig)
        if bkt is None:
            if len(self._buckets) >= self.max_buckets:
                self._evict_idle_bucket()
            try:
                bkt = _Bucket(sig, items[0], self._fresh_ctx(items[0]),
                              self.max_slots)
            except Exception as e:  # noqa: BLE001 - to the fallback
                self._bad_sigs.add(sig)
                if isinstance(e, CBIneligible):
                    debug_log(f"cb: {sig[:8]} ineligible: {e}")
                else:
                    log(f"cb: bucket build failed for {sig[:8]}: "
                        f"{type(e).__name__}: {e}")
                self._to_fallback(items)
                return
            self._buckets[sig] = bkt
        # preemption: a group admitted into a full bucket (room_for
        # counted lower-class rows) parks them first
        need = bkt.n_active + len(items) - bkt.capacity
        if need > 0 and self.park_enabled:
            self._park_victims(bkt, need, items[0])
        now_wall = time.time()
        try:
            first_slot = bkt.admit_many(items)
        except Exception as e:  # noqa: BLE001 - the items are popped
            # they must not vanish: the fallback runs or fails them, each
            # with its history entry
            log(f"cb: admit failed for {sig[:8]}: {type(e).__name__}: {e}")
            self._bad_sigs.add(sig)
            self._buckets.pop(sig, None)
            self._fail_parked(sig, e)
            for item in bkt.abort_all():
                self.state._finalize_hand([item], None, e,
                                          time.perf_counter())
            self._to_fallback(items)
            return
        trace_mod.GLOBAL_COUNTERS.bump("cb_admits", len(items))
        with self._lock:
            self._stats["admits"] += len(items)
        for off, item in enumerate(items):
            item["started_at"] = now_wall
            if item.get("span") is not None:
                trace_mod.event_span(
                    "cb_admit", now_wall, now_wall, parent=item["span"],
                    attrs={"bucket": sig[:8], "slot": first_slot + off})
            debug_log(f"cb: {item['id']} joined bucket {sig[:8]} "
                      f"slot {first_slot + off} "
                      f"({bkt.n_active}/{bkt.capacity})")

    # -- park and resume (driver thread) --------------------------------------

    def _park_victims(self, bkt: _Bucket, need: int,
                      incoming: Dict[str, Any]) -> None:
        """Park up to ``need`` lower-class slots for ``incoming``: the
        lowest class first, the youngest admit first within a class (the
        oldest work keeps its slot)."""
        new_rank = _class_rank(self._class_of(incoming))
        cands = [(i, s) for i, s in enumerate(bkt.slots)
                 if _class_rank(self._class_of(s.item)) < new_rank]
        cands.sort(key=lambda t: (
            _class_rank(self._class_of(t[1].item)), -t[1].t_admit))
        victims = [i for i, _ in
                   cands[:min(need, len(cands), self.parked.room())]]
        if victims:
            self._park_out(bkt, victims, preempted_by=incoming)

    def _park_out(self, bkt: _Bucket, indices: List[int],
                  preempted_by: Optional[Dict[str, Any]] = None) -> None:
        """Copy ``indices``'s slots to the host and register them: the
        one writer of parked records (:meth:`_resume_boundary` the one
        reader); the ``cb_park`` spans and the parked gauge."""
        t_park = time.perf_counter()
        now_wall = time.time()
        recs = [_ParkedRow(item, bkt.sig,
                           _class_rank(self._class_of(item)),
                           step, t_admit, x_rows, t_park)
                for item, step, t_admit, x_rows
                in bkt.park_slots(indices)]
        self.parked.park(recs)
        # the park's own seconds: the copy to the host and the repad
        trace_mod.GLOBAL_STAGES.record("cb_park",
                                       time.perf_counter() - t_park)
        trace_mod.GLOBAL_COUNTERS.bump("cb_parks", len(recs))
        if preempted_by is not None:
            trace_mod.GLOBAL_COUNTERS.bump("cb_preemptions", len(recs))
        trace_mod.GLOBAL_GAUGES.set("cb_parked", self.parked.count())
        with self._lock:
            self._stats["parks"] += len(recs)
            if preempted_by is not None:
                self._stats["preemptions"] += len(recs)
        for rec in recs:
            if rec.item.get("span") is not None:
                attrs = {"bucket": bkt.sig[:8], "step": rec.step,
                         "tenant": self._class_of(rec.item)}
                if preempted_by is not None:
                    attrs["preempted_by"] = self._class_of(preempted_by)
                trace_mod.event_span("cb_park", now_wall, now_wall,
                                     parent=rec.item["span"], attrs=attrs)
            debug_log(f"cb: {rec.pid} parked from bucket {bkt.sig[:8]} "
                      f"at step {rec.step} ({self.parked.count()} parked)")

    def _mem_fraction(self) -> Optional[float]:
        """The device memory in use over its limit, or None without a
        limit (the CPU): then only slot pressure parks."""
        probe = self._mem_probe
        try:
            snap = (probe() if probe is not None else
                    resource_mod.device_memory_snapshot(self.state.device)
                    ) or {}
        except Exception:  # noqa: BLE001 - telemetry must not kill the driver
            return None
        limit = snap.get("bytes_limit")
        if not limit:
            return None
        return float(snap.get("bytes_in_use", 0) or 0) / float(limit)

    def _pressure_park(self) -> None:
        """Above the memory fraction, park one lowest-class slot a
        boundary (gradual: a passing spike does not evict a class)."""
        if self.parked.room() <= 0:
            return
        frac = self._mem_fraction()
        if frac is None or frac < self.park_hbm_fraction:
            return
        best = None   # ((rank, -t_admit), bucket, slot index)
        for bkt in self._buckets.values():
            for i, s in enumerate(bkt.slots):
                r = _class_rank(self._class_of(s.item))
                if r >= len(C.CB_PREEMPT_ORDER):
                    continue
                key = (r, -s.t_admit)
                if best is None or key < best[0]:
                    best = (key, bkt, i)
        if best is not None:
            self._park_out(best[1], [best[2]])
            self._mirror_stats()

    def _finalize_err(self, items: List[Dict[str, Any]],
                      err: BaseException) -> None:
        for item in items:
            self.state._finalize_hand([item], None, err,
                                      time.perf_counter())

    def _exit_spans(self, items: List[Dict[str, Any]], sig: str) -> None:
        now_wall = time.time()
        for item in items:
            if item.get("span") is not None:
                trace_mod.event_span("cb_exit", now_wall, now_wall,
                                     parent=item["span"],
                                     attrs={"bucket": sig[:8]})

    def _drop_abandoned_parked(self) -> None:
        """A parked row whose client left is freed, finalized
        ``abandoned``, never resumed."""
        gone = self.parked.pop_abandoned(reuse_mod.PREVIEWS.is_abandoned)
        if not gone:
            return
        trace_mod.GLOBAL_COUNTERS.bump("cb_abandoned", len(gone))
        trace_mod.GLOBAL_GAUGES.set("cb_parked", self.parked.count())
        with self._lock:
            self._stats["abandoned"] += len(gone)
        for rec in gone:
            self._exit_spans([rec.item], rec.sig)
            debug_log(f"cb: parked {rec.pid} abandoned (client gone)")
        self._finalize_err([r.item for r in gone], reuse_mod.AbandonedError(
            "client disconnected while parked"))

    def _fail_parked(self, sig: str, err: BaseException) -> None:
        """A bucket died with rows of its signature parked: they fail,
        their conditioning gone with it."""
        recs = self.parked.pop_for(sig, self.parked.count())
        if recs:
            trace_mod.GLOBAL_GAUGES.set("cb_parked", self.parked.count())
            self._finalize_err([r.item for r in recs], err)

    def _resume_boundary(self) -> bool:
        """Refill free slots from the parked store, highest class first,
        FIFO within a class, unless device memory is above the fraction.
        It runs after the queue's admission, so the stride keeps first
        claim and a resumed row is never parked again by the same
        boundary.  True when anything resumed."""
        if self.parked.count() == 0:
            return False
        self._drop_abandoned_parked()
        frac = self._mem_fraction()
        if frac is not None and frac >= self.park_hbm_fraction:
            return False
        moved = False
        for sig in self.parked.sigs():
            bkt = self._buckets.get(sig)
            if bkt is None:
                # eviction skips parked signatures: the bucket died on
                # an error path
                self._fail_parked(sig, RuntimeError(
                    f"bucket {sig[:8]} lost while rows were parked"))
                continue
            free = bkt.capacity - bkt.n_active
            recs = self.parked.pop_for(sig, free) if free > 0 else []
            if not recs:
                continue
            now_wall = time.time()
            t0 = time.perf_counter()
            try:
                first_slot = bkt.resume_parked(recs)
                trace_mod.GLOBAL_STAGES.record("cb_resume",
                                               time.perf_counter() - t0)
            except Exception as e:  # noqa: BLE001 - rows must not vanish
                log(f"cb: resume failed in bucket {sig[:8]}: "
                    f"{type(e).__name__}: {e}")
                self._finalize_err([r.item for r in recs], e)
                continue
            moved = True
            trace_mod.GLOBAL_COUNTERS.bump("cb_resumes", len(recs))
            with self._lock:
                self._stats["resumes"] += len(recs)
            for off, rec in enumerate(recs):
                if rec.item.get("span") is not None:
                    trace_mod.event_span(
                        "cb_resume", now_wall, now_wall,
                        parent=rec.item["span"],
                        attrs={"bucket": sig[:8], "slot": first_slot + off,
                               "step": rec.step})
                debug_log(f"cb: {rec.pid} resumed into bucket {sig[:8]} "
                          f"slot {first_slot + off} at step {rec.step}")
            # a row parked at its last boundary has no step left
            self._retire_cohorts(bkt)
        if moved:
            trace_mod.GLOBAL_GAUGES.set("cb_parked", self.parked.count())
            self._mirror_stats()
        return moved

    # -- the step loop (driver thread) ----------------------------------------

    def _next_bucket(self) -> Optional[_Bucket]:
        live = [b for b in self._buckets.values() if b.n_active]
        if not live:
            return None
        self._rr = (self._rr + 1) % len(live)
        return live[self._rr]

    def _drop_abandoned(self, bkt: _Bucket) -> None:
        """Slots whose last preview client left exit at this boundary,
        finalized ``abandoned``; their slots free for the next admit."""
        bus = reuse_mod.PREVIEWS
        doomed = [i for i, s in enumerate(bkt.slots)
                  if bus.is_abandoned(s.item["id"])]
        if not doomed:
            return
        items = bkt.drop_slots(doomed)
        trace_mod.GLOBAL_COUNTERS.bump("cb_abandoned", len(items))
        with self._lock:
            self._stats["abandoned"] += len(items)
        self._exit_spans(items, bkt.sig)
        self._finalize_err(items, reuse_mod.AbandonedError(
            "client disconnected mid-denoise"))
        self._mirror_stats()

    def _publish_previews(self, bkt: _Bucket) -> None:
        """A latent preview of each watched slot every
        ``DTPU_PREVIEW_EVERY`` boundaries (one lookup a slot while no
        one watches)."""
        bus = reuse_mod.PREVIEWS
        every = reuse_mod.preview_every()
        for i, slot in enumerate(bkt.slots):
            pid = slot.item["id"]
            if slot.step % every == 0 and bus.wants(pid):
                bus.publish_latent(pid, slot.step, bkt.n_steps,
                                   bkt.x[i * bkt.b])

    def _step_and_retire(self, bkt: _Bucket) -> None:
        self._drop_abandoned(bkt)
        if not bkt.slots:
            return
        first_timers = [s for s in bkt.slots if s.step == 0]
        built_before = bkt.retraces
        t0 = time.perf_counter()
        try:
            # the device lock: a fallback group's counts and this step's
            # never mix
            with self.state._device_lock:
                v0, s0 = _launch_counts()
                bkt.step_once()
                v1, s1 = _launch_counts()
        except Exception as e:  # noqa: BLE001 - the bucket dies, not the loop
            log(f"cb: step failed in bucket {bkt.sig[:8]}: "
                f"{type(e).__name__}: {e}")
            self._bad_sigs.add(bkt.sig)
            self._finalize_err(bkt.abort_all(), e)
            self._buckets.pop(bkt.sig, None)
            self._fail_parked(bkt.sig, e)
            self._mirror_stats()
            return
        t1 = time.perf_counter()
        for k, n in v1.items():
            if n - v0.get(k, 0):
                bkt.launches[k] += n - v0.get(k, 0)
        for k, n in s1.items():
            if n - s0.get(k, 0):
                bkt.launches_by_shape[k] += n - s0.get(k, 0)
        trace_mod.GLOBAL_STAGES.record("cb_step", t1 - t0)
        # admit to the end of the first step: time at the boundary,
        # which queue_wait does not see
        for s in first_timers:
            wait = max(t1 - s.t_admit, 0.0)
            sp = s.item.get("span")
            tid = sp.trace_id if sp is not None else None
            self.admit_to_first_step.record(wait, trace_id=tid)
            trace_mod.GLOBAL_STAGES.record("cb_admit_to_first_step", wait,
                                           trace_id=tid)
        built = bkt.retraces - built_before
        if built:
            trace_mod.GLOBAL_COUNTERS.bump("cb_retraces", built)
        trace_mod.GLOBAL_COUNTERS.bump("cb_steps")
        with self._lock:
            self._stats["steps"] += 1
            self._stats["retraces"] += built
        if reuse_mod.previews_enabled():
            self._publish_previews(bkt)
        self._retire_cohorts(bkt)
        self._mirror_stats()
        self._deck_record(bkt)

    def _retire_cohorts(self, bkt: _Bucket) -> bool:
        """Every finished slot to the decode tail (the step loop's and a
        resume's: a row resumed at its last boundary retires unstepped)."""
        finished = bkt.take_finished()
        for items, rows, t_admit in finished:
            trace_mod.GLOBAL_COUNTERS.bump("cb_retires", len(items))
            with self._lock:
                self._stats["retires"] += len(items)
                self._tailing += len(items)
            self._exit_spans(items, bkt.sig)
            self._tail_q.put((bkt, items, rows, t_admit))
        return bool(finished)

    def _abort_active(self, err: BaseException) -> None:
        for bkt in list(self._buckets.values()):
            self._finalize_err(bkt.abort_all(), err)
        self._finalize_err([r.item for r in self.parked.drain_all()], err)
        trace_mod.GLOBAL_GAUGES.set("cb_parked", 0)
        self._mirror_stats()

    def _queue_waiting(self) -> bool:
        with self.state._cond:
            return bool(self.state._queue)

    def _wait_queue(self, timeout: float) -> None:
        with self.state._cond:
            if not self.state._queue:
                self.state._cond.wait(timeout)

    def _drive(self) -> None:
        st = self.state
        batch_started = None
        while not self._stop:
            try:
                if not st._exec_gate.is_set():
                    st._exec_gate.wait(0.05)
                    continue
                if interrupt.is_interrupted():
                    active = any(b.n_active for b in self._buckets.values()) \
                        or self.parked.count()
                    if active or self._fallback_busy:
                        # a running fallback group must still see the
                        # flag: consume it only without one
                        if not self._fallback_busy:
                            interrupt.clear_interrupt()
                        self._abort_active(
                            InterruptedError("execution interrupted"))
                        time.sleep(0.005)
                        continue
                    if self._queue_waiting():
                        # a stale flag with work queued: consumed at the
                        # dispatch, as the one-dispatch loop does
                        interrupt.clear_interrupt()
                    else:
                        # nothing here to interrupt: the flag is not
                        # ours to consume
                        self._wait_queue(0.05)
                        continue
                admitted = self._admit_boundary()
                resumed = False
                if self.park_enabled:
                    # shed under memory pressure, then refill free slots
                    # from the parked rows (the queue took its share)
                    self._pressure_park()
                    resumed = self._resume_boundary()
                bkt = self._next_bucket()
                if bkt is None:
                    batch_started = None
                    if not admitted and not resumed:
                        if self._queue_waiting():
                            # queued work that cannot dispatch now (a
                            # busy fallback, a full bucket)
                            time.sleep(0.005)
                        else:
                            self._wait_queue(0.02)
                    continue
                if batch_started is None:
                    batch_started = time.monotonic()
                    if self.admit_window > 0:
                        # linger at a new batch's first boundary for a
                        # burst's later arrivals
                        deadline = batch_started + self.admit_window
                        while time.monotonic() < deadline \
                                and not self._stop:
                            self._wait_queue(min(0.005,
                                                 self.admit_window))
                            self._admit_boundary()
                self._step_and_retire(bkt)
            except Exception as e:  # noqa: BLE001 - the loop must survive
                log(f"cb driver error: {type(e).__name__}: {e}")
                time.sleep(0.1)

    # -- the tail (decode, save) and fallback threads -------------------------

    def _decode(self, job: tuple) -> None:
        bkt, items, rows, t_admit = job
        k = len(items)
        first = items[0]
        res, err = None, None
        try:
            ctx = self._fresh_ctx(first)
            # one tail run over the cohort's rows; the coalesced PNG
            # metadata gives each prompt its own seed and history entry
            ctx.coalesce = k
            hidden: Dict[str, Dict[str, Any]] = {
                bkt.ks_node: {"cb_latent": DeviceLatent(rows)}}
            if k > 1:
                hidden[bkt.ks_node]["coalesced_seeds"] = [
                    int(it["prompt"][bkt.ks_node]["inputs"].get("seed", 0))
                    for it in items]
            with trace_mod.use_span(first.get("span")), \
                    trace_mod.span("cb_decode", bucket=bkt.sig[:8],
                                   coalesced=k):
                res = WorkflowExecutor(ctx).execute(
                    build_tail_prompt(first["prompt"], bkt.tail_keep,
                                      bkt.ks_node),
                    hidden=hidden,
                    # the PNGs embed the whole graph, as a one-dispatch
                    # run's do
                    prompt_json=parse_workflow(
                        first["prompt"]).to_api_format())
        except Exception as e:  # noqa: BLE001 - surfaces in history
            err = e
        with self._lock:
            self._tailing -= k
        self.state._finalize_hand(
            items, res, err, t_admit,
            {"launches": {}, "launches_by_shape": [],
             "max_memory_allocated": None, "cb_bucket": bkt.sig[:8]})

    def _tail_loop(self) -> None:
        while True:
            job = self._tail_q.get()
            if job is None:
                return
            # the job lives in _decode's frame alone: no loop variable
            # keeps a finished cohort's tensors alive
            self._decode(job)
            del job

    def _fallback_loop(self) -> None:
        while True:
            group = self._fallback_q.get()
            if group is None:
                return
            try:
                self.state._execute_group(group)
            finally:
                with self.state._cond:
                    self.state._running = False
                self._fallback_busy = False
                del group
