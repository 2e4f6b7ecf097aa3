"""The elastic-fleet autoscaler: the counterpart of
``comfyui_distributed_tpu/runtime/autoscale.py``.

A master that owns a work ledger and lease-based worker liveness can
treat its worker pool as elastic: workers join by registration, leave
by lease expiry, and the ledger reassigns what a leaver still owed.  A
reconciliation thread on the master reads the fleet's telemetry (the
federated queue depth from the registry, the utilization estimate of
``utils/resource.py``, the parked continuous-batching backlog, the paid
class's SLO burn rate and a sharded master's gossiped peer depths),
holds it against thresholds, and spawns or retires workers.

Every decision passes three gates, so it converges instead of reacting:

- a *sustained window*: the signal sits beyond its bar for
  ``DTPU_AUTOSCALE_WINDOW`` consecutive samples;
- *hysteresis*: the scale-down bars sit strictly below the scale-up
  bars, so a signal oscillating between them does nothing;
- a *cooldown*: after any action the loop waits
  ``DTPU_AUTOSCALE_COOLDOWN_S`` before the next.

A scale-up calls the ``spawner`` (by default a local ``cli worker``
launched through the process manager and added to the config).  A
scale-down drains by lease non-renewal: the victim, the youngest worker
this loop spawned, is marked RETIRING in the registry (the dispatcher
gives it no new work); once its queue reads empty it is stopped and
forgotten, or, at the drain deadline, stopped and kept so its lease
ages to DEAD and the ledger reassigns what it still owed.

Every decision lands in a bounded ring (``GET /distributed/fleet``,
``cli fleet``) and bumps an ``autoscale_*`` counter; a reversal within
the flap window of the previous action counts as a flap.  The decisions
are the JAX package's, call for call, on the same inputs and clock.
"""

from __future__ import annotations

import os
import threading
import time
from collections import deque
from typing import Any, Callable, Dict, List, Optional

from comfyui_distributed_tpu_torch.utils import clock as clock_mod
from comfyui_distributed_tpu_torch.utils import constants as C
from comfyui_distributed_tpu_torch.utils import trace as trace_mod
from comfyui_distributed_tpu_torch.utils.log import debug_log, log


def _env_float(name: str, default: float) -> float:
    try:
        return float(os.environ.get(name, default))
    except ValueError:
        return float(default)


def _env_int(name: str, default: int) -> int:
    try:
        return int(os.environ.get(name, default))
    except ValueError:
        return int(default)


def autoscale_armed() -> bool:
    return os.environ.get(C.AUTOSCALE_ENV, "0").lower() \
        in ("1", "true", "on")


class FleetAutoscaler:
    """The reconciliation loop.

    ``queue_depth_fn`` gives the master's queued and running prompts;
    the workers' half of the depth comes from ``worker_queue_fn`` or the
    registry's ``queue_remaining``.  ``util_fn`` gives the utilization
    in [0, 1] (or None).  ``spawner()`` starts one worker and returns
    its id (None on failure); ``retirer(worker_id)`` stops a drained
    worker.  ``pending_fn`` (the port's, None in the JAX package) counts
    the workers started but not yet live in the registry: a cold start
    (seconds of imports and a card to open) that outlasts the lease is
    capacity on its way, not a worker to spawn again.  Every bound left
    None reads its ``DTPU_AUTOSCALE_*`` variable."""

    def __init__(self,
                 registry,
                 queue_depth_fn: Callable[[], int],
                 util_fn: Optional[Callable[[], Optional[float]]] = None,
                 spawner: Optional[Callable[[], Optional[str]]] = None,
                 retirer: Optional[Callable[[str], bool]] = None,
                 worker_queue_fn: Optional[Callable[[str], Optional[int]]]
                 = None,
                 min_workers: Optional[int] = None,
                 max_workers: Optional[int] = None,
                 up_queue: Optional[float] = None,
                 down_queue: Optional[float] = None,
                 up_util: Optional[float] = None,
                 down_util: Optional[float] = None,
                 window: Optional[int] = None,
                 cooldown_s: Optional[float] = None,
                 interval_s: Optional[float] = None,
                 drain_s: Optional[float] = None,
                 flap_window_s: Optional[float] = None,
                 shard: Optional[Any] = None,
                 parked_backlog_fn: Optional[Callable[[], int]] = None,
                 slo_burn_fn: Optional[Callable[[], Optional[float]]]
                 = None,
                 pending_fn: Optional[Callable[[], int]] = None,
                 clock: Optional[Any] = None):
        # cooldowns, drain deadlines and decision timestamps
        self._clock = clock if clock is not None else clock_mod.WALL
        self.registry = registry
        self.queue_depth_fn = queue_depth_fn
        self.util_fn = util_fn
        self.spawner = spawner
        self.retirer = retirer
        self.worker_queue_fn = worker_queue_fn
        # parked continuous-batching rows left the queue at admission
        # but are unfinished work: they fold into the scale-up signal
        self.parked_backlog_fn = parked_backlog_fn
        # the paid class's fast burn over 1.0 scales up even when the
        # queue looks shallow (DTPU_AUTOSCALE_SLO=1)
        self.slo_burn_fn = slo_burn_fn
        self.pending_fn = pending_fn
        # a sharded master's ShardManager: its peers' gossiped depths
        # join the signal, and only the ring's actuator acts
        self.shard = shard
        self.min_workers = _env_int(C.AUTOSCALE_MIN_ENV,
                                    C.AUTOSCALE_MIN_DEFAULT) \
            if min_workers is None else int(min_workers)
        self.max_workers = _env_int(C.AUTOSCALE_MAX_ENV,
                                    C.AUTOSCALE_MAX_DEFAULT) \
            if max_workers is None else int(max_workers)
        self.up_queue = _env_float(C.AUTOSCALE_UP_QUEUE_ENV,
                                   C.AUTOSCALE_UP_QUEUE_DEFAULT) \
            if up_queue is None else float(up_queue)
        self.down_queue = _env_float(C.AUTOSCALE_DOWN_QUEUE_ENV,
                                     C.AUTOSCALE_DOWN_QUEUE_DEFAULT) \
            if down_queue is None else float(down_queue)
        self.up_util = _env_float(C.AUTOSCALE_UP_UTIL_ENV,
                                  C.AUTOSCALE_UP_UTIL_DEFAULT) \
            if up_util is None else float(up_util)
        self.down_util = _env_float(C.AUTOSCALE_DOWN_UTIL_ENV,
                                    C.AUTOSCALE_DOWN_UTIL_DEFAULT) \
            if down_util is None else float(down_util)
        self.window = max(_env_int(C.AUTOSCALE_WINDOW_ENV,
                                   C.AUTOSCALE_WINDOW_DEFAULT)
                          if window is None else int(window), 1)
        self.cooldown_s = _env_float(C.AUTOSCALE_COOLDOWN_ENV,
                                     C.AUTOSCALE_COOLDOWN_DEFAULT) \
            if cooldown_s is None else float(cooldown_s)
        self.interval_s = max(
            _env_float(C.AUTOSCALE_INTERVAL_ENV,
                       C.AUTOSCALE_INTERVAL_DEFAULT)
            if interval_s is None else float(interval_s), 0.02)
        self.drain_s = _env_float(C.AUTOSCALE_DRAIN_ENV,
                                  C.AUTOSCALE_DRAIN_DEFAULT) \
            if drain_s is None else float(drain_s)
        # a reversal is a FLAP when it lands before the previous action
        # could have moved the signal: within two cooldowns, capped
        self.flap_window_s = min(2.0 * self.cooldown_s,
                                 C.AUTOSCALE_FLAP_S) \
            if flap_window_s is None else float(flap_window_s)
        # the loop thread and the HTTP handlers' snapshot() share these
        self._over_streak = 0                     # guarded-by: self._lock
        self._under_streak = 0                    # guarded-by: self._lock
        self._last_action: Optional[str] = None   # guarded-by: self._lock
        self._last_action_t: Optional[float] = None  # guarded-by: self._lock
        self._spawned: List[str] = []             # guarded-by: self._lock
        self._retiring: Dict[str, float] = {}     # guarded-by: self._lock
        self.decisions: deque = deque(
            maxlen=C.AUTOSCALE_DECISIONS_KEPT)    # guarded-by: self._lock
        self.flaps = 0                            # guarded-by: self._lock
        self.scale_ups = 0                        # guarded-by: self._lock
        self.scale_downs = 0                      # guarded-by: self._lock
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # -- signal ---------------------------------------------------------------

    def fleet_signal(self) -> Dict[str, Any]:
        """One federated sample: the master's depth, every live
        worker's, the peers' and the parked backlog, over the
        participants, with the utilization and the paid burn rate."""
        from comfyui_distributed_tpu_torch.runtime import cluster as cl
        master_q = 0
        try:
            master_q = int(self.queue_depth_fn() or 0)
        except Exception as e:  # noqa: BLE001 - the loop survives
            debug_log(f"autoscale: queue probe failed: {e}")
        worker_q = 0
        live = 0
        snap = self.registry.snapshot()["workers"] \
            if self.registry is not None else {}
        for wid, w in snap.items():
            if w["state"] in (cl.HEALTHY, cl.SUSPECT, cl.RETIRING):
                live += 1
                q = self._worker_queue(wid, registry_hint=w)
                worker_q += int(q or 0)
        util = None
        if self.util_fn is not None:
            try:
                util = self.util_fn()
            except Exception as e:  # noqa: BLE001
                debug_log(f"autoscale: util probe failed: {e}")
        # the workers are shared by the shards, so their backlog is
        # counted once, here; the peers add their own queues
        peer_q = 0
        peer_masters = 0
        if self.shard is not None:
            try:
                peer_q = int(self.shard.peer_queue_depth())
                peer_masters = int(self.shard.live_peer_masters())
            except Exception as e:  # noqa: BLE001
                debug_log(f"autoscale: shard signal failed: {e}")
        parked = 0
        if self.parked_backlog_fn is not None:
            try:
                parked = int(self.parked_backlog_fn() or 0)
            except Exception as e:  # noqa: BLE001
                debug_log(f"autoscale: parked probe failed: {e}")
        slo_burn = None
        if self.slo_burn_fn is not None:
            try:
                slo_burn = self.slo_burn_fn()
            except Exception as e:  # noqa: BLE001
                debug_log(f"autoscale: slo probe failed: {e}")
        pending = 0
        if self.pending_fn is not None:
            try:
                pending = int(self.pending_fn() or 0)
            except Exception as e:  # noqa: BLE001
                debug_log(f"autoscale: pending probe failed: {e}")
        live += pending
        participants = 1 + live + peer_masters   # masters serve too
        depth = master_q + worker_q + peer_q + parked
        out = {
            "queue_depth": depth,
            "queue_per_participant": depth / participants,
            "utilization": util,
            "live_workers": live,
            "participants": participants,
        }
        if pending:
            out["pending_workers"] = pending
        if parked:
            out["parked_backlog"] = parked
        if slo_burn is not None:
            out["slo_burn"] = round(float(slo_burn), 4)
        if self.shard is not None:
            out["peer_masters"] = peer_masters
            out["peer_queue_depth"] = peer_q
        return out

    # -- decision -------------------------------------------------------------

    def _record(self, action: str, reason: str, now: float,
                signal: Dict[str, Any],
                worker_id: Optional[str] = None) -> None:
        entry = {"t": self._clock.time(), "action": action,
                 "reason": reason,
                 "worker_id": worker_id,
                 "queue_per_participant": round(
                     signal.get("queue_per_participant", 0.0), 3),
                 "utilization": signal.get("utilization"),
                 "live_workers": signal.get("live_workers")}
        # decide and mutate under one hold, so a snapshot() never reads
        # torn decision state; the log and counters come after
        flap_delta: Optional[float] = None
        with self._lock:
            self.decisions.append(entry)
            if action in ("up", "down"):
                prev, prev_t = self._last_action, self._last_action_t
                if prev is not None and prev != action \
                        and prev_t is not None \
                        and now - prev_t < self.flap_window_s:
                    self.flaps += 1
                    flap_delta = now - prev_t
                self._last_action, self._last_action_t = action, now
        if action in ("up", "down"):
            if flap_delta is not None:
                trace_mod.GLOBAL_COUNTERS.bump("autoscale_flaps")
                log(f"autoscale: FLAP — {action} within "
                    f"{flap_delta:.1f}s of the previous action "
                    f"(hysteresis/window too tight for this workload)")
            trace_mod.GLOBAL_COUNTERS.bump(f"autoscale_{action}")
            log(f"autoscale: scale {action} ({reason})"
                + (f" worker={worker_id}" if worker_id else ""))

    def _in_cooldown(self, now: float) -> bool:
        with self._lock:
            return (self._last_action_t is not None
                    and now - self._last_action_t < self.cooldown_s)

    def sample_once(self, now: Optional[float] = None) -> Dict[str, Any]:
        """One reconciliation step, without the thread (tests drive it on
        a fake clock).  Returns the sample and the action taken ("up",
        "down", "retire_done" or None)."""
        now = self._clock.monotonic() if now is None else now
        signal = self.fleet_signal()
        # retirements in flight finish first (their drain is async)
        action = self._reap_retiring(now)
        qpp = signal["queue_per_participant"]
        util = signal["utilization"]
        slo_burn = signal.get("slo_burn")
        slo_hot = slo_burn is not None and slo_burn > 1.0
        over = qpp > self.up_queue or (util is not None
                                       and util > self.up_util) \
            or slo_hot
        under = qpp < self.down_queue and (util is None
                                           or util < self.down_util)
        # the streaks under the lock; the spawner and retirer (process
        # and registry work) outside it
        with self._lock:
            self._over_streak = self._over_streak + 1 if over else 0
            self._under_streak = self._under_streak + 1 if under else 0
            over_ready = over and self._over_streak >= self.window
            under_ready = under and self._under_streak >= self.window
        if self._in_cooldown(now):
            return {**signal, "action": action, "cooldown": True}
        # every sharded master folds in the same backlog: only the
        # ring's designated actuator acts, the others keep sampling
        # (and reaping their own retirements, above)
        if self.shard is not None:
            try:
                actuator = bool(self.shard.is_autoscale_actuator())
            except Exception:  # noqa: BLE001 - fail open: act alone
                actuator = True
            if not actuator:
                return {**signal, "action": action, "cooldown": False,
                        "actuator": False}
        live = signal["live_workers"]
        if over_ready and live < self.max_workers \
                and self.spawner is not None:
            wid = None
            try:
                wid = self.spawner()
            except Exception as e:  # noqa: BLE001 - the loop survives
                log(f"autoscale: spawn failed: {type(e).__name__}: {e}")
            if wid:
                with self._lock:
                    self._spawned.append(str(wid))
                    self.scale_ups += 1
                    self._over_streak = 0
                if qpp > self.up_queue:
                    reason = (f"queue/participant {qpp:.2f} > "
                              f"{self.up_queue:g}")
                elif util is not None and util > self.up_util:
                    reason = (f"utilization {util:.2f} > "
                              f"{self.up_util:g}")
                else:
                    reason = (f"paid SLO burn rate {slo_burn:.2f} > 1 "
                              f"(fast window)")
                self._record("up", reason, now, signal, wid)
                action = "up"
        elif under_ready and live > self.min_workers \
                and self.retirer is not None:
            wid = self._pick_retirement_victim()
            if wid is not None:
                if self.registry is not None:
                    self.registry.set_retiring(wid, True)
                with self._lock:
                    self.scale_downs += 1
                    self._retiring[wid] = now + self.drain_s
                    self._under_streak = 0
                self._record(
                    "down",
                    f"queue/participant {qpp:.2f} < "
                    f"{self.down_queue:g} (drain via lease non-renewal)",
                    now, signal, wid)
                action = "down"
        return {**signal, "action": action, "cooldown": False}

    def _pick_retirement_victim(self) -> Optional[str]:
        """The youngest worker this loop spawned and is not retiring yet
        (the config's own fleet is never scaled away)."""
        with self._lock:
            for wid in reversed(self._spawned):
                if wid not in self._retiring:
                    return wid
        return None

    def _worker_queue(self, wid: str,
                      registry_hint: Optional[Dict[str, Any]] = None
                      ) -> Optional[int]:
        """A worker's queued prompts: the injected probe when it knows
        the worker, else the registry's probe- or heartbeat-carried
        value."""
        if self.worker_queue_fn is not None:
            try:
                q = self.worker_queue_fn(wid)
                if q is not None:
                    return q
            except Exception:  # noqa: BLE001 - unknown, not zero
                pass
        w = registry_hint
        if w is None and self.registry is not None:
            w = self.registry.snapshot()["workers"].get(wid)
        return None if w is None else w.get("queue_remaining")

    def _reap_retiring(self, now: float) -> Optional[str]:
        """A retiring worker whose queue reads empty, or whose drain
        deadline passed, is stopped.  An unknown queue waits for the
        deadline: retiring is reversible until the process stops."""
        with self._lock:
            pending = list(self._retiring.items())
        finished = None
        for wid, deadline in pending:
            q = self._worker_queue(wid)
            if not (q == 0 or now >= deadline):
                continue
            forced = q not in (0, None)
            try:
                if self.retirer is not None:
                    self.retirer(wid)
            except Exception as e:  # noqa: BLE001
                log(f"autoscale: retire of {wid} failed: {e}")
            with self._lock:
                self._retiring.pop(wid, None)
                if wid in self._spawned:
                    self._spawned.remove(wid)
            if self.registry is not None and not forced:
                # drained clean: nothing in flight names it.  A forced
                # stop keeps the record: the drains find a lost owner by
                # its DEAD state once the lease ages out, and a forgotten
                # id would read UNKNOWN forever
                self.registry.forget(wid)
            trace_mod.GLOBAL_COUNTERS.bump("autoscale_retired")
            debug_log(f"autoscale: worker {wid} retired"
                      + (" (drain deadline; lease will age to DEAD and "
                         "the ledger reassigns the remainder)"
                         if forced else " (drained clean)"))
            finished = "retire_done"
        return finished

    # -- lifecycle ------------------------------------------------------------

    def start(self) -> None:
        if self._thread is not None:
            return
        self._stop.clear()

        def run():
            while not self._stop.wait(self.interval_s):
                try:
                    self.sample_once()
                except Exception as e:  # noqa: BLE001 - the loop survives
                    log(f"autoscale: reconcile error: "
                        f"{type(e).__name__}: {e}")

        self._thread = threading.Thread(target=run, daemon=True,
                                        name="dtpu-autoscale")
        self._thread.start()
        log(f"autoscale: armed (interval {self.interval_s:g}s, window "
            f"{self.window} samples, up>{self.up_queue:g} q/p or "
            f">{self.up_util:g} util, down<{self.down_queue:g} q/p, "
            f"cooldown {self.cooldown_s:g}s, workers "
            f"[{self.min_workers}, {self.max_workers}])")

    def stop(self) -> None:
        self._stop.set()
        t = self._thread
        if t is not None:
            t.join(timeout=2 * self.interval_s + 1.0)
        self._thread = None

    def snapshot(self) -> Dict[str, Any]:
        with self._lock:
            return {
                "enabled": True,
                "running": self._thread is not None
                and self._thread.is_alive(),
                "interval_s": self.interval_s,
                "window": self.window,
                "cooldown_s": self.cooldown_s,
                "thresholds": {
                    "up_queue_per_participant": self.up_queue,
                    "down_queue_per_participant": self.down_queue,
                    "up_utilization": self.up_util,
                    "down_utilization": self.down_util,
                },
                "bounds": {"min_workers": self.min_workers,
                           "max_workers": self.max_workers},
                "scale_ups": self.scale_ups,
                "scale_downs": self.scale_downs,
                "flaps": self.flaps,
                "spawned": list(self._spawned),
                "retiring": sorted(self._retiring),
                "decisions": list(self.decisions),
            }


def default_spawner(state) -> Callable[[], Optional[str]]:
    """Add an ``auto_*`` worker on a free port to the config and launch
    it through the process manager as ``cli worker`` on the master's
    device and models directory.  It inherits ``DTPU_WORKER_ID`` and
    ``DTPU_MASTER_URL`` (from the environment or the config's ``master``
    section), so it heartbeats its lease here; the health poller and the
    next fan-out's preflight probe it either way."""
    from comfyui_distributed_tpu_torch.utils import config as cfg_mod
    from comfyui_distributed_tpu_torch.utils.net import find_free_port
    counter = {"n": 0}

    def spawn() -> Optional[str]:
        counter["n"] += 1
        wid = f"auto_{int(time.time())}_{counter['n']}"
        worker = {"id": wid, "name": wid, "host": "127.0.0.1",
                  "port": find_free_port(), "enabled": True,
                  "extra_args": f"--host 127.0.0.1 --device {state.device}"}
        cfg_mod.mutate_config(
            lambda cfg: cfg.setdefault("workers", []).append(worker),
            state.config_path)
        try:
            state.manager.launch_worker(worker)
        except BaseException:
            cfg_mod.mutate_config(
                lambda cfg: cfg_mod.delete_worker(cfg, wid),
                state.config_path)
            raise
        return wid

    return spawn


def default_retirer(state) -> Callable[[str], bool]:
    """Stop the managed process and drop the worker from the config (the
    registry ages its lease out on its own)."""
    from comfyui_distributed_tpu_torch.utils import config as cfg_mod

    def retire(worker_id: str) -> bool:
        ok = state.manager.stop_worker(worker_id)
        try:
            cfg_mod.mutate_config(
                lambda cfg: cfg_mod.delete_worker(cfg, str(worker_id)),
                state.config_path)
        except Exception as e:  # noqa: BLE001 - config cleanup best-effort
            debug_log(f"autoscale: config cleanup of {worker_id}: {e}")
        return ok

    return retire


def install(state) -> Optional[FleetAutoscaler]:
    """Arm and start the autoscaler for a master ``state`` under
    ``DTPU_AUTOSCALE=1``: its queue depth, the resource monitor's
    utilization, the parked backlog, the paid class's fast burn rate
    (``DTPU_AUTOSCALE_SLO=1`` with a spec) and the shard plane, with
    the default spawner and retirer.  None when unarmed (the
    default)."""
    if not autoscale_armed():
        return None
    from comfyui_distributed_tpu_torch.utils import resource as resource_mod
    from comfyui_distributed_tpu_torch.utils import slo as slo_mod

    def util() -> Optional[float]:
        u = resource_mod.fleet_sample().get("utilization")
        return float(u) if isinstance(u, (int, float)) else None

    cb = getattr(state, "cb", None)
    slo_engine = getattr(state, "slo", None)
    slo_burn_fn = None
    if slo_mod.autoscale_slo_armed() and slo_engine is not None \
            and slo_engine.enabled:
        def slo_burn() -> Optional[float]:
            return slo_engine.burn_rate(C.TENANT_DEFAULT_CLASS, "fast")

        slo_burn_fn = slo_burn
    def pending() -> int:
        # spawned, its process alive and starting, the registry not
        # holding it live yet
        from comfyui_distributed_tpu_torch.runtime import cluster as cl
        live = {w for w, r in state.cluster.snapshot()["workers"].items()
                if r["state"] in (cl.HEALTHY, cl.SUSPECT, cl.RETIRING)}
        managed = state.manager.get_managed_workers()
        return sum(1 for w in scaler.snapshot()["spawned"]
                   if w not in live and managed.get(w, {}).get("alive")
                   and managed[w].get("launching"))

    scaler = FleetAutoscaler(
        registry=state.cluster,
        queue_depth_fn=state.queue_remaining,
        util_fn=util,
        spawner=default_spawner(state),
        retirer=default_retirer(state),
        shard=getattr(state, "shard", None),
        parked_backlog_fn=cb.parked_count if cb is not None else None,
        slo_burn_fn=slo_burn_fn,
        pending_fn=pending,
    )
    scaler.start()
    return scaler
