"""The chaos fault-injection harness: the counterpart of
``comfyui_distributed_tpu/utils/chaos.py``.

A control plane that survives dropped and delayed HTTP edges, spurious
5xx answers, frozen heartbeats and corrupted uploads has to be run
under them.  This module is the one switchboard for those faults, armed
from the environment (a ``DTPU_CHAOS`` JSON spec) or by
:func:`set_chaos`, so each injection site stays a one-liner:

- ``utils/net.post_form_with_retry`` calls :meth:`ChaosMonkey.client_edge`
  before each attempt (a drop raises :class:`ChaosDropError`, which the
  retry loop handles as a transport error; a delay sleeps);
- ``server/app.py``'s ``_dispatch`` calls :meth:`ChaosMonkey.server_edge`
  before a handler runs, so a matching route answers 503 or waits a
  share of the time (the JAX package does this in an aiohttp
  middleware; the port's server is ``http.server``);
- the server's upload decoder runs each payload through
  :meth:`ChaosMonkey.corrupt` (a corrupted upload fails its decode with
  a 500 and is sent again clean);
- ``runtime/cluster.HeartbeatSender`` asks
  :meth:`ChaosMonkey.heartbeat_frozen` (a frozen heartbeat ages a live
  worker's lease to dead).

One ``random.Random`` seeded from the spec (``"seed"`` or
``DTPU_CHAOS_SEED``) draws every roll, so the same spec and the same
calls give the JAX harness's faults.  Every injection bumps a
``chaos_*`` event counter; with no spec armed an edge costs one env
read and a string compare.
"""

from __future__ import annotations

import json
import os
import random
import threading
import time
from typing import Any, Dict, Optional

from comfyui_distributed_tpu_torch.utils import constants as C
from comfyui_distributed_tpu_torch.utils import trace as trace_mod
from comfyui_distributed_tpu_torch.utils.log import debug_log, log


class ChaosDropError(ConnectionError):
    """A dropped client edge (a retryable transport failure)."""


class ChaosMonkey:
    """One parsed injection spec, its seeded RNG and its counters."""

    def __init__(self, spec: Optional[Dict[str, Any]] = None):
        spec = dict(spec or {})
        self.spec = spec
        self.drop_pct = float(spec.get("drop_pct", 0) or 0)
        self.delay_pct = float(spec.get("delay_pct", 0) or 0)
        self.delay_s = float(spec.get("delay_s",
                                      C.CHAOS_DELAY_DEFAULT_S) or 0)
        self.http_5xx_pct = float(spec.get("http_5xx_pct", 0) or 0)
        self.corrupt_pct = float(spec.get("corrupt_pct", 0) or 0)
        # True freezes every sender; a list only those worker ids
        fh = spec.get("freeze_heartbeats", False)
        self.freeze_all = fh is True
        self.freeze_ids = set(str(x) for x in fh) \
            if isinstance(fh, (list, tuple, set)) else set()
        self.routes = tuple(spec.get("routes") or C.CHAOS_DEFAULT_ROUTES)
        seed = spec.get("seed", os.environ.get(C.CHAOS_SEED_ENV))
        self._rng = random.Random(int(seed) if seed is not None else None)
        self._lock = threading.Lock()

    @property
    def active(self) -> bool:
        return bool(self.drop_pct or self.delay_pct or self.http_5xx_pct
                    or self.corrupt_pct or self.freeze_all
                    or self.freeze_ids)

    def _roll(self, pct: float) -> bool:
        if pct <= 0:
            return False
        with self._lock:
            return self._rng.uniform(0, 100) < pct

    def _bump(self, kind: str, what: str) -> None:
        trace_mod.GLOBAL_COUNTERS.bump(f"chaos_{kind}")
        # inside a traced operation the injection joins the job's trace,
        # so `cli trace` shows where it landed
        sp = trace_mod.capture_span_context()
        if sp is not None:
            now = time.time()
            trace_mod.event_span(f"chaos_{kind}", now, now, parent=sp,
                                 attrs={"target": str(what)[:120]})
        debug_log(f"chaos: injected {kind} on {what}")

    # -- the client's HTTP edge (post_form_with_retry) ------------------------

    def client_edge(self, url: str, what: str = "send") -> float:
        """Before each send attempt: raises :class:`ChaosDropError` for a
        dropped edge, else returns the extra delay in seconds (0 for
        none) for the caller to sleep."""
        if self._roll(self.drop_pct):
            self._bump("drop", f"{what} {url}")
            raise ChaosDropError(f"chaos: dropped {what} to {url}")
        if self._roll(self.delay_pct):
            self._bump("delay", f"{what} {url}")
            return max(self.delay_s, 0.0)
        return 0.0

    # -- the server's HTTP edge (server/app.py _dispatch) ---------------------

    def route_matches(self, path: str) -> bool:
        return any(path.startswith(r) for r in self.routes)

    def server_edge(self, path: str):
        """``(status or None, delay_s)`` for a request on a matching
        route: a 503 a share of the time, a delay a share, else pass."""
        if not self.route_matches(path):
            return None, 0.0
        if self._roll(self.http_5xx_pct):
            self._bump("5xx", path)
            return 503, 0.0
        if self._roll(self.delay_pct):
            self._bump("delay", path)
            return None, max(self.delay_s, 0.0)
        return None, 0.0

    # -- the upload decoder's edge --------------------------------------------

    def corrupt(self, data: bytes, what: str = "upload") -> bytes:
        """Maybe flip 16 bytes in the middle of an upload (headers and
        checksums cannot hide it).  The corruption is per delivery: the
        sender's retry delivers the clean payload."""
        if not data or not self._roll(self.corrupt_pct):
            return data
        self._bump("corrupt", what)
        mid = len(data) // 2
        return data[:mid] + bytes(b ^ 0xFF for b in data[mid:mid + 16]) \
            + data[mid + 16:]

    # -- a worker's lifecycle -------------------------------------------------

    def heartbeat_frozen(self, worker_id: str) -> bool:
        if self.freeze_all or str(worker_id) in self.freeze_ids:
            trace_mod.GLOBAL_COUNTERS.bump("chaos_heartbeat_frozen")
            return True
        return False

    def snapshot(self) -> Dict[str, Any]:
        return {
            "active": self.active,
            "drop_pct": self.drop_pct,
            "delay_pct": self.delay_pct,
            "delay_s": self.delay_s,
            "http_5xx_pct": self.http_5xx_pct,
            "corrupt_pct": self.corrupt_pct,
            "freeze_heartbeats": (True if self.freeze_all
                                  else sorted(self.freeze_ids)),
            "routes": list(self.routes),
            "injected": {
                k.split("chaos_", 1)[1]: v
                for k, v in trace_mod.GLOBAL_COUNTERS.snapshot().items()
                if k.startswith("chaos_")},
        }


_IDLE = ChaosMonkey()          # the zero spec: never active
_current: ChaosMonkey = _IDLE
_current_from_env = False
_env_raw_seen = ""
_install_lock = threading.Lock()


def set_chaos(spec: Optional[Dict[str, Any]]) -> ChaosMonkey:
    """Install a spec from code (tests, drills); ``None`` disarms.
    Returns the active monkey."""
    global _current, _current_from_env
    with _install_lock:
        _current = ChaosMonkey(spec) if spec else _IDLE
        _current_from_env = False
        if _current.active:
            log(f"chaos: armed {json.dumps(spec, sort_keys=True)}")
        return _current


def get_chaos() -> ChaosMonkey:
    """The active monkey.  ``DTPU_CHAOS`` is parsed again only when its
    raw value changes, so a :func:`set_chaos` spec survives an untouched
    environment, and clearing the variable disarms only a spec it
    armed."""
    global _current, _current_from_env, _env_raw_seen
    raw = os.environ.get(C.CHAOS_ENV) or ""
    if raw != _env_raw_seen:
        with _install_lock:
            _env_raw_seen = raw
            if raw:
                try:
                    spec = json.loads(raw)
                    _current = ChaosMonkey(spec if isinstance(spec, dict)
                                           else {})
                    _current_from_env = True
                    if _current.active:
                        log(f"chaos: armed from {C.CHAOS_ENV}")
                except ValueError:
                    log(f"chaos: bad {C.CHAOS_ENV} JSON; ignoring")
                    _current, _current_from_env = _IDLE, False
            elif _current_from_env:
                _current, _current_from_env = _IDLE, False
    return _current
