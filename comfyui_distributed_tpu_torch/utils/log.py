"""The port's log lines and phase timer: the counterpart of
``comfyui_distributed_tpu/utils/logging.py``.

By default a line is ``dtpu-torch <message>`` on standard output,
flushed, one a line, written whole under a lock, so lines of two threads
(the execution and the finalize thread) never interleave
(``chip_smoke.py`` reads the servers' logs).  With
``DTPU_LOG_JSON=1`` (or :func:`set_json_logs`) each line is one JSON
object, ``{"ts", "level", "msg"}`` plus the active request trace's
``trace_id``, ``span_id`` and ``prompt_id`` (``utils.trace.
current_trace_ids``), so a log line joins the trace of the job that
wrote it.

The debug tier (``debug_log``) follows the config's ``settings.debug``,
which ``utils/config.py`` applies on every load and save, as in the JAX
package; ``DISTRIBUTED_TPU_DEBUG`` set to a true value keeps it on.

:class:`Timer` times a phase into ``utils.trace.GLOBAL_PHASES`` (the
``phases`` block of ``/distributed/metrics``)."""

import json
import os
import sys
import threading
import time

_LOG_JSON_ENV = "DTPU_LOG_JSON"   # utils.constants.LOG_JSON_ENV (log sits
                                  # below the modules that import constants)

_ENV_DEBUG = os.environ.get("DISTRIBUTED_TPU_DEBUG")
_env_forced = (_ENV_DEBUG is not None and _ENV_DEBUG.strip().lower()
               not in ("", "0", "false", "no", "off"))
_debug_enabled = _env_forced
_json_enabled = os.environ.get(_LOG_JSON_ENV, "").strip().lower() \
    in ("1", "true", "yes", "on")


def set_debug(enabled: bool) -> None:
    """Turn the debug tier on or off; the environment variable wins."""
    global _debug_enabled
    _debug_enabled = bool(enabled) or _env_forced


def debug_enabled() -> bool:
    return _debug_enabled


def set_json_logs(enabled: bool) -> None:
    """Switch between plain and JSON lines (start value from
    ``DTPU_LOG_JSON``)."""
    global _json_enabled
    _json_enabled = bool(enabled)


def json_logs_enabled() -> bool:
    return _json_enabled


_write_lock = threading.Lock()


def _write(line: str) -> None:
    """One line in one write: ``print`` writes the text and the newline
    apart, and another thread's line can fall between them."""
    with _write_lock:
        sys.stdout.write(line + "\n")
        sys.stdout.flush()


def _emit(level: str, msg: str) -> None:
    if not _json_enabled:
        tag = "" if level == "info" else "[DEBUG] "
        _write(f"dtpu-torch {tag}{msg}")
        return
    out = {"ts": round(time.time(), 6), "level": level, "msg": msg}
    try:
        # trace sits above log in the utils import order
        from comfyui_distributed_tpu_torch.utils.trace import \
            current_trace_ids
        ids = current_trace_ids()
    except Exception:  # noqa: BLE001 - a log line never raises
        ids = None
    if ids:
        out.update(ids)
    _write(json.dumps(out, ensure_ascii=False, default=str))


def log(msg: str) -> None:
    _emit("info", msg)


def debug_log(msg: str) -> None:
    if _debug_enabled:
        _emit("debug", msg)


class Timer:
    """A phase's wall-clock, recorded into ``GLOBAL_PHASES``::

        with Timer("vae_decode") as t: ...
        t.elapsed_s
    """

    def __init__(self, name: str, emit: bool = True):
        self.name = name
        self.emit = emit
        self.elapsed_s = 0.0

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.elapsed_s = time.perf_counter() - self._t0
        if self.emit:
            debug_log(f"phase[{self.name}] {self.elapsed_s * 1e3:.1f} ms")
        from comfyui_distributed_tpu_torch.utils.trace import GLOBAL_PHASES
        GLOBAL_PHASES.record(self.name, self.elapsed_s)
        return False
