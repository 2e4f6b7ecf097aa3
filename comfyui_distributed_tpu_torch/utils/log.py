"""The port's log lines: ``dtpu-torch <message>`` on standard output,
flushed, one a line (``chip_smoke.py`` reads the servers' logs).

The debug tier (``debug_log``) follows the config's ``settings.debug``,
which ``utils/config.py`` applies on every load and save, as in the JAX
package; ``DISTRIBUTED_TPU_DEBUG`` set to a true value keeps it on."""

import os

_ENV_DEBUG = os.environ.get("DISTRIBUTED_TPU_DEBUG")
_env_forced = (_ENV_DEBUG is not None and _ENV_DEBUG.strip().lower()
               not in ("", "0", "false", "no", "off"))
_debug_enabled = _env_forced


def set_debug(enabled: bool) -> None:
    """Turn the debug tier on or off; the environment variable wins."""
    global _debug_enabled
    _debug_enabled = bool(enabled) or _env_forced


def debug_enabled() -> bool:
    return _debug_enabled


def log(msg: str) -> None:
    print(f"dtpu-torch {msg}", flush=True)


def debug_log(msg: str) -> None:
    if _debug_enabled:
        print(f"dtpu-torch [DEBUG] {msg}", flush=True)
