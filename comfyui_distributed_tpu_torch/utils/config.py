"""Cluster configuration: the JSON file and schema of
``comfyui_distributed_tpu/utils/config.py``, read and written the same
way (``DISTRIBUTED_TPU_CONFIG`` names the file, else
``./cluster_config.json``; a missing or corrupt file reads as the
defaults; writes are atomic).

Schema::

    {
      "master":  {"host": str|None, "port": int?, "extra_args": str?},
      "workers": [{"id": str, "name": str, "host": str?, "port": int,
                   "enabled": bool, "extra_args": str?}],
      "settings": {"debug": bool, "auto_launch_workers": bool,
                   "stop_workers_on_master_exit": bool},
      "mesh":    {"axes": {"data": int, "tensor": int, "seq": int},
                  "allow_cpu_fallback": bool},
      "managed_processes": {name: {"pid": int, ...}}
    }

The port reads ``master`` and ``workers``; it keeps the other sections
so a file stays valid for the JAX package.
"""

from __future__ import annotations

import json
import os
import tempfile
import threading
from typing import Any, Callable, Dict, List, Optional

_lock = threading.RLock()

CONFIG_ENV = "DISTRIBUTED_TPU_CONFIG"
DEFAULT_CONFIG_NAME = "cluster_config.json"


def default_config_path() -> str:
    return os.environ.get(CONFIG_ENV) or os.path.join(os.getcwd(),
                                                      DEFAULT_CONFIG_NAME)


def get_default_config() -> Dict[str, Any]:
    return {
        "master": {"host": None},
        "workers": [],
        "settings": {
            "debug": False,
            "auto_launch_workers": False,
            "stop_workers_on_master_exit": True,
        },
        "mesh": {
            "axes": {"data": -1, "tensor": 1, "seq": 1},
            "allow_cpu_fallback": True,
        },
        "managed_processes": {},
    }


def _merge_defaults(cfg: Any) -> Dict[str, Any]:
    base = get_default_config()
    if not isinstance(cfg, dict):
        return base
    for key, val in base.items():
        if isinstance(val, dict):
            if not isinstance(cfg.get(key), dict):
                cfg[key] = val
            else:
                for k2, v2 in val.items():
                    cfg[key].setdefault(k2, v2)
        elif cfg.get(key) is None:
            cfg[key] = val
    return cfg


def load_config(path: Optional[str] = None) -> Dict[str, Any]:
    path = path or default_config_path()
    with _lock:
        try:
            with open(path, "r", encoding="utf-8") as f:
                cfg = json.load(f)
        except (FileNotFoundError, json.JSONDecodeError):
            cfg = get_default_config()
        return _merge_defaults(cfg)


def save_config(cfg: Dict[str, Any], path: Optional[str] = None) -> None:
    """Write to a temporary file in the same directory, then rename it
    over ``path``: a reader never sees half a file."""
    path = path or default_config_path()
    with _lock:
        d = os.path.dirname(os.path.abspath(path))
        os.makedirs(d, exist_ok=True)
        fd, tmp = tempfile.mkstemp(dir=d, prefix=".cfg-", suffix=".tmp")
        try:
            with os.fdopen(fd, "w", encoding="utf-8") as f:
                json.dump(cfg, f, indent=2)
            os.replace(tmp, path)
        except BaseException:
            try:
                os.unlink(tmp)
            except OSError:
                pass
            raise


def mutate_config(mutator: Callable[[Dict[str, Any]], Any],
                  path: Optional[str] = None) -> Dict[str, Any]:
    """Load, apply ``mutator(cfg)`` and save under one lock."""
    with _lock:
        cfg = load_config(path)
        mutator(cfg)
        save_config(cfg, path)
        return cfg


def upsert_worker(cfg: Dict[str, Any],
                  worker: Dict[str, Any]) -> Dict[str, Any]:
    """Insert or update a worker by id; a value of ``None`` deletes that
    field; a new worker is disabled unless it says otherwise."""
    wid = str(worker["id"])
    workers = cfg.setdefault("workers", [])
    for existing in workers:
        if str(existing.get("id")) == wid:
            for k, v in worker.items():
                if v is None:
                    existing.pop(k, None)
                else:
                    existing[k] = v
            return existing
    clean = {k: v for k, v in worker.items() if v is not None}
    clean.setdefault("enabled", False)
    workers.append(clean)
    return clean


def delete_worker(cfg: Dict[str, Any], worker_id: str) -> bool:
    workers = cfg.setdefault("workers", [])
    before = len(workers)
    cfg["workers"] = [w for w in workers if str(w.get("id")) != str(worker_id)]
    return len(cfg["workers"]) != before


def update_setting(cfg: Dict[str, Any], key: str, value: Any) -> None:
    cfg.setdefault("settings", {})[key] = value


def enabled_workers(cfg: Dict[str, Any]) -> List[Dict[str, Any]]:
    return [w for w in cfg.get("workers", []) if w.get("enabled")]
