"""Device and memory probes of the control routes: the part of
``comfyui_distributed_tpu/utils/resource.py`` that
``/distributed/clear_memory`` reads, and the device view of
``/distributed/status`` and ``cli devices`` (the JAX package's
``describe_devices``).  The sampling ring and ``/distributed/resource``
are not ported yet.
"""

from __future__ import annotations

import os
import resource as _res
from typing import Any, Dict

import torch

try:
    import psutil
except ImportError:
    psutil = None


def host_rss_bytes() -> int:
    """This process's resident set size: psutil where installed, else
    ``/proc/self/statm``, else the peak from ``getrusage``."""
    if psutil is not None:
        return int(psutil.Process().memory_info().rss)
    try:
        with open("/proc/self/statm", "r", encoding="ascii") as f:
            return int(f.read().split()[1]) * os.sysconf("SC_PAGE_SIZE")
    except (OSError, ValueError, IndexError):
        # ru_maxrss: the peak, in KB on Linux
        return int(_res.getrusage(_res.RUSAGE_SELF).ru_maxrss) * 1024


def device_memory_snapshot(device: str = "cuda") -> Dict[str, Any]:
    """``{"bytes_in_use", "peak_bytes_in_use", "bytes_limit",
    "n_devices", "source"}``.  On ``cuda``: torch's allocated bytes,
    their peak and each card's total, summed over the visible cards
    (``source: "memory_stats"``).  On the CPU the device's memory is the
    host's: this process's resident bytes (``source: "host_rss"``), as
    the JAX package reports a backend without memory stats."""
    if torch.device(device).type == "cuda":
        n = torch.cuda.device_count()
        return {
            "bytes_in_use": sum(torch.cuda.memory_allocated(i)
                                for i in range(n)),
            "peak_bytes_in_use": sum(torch.cuda.max_memory_allocated(i)
                                     for i in range(n)),
            "bytes_limit": sum(torch.cuda.get_device_properties(i)
                               .total_memory for i in range(n)),
            "n_devices": n, "source": "memory_stats"}
    rss = host_rss_bytes()
    peak = int(_res.getrusage(_res.RUSAGE_SELF).ru_maxrss) * 1024
    return {"bytes_in_use": rss, "peak_bytes_in_use": max(peak, rss),
            "bytes_limit": None, "n_devices": 0, "source": "host_rss"}


def describe_devices(device: str = "cuda") -> Dict[str, Any]:
    """The devices a server on ``device`` runs on, with the keys of the
    JAX package's ``describe_devices``: ``platform`` (``gpu``, ``cpu``,
    or ``none`` when torch sees no card), ``num_devices``,
    ``num_local_devices``, ``num_processes``, ``process_index`` and
    ``devices`` (``id``, ``platform``, ``kind``, ``process_index``
    each).  Nothing is computed on a device."""
    if torch.device(device).type == "cuda":
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        devices = [{"id": i, "platform": "gpu",
                    "kind": torch.cuda.get_device_name(i),
                    "process_index": 0} for i in range(n)]
    else:
        devices = [{"id": 0, "platform": "cpu", "kind": "cpu",
                    "process_index": 0}]
    return {"platform": devices[0]["platform"] if devices else "none",
            "num_devices": len(devices), "num_local_devices": len(devices),
            "num_processes": 1, "process_index": 0, "devices": devices}
