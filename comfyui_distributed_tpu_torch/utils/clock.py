"""The clock seam of the control plane: the counterpart of ``Clock`` and
``WALL`` in ``comfyui_distributed_tpu/utils/clock.py``.

``ClusterRegistry`` and ``WorkLedger`` take a ``clock`` and default to
:data:`WALL`, which delegates to ``time``; a test hands both packages'
registries and ledgers one fake clock and steps it.
"""

from __future__ import annotations

import time


class Clock:
    """``time()`` (epoch seconds, for timestamps people read) and
    ``monotonic()`` (leases, overdue bars)."""

    def time(self) -> float:
        return time.time()

    def monotonic(self) -> float:
        return time.monotonic()


# the default every seamed class falls back to
WALL = Clock()
