"""The process-wide interrupt flag: the counterpart of
``comfyui_distributed_tpu/runtime/interrupt.py``.

One ``threading.Event`` per process, as ComfyUI has one processing
interrupt: the server's ``/interrupt`` route sets it, the execution
thread clears it when a prompt starts.  The samplers read it at the top
of every step (``models/samplers.py``) and the ops between nodes and
between tiles (``OpContext.check_interrupt``).  The JAX package polls it
from inside a compiled scan through a host callback; the port's step
loop is Python, so reading it is one attribute load and never waits for
the card.
"""

from __future__ import annotations

import threading

_event = threading.Event()


def interrupt_event() -> threading.Event:
    """The process-wide event (the server's state shares it)."""
    return _event


def request_interrupt() -> None:
    _event.set()


def clear_interrupt() -> None:
    _event.clear()


def is_interrupted() -> bool:
    return _event.is_set()
