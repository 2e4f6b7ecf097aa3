"""Op protocol, registry and execution context: the counterpart of
``comfyui_distributed_tpu/ops/base.py`` for the single-device path.

Each op mirrors a ComfyUI node's schema: ``WIDGETS`` is the widget order
(``CONTROL`` marks UI-only slots such as control_after_generate) and
``HIDDEN`` lists the hidden inputs the op accepts.  Tensor-plane values
(latents, images) travel between ops as :class:`DeviceTensor` wrappers
around a torch tensor on the run's device; the only host edge is
:meth:`DeviceTensor.to_host`, taken by output nodes.  The device edges
(:meth:`DeviceTensor.to_host`, :func:`as_device_array` of a host value,
:func:`as_image_array` of a device value) report their bytes through
``utils.trace.record_transfer``, attributed to the executing node, as
the JAX package's do (``d2h`` and ``h2d``; on a card real copies).

An output node collects its images through :meth:`OpContext.collect_images`:
inline, or with a host pool (the server's overlapped finalize) on the
pool, so one job's PNG encodes run while the next job's kernels do.  The
copy to the host stays on the execution thread, and the pool gets the
numpy array: a copy issued from a pool thread would instead queue behind
the next job's kernels on the default stream.
"""

from __future__ import annotations

import contextlib
import dataclasses
import threading
import time
from typing import Any, Callable, Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch

from comfyui_distributed_tpu_torch.runtime import interrupt
from comfyui_distributed_tpu_torch.utils.trace import (
    GLOBAL_PHASES,
    record_transfer,
)

# sentinel for widget slots that are UI chrome (control_after_generate)
CONTROL = "__control__"


class CBCapture(Exception):
    """The continuous-batching bucket build's stop
    (``workflow/batch_executor.py``): with ``OpContext.cb_capture`` set,
    the KSampler puts its resolved inputs into that dict and raises
    this instead of sampling, so the run ends before the graph's tail
    (decode, save)."""


@dataclasses.dataclass
class Conditioning:
    """CLIP encoding result (comfy CONDITIONING): context [1, T, C] and,
    for SDXL, the pooled text embedding [1, P] and the ADM scalars: those
    of CLIPTextEncodeSDXL (height, width, crop_h, crop_w, target_height,
    target_width) or of CLIPTextEncodeSDXLRefiner (height, width, 0, 0,
    aesthetic score); without them the sampler derives them from the
    latent.  ``concat_latent`` [B, h, w, K]: an inpaint or ip2p model's
    extra UNet input channels (InpaintModelConditioning's [mask, masked
    latent], InstructPixToPixConditioning's source latent), set on both
    CFG sides.

    Regional prompting (ComfyUI's multi-entry conditioning lists):
    ``area_mask`` is an image-resolution mask [B, H, W] or a rectangle
    ``("px", x, y, w, h)`` (pixels, ComfyUI's //8 latent units) or
    ``("pct", x, y, w, h)`` (canvas fractions), resolved against the
    latent at sample time; ``area_strength`` weighs the entry's
    denoised prediction in the blend; ``siblings`` are the further
    entries ConditioningCombine bundled; ``timestep_range`` (start,
    end) in sampling percent (0 = the first step) limits when the
    entry counts.  ``unclip``: (image_embed [1, D], strength,
    noise_augmentation) entries for an unCLIP model's ADM vector.
    ``control``: the ControlNet chain attached to the entry, a tuple of
    ``(net, hint image [B, H, W, 3], strength[, (start_percent,
    end_percent)])`` links (ComfyUI's previous_controlnet chain: every
    link runs and their residuals sum).  ``gligen``: (GLIGEN model,
    ((phrase embedding [1, D], box (x, y, w, h) in latent units), ...))
    from GLIGENTextBoxApply; the sampler grounds this entry's rows on
    those boxes."""
    context: torch.Tensor
    pooled: Optional[torch.Tensor] = None
    size_cond: Optional[Tuple[float, ...]] = None
    concat_latent: Optional[torch.Tensor] = None
    area_mask: Any = None
    area_strength: float = 1.0
    siblings: Tuple["Conditioning", ...] = ()
    timestep_range: Optional[Tuple[float, float]] = None
    unclip: Optional[Tuple[Tuple[Any, float, float], ...]] = None
    control: Optional[Tuple[Tuple[Any, ...], ...]] = None
    gligen: Optional[Tuple[Any, Tuple[Tuple[Any, Tuple[int, ...]], ...]]] \
        = None


@dataclasses.dataclass
class SeedValue:
    """INT seed that knows whether it came from a DistributedSeed node.
    With SPMD fan-out, replica r of a ``distributed`` seed takes
    ``base + r``; the port runs fanout 1 in a process (every row takes
    ``base``) and fans out over HTTP, where a worker's seed node already
    adds its offset."""
    base: int
    distributed: bool = False
    # the coalescing scheduler's seeds, one a merged prompt:
    # _prepare_sample_inputs repeats each over its prompt's rows
    per_prompt: Any = None

    def __index__(self) -> int:
        return int(self.base)


@dataclasses.dataclass
class OpContext:
    """Per-run execution context.  ``device`` is where every tensor of
    the run lives: ``cuda`` unless the caller asks for ``cpu``."""
    device: str = "cuda"
    models_dir: Optional[str] = None
    # signature-equal prompts merged into this run by the coalescing
    # scheduler; EmptyLatentImage multiplies its batch by it
    coalesce: int = 1
    # the overlapped finalize (utils.net.HostIOPool): when set, output
    # nodes' host work (the copy's wait, PNG encodes, disk writes) runs
    # on the pool and lands in image_futures instead of saved_images
    host_pool: Any = None
    image_futures: List[Any] = dataclasses.field(default_factory=list)
    # where LoadImage resolves relative file names
    input_dir: Optional[str] = None
    output_dir: Optional[str] = None
    # distributed identity (hidden-input defaults for all ops)
    is_worker: bool = False
    worker_id: str = ""
    master_url: str = ""
    # the server's per-job result queues (runtime/jobs.JobStore); a
    # master's collector and tiled upscaler drain them
    job_store: Any = None
    # the control plane (runtime/cluster.py): the worker registry with
    # leases and the work ledger.  The collectors find dead owners in
    # the registry and check completions in through the ledger, so lost
    # units are recovered instead of dropped; None keeps the drains of
    # a fan-out without a control plane
    cluster: Any = None
    ledger: Any = None
    # fault injection for tests and drills ({"drop_tiles_after": k,
    # "stall_s": t}); empty in production
    fault_inject: Dict[str, Any] = dataclasses.field(default_factory=dict)
    # the API-format graph being run and the request's
    # ``extra_data["extra_pnginfo"]`` (the UI's ``workflow``): SaveImage
    # stores each in a text chunk of its PNGs
    prompt_json: Any = None
    extra_pnginfo: Optional[Dict[str, Any]] = None
    # the run's hidden overrides (``WorkflowExecutor.execute(hidden=)``):
    # SaveImage writes each merged prompt's own seed from them
    hidden_overrides: Dict[str, Dict[str, Any]] = dataclasses.field(
        default_factory=dict)
    # continuous batching's bucket build: the KSampler records its
    # inputs here and raises CBCapture (None: it samples)
    cb_capture: Optional[Dict[str, Any]] = None
    # the executing node's input sub-graph content key
    # (runtime/reuse.subgraph_keys), or None: the encode memo's key
    content_key: Optional[str] = None
    # collected artifacts
    saved_images: List[np.ndarray] = dataclasses.field(default_factory=list)
    node_timings: Dict[str, float] = dataclasses.field(default_factory=dict)
    # seconds of named stages inside ops (``stage``), summed over the run
    stage_seconds: Dict[str, float] = dataclasses.field(
        default_factory=dict)
    # the process-wide interrupt event (``runtime/interrupt.py``), the
    # one the samplers read at each step
    interrupt_event: threading.Event = dataclasses.field(
        default_factory=interrupt.interrupt_event)

    def check_interrupt(self) -> None:
        """Raise once ``/interrupt`` has set the event: the ops call this
        on entry, after sampling and between tiles, so an interrupted
        prompt ends as an error at its next check."""
        if self.interrupt_event.is_set():
            raise InterruptedError("execution interrupted")

    def collect_images(self, make_host_images: Callable[[], List]) -> None:
        """An output node's images: ``make_host_images()`` does the host
        work and returns the images.  Without a host pool it runs here
        into ``saved_images``; with one it runs on the pool and its
        future goes into ``image_futures`` (in submission order, which
        ``ExecutionResult.wait_host`` keeps)."""
        if self.host_pool is None:
            self.saved_images.extend(make_host_images())
        else:
            self.image_futures.append(self.host_pool.submit(
                make_host_images))


@contextlib.contextmanager
def stage(ctx: OpContext, name: str) -> Iterator[None]:
    """Add the seconds of the enclosed block to ``ctx.stage_seconds[name]``
    and to the ``phases`` aggregate (the JAX package times these phases
    with its ``Timer``); on a card the block ends in a synchronize, so
    the time is the stage's own device time."""
    t0 = time.perf_counter()
    yield
    if torch.device(ctx.device).type == "cuda":
        torch.cuda.synchronize(ctx.device)
    dt = time.perf_counter() - t0
    ctx.stage_seconds[name] = ctx.stage_seconds.get(name, 0.0) + dt
    GLOBAL_PHASES.record(name, dt)


class Op:
    """Base class for workflow ops.

    Class attributes:
        TYPE: node class name
        WIDGETS: widget names in UI order (CONTROL for chrome slots)
        DEFAULTS: default values for optional widgets
        HIDDEN: hidden input names this op accepts
    """

    TYPE = ""
    WIDGETS: List[str] = []
    DEFAULTS: Dict[str, Any] = {}
    HIDDEN: List[str] = []

    def execute(self, ctx: OpContext, **inputs) -> Tuple:
        raise NotImplementedError


NODE_CLASS_MAPPINGS: Dict[str, type] = {}
_registry_lock = threading.Lock()


def register_op(cls: type) -> type:
    with _registry_lock:
        NODE_CLASS_MAPPINGS[cls.TYPE] = cls
    return cls


def get_op(type_name: str) -> Op:
    try:
        cls = NODE_CLASS_MAPPINGS[type_name]
    except KeyError:
        raise KeyError(
            f"unknown node type {type_name!r}; ported: "
            f"{sorted(NODE_CLASS_MAPPINGS)}") from None
    return cls()


class DeviceTensor:
    """Device-resident tensor-plane value, handed between ops without
    leaving the device."""

    __slots__ = ("data",)

    def __init__(self, data: torch.Tensor):
        self.data = data

    @property
    def shape(self) -> Tuple[int, ...]:
        return tuple(self.data.shape)

    def to_host(self) -> np.ndarray:
        """The device -> host edge: float32 numpy, counted."""
        arr = self.data.detach().float().cpu().numpy()
        record_transfer("d2h", arr.nbytes)
        return arr

    def __repr__(self) -> str:
        return f"{type(self).__name__}(shape={self.shape})"


class DeviceImage(DeviceTensor):
    """IMAGE wire value ([B, H, W, C] float32 in [0, 1])."""


class DeviceLatent(DeviceTensor):
    """LATENT ``samples`` value ([B, h, w, C] float32)."""


def as_device_array(x, device) -> torch.Tensor:
    """A wire value as a float32 tensor on ``device``; device-resident
    values are used as they are, a host value pays one counted h2d
    copy."""
    if isinstance(x, DeviceTensor):
        x = x.data
    if isinstance(x, torch.Tensor):
        out = x.to(device=device, dtype=torch.float32)
        if out.device != x.device:
            record_transfer("h2d", out.nelement() * out.element_size())
        return out
    arr = np.asarray(x, np.float32)
    record_transfer("h2d", arr.nbytes)
    return torch.as_tensor(arr, device=device)


def as_device_image(x, device) -> torch.Tensor:
    """IMAGE value -> float32 [B, H, W, C] tensor on ``device``."""
    arr = as_device_array(x, device)
    return arr[None] if arr.ndim == 3 else arr


def as_image_array(x) -> np.ndarray:
    """IMAGE value -> numpy [B, H, W, C] float32 (a host edge: a device
    value's copy is counted)."""
    if isinstance(x, DeviceTensor):
        arr = x.to_host()
    elif isinstance(x, torch.Tensor):
        arr = x.detach().float().cpu().numpy()
        record_transfer("d2h", arr.nbytes)
    else:
        arr = np.asarray(x, dtype=np.float32)
    if arr.ndim == 3:
        arr = arr[None]
    return arr
