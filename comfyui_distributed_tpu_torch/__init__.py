"""comfyui_distributed_tpu_torch: the PyTorch and CUDA port of
``comfyui_distributed_tpu`` for NVIDIA Hopper GPUs.

The JAX package stays the reference; this package mirrors its module
paths (``models/unet.py``, ``ops/basic.py``, ``workflow/executor.py``...)
and imports nothing of it.  Plain tensor code is PyTorch, run eagerly; the
UNet's attention is a CUDA kernel of this package (``csrc/``), built for
``sm_90a`` on first use.  Entry points run on ``cuda`` unless the caller
passes ``device="cpu"``, where each kernel's wrapper runs its plain
PyTorch version.

Packages:
    models/    UNet, CLIP, VAE decoder, schedules, samplers, seed-to-noise
    ops/       workflow node library; ``ops/kernels/`` holds the kernel
               wrappers and their build
    workflow/  API-format graph parser and executor; the HTTP fan-out's
               graph rewrites (dispatcher) and orchestration
    server/    the master/worker HTTP server (standard library)
    runtime/   per-job result queues, the control plane, the log
    utils/     PNG, resampling, the tensor wire, HTTP helpers, config,
               traces, capture files, trace analysis, resources
    csrc/      CUDA sources
"""

__version__ = "0.1.0"
