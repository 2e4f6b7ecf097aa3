"""Timeouts, node-type sets and wire constants of the HTTP fan-out: the
subset of ``comfyui_distributed_tpu/utils/constants.py`` that the port's
master/worker path reads, with the same values, so a worker of either
package keeps to a master of the other.
"""

# --- job collection --------------------------------------------------------
WORKER_JOB_TIMEOUT = 10.0        # s without a new image before a drain ends
JOB_COMPLETION_TIMEOUT = 60.0    # s overall for the workers' images
TILE_COLLECTION_TIMEOUT = 60.0   # s overall for tile gathering
TILE_WAIT_TIMEOUT = 30.0         # s without a new tile before a drain ends
TILE_TRANSFER_TIMEOUT = 30.0     # s for one tile POST
TILE_SEND_TIMEOUT = 60.0         # s for one image POST (a whole image set)
PREFLIGHT_TIMEOUT = 0.3          # s health probe before dispatch

# --- transport retry -------------------------------------------------------
SEND_MAX_RETRIES = 5
SEND_BACKOFF_BASE = 0.5          # s; doubles each retry, capped
SEND_BACKOFF_CAP = 5.0
SEND_JITTER_FRACTION = 0.5       # delay *= uniform[1 - j, 1]
SEND_ATTEMPT_TIMEOUT_CAP = 60.0  # s one attempt may take, at most
RETRY_AFTER_CAP_S = 60.0         # longest Retry-After honoured

# --- node types ------------------------------------------------------------
# a graph with one of DISTRIBUTED_NODE_TYPES fans out; workers keep the
# connected component of those nodes
SEED_NODE_TYPES = ("DistributedSeed",)
COLLECTOR_NODE_TYPES = ("DistributedCollector",)
UPSCALER_NODE_TYPES = ("UltimateSDUpscaleDistributed",)
DISTRIBUTED_NODE_TYPES = COLLECTOR_NODE_TYPES + UPSCALER_NODE_TYPES

# --- wire formats ----------------------------------------------------------
# raw-tensor uploads (npy, compressed) on the worker -> master hop,
# negotiated per master through GET /distributed/wire_formats; PNG for
# peers that do not list it
TENSOR_WIRE_CONTENT_TYPE = "application/x-dtpu-tensor"
