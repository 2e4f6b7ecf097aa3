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

# --- fault-tolerant control plane (runtime/cluster.py) ----------------------
# A worker is HEALTHY while its lease (renewed by heartbeats, health probes
# and data-plane contact) is fresh, SUSPECT after DTPU_SUSPECT_PROBES
# failed probes in a row, DEAD once the lease expires.  The work ledger
# records which participant owns which tile or seed slice; a dead owner's
# units are redispatched (or refined on the master) instead of dropped.
LEASE_ENV = "DTPU_LEASE_S"
LEASE_DEFAULT = 15.0             # s a worker stays alive without contact
SUSPECT_PROBES_ENV = "DTPU_SUSPECT_PROBES"
SUSPECT_PROBES_DEFAULT = 2       # failed probes in a row -> suspect
# reassign: recover lost units (the default); partial: keep what arrived
# at the deadline; fail: raise ClusterFaultError
FAULT_POLICY_ENV = "DTPU_FAULT_POLICY"
FAULT_POLICY_DEFAULT = "reassign"
FAULT_POLICIES = ("reassign", "partial", "fail")
# hedged stragglers: once a job is DTPU_HEDGE_PCT % done, a unit whose
# owner has been silent longer than max(DTPU_HEDGE_FACTOR x the ledger's
# moving latency estimate, DTPU_HEDGE_MIN_WAIT_S) is re-issued; the
# first completion wins through the ledger
HEDGE_ENV = "DTPU_HEDGE"                 # "0" disarms hedging
HEDGE_PCT_ENV = "DTPU_HEDGE_PCT"
HEDGE_PCT_DEFAULT = 50.0
HEDGE_FACTOR_ENV = "DTPU_HEDGE_FACTOR"
HEDGE_FACTOR_DEFAULT = 3.0
HEDGE_MIN_WAIT_ENV = "DTPU_HEDGE_MIN_WAIT_S"
HEDGE_MIN_WAIT_DEFAULT = 5.0
CLUSTER_POLL_S = 0.25            # drain poll with recovery armed
HEARTBEAT_FRACTION = 3.0         # workers heartbeat every lease / this
CLUSTER_TRANSITIONS_KEPT = 64    # registry transition ring
LEDGER_COMPLETED_KEPT = 32       # finished-job summary ring
WORKER_CHECK_INTERVAL = 2.0      # s between the master's health probes
MASTER_URL_ENV = "DTPU_MASTER_URL"   # worker -> master heartbeat target
WORKER_ID_ENV = "DTPU_WORKER_ID"     # this worker's config id
# fault injection for tests and drills, JSON: {"drop_tiles_after": k}
# makes a worker stop after sending k tiles; {"stall_s": t} delays its
# first tile send by t seconds
FAULT_INJECT_ENV = "DTPU_FAULT_INJECT"
