"""Timeouts, node-type sets and wire constants of the HTTP fan-out, the
worker manager and the write-ahead log: the subset of
``comfyui_distributed_tpu/utils/constants.py`` that the port reads, with
the same values, so a worker of either package keeps to a master of the
other.
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
# first tile or image send by t seconds
FAULT_INJECT_ENV = "DTPU_FAULT_INJECT"

# --- durable job state and master failover (runtime/durable.py) -------------
# The write-ahead job log: every queue admission, ledger ownership
# transition, unit check-in and idempotency key is appended as a
# checksummed record to segment files under DTPU_WAL_DIR (unset:
# durability off).  A restarted master replays it and resumes the
# interrupted prompts, refining only their unfinished units; a standby
# (DTPU_STANDBY=1) watches the master's lease file in the same directory
# and takes over when it expires.  Appends carry the holder's epoch and
# are refused once a higher epoch holds the lease (fencing).
WAL_DIR_ENV = "DTPU_WAL_DIR"
# fsync policy: "always" (a record is durable before its caller is
# answered), "off" (left to the OS), or seconds between group fsyncs
WAL_SYNC_ENV = "DTPU_WAL_SYNC"
WAL_SYNC_DEFAULT = "always"
WAL_SEGMENT_BYTES_ENV = "DTPU_WAL_SEGMENT_BYTES"
WAL_SEGMENT_BYTES_DEFAULT = 1 << 20    # rotate (and snapshot) at 1 MiB
STANDBY_ENV = "DTPU_STANDBY"           # "1": watch the lease, do not take it
MASTER_LEASE_ENV = "DTPU_MASTER_LEASE_S"
MASTER_LEASE_DEFAULT = 10.0            # s the master lease lives unrenewed
MASTER_LEASE_FRACTION = 3.0            # renewed every lease / this
WAL_FENCE_CHECK_S = 0.25               # s between re-reads of the lease
WAL_OWNER_ENV = "DTPU_MASTER_ID"       # the lease owner (default: master)

# --- worker lifecycle (runtime/manager.py, runtime/monitor.py) ---------------
PROCESS_TERMINATION_TIMEOUT = 5.0  # s a TERM may take before KILL
PROCESS_WAIT_TIMEOUT = 3.0       # s to reap a process after KILL
WORKER_STARTUP_DELAY = 2.0       # s before auto-launching workers
LOG_TAIL_BYTES = 65536           # default tail of GET /distributed/worker_log
MASTER_PID_ENV = "DTPU_MASTER_PID"   # a managed worker's master
METRICS_RESET_ENV = "DTPU_METRICS_RESET"  # "0" refuses POST .../metrics/reset
