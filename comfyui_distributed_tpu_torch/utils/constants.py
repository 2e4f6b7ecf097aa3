"""Timeouts, node-type sets and wire constants of the HTTP fan-out, the
worker manager, the write-ahead log and the observability plane (traces,
capture files, critical-path analysis, resources): the subset of
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

# --- observability (utils/trace.py) -----------------------------------------
# Request tracing: every job gets a trace whose spans ride a contextvar,
# cross the HTTP edges in a W3C traceparent header and land in a bounded
# flight recorder behind GET /distributed/trace/<prompt_id>.
TRACE_ENV = "DTPU_TRACE"                 # "0" disables span creation
TRACE_RING_ENV = "DTPU_TRACE_RING"       # flight-recorder ring size
TRACE_RING_DEFAULT = 128                 # completed job traces retained
TRACE_MAX_SPANS = 512                    # per-trace span cap (then dropped)
TRACEPARENT_HEADER = "traceparent"       # W3C trace-context header name
SLOW_JOB_ENV = "DTPU_SLOW_JOB_S"         # >0: the slow-job log line
LOG_JSON_ENV = "DTPU_LOG_JSON"           # "1": JSON log lines with trace ids

# latency-histogram bucket bounds (seconds), shared by the JSON
# percentiles and the Prometheus exposition
HISTOGRAM_BUCKETS_S = (0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1,
                       0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0, 60.0)

# --- capture files (utils/trace_export.py) -----------------------------------
# committed traces stream to rotating, size-bounded JSONL segments in
# either package's schema; off unless a directory is set
TRACE_EXPORT_DIR_ENV = "DTPU_TRACE_EXPORT_DIR"       # unset/empty: off
TRACE_EXPORT_SEGMENT_ENV = "DTPU_TRACE_EXPORT_SEGMENT_BYTES"
TRACE_EXPORT_SEGMENT_DEFAULT = 4 * 1024 * 1024       # rotate past 4 MiB
TRACE_EXPORT_RETAIN_ENV = "DTPU_TRACE_EXPORT_RETAIN_BYTES"
TRACE_EXPORT_RETAIN_DEFAULT = 64 * 1024 * 1024       # dir cap (oldest out)
TRACE_EXPORT_SCHEMA = 1                              # capture-file schema
TRACE_EXPORT_PREFIX = "capture-"                     # segment file prefix
# ring evictions and export drops log once per N
TRACE_EVICT_LOG_EVERY = 50
TRACE_EXPORT_DROP_LOG_EVERY = 20

# --- resources (utils/resource.py) ------------------------------------------
# device memory, host RSS, utilization and queue depth sampled into
# bounded rings; heartbeats carry a snapshot and the master serves the
# merged view on GET /distributed/cluster/metrics{,.prom}
RESOURCE_ENV = "DTPU_RESOURCE"           # "0" disables the monitor thread
RES_INTERVAL_ENV = "DTPU_RES_INTERVAL_S"
RES_INTERVAL_DEFAULT = 5.0               # s between monitor samples
RES_RING_ENV = "DTPU_RES_RING"
RES_RING_DEFAULT = 720                   # samples per series (~1h @ 5s)
# a worker snapshot older than this is pulled live from its
# GET /distributed/resource and cached back into the registry
RES_FED_TTL_ENV = "DTPU_RES_FED_TTL_S"
RES_FED_TTL_DEFAULT = 10.0

# --- critical-path analysis (utils/trace_analysis.py) ------------------------
ANALYSIS_BASELINE_ENV = "DTPU_ANALYSIS_BASELINE"   # unset/empty: disarmed
ANALYSIS_ANOMALY_PCT_ENV = "DTPU_ANALYSIS_ANOMALY_PCT"
ANALYSIS_ANOMALY_PCT_DEFAULT = 50.0     # per-category regression bar (%)
ANALYSIS_STRAGGLER_X_ENV = "DTPU_ANALYSIS_STRAGGLER_X"
ANALYSIS_STRAGGLER_X_DEFAULT = 2.0      # worker p95 vs fleet-median bar
ANALYSIS_MAX_TRACES_ENV = "DTPU_ANALYSIS_MAX_TRACES"
ANALYSIS_MAX_TRACES_DEFAULT = 256       # records per aggregation pass
# heartbeats carry the worker's wall clock; the master min-filters
# (offset + one-way delay) samples into a per-worker estimate and shifts
# shipped worker spans by it.  "0" keeps the estimates, shifts nothing.
SKEW_CORRECTION_ENV = "DTPU_SKEW_CORRECTION"
SKEW_SAMPLES_KEPT = 16                  # min-filter window per worker

# every literal attr key a span carries: the vocabulary the trace
# readers (cli trace, why, analyze) know
TRACE_ATTR_WHITELIST = frozenset({
    # job identity / topology
    "prompt_id", "client_id", "tenant", "role", "fanout", "job",
    "worker", "node", "target",
    # coalescing / continuous batching
    "coalesced", "coalesced_into", "bucket", "slot",
    "step", "preempted_by",
    "threshold_s",
    # recovery / hedging
    "lost", "to", "units", "tile_idx", "n_workers",
    # resource attribution
    "device_peak_mb", "rss_mb", "mem_peak_mb", "mem_peak_delta_mb",
    "mem_source",
    # cross-request compute reuse
    "cache_hit", "cache_tier", "tiles_skipped",
    # multi-master sharded control plane
    "shard", "ring_epoch", "forwarded_from",
    # the offset (ms) applied to a shipped worker span forest
    "skew_ms",
})
