"""Timeouts, node-type sets and wire constants of the HTTP fan-out, the
worker manager, the write-ahead log, the observability plane (traces,
capture files, critical-path analysis, resources), admission and SLOs
and the sharded masters: the subset of
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

# --- the serving queue (server/app.py) ----------------------------------------
MAX_QUEUE_ENV = "DTPU_MAX_QUEUE"         # /prompt backpressure cap
MAX_QUEUE_DEFAULT = 256                  # full queue -> HTTP 429
DRAIN_TIMEOUT_ENV = "DTPU_DRAIN_TIMEOUT_S"
DRAIN_TIMEOUT_DEFAULT = 30.0             # graceful-shutdown drain bound

# --- SLO burn-rate engine (utils/slo.py) -------------------------------------
# Per-tenant-class objectives over a fast and a slow rolling window, fed
# by the finalize path.  Spec: "class:obj,obj;class:obj", obj = pNN<DURs
# (at most (100-NN)% of requests slower than DUR) or completion>RATIO,
# e.g. "paid:p95<2s,completion>0.999;free:p95<10s".
SLO_SPEC_ENV = "DTPU_SLO_SPEC"           # unset/empty: engine disarmed
SLO_FAST_WINDOW_ENV = "DTPU_SLO_FAST_S"
SLO_FAST_WINDOW_DEFAULT = 300.0          # fast burn window (~5m)
SLO_SLOW_WINDOW_ENV = "DTPU_SLO_SLOW_S"
SLO_SLOW_WINDOW_DEFAULT = 3600.0         # slow burn window (~1h)
SLO_RING_MAX = 4096                      # samples kept per tenant window
AUTOSCALE_SLO_ENV = "DTPU_AUTOSCALE_SLO"  # "1": paid fast burn>1 scales up

# --- multi-tenant admission (workflow/scheduler.py) ---------------------------
# Untagged traffic rides the highest class, so a single-tenant deployment
# keeps plain DTPU_MAX_QUEUE backpressure; {"priority": "free"|"batch"}
# opts into the lower classes.
TENANT_CLASSES = ("paid", "free", "batch")
TENANT_DEFAULT_CLASS_ENV = "DTPU_TENANT_DEFAULT_CLASS"
TENANT_DEFAULT_CLASS = "paid"
# stride-scheduling dequeue weights: "paid=6,free=3,batch=1"
TENANT_WEIGHTS_ENV = "DTPU_TENANT_WEIGHTS"
TENANT_WEIGHTS_DEFAULT = {"paid": 6.0, "free": 3.0, "batch": 1.0}
# a class is shed (429) once the queued count reaches ceil(bar x max_queue)
TENANT_SHED_ENV = "DTPU_TENANT_SHED"      # "batch=0.5,free=0.85,paid=1"
TENANT_SHED_DEFAULT = {"paid": 1.0, "free": 0.85, "batch": 0.5}
# per-client token buckets: prompts/s and burst; 0/unset = unlimited
TENANT_RATE_ENV = "DTPU_TENANT_RATE"
TENANT_BURST_ENV = "DTPU_TENANT_BURST"
TENANT_BURST_DEFAULT = 10.0
TENANT_BUCKETS_KEPT = 1024       # LRU bound on per-client bucket state
# deadline hedging: a request's {"slo_s": N} stamps its distributed jobs
# with a deadline; a unit silent longer than max(fraction x the budget
# left, SLO_MIN_WAIT_S) is hedged, with no min-progress gate
SLO_HEDGE_FRACTION_ENV = "DTPU_SLO_HEDGE_FRACTION"
SLO_HEDGE_FRACTION_DEFAULT = 0.25
SLO_MIN_WAIT_S = 0.25

# --- sharded masters (runtime/shard.py) ---------------------------------------
# N active masters own the prompt-id space on a consistent-hash ring.
# DTPU_SHARD_ID arms it; DTPU_SHARD_PEERS is "id=url,id=url" (self
# included); each shard's log is DTPU_SHARD_WAL_ROOT/<id>, and a dead
# master's shard is absorbed by its ring successor.
SHARD_ID_ENV = "DTPU_SHARD_ID"
SHARD_PEERS_ENV = "DTPU_SHARD_PEERS"
SHARD_WAL_ROOT_ENV = "DTPU_SHARD_WAL_ROOT"
SHARD_VNODES_ENV = "DTPU_SHARD_VNODES"       # virtual nodes per member
SHARD_VNODES_DEFAULT = 512
SHARD_GOSSIP_ENV = "DTPU_SHARD_GOSSIP_S"    # ring-gossip interval
SHARD_GOSSIP_DEFAULT = 2.0
# a peer silent on gossip this long reads as down (takeover keys on its
# master lease, not on this)
SHARD_PEER_DOWN_ENV = "DTPU_SHARD_PEER_DOWN_S"
SHARD_PEER_DOWN_DEFAULT = 10.0
SHARD_TAKEOVER_ENV = "DTPU_SHARD_TAKEOVER"  # "0": watch only, never absorb
# the shard owning this key is the fleet autoscaler's one actuator
AUTOSCALE_ACTUATOR_KEY = "dtpu-fleet-autoscale-actuator"
MASTER_URLS_ENV = "DTPU_MASTER_URLS"   # a worker's masters, comma list
ROUTER_MASTERS_ENV = "DTPU_ROUTER_MASTERS"  # the router's seed masters
ROUTER_REFRESH_ENV = "DTPU_ROUTER_REFRESH_S"  # ring re-pull cadence
ROUTER_REFRESH_DEFAULT = 5.0
# a /prompt with this header is never forwarded again
SHARD_FORWARD_HEADER = "x-dtpu-forwarded-from"

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
