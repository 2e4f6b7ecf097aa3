"""Timeouts, node-type sets and wire constants of the HTTP fan-out, the
worker manager, the write-ahead log, the observability plane (traces,
capture files, critical-path analysis, resources), admission and SLOs,
the sharded masters, the coalescing scheduler, the overlapped finalize
and the reuse plane: the subset of
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
OVERLAP_ENV = "DTPU_OVERLAP"             # "0" -> serial (host work inline)
COALESCE_ENV = "DTPU_COALESCE"           # "0" -> one prompt per dispatch
COALESCE_MAX_ENV = "DTPU_MAX_COALESCE"
COALESCE_MAX_DEFAULT = 8                 # largest batched prompt group
# continuous batching (workflow/batch_executor.py): the unit of
# scheduling is one denoise step of a padded batch a signature (a
# bucket); a prompt joins a running bucket at a step boundary and
# leaves it when its schedule ends, its decode on a tail thread.  Off by
# default, as in the JAX package.
CB_ENV = "DTPU_CB"                       # "1" arms the step executor
CB_SLOTS_ENV = "DTPU_CB_SLOTS"           # slots a bucket (its max batch)
CB_SLOTS_DEFAULT = 4
# each step runs at the smallest pad of this set >= the active slots;
# pads above DTPU_CB_SLOTS are ignored and the slot count always joins
CB_PAD_BUCKETS_ENV = "DTPU_CB_PAD_BUCKETS"
CB_PAD_BUCKETS_DEFAULT = "1,2,4,8"
CB_MAX_BUCKETS_ENV = "DTPU_CB_MAX_BUCKETS"  # signatures stepping at once
CB_MAX_BUCKETS_DEFAULT = 4
# how long the driver lingers at a new batch's first boundary for more
# arrivals (0: step at once)
CB_ADMIT_WINDOW_ENV = "DTPU_CB_ADMIT_WINDOW_S"
CB_ADMIT_WINDOW_DEFAULT = 0.0
# samplers with an extracted step (models/samplers.SAMPLER_STEPS): each
# step is a function of (x, sigma, sigma_next, keys, step index) alone
CB_SAFE_SAMPLERS = frozenset({"euler", "ddim", "euler_ancestral"})
# park and resume: a lower class's row goes to the host when a higher
# class's prompt needs its slot, or while device memory is above the
# fraction, and comes back at a later boundary
CB_PARK_ENV = "DTPU_CB_PARK"             # "1" arms parking
CB_PARK_MAX_ENV = "DTPU_CB_PARK_MAX"     # rows parked at most
CB_PARK_MAX_DEFAULT = 64
CB_PARK_HBM_FRACTION_ENV = "DTPU_CB_PARK_HBM_FRACTION"
CB_PARK_HBM_FRACTION_DEFAULT = 0.9
# leftmost parks first; a class preempts only the classes before it, so
# paid (absent) is never parked
CB_PREEMPT_ORDER = ("batch", "free")
# the flight deck's ring of step-boundary rows (cli flightdeck)
CB_DECK_RING_ENV = "DTPU_CB_DECK_RING"
CB_DECK_RING_DEFAULT = 128
HOSTIO_THREADS_ENV = "DTPU_HOSTIO_THREADS"
HOSTIO_THREADS_DEFAULT = 2               # encoder pool width
HOSTIO_PENDING_ENV = "DTPU_HOSTIO_PENDING"
HOSTIO_PENDING_DEFAULT = 16              # bounded: submit blocks past this
WARMUP_ENV = "DTPU_WARMUP"               # serve-startup warmup JSON

# Node types the coalescing scheduler may merge along the batch: each is
# batch-parallel (no cross-sample state, no HTTP side channel), the only
# batch source is EmptyLatentImage, and prompts of one group differ only
# in the KSampler seed (masked out of the signature).  Anything else
# runs one prompt a dispatch.
COALESCE_SAFE_NODE_TYPES = frozenset({
    "CheckpointLoaderSimple", "CLIPTextEncode", "CLIPSetLastLayer",
    "LoraLoader", "LoraLoaderModelOnly", "EmptyLatentImage", "KSampler",
    "VAEDecode", "VAEDecodeTiled", "SaveImage", "PreviewImage",
})

# --- cross-request reuse (runtime/reuse.py) ----------------------------------
# Three content-addressed tiers, each an LRU with its own byte budget:
# exact-hit results (host), text and VAE encodes (on the device) and
# refined upscale tiles.  DTPU_CACHE=0 turns every tier off before any
# key is computed.
CACHE_ENV = "DTPU_CACHE"                 # "0" disables every tier
CACHE_BYTES_ENV = "DTPU_CACHE_BYTES"     # exact-hit result tier budget
CACHE_BYTES_DEFAULT = 256 << 20
CACHE_DEVICE_BYTES_ENV = "DTPU_CACHE_DEVICE_BYTES"  # on-device encode tier
CACHE_DEVICE_BYTES_DEFAULT = 128 << 20
CACHE_TILE_BYTES_ENV = "DTPU_CACHE_TILE_BYTES"      # refined-tile tier
CACHE_TILE_BYTES_DEFAULT = 256 << 20
CACHE_ENTRIES_ENV = "DTPU_CACHE_ENTRIES"  # per-tier entry cap
CACHE_ENTRIES_DEFAULT = 256
# previews over server-sent events (GET /distributed/preview/<prompt_id>);
# a client that disconnects from a queued prompt abandons it
PREVIEW_ENV = "DTPU_PREVIEW"             # "0" disables the route
PREVIEW_EVERY_ENV = "DTPU_PREVIEW_EVERY"  # publish every N steps
PREVIEW_EVERY_DEFAULT = 1
PREVIEW_MAX_CLIENTS_ENV = "DTPU_PREVIEW_MAX_CLIENTS"
PREVIEW_MAX_CLIENTS_DEFAULT = 64

# Node types whose output is a pure function of their widgets and their
# upstream content keys: the encode memo's addressable set
# (runtime/reuse.subgraph_keys).  LoadImage takes part through a salt
# of its file's stat.
REUSE_KEY_NODE_TYPES = frozenset({
    "CheckpointLoaderSimple", "CLIPSetLastLayer", "LoraLoader",
    "LoraLoaderModelOnly", "CLIPTextEncode", "CLIPTextEncodeSDXL",
    "CLIPTextEncodeSDXLRefiner", "LoadImage", "VAEEncode",
    "ImageScale", "EmptyLatentImage",
})

# Node types a whole graph may consist of and still be replayed from the
# exact-hit tier: deterministic functions of their widgets and inputs.
# Distributed nodes never qualify, nor does SaveImage (its contract is a
# new file on disk each time, which a replay cannot honour).
RESULT_CACHE_SAFE_NODE_TYPES = (COALESCE_SAFE_NODE_TYPES | frozenset({
    "LoadImage", "VAEEncode", "VAEEncodeTiled", "ImageScale",
    "CLIPTextEncodeSDXL", "CLIPTextEncodeSDXLRefiner",
    "KSamplerAdvanced",
})) - frozenset({"SaveImage"})

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

# --- elastic-fleet autoscaler (runtime/autoscale.py) -------------------------
# A master's reconciliation loop spawns workers when the federated queue
# depth a participant (or the utilization, or the paid class's burn
# rate) sits over its bar for WINDOW consecutive samples, and retires
# the ones it spawned, by drain and lease non-renewal, when both sit
# under the strictly lower DOWN bars.  COOLDOWN after any action blocks
# the next.  Off by default; DTPU_AUTOSCALE=1 arms it in serve().
AUTOSCALE_ENV = "DTPU_AUTOSCALE"
AUTOSCALE_INTERVAL_ENV = "DTPU_AUTOSCALE_INTERVAL_S"
AUTOSCALE_INTERVAL_DEFAULT = 5.0
AUTOSCALE_MIN_ENV = "DTPU_AUTOSCALE_MIN"     # floor on worker count
AUTOSCALE_MIN_DEFAULT = 0
AUTOSCALE_MAX_ENV = "DTPU_AUTOSCALE_MAX"     # ceiling on worker count
AUTOSCALE_MAX_DEFAULT = 4
AUTOSCALE_UP_QUEUE_ENV = "DTPU_AUTOSCALE_UP_QUEUE"
AUTOSCALE_UP_QUEUE_DEFAULT = 4.0             # queued prompts a participant
AUTOSCALE_DOWN_QUEUE_ENV = "DTPU_AUTOSCALE_DOWN_QUEUE"
AUTOSCALE_DOWN_QUEUE_DEFAULT = 1.0
AUTOSCALE_UP_UTIL_ENV = "DTPU_AUTOSCALE_UP_UTIL"
AUTOSCALE_UP_UTIL_DEFAULT = 0.85             # device-utilization fraction
AUTOSCALE_DOWN_UTIL_ENV = "DTPU_AUTOSCALE_DOWN_UTIL"
AUTOSCALE_DOWN_UTIL_DEFAULT = 0.30
AUTOSCALE_WINDOW_ENV = "DTPU_AUTOSCALE_WINDOW"
AUTOSCALE_WINDOW_DEFAULT = 3                 # consecutive samples over bar
AUTOSCALE_COOLDOWN_ENV = "DTPU_AUTOSCALE_COOLDOWN_S"
AUTOSCALE_COOLDOWN_DEFAULT = 30.0
AUTOSCALE_DRAIN_ENV = "DTPU_AUTOSCALE_DRAIN_S"
AUTOSCALE_DRAIN_DEFAULT = 30.0               # retirement drain bound
# a reversal within this long of the previous action is a FLAP
AUTOSCALE_FLAP_S = 60.0
AUTOSCALE_DECISIONS_KEPT = 128               # decision-ring bound
WORKER_STATE_RETIRING = "retiring"           # registry state during drain

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

# --- chaos fault injection (utils/chaos.py) ----------------------------------
# DTPU_CHAOS is a JSON spec; unset costs one env read an edge:
#   {"drop_pct": 5, "delay_pct": 5, "delay_s": 0.2, "http_5xx_pct": 5,
#    "corrupt_pct": 2, "freeze_heartbeats": true|["w0"],
#    "routes": ["/distributed/tile_complete", ...], "seed": 1234}
# pcts are 0-100 shares of matching edges; "routes" scopes the server's
# side; "seed" (or DTPU_CHAOS_SEED) makes a run replay.  Every injection
# bumps a chaos_* event counter.
CHAOS_ENV = "DTPU_CHAOS"
CHAOS_SEED_ENV = "DTPU_CHAOS_SEED"
CHAOS_DEFAULT_ROUTES = ("/prompt", "/distributed/tile_complete",
                        "/distributed/job_complete",
                        "/distributed/heartbeat")
CHAOS_DELAY_DEFAULT_S = 0.25

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
