"""The port's configuration object and device resolution.

Mirrors ``opentsdb_tpu/utils/config.py`` of the JAX package, trimmed to
the fields this port reads (the resident window's, the spill tier's and
its durability and compression knobs, the live sketches', the fragment
cache's, the fused block plan's, the admission ladder's and the replica,
cluster and router knobs among them, with the JAX package's defaults),
plus
``device``: where the query kernels run.
``backend="cpu"`` keeps its JAX-package meaning — the float64 numpy
oracle answers every query (``ops/oracle.py``) — and is independent of
``device``.
"""

from __future__ import annotations

import dataclasses
import multiprocessing


@dataclasses.dataclass
class Config:
    # storage
    table: str = "tsdb"
    uidtable: str = "tsdb-uid"
    throttle_rows: int | None = None  # memtable rows before PleaseThrottle
    # fsync the WAL at every flush (power-loss safety; off by default, as
    # in the JAX package).
    fsync: bool = False
    # WAL group commit (storage/kv.py): > 0 lets concurrent appends share
    # one flush (+ fsync) per this many milliseconds; acknowledgements
    # still wait for the covering flush, so durability is unchanged. 0
    # (default) flushes every append, with the same WAL bytes.
    wal_group_ms: float = 0.0
    # Write-side sstable format (compress/):
    # - "none": spill the uncompressed TSST3 layout (the default);
    # - "tsst4": spill compressed columnar blocks (delta-of-delta
    #   timestamps, XOR floats, zigzag int deltas; zlib/verbatim
    #   fallbacks; each block self-describing). The read side sniffs each
    #   file, so v1-v4 generations mix and flipping this changes only
    #   later spills; compaction re-encodes as generations merge.
    sstable_codec: str = "none"
    # Spill-encode pipelining (storage/sstable.py): overlap per-block
    # TSST4 encoding (its self-check round trip included) with the
    # spill's file writes on this many encoder threads. The bytes equal
    # the serial encode's (blocks drain in submission order); 0 disables;
    # serial while fault points are armed.
    spill_encode_workers: int = 2
    # Fused decode-plus-aggregate serving (compress/kernels.py): eligible
    # downsampled queries run straight off TSST4 blocks, the decoded
    # columns living only on the device. Exact or declined; off forces
    # the decode-then-reduce scan.
    sstable_fused_agg: bool = True
    # Device-side block cache (compress/devcache.py): total decoded
    # POINTS kept resident on the device (~12 bytes a point across the
    # qualifier-delta, value and record columns). Warm fused queries then
    # upload only per-record arrays. 0 disables the cache.
    devblock_points: int = 1 << 23

    # core behavior (names mirror the reference's system properties)
    auto_create_metrics: bool = False   # tsd.core.auto_create_metrics
    enable_compactions: bool = True     # tsd.feature.compactions
    flush_interval: float = 10.0        # compaction thread wake period (s)
    compaction_min_flush_threshold: int = 100
    compaction_max_concurrent_flushes: int = 10_000
    compaction_flush_speed: int = 2
    checkpoint_interval: float = 0.0    # spill+WAL-truncate period (s); 0=off

    # Materialized rollup tier (rollup/): per-series coarse-window
    # summaries (count/sum/min/max/first/last + t-digest, HLL and moment
    # sketch columns) folded at checkpoint-spill time into a parallel
    # per-shard store and served by the query planner for window-aligned
    # downsamples. Writers with a persistent store only; a stale or
    # missing tier degrades to raw scans. The JAX package's names and
    # defaults.
    enable_rollups: bool = False
    rollup_resolutions: tuple = (3600, 86400)  # ascending, each divides next
    rollup_pack: int = 48          # windows packed per rollup row
    rollup_digest_k: int = 64      # t-digest centroids per window (0=off)
    rollup_hll_p: int = 8          # HLL registers exponent per window
    rollup_sketch_min_res: int = 86400  # digest + HLL columns at res >= this
    rollup_catchup: str = "background"  # background | sync | off
    # After a crash mid-fold, refold only the windows the persisted
    # in-flight set names; False forces the full rebuild.
    rollup_incremental_catchup: bool = True
    # Ingest-time delta accumulators (rollup/delta.py): a fold serves a
    # window whose whole point set is buffered from memory, with the same
    # record bytes as the raw re-read. False forces every fold to re-read.
    rollup_delta_fold: bool = True
    rollup_delta_points: int = 1 << 22  # buffered points, all windows
    # Moment-sketch columns (sketch/moment.py): stored at resolutions >=
    # rollup_moment_min_res (0 = every resolution); 0 disables.
    rollup_moment_k: int = 5
    rollup_moment_min_res: int = 0
    # The admission ladder's bounded-error step: a degraded pNN query is
    # served from the tier's sketch columns whenever its reported relative
    # bound is <= this budget (0: any bound admits; the answer reports its
    # bound either way).
    degrade_max_error: float = 0.0
    # Debug oracle: derive the dirty-window set both ways (the store's
    # index and a memtable sweep) and fail on divergence. Test-only.
    rollup_sweep_check: bool = False
    # The checkpoint fold on the device (ops/rollup_fold.py, the
    # hand-written window-fold kernel, in float64, one launch a (metric,
    # coarse window) group): the tier declares "device-f64" in its state
    # file; off keeps the host fold. Only the moment fold moves: the
    # record build and the sketches stay on the host, so a checkpoint of
    # 2,500 series gains the ~1.3-1.7 s of its moment fold in 14-21 s
    # (PERF.md §6, PR 19).
    rollup_device_fold: bool = False
    # Accuracy-budgeted sketch allocation (sketch/budget.py): > 0 spends
    # this many summary bytes across the rollup resolutions instead of
    # the uniform sketch_min_res / moment_min_res cutoffs.
    sketch_byte_budget: int = 0

    # compute: 'device' = the port's kernels on ``device``; 'cpu' = the
    # float64 numpy oracle.
    backend: str = "device"
    # Torch device of the query kernels. "cuda" by default: the port is
    # built for one NVIDIA H100, and a missing card is an error, never a
    # silent CPU run. Tests pass "cpu".
    device: str = "cuda"

    # Query fast path (query/executor.py, the fragment cache): decoded
    # per-(selector, aligned time-chunk) columns, validated against the
    # store's mutation seq, per-base transition stamps and dirty-base set
    # (MemKVStore.chunk_state). Chunks with memtable rows are re-read on
    # every query; clean history serves from RAM, bit-identical to a cold
    # scan. The JAX package's names and defaults.
    qcache: bool = True
    qcache_chunk_s: int = 6 * 3600   # chunk width (rounded to row span)
    qcache_points: int = 1 << 24     # total cached points across fragments
    qcache_fragments: int = 1024     # max distinct fragments
    qcache_max_chunks: int = 512     # wider ranges scan unchunked/uncached

    # Streaming sketches (stats/livesketch.py): a t-digest per series and
    # a HyperLogLog per (metric, tag key), folded on the device at ingest.
    # The JAX package's names and defaults.
    enable_sketches: bool = True
    sketch_compression: int = 128       # t-digest centroids per series
    sketch_hll_p: int = 12              # 2^p registers per (metric, tagk)
    sketch_flush_points: int = 1 << 20  # buffered points before a fold

    # Device-resident columnar hot window (storage/devstore.py): ingest is
    # mirrored into device memory so downsampled moment queries skip the
    # storage scan and the per-query host-to-device copy. The JAX
    # package's names and defaults.
    device_window: bool = True
    device_window_staging: int = 1 << 20   # points per upload chunk
    device_window_points: int = 1 << 26    # resident budget, all metrics
    # Mesh-sharded hot set (storage/devshard.py): shard the resident
    # window on the series axis over the mesh devices. 0 = off (one
    # window); N >= 1 = N logical shards round-robined over the devices
    # (N may exceed the device count: the CPU tests run the sharded path
    # on the one CPU device, the card four shards on one H100). The
    # shards split device_window_points between them.
    devwindow_shards: int = 0

    # Device mesh for query execution (parallel/): 0 = single-device;
    # N > 1 = shard downsampled queries over the first N cards. mesh_shape
    # supersedes it when set: "" = no mesh; "N" = a 1-D series mesh of N
    # shards (N cards on CUDA, past which the daemon refuses to boot; N
    # logical shards on the CPU); "RxC" = the 2-D hybrid (host, series)
    # mesh of R host rows of C shards (R * C cards on CUDA; logical
    # shards on the CPU). The JAX package's names and defaults.
    mesh_devices: int = 0
    mesh_shape: str = ""
    # Expert-parallel dashboard serving (parallel/expert.py): with a mesh,
    # a mixed /q batch (>= 2 sub-queries, one shared downsample interval,
    # lerp-family moment and percentile aggregators) packs into expert
    # buckets and runs in one mesh dispatch. A batch that falls off the
    # path declines, declared per result (plan: "expert-decline") and
    # counted (mesh.expert.decline{reason=}), and serves serially.
    expert_parallel: bool = False
    # Served mesh-plane deployment mode (tsd --mesh-plane,
    # parallel/fleet.py): non-empty = the coordinator's HOST:PORT; the
    # daemon joins a torch.distributed group before the storage engine
    # builds a window. Each process still serves its own mesh; plane
    # membership is reported in /healthz for the router.
    mesh_plane: str = ""
    mesh_plane_procs: int = 1          # processes in the plane
    mesh_plane_id: int = 0             # this process's plane rank

    # Admission control / backpressure (serve/admission.py). All off
    # by default (0); per-tenant buckets key on the ?tenant= query
    # param (HTTP) or the connection's tenant (telnet; "default").
    # - ingest_rate/_burst_s: per-tenant token bucket in points/s;
    #   over-quota puts shed with "Please throttle" + Retry-After
    #   instead of queueing.
    # - ingest_queue_points: global cap on decoded-but-not-yet-applied
    #   points across connections — sheds before memory does.
    # - query_rate/_burst: per-tenant queries/s bucket;
    # - query_max_inflight N: the load-shedding ladder. Below N
    #   queries in flight: full service. N..2N: degraded: traces are
    #   stripped and /q serves rollup-only (no raw stitching; results
    #   tagged "degraded": "rollup-only"; queries the tier cannot serve
    #   get 503 + Retry-After). At 2N: 503 + Retry-After.
    ingest_rate: float = 0.0
    ingest_burst_s: float = 2.0
    ingest_queue_points: int = 0
    query_rate: float = 0.0
    query_burst: float = 8.0
    query_max_inflight: int = 0

    # Tenant cardinality control plane (tenant/):
    # - tenant_accounting: track per-tenant series cardinality from
    #   the ingest path's series-identity hash (exact set below
    #   tenant_exact_cutoff distinct series, HLL above it) plus
    #   heavy-hitter summaries; snapshotted to <wal>.tenants.json in
    #   the checkpoint bracket and rebuilt from storage on a
    #   torn/foreign state file. Writers only.
    # - tenant_max_series: refuse a NEW series from a tenant already
    #   at this many distinct series (0 = unlimited). Existing series
    #   keep ingesting; the refusal is a declared wire error (telnet
    #   "tenant series limit exceeded" line / HTTP 429), never a
    #   retryable throttle.
    # - tenant_global_max_series: directory-wide backstop across all
    #   tenants (0 = unlimited).
    # - tenant_limit_mode: "enforce" refuses; "warn" only counts +
    #   logs what would have been refused (would_refuse).
    # - tenant_overrides: ("name=limit", ...) per-tenant caps beating
    #   the blanket tenant_max_series; 0 = unlimited for that tenant.
    tenant_accounting: bool = True
    tenant_max_series: int = 0
    tenant_global_max_series: int = 0
    tenant_limit_mode: str = "enforce"
    tenant_overrides: tuple = ()
    tenant_exact_cutoff: int = 4096
    tenant_hll_p: int = 12
    tenant_topk: int = 16

    # Observability (obs/), the JAX package's names and defaults:
    # - slow_query_ms: /q requests at or over this wall time are traced
    #   and logged as one-line JSON records (span tree, plan) into the
    #   trace ring and the slow-query logger. 0 disables; queries are
    #   then traced only when asked (?trace=1).
    # - selfmon_interval_s: period of the self-monitoring loop that
    #   ingests the /stats lines into the store as tsd.* series. 0 = off.
    # - trace_ring: records kept for /api/traces.
    # - trace_sample_n: trace 1 /q in N into the ring (baselines between
    #   incidents). 0 disables.
    slow_query_ms: float = 0.0
    selfmon_interval_s: float = 0.0
    trace_ring: int = 256
    trace_sample_n: int = 0

    # Replicas (serve/tailer.py, ROADMAP item 10a):
    # - role: "writer" (the single ingesting daemon), "replica" (a
    #   read-only daemon that tails the writer's WAL) or "router" (the
    #   storage-free front door over the replicas, serve/router.py).
    # - max_staleness_ms: the replica staleness contract; a replica whose
    #   last successful catch-up is older answers every /q with a
    #   "degraded": "stale" tag and reports unhealthy at /healthz. 0
    #   turns the contract off.
    # - tail_interval_s: the tailer's poll period.
    role: str = "writer"
    max_staleness_ms: float = 0.0
    tail_interval_s: float = 0.25
    # Cluster write tier (cluster/epoch.py):
    # - cluster: a writer adopts (or creates) the EPOCH.json beside its
    #   WAL, stamps its epoch into every WAL segment, and fences every
    #   mutation once a promotion bumps the persisted epoch past its own.
    # - cluster_owner: this daemon's label in EPOCH.json bumps.
    # - epoch_check_interval_s: the zombie guard's stat cadence.
    # - writer_grace_ms (router role): how long the writer's /healthz must
    #   stay dead before the router promotes a replica. 0 leaves
    #   promotion to an operator's /promote.
    cluster: bool = False
    cluster_owner: str | None = None
    epoch_check_interval_s: float = 0.05
    writer_grace_ms: float = 0.0

    # Multi-writer sharding (cluster/ownership.py; router role only):
    # - router_writers: writer base URLs. With more than one, the router
    #   routes ingest by the series-hash ownership map and fans each read
    #   over its slot's owner history (the answers merge).
    # - cluster_map: the CLUSTER.json path; a missing file is created as
    #   an equal split over router_writers.
    # - cluster_slots: hash-space slots of a newly created map.
    router_writers: tuple = ()
    cluster_map: str | None = None
    cluster_slots: int = 64
    # The router's bounded result cache: full-service /q answers keyed by
    # (normalized query, ownership epoch, staleness bound), expiring after
    # router_rcache_ms. 0 entries: off.
    router_rcache: int = 0
    router_rcache_ms: float = 1000.0

    # Query router (serve/router.py; role="router" only):
    # - router_backends: replica base URLs ("http://host:port").
    # - writer_url: where forwarded telnet puts go (None: refused).
    # - router_deadline_ms: one budget a request; each hop gets a share of
    #   what remains.
    # - router_retries / router_backoff_ms: more attempts on the next
    #   replica after a failed or expired hop, with capped exponential
    #   backoff.
    # - router_hedge_ms: a duplicate hop to the next replica when the
    #   first is slower than this; the first answer wins, the loser is
    #   cancelled. 0 derives the delay from the observed p95 hop latency;
    #   negative disables hedging.
    # - probe_interval_s / router_eject_after: the /healthz probe cadence
    #   and the consecutive failures that eject a replica from rotation
    #   (readmitted on the next healthy probe).
    router_backends: tuple = ()
    writer_url: str | None = None
    router_deadline_ms: float = 10_000.0
    router_retries: int = 2
    router_backoff_ms: float = 50.0
    router_hedge_ms: float = 0.0
    probe_interval_s: float = 1.0
    router_eject_after: int = 3

    # network
    port: int = 4242
    bind: str = "0.0.0.0"
    worker_threads: int = dataclasses.field(
        default_factory=lambda: 2 * multiprocessing.cpu_count())


def resolve_device(name: str) -> "torch.device":
    """``name`` as a torch device, refusing a CUDA device without a card:
    the port runs where its caller asked or not at all. torch is imported
    here, not with the module, so the router's chain (``tools/cli.py``
    ``tsd --role router``) reads its Config without loading torch."""
    import torch

    dev = torch.device(name)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {name!r} requested but CUDA is not available; pass "
            f"device='cpu' to run the port on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {name!r} (cuda or cpu)")
    return dev
