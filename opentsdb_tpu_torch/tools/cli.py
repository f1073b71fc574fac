"""The ``tsd``, ``tenants``, ``fsck``, ``stats`` and ``sketch-plan``
commands.

Mirrors those subcommands of ``opentsdb_tpu/tools/cli.py`` (the
reference's TSDMain.java for ``tsd``, Fsck.java for ``fsck``). The daemon serves on the CUDA card
unless ``--device cpu`` is given; ``--backend cpu`` answers queries with
the float64 oracle instead of the kernels. As in the JAX package's
daemon, the resident device window is on: ingest (and, at start-up, what
the sstable generations and the WAL hold) is mirrored into device memory,
and downsampled moment queries are served from it (``"rollup":
"resident"`` in the /q JSON). With ``--wal`` the store spills to sstable
generations beside the WAL at every ``--checkpoint-interval`` seconds and
at shutdown, in the JAX package's formats. Tenant accounting is on
(``--no-tenant-accounting`` turns it off), with the series limits and the
ingest quotas off unless a flag sets them. Once the store is open the
daemon freezes its heap out of cycle collection
(``utils/gctune.tune_for_ingest``). Run it with

    python -m opentsdb_tpu_torch.tools.cli tsd --port 4242 \\
        --wal /var/tsdb/wal --auto-metric

``--shards N`` (N > 1) opens ``--wal`` as the directory of a
series-sharded store (``storage/sharded.py``: ``shard-<i>/`` and
``SHARDS.json``); the default 0 opens a sharded store exactly when
``--wal`` already holds a ``SHARDS.json`` (its count wins), and an
explicit count that disagrees with it is a hard error. ``--wal-group-ms``
turns on WAL group commit in the daemon, and ``--sstable-codec tsst4``
makes its spills compressed TSST4 generations (``compress/``; the
encode pool's width is ``Config.spill_encode_workers``, with no flag, as
in the JAX package).

``--rollups`` keeps the materialized rollup tier (``rollup/``: per-series
1h/1d summaries folded at every checkpoint, served by the query planner
for window-aligned downsamples); ``--rollup-resolutions`` sets its windows
(and implies the tier), ``--rollup-device-fold`` folds on the card with
the window-fold kernel (declared ``device-f64``). As in the JAX package,
a store whose tier already exists (``<wal>.rollup.json`` or
``ROLLUP.json``) adopts it with its own layout, flag or no flag, in every
subcommand that opens the store, so no writer spills under stale
summaries.

``tenants`` prints the per-tenant cardinality report of a store
(``--wal``) or of a live daemon (``--url``, its ``/api/tenants``).
``fsck`` checks a store (``tools/fsck.py``); ``--fix`` salvages bad rows
and ``--expect-clean`` exits 2 on any error, even when fixed.

``--sketch-byte-budget N`` (every subcommand, as in the JAX CLI) spends
N summary bytes across the rollup resolutions (``sketch/budget.py``)
instead of the uniform cutoffs, and ``sketch-plan --budget N`` prints the
allocation it would choose (the JAX CLI's bytes), with ``--url`` weighted
by a live daemon's trace ring.

Replicas and the cluster tier (ROADMAP item 10a): ``--read-only`` opens
``--wal`` as a read-only replica of a (possibly live) writer daemon over
the same files, refreshed every ``--checkpoint-interval`` seconds
(default 5); ``--role replica`` is a read-only daemon with a WAL tailer
(``serve/tailer.py``: every ``--tail-interval`` seconds, with the
staleness contract ``--max-staleness-ms``, default 5000 for the role).
``--cluster`` makes a writer adopt or create ``EPOCH.json`` beside its
WAL: every writer boot bumps the epoch (``--cluster-owner`` labels the
bump), stamps it into its WAL segments and fences its mutations once a
promotion bumps past it; a ``--cluster`` replica accepts ``/promote``.

``--mesh N`` shards eligible downsampled queries over a mesh of N
(``parallel/``: N cards, or N logical shards with ``--device cpu``; more
than the cards refuses to boot; ``RxC`` folds R x C of them into the
hybrid host x series mesh), ``--expert-parallel`` answers a mixed
dashboard in one mesh dispatch (``parallel/expert.py``), and
``--devwindow-shards N`` shards the resident hot window over the mesh's
devices (``storage/devshard.py``, resharded live by
``/api/mesh/reshard?shards=N``). ``--mesh-plane HOST:PORT
--mesh-plane-procs P --mesh-plane-id I`` joins the daemon to a mesh plane
of P processes (``parallel/fleet.py``) before the storage opens.

``--role router`` (ROADMAP item 10b, ``serve/router.py``) is the
storage-free front door over ``--backends`` (replica URLs): ``/q`` fans
out by series-hash ownership with ``--router-deadline-ms``,
``--router-retries``, hedging (``--router-hedge-ms``) and ``/healthz``
probes (``--probe-interval``, ``--router-eject-after``); telnet ``put``
lines forward to ``--writer-url`` under ingest admission, and with
``--writer-grace-ms`` the router promotes a replica once the writer has
been dead that long (``cluster/promote.py``). ``--writers`` (more than
one) shards ingest and reads by the ``--cluster-map`` ownership map. The
router imports neither torch nor the storage engine: this module loads
the engine (``core/``, ``storage/``) and the daemon inside the
subcommands that use them, as the JAX CLI does. A replica of the writer
above, and a router over two replicas::

    python -m opentsdb_tpu_torch.tools.cli tsd --port 4243 \
        --wal /var/tsdb/wal --role replica
    python -m opentsdb_tpu_torch.tools.cli tsd --port 4240 --role router \
        --backends http://127.0.0.1:4243,http://127.0.0.1:4244 \
        --writer-url http://127.0.0.1:4242

``stats`` prints the ``/stats`` lines (``--metrics``: the Prometheus text
of ``/metrics``) of a live daemon (``--url``) or of a store (``--wal``:
the engine's stats and the metrics registry; the server's own counters
need ``--url``). The daemon's observability flags: ``--slow-query-ms``,
``--selfmon-interval``, ``--trace-ring`` and ``--trace-sample-n``; its
query admission flags (every role): ``--query-max-inflight``,
``--query-rate`` and ``--query-burst``.
"""

from __future__ import annotations

import argparse
import asyncio
import contextlib
import json
import os
import signal
import sys
import time
import urllib.request
from typing import TYPE_CHECKING

from opentsdb_tpu_torch.utils.config import Config
from opentsdb_tpu_torch.utils.gctune import tune_for_ingest

if TYPE_CHECKING:
    from opentsdb_tpu_torch.core.tsdb import TSDB
    from opentsdb_tpu_torch.storage.kv import KVStore


def _is_dir_store(wal: str | None, shards: int) -> bool:
    from opentsdb_tpu_torch.storage.sharded import manifest_path
    return bool(shards > 1 or (wal and os.path.exists(manifest_path(wal))))


def open_store(cfg: Config, wal: str | None, shards: int = 0,
               read_only: bool = False, writer_epoch: int | None = None,
               epoch_guard=None) -> KVStore:
    """The store at ``wal``, replayed and opened: sharded when ``shards``
    > 1 or ``wal`` holds a ``SHARDS.json`` (an explicit count, 1 included,
    must then match it), else one WAL store. ``read_only`` opens it as a
    replica; ``writer_epoch`` / ``epoch_guard`` as a cluster writer."""
    from opentsdb_tpu_torch.storage.kv import MemKVStore
    from opentsdb_tpu_torch.storage.sharded import ShardedKVStore

    kw = dict(throttle_rows=cfg.throttle_rows, fsync=cfg.fsync,
              read_only=read_only, writer_epoch=writer_epoch,
              epoch_guard=epoch_guard)
    if _is_dir_store(wal, shards):
        return ShardedKVStore(wal, shards=shards if shards >= 1 else None,
                              data_table=cfg.table, **kw)
    return MemKVStore(wal_path=wal, **kw)


def apply_rollup_args(cfg: Config, args) -> Config:
    """The rollup flags onto ``cfg``, and the auto-adopt of an existing
    tier: its state file's layout wins over the defaults (an unreadable
    or foreign file leaves them, and the tier then rebuilds)."""
    if getattr(args, "rollups", False):
        cfg.enable_rollups = True
    if getattr(args, "rollup_resolutions", None):
        # An explicit layout implies the tier.
        cfg.enable_rollups = True
        cfg.rollup_resolutions = tuple(
            int(r) for r in args.rollup_resolutions.split(","))
    elif args.wal:
        from opentsdb_tpu_torch.rollup.tier import STATE_NAME, RollupTier
        for sp in (os.path.join(args.wal, STATE_NAME),
                   args.wal + ".rollup.json"):
            if os.path.exists(sp):
                cfg.enable_rollups = True
                RollupTier.adopt_config(sp, cfg)
                break
    cfg.rollup_device_fold = bool(getattr(args, "rollup_device_fold",
                                          False))
    if getattr(args, "sketch_byte_budget", None) is not None:
        cfg.sketch_byte_budget = int(args.sketch_byte_budget)
    return cfg


def open_tsdb(cfg: Config, wal: str | None,
              start_compaction_thread: bool = True,
              shards: int = 0, **store_kw) -> TSDB:
    """The store and TSDB the daemon serves: the WAL, sharded or memory
    store (``open_store``, which takes ``store_kw``), replayed and opened,
    under ``cfg``."""
    from opentsdb_tpu_torch.core.tsdb import TSDB

    return TSDB(open_store(cfg, wal, shards, **store_kw), cfg,
                start_compaction_thread=start_compaction_thread)


def make_tsdb(cfg: Config, wal: str | None, shards: int = 0,
              read_only: bool = False,
              start_compaction_thread: bool = True) -> TSDB:
    """The daemon's TSDB under its role: a replica (``read_only``, whose
    legacy timer, unless ``cfg.role`` is "replica", polls the writer every
    ``checkpoint_interval`` seconds, 5 when unset), or a writer, which in
    cluster mode (``cfg.cluster``) claims a new epoch at every boot (the
    file's first epoch is 1): a restarted deposed writer adopting the
    promoted replica's epoch would leave two unfenced writers at one
    epoch, while a fresh bump leaves exactly one of them fenced."""
    if (read_only and not cfg.checkpoint_interval
            and cfg.role != "replica"):
        cfg.checkpoint_interval = 5.0
    epoch_path = writer_epoch = epoch_guard = None
    if cfg.cluster and wal:
        from opentsdb_tpu_torch.cluster import epoch as ep
        if not cfg.cluster_owner:
            cfg.cluster_owner = f"{os.uname().nodename}:{os.getpid()}"
        epoch_path = ep.epoch_path_for_wal(
            wal, is_dir=_is_dir_store(wal, shards))
        if not read_only:
            cur, _ = ep.read_epoch(epoch_path)
            if cur == 0:
                ep.write_epoch(epoch_path, 1, cfg.cluster_owner)
                cur = 1
            else:
                cur = ep.bump_epoch(epoch_path, cfg.cluster_owner,
                                    expect=cur)
            writer_epoch = cur
            epoch_guard = ep.EpochGuard(
                epoch_path, cur, interval_s=cfg.epoch_check_interval_s)
    tsdb = open_tsdb(cfg, wal,
                     start_compaction_thread=start_compaction_thread,
                     shards=shards, read_only=read_only,
                     writer_epoch=writer_epoch, epoch_guard=epoch_guard)
    tsdb.cluster_epoch_path = epoch_path
    return tsdb


def _mesh_width(shape: str) -> int:
    """The shards a ``--mesh`` shape asks for (0 for none)."""
    shape = (shape or "").strip().lower()
    if not shape:
        return 0
    r, _, c = shape.partition("x")
    return int(r) * int(c or 1)


def cmd_tsd(args) -> int:
    role = args.role
    if role == "router":
        return _cmd_router(args)
    read_only = args.read_only
    if role == "replica":
        # A replica is a read-only daemon plus the WAL tailer and the
        # staleness contract, on by default for the role.
        read_only = True
        if not args.max_staleness_ms:
            args.max_staleness_ms = 5000.0
    cfg = Config(
        table=args.table, uidtable=args.uidtable, backend=args.backend,
        device=args.device, auto_create_metrics=args.auto_metric,
        port=args.port, bind=args.bind, flush_interval=args.flush_interval,
        checkpoint_interval=args.checkpoint_interval,
        ingest_rate=args.ingest_rate,
        ingest_queue_points=args.ingest_queue_points,
        tenant_accounting=not args.no_tenant_accounting,
        tenant_max_series=args.tenant_max_series,
        tenant_global_max_series=args.tenant_global_max_series,
        tenant_limit_mode=args.tenant_limit_mode,
        tenant_overrides=tuple(args.tenant_override),
        tenant_exact_cutoff=args.tenant_exact_cutoff,
        wal_group_ms=args.wal_group_ms,
        sstable_codec=args.sstable_codec,
        slow_query_ms=args.slow_query_ms,
        selfmon_interval_s=args.selfmon_interval,
        trace_ring=args.trace_ring, trace_sample_n=args.trace_sample_n,
        role=role, max_staleness_ms=args.max_staleness_ms,
        tail_interval_s=args.tail_interval, cluster=args.cluster,
        cluster_owner=args.cluster_owner,
        query_max_inflight=args.query_max_inflight,
        query_rate=args.query_rate, query_burst=args.query_burst,
        mesh_devices=args.mesh_devices, mesh_shape=args.mesh,
        devwindow_shards=args.devwindow_shards,
        expert_parallel=args.expert_parallel, mesh_plane=args.mesh_plane,
        mesh_plane_procs=args.mesh_plane_procs,
        mesh_plane_id=args.mesh_plane_id)
    apply_rollup_args(cfg, args)
    if cfg.mesh_plane:
        # Join the plane before the storage engine builds a window: a
        # failed join is a boot failure, never a silent singleton.
        from opentsdb_tpu_torch.parallel.fleet import init_plane
        local = cfg.devwindow_shards or _mesh_width(cfg.mesh_shape) or 1
        plane = init_plane(cfg.mesh_plane, cfg.mesh_plane_procs,
                           cfg.mesh_plane_id, devices_local=local,
                           device=cfg.device)
        if cfg.devwindow_shards == 0:
            # The resident hot set defaults to one shard per local mesh
            # device: the deployment mode's point.
            cfg.devwindow_shards = max(1, plane["devices_local"])
    tsdb = make_tsdb(cfg, args.wal, shards=args.shards,
                     read_only=read_only)
    # The replayed WAL and the opened generations are in place: freeze
    # them out of cycle collection (utils/gctune.py).
    tune_for_ingest()
    from opentsdb_tpu_torch.server.tsd import TSDServer
    server = TSDServer(tsdb)
    if role == "replica":
        from opentsdb_tpu_torch.serve.tailer import WalTailer
        tailer = WalTailer(tsdb)
        server.attach_tailer(tailer)
        tailer.start()

    async def main():
        await server.start()
        # Graceful shutdown on SIGTERM/SIGINT: flush + close the WAL and
        # stop threads instead of dying with buffered state.
        loop = asyncio.get_running_loop()
        for sig in (signal.SIGTERM, signal.SIGINT):
            loop.add_signal_handler(sig, server.request_shutdown)
        print(f"Ready to serve on {tsdb.config.bind}:{server.port}",
              flush=True)
        await server.serve_forever()

    asyncio.run(main())
    return 0


def _csv(text: str | None) -> tuple:
    return tuple(u.strip() for u in (text or "").split(",") if u.strip())


def router_config(args) -> Config:
    """The Config of ``tsd --role router``, the JAX CLI's fields."""
    return Config(
        port=args.port, bind=args.bind, role="router",
        router_backends=_csv(args.backends),
        writer_url=args.writer_url or None,
        router_deadline_ms=args.router_deadline_ms,
        router_retries=args.router_retries,
        router_hedge_ms=args.router_hedge_ms,
        probe_interval_s=args.probe_interval,
        router_eject_after=args.router_eject_after,
        query_max_inflight=args.query_max_inflight,
        query_rate=args.query_rate, query_burst=args.query_burst,
        ingest_rate=args.ingest_rate,
        ingest_queue_points=args.ingest_queue_points,
        writer_grace_ms=args.writer_grace_ms,
        router_writers=_csv(args.writers),
        cluster_map=args.cluster_map or None,
        cluster_slots=args.cluster_slots,
        router_rcache=args.router_rcache,
        router_rcache_ms=args.router_rcache_ms,
        trace_ring=args.trace_ring)


def _cmd_router(args) -> int:
    """``tsd --role router``: the storage-free front door
    (``serve/router.py``). Loads neither torch nor the storage engine, so
    a router restarts in well under a second."""
    from opentsdb_tpu_torch.serve.router import RouterServer

    cfg = router_config(args)
    server = RouterServer(cfg)

    async def main():
        await server.start()
        loop = asyncio.get_running_loop()
        for sig in (signal.SIGTERM, signal.SIGINT):
            loop.add_signal_handler(sig, server.request_shutdown)
        print(f"Ready to serve on {cfg.bind}:{server.port}", flush=True)
        await server.serve_forever()

    asyncio.run(main())
    return 0


def cmd_tenants(args) -> int:
    """Per-tenant cardinality report: series counts (exact or HLL tier,
    error declared), the limit governing each tenant, refusal counters,
    and the heavy-hitter summaries — from a live daemon's /api/tenants
    (--url) or an opened store's accountant."""
    if args.url:
        with urllib.request.urlopen(
                args.url.rstrip("/") + "/api/tenants", timeout=15) as r:
            info = json.loads(r.read())
        if not info.get("enabled", True):
            print("tenant accounting is off on that daemon "
                  f"(role {info.get('role', '?')})")
            return 0
    else:
        # A one-shot tool: no resident window to warm and throw away.
        cfg = apply_rollup_args(
            Config(table=args.table, uidtable=args.uidtable,
                   backend=args.backend, device=args.device,
                   device_window=False), args)
        tsdb = open_tsdb(cfg, args.wal, start_compaction_thread=False,
                         shards=args.shards)
        try:
            info = tsdb.tenants.snapshot_info(tsdb.tenant_limits)
        finally:
            tsdb.shutdown()
    if args.json_out:
        json.dump(info, sys.stdout, indent=1)
        print()
        return 0
    print(f"tracked series: {info['tracked_series']}"
          f"  (total ever admitted: {info['total_series']}, "
          f"recovered: {info['recovered_series']})")
    if info.get("mode"):
        print(f"limit mode: {info['mode']}  global limit: "
              f"{info.get('global_limit') or 'unlimited'}")
    hdr = (f"{'tenant':20s} {'series':>10s} {'tier':>6s} "
           f"{'limit':>10s} {'points':>12s} {'refused':>8s} "
           f"{'would':>6s}")
    print(hdr)
    for name, ent in sorted(info["tenants"].items(),
                            key=lambda kv: -kv[1]["series"]):
        err = (f"±{ent['error'] * 100:.0f}%"
               if ent["tier"] == "hll" else "")
        print(f"{name[:20]:20s} {ent['series']:>10d} "
              f"{ent['tier'] + err:>6s} "
              f"{ent.get('limit') or '∞':>10} "
              f"{ent['points']:>12d} {ent['refused']:>8d} "
              f"{ent['would_refuse']:>6d}")
        for hh in ent["top_series"][:args.top]:
            print(f"    series {hh['series']}  points~{hh['points']} "
                  f"(err {hh['err']})")
        for hh in ent["top_prefixes"][:args.top]:
            print(f"    prefix {hh['prefix']}  new-series~"
                  f"{hh['new_series']} (err {hh['err']})")
    return 0


def cmd_fsck(args) -> int:
    """Table consistency check (``tools/fsck.py``): qualifiers, values,
    duplicate or out-of-order points, series blooms, TSST4 blocks (with a
    per-codec count line); ``--fix`` rewrites
    bad rows. ``--expect-clean`` exits 2 on any error found, even under
    ``--fix``: a store that needed fixing after a crash is a failed
    invariant."""
    from opentsdb_tpu_torch.tools.fsck import run_fsck

    # A storage tool: no window to warm, no sketches to re-fold (the
    # port's full re-fold refuses the conflicting duplicates fsck is here
    # to report). It closes the store without a checkpoint, so the
    # snapshots beside it stay as they were and the next open re-folds
    # the rows --fix rewrote from the WAL.
    tsdb = open_tsdb(Config(table=args.table, uidtable=args.uidtable,
                            backend=args.backend, device=args.device,
                            device_window=False, enable_sketches=False),
                     args.wal, start_compaction_thread=False,
                     shards=args.shards)
    try:
        t0 = time.time()
        rep = run_fsck(tsdb, fix=args.fix, log=print)
        print(f"sstables: {rep.bloomed} with series blooms, {rep.plain} "
              f"bloomless/legacy, {rep.bloom_misses} bloom false "
              f"negatives")
        if rep.format_counts:
            mix = " ".join(f"v{fmt}={n}" for fmt, n in
                           sorted(rep.format_counts.items()))
            print(f"sstable formats: {mix}")
        if rep.blocks:
            per = " ".join(f"{name}={n}" for name, n in
                           sorted(rep.codec_counts.items()))
            print(f"compressed blocks: {rep.blocks} audited ({per}), "
                  f"{rep.codec_errors} codec errors")
        dt = max(time.time() - t0, 1e-9)
        print(f"{rep.kvs} KVs (in {rep.rows} rows) analyzed in "
              f"{dt * 1000:.0f}ms (~{rep.kvs / dt:.0f} KV/s)")
        print(f"Found {rep.errors} errors."
              + (f" Fixed {rep.fixed} rows." if args.fix else ""))
    finally:
        tsdb.compactionq.shutdown()
        tsdb.store.close()
    if args.expect_clean and rep.errors:
        return 2
    return 1 if rep.errors and not args.fix else 0


def cmd_stats(args) -> int:
    """Print the /stats lines (or, with --metrics, the Prometheus text)
    of a live daemon (--url) or of an opened store. A store opens as the
    one-shot tools do (no window, no sketches) and closes without a
    checkpoint; the server's counters (connections, RPC latency) need
    --url."""
    if args.url:
        url = args.url.rstrip("/") + (
            "/metrics" if args.metrics else "/stats")
        with urllib.request.urlopen(url, timeout=15) as r:
            sys.stdout.write(r.read().decode("utf-8", "replace"))
        return 0
    from opentsdb_tpu_torch.obs.registry import METRICS
    from opentsdb_tpu_torch.stats.collector import StatsCollector

    with _reader_tsdb(args) as tsdb:
        c = StatsCollector("tsd")
        tsdb.collect_stats(c)
        METRICS.collect(c)
    if args.metrics:
        sys.stdout.write(METRICS.prometheus_text(extra_lines=c.lines))
    elif c.lines:
        print("\n".join(c.lines))
    return 0


@contextlib.contextmanager
def _reader_tsdb(args):
    """The store of a reading subcommand (``stats``, ``sketch-plan``): no
    window, no sketches, an existing rollup tier adopted without a
    catch-up (nothing spills or folds), and closed without a
    checkpoint."""
    cfg = apply_rollup_args(
        Config(table=args.table, uidtable=args.uidtable,
               backend=args.backend, device=args.device,
               device_window=False, enable_sketches=False,
               rollup_catchup="off"), args)
    tsdb = open_tsdb(cfg, args.wal, start_compaction_thread=False,
                     shards=args.shards)
    try:
        yield tsdb
    finally:
        tsdb.compactionq.shutdown()
        try:
            if tsdb.rollups is not None:
                tsdb.rollups.close()
        finally:
            tsdb.store.close()


def cmd_sketch_plan(args) -> int:
    """Preview the accuracy-budgeted sketch allocation
    (``sketch/budget.py``): record densities from the opened store's raw
    tier, the query-workload profile from a live daemon's trace ring
    (``--url``) or uniform weights. Printing only: the tier applies a
    budget through ``--sketch-byte-budget`` at daemon start (a layout
    change rebuilds). The store opens as ``stats`` opens it."""
    from opentsdb_tpu_torch.core.const import MAX_TIMESPAN
    from opentsdb_tpu_torch.sketch import budget as _budget

    budget = args.budget
    if budget is None:
        budget = args.sketch_byte_budget
    if not budget or budget <= 0:
        print("sketch-plan needs --budget (or --sketch-byte-budget) "
              "> 0", file=sys.stderr)
        return 2
    with _reader_tsdb(args) as tsdb:
        tier = tsdb.rollups
        if tier is not None:
            resolutions = tier.resolutions
            rows = tier._estimate_row_hours()
            hll_p = tier.hll_p
        else:
            resolutions = tuple(sorted(
                int(r) for r in tsdb.config.rollup_resolutions))
            rows = 1
            hll_p = tsdb.config.rollup_hll_p
        records = {r: max(rows // max(r // MAX_TIMESPAN, 1), 1)
                   for r in resolutions}
        workload = None
        if args.url:
            try:
                with urllib.request.urlopen(
                        args.url.rstrip("/") + "/api/traces",
                        timeout=10) as resp:
                    ring = json.loads(resp.read())
                workload = _budget.workload_from_ring(ring, resolutions)
                print(f"workload profile from {args.url}: "
                      + ", ".join(f"{r}s={w:g}" for r, w in
                                  sorted(workload.items())))
            except Exception as e:
                print(f"could not fetch workload from {args.url}: {e}"
                      f" (using uniform weights)", file=sys.stderr)
        allocs = _budget.allocate(int(budget), records, workload,
                                  hll_p=hll_p)
        print(_budget.render_plan(allocs, int(budget)))
        if tier is not None and tier.sketch_byte_budget:
            current = {r: tuple(a) for r, a in tier.sketch_alloc.items()}
            planned = {r: (a.digest_k, a.moment_k, a.hll_p)
                       for r, a in allocs.items()}
            if current != planned:
                print("NOTE: differs from the tier's current applied "
                      "allocation — restarting the writer with this "
                      "budget will rebuild the tier")
    return 0


def _store_args(p: argparse.ArgumentParser) -> None:
    p.add_argument("--table", default="tsdb")
    p.add_argument("--uidtable", default="tsdb-uid")
    p.add_argument("--wal", default=None, help="WAL file path (durable "
                   "state; the JAX package's WAL format)")
    p.add_argument("--shards", type=int, default=0,
                   help="partition storage into N series-sharded KVStore "
                        "shards; with N > 1 the --wal path is the store "
                        "DIRECTORY (shard-<i>/ subdirs + SHARDS.json). "
                        "0 = auto: sharded iff --wal already holds a "
                        "SHARDS.json manifest (its count wins); an "
                        "explicit N that disagrees with the manifest is "
                        "a hard error")
    p.add_argument("--backend", default="device", choices=["device", "cpu"],
                   help="device: the port's kernels; cpu: the float64 "
                        "oracle")
    p.add_argument("--device", default="cuda",
                   help="torch device of the kernels (cuda or cpu)")
    p.add_argument("--sketch-byte-budget", type=int, default=None,
                   help="accuracy-budgeted sketch allocation (sketch/"
                        "budget.py): spend this many summary bytes "
                        "across the rollup resolutions (kind + size "
                        "per resolution, Storyboard-style) instead of "
                        "the uniform sketch_min_res cutoff; `tsdb "
                        "sketch-plan` previews the allocation")


def cmd_version(args) -> int:
    from opentsdb_tpu_torch.build_data import build_data, version_string
    print(version_string(), end="")
    if args.verbose:
        for k, v in build_data().items():
            print(f"{k}: {v}")
    return 0


def main(argv: list[str] | None = None) -> int:
    args = build_parser().parse_args(argv)
    return args.func(args)


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="tsdb", description="opentsdb_tpu_torch command-line tool")
    sub = parser.add_subparsers(dest="command", required=True)
    p = sub.add_parser("tsd", help="start the network daemon")
    _store_args(p)
    p.add_argument("--auto-metric", action="store_true",
                   help="automatically create metric UIDs (ingest)")
    p.add_argument("--port", type=int, default=4242)
    p.add_argument("--bind", default="0.0.0.0")
    p.add_argument("--flush-interval", type=float, default=10.0)
    p.add_argument("--checkpoint-interval", type=float, default=0.0,
                   help="seconds between sstable spills + WAL truncation "
                        "(0 disables; requires --wal)")
    p.add_argument("--mesh-devices", type=int, default=0,
                   help="shard fused queries over the first N local "
                        "chips (0 = single-device)")
    p.add_argument("--mesh", default="",
                   help="mesh execution plane: 'N' = 1-D series-hash "
                        "mesh of N shards (N cards; N logical shards "
                        "with --device cpu). Eligible query reductions "
                        "run sharded; supersedes --mesh-devices. "
                        "'RxC' = the 2-D hybrid (host, series) mesh of R "
                        "host rows of C shards")
    p.add_argument("--expert-parallel", action="store_true",
                   help="with --mesh: pack mixed /q dashboard batches "
                        "into expert buckets (one mesh dispatch per "
                        "batch; declines declared per-result as "
                        "plan: expert-decline)")
    p.add_argument("--mesh-plane", default="",
                   help="join the serving mesh plane at HOST:PORT (a "
                        "torch.distributed group, gloo, or NCCL when "
                        "every rank holds a card of its own) before the "
                        "storage opens; a failed join refuses to boot. "
                        "/healthz reports the membership")
    p.add_argument("--mesh-plane-procs", type=int, default=1,
                   help="processes in the mesh plane")
    p.add_argument("--mesh-plane-id", type=int, default=0,
                   help="this process's rank in the mesh plane")
    p.add_argument("--devwindow-shards", type=int, default=0,
                   help="shard the device-resident hot window into N "
                        "columns round-robined over the local mesh "
                        "devices (storage/devshard.py): capacity and "
                        "fold throughput scale with device count, and "
                        "the set reshards LIVE on grow/shrink "
                        "(/api/mesh/reshard). 0 = one resident window")
    p.add_argument("--read-only", action="store_true",
                   help="open the WAL as a read-only replica of a "
                        "(possibly live) writer daemon: serve reads "
                        "over the same store files without the "
                        "single-writer lock; all mutations refused. "
                        "A replica daemon polls the writer's durable "
                        "state every --checkpoint-interval seconds "
                        "(default 5 when read-only)")
    p.add_argument("--role", default="writer",
                   choices=["writer", "replica", "router"],
                   help="writer: the single ingesting daemon "
                        "(default). replica: read-only daemon that "
                        "TAILS the writer's WAL continuously with a "
                        "bounded staleness contract (/healthz reports "
                        "lag vs --max-staleness-ms). router: "
                        "storage-free front door fanning /q across "
                        "--backends with deadlines, retries, hedging "
                        "and health-probe ejection")
    p.add_argument("--max-staleness-ms", type=float, default=0.0,
                   help="replica staleness contract: beyond this lag "
                        "every answer is tagged degraded/stale and "
                        "/healthz turns unhealthy (replica role "
                        "defaults to 5000; 0 elsewhere disables)")
    p.add_argument("--tail-interval", type=float, default=0.25,
                   help="seconds between WAL tail cycles (replica)")
    p.add_argument("--backends", default="",
                   help="router: comma-separated replica base URLs "
                        "(http://host:port)")
    p.add_argument("--writer-url", default=None,
                   help="router: forward telnet put lines here")
    p.add_argument("--router-deadline-ms", type=float, default=10000.0)
    p.add_argument("--router-retries", type=int, default=2)
    p.add_argument("--router-hedge-ms", type=float, default=0.0,
                   help="hedge a slow hop after this many ms (0 = "
                        "derive from the observed p95; negative "
                        "disables)")
    p.add_argument("--probe-interval", type=float, default=1.0)
    p.add_argument("--router-eject-after", type=int, default=3)
    p.add_argument("--cluster", action="store_true",
                   help="join the cluster write tier: adopt/create "
                        "EPOCH.json next to the WAL, stamp writer "
                        "epochs into WAL segments, fence mutations "
                        "once deposed (writers); accept /promote "
                        "(replicas)")
    p.add_argument("--cluster-owner", default=None,
                   help="this daemon's label in EPOCH.json bumps "
                        "(default host:pid)")
    p.add_argument("--writer-grace-ms", type=float, default=0.0,
                   help="router: promote a replica once the writer's "
                        "/healthz has been dead this long (0 = "
                        "operator-driven failover only)")
    p.add_argument("--writers", default="",
                   help="router: comma-separated writer base URLs; "
                        ">1 enables multi-writer series-hash "
                        "sharding via the ownership map")
    p.add_argument("--cluster-map", default=None,
                   help="router: CLUSTER.json ownership-map path "
                        "(created as an equal split over --writers "
                        "when missing)")
    p.add_argument("--cluster-slots", type=int, default=64,
                   help="hash-space slots for a newly created "
                        "ownership map")
    p.add_argument("--router-rcache", type=int, default=0,
                   help="router: bounded result-cache entries keyed "
                        "by (query, ownership epoch, staleness "
                        "bound); 0 disables")
    p.add_argument("--router-rcache-ms", type=float, default=1000.0,
                   help="router result-cache staleness bound")
    p.add_argument("--wal-group-ms", type=float, default=0.0,
                   help="WAL group-commit window in ms: concurrent "
                        "durable appends coalesce into one WAL "
                        "write+fsync per window, acks release only "
                        "after the covering fsync (storage/kv.py). "
                        "0 (default) = legacy per-barrier flushing, "
                        "bit-identical WAL bytes")
    p.add_argument("--sstable-codec", default="none",
                   choices=["none", "tsst4"],
                   help="write-side sstable format: 'tsst4' spills "
                        "compressed columnar blocks (delta-of-delta "
                        "timestamps + XOR floats; compress/). The read "
                        "side sniffs each file, so existing v1-v3 "
                        "generations keep serving and compaction "
                        "re-encodes as they merge")
    # Materialized rollup tier (rollup/).
    p.add_argument("--rollups", action="store_true",
                   help="maintain the materialized rollup tier "
                        "(rollup/): per-series 1h/1d summaries folded at "
                        "checkpoint spill and served by the query "
                        "planner for window-aligned downsamples. Writer "
                        "daemons with --wal only; a stale/missing tier "
                        "degrades to raw scans")
    p.add_argument("--rollup-resolutions", default=None,
                   help="comma-separated rollup window sizes in seconds "
                        "(ascending, each a multiple of 3600 dividing "
                        "the next; default 3600,86400)")
    p.add_argument("--rollup-device-fold", action="store_true",
                   help="fold the rollup tier at each checkpoint on the "
                        "card with the window-fold kernel, in float64 "
                        "(declared device-f64 in the tier's state file; "
                        "a fold-kind change rebuilds the tier)")
    # Tenant cardinality control plane (tenant/).
    p.add_argument("--tenant-max-series", type=int, default=0,
                   help="refuse a NEW series from any tenant already "
                        "at this many distinct series (declared "
                        "refusal, never a throttle; existing series "
                        "keep ingesting; 0 = unlimited)")
    p.add_argument("--tenant-global-max-series", type=int, default=0,
                   help="directory-wide series cap across every "
                        "tenant (0 = unlimited)")
    p.add_argument("--tenant-limit-mode", default="enforce",
                   choices=["enforce", "warn"],
                   help="warn: count + log would-be refusals "
                        "(would_refuse) without refusing — the dry run "
                        "before enforcement")
    p.add_argument("--tenant-override", action="append", default=[],
                   metavar="TENANT=LIMIT",
                   help="per-tenant series cap beating "
                        "--tenant-max-series (repeatable; 0 = "
                        "unlimited for that tenant)")
    p.add_argument("--tenant-exact-cutoff", type=int, default=4096,
                   help="distinct series per tenant before its exact "
                        "accounting set folds into an HLL sketch "
                        "(bounded memory under hostile cardinality)")
    p.add_argument("--no-tenant-accounting", action="store_true",
                   help="disable per-tenant series accounting + "
                        "tenant snapshots entirely")
    # Admission control (serve/admission.py; any role, off by default).
    p.add_argument("--query-max-inflight", type=int, default=0,
                   help="load-shedding ladder threshold N: N..2N in "
                        "flight degrades (rollup-only), 2N sheds 503")
    p.add_argument("--query-rate", type=float, default=0.0,
                   help="per-tenant queries/s quota (429 when dry)")
    p.add_argument("--query-burst", type=float, default=8.0,
                   help="per-tenant query bucket burst allowance")
    p.add_argument("--ingest-rate", type=float, default=0.0,
                   help="per-tenant ingest points/s quota")
    p.add_argument("--ingest-queue-points", type=int, default=0,
                   help="global in-flight decoded-point cap; over it "
                        "puts shed with a throttle line")
    # Observability (obs/).
    p.add_argument("--slow-query-ms", type=float, default=0.0,
                   help="trace every /q and log one-line JSON records "
                        "(span tree + plan) for queries at/over this "
                        "wall time; they land in /api/traces too "
                        "(0 disables)")
    p.add_argument("--selfmon-interval", type=float, default=0.0,
                   help="seconds between self-monitoring cycles that "
                        "ingest /stats into the store itself as tsd.* "
                        "series (0 disables)")
    p.add_argument("--trace-ring", type=int, default=256,
                   help="traced / slow query records kept for "
                        "/api/traces")
    p.add_argument("--trace-sample-n", type=int, default=0,
                   help="trace 1 /q in N into the trace ring (0 "
                        "disables)")
    p.set_defaults(func=cmd_tsd)

    p = sub.add_parser(
        "tenants",
        help="per-tenant series cardinality, limits, refusals and "
             "heavy hitters (tenant/)")
    _store_args(p)
    p.add_argument("--url", default=None,
                   help="base URL of a live tsd: fetch its "
                        "/api/tenants instead of opening a store")
    p.add_argument("--json", dest="json_out", action="store_true",
                   help="raw JSON instead of the table")
    p.add_argument("--top", type=int, default=3,
                   help="heavy-hitter rows to print per tenant")
    p.set_defaults(func=cmd_tenants)

    p = sub.add_parser("fsck", help="check table consistency")
    _store_args(p)
    p.add_argument("--fix", action="store_true")
    p.add_argument("--expect-clean", action="store_true",
                   help="exit 2 if ANY error is found (even with "
                        "--fix) — the crash-harness/CI contract")
    p.set_defaults(func=cmd_fsck)

    p = sub.add_parser(
        "stats", help="print /stats lines from a server or a store")
    _store_args(p)
    p.add_argument("--url", default=None,
                   help="base URL of a live tsd (e.g. "
                        "http://localhost:4242): fetch its /stats "
                        "instead of opening a store")
    p.add_argument("--metrics", action="store_true",
                   help="Prometheus text exposition (/metrics) instead "
                        "of classic stats lines")
    p.set_defaults(func=cmd_stats)

    p = sub.add_parser(
        "sketch-plan",
        help="preview the accuracy-budgeted sketch allocation for a "
             "byte budget (sketch/budget.py)")
    _store_args(p)
    p.add_argument("--budget", type=int, default=None,
                   help="summary-byte budget to plan for (falls back "
                        "to --sketch-byte-budget)")
    p.add_argument("--url", default=None,
                   help="base URL of a live tsd: derive the query-"
                        "workload profile from its /api/traces ring "
                        "instead of uniform weights")
    p.set_defaults(func=cmd_sketch_plan)

    p = sub.add_parser("version", help="print build/version information")
    p.add_argument("--verbose", action="store_true")
    p.set_defaults(func=cmd_version)
    return parser


if __name__ == "__main__":
    raise SystemExit(main())
