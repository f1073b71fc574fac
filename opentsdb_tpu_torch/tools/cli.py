"""The ``tsd``, ``tenants``, ``fsck`` and ``stats`` commands.

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

``tenants`` prints the per-tenant cardinality report of a store
(``--wal``) or of a live daemon (``--url``, its ``/api/tenants``).
``fsck`` checks a store (``tools/fsck.py``); ``--fix`` salvages bad rows
and ``--expect-clean`` exits 2 on any error, even when fixed.

``stats`` prints the ``/stats`` lines (``--metrics``: the Prometheus text
of ``/metrics``) of a live daemon (``--url``) or of a store (``--wal``:
the engine's stats and the metrics registry; the server's own counters
need ``--url``). The daemon's observability flags: ``--slow-query-ms``,
``--selfmon-interval``, ``--trace-ring`` and ``--trace-sample-n``.
"""

from __future__ import annotations

import argparse
import asyncio
import json
import os
import signal
import sys
import time
import urllib.request

from opentsdb_tpu_torch.core.tsdb import TSDB
from opentsdb_tpu_torch.server.tsd import TSDServer
from opentsdb_tpu_torch.storage.kv import KVStore, MemKVStore
from opentsdb_tpu_torch.storage.sharded import ShardedKVStore, manifest_path
from opentsdb_tpu_torch.utils.config import Config
from opentsdb_tpu_torch.utils.gctune import tune_for_ingest


def open_store(cfg: Config, wal: str | None, shards: int = 0) -> KVStore:
    """The store at ``wal``, replayed and opened: sharded when ``shards``
    > 1 or ``wal`` holds a ``SHARDS.json`` (an explicit count, 1 included,
    must then match it), else one WAL store."""
    if shards > 1 or (wal and os.path.exists(manifest_path(wal))):
        return ShardedKVStore(wal, shards=shards if shards >= 1 else None,
                              data_table=cfg.table,
                              throttle_rows=cfg.throttle_rows,
                              fsync=cfg.fsync)
    return MemKVStore(wal_path=wal, throttle_rows=cfg.throttle_rows,
                      fsync=cfg.fsync)


def open_tsdb(cfg: Config, wal: str | None,
              start_compaction_thread: bool = True,
              shards: int = 0) -> TSDB:
    """The store and TSDB the daemon serves: the WAL, sharded or memory
    store (``open_store``), replayed and opened, under ``cfg``."""
    return TSDB(open_store(cfg, wal, shards), cfg,
                start_compaction_thread=start_compaction_thread)


def cmd_tsd(args) -> int:
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
        trace_ring=args.trace_ring, trace_sample_n=args.trace_sample_n)
    tsdb = open_tsdb(cfg, args.wal, shards=args.shards)
    # The replayed WAL and the opened generations are in place: freeze
    # them out of cycle collection (utils/gctune.py).
    tune_for_ingest()
    server = TSDServer(tsdb)

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
        tsdb = open_tsdb(Config(table=args.table, uidtable=args.uidtable,
                                backend=args.backend, device=args.device,
                                device_window=False), args.wal,
                         start_compaction_thread=False, shards=args.shards)
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

    tsdb = open_tsdb(Config(table=args.table, uidtable=args.uidtable,
                            backend=args.backend, device=args.device,
                            device_window=False, enable_sketches=False),
                     args.wal, start_compaction_thread=False,
                     shards=args.shards)
    try:
        c = StatsCollector("tsd")
        tsdb.collect_stats(c)
        METRICS.collect(c)
    finally:
        tsdb.compactionq.shutdown()
        tsdb.store.close()
    if args.metrics:
        sys.stdout.write(METRICS.prometheus_text(extra_lines=c.lines))
    elif c.lines:
        print("\n".join(c.lines))
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


def cmd_version(args) -> int:
    from opentsdb_tpu_torch.build_data import build_data, version_string
    print(version_string(), end="")
    if args.verbose:
        for k, v in build_data().items():
            print(f"{k}: {v}")
    return 0


def main(argv: list[str] | None = None) -> int:
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
    # Ingest admission (serve/admission.py; off by default).
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

    p = sub.add_parser("version", help="print build/version information")
    p.add_argument("--verbose", action="store_true")
    p.set_defaults(func=cmd_version)
    args = parser.parse_args(argv)
    return args.func(args)


if __name__ == "__main__":
    raise SystemExit(main())
