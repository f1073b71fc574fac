"""The ``tsd`` and ``tenants`` commands.

Mirrors those subcommands of ``opentsdb_tpu/tools/cli.py`` (the
reference's TSDMain.java for ``tsd``). The daemon serves on the CUDA card
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

``tenants`` prints the per-tenant cardinality report of a store
(``--wal``) or of a live daemon (``--url``, its ``/api/tenants``).
"""

from __future__ import annotations

import argparse
import asyncio
import json
import signal
import sys
import urllib.request

from opentsdb_tpu_torch.core.tsdb import TSDB
from opentsdb_tpu_torch.server.tsd import TSDServer
from opentsdb_tpu_torch.storage.kv import MemKVStore
from opentsdb_tpu_torch.utils.config import Config
from opentsdb_tpu_torch.utils.gctune import tune_for_ingest


def open_tsdb(cfg: Config, wal: str | None,
              start_compaction_thread: bool = True) -> TSDB:
    """The store and TSDB the daemon serves: the WAL (or memory) store,
    replayed and opened, under ``cfg``."""
    return TSDB(MemKVStore(wal_path=wal, throttle_rows=cfg.throttle_rows),
                cfg, start_compaction_thread=start_compaction_thread)


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
        tenant_exact_cutoff=args.tenant_exact_cutoff)
    tsdb = open_tsdb(cfg, args.wal)
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
                         start_compaction_thread=False)
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


def _store_args(p: argparse.ArgumentParser) -> None:
    p.add_argument("--table", default="tsdb")
    p.add_argument("--uidtable", default="tsdb-uid")
    p.add_argument("--wal", default=None, help="WAL file path (durable "
                   "state; the JAX package's WAL format)")
    p.add_argument("--backend", default="device", choices=["device", "cpu"],
                   help="device: the port's kernels; cpu: the float64 "
                        "oracle")
    p.add_argument("--device", default="cuda",
                   help="torch device of the kernels (cuda or cpu)")


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
    args = parser.parse_args(argv)
    return args.func(args)


if __name__ == "__main__":
    raise SystemExit(main())
