"""The ``tsd`` command: start the port's network daemon.

Mirrors the ``tsd`` subcommand of ``opentsdb_tpu/tools/cli.py`` (the
reference's TSDMain.java). The daemon serves on the CUDA card unless
``--device cpu`` is given; ``--backend cpu`` answers queries with the
float64 oracle instead of the kernels. As in the JAX package's daemon,
the resident device window is on: ingest (and, at start-up, what the
sstable generations and the WAL hold) is mirrored into device memory, and
downsampled moment queries are served from it (``"rollup": "resident"``
in the /q JSON). With ``--wal`` the store spills to sstable generations
beside the WAL at every ``--checkpoint-interval`` seconds and at shutdown,
in the JAX package's formats. Run it with

    python -m opentsdb_tpu_torch.tools.cli tsd --port 4242 \\
        --wal /var/tsdb/wal --auto-metric
"""

from __future__ import annotations

import argparse
import asyncio
import signal

from opentsdb_tpu_torch.core.tsdb import TSDB
from opentsdb_tpu_torch.server.tsd import TSDServer
from opentsdb_tpu_torch.storage.kv import MemKVStore
from opentsdb_tpu_torch.utils.config import Config


def cmd_tsd(args) -> int:
    cfg = Config(
        table=args.table, uidtable=args.uidtable, backend=args.backend,
        device=args.device, auto_create_metrics=args.auto_metric,
        port=args.port, bind=args.bind, flush_interval=args.flush_interval,
        checkpoint_interval=args.checkpoint_interval)
    tsdb = TSDB(MemKVStore(wal_path=args.wal,
                           throttle_rows=cfg.throttle_rows), cfg)
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


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(
        prog="tsdb", description="opentsdb_tpu_torch command-line tool")
    sub = parser.add_subparsers(dest="command", required=True)
    p = sub.add_parser("tsd", help="start the network daemon")
    p.add_argument("--table", default="tsdb")
    p.add_argument("--uidtable", default="tsdb-uid")
    p.add_argument("--wal", default=None, help="WAL file path (durable "
                   "state; the JAX package's WAL format)")
    p.add_argument("--backend", default="device", choices=["device", "cpu"],
                   help="device: the port's kernels; cpu: the float64 "
                        "oracle")
    p.add_argument("--device", default="cuda",
                   help="torch device of the kernels (cuda or cpu)")
    p.add_argument("--auto-metric", action="store_true",
                   help="automatically create metric UIDs (ingest)")
    p.add_argument("--port", type=int, default=4242)
    p.add_argument("--bind", default="0.0.0.0")
    p.add_argument("--flush-interval", type=float, default=10.0)
    p.add_argument("--checkpoint-interval", type=float, default=0.0,
                   help="seconds between sstable spills + WAL truncation "
                        "(0 disables; requires --wal)")
    p.set_defaults(func=cmd_tsd)
    args = parser.parse_args(argv)
    return args.func(args)


if __name__ == "__main__":
    raise SystemExit(main())
