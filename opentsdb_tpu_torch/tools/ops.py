"""Operational side-tools: alerting probe, maintenance drain, cache cleaner.

Mirrors ``opentsdb_tpu/tools/ops.py`` of the JAX package (standard
library only, copied: the port imports nothing of that package), so the
port's ``tsdb`` gives the same answers, exit codes and files.

  check     Nagios-style threshold alerting over ``/q?...&ascii`` of a
            running daemon, either package's (reference tools/check_tsd:
            comparators gt/ge/lt/le/eq/ne, warning/critical thresholds,
            --ignore-recent window, --no-result-ok, downsample/rate query
            construction; ratio, skew and ``/stats`` checks).
  drain     low-end TCP sink for ``put`` lines during storage maintenance,
            one append-only file per client IP, re-importable later with
            ``tsdb import`` (reference tools/tsddrain.py).
  clean-cache
            delete ``/q`` disk-cache files when the cache volume is nearly
            full (reference tools/clean_cache.sh: acts at >=90% disk
            usage).

All three are ``tsdb`` subcommands (``tools/cli.py``).
"""

from __future__ import annotations

import argparse
import asyncio
import http.client
import operator
import os
import shutil
import sys
import time

COMPARATORS = {
    "gt": operator.gt, "ge": operator.ge, "lt": operator.lt,
    "le": operator.le, "eq": operator.eq, "ne": operator.ne,
}

# Nagios exit codes.
OK, WARNING, CRITICAL = 0, 1, 2


def add_check_args(p: argparse.ArgumentParser) -> None:
    p.add_argument("-H", "--host", default="localhost")
    p.add_argument("-p", "--port", type=int, default=4242)
    p.add_argument("-m", "--metric", default=None,
                   help="metric to probe via /q (required unless "
                        "--stats-metric)")
    p.add_argument("-t", "--tag", action="append", default=[],
                   help="tag=value filter (repeatable)")
    p.add_argument("-d", "--duration", type=int, default=600,
                   help="how far back to look, seconds")
    p.add_argument("-D", "--downsample", default="none",
                   choices=["none", "avg", "min", "sum", "max"])
    p.add_argument("-W", "--downsample-window", type=int, default=60)
    p.add_argument("-a", "--aggregator", default="sum")
    p.add_argument("-x", "--method", dest="comparator", default="gt",
                   choices=sorted(COMPARATORS))
    p.add_argument("-r", "--rate", action="store_true")
    p.add_argument("-w", "--warning", type=float, default=None)
    p.add_argument("-c", "--critical", type=float, default=None)
    p.add_argument("-E", "--no-result-ok", action="store_true")
    p.add_argument("-I", "--ignore-recent", type=int, default=0,
                   help="ignore data points newer than this many seconds")
    p.add_argument("-T", "--timeout", type=int, default=10)
    p.add_argument("-v", "--verbose", action="store_true")
    # Ratio checks (the self-monitoring alerting follow-on): divide
    # the probed metric by a second one, timestamp-aligned, and
    # threshold the RATIO — e.g. a fragment-cache hit ratio from the
    # tsd.qcache.hit / tsd.qcache.miss series the selfmon loop
    # ingests:
    #   tsdb check -m tsd.qcache.hit -R tsd.qcache.miss --ratio-total \
    #        -x lt -c 0.5
    p.add_argument("-R", "--divide-by", default=None,
                   help="second metric; checked value becomes "
                        "a/b per aligned timestamp (b's query reuses "
                        "the same tags/downsample/rate)")
    p.add_argument("--ratio-total", action="store_true",
                   help="with --divide-by: use a/(a+b) instead of "
                        "a/b (hit-ratio shape; denominator-0 points "
                        "are skipped either way)")
    p.add_argument("--skew", action="store_true",
                   help="threshold the per-timestamp SPREAD (max - "
                        "min) across the answer's series instead of "
                        "the raw values — the cluster epoch-skew "
                        "alert over self-monitored series: daemons "
                        "disagreeing about the writer epoch is a "
                        "failover wedged halfway. Query with a "
                        "group-by so daemons stay distinct lines: "
                        "tsdb check -m tsd.cluster.epoch -t host=* "
                        "--skew -x gt -c 0")
    p.add_argument("--stats-metric", default=None,
                   help="threshold a live /stats line instead of a "
                        "/q series (read-only replicas can't "
                        "self-ingest tsd.* series, but their /stats "
                        "carries the same values — e.g. "
                        "--stats-metric tsd.replica.lag_ms -x gt "
                        "-c 5000 alerts on the staleness contract). "
                        "-m is ignored in this mode")


def check_query_path(args) -> str:
    """Build the `/q` target the probe fetches (ascii, one metric)."""
    tags = ",".join(args.tag)
    spec = args.aggregator + ":"
    if args.downsample != "none":
        spec += f"{args.downsample_window}s-{args.downsample}:"
    if args.rate:
        spec += "rate:"
    spec += args.metric
    if tags:
        spec += "{" + tags + "}"
    return f"/q?start={args.duration}s-ago&m={spec}&ascii&nagios"


def evaluate_check(args, lines: list[str], now: int) -> tuple[int, str]:
    """Threshold logic over ascii output lines `metric ts value tags...`.

    Returns (nagios_rv, message). A point is counted only when it falls
    inside (now-duration, now-ignore_recent]; the worst offending value
    (by the chosen comparator) is reported.
    """
    cmp_ = COMPARATORS[args.comparator]
    warning = args.warning if args.warning is not None else args.critical
    critical = args.critical if args.critical is not None else args.warning
    rv = OK
    npoints = nbad = 0
    badval = badts = None
    val = None
    for line in lines:
        parts = line.split()
        if len(parts) < 3:
            continue
        ts = int(parts[1])
        delta = now - ts
        if delta > args.duration or delta <= args.ignore_recent:
            continue
        npoints += 1
        val = float(parts[2]) if "." in parts[2] else int(parts[2])
        bad = False
        if cmp_(val, critical):
            rv, bad = CRITICAL, True
        elif rv < CRITICAL and cmp_(val, warning):
            rv, bad = WARNING, True
        if bad:
            nbad += 1
            if badval is None or cmp_(val, badval):
                badval, badts = val, ts
    if not npoints:
        if args.no_result_ok:
            return OK, "OK: query did not return any data point"
        return CRITICAL, "CRITICAL: query did not return any data point"
    tags = ("{" + ",".join(args.tag) + "}") if args.tag else ""
    tags = tags.replace("|", ":")  # '|' is special to nrpe
    if rv == OK:
        return OK, (f"OK: {args.metric}{tags}: {npoints} values OK, "
                    f"last={val!r}")
    level = "WARNING" if rv == WARNING else "CRITICAL"
    threshold = warning if rv == WARNING else critical
    when = time.asctime(time.localtime(badts))
    return rv, (f"{level}: {args.metric}{tags} {args.comparator} {threshold}:"
                f" {nbad}/{npoints} bad values ({nbad * 100.0 / npoints:.1f}%)"
                f" worst: {badval!r} @ {when}")


def _sum_by_ts(lines: list[str]) -> dict[int, float]:
    """Collapse ascii /q lines to {ts: summed value} (the probe's
    aggregator already merged groups; summing here makes multi-line
    answers — distinct tag sets — behave like one series)."""
    out: dict[int, float] = {}
    for line in lines:
        parts = line.split()
        if len(parts) < 3:
            continue
        try:
            ts, val = int(parts[1]), float(parts[2])
        except ValueError:
            continue
        out[ts] = out.get(ts, 0.0) + val
    return out


def ratio_lines(num_lines: list[str], den_lines: list[str],
                metric: str, total: bool) -> list[str]:
    """Timestamp-aligned a/b (or a/(a+b)) as synthetic ascii lines, so
    the threshold logic runs unchanged on ratios. Zero denominators
    are skipped — no data beats a division blowup in an alert."""
    num = _sum_by_ts(num_lines)
    den = _sum_by_ts(den_lines)
    out = []
    for ts in sorted(set(num) & set(den)):
        d = num[ts] + den[ts] if total else den[ts]
        if d == 0:
            continue
        out.append(f"{metric} {ts} {num[ts] / d!r}")
    return out


def skew_lines(lines: list[str], metric: str) -> list[str]:
    """Per-timestamp max-min across an answer's lines, as synthetic
    ascii lines the threshold logic runs on unchanged. Unlike
    ``_sum_by_ts`` this keeps every line DISTINCT per timestamp (each
    tag set — each daemon, for selfmon-ingested tsd.* series — is one
    observation; the spread between them is the alert signal).
    Timestamps with a single observation still emit (spread 0): a
    one-daemon window is agreement, not no-data."""
    by_ts: dict[int, list[float]] = {}
    for line in lines:
        parts = line.split()
        if len(parts) < 3:
            continue
        try:
            ts, val = int(parts[1]), float(parts[2])
        except ValueError:
            continue
        by_ts.setdefault(ts, []).append(val)
    return [f"{metric} {ts} {max(vs) - min(vs)!r}"
            for ts, vs in sorted(by_ts.items())]


def _fetch_ascii(args, url: str):
    """GET an ascii /q; returns (lines, None) or (None, exit code)."""
    conn = http.client.HTTPConnection(args.host, args.port,
                                      timeout=args.timeout)
    try:
        conn.request("GET", url)
        res = conn.getresponse()
        body = res.read().decode("utf-8", "replace")
        conn.close()
    except (OSError, http.client.HTTPException) as e:
        print(f"ERROR: couldn't GET {url} from "
              f"{args.host}:{args.port}: {e}")
        return None, CRITICAL
    if res.status not in (200, 202):
        print(f"CRITICAL: status = {res.status} when talking to "
              f"{args.host}:{args.port}")
        if args.verbose:
            print(body)
        return None, CRITICAL
    if args.verbose:
        print(body)
    return body.splitlines(), None


def check_stats_metric(args) -> int:
    """Threshold the CURRENT value of one /stats line (gauge shape):
    the replica-lag / shed-counter alerting path, no selfmon loop or
    writable store required."""
    lines, err = _fetch_ascii(args, "/stats")
    if err is not None:
        return err
    name = args.stats_metric
    cmp_ = COMPARATORS[args.comparator]
    warning = args.warning if args.warning is not None else args.critical
    critical = args.critical if args.critical is not None else args.warning
    worst = None
    for line in lines:
        parts = line.split()
        if len(parts) < 3 or parts[0] != name:
            continue
        val = float(parts[2])
        if worst is None or cmp_(val, worst):
            worst = val
    if worst is None:
        if args.no_result_ok:
            print(f"OK: no {name} line in /stats")
            return OK
        print(f"CRITICAL: no {name} line in /stats")
        return CRITICAL
    if cmp_(worst, critical):
        print(f"CRITICAL: {name} {args.comparator} {critical}: "
              f"value={worst!r}")
        return CRITICAL
    if cmp_(worst, warning):
        print(f"WARNING: {name} {args.comparator} {warning}: "
              f"value={worst!r}")
        return WARNING
    print(f"OK: {name}: value={worst!r}")
    return OK


def cmd_check(args) -> int:
    if args.warning is None and args.critical is None:
        print("ERROR: need at least one of --warning/--critical",
              file=sys.stderr)
        return CRITICAL
    if getattr(args, "stats_metric", None):
        return check_stats_metric(args)
    if not args.metric:
        print("ERROR: need -m/--metric (or --stats-metric)",
              file=sys.stderr)
        return CRITICAL
    now = int(time.time())
    lines, err = _fetch_ascii(args, check_query_path(args))
    if err is not None:
        return err
    if getattr(args, "skew", False):
        # Spread-across-series mode (epoch skew): query with a
        # group-by (-t host=*) so each daemon stays a distinct line.
        import copy
        label = f"skew({args.metric})"
        lines = skew_lines(lines, label)
        args = copy.copy(args)
        args.metric = label
    divisor = getattr(args, "divide_by", None)
    if divisor:
        import copy
        args2 = copy.copy(args)
        args2.metric = divisor
        den_lines, err = _fetch_ascii(args2, check_query_path(args2))
        if err is not None:
            return err
        label = (f"{args.metric}/({args.metric}+{divisor})"
                 if getattr(args, "ratio_total", False)
                 else f"{args.metric}/{divisor}")
        lines = ratio_lines(lines, den_lines, label,
                            getattr(args, "ratio_total", False))
        args = copy.copy(args)
        args.metric = label
    rv, msg = evaluate_check(args, lines, now)
    print(msg)
    return rv


# ---------------------------------------------------------------------------
# drain
# ---------------------------------------------------------------------------

class DrainServer:
    """TCP sink for `put` lines while the real daemon is down.

    Each client IP gets one append-only file under `draindir` holding the
    lines minus the `put ` prefix — exactly the text-import format — so
    recovery is `tsdb import draindir/*`. Answers `version` so collectors'
    health checks keep passing.
    """

    def __init__(self, draindir: str, bind: str = "0.0.0.0",
                 port: int = 4242) -> None:
        self.draindir = draindir
        self.bind = bind
        self._port = port
        self._server: asyncio.AbstractServer | None = None
        self.lines_drained = 0

    @property
    def port(self) -> int:
        if self._server is not None:
            return self._server.sockets[0].getsockname()[1]
        return self._port

    async def start(self) -> None:
        os.makedirs(self.draindir, exist_ok=True)
        self._server = await asyncio.start_server(
            self._handle, self.bind, self._port)

    async def stop(self) -> None:
        if self._server is not None:
            self._server.close()
            await self._server.wait_closed()

    async def serve_forever(self) -> None:
        assert self._server is not None
        async with self._server:
            await self._server.serve_forever()

    async def _handle(self, reader: asyncio.StreamReader,
                      writer: asyncio.StreamWriter) -> None:
        peer = writer.get_extra_info("peername") or ("unknown",)
        path = os.path.join(self.draindir, str(peer[0]))
        try:
            with open(path, "ab") as out:
                while True:
                    line = await reader.readline()
                    if not line:
                        break
                    if line.strip() == b"version":
                        writer.write(b"tsdb drain\n")
                        await writer.drain()
                        continue
                    if not line.startswith(b"put "):
                        continue
                    out.write(line[4:])
                    out.flush()
                    self.lines_drained += 1
        finally:
            writer.close()


def cmd_drain(args) -> int:
    server = DrainServer(args.dir, bind=args.bind, port=args.port)

    async def main():
        await server.start()
        print(f"draining to {args.dir} on {args.bind}:{server.port}",
              flush=True)
        await server.serve_forever()

    try:
        asyncio.run(main())
    except KeyboardInterrupt:
        pass
    return 0


# ---------------------------------------------------------------------------
# clean-cache
# ---------------------------------------------------------------------------

def clean_cache(cachedir: str, threshold_pct: float = 90.0,
                now: float | None = None, min_age: float = 0.0) -> int:
    """Delete cache files when the volume holding `cachedir` is nearly full.

    Returns the number of files removed (0 when usage < threshold).
    `min_age` spares files younger than that many seconds (an improvement
    over the reference's indiscriminate `rm -rf`: in-flight renders
    survive).
    """
    if not os.path.isdir(cachedir):
        return 0
    usage = shutil.disk_usage(cachedir)
    # df's Use%: used/(used+avail), so root-reserved blocks don't hide
    # pressure on the non-superuser space the cache actually writes to.
    pct = 100.0 * usage.used / max(usage.used + usage.free, 1)
    if pct < threshold_pct:
        return 0
    now = time.time() if now is None else now
    removed = 0
    for name in os.listdir(cachedir):
        path = os.path.join(cachedir, name)
        try:
            if not os.path.isfile(path):
                continue
            if min_age and now - os.path.getmtime(path) < min_age:
                continue
            os.unlink(path)
            removed += 1
        except OSError:
            continue
    return removed


def cmd_clean_cache(args) -> int:
    removed = clean_cache(args.cachedir, threshold_pct=args.threshold,
                          min_age=args.min_age)
    if args.verbose:
        print(f"removed {removed} cache files from {args.cachedir}")
    return 0
