"""The TSD network server: one asyncio TCP listener, two protocols.

Mirrors a subset of ``opentsdb_tpu/server/tsd.py`` of the JAX package:
the first-byte protocol sniff (a capital ASCII letter means HTTP,
reference PipelineFactory :68-98); the telnet ``put``, ``tenant``,
``version`` and ``exit`` commands, with pipelined bursts of ``put`` lines
decoded in columnar batches; and HTTP ``/api/put`` (a POST body of put
lines or JSON datapoints, ``?tenant=``), ``/q`` (``ascii`` and ``json``
output), ``/sketch`` (quantiles of the live t-digests), ``/distinct``
(distinct tag values from the live HyperLogLogs, or counted over a
range), ``/api/tenants`` and its page ``/tenants`` (per-tenant series
cardinality, limits, refusals, heavy hitters), ``/aggregators`` and
``/version``. Every put, telnet or HTTP, is charged to a tenant (the
connection's, set by ``tenant <id>``, or ``?tenant=``; "default" unless
named) and passes the admission controller's ingest half first
(``serve/admission.py``). Queries run in a thread pool off the event
loop, so ingest keeps flowing while they compute; each pool thread
launches its kernels on its own current CUDA stream.

Not ported yet, and answered with 400 "not yet ported": PNG graphs
(``/q`` without ``ascii``/``json``) and ``/forecast``. Other paths are
404.
"""

from __future__ import annotations

import asyncio
import concurrent.futures
import functools
import json
import logging
import math
import time
import urllib.parse
from typing import NamedTuple

import torch

from opentsdb_tpu_torch import __version__
from opentsdb_tpu_torch.core import tags as tags_mod
from opentsdb_tpu_torch.core.errors import (BadRequestError,
                                             NoSuchUniqueName,
                                             OverloadedError,
                                             PleaseThrottleError,
                                             TenantLimitError)
from opentsdb_tpu_torch.query.aggregators import Aggregators
from opentsdb_tpu_torch.query.executor import (QueryExecutor, QuerySpec,
                                               not_yet_ported)
from opentsdb_tpu_torch.query.grammar import parse_m
from opentsdb_tpu_torch.serve.admission import AdmissionController
from opentsdb_tpu_torch.server import wire
from opentsdb_tpu_torch.sketch.bounds import hll_error
from opentsdb_tpu_torch.utils import timeparse

LOG = logging.getLogger(__name__)

MAX_LINE = 1024       # per-line telnet framing limit (reference
                      # LineBasedFrameDecoder's 1024 B discard protection)
MAX_BUFFER = 1 << 22  # pipelined-burst buffer bound for the bulk path
MAX_HEADER_BYTES = 65536
MAX_BODY_BYTES = 1 << 20

_REASONS = {200: "OK", 400: "Bad Request", 404: "Not Found",
            405: "Method Not Allowed", 413: "Payload Too Large",
            429: "Too Many Requests",
            431: "Request Header Fields Too Large",
            500: "Internal Server Error", 503: "Service Unavailable"}


class HttpRequest(NamedTuple):
    """What an HTTP route handler sees."""
    method: str
    path: str
    q: dict                    # last-value-wins query params
    params: dict               # full multi-value query params
    body: bytes = b""          # bounded at MAX_BODY_BYTES; b"" for GETs


def _retry_after(seconds: float) -> dict:
    """Retry-After is integral delta-seconds on the wire; never 0 (a 0
    invites an instant retry storm from well-behaved clients)."""
    return {"Retry-After": str(max(1, math.ceil(seconds)))}


def _parse_max_error(q) -> float | None:
    """The ``max_error=`` budget of /sketch: a positive relative
    half-width, or None when absent."""
    if "max_error" not in q:
        return None
    try:
        max_error = float(q["max_error"])
    except ValueError:
        raise BadRequestError(
            f"invalid max_error: {q['max_error']}") from None
    if max_error <= 0:
        raise BadRequestError("max_error must be > 0")
    return max_error


def _put_prefix_len(buf: bytes) -> int:
    """Byte length of the longest prefix of complete ``put `` lines."""
    pos = 0
    while True:
        nl = buf.find(b"\n", pos)
        if nl < 0 or not buf.startswith(b"put ", pos):
            return pos
        pos = nl + 1


class TSDServer:
    def __init__(self, tsdb) -> None:
        self.tsdb = tsdb
        self.executor = QueryExecutor(tsdb)
        self.config = tsdb.config
        self.admission = AdmissionController(self.config)
        self._server: asyncio.AbstractServer | None = None
        self._shutdown = asyncio.Event()
        self._pool = concurrent.futures.ThreadPoolExecutor(
            max_workers=max(2, self.config.worker_threads))
        # Handlers take (words, writer, conn): ``conn`` is the
        # connection's state (its tenant).
        self.telnet_commands = {
            "put": self._telnet_put,
            "tenant": self._telnet_tenant,
            "version": lambda words, writer, conn: writer.write(
                self._version_text().encode()),
            "exit": lambda words, writer, conn: False,
        }
        self.http_routes = {
            "/aggregators": self._http_aggregators,
            "/version": self._http_version,
            "/api/put": self._http_put,
            "/api/tenants": self._http_tenants,
            "/tenants": self._http_tenants_page,
            "/q": self._query,
            "/distinct": self._distinct,
            "/sketch": self._sketch,
            "/forecast": self._not_ported,
        }

    # ------------------------------------------------------------------
    # Lifecycle
    # ------------------------------------------------------------------

    async def start(self) -> None:
        self._server = await asyncio.start_server(
            self._handle_conn, self.config.bind, self.config.port)
        LOG.info("Ready to serve on %s:%d", self.config.bind, self.port)

    async def serve_forever(self) -> None:
        if self._server is None:
            await self.start()
        await self._shutdown.wait()
        await self.stop()

    async def stop(self) -> None:
        if self._server is not None:
            self._server.close()
            await self._server.wait_closed()
            self._server = None
        self._pool.shutdown(wait=True)
        self.tsdb.shutdown()

    def request_shutdown(self) -> None:
        self._shutdown.set()

    @property
    def port(self) -> int:
        return self._server.sockets[0].getsockname()[1]

    async def _handle_conn(self, reader: asyncio.StreamReader,
                           writer: asyncio.StreamWriter) -> None:
        try:
            first = await reader.read(1)
            if not first:
                return
            if b"A" <= first <= b"Z":
                await self._handle_http(first, reader, writer)
            else:
                await self._handle_telnet(first, reader, writer)
        except (ConnectionResetError, asyncio.IncompleteReadError):
            pass
        except Exception:
            LOG.exception("Unexpected exception from client")
        finally:
            writer.close()
            try:
                await writer.wait_closed()
            except (ConnectionResetError, BrokenPipeError):
                pass

    # ------------------------------------------------------------------
    # Telnet protocol
    # ------------------------------------------------------------------

    async def _handle_telnet(self, first: bytes, reader, writer) -> None:
        buf = first
        line_no = 0
        conn = {"tenant": "default"}
        while not self._shutdown.is_set():
            nl = buf.find(b"\n")
            if nl < 0:
                if len(buf) > MAX_BUFFER:
                    raise ValueError("frame length exceeds buffer limit")
                chunk = await reader.read(
                    max(MAX_BUFFER + 1 - len(buf), 1))
                if not chunk:
                    break
                buf += chunk
                continue
            # Bulk path: a pipelined burst of complete put lines decodes
            # into columnar arrays and lands through add_batch, in order
            # with the single-line commands around it.
            if buf.startswith(b"put ") and buf.find(b"\n", nl + 1) >= 0:
                prefix_len = _put_prefix_len(buf)
                chunk, buf = buf[:prefix_len], buf[prefix_len:]
                await self._bulk_puts(chunk, writer, line_no,
                                      conn["tenant"])
                line_no += chunk.count(b"\n")
                continue
            line, buf = buf[:nl], buf[nl + 1:]
            line_no += 1
            if len(line) > MAX_LINE:
                raise ValueError(f"frame length exceeds {MAX_LINE}")
            words = tags_mod.split_string(
                line.decode("utf-8", "replace").rstrip("\r"))
            if not words:
                continue
            handler = self.telnet_commands.get(words[0])
            if handler is None:
                writer.write(f"unknown command: {words[0]}\n".encode())
            elif handler(words, writer, conn) is False:
                await writer.drain()
                return
            await writer.drain()

    async def _bulk_puts(self, chunk: bytes, writer, line_base: int,
                         tenant: str) -> None:
        loop = asyncio.get_running_loop()
        batch = await loop.run_in_executor(
            self._pool, functools.partial(wire.decode_puts, chunk,
                                          line_base=line_base))
        # Ingest admission: shed the whole batch with a throttle line and
        # a retry hint before it allocates store work.
        npts = len(batch.sid)
        wait = self.admission.admit_ingest(npts, tenant) if npts else 0.0
        if wait > 0:
            writer.write(
                f"put: Please throttle writes: over ingest quota, "
                f"retry after {max(wait, 0.1):.1f}s\n".encode())
            await writer.drain()
            return
        try:
            _, series_errors = await loop.run_in_executor(
                self._pool, functools.partial(
                    wire.ingest_batch, self.tsdb, batch, tenant=tenant))
        finally:
            if npts:
                self.admission.ingest_done(npts)
        for line, err in zip(batch.error_lines, batch.errors):
            writer.write(
                f"put: illegal argument at line {line + 1}: {err}\n"
                .encode())
        for err in series_errors:
            if "No such name" in err:
                kind = "unknown metric"
            elif "throttle" in err.lower():
                kind = "Please throttle writes"
            elif "[tenant-limit]" in err:
                # Declared cardinality refusal, tagged by ingest_batch:
                # NOT a throttle (the series can never ingest until the
                # limit moves); the batch's existing series applied.
                kind = "tenant series limit exceeded"
            else:
                kind = "illegal argument"
            writer.write(f"put: {kind}: {err}\n".encode())
        await writer.drain()

    def _telnet_tenant(self, words: list[str], writer, conn: dict) -> None:
        """``tenant <id>`` charges every later put of the connection to
        <id>'s quota and cardinality budget."""
        if len(words) != 2 or not words[1]:
            writer.write(b"tenant: need exactly one id\n")
        else:
            conn["tenant"] = words[1]
            writer.write(f"tenant {words[1]}\n".encode())

    def _telnet_put(self, words: list[str], writer, conn: dict) -> None:
        """Parity: reference PutDataPointRpc.importDataPoint (:93-123)."""
        tenant = conn["tenant"]
        try:
            wait = self.admission.admit_ingest(1, tenant)
            if wait > 0:
                # Shed: admit_ingest took no slot, so nothing to release.
                raise PleaseThrottleError(
                    f"over ingest quota, retry after "
                    f"{max(wait, 0.1):.1f}s")
            self.admission.ingest_done(1)
            if len(words) < 5:
                raise ValueError("not enough arguments"
                                 f" (need least 5, got {len(words)})")
            metric = words[1]
            timestamp = tags_mod.parse_long(words[2])
            if timestamp <= 0:
                raise ValueError("invalid timestamp: " + str(timestamp))
            is_float, ival, fval = tags_mod.parse_value(words[3])
            tag_map: dict[str, str] = {}
            for tag in words[4:]:
                tags_mod.parse(tag_map, tag)
            self.tsdb.add_point(metric, timestamp,
                                fval if is_float else ival, tag_map,
                                tenant=tenant)
        except TenantLimitError as e:
            # A distinct line from the throttle: the put can never
            # succeed until the limit is raised.
            writer.write(
                f"put: tenant series limit exceeded: {e}\n".encode())
        except NoSuchUniqueName as e:
            writer.write(f"put: unknown metric: {e}\n".encode())
        except (ValueError, ArithmeticError) as e:
            writer.write(f"put: illegal argument: {e}\n".encode())
        except PleaseThrottleError as e:
            writer.write(f"put: Please throttle writes: {e}\n".encode())

    # ------------------------------------------------------------------
    # HTTP protocol
    # ------------------------------------------------------------------

    async def _handle_http(self, first: bytes, reader, writer) -> None:
        """Persistent-connection HTTP loop (reference HttpQuery.java
        :471-530), headers and bodies bounded."""
        data = first
        while not self._shutdown.is_set():
            while b"\r\n\r\n" not in data:
                chunk = await reader.read(4096)
                if not chunk:
                    return
                data += chunk
                if len(data) > MAX_HEADER_BYTES:
                    await self._respond(writer, 431, "text/plain",
                                        b"Request Header Fields Too Large\n",
                                        False)
                    return
            head, _, data = data.partition(b"\r\n\r\n")
            lines = head.decode("latin-1").split("\r\n")
            try:
                method, target, version = lines[0].split(" ", 2)
            except ValueError:
                return
            headers = {}
            for ln in lines[1:]:
                k, _, v = ln.partition(":")
                headers[k.strip().lower()] = v.strip()
            try:
                clen = int(headers.get("content-length", "0") or "0")
            except ValueError:
                return
            if clen > MAX_BODY_BYTES:
                await self._respond(writer, 413, "text/plain",
                                    b"Payload Too Large\n", False)
                return
            while len(data) < clen:
                chunk = await reader.read(1 << 16)
                if not chunk:
                    return
                data += chunk
            req_body, data = data[:clen], data[clen:]
            keep = (version.strip().upper() == "HTTP/1.1"
                    and headers.get("connection", "").lower() != "close")
            extra: dict = {}
            try:
                status, ctype, body, extra = await self._route(
                    method, target, req_body)
            except (BadRequestError, NoSuchUniqueName) as e:
                status = getattr(e, "status", 400)
                ctype, body = "text/plain", f"{e}\n".encode()
            except OverloadedError as e:
                # Admission shed: an explicit retry signal, not a failure.
                status, extra = e.status, _retry_after(e.retry_after)
                ctype, body = "text/plain", f"{e}\n".encode()
            except Exception as e:
                LOG.exception("HTTP error on %s", target)
                status, ctype = 500, "text/plain"
                body = f"Internal Server Error: {e}\n".encode()
            await self._respond(writer, status, ctype, body, keep, extra)
            if not keep:
                return

    async def _respond(self, writer, status: int, ctype: str, body: bytes,
                       keep: bool, extra: dict | None = None) -> None:
        hdrs = [f"HTTP/1.1 {status} {_REASONS.get(status, 'OK')}",
                f"Content-Type: {ctype}",
                f"Content-Length: {len(body)}",
                f"Connection: {'keep-alive' if keep else 'close'}"]
        hdrs.extend(f"{k}: {v}" for k, v in (extra or {}).items())
        writer.write(("\r\n".join(hdrs) + "\r\n\r\n").encode() + body)
        await writer.drain()

    async def _route(self, method: str, target: str,
                     body: bytes = b"") -> tuple:
        """(status, content type, body, extra headers): every handler
        takes an HttpRequest and returns that shape."""
        parsed = urllib.parse.urlsplit(target)
        handler = self.http_routes.get(parsed.path.rstrip("/") or "/")
        if handler is None:
            return 404, "text/plain", b"Page Not Found\n", {}
        params = urllib.parse.parse_qs(parsed.query, keep_blank_values=True)
        q = {k: v[-1] for k, v in params.items()}
        out = handler(HttpRequest(method, parsed.path, q, params, body))
        if asyncio.iscoroutine(out):
            out = await out
        return out

    def _http_aggregators(self, req) -> tuple:
        return (200, "application/json",
                json.dumps(Aggregators.available()).encode(), {})

    def _http_version(self, req) -> tuple:
        if "json" in req.q:
            return (200, "application/json", json.dumps({
                "version": __version__, "torch": torch.__version__,
                "device": str(self.executor.device)}).encode(), {})
        return 200, "text/plain", self._version_text().encode(), {}

    def _not_ported(self, req) -> tuple:
        raise not_yet_ported(req.path)

    # ------------------------------------------------------------------
    # Tenants and HTTP ingest
    # ------------------------------------------------------------------

    def _http_tenants(self, req) -> tuple:
        """JSON feed behind the /tenants page: per-tenant series
        cardinality (exact or HLL tier, error declared), the limit
        governing each tenant, refusal counters, the heavy-hitter
        summaries, and the admission controller's bucket table. A daemon
        without accounting answers ``enabled: false``."""
        acct = self.tsdb.tenants
        if acct is None:
            body = {"enabled": False, "role": "writer"}
            return (200, "application/json",
                    json.dumps(body).encode(), {})
        body = acct.snapshot_info(self.tsdb.tenant_limits)
        body["enabled"] = True
        admission = self.admission
        body["admission"] = {
            "tenants": max(len(admission._ingest_buckets),
                           len(admission._query_buckets)),
            "evicted": admission.tenants_evicted,
            "collapsed": admission.tenants_collapsed,
        }
        return (200, "application/json", json.dumps(body).encode(), {})

    def _http_tenants_page(self, req) -> tuple:
        return (200, "text/html; charset=UTF-8",
                _TENANTS_HTML.encode(), {"Cache-Control": "no-cache"})

    async def _http_put(self, req) -> tuple:
        """HTTP ingest: a POST body of telnet-format ``put`` lines (the
        leading "put " optional per line) or a JSON datapoint
        object/array (the reference ``/api/put`` shape), charged to
        ``?tenant=``. Both bodies decode into the same columnar batch.
        When every series was refused by the cardinality limiter the
        answer is 429 naming the limit; partial refusals report
        per-series errors in a 200 body."""
        if req.method != "POST":
            raise BadRequestError("POST a body of put lines", 405)
        if not req.body.strip():
            raise BadRequestError("empty body")
        tenant = req.q.get("tenant", "default")
        raw = req.body
        loop = asyncio.get_running_loop()
        # JSON bodies are unambiguous: no put line can start with '{' or
        # '[' (the metric charset forbids both).
        if raw.lstrip()[:1] in (b"{", b"["):
            try:
                obj = json.loads(raw)
            except ValueError as e:
                raise BadRequestError(f"invalid json: {e}")
            try:
                batch = await loop.run_in_executor(
                    self._pool, wire.decode_json_puts, obj)
            except ValueError as e:
                raise BadRequestError(str(e))
        else:
            if not raw.endswith(b"\n"):
                raw += b"\n"
            raw = b"\n".join(
                b"put " + ln if ln and not ln.startswith(b"put ") else ln
                for ln in raw.split(b"\n"))
            batch = await loop.run_in_executor(
                self._pool, wire.decode_puts, raw)
        npts = len(batch.sid)
        wait = self.admission.admit_ingest(npts, tenant) if npts else 0.0
        if wait > 0:
            raise OverloadedError(
                f"over ingest quota for tenant {tenant!r}", wait,
                status=429)
        try:
            n, series_errors = await loop.run_in_executor(
                self._pool, functools.partial(
                    wire.ingest_batch, self.tsdb, batch, tenant=tenant))
        finally:
            if npts:
                self.admission.ingest_done(npts)
        errors = list(batch.errors) + series_errors
        refused = [e for e in series_errors if "[tenant-limit]" in e]
        body = {"points": n, "errors": errors, "tenant": tenant,
                "refused_series": len(refused)}
        if refused and n == 0:
            # Everything sent was a refused NEW series: the declared 429,
            # naming the limit, and no Retry-After (a retry cannot
            # succeed until the limit moves).
            limits = self.tsdb.tenant_limits
            body["error"] = refused[0]
            body["limit"] = (limits.limit_for(tenant)
                             if limits is not None else None)
            return (429, "application/json",
                    json.dumps(body).encode(), {})
        return 200, "application/json", json.dumps(body).encode(), {}

    def _version_text(self) -> str:
        return (f"opentsdb_tpu_torch {__version__} (torch "
                f"{torch.__version__}, device {self.executor.device})\n")

    async def _query(self, req) -> tuple:
        q, params = req.q, req.params
        if "start" not in q:
            raise BadRequestError("Missing parameter: start")
        if "ascii" not in q and "json" not in q:
            raise not_yet_ported("PNG graphs (ask for &ascii or &json)")
        tz = q.get("tz")
        now = int(time.time())
        start = timeparse.parse_date(q["start"], tz=tz, now=now)
        end = (timeparse.parse_date(q["end"], tz=tz, now=now)
               if q.get("end") else now)
        ms = params.get("m", [])
        if not ms:
            raise BadRequestError("Missing parameter: m")
        loop = asyncio.get_running_loop()
        results = []
        plans = []
        cached = []
        for m in ms:
            parsed = parse_m(m)
            spec = QuerySpec(
                metric=parsed.metric, tags=parsed.tags,
                aggregator=parsed.aggregator, rate=parsed.rate,
                downsample=parsed.downsample, counter=parsed.counter,
                counter_max=parsed.counter_max,
                reset_value=parsed.reset_value)
            rs, plan, hit = await loop.run_in_executor(
                self._pool, self.executor.run_with_plan, spec, start, end)
            results.extend(rs)
            plans.extend([plan] * len(rs))
            cached.extend([hit] * len(rs))
        if "ascii" in q:
            return (200, "text/plain", self._ascii_output(results).encode(),
                    {})
        return (200, "application/json",
                json.dumps(self._json_output(results, plans,
                                             cached)).encode(), {})

    async def _distinct(self, req) -> tuple:
        """Distinct values of one tag key. Without ``start`` (or with
        ``stream``): the streaming per-(metric, tagk) HLL estimate, all
        time, with its error bound. With a range: an exact count over the
        series with data in it, or, with a tag filter, ``distinct_tagv``.
        Bodies, errors and the X-Tsd-Approx header are the JAX daemon's."""
        q = req.q
        for name in ("metric", "tagk"):
            if name not in q:
                raise BadRequestError(f"Missing parameter: {name}")
        loop = asyncio.get_running_loop()
        if "stream" in q or "start" not in q:
            if "end" in q and "stream" not in q:
                raise BadRequestError(
                    "distinct range needs start= (end= alone would "
                    "silently answer all-time)")
            n = await loop.run_in_executor(
                self._pool, self.executor.sketch_distinct, q["metric"],
                q["tagk"])
            if n is None:
                raise BadRequestError(
                    f"no streaming sketch state for metric {q['metric']}"
                    f" / tagk {q['tagk']} (pass start= for a scan)")
            err = hll_error(self.config.sketch_hll_p, n)
            body = json.dumps({
                "metric": q["metric"], "tagk": q["tagk"], "distinct": n,
                "source": "stream",
                "approx": {"kind": "hll", "error": err}}).encode()
            return (200, "application/json", body,
                    {"X-Tsd-Approx": f"hll;error={err:.6g}"})
        now = int(time.time())
        start = timeparse.parse_date(q["start"], now=now)
        end = timeparse.parse_date(q["end"], now=now) if "end" in q else now
        tag_map: dict[str, str] = {}
        if "tags" in q and q["tags"]:
            for t in q["tags"].split(","):
                tags_mod.parse(tag_map, t)
        if not tag_map:
            n, source = await loop.run_in_executor(
                self._pool, self.executor.sketch_distinct_with_source,
                q["metric"], q["tagk"], start, end)
        else:
            n = await loop.run_in_executor(
                self._pool, self.executor.distinct_tagv, q["metric"],
                tag_map, q["tagk"], start, end)
            source = "scan"
        body = json.dumps({"metric": q["metric"], "tagk": q["tagk"],
                           "distinct": n, "source": source}).encode()
        return 200, "application/json", body, {}

    async def _sketch(self, req) -> tuple:
        """All-time percentiles of the matching series' merged t-digests
        (``m=metric{tag=v,...}``, ``q=p50,p99`` or ``0.5,0.99``), or,
        with ``start``, the exact quantiles over the range."""
        q = req.q
        if "m" not in q:
            raise BadRequestError("Missing parameter: m")
        tag_map: dict[str, str] = {}
        try:
            metric = tags_mod.parse_with_metric(q["m"], tag_map)
        except ValueError as e:
            raise BadRequestError(str(e)) from None
        qs = []
        for part in q.get("q", "p50,p95,p99").split(","):
            part = part.strip()
            try:
                if part.startswith("p") and part[1:].isdigit():
                    d = part[1:]
                    # p5 -> 0.05, p99 -> 0.99; three or more digits follow
                    # the decimal point: p999 -> 0.999.
                    qs.append(int(d) / 100 if len(d) <= 2
                              else int(d) / 10 ** len(d))
                else:
                    qs.append(float(part))
            except ValueError:
                raise BadRequestError(f"bad quantile: {part}") from None
            if not 0.0 <= qs[-1] <= 1.0:
                raise BadRequestError(f"quantile out of range: {part}")
        start = end = None
        if "start" in q:
            now = int(time.time())
            start = timeparse.parse_date(q["start"], now=now)
            end = (timeparse.parse_date(q["end"], now=now)
                   if "end" in q else now)
        elif "end" in q:
            raise BadRequestError(
                "sketch range needs start= (end= alone would silently "
                "answer all-time)")
        max_error = _parse_max_error(q)
        loop = asyncio.get_running_loop()
        out = await loop.run_in_executor(
            self._pool, self.executor.sketch_quantiles, metric, tag_map,
            qs, start, end, max_error)
        # No answer here is approximate beyond the digests' own error:
        # the JAX daemon's X-Tsd-Approx header on /sketch comes only with
        # a rollup tier's answers.
        return 200, "application/json", json.dumps(out).encode(), {}

    @staticmethod
    def _fmt_value(v: float) -> str:
        return str(int(v)) if float(v).is_integer() else repr(float(v))

    def _ascii_output(self, results) -> str:
        """One "metric timestamp value tags" line per point (reference
        GraphHandler.respondAsciiQuery :770-818) — re-importable."""
        out = []
        for r in results:
            tag_str = " ".join(
                f"{k}={v}" for k, v in sorted(r.tags.items()))
            for ts, v in zip(r.timestamps, r.values):
                line = f"{r.metric} {int(ts)} {self._fmt_value(v)}"
                out.append(line + (" " + tag_str if tag_str else ""))
        return "\n".join(out) + ("\n" if out else "")

    @staticmethod
    def _json_output(results, plans, cached) -> list:
        return [{
            "metric": r.metric,
            "tags": r.tags,
            "aggregateTags": r.aggregated_tags,
            "rollup": plans[i],
            # Fragment-cache provenance: True iff this sub-query's whole
            # range served from warm decoded fragments.
            "cached": bool(cached[i]),
            "dps": {str(int(t)): float(v)
                    for t, v in zip(r.timestamps, r.values)},
        } for i, r in enumerate(results)]


# The /tenants page: one self-contained page over the /api/tenants JSON
# feed, served from memory, auto-refreshing (the JAX daemon's).
_TENANTS_HTML = """<!doctype html>
<html><head><meta charset="utf-8"><title>tsd tenants</title>
<style>
 body{font:13px/1.45 system-ui,sans-serif;margin:1.2em;background:#fafafa;
      color:#222}
 h1{font-size:1.2em;margin:0 0 .2em}
 h2{font-size:1em;margin:1.2em 0 .3em}
 table{border-collapse:collapse;background:#fff;min-width:36em}
 th,td{border:1px solid #ddd;padding:.25em .6em;text-align:left;
       font-variant-numeric:tabular-nums}
 th{background:#f0f0f0;font-weight:600}
 .ok{color:#0a7d32}.bad{color:#c0392b}.warn{color:#b8860b}
 #meta{color:#666;font-size:.9em;margin-bottom:.8em}
 .pill{display:inline-block;padding:0 .5em;border-radius:.8em;
       background:#eee;margin-right:.4em}
 small{color:#888}
</style></head><body>
<h1>Tenant cardinality</h1>
<div id="meta">loading /api/tenants&hellip;</div>
<div id="tenants"></div><div id="hh"></div><div id="adm"></div>
<script>
function esc(v){return String(v).replace(/&/g,"&amp;")
  .replace(/</g,"&lt;").replace(/>/g,"&gt;");}
function fmt(v){return v===null||v===undefined?"&mdash;":esc(v);}
function table(title, heads, rows){
  var h="<h2>"+title+"</h2><table><tr>"+heads.map(
    function(x){return "<th>"+x+"</th>";}).join("")+"</tr>";
  h+=rows.map(function(r){return "<tr>"+r.map(
    function(c){return "<td>"+c+"</td>";}).join("")+"</tr>";}).join("");
  return h+"</table>";
}
function pills(title, obj){
  return "<h2>"+title+"</h2>"+Object.keys(obj).sort().map(function(k){
    return "<span class='pill'>"+esc(k)+": "+esc(obj[k])+"</span>";
  }).join("")||"&mdash;";
}
function render(t){
  if(!t.enabled){
    document.getElementById("meta").innerHTML=
      "tenant accounting is off on this daemon (role "+
      fmt(t.role)+")";
    return;
  }
  document.getElementById("meta").innerHTML=
    "tracked series "+t.tracked_series+" &middot; mode "+fmt(t.mode)+
    " &middot; global limit "+(t.global_limit||"&infin;")+
    " &middot; snapshots "+t.snapshots_written+
    " &middot; refreshed "+new Date().toLocaleTimeString();
  var names=Object.keys(t.tenants||{});
  var rows=names.map(function(n){
    var e=t.tenants[n];
    var over=e.limit&&e.series>=e.limit;
    var ser=e.series+(e.tier==="hll"
      ?" <small>&plusmn;"+Math.round(e.error*100)+"% (hll)</small>":"");
    return [esc(n), over?"<span class='bad'>"+ser+"</span>":ser,
      e.limit?esc(e.limit):"&infin;", e.points,
      e.refused?"<span class='bad'>"+e.refused+"</span>":0,
      e.would_refuse||0];});
  document.getElementById("tenants").innerHTML=
    table("Tenants",["tenant","series","limit","points","refused",
                     "would refuse"],rows);
  var hh="";
  names.forEach(function(n){
    var e=t.tenants[n];
    if((e.top_series||[]).length)
      hh+=table("Heavy hitters &mdash; "+esc(n),
        ["series","points","err","","prefix","new series","err"],
        e.top_series.map(function(s,i){
          var p=(e.top_prefixes||[])[i]||{};
          return [esc(s.series),s.points,s.err,"",
            fmt(p.prefix),fmt(p.new_series),fmt(p.err)];}));
  });
  document.getElementById("hh").innerHTML=hh;
  document.getElementById("adm").innerHTML=
    pills("Admission buckets", t.admission||{});
}
function tick(){
  fetch("/api/tenants").then(function(r){return r.json();})
    .then(render)
    .catch(function(e){document.getElementById("meta").innerHTML=
      "<span class='bad'>fetch failed: "+esc(e)+"</span>";});
}
tick(); setInterval(tick, 2000);
</script></body></html>
"""
