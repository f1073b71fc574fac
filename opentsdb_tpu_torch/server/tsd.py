"""The TSD network server: one asyncio TCP listener, two protocols.

Mirrors a subset of ``opentsdb_tpu/server/tsd.py`` of the JAX package:
the first-byte protocol sniff (a capital ASCII letter means HTTP,
reference PipelineFactory :68-98); the telnet ``put``, ``version`` and
``exit`` commands, with pipelined bursts of ``put`` lines decoded in
columnar batches; and HTTP ``/q`` (``ascii`` and ``json`` output),
``/aggregators`` and ``/version``. Queries run in a thread pool off the
event loop, so ingest keeps flowing while they compute; each pool thread
launches its kernels on its own current CUDA stream.

Not ported yet, and answered with 400 "not yet ported": PNG graphs
(``/q`` without ``ascii``/``json``), ``/distinct``, ``/sketch`` and
``/forecast``. Other paths are 404.
"""

from __future__ import annotations

import asyncio
import concurrent.futures
import functools
import json
import logging
import time
import urllib.parse

import torch

from opentsdb_tpu_torch import __version__
from opentsdb_tpu_torch.core import tags as tags_mod
from opentsdb_tpu_torch.core.errors import BadRequestError, NoSuchUniqueName
from opentsdb_tpu_torch.query.aggregators import Aggregators
from opentsdb_tpu_torch.query.executor import (QueryExecutor, QuerySpec,
                                               not_yet_ported)
from opentsdb_tpu_torch.query.grammar import parse_m
from opentsdb_tpu_torch.server import wire
from opentsdb_tpu_torch.utils import timeparse

LOG = logging.getLogger(__name__)

MAX_LINE = 1024       # per-line telnet framing limit (reference
                      # LineBasedFrameDecoder's 1024 B discard protection)
MAX_BUFFER = 1 << 22  # pipelined-burst buffer bound for the bulk path
MAX_HEADER_BYTES = 65536
MAX_BODY_BYTES = 1 << 20

_REASONS = {200: "OK", 400: "Bad Request", 404: "Not Found",
            413: "Payload Too Large",
            431: "Request Header Fields Too Large",
            500: "Internal Server Error"}


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
        self._server: asyncio.AbstractServer | None = None
        self._shutdown = asyncio.Event()
        self._pool = concurrent.futures.ThreadPoolExecutor(
            max_workers=max(2, self.config.worker_threads))
        self.telnet_commands = {
            "put": self._telnet_put,
            "version": lambda words, writer: writer.write(
                self._version_text().encode()),
            "exit": lambda words, writer: False,
        }
        self.http_routes = {
            "/aggregators": self._http_aggregators,
            "/version": self._http_version,
            "/q": self._query,
            "/distinct": self._not_ported,
            "/sketch": self._not_ported,
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
                await self._bulk_puts(chunk, writer, line_no)
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
            elif handler(words, writer) is False:
                await writer.drain()
                return
            await writer.drain()

    async def _bulk_puts(self, chunk: bytes, writer, line_base: int) -> None:
        loop = asyncio.get_running_loop()
        batch = await loop.run_in_executor(
            self._pool, functools.partial(wire.decode_puts, chunk,
                                          line_base=line_base))
        _, series_errors = await loop.run_in_executor(
            self._pool, wire.ingest_batch, self.tsdb, batch)
        for line, err in zip(batch.error_lines, batch.errors):
            writer.write(
                f"put: illegal argument at line {line + 1}: {err}\n"
                .encode())
        for err in series_errors:
            kind = "unknown metric" if "No such name" in err \
                else "illegal argument"
            writer.write(f"put: {kind}: {err}\n".encode())
        await writer.drain()

    def _telnet_put(self, words: list[str], writer) -> None:
        """Parity: reference PutDataPointRpc.importDataPoint (:93-123)."""
        try:
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
                                fval if is_float else ival, tag_map)
        except NoSuchUniqueName as e:
            writer.write(f"put: unknown metric: {e}\n".encode())
        except (ValueError, ArithmeticError) as e:
            writer.write(f"put: illegal argument: {e}\n".encode())

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
            data = data[clen:]  # no route of this subset reads a body
            keep = (version.strip().upper() == "HTTP/1.1"
                    and headers.get("connection", "").lower() != "close")
            try:
                status, ctype, body = await self._route(target)
            except (BadRequestError, NoSuchUniqueName) as e:
                status = getattr(e, "status", 400)
                ctype, body = "text/plain", f"{e}\n".encode()
            except Exception as e:
                LOG.exception("HTTP error on %s", target)
                status, ctype = 500, "text/plain"
                body = f"Internal Server Error: {e}\n".encode()
            await self._respond(writer, status, ctype, body, keep)
            if not keep:
                return

    async def _respond(self, writer, status: int, ctype: str, body: bytes,
                       keep: bool) -> None:
        hdrs = [f"HTTP/1.1 {status} {_REASONS.get(status, 'OK')}",
                f"Content-Type: {ctype}",
                f"Content-Length: {len(body)}",
                f"Connection: {'keep-alive' if keep else 'close'}"]
        writer.write(("\r\n".join(hdrs) + "\r\n\r\n").encode() + body)
        await writer.drain()

    async def _route(self, target: str):
        parsed = urllib.parse.urlsplit(target)
        handler = self.http_routes.get(parsed.path.rstrip("/") or "/")
        if handler is None:
            return 404, "text/plain", b"Page Not Found\n"
        params = urllib.parse.parse_qs(parsed.query, keep_blank_values=True)
        q = {k: v[-1] for k, v in params.items()}
        out = handler(q, params, parsed.path)
        if asyncio.iscoroutine(out):
            out = await out
        return out

    def _http_aggregators(self, q, params, path) -> tuple:
        return (200, "application/json",
                json.dumps(Aggregators.available()).encode())

    def _http_version(self, q, params, path) -> tuple:
        if "json" in q:
            return (200, "application/json", json.dumps({
                "version": __version__, "torch": torch.__version__,
                "device": str(self.executor.device)}).encode())
        return 200, "text/plain", self._version_text().encode()

    def _not_ported(self, q, params, path) -> tuple:
        raise not_yet_ported(path)

    def _version_text(self) -> str:
        return (f"opentsdb_tpu_torch {__version__} (torch "
                f"{torch.__version__}, device {self.executor.device})\n")

    async def _query(self, q, params, path) -> tuple:
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
        for m in ms:
            parsed = parse_m(m)
            spec = QuerySpec(
                metric=parsed.metric, tags=parsed.tags,
                aggregator=parsed.aggregator, rate=parsed.rate,
                downsample=parsed.downsample, counter=parsed.counter,
                counter_max=parsed.counter_max,
                reset_value=parsed.reset_value)
            rs, plan, _ = await loop.run_in_executor(
                self._pool, self.executor.run_with_plan, spec, start, end)
            results.extend(rs)
            plans.extend([plan] * len(rs))
        if "ascii" in q:
            return 200, "text/plain", self._ascii_output(results).encode()
        return (200, "application/json",
                json.dumps(self._json_output(results, plans)).encode())

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
    def _json_output(results, plans) -> list:
        return [{
            "metric": r.metric,
            "tags": r.tags,
            "aggregateTags": r.aggregated_tags,
            "rollup": plans[i],
            "cached": False,
            "dps": {str(int(t)): float(v)
                    for t, v in zip(r.timestamps, r.values)},
        } for i, r in enumerate(results)]
