"""The TSD network server: one asyncio TCP listener, two protocols.

Mirrors a subset of ``opentsdb_tpu/server/tsd.py`` of the JAX package:
the first-byte protocol sniff (a capital ASCII letter means HTTP,
reference PipelineFactory :68-98); the telnet commands of the reference's
RpcHandler (``put``, ``stats``, ``help``, ``version``, ``exit``,
``dropcaches``, ``diediedie``) and ``tenant``, with pipelined bursts of
``put`` lines decoded in columnar batches; and HTTP ``/api/put`` (a POST
body of put lines or JSON datapoints, ``?tenant=``), ``/q`` (``ascii``
and ``json`` output), ``/sketch`` (quantiles of the live t-digests),
``/distinct`` (distinct tag values from the live HyperLogLogs, or counted
over a range), ``/api/tenants`` and its page ``/tenants`` (per-tenant
series cardinality, limits, refusals, heavy hitters), ``/aggregators``,
``/version``, ``/suggest``, ``/dropcaches``, ``/diediedie`` and
``/favicon.ico``. Every put, telnet or HTTP, is charged to a tenant (the
connection's, set by ``tenant <id>``, or ``?tenant=``; "default" unless
named) and passes the admission controller's ingest half first
(``serve/admission.py``). Queries run in a thread pool off the event
loop, so ingest keeps flowing while they compute; each pool thread
launches its kernels on its own current CUDA stream.

Observability (``obs/``, the JAX daemon's surface): ``/stats`` (text, or
``?json``) and the telnet ``stats`` command give the reference's counters
and latency digests, the engine's stats and the metrics registry as
``tsd.*`` lines; ``/metrics`` the same as Prometheus text; ``/logs`` the
last 1024 log records (``?level=`` sets the root level); ``/q?trace=1``
answers each JSON result with its span tree, and traced queries (asked
for, slower than ``Config.slow_query_ms``, or 1 in
``Config.trace_sample_n``) land in the ring at ``/api/traces``
(``?slow=1``); ``/api/queries`` and its page ``/queries`` report the
plans served and the caches. Every HTTP route is timed
(``http.handler{endpoint=}``), every telnet command too
(``telnet.handler{cmd=}``), and error answers count in ``http.errors`` /
``telnet.errors``. A self-monitor (``obs/selfmon.py``) ingests the
``/stats`` lines into the store every ``Config.selfmon_interval_s``
seconds (off by default). The ``/api/queries`` fused section reports the
fused block plan's attempts, serves, declines by reason and device block
cache counts, as the JAX daemon's does, and its rollup section the rollup
tier's state (ready, resolutions, hits, fallbacks, the sketch allocation
and bytes, the fold split and the delta accumulators) when the tier is
open, and its sketch section the approximate-serving counters; its mesh
section the execution plane's compile-cache line, the expert serve /
decline counts and, with a sharded resident hot set
(``--devwindow-shards``) or a mesh plane (``--mesh-plane``), the serving
mesh's shape and the plane's membership, which ``/healthz`` carries too
(the router weighs backends by its ``width``). ``--mesh N`` (or ``RxC``)
builds the query mesh at boot (N cards, or N logical shards on the CPU;
past the cards it refuses to start), and ``/api/mesh/reshard?shards=N``
reshards the hot set live. With ``--expert-parallel``, a ``/q`` of two
or more ``m=`` panels is first offered to the executor's expert path
(``run_expert_batch``: one mesh dispatch, each result's ``"plan"``
``"expert"``); a decline is declared as ``"plan": "expert-decline"`` and
counted under ``mesh.expert.decline{reason=}``, and the panels serve
one after another. A ranged
``/sketch`` served from rollups declares its bound in ``X-Tsd-Approx``,
and so does a ``/q`` with
``approx=1`` or ``max_error=`` whose percentile downsample was served
from the tier's sketch columns (plan label ``approx-1h``, the bound per
result under ``"approx"``). ``/forecast`` answers Holt-Winters / EWMA
forecasts and anomaly bands over a query's series (``models/``, one
launch of the smoothing kernels).

Admission (``serve/admission.py``): every ``/q`` passes the query half
first (a dry per-tenant ``Config.query_rate`` bucket answers 429, past
2 x ``Config.query_max_inflight`` in flight 503, both with Retry-After).
Between N and 2N in flight, or when asked with ``?degrade=rollup-only``
(a router's degraded step), the query runs degraded: trace work is shed,
it is served from the rollup tier only (``QueryExecutor.run_approx``
with ``rollup_only``; a percentile downsample from the tier's sketch
columns under ``Config.degrade_max_error``; a query the tier cannot
serve answers 503 + Retry-After; stale windows declared by a
``"rollup-stale"`` approx info), and every result and the
``X-Tsd-Degraded`` header carry ``"rollup-only"``, comma-joined with
``"stale"`` when both hold.

Replicas (ROADMAP item 10a): a ``--role replica`` daemon has a
``serve/tailer.WalTailer`` attached (``attach_tailer``). ``/healthz``
answers its staleness contract (200 while fresh, 503 past
``Config.max_staleness_ms``; a writer answers its role, and in cluster
mode its epoch and whether it was fenced), and while the replica is stale
every ``/q`` result carries ``"degraded": "stale"`` and the answer the
``X-Tsd-Degraded`` header. Puts to a replica or to a fenced writer are
refused with the JAX daemon's telnet lines (``put: read-only replica:``,
``put: fenced writer ...``) and ``/api/put`` bodies; ``/api/tenants``
of a daemon without accounting names its role. ``/fault`` arms, disarms
and lists fault points on a live daemon. In cluster mode (``--cluster``)
``/promote`` turns a replica into the writer (the epoch bumped first, the
tailer stopped, ``TSDB.promote``; a failure goes back to tailing) and
``/demote`` a deposed writer into a tailing replica, each idempotent and
one at a time; the router's ``cluster/promote.PromotionManager`` calls
them. The JAX daemon's test-only switches are kept:
``TSDB_SERVE_BUG=stale-serve`` drops the "stale" tag, and
``TSDB_CLUSTER_BUG=split-brain`` refuses ``/demote`` (and unfences the
writer, ``cluster/epoch.py``), so the serve matrix can prove that it
catches both.

Not ported yet, and answered with 400 "not yet ported": PNG graphs
(``/q`` without ``ascii``/``json``, ``/forecast`` with ``png``). Other
paths (the JAX daemon's ``/`` and ``/s/``) are 404.
"""

from __future__ import annotations

import asyncio
import concurrent.futures
import functools
import json
import logging
import math
import os
import threading
import time
import urllib.parse
from typing import NamedTuple

import torch

from opentsdb_tpu_torch.build_data import build_data, version_string
from opentsdb_tpu_torch.core import tags as tags_mod
from opentsdb_tpu_torch.core.errors import (BadRequestError,
                                             FencedWriterError,
                                             NoSuchUniqueName,
                                             OverloadedError,
                                             PleaseThrottleError,
                                             ReadOnlyStoreError,
                                             TenantLimitError)
from opentsdb_tpu_torch.fault import faultpoints
from opentsdb_tpu_torch.models import forecast as fcast
from opentsdb_tpu_torch.obs import trace as obs_trace
from opentsdb_tpu_torch.obs.registry import METRICS, read_rss_bytes
from opentsdb_tpu_torch.obs.ring import TraceRing, log_slow, make_record
from opentsdb_tpu_torch.obs.selfmon import SelfMonitor
from opentsdb_tpu_torch.parallel import compile as mesh_plane
from opentsdb_tpu_torch.query.aggregators import Aggregators
from opentsdb_tpu_torch.query.executor import (QueryExecutor, QuerySpec,
                                               not_yet_ported)
from opentsdb_tpu_torch.query.grammar import parse_m
from opentsdb_tpu_torch.serve.admission import (DEGRADE, SHED_LOAD,
                                                SHED_QUOTA,
                                                AdmissionController)
from opentsdb_tpu_torch.server import logbuffer, wire
from opentsdb_tpu_torch.sketch.bounds import hll_error
from opentsdb_tpu_torch.stats.collector import LatencyDigest, StatsCollector
from opentsdb_tpu_torch.utils import timeparse

LOG = logging.getLogger(__name__)

MAX_LINE = 1024       # per-line telnet framing limit (reference
                      # LineBasedFrameDecoder's 1024 B discard protection)
MAX_BUFFER = 1 << 22  # pipelined-burst buffer bound for the bulk path
MAX_HEADER_BYTES = 65536
MAX_BODY_BYTES = 1 << 20

# Protocol-level error counters: every >= 400 HTTP answer and every telnet
# line answered with an error bumps these, so a collector sees malformed
# clients, oversized bodies and shed load without parsing log text.
_M_HTTP_ERRORS = METRICS.counter("http.errors")
_M_TELNET_ERRORS = METRICS.counter("telnet.errors")

# Test-only sabotage switch of the serve matrix (tools/servematrix.py
# --bug): "stale-serve" drops the stale tag while a replica keeps serving,
# the contract violation the matrix's staleness oracle must catch.
_SERVE_BUG = os.environ.get("TSDB_SERVE_BUG", "")

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
    """The ``max_error=`` budget of /sketch and /q: a positive relative
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


def _spec_of(parsed) -> QuerySpec:
    """The executor's spec of one parsed ``m=``."""
    return QuerySpec(
        metric=parsed.metric, tags=parsed.tags,
        aggregator=parsed.aggregator, rate=parsed.rate,
        downsample=parsed.downsample, counter=parsed.counter,
        counter_max=parsed.counter_max, reset_value=parsed.reset_value)


def config_mesh(tsdb):
    """The query mesh a daemon's config asks for (the JAX daemon's boot
    rule): ``mesh_shape`` when set, else ``mesh_devices`` > 1 cards, else
    None. A shape past the cards raises here, at boot."""
    shape = tsdb.config.mesh_shape or ""
    if shape:
        from opentsdb_tpu_torch.parallel.plan import build_mesh
        return build_mesh(shape, device=tsdb.device)
    if tsdb.config.mesh_devices > 1:
        from opentsdb_tpu_torch.parallel.mesh import local_devices, make_mesh
        return make_mesh(tsdb.config.mesh_devices,
                         devices=local_devices(tsdb.device))
    return None


class TSDServer:
    def __init__(self, tsdb) -> None:
        self.tsdb = tsdb
        mesh = config_mesh(tsdb)
        if mesh is not None:
            mesh_plane.set_mesh_devices(mesh.size)
        self.executor = QueryExecutor(tsdb, mesh=mesh)
        self.config = tsdb.config
        # Expert-parallel dashboard serving: the knob alone arms the
        # attempt, so a knob-on daemon without a (multi-shard) mesh still
        # declares the decline (plan: "expert-decline",
        # mesh.expert.decline{reason=no-mesh}) instead of quietly serving
        # serially.
        self.expert_enabled = bool(self.config.expert_parallel)
        self.admission = AdmissionController(self.config)
        self._server: asyncio.AbstractServer | None = None
        self._shutdown = asyncio.Event()
        self._pool = concurrent.futures.ThreadPoolExecutor(
            max_workers=max(2, self.config.worker_threads))
        self.log_ring = logbuffer.install()
        # The reference's counters (ConnectionManager, RpcHandler,
        # PutDataPointRpc) and latency digests, as the JAX daemon keeps
        # them. The port has no /q disk cache and no PNG graphs, so every
        # /q is a cache miss and the graph digest stays empty.
        self.connections_established = 0
        self.exceptions_caught = 0
        self.telnet_rpcs = 0
        self.http_rpcs = 0
        self.rpcs_unknown = 0
        self.requests_put = 0
        self.hbase_errors_put = 0
        self.illegal_arguments_put = 0
        self.unknown_metrics_put = 0
        self.put_latency = LatencyDigest()
        self.http_latency = LatencyDigest()
        self.graph_latency = LatencyDigest()
        self.cache_hits = 0
        self.cache_misses = 0
        self.start_time = int(time.time())
        # The last Config.trace_ring traced or slow queries (/api/traces),
        # the 1-in-N sampling counter, and the per-plan serve counters
        # (bumped once per sub-query; /api/queries, /stats query.plan).
        self.trace_ring = TraceRing(self.config.trace_ring)
        self._trace_sample_seq = 0
        self._plan_lock = threading.Lock()
        self.plan_counts: dict[str, int] = {}
        # Ingests the /stats lines as tsd.* series every
        # selfmon_interval_s (0: off; built anyway, so run_once works).
        self.selfmon = SelfMonitor(tsdb, self._collect_stats,
                                   self.config.selfmon_interval_s)
        # The WAL tailer of a --role replica daemon (attach_tailer): the
        # staleness contract behind /healthz and the /q stale tag.
        self.tailer = None
        # One role transition (/promote, /demote) at a time.
        self._role_lock = threading.Lock()
        # Handlers take (words, writer, conn): ``conn`` is the
        # connection's state (its tenant). False closes the connection.
        self.telnet_commands = {
            "put": self._telnet_put,
            "tenant": self._telnet_tenant,
            "version": lambda words, writer, conn: writer.write(
                self._version_text().encode()),
            "stats": lambda words, writer, conn: writer.write(
                ("\n".join(self._collect_stats()) + "\n").encode()),
            "help": lambda words, writer, conn: writer.write((
                "available commands: "
                + " ".join(sorted(self.telnet_commands))
                + "\n").encode()),
            "exit": lambda words, writer, conn: False,
            "dropcaches": self._telnet_dropcaches,
            "diediedie": self._telnet_diediedie,
        }
        self.http_routes = {
            "/aggregators": self._http_aggregators,
            "/version": self._http_version,
            "/stats": self._http_stats,
            "/logs": self._http_logs,
            "/suggest": self._http_suggest,
            "/api/put": self._http_put,
            "/api/tenants": self._http_tenants,
            "/tenants": self._http_tenants_page,
            "/queries": self._http_queries_page,
            "/api/queries": self._http_queries,
            "/metrics": self._http_metrics,
            "/api/traces": self._http_traces,
            "/dropcaches": self._http_dropcaches,
            "/diediedie": self._http_diediedie,
            "/favicon.ico": self._http_favicon,
            "/q": self._query,
            "/distinct": self._distinct,
            "/sketch": self._sketch,
            "/forecast": self._forecast,
            "/healthz": self._http_healthz,
            "/fault": self._http_fault,
            "/promote": self._http_promote,
            "/demote": self._http_demote,
            "/api/mesh/reshard": self._http_mesh_reshard,
        }

    def attach_tailer(self, tailer) -> None:
        """Wire a ``serve.tailer.WalTailer`` into /healthz and the /q
        staleness tag; ``stop()`` stops it."""
        self.tailer = tailer

    # ------------------------------------------------------------------
    # Lifecycle
    # ------------------------------------------------------------------

    async def start(self) -> None:
        self._server = await asyncio.start_server(
            self._handle_conn, self.config.bind, self.config.port)
        self.selfmon.start()
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
        self.selfmon.stop()
        if self.tailer is not None:
            self.tailer.stop()
        self._pool.shutdown(wait=True)
        self.tsdb.shutdown()

    def request_shutdown(self) -> None:
        self._shutdown.set()

    @property
    def port(self) -> int:
        return self._server.sockets[0].getsockname()[1]

    async def _handle_conn(self, reader: asyncio.StreamReader,
                           writer: asyncio.StreamWriter) -> None:
        self.connections_established += 1
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
            self.exceptions_caught += 1
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
            self.telnet_rpcs += 1
            handler = self.telnet_commands.get(words[0])
            if handler is None:
                self.rpcs_unknown += 1
                _M_TELNET_ERRORS.inc()
                writer.write(f"unknown command: {words[0]}\n".encode())
                await writer.drain()
                continue
            # Per-command latency (the HTTP routes' twin); the bulk put
            # path bypasses it, covered by rpc.latency and wal.*.
            with METRICS.timer("telnet.handler", {"cmd": words[0]}).time():
                out = handler(words, writer, conn)
            await writer.drain()
            if out is False:
                return

    async def _bulk_puts(self, chunk: bytes, writer, line_base: int,
                         tenant: str) -> None:
        t0 = time.time()
        loop = asyncio.get_running_loop()
        batch = await loop.run_in_executor(
            self._pool, functools.partial(wire.decode_puts, chunk,
                                          line_base=line_base))
        # Ingest admission: shed the whole batch with a throttle line and
        # a retry hint before it allocates store work.
        npts = len(batch.sid)
        wait = self.admission.admit_ingest(npts, tenant) if npts else 0.0
        if wait > 0:
            self.telnet_rpcs += npts + len(batch.errors)
            self.requests_put += npts + len(batch.errors)
            self.hbase_errors_put += 1
            _M_TELNET_ERRORS.inc()
            writer.write(
                f"put: Please throttle writes: over ingest quota, "
                f"retry after {max(wait, 0.1):.1f}s\n".encode())
            await writer.drain()
            return
        try:
            n, series_errors = await loop.run_in_executor(
                self._pool, functools.partial(
                    wire.ingest_batch, self.tsdb, batch, tenant=tenant))
        finally:
            if npts:
                self.admission.ingest_done(npts)
        self.telnet_rpcs += n + len(batch.errors)
        self.requests_put += n + len(batch.errors)
        elines = list(batch.error_lines)
        for k, err in enumerate(batch.errors):
            self.illegal_arguments_put += 1
            _M_TELNET_ERRORS.inc()
            # 1-based stream line numbers where the decoder gave them
            # (the native one does not); the same line prefix either way.
            at = f" at line {elines[k] + 1}" if k < len(elines) else ""
            writer.write(f"put: illegal argument{at}: {err}\n".encode())
        for err in series_errors:
            _M_TELNET_ERRORS.inc()
            if "No such name" in err:
                self.unknown_metrics_put += 1
                kind = "unknown metric"
            elif "throttle" in err.lower():
                self.hbase_errors_put += 1
                kind = "Please throttle writes"
            elif "[tenant-limit]" in err:
                # Declared cardinality refusal, tagged by ingest_batch:
                # NOT a throttle (the series can never ingest until the
                # limit moves); the batch's existing series applied.
                self.hbase_errors_put += 1
                kind = "tenant series limit exceeded"
            elif "read-only" in err:
                self.hbase_errors_put += 1
                kind = "read-only replica"
            elif "[fenced]" in err:
                # A deposed writer (tagged by ingest_batch): refused, the
                # collector re-sends to the current writer.
                self.hbase_errors_put += 1
                kind = "fenced writer"
            else:
                self.illegal_arguments_put += 1
                kind = "illegal argument"
            writer.write(f"put: {kind}: {err}\n".encode())
        self.put_latency.add((time.time() - t0) * 1000)
        await writer.drain()

    def _telnet_tenant(self, words: list[str], writer, conn: dict) -> None:
        """``tenant <id>`` charges every later put of the connection to
        <id>'s quota and cardinality budget."""
        if len(words) != 2 or not words[1]:
            _M_TELNET_ERRORS.inc()
            writer.write(b"tenant: need exactly one id\n")
        else:
            conn["tenant"] = words[1]
            writer.write(f"tenant {words[1]}\n".encode())

    def _telnet_put(self, words: list[str], writer, conn: dict) -> None:
        """Parity: reference PutDataPointRpc.importDataPoint (:93-123)."""
        tenant = conn["tenant"]
        t0 = time.time()
        self.requests_put += 1
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
            self.put_latency.add((time.time() - t0) * 1000)
        except TenantLimitError as e:
            # A distinct line from the throttle: the put can never
            # succeed until the limit is raised.
            self.hbase_errors_put += 1
            _M_TELNET_ERRORS.inc()
            writer.write(
                f"put: tenant series limit exceeded: {e}\n".encode())
        except NoSuchUniqueName as e:
            self.unknown_metrics_put += 1
            _M_TELNET_ERRORS.inc()
            writer.write(f"put: unknown metric: {e}\n".encode())
        except (ValueError, ArithmeticError) as e:
            self.illegal_arguments_put += 1
            _M_TELNET_ERRORS.inc()
            writer.write(f"put: illegal argument: {e}\n".encode())
        except PleaseThrottleError as e:
            self.hbase_errors_put += 1
            _M_TELNET_ERRORS.inc()
            writer.write(f"put: Please throttle writes: {e}\n".encode())
        except ReadOnlyStoreError as e:
            # A replica serves reads only: write to the writer instead.
            self.hbase_errors_put += 1
            _M_TELNET_ERRORS.inc()
            writer.write(f"put: read-only replica: {e}\n".encode())
        except FencedWriterError as e:
            # A deposed writer: refused, never acknowledged.
            self.hbase_errors_put += 1
            _M_TELNET_ERRORS.inc()
            writer.write(f"put: fenced writer (superseded by epoch "
                         f"{e.current_epoch}): {e}\n".encode())

    def _telnet_dropcaches(self, words, writer, conn) -> None:
        self.tsdb.drop_caches()
        writer.write(b"Caches dropped.\n")

    def _telnet_diediedie(self, words, writer, conn) -> bool:
        writer.write(b"Cleaning up and exiting now.\n")
        self.request_shutdown()
        return False

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
            t0 = time.time()
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
                self.exceptions_caught += 1
                LOG.exception("HTTP error on %s", target)
                status, ctype = 500, "text/plain"
                body = f"Internal Server Error: {e}\n".encode()
            self.http_latency.add((time.time() - t0) * 1000)
            await self._respond(writer, status, ctype, body, keep, extra)
            if not keep:
                return

    async def _respond(self, writer, status: int, ctype: str, body: bytes,
                       keep: bool, extra: dict | None = None) -> None:
        if status >= 400:
            _M_HTTP_ERRORS.inc()
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
        self.http_rpcs += 1
        parsed = urllib.parse.urlsplit(target)
        route = parsed.path.rstrip("/") or "/"
        handler = self.http_routes.get(route)
        if handler is None:
            self.rpcs_unknown += 1
            return 404, "text/plain", b"Page Not Found\n", {}
        params = urllib.parse.parse_qs(parsed.query, keep_blank_values=True)
        q = {k: v[-1] for k, v in params.items()}
        # Per-endpoint latency, tagged by the route (a bounded label set),
        # never the raw path.
        with METRICS.timer("http.handler", {"endpoint": route}).time():
            out = handler(HttpRequest(method, parsed.path, q, params, body))
            if asyncio.iscoroutine(out):
                out = await out
        return out

    def _http_aggregators(self, req) -> tuple:
        return (200, "application/json",
                json.dumps(Aggregators.available()).encode(), {})

    def _http_version(self, req) -> tuple:
        if "json" in req.q:
            # The JAX daemon's keys, plus the port's torch and device.
            info = dict(build_data(), start_time=self.start_time,
                        torch=torch.__version__,
                        device=str(self.executor.device))
            return (200, "application/json",
                    json.dumps(info).encode(), {})
        return 200, "text/plain", self._version_text().encode(), {}

    # ------------------------------------------------------------------
    # Operator surface: stats, logs, metrics, traces, caches
    # ------------------------------------------------------------------

    def _http_stats(self, req) -> tuple:
        lines = self._collect_stats()
        if "json" in req.q:
            return (200, "application/json",
                    json.dumps(lines).encode(), {})
        return 200, "text/plain", ("\n".join(lines) + "\n").encode(), {}

    def _http_logs(self, req) -> tuple:
        """The log ring, newest first (reference LogsRpc :62-103);
        ``?level=`` sets the root logger's level first."""
        lines = self.log_ring.formatted()
        if "level" in req.q:
            try:
                logbuffer.set_level(req.q["level"])
            except ValueError as e:
                raise BadRequestError(str(e)) from None
        if "json" in req.q:
            return (200, "application/json", json.dumps(lines).encode(),
                    {})
        return (200, "text/plain", ("\n".join(lines) + "\n").encode(),
                {})

    def _http_metrics(self, req) -> tuple:
        """Prometheus text: the registry (counters, gauges, timer
        summaries) merged with the /stats lines (untyped gauges, skipped
        where the registry already names them)."""
        body = METRICS.prometheus_text(extra_lines=self._collect_stats())
        return (200, "text/plain; version=0.0.4; charset=utf-8",
                body.encode(), {})

    def _http_traces(self, req) -> tuple:
        """The trace ring, newest last; ``?slow=1`` keeps the slow
        records."""
        records = self.trace_ring.snapshot()
        if "slow" in req.q and req.q["slow"] not in ("", "0"):
            records = [r for r in records if r.get("slow")]
        return 200, "application/json", json.dumps(records).encode(), {}

    def _http_suggest(self, req) -> tuple:
        q = req.q
        kind = q.get("type", "metrics")
        prefix = q.get("q", "")
        try:
            limit = int(q.get("max", "25"))
        except ValueError:
            raise BadRequestError("invalid 'max' parameter") from None
        uids = {"metrics": self.tsdb.metrics, "tagk": self.tsdb.tagk,
                "tagv": self.tsdb.tagv}.get(kind)
        if uids is None:
            raise BadRequestError(f"Invalid 'type' parameter: {kind}")
        return (200, "application/json",
                json.dumps(uids.suggest(prefix, limit)).encode(), {})

    def _http_dropcaches(self, req) -> tuple:
        self.tsdb.drop_caches()
        return 200, "text/plain", b"Caches dropped.\n", {}

    def _http_diediedie(self, req) -> tuple:
        self.request_shutdown()
        return (200, "text/html; charset=UTF-8",
                b"Cleaning up and exiting now.\n", {})

    def _http_favicon(self, req) -> tuple:
        return 404, "text/plain", b"", {}

    def _http_fault(self, req) -> tuple:
        """Fault-injection admin (fault/faultpoints.py) on a live daemon:
        ``/fault`` lists the registry, ``?arm=site=mode:k=v`` arms (a
        crash mode kills the daemon at the next hit), ``?disarm=site``
        disarms one site, ``?clear=1`` every site."""
        q = req.q
        if "arm" in q:
            try:
                faultpoints.install_spec(q["arm"])
            except ValueError as e:
                raise BadRequestError(str(e)) from None
        if "disarm" in q:
            faultpoints.disarm(q["disarm"])
        if "clear" in q:
            faultpoints.clear()
        return (200, "application/json",
                json.dumps(faultpoints.status()).encode(), {})

    def _http_healthz(self, req) -> tuple:
        """Liveness and the replica staleness contract: 200 while ok, 503
        while a replica is stale (the body still carries the measured
        lag). In cluster mode the body carries the epoch this daemon owns
        and, once deposed, ``fenced`` and the epoch that fenced it."""
        if self.tailer is not None:
            body = self.tailer.health()
        else:
            body = {"role": self.config.role, "ok": True,
                    "read_only": bool(getattr(self.tsdb.store,
                                              "read_only", False))}
        store = self.tsdb.store
        epoch = getattr(store, "writer_epoch", None)
        if epoch is not None:
            body["writer_epoch"] = int(epoch)
        guard = getattr(store, "epoch_guard", None)
        if guard is not None and guard.fenced:
            # Deposed but alive: reads still serve, every write refuses.
            body["fenced"] = True
            body["fenced_by_epoch"] = guard.fenced_epoch
        body["uptime_s"] = int(time.time()) - self.start_time
        body["inflight_queries"] = self.admission.inflight_queries
        mesh = self._mesh_serving_info()
        if mesh is not None:
            # The router weights series ownership by this width (the
            # resident hot set's shards).
            body["mesh"] = mesh
        status = 200 if body.get("ok") else 503
        return status, "application/json", json.dumps(body).encode(), {}

    def _mesh_serving_info(self) -> dict | None:
        """The serving-mesh block of /healthz and /api/queries: plane
        membership (``plane``, when --mesh-plane joined one) and the
        sharded resident hot set's live shape. None when neither is on,
        so the body stays the same for a daemon without them."""
        from opentsdb_tpu_torch.parallel.fleet import plane_info
        plane = plane_info()
        dw = self.tsdb.devwindow
        sharded = dw is not None and hasattr(dw, "shard_of")
        if plane is None and not sharded:
            return None
        out: dict = {"width": dw.n_shards if sharded else 1}
        if plane is not None:
            out["plane"] = dict(plane)
        if sharded:
            out["resident"] = {
                "shards": dw.n_shards,
                "points": dw.resident_points(),
                "generation": dw.generation,
                "reshards": dw.reshard_count,
                "last_reshard_ms": round(dw.reshard_ms, 2)}
        return out

    async def _http_mesh_reshard(self, req) -> tuple:
        """``/api/mesh/reshard?shards=N``: redistribute the resident
        device columns over N shards (a coherent swap: queries that
        began before it finish on the complete old set; see
        storage/devshard.py). Runs in the worker pool, so the drain and
        rebuild never block the event loop's ingest."""
        dw = self.tsdb.devwindow
        if dw is None or not hasattr(dw, "shard_of"):
            raise BadRequestError(
                "resident hot set is not sharded (start the daemon "
                "with --devwindow-shards)")
        try:
            n = int(req.q.get("shards", "0"))
        except ValueError:
            raise BadRequestError(
                f"invalid shards: {req.q.get('shards')}") from None
        if n < 1:
            raise BadRequestError("shards must be >= 1")
        loop = asyncio.get_running_loop()
        try:
            stats = await loop.run_in_executor(
                self._pool, lambda: dw.reshard(n_shards=n))
        except RuntimeError as e:
            return (409, "application/json",
                    json.dumps({"error": str(e)}).encode(), {})
        return (200, "application/json", json.dumps(stats).encode(), {})

    # ------------------------------------------------------------------
    # Cluster failover: /promote and /demote
    # ------------------------------------------------------------------

    async def _http_promote(self, req) -> tuple:
        """Replica -> writer takeover, asked by the router's promotion
        manager when the writer's /healthz stayed dead past its grace, or
        by an operator. Bumps the persisted epoch (the EPOCH.json CAS;
        ``expect=`` pins the epoch the bump must start from), stops the
        tailer and promotes the TSDB. Idempotent: a promoted daemon asked
        again answers its epoch without another bump."""
        path = getattr(self.tsdb, "cluster_epoch_path", None)
        if not path:
            raise BadRequestError(
                "not a cluster member (start the daemon with --cluster)")
        store = self.tsdb.store
        if not getattr(store, "read_only", False):
            return (200, "application/json", json.dumps({
                "role": "writer", "already_writer": True,
                "epoch": int(getattr(store, "writer_epoch", 0) or 0),
            }).encode(), {})
        expect = None
        if req.q.get("expect"):
            try:
                expect = int(req.q["expect"])
            except ValueError:
                raise BadRequestError("expect must be an integer") from None
        loop = asyncio.get_running_loop()
        epoch = await loop.run_in_executor(
            self._pool, functools.partial(self._do_promote, path, expect))
        return (200, "application/json", json.dumps(
            {"role": "writer", "epoch": epoch}).encode(), {})

    def _do_promote(self, path: str, expect: int | None) -> int:
        from opentsdb_tpu_torch.cluster import epoch as _ep
        from opentsdb_tpu_torch.serve.tailer import WalTailer
        # Under the lock, the check again: two retried /promote requests
        # can both pass the one on the event loop, and a second bump would
        # fence the writer the first one made.
        with self._role_lock:
            if not getattr(self.tsdb.store, "read_only", False):
                return int(getattr(self.tsdb.store, "writer_epoch", 0) or 0)
            # Bump before the tailer stops: a failed bump (a CAS conflict,
            # a disk error) leaves the replica tailing as it was. A crash
            # after the bump leaves an epoch without a writer, which the
            # next promotion bumps past.
            owner = (self.config.cluster_owner
                     or f"{self.config.bind}:{self.config.port}")
            new = _ep.bump_epoch(path, owner=owner, expect=expect)
            faultpoints.fire("cluster.promote.bumped", path)
            guard = _ep.EpochGuard(
                path, new, interval_s=self.config.epoch_check_interval_s)
            tailer, self.tailer = self.tailer, None
            if tailer is not None:
                # The tailer drives refresh_replica, which a writable store
                # refuses: it stops before the store flips.
                tailer.stop()
            try:
                self.tsdb.promote(new, epoch_guard=guard)
            except BaseException:
                # The store restored itself to a coherent replica: tail
                # again, so this daemon keeps its place in rotation while
                # the router tries the next candidate.
                self.tailer = WalTailer(self.tsdb)
                self.tailer.start()
                raise
            self.config.role = "writer"
            # A promoted replica spills at the cadence it was configured
            # with (0: checkpoints at shutdown only).
            self.tsdb.compactionq.checkpoint_interval = \
                self.config.checkpoint_interval or 0.0
            LOG.warning("promoted to writer at epoch %d", new)
            return new

    async def _http_demote(self, req) -> tuple:
        """Writer -> tailing replica: the deposed writer's way back into
        the fleet, asked by the router when a fenced or stale-epoch writer
        reappears. Idempotent on a replica."""
        path = getattr(self.tsdb, "cluster_epoch_path", None)
        if not path:
            raise BadRequestError(
                "not a cluster member (start the daemon with --cluster)")
        if getattr(self.tsdb.store, "read_only", False):
            return (200, "application/json", json.dumps(
                {"role": "replica", "already_replica": True}).encode(), {})
        if os.environ.get("TSDB_CLUSTER_BUG") == "split-brain":
            # The serve matrix's cluster gate: an unfenced zombie ignores
            # the protocol, demotion included.
            return (500, "text/plain",
                    b"demote sabotaged by TSDB_CLUSTER_BUG\n", {})
        loop = asyncio.get_running_loop()
        await loop.run_in_executor(self._pool, self._do_demote)
        return (200, "application/json", json.dumps(
            {"role": "replica"}).encode(), {})

    def _do_demote(self) -> None:
        from opentsdb_tpu_torch.serve.tailer import WalTailer
        with self._role_lock:
            if getattr(self.tsdb.store, "read_only", False):
                return  # a concurrent demote won the race
            self.tsdb.demote()
            self.config.role = "replica"
            if not self.config.max_staleness_ms:
                # A demoted daemon serves under the staleness contract a
                # born replica has (cmd_tsd's replica default).
                self.config.max_staleness_ms = 5000.0
            # The tailer becomes the only thing that refreshes: the compaction
            # timer stops driving refresh_replica.
            self.tsdb.compactionq.checkpoint_interval = 0.0
            self.tailer = WalTailer(self.tsdb)
            self.tailer.start()
            LOG.warning("demoted to tailing replica")

    def _degraded_reason(self, load_degraded: bool = False) -> str | None:
        """The /q result tag: "stale" while the replica staleness contract
        is violated, "rollup-only" at the admission ladder's degraded step,
        both comma-joined when both hold; None at full service. The stale
        half is what the serve matrix's staleness oracle checks, and what
        ``TSDB_SERVE_BUG=stale-serve`` drops so the oracle can be shown to
        catch a replica that lies."""
        reasons = []
        if (self.tailer is not None and self.tailer.stale()
                and _SERVE_BUG != "stale-serve"):
            reasons.append("stale")
        if load_degraded:
            reasons.append("rollup-only")
        return ",".join(reasons) if reasons else None

    def _note_plan(self, plan: str, approx: bool = False) -> None:
        """Bump the bounded per-plan counters, as in the JAX daemon:
        "approx-1h" labels count as "approx", rollup resolution labels
        ("1h", "1d") fold into "rollup", and an exact-plan answer that
        carries approx metadata counts both."""
        if plan.startswith("approx"):
            key = "approx"
        elif plan in ("raw", "resident", "fused", "expert"):
            key = plan
        else:
            key = "rollup"
        with self._plan_lock:
            self.plan_counts[key] = self.plan_counts.get(key, 0) + 1
            if approx and key != "approx":
                self.plan_counts["approx"] = \
                    self.plan_counts.get("approx", 0) + 1

    def _http_queries(self, req) -> tuple:
        """JSON feed behind the /queries page: plans served, the ingest
        fast path's group commit and parse timers, the fragment cache,
        admission, the fused block plan's coverage (attempts, serves,
        declines by reason, the device block cache), the approximate-
        serving counters (``sketch.*``), and the rollup tier's section
        when it is open. The mesh section carries the plane's
        compile-cache line and the serving mesh's shape."""
        sketch: dict = {}
        fused = {"attempt": 0, "served": 0, "declines": {},
                 "devcache": {"hit": 0, "miss": 0, "evict": 0}}
        ingest = {"group": {"batches": 0, "points": 0, "fsyncs": 0,
                            "waits": 0, "wait_ms_p95": 0.0},
                  "parse": {"count": 0, "p95_ms": 0.0}}
        expert_counts = {"serve": 0, "decline": 0}
        for name, kind, tkey, obj in METRICS._snapshot():
            if name == "mesh.expert.serve":
                expert_counts["serve"] += obj.value
            elif name == "mesh.expert.decline":
                expert_counts["decline"] += obj.value
            elif name.startswith("sketch."):
                label = name[len("sketch."):]
                if tkey:
                    label += "{" + ",".join(
                        f"{k}={v}" for k, v in tkey) + "}"
                if kind == "counter":
                    sketch[label] = obj.value
                elif kind == "timer":
                    sketch[label + ".count"] = obj.count
                    sketch[label + ".p95"] = round(
                        obj.digest.percentile(95), 4)
            elif name == "wal.group.batches":
                ingest["group"]["batches"] += obj.value
            elif name == "wal.group.points":
                ingest["group"]["points"] += obj.value
            elif name == "wal.group.fsyncs":
                ingest["group"]["fsyncs"] += obj.value
            elif name == "wal.group.wait_ms" and kind == "timer":
                ingest["group"]["waits"] += obj.count
                ingest["group"]["wait_ms_p95"] = round(
                    obj.digest.percentile(95), 4)
            elif name == "ingest.parse" and kind == "timer":
                ingest["parse"]["count"] += obj.count
                ingest["parse"]["p95_ms"] = round(
                    obj.digest.percentile(95), 4)
            elif name == "compress.fused.attempt":
                fused["attempt"] += obj.value
            elif name == "compress.fused.served":
                fused["served"] += obj.value
            elif name == "compress.fused.decline":
                reason = dict(tkey).get("reason", "?")
                fused["declines"][reason] = \
                    fused["declines"].get(reason, 0) + obj.value
            elif name.startswith("compress.devcache."):
                fused["devcache"][name.rsplit(".", 1)[1]] = obj.value
        fused["coverage"] = (fused["served"] / fused["attempt"]
                             if fused["attempt"] else 0.0)
        g = ingest["group"]
        g["batches_per_fsync"] = (g["batches"] / g["fsyncs"]
                                  if g["fsyncs"] else 0.0)
        with self._plan_lock:
            plans = dict(self.plan_counts)
        body = {
            "uptime_s": int(time.time()) - self.start_time,
            "plans": plans,
            "fused": fused,
            "ingest": ingest,
            "sketch": sketch,
            "rollup": self._rollup_section(),
            # The mesh plane's compile-cache line: the configured
            # mesh's devices, the plan cache's size / hit / miss, the
            # expert serve / decline counters and the serving mesh's
            # shape.
            "mesh": {"devices": (self.executor.mesh.size
                                 if self.executor.mesh is not None
                                 else 1),
                     "expert_enabled": self.expert_enabled,
                     "compile_cache": mesh_plane.cache_info(),
                     "expert": expert_counts,
                     "serving": self._mesh_serving_info()},
            "qcache": {"hit": self.executor.qcache_hits,
                       "miss": self.executor.qcache_misses,
                       "bypass": self.executor.qcache_bypasses},
            "admission": {
                "inflight": self.admission.inflight_queries,
                "degraded": self.admission.query_degraded,
                "shed_load": self.admission.query_shed_load,
            },
        }
        return (200, "application/json", json.dumps(body).encode(), {})

    def _rollup_section(self) -> dict | None:
        """The rollup tier's /api/queries section (the JAX daemon's keys),
        None without the tier."""
        tier = getattr(self.tsdb, "rollups", None)
        if tier is None:
            return None
        from opentsdb_tpu_torch.rollup.tier import res_label
        rollup = {
            "ready": bool(tier.ready),
            "resolutions": [res_label(r) for r in tier.resolutions],
            "hits": {res_label(r): tier.hits.get(r, 0)
                     for r in tier.resolutions},
            "fallbacks": dict(tier.fallbacks),
            "sketch_alloc": {
                res_label(r): {"digest_k": a[0], "moment_k": a[1],
                               "hll_p": a[2]}
                for r, a in sorted(tier.sketch_alloc.items())},
            "sketch_bytes": dict(tier.sketch_bytes),
            # Checkpoint fold sourcing: windows served from the delta
            # buffers against full re-reads of spilled rows.
            "folds": {"delta": tier.fold_delta, "full": tier.fold_full},
        }
        if tier.delta is not None:
            rollup["delta"] = tier.delta.stats()
        return rollup

    def _http_queries_page(self, req) -> tuple:
        return (200, "text/html; charset=UTF-8",
                _QUERIES_HTML.encode(), {"Cache-Control": "no-cache"})

    def _collect_stats(self) -> list[str]:
        """The /stats lines: the reference's server counters and latency
        digests, the plan counters, fault points, process and trace-ring
        lines, admission and the self-monitor, the engine's
        ``TSDB.collect_stats`` and the metrics registry (timers as
        p50/p95/p99 plus ``.count`` / ``.sum_ms``). The JAX daemon's
        lines."""
        c = StatsCollector("tsd")
        c.record("connectionmgr.connections", self.connections_established)
        c.record("connectionmgr.exceptions", self.exceptions_caught)
        c.record("rpc.received", self.telnet_rpcs, "type=telnet")
        c.record("rpc.received", self.http_rpcs, "type=http")
        c.record("rpc.errors", self.rpcs_unknown, "type=unknown")
        c.record("rpc.errors", self.hbase_errors_put, "type=hbase_errors")
        c.record("rpc.errors", self.illegal_arguments_put,
                 "type=illegal_arguments")
        c.record("rpc.errors", self.unknown_metrics_put,
                 "type=unknown_metrics")
        c.record("rpc.requests", self.requests_put, "type=put")
        c.record("http.latency", self.http_latency, "type=all")
        c.record("http.latency", self.graph_latency, "type=graph")
        c.record("rpc.latency", self.put_latency, "type=put")
        c.record("scan.latency", self.executor.scan_latency, "type=query")
        c.record("http.graph.requests", self.cache_hits, "cache=hit")
        c.record("http.graph.requests", self.cache_misses, "cache=miss")
        c.record("qcache.hit", self.executor.qcache_hits)
        c.record("qcache.miss", self.executor.qcache_misses)
        c.record("qcache.bypass", self.executor.qcache_bypasses)
        with self._plan_lock:
            plans = sorted(self.plan_counts.items())
        for plan, n in plans:
            c.record("query.plan", n, f"plan={plan}")
        fstat = faultpoints.status()
        c.record("fault.sites_armed", len(fstat["armed"]))
        c.record("fault.fired", sum(fstat["fired"].values()))
        for site, n in sorted(fstat["fired"].items()):
            c.record("fault.fired_site", n, f"site={site}")
        c.record("uptime", int(time.time()) - self.start_time)
        c.record("uptime_s", int(time.time()) - self.start_time)
        rss = read_rss_bytes()
        if rss:
            c.record("process.rss_bytes", rss)
        c.record("traces.recorded", self.trace_ring.recorded)
        c.record("traces.slow", self.trace_ring.slow)
        self.admission.collect_stats(c)
        c.record("selfmon.cycles", self.selfmon.cycles)
        c.record("selfmon.points", self.selfmon.points)
        c.record("selfmon.errors", self.selfmon.errors)
        self.tsdb.collect_stats(c)
        METRICS.collect(c)
        return c.lines

    # ------------------------------------------------------------------
    # Tenants and HTTP ingest
    # ------------------------------------------------------------------

    def _http_tenants(self, req) -> tuple:
        """JSON feed behind the /tenants page: per-tenant series
        cardinality (exact or HLL tier, error declared), the limit
        governing each tenant, refusal counters, the heavy-hitter
        summaries, and the admission controller's bucket table. A daemon
        without accounting (a replica among them) answers ``enabled:
        false`` and its role."""
        acct = self.tsdb.tenants
        if acct is None:
            body = {"enabled": False, "role": self.config.role}
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
        self.requests_put += n
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
        return version_string()

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
        # Admission (serve/admission.py): a dry per-tenant bucket is 429,
        # the ladder's top 503, both through OverloadedError so that the
        # Retry-After reaches the wire. The degraded step takes a slot as
        # full service does (the work still runs, cheaper), released in the
        # finally below. Only valid requests take slots.
        tenant = q.get("tenant", "default")
        verdict, retry = self.admission.admit_query(tenant)
        if verdict == SHED_QUOTA:
            raise OverloadedError(
                f"query quota exceeded for tenant {tenant!r}", retry,
                status=429)
        if verdict == SHED_LOAD:
            raise OverloadedError(
                "shedding load: too many queries in flight", retry,
                status=503)
        # ?degrade=rollup-only: an overloaded router asking for the cheap
        # path on this hop, honoured as the local ladder's degraded step.
        degrade = (verdict == DEGRADE
                   or q.get("degrade") == "rollup-only")
        try:
            return await self._query_admitted(q, ms, start, end, degrade)
        finally:
            self.admission.query_done()

    async def _query_admitted(self, q, ms, start: int, end: int,
                              degrade: bool) -> tuple:
        # Tracing: asked for (?trace=1), implied for every query by a
        # slow-query threshold, or 1 in trace_sample_n (a baseline between
        # incidents). Off, each hook is one global integer check; on, a
        # perf_counter pair per stage, never per point. The degraded step
        # sheds trace work first.
        want_trace = q.get("trace", "0") not in ("", "0") and not degrade
        slow_ms = float(self.config.slow_query_ms or 0)
        sample_n = int(self.config.trace_sample_n or 0)
        sampled = False
        if sample_n > 0 and not want_trace and not degrade:
            self._trace_sample_seq += 1
            sampled = self._trace_sample_seq % sample_n == 0
        do_trace = want_trace or sampled or (slow_ms > 0 and not degrade)
        # Approximate serving (sketch/serving.py, whose import registers
        # the sketch.* instruments, as every /q of the JAX daemon does):
        # ``approx=1`` lets a percentile downsample be served from the
        # rollup tier's sketch columns at any reported bound;
        # ``max_error=X`` (a relative half-width) implies the opt-in and
        # caps it, an answer over it falls back to the exact path. The
        # degraded step serves percentile downsamples from the sketch
        # columns under Config.degrade_max_error.
        from opentsdb_tpu_torch.sketch.serving import ApproxSpec
        max_error = _parse_max_error(q)
        approx_on = (q.get("approx", "0") not in ("", "0")
                     or max_error is not None)
        if degrade and max_error is None:
            budget = float(self.config.degrade_max_error or 0)
            max_error = budget if budget > 0 else None
        aspec = ApproxSpec(approx_on, max_error)
        # Anything less than full service is declared, per result in JSON
        # and as X-Tsd-Degraded: "stale" while a replica is past its
        # staleness contract, "rollup-only" at the degraded step.
        degraded = self._degraded_reason(degrade)
        # No /q disk cache here: every query executes (so no exact caller
        # can be served an approximate answer from a cached one).
        self.cache_misses += 1
        loop = asyncio.get_running_loop()
        results = []
        plans = []
        cached = []
        traces = []
        approx = []
        # Expert-parallel batch serving (parallel/expert.py, behind
        # Config.expert_parallel and a mesh): a mixed dashboard of two or
        # more sub-queries runs in one mesh dispatch. Attempted only on
        # the full-service path (tracing, the degraded step and approx
        # contracts keep their serial semantics); a decline is declared
        # (plan: "expert-decline" per result and mesh.expert.decline) and
        # the batch serves serially with the parsed specs, answers
        # unchanged.
        expert_label = None
        specs = None
        if (self.expert_enabled and len(ms) >= 2 and not do_trace
                and not degrade and not aspec.enabled):
            specs = [_spec_of(parse_m(m)) for m in ms]
            per_spec, reason = await loop.run_in_executor(
                self._pool, functools.partial(
                    self.executor.run_expert_batch, specs, start, end))
            if per_spec is not None:
                # Counted per sub-query, the serial loop's unit.
                METRICS.counter("mesh.expert.serve").inc(len(ms))
                for _ in ms:
                    self._note_plan("expert")
                expert_label = "expert"
                for rs in per_spec:
                    results.extend(rs)
                    plans.extend(["expert"] * len(rs))
                    cached.extend([False] * len(rs))
                    traces.extend([None] * len(rs))
                    approx.extend([None] * len(rs))
                ms = ()
            else:
                METRICS.counter("mesh.expert.decline",
                                {"reason": reason}).inc(len(ms))
                with self._plan_lock:
                    self.plan_counts["expert-decline"] = \
                        self.plan_counts.get("expert-decline", 0) + len(ms)
                expert_label = "expert-decline"
        for mi, m in enumerate(ms):
            spec = (specs[mi] if specs is not None
                    else _spec_of(parse_m(m)))
            # trace_parent: a router's fan-out id, so a hop's record
            # carries the id of the tree it belongs to.
            trace = (obs_trace.Trace(
                m, trace_id=q.get("trace_parent") or None)
                if do_trace else None)
            rs, plan, hit, ainfo = await loop.run_in_executor(
                self._pool, functools.partial(
                    self.executor.run_approx, spec, start, end, trace,
                    approx=aspec, rollup_only=degrade))
            # An ApproxInfo, or the rollup-stale dict of a degraded answer.
            ajson = (ainfo.as_json() if hasattr(ainfo, "as_json")
                     else ainfo)
            self._note_plan(plan, approx=ajson is not None)
            tdict = None
            if trace is not None:
                rec = make_record(
                    m, trace, plan, hit, slow_ms,
                    getattr(self.tsdb.store, "shard_count", 1) or 1, False)
                tdict = rec["trace"]
                # The ring holds every asked-for trace, every slow query
                # and the sampled baselines (flagged); threshold-only
                # traces of fast queries stay out.
                if sampled:
                    rec["sampled"] = True
                if want_trace or sampled or rec["slow"]:
                    self.trace_ring.add(rec)
                if rec["slow"]:
                    log_slow(rec)
            results.extend(rs)
            plans.extend([plan] * len(rs))
            cached.extend([hit] * len(rs))
            traces.extend([tdict] * len(rs))
            approx.extend([ajson] * len(rs))
        extra = {}
        if degraded:
            extra["X-Tsd-Degraded"] = degraded
        served = [a for a in approx if a]
        if served:
            # The declared approximation, header form: the kinds involved
            # and the worst reported relative bound.
            tagv = ",".join(sorted({a.get("kind", "?") for a in served}))
            rels = [a["rel_error"] for a in served
                    if isinstance(a.get("rel_error"), (int, float))]
            if rels:
                tagv += f";rel_error={max(rels):.6g}"
            extra["X-Tsd-Approx"] = tagv
        if "ascii" in q:
            return (200, "text/plain", self._ascii_output(results).encode(),
                    extra)
        return (200, "application/json",
                json.dumps(self._json_output(
                    results, plans, cached,
                    traces if want_trace else None, approx,
                    degraded, expert_label)).encode(), extra)

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
        # A rollup-served range declares its bound (the JAX daemon's
        # header).
        hdrs = {}
        ap = out.get("approx") if isinstance(out, dict) else None
        if ap:
            rel = ap.get("rel_error", 0)
            hdrs["X-Tsd-Approx"] = f"{ap.get('kind', '?')};rel_error={rel:.6g}"
        return 200, "application/json", json.dumps(out).encode(), hdrs

    async def _forecast(self, req) -> tuple:
        """Holt-Winters / EWMA forecasts and anomaly bands over a query's
        result series (no reference analog), as the JAX daemon answers
        them. Params: start, end, m= (each with a downsample, all with
        one interval: the model's bucket grid), horizon (future buckets,
        default 10), season (buckets, default 0), alpha / beta / gamma,
        nsigma (default 3), model (hw or ewma). The series come from the
        executor's ``run``; the model runs in one launch of the smoothing
        kernels (``models/forecast.py``). ``png`` is answered 400 "not
        yet ported"."""
        q, params = req.q, req.params
        if "start" not in q:
            raise BadRequestError("Missing parameter: start")
        now = int(time.time())
        tz = q.get("tz")
        start = timeparse.parse_date(q["start"], tz=tz, now=now)
        end = (timeparse.parse_date(q["end"], tz=tz, now=now)
               if q.get("end") else now)
        ms = params.get("m", [])
        if not ms:
            raise BadRequestError("Missing parameter: m")

        def num(name, default, lo, hi, as_int=False):
            try:
                v = float(q.get(name, default))
                if as_int:
                    v = int(v)
            except (ValueError, OverflowError):
                raise BadRequestError(
                    f"invalid '{name}' parameter") from None
            if not (lo <= v <= hi):
                raise BadRequestError(
                    f"'{name}' out of range [{lo}, {hi}]")
            return v

        opts = fcast.ForecastOpts(
            horizon=num("horizon", 10, 1, 10000, as_int=True),
            season=num("season", 0, 0, 10000, as_int=True),
            alpha=num("alpha", 0.3, 0.0, 1.0),
            beta=num("beta", 0.1, 0.0, 1.0),
            gamma=num("gamma", 0.1, 0.0, 1.0),
            nsigma=num("nsigma", 3.0, 0.1, 1000.0),
            model=q.get("model", "hw"))
        if opts.model not in ("hw", "ewma"):
            raise BadRequestError(f"unknown model: {opts.model}")
        loop = asyncio.get_running_loop()
        results = []
        interval = None
        for m in ms:
            parsed = parse_m(m)
            if not parsed.downsample:
                raise BadRequestError(
                    "forecast queries need a downsample interval "
                    "(e.g. m=sum:5m-avg:metric) to define the model grid")
            if interval is None:
                interval = parsed.downsample[0]
            elif interval != parsed.downsample[0]:
                raise BadRequestError(
                    "all m= specs must share one downsample interval")
            spec = QuerySpec(
                metric=parsed.metric, tags=parsed.tags,
                aggregator=parsed.aggregator, rate=parsed.rate,
                downsample=parsed.downsample, counter=parsed.counter,
                counter_max=parsed.counter_max,
                reset_value=parsed.reset_value)
            results.extend(await loop.run_in_executor(
                self._pool, self.executor.run, spec, start, end))
        if "png" in q:
            raise not_yet_ported("PNG forecast graphs (leave out &png)")

        def compute() -> bytes:
            grid = fcast.model_grid(results, start, end, interval)
            out = fcast.run_model(grid, opts, self.executor.device)
            return fcast.body(results, grid, out, opts)

        body = await loop.run_in_executor(self._pool, compute)
        return 200, "application/json", body, {}

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
    def _json_output(results, plans, cached, traces=None,
                     approx=None, degraded=None, expert=None) -> list:
        out = [{
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
        if expert:
            # Expert-path provenance, declared either way: "expert" when
            # the batch served through the mesh's expert buckets,
            # "expert-decline" when it was eligible for the attempt but
            # fell off the path and served serially.
            for ent in out:
                ent["plan"] = expert
        if degraded:
            for ent in out:
                ent["degraded"] = degraded
        if approx:
            # The error contract: a sketch-served answer carries its kind
            # and reported bound.
            for ent, ap in zip(out, approx):
                if ap:
                    ent["approx"] = ap
        if traces is not None:
            # ?trace=1 only: each sub-query's span tree, inline.
            for ent, tr in zip(out, traces):
                if tr is not None:
                    ent["trace"] = tr
        return out


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


# The /queries page: one self-contained page over the /api/queries feed,
# served from memory, auto-refreshing (the JAX daemon's).
_QUERIES_HTML = """<!doctype html>
<html><head><meta charset="utf-8"><title>tsd queries</title>
<style>
 body{font:13px/1.45 system-ui,sans-serif;margin:1.2em;background:#fafafa;
      color:#222}
 h1{font-size:1.2em;margin:0 0 .2em}
 h2{font-size:1em;margin:1.2em 0 .3em}
 table{border-collapse:collapse;background:#fff;min-width:30em}
 th,td{border:1px solid #ddd;padding:.25em .6em;text-align:left;
       font-variant-numeric:tabular-nums}
 th{background:#f0f0f0;font-weight:600}
 .ok{color:#0a7d32}.bad{color:#c0392b}.warn{color:#b8860b}
 #meta{color:#666;font-size:.9em;margin-bottom:.8em}
 .pill{display:inline-block;padding:0 .5em;border-radius:.8em;
       background:#eee;margin-right:.4em}
</style></head><body>
<h1>Query planner</h1>
<div id="meta">loading /api/queries&hellip;</div>
<div id="plans"></div><div id="sketch"></div>
<div id="rollup"></div><div id="caches"></div>
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
  document.getElementById("meta").innerHTML=
    "up "+t.uptime_s+"s &middot; refreshed "+
    new Date().toLocaleTimeString();
  var order=["raw","resident","fused","rollup","approx","expert",
             "expert-decline"];
  var p=t.plans||{};
  document.getElementById("plans").innerHTML=
    table("Plans served",["plan","results"],order.filter(function(k){
      return p[k];}).map(function(k){
        var cls=k==="approx"?" class='warn'":"";
        return ["<span"+cls+">"+esc(k)+"</span>", p[k]];}));
  var f=t.fused;
  if(f&&f.attempt){
    var dec=Object.keys(f.declines||{}).sort().map(function(k){
      return esc(k)+"="+esc(f.declines[k]);}).join(" ")||"none";
    var dc=f.devcache||{};
    document.getElementById("plans").innerHTML+=
      "<p>fused coverage: <b>"+(100*f.coverage).toFixed(1)+"%</b> ("+
      f.served+"/"+f.attempt+" batteries) &middot; declines: "+dec+
      " &middot; devcache hit/miss/evict: "+(dc.hit||0)+"/"+
      (dc.miss||0)+"/"+(dc.evict||0)+"</p>";
  }
  document.getElementById("sketch").innerHTML=
    pills("Sketch serving (error contract)", t.sketch||{});
  var r=t.rollup;
  if(r){
    var rows=Object.keys(r.sketch_alloc||{}).map(function(res){
      var a=r.sketch_alloc[res];
      return [esc(res),(r.hits||{})[res]||0,a.digest_k,a.moment_k,
              a.hll_p];});
    document.getElementById("rollup").innerHTML=
      table("Rollup tier "+(r.ready?"<span class='ok'>ready</span>"
        :"<span class='bad'>not ready</span>"),
        ["res","hits","digest_k","moment_k","hll_p"],rows)
      +pills("Fallbacks", r.fallbacks||{})
      +pills("Sketch bytes written", r.sketch_bytes||{});
  } else { document.getElementById("rollup").innerHTML=""; }
  var mesh=t.mesh||{};
  var cc=mesh.compile_cache||{};
  document.getElementById("caches").innerHTML=
    pills("Mesh execution ("+(mesh.devices||1)+" device"+
          ((mesh.devices||1)>1?"s":"")+
          (mesh.expert_enabled?", expert on":"")+")",
          {"compile cache":(cc.size||0)+" plans",
           "hit":cc.hit||0,"miss":cc.miss||0,
           "expert served":(mesh.expert||{}).serve||0,
           "expert declined":(mesh.expert||{}).decline||0})+
    pills("Fragment cache", t.qcache||{})+
    pills("Admission", t.admission||{});
}
function tick(){
  fetch("/api/queries").then(function(r){return r.json();})
    .then(render)
    .catch(function(e){document.getElementById("meta").innerHTML=
      "<span class='bad'>fetch failed: "+esc(e)+"</span>";});
}
tick(); setInterval(tick, 2000);
</script></body></html>
"""
