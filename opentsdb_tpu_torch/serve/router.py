"""The front-door query router: fan ``/q`` across replicas and stay up.

Mirrors ``opentsdb_tpu/serve/router.py`` of the JAX package, copied rather
than imported: ``Backend``, ``HopError`` and ``RouterServer`` with the same
routes, bodies, headers and ``router.*`` / ``cluster.handoffs``
instruments, so a router of either package fronts replicas of either.

A stateless asyncio daemon (``tsd --role router``) in front of N
replica daemons (and optionally the writer for forwarded puts). It
holds no storage and imports neither torch nor the storage engine
(``storage/``, ``core/``): a router restarts in well under a second,
which is the point: the failure domain of the front door is as small as
it can be. The replicas behind it answer each hop on their card.

Request handling, in contract order:

- **Ownership**: each ``m=`` sub-query routes to the replica that owns
  its spec's series hash (``sstable.series_hash``'s crc32 chain, which
  the shard router and the blooms use, computed here without the
  storage module), so repeat dashboards hit the same replica's warm
  fragment cache instead of spreading cold decodes over the fleet. The
  split weights each backend by the serving-mesh width it reports in
  ``/healthz`` (its resident hot-set shards, ``--devwindow-shards``), so
  a wider backend owns proportionally more of the series space; a
  uniform fleet is the plain modulo.
- **Deadlines**: one budget per request (``Config.router_deadline_ms``);
  every hop gets the remainder, so a wedged replica costs bounded time.
- **Retries**: a failed/expired hop retries on the NEXT healthy
  replica with capped exponential backoff (``router_retries``,
  ``router_backoff_ms``), never the same replica twice in a row.
- **Hedging**: when a hop is slower than the hedge delay (fixed
  ``router_hedge_ms``, or derived from the observed p95 hop latency
  when 0), a duplicate fires at the next replica; first response wins
  and the loser is CANCELLED (recorded as a cancelled child span in
  the trace tree).
- **Health**: a background probe hits every replica's ``/healthz``
  each ``probe_interval_s``; ``router_eject_after`` consecutive
  failures eject it from rotation, the next healthy probe readmits
  it. Stale-but-alive replicas stay usable at lowest preference, and
  their answers keep the ``degraded`` tag they arrived with. The same
  loop drives writer failover (``cluster/promote.py``).
- **Admission**: the same per-tenant query buckets + in-flight ladder
  as the daemons (sans the rollup-only step, which is the replicas'
  job): the router sheds with 429/503 + Retry-After before its own
  event loop drowns, and at the ladder's degraded step asks each hop
  for ``degrade=rollup-only``.

Telnet connections are sniffed exactly like the TSD and ``put`` lines
forward to ``Config.writer_url`` (or, with several writers, to the
owner of the metric's slot in ``CLUSTER.json``) under ingest
admission; everything else about writes stays the writer's business.
"""

from __future__ import annotations

import asyncio
import json
import logging
import os
import time
import urllib.parse
import zlib

from opentsdb_tpu_torch.build_data import version_string
from opentsdb_tpu_torch.cluster.ownership import OwnershipMap, slot_of
from opentsdb_tpu_torch.cluster.promote import PromotionManager
from opentsdb_tpu_torch.obs import trace as obs_trace
from opentsdb_tpu_torch.obs.registry import METRICS
from opentsdb_tpu_torch.obs.ring import TraceRing
from opentsdb_tpu_torch.serve.admission import (DEGRADE, SHED_LOAD,
                                                SHED_QUOTA,
                                                AdmissionController)
from opentsdb_tpu_torch.stats.collector import LatencyDigest, StatsCollector
from opentsdb_tpu_torch.utils.lru import LRUCache

LOG = logging.getLogger(__name__)

_M_FANOUTS = METRICS.counter("router.fanouts")
_M_RETRIES = METRICS.counter("router.retries")
_M_HEDGES = METRICS.counter("router.hedges")
_M_HEDGE_WINS = METRICS.counter("router.hedge_wins")
_M_EJECTED = METRICS.counter("router.ejections")
_M_READMITTED = METRICS.counter("router.readmissions")
_M_HOP = METRICS.timer("router.hop")
_M_ERRORS = METRICS.counter("router.hop_errors")
_M_RCACHE_HIT = METRICS.counter("router.rcache.hit")
_M_RCACHE_MISS = METRICS.counter("router.rcache.miss")
_M_HANDOFFS = METRICS.counter("cluster.handoffs")

# Hedge-delay bounds when derived from the p95: never hedge absurdly
# early (doubling every request's load) nor later than half the
# remaining budget (a hedge that can't finish is noise).
_HEDGE_FLOOR_MS = 10.0


def series_hash(name: bytes) -> int:
    """``storage/sstable.series_hash``: crc32 of the name (stable across
    processes, restarts and builds, never ``hash()``), kept here so the
    router does not load the storage engine."""
    return zlib.crc32(name)


class Backend:
    """One replica as the router sees it."""

    def __init__(self, url: str) -> None:
        self.url = url.rstrip("/")
        parsed = urllib.parse.urlsplit(self.url)
        if parsed.scheme != "http" or not parsed.hostname:
            raise ValueError(f"backend must be http://host:port, "
                             f"got {url!r}")
        self.host = parsed.hostname
        self.port = parsed.port or 80
        self.healthy = True          # in rotation?
        self.stale = False           # serving, but beyond its contract
        self.consecutive_fails = 0
        self.probes = 0
        self.latency = LatencyDigest()
        self.last_health: dict = {}

    def snapshot(self) -> dict:
        return {"url": self.url, "healthy": self.healthy,
                "stale": self.stale,
                "consecutive_fails": self.consecutive_fails,
                "hop_p95_ms": round(self.latency.percentile(95), 3)
                if self.latency.count else None,
                "health": self.last_health}


class HopError(Exception):
    """One backend hop failed (connect/timeout/5xx); retryable."""


async def _http_fetch(host: str, port: int, target: str,
                      timeout_s: float) -> tuple[int, dict, bytes]:
    """Minimal one-shot HTTP/1.0-style GET (Connection: close). The
    router's hops are coarse (one per sub-query), so per-hop connection
    setup is noise next to the query itself — and one-shot connections
    make cancellation trivially safe: closing the socket IS the
    cancel."""

    async def _go():
        reader, writer = await asyncio.open_connection(host, port)
        try:
            writer.write((f"GET {target} HTTP/1.1\r\n"
                          f"Host: {host}:{port}\r\n"
                          f"Connection: close\r\n\r\n").encode())
            await writer.drain()
            raw = await reader.read()
        finally:
            writer.close()
            try:
                await writer.wait_closed()
            except Exception:
                pass
        head, sep, body = raw.partition(b"\r\n\r\n")
        if not sep:
            raise HopError(f"short response from {host}:{port}")
        lines = head.decode("latin-1").split("\r\n")
        status = int(lines[0].split(" ", 2)[1])
        headers = {}
        for ln in lines[1:]:
            k, _, v = ln.partition(":")
            headers[k.strip().lower()] = v.strip()
        return status, headers, body

    try:
        return await asyncio.wait_for(_go(), timeout=timeout_s)
    except asyncio.TimeoutError:
        raise HopError(
            f"hop to {host}:{port} exceeded {timeout_s * 1000:.0f}ms "
            f"deadline") from None
    except OSError as e:
        raise HopError(f"hop to {host}:{port} failed: {e}") from None


class RouterServer:
    def __init__(self, config) -> None:
        self.config = config
        # Multi-writer mode (cluster/ownership.py): with N writers,
        # the ownership map drives BOTH ingest fan-out (each put line
        # routes to the writer owning its metric's hash slot) and read
        # fan-out (each sub-query hops to every writer in its slot's
        # owner history and the answers merge). The map is loaded from
        # Config.cluster_map when the file exists, else built as an
        # equal split and persisted there.
        writers = list(getattr(config, "router_writers", ()) or ())
        self.cluster_map_path = getattr(config, "cluster_map", None)
        self.ownership: OwnershipMap | None = None
        if self.cluster_map_path and \
                os.path.exists(self.cluster_map_path):
            self.ownership = OwnershipMap.load(self.cluster_map_path)
            if writers and list(self.ownership.writers) != \
                    [w.rstrip("/") for w in writers]:
                raise ValueError(
                    f"--writers disagrees with the cluster map at "
                    f"{self.cluster_map_path!r} "
                    f"({self.ownership.writers}); edit the map, not "
                    f"the flag (slot history would dangle)")
        elif len(writers) > 1:
            self.ownership = OwnershipMap(
                writers,
                slots=int(getattr(config, "cluster_slots", 64) or 64))
            if self.cluster_map_path:
                self.ownership.save(self.cluster_map_path)
        self.writer_backends = [Backend(u) for u in
                                (self.ownership.writers
                                 if self.ownership else writers)]
        backends = list(getattr(config, "router_backends", ()) or ())
        if not backends:
            if self.writer_backends:
                # Writer-serves-reads topology: the writers ARE the
                # read backends (the bench_serve --writers shape).
                backends = [b.url for b in self.writer_backends]
            else:
                raise ValueError("router role needs --backends "
                                 "(comma-separated replica URLs) or "
                                 "--writers")
        self.backends = [Backend(u) for u in backends]
        self.writer_url = getattr(config, "writer_url", None)
        if not self.writer_url and len(writers) == 1:
            # A lone --writers entry is just the writer (ingest
            # forwards there; no ownership map needed).
            self.writer_url = writers[0]
        self._writer = Backend(self.writer_url) if self.writer_url \
            else None
        # Failover (cluster/promote.py): probes the writer,
        # promotes a replica past the grace, demotes the deposed one
        # on return. Constructed whenever there IS a writer; inert
        # unless Config.writer_grace_ms > 0 (or a fenced writer shows
        # up in a probe).
        self.promotion = PromotionManager(self) if self._writer \
            else None
        self.admission = AdmissionController(config)
        self.trace_ring = TraceRing(getattr(config, "trace_ring", 256))
        # Bounded result cache (the fragment-cache stamp discipline at
        # the router): full-service JSON answers keyed by (normalized
        # query, ownership-map epoch, staleness bound). Repeat
        # dashboard fan-ins stop re-hitting replicas every poll; an
        # ownership handoff bumps the map epoch and orphans every
        # entry computed under the old layout.
        n_rcache = int(getattr(config, "router_rcache", 0) or 0)
        self.rcache = LRUCache(n_rcache) if n_rcache > 0 else None
        self.rcache_ms = float(getattr(config, "router_rcache_ms",
                                       1000.0) or 1000.0)
        self._server: asyncio.AbstractServer | None = None
        self._shutdown = asyncio.Event()
        self._probe_task: asyncio.Task | None = None
        self.start_time = int(time.time())
        self.http_rpcs = 0
        self.telnet_lines_forwarded = 0

    # ------------------------------------------------------------------
    # Lifecycle
    # ------------------------------------------------------------------

    async def start(self) -> None:
        self._server = await asyncio.start_server(
            self._handle_conn, self.config.bind, self.config.port)
        self._probe_task = asyncio.create_task(self._probe_loop())
        LOG.info("Router ready on %s:%d over %d backends",
                 self.config.bind, self.port, len(self.backends))

    async def serve_forever(self) -> None:
        if self._server is None:
            await self.start()
        await self._shutdown.wait()
        await self.stop()

    async def stop(self) -> None:
        if self._probe_task is not None:
            self._probe_task.cancel()
            try:
                await self._probe_task
            except (asyncio.CancelledError, Exception):
                pass
            self._probe_task = None
        if self._server is not None:
            self._server.close()
            await self._server.wait_closed()
            self._server = None

    def request_shutdown(self) -> None:
        self._shutdown.set()

    @property
    def port(self) -> int:
        return self._server.sockets[0].getsockname()[1]

    # ------------------------------------------------------------------
    # Health probing: ejection + readmission
    # ------------------------------------------------------------------

    async def _probe_loop(self) -> None:
        interval = float(getattr(self.config, "probe_interval_s", 1.0))
        while True:
            probes = [self._probe_one(b) for b in self.backends]
            if self.promotion is not None:
                # The failover manager rides the same cadence: writer
                # health, the promotion grace, and the demote-on-
                # return handshake (cluster/promote.py).
                probes.append(self.promotion.probe_writer())
            await asyncio.gather(*probes, return_exceptions=True)
            await asyncio.sleep(interval)

    async def _probe_one(self, b: Backend) -> None:
        b.probes += 1
        try:
            status, _, body = await _http_fetch(
                b.host, b.port, "/healthz", timeout_s=2.0)
            health = json.loads(body)
        except (HopError, ValueError):
            self._note_failure(b)
            return
        b.last_health = health
        b.consecutive_fails = 0
        # 503 + stale is a REPLICA KEEPING ITS CONTRACT, not a dead
        # box: keep it at lowest preference (its answers carry the
        # degraded tag) instead of pretending it's gone.
        b.stale = bool(health.get("stale"))
        if not b.healthy:
            b.healthy = True
            _M_READMITTED.inc()
            LOG.info("backend %s readmitted", b.url)

    def _note_failure(self, b: Backend) -> None:
        b.consecutive_fails += 1
        eject_after = int(getattr(self.config, "router_eject_after",
                                  3) or 3)
        if b.healthy and b.consecutive_fails >= eject_after:
            b.healthy = False
            _M_EJECTED.inc()
            LOG.warning("backend %s ejected after %d failures",
                        b.url, b.consecutive_fails)

    def _candidates(self, owner: int) -> list[Backend]:
        """Attempt order for a sub-query owned by backend index
        ``owner``: the owner first, then the ring — healthy-and-fresh
        before healthy-but-stale before ejected (a fully dark fleet
        still gets ONE desperate attempt rather than an instant 502)."""
        ring = [self.backends[(owner + i) % len(self.backends)]
                for i in range(len(self.backends))]
        fresh = [b for b in ring if b.healthy and not b.stale]
        stale = [b for b in ring if b.healthy and b.stale]
        dark = [b for b in ring if not b.healthy]
        return fresh + stale + dark

    # ------------------------------------------------------------------
    # Connection handling (the TSD's first-byte sniff)
    # ------------------------------------------------------------------

    async def _handle_conn(self, reader, writer) -> None:
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
            LOG.exception("router connection error")
        finally:
            try:
                writer.close()
                await writer.wait_closed()
            except Exception:
                pass

    # ------------------------------------------------------------------
    # Telnet: forward puts to the writer under ingest admission
    # ------------------------------------------------------------------

    def _ingest_target(self, text: str) -> Backend | None:
        """Which writer a ``put`` line belongs to. Single-writer:
        the (possibly failed-over) forwarding target. Multi-writer:
        the ownership map routes by the metric's series hash — the
        same crc32 chain the storage sharder and the TSST3 blooms
        use, one level up."""
        if self.ownership is None:
            return self._writer
        parts = text.split(" ", 2)
        if len(parts) < 2 or not parts[1]:
            return self.writer_backends[0]  # malformed; let a writer
            #                                 produce the error line
        return self.writer_backends[
            self.ownership.owner(parts[1].encode())]

    async def _handle_telnet(self, first: bytes, reader, writer) -> None:
        # One lazily-opened upstream per writer URL: a multi-writer
        # cluster fans one client connection across N owner writers.
        upstreams: dict[str, tuple] = {}
        # Connection-scoped tenant: a `tenant <id>` line binds every
        # later put AND is replayed ahead of the forwarded stream on
        # each upstream connection, so the writer's admission buckets
        # and cardinality accounting see the same id the client told
        # the router — attribution no longer stops at the front door.
        tenant = "default"
        try:
            buf = first
            while True:
                nl = buf.find(b"\n")
                if nl < 0:
                    chunk = await reader.read(1 << 16)
                    if not chunk:
                        return
                    buf += chunk
                    continue
                line, buf = buf[:nl], buf[nl + 1:]
                text = line.decode("utf-8", "replace").rstrip("\r")
                if text == "version":
                    writer.write(
                        f"router {version_string()}".encode())
                    await writer.drain()
                    continue
                if text == "exit":
                    return
                if text == "tenant" or text.startswith("tenant "):
                    parts = text.split()
                    if len(parts) == 2 and parts[1]:
                        tenant = parts[1]
                        # Already-open upstreams switch in-stream
                        # (ordering preserved: the line lands before
                        # any later put on the same connection).
                        for _r, up_w in upstreams.values():
                            up_w.write(f"tenant {tenant}\n".encode())
                        writer.write(f"tenant {tenant}\n".encode())
                    else:
                        writer.write(b"tenant: need exactly one id\n")
                    await writer.drain()
                    continue
                if not text.startswith("put "):
                    writer.write(b"unknown command: "
                                 + text.split(" ", 1)[0].encode()
                                 + b"\n")
                    await writer.drain()
                    continue
                target = self._ingest_target(text)
                if target is None:
                    writer.write(b"put: no writer configured on this "
                                 b"router\n")
                    await writer.drain()
                    continue
                wait = self.admission.admit_ingest(1, tenant)
                if wait > 0:
                    writer.write(
                        f"put: Please throttle writes: over ingest "
                        f"quota, retry after {max(wait, 0.1):.1f}s\n"
                        .encode())
                    await writer.drain()
                    continue
                try:
                    upstream = upstreams.get(target.url)
                    if upstream is None:
                        upstream = await asyncio.open_connection(
                            target.host, target.port)
                        upstreams[target.url] = upstream
                        if tenant != "default":
                            # Fresh upstream: replay the attribution
                            # before the first forwarded put.
                            upstream[1].write(
                                f"tenant {tenant}\n".encode())
                    upstream[1].write(line + b"\n")
                    await upstream[1].drain()
                    self.telnet_lines_forwarded += 1
                finally:
                    self.admission.ingest_done(1)
        finally:
            for up_reader, up_writer in upstreams.values():
                # Drain each writer's error lines (if any) back to the
                # client before closing — they're the put's only ack.
                try:
                    up_writer.write_eof()
                    back = await asyncio.wait_for(up_reader.read(),
                                                  timeout=5.0)
                    # Swallow the `tenant <id>` acks our own
                    # attribution replays provoked (the router is this
                    # upstream's only writer, so any tenant line here
                    # is ours, and the client already got the
                    # router's ack); everything else is a put error
                    # the client must see.
                    keep = [ln for ln in back.split(b"\n")
                            if ln and not ln.startswith(b"tenant ")]
                    if keep:
                        writer.write(b"\n".join(keep) + b"\n")
                        await writer.drain()
                except Exception:
                    pass
                up_writer.close()

    # ------------------------------------------------------------------
    # HTTP
    # ------------------------------------------------------------------

    async def _handle_http(self, first: bytes, reader, writer) -> None:
        data = first
        while True:
            while b"\r\n\r\n" not in data:
                chunk = await reader.read(4096)
                if not chunk:
                    return
                data += chunk
                if len(data) > 65536:
                    await self._respond(writer, 431, "text/plain",
                                        b"headers too large\n", {},
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
            keep = (version.strip().upper() == "HTTP/1.1"
                    and headers.get("connection", "").lower()
                    != "close")
            self.http_rpcs += 1
            try:
                status, ctype, body, extra = await self._route(target)
            except Exception as e:
                LOG.exception("router error on %s", target)
                status, ctype, body, extra = (
                    500, "text/plain",
                    f"router error: {e}\n".encode(), {})
            await self._respond(writer, status, ctype, body, extra,
                                keep)
            if not keep:
                return

    async def _respond(self, writer, status, ctype, body, extra,
                       keep) -> None:
        reason = {200: "OK", 400: "Bad Request", 404: "Not Found",
                  429: "Too Many Requests", 500: "Internal Server Error",
                  502: "Bad Gateway",
                  503: "Service Unavailable"}.get(status, "OK")
        hdrs = [f"HTTP/1.1 {status} {reason}",
                f"Content-Type: {ctype}",
                f"Content-Length: {len(body)}",
                f"Connection: {'keep-alive' if keep else 'close'}"]
        for k, v in extra.items():
            hdrs.append(f"{k}: {v}")
        writer.write(("\r\n".join(hdrs) + "\r\n\r\n").encode() + body)
        await writer.drain()

    async def _route(self, target: str):
        parsed = urllib.parse.urlsplit(target)
        path = parsed.path.rstrip("/") or "/"
        params = urllib.parse.parse_qs(parsed.query,
                                       keep_blank_values=True)
        q = {k: v[-1] for k, v in params.items()}
        if path == "/q":
            return await self._query(parsed.query, q, params)
        if path == "/healthz":
            return self._healthz()
        if path == "/stats":
            return self._stats(q)
        if path == "/metrics":
            body = METRICS.prometheus_text(
                extra_lines=self._collect_stats())
            return (200, "text/plain; version=0.0.4; charset=utf-8",
                    body.encode(), {})
        if path == "/api/traces":
            records = self.trace_ring.snapshot()
            return (200, "application/json",
                    json.dumps(records).encode(), {})
        if path == "/api/topology":
            return self._topology()
        if path == "/topology":
            return (200, "text/html; charset=UTF-8",
                    _TOPOLOGY_HTML.encode(), {})
        if path == "/api/cluster/handoff":
            return await self._handoff(q)
        if path == "/api/tenants":
            # Tenant accounting lives on the WRITER(s) (the admission
            # point); proxy there so the control plane has one front
            # door. Replicas answer enabled:false, so the replica
            # fallback below still yields a well-formed body.
            # When a writer IS configured but unreachable, the outage
            # is DECLARED (503) — falling through to a replica would
            # answer a healthy-looking enabled:false, and monitoring
            # could not tell a config choice from a down writer. The
            # replica fallback serves only the no-writer-configured
            # router shape.
            if self._writer is not None:
                try:
                    status, headers, body = await _http_fetch(
                        self._writer.host, self._writer.port, target,
                        timeout_s=5.0)
                    return (status,
                            headers.get("content-type",
                                        "application/json"), body, {})
                except HopError:
                    return (503, "application/json", json.dumps({
                        "error": "writer unreachable",
                        "writer": self._writer.url}).encode(), {})
            if self.writer_backends:
                merged = await self._tenants_fanout(target)
                if merged is None:
                    return (503, "application/json", json.dumps({
                        "error": "no writer reachable",
                        "writers": len(self.writer_backends)}).encode(),
                        {})
                return (200, "application/json",
                        json.dumps(merged).encode(), {})
            return await self._proxy_any(target)
        if path in ("/aggregators", "/version", "/suggest"):
            # Storage-free passthroughs any healthy replica answers.
            return await self._proxy_any(target)
        return 404, "text/plain", b"Page Not Found\n", {}

    async def _tenants_fanout(self, target: str) -> dict | None:
        """Multi-writer /api/tenants: every owner accounts its own
        ownership-disjoint slice of the series space, so per-tenant
        series/points/refusal counts SUM exactly across writers;
        heavy-hitter summaries merge by key with count+err addition
        (the standard SpaceSaving merge — errors stay upper bounds);
        a tenant's tier degrades to hll (max declared error) when any
        writer's slice is past its cutoff. Unreachable or
        accounting-off writers are DECLARED via writers_unreachable,
        never silently averaged away. Returns None when no writer
        answered with accounting enabled (caller falls back)."""
        outs = await asyncio.gather(
            *(_http_fetch(b.host, b.port, target, timeout_s=5.0)
              for b in self.writer_backends),
            return_exceptions=True)
        bodies = []
        unreachable = disabled = 0
        for out in outs:
            if isinstance(out, BaseException):
                unreachable += 1
                continue
            status, _headers, body = out
            try:
                data = json.loads(body) if status == 200 else None
            except ValueError:
                data = None
            if data is None:
                unreachable += 1
            elif data.get("enabled"):
                bodies.append(data)
            else:
                disabled += 1
        if not bodies:
            if disabled:
                # Writers answered — accounting is genuinely off
                # fleet-wide (or on none of the reachable ones); a
                # truthful enabled:false, not an outage.
                return {"enabled": False,
                        "writers": len(self.writer_backends),
                        "writers_unreachable": unreachable}
            return None

        def _merge_hh(key: str, ents: list[dict], label: str,
                      weight: str) -> list[dict]:
            acc: dict[str, list[int]] = {}
            for ent in ents:
                for row in ent.get(key, ()):
                    slot = acc.setdefault(str(row[label]), [0, 0])
                    slot[0] += int(row[weight])
                    slot[1] += int(row.get("err", 0))
            ranked = sorted(acc.items(), key=lambda kv: -kv[1][0])
            width = max((len(ent.get(key, ())) for ent in ents),
                        default=0)
            return [{label: k, weight: c, "err": e}
                    for k, (c, e) in ranked[:width]]

        tenants: dict[str, dict] = {}
        for data in bodies:
            for name, ent in data.get("tenants", {}).items():
                t = tenants.get(name)
                if t is None:
                    tenants[name] = t = {
                        "series": 0, "tier": "exact", "error": 0.0,
                        "points": 0, "refused": 0, "would_refuse": 0,
                        "_hh": []}
                    if "limit" in ent:
                        t["limit"] = ent["limit"]
                t["series"] += int(ent.get("series", 0))
                t["points"] += int(ent.get("points", 0))
                t["refused"] += int(ent.get("refused", 0))
                t["would_refuse"] += int(ent.get("would_refuse", 0))
                if ent.get("tier") == "hll":
                    t["tier"] = "hll"
                t["error"] = max(t["error"],
                                 float(ent.get("error", 0.0)))
                t["_hh"].append(ent)
        for t in tenants.values():
            ents = t.pop("_hh")
            t["top_series"] = _merge_hh("top_series", ents,
                                        "series", "points")
            t["top_prefixes"] = _merge_hh("top_prefixes", ents,
                                          "prefix", "new_series")
        first = bodies[0]
        merged = {
            "enabled": True,
            "tenants": tenants,
            "total_series": sum(int(d.get("total_series", 0))
                                for d in bodies),
            "tracked_series": sum(int(d.get("tracked_series", 0))
                                  for d in bodies),
            "recovered_series": sum(int(d.get("recovered_series", 0))
                                    for d in bodies),
            "snapshots_written": sum(
                int(d.get("snapshots_written", 0)) for d in bodies),
            "exact_cutoff": first.get("exact_cutoff"),
            "hll_p": first.get("hll_p"),
            "writers": len(self.writer_backends),
            "writers_unreachable": unreachable,
        }
        for k in ("mode", "global_limit"):
            if k in first:
                merged[k] = first[k]
        return merged

    def _healthz(self) -> tuple:
        ok = any(b.healthy for b in self.backends)
        body = {
            "role": "router",
            "ok": ok,
            "backends": [b.snapshot() for b in self.backends],
            "uptime_s": int(time.time()) - self.start_time,
            "inflight_queries": self.admission.inflight_queries,
        }
        return (200 if ok else 503, "application/json",
                json.dumps(body).encode(), {})

    def _topology(self) -> tuple:
        """The cluster-state dashboard feed: writers (+ epoch,
        failover history), every read backend with its measured lag /
        ejection state / hop latency, hedge + retry counters, and the
        ownership map — everything a topology view needs without
        scraping and correlating /stats text."""
        # Health by URL: in multi-writer mode the probed Backend
        # objects live in self.backends (writers serve reads), not in
        # the writer_backends copies — resolve through both so the
        # writers array carries real probe data.
        by_url = {b.url: b.last_health for b in self.backends}
        if self._writer is not None:
            by_url.setdefault(self._writer.url,
                              self._writer.last_health)
        writers = []
        if self._writer is not None:
            writers.append({"url": self._writer.url,
                            "health": by_url.get(
                                self._writer.url,
                                self._writer.last_health)})
        for b in self.writer_backends:
            if self._writer is None or b.url != self._writer.url:
                writers.append({"url": b.url,
                                "health": by_url.get(b.url,
                                                     b.last_health)})
        replicas = []
        for b in self.backends:
            h = b.last_health or {}
            replicas.append({
                "url": b.url,
                "healthy": b.healthy,
                "ejected": not b.healthy,
                "stale": b.stale,
                "consecutive_fails": b.consecutive_fails,
                "lag_ms": h.get("lag_ms"),
                "writer_epoch": h.get("writer_epoch"),
                "hop_p95_ms": round(b.latency.percentile(95), 3)
                if b.latency.count else None,
            })
        body = {
            "role": "router",
            "writers": writers,
            "replicas": replicas,
            "promotion": self.promotion.snapshot()
            if self.promotion else None,
            "ownership": self.ownership.snapshot()
            if self.ownership else None,
            "counters": {
                "hedges": METRICS.counter("router.hedges").value,
                "hedge_wins": METRICS.counter("router.hedge_wins").value,
                "retries": METRICS.counter("router.retries").value,
                "ejections": METRICS.counter("router.ejections").value,
                "readmissions":
                    METRICS.counter("router.readmissions").value,
                "rcache_hit": _M_RCACHE_HIT.value,
                "rcache_miss": _M_RCACHE_MISS.value,
            },
            "uptime_s": int(time.time()) - self.start_time,
        }
        return (200, "application/json", json.dumps(body).encode(),
                {})

    async def _handoff(self, q) -> tuple:
        """Shard handoff: drain-then-transfer one ownership slot (or a
        metric's slot) to another writer, committed as an ownership-
        map epoch bump. The router is the single ingest door, so the
        drain is local: flush nothing-left-in-flight semantics come
        from the per-connection forwarding being synchronous (a line
        is drained to the old owner before the next is read); the
        map flip below happens atomically on this event loop, so no
        two writers ever receive the same slot concurrently."""
        if self.ownership is None:
            return (400, "text/plain",
                    b"not a multi-writer cluster (no ownership map)\n",
                    {})
        if "metric" in q:
            slot = slot_of(q["metric"].encode(), self.ownership.slots)
        elif "slot" in q:
            try:
                slot = int(q["slot"])
            except ValueError:
                return (400, "text/plain", b"slot must be an integer\n",
                        {})
        else:
            return (400, "text/plain",
                    b"need slot= or metric= and to=\n", {})
        try:
            to = int(q.get("to", ""))
        except ValueError:
            return (400, "text/plain", b"need to=<writer index>\n", {})
        snap = self.ownership.snapshot()
        try:
            old = self.ownership.assign[slot]
            self.ownership.transfer(slot, to)
        except (ValueError, IndexError) as e:
            return (400, "text/plain", f"{e}\n".encode(), {})
        if self.cluster_map_path:
            try:
                self.ownership.save(self.cluster_map_path)
            except Exception:
                # Commit failed: the flip must not outlive the crash-
                # durable map — restore the WHOLE pre-transfer view
                # (assign, epoch, AND the history entry transfer
                # appended; a leaked history entry would fan every
                # later read of this slot to a writer that never
                # owned it).
                self.ownership.assign = list(snap["assign"])
                self.ownership.history = [list(h) for h in
                                          snap["history"]]
                self.ownership.epoch = snap["epoch"]
                raise
        _M_HANDOFFS.inc()
        LOG.warning("handoff: slot %d writer %d -> %d (map epoch %d)",
                    slot, old, to, self.ownership.epoch)
        return (200, "application/json", json.dumps({
            "slot": slot, "from": old, "to": to,
            "epoch": self.ownership.epoch}).encode(), {})

    def _collect_stats(self) -> list[str]:
        c = StatsCollector("tsd")
        c.record("router.backends", len(self.backends))
        c.record("router.backends_healthy",
                 sum(1 for b in self.backends if b.healthy))
        c.record("router.http_rpcs", self.http_rpcs)
        c.record("router.put_lines_forwarded",
                 self.telnet_lines_forwarded)
        c.record("uptime_s", int(time.time()) - self.start_time)
        if self.ownership is not None:
            c.record("cluster.map_epoch", self.ownership.epoch)
            c.record("cluster.writers", len(self.ownership.writers))
        if self.promotion is not None:
            c.record("cluster.epoch", self.promotion.epoch)
        if self.rcache is not None:
            c.record("router.rcache.entries", len(self.rcache))
        self.admission.collect_stats(c)
        METRICS.collect(c)
        return c.lines

    def _stats(self, q) -> tuple:
        lines = self._collect_stats()
        if "json" in q:
            return (200, "application/json",
                    json.dumps(lines).encode(), {})
        return (200, "text/plain",
                ("\n".join(lines) + "\n").encode(), {})

    async def _proxy_any(self, target: str) -> tuple:
        for b in self._candidates(0):
            try:
                status, headers, body = await _http_fetch(
                    b.host, b.port, target, timeout_s=5.0)
            except HopError:
                self._note_failure(b)
                continue
            return (status,
                    headers.get("content-type", "text/plain"), body,
                    {})
        return 502, "text/plain", b"no healthy backend\n", {}

    # ------------------------------------------------------------------
    # /q: ownership fan-out + deadlines + retries + hedging
    # ------------------------------------------------------------------

    async def _query(self, query_string: str, q, params) -> tuple:
        ms = params.get("m", [])
        if not ms or "start" not in q:
            return (400, "text/plain",
                    b"Missing parameter: start and m\n", {})
        verdict, retry = self.admission.admit_query(
            q.get("tenant", "default"))
        if verdict == SHED_QUOTA:
            return (429, "text/plain", b"query quota exceeded\n",
                    {"Retry-After": str(max(1, round(retry + 0.5)))})
        if verdict == SHED_LOAD:
            return (503, "text/plain",
                    b"router shedding load\n",
                    {"Retry-After": str(max(1, round(retry + 0.5)))})
        try:
            # Router-side result cache: the fragment-cache stamp
            # discipline one level up. The key carries the ownership-
            # map epoch (a handoff orphans every entry computed under
            # the old layout) and the staleness bound; entries expire
            # at router_rcache_ms — the bound IS the declared promise,
            # not a TTL guess. Admission runs first so quotas and the
            # ladder still bite; degraded/traced answers never cache.
            cache_key = None
            if (self.rcache is not None and "nocache" not in q
                    and q.get("trace", "0") in ("", "0")
                    and verdict != DEGRADE):
                epoch = (self.ownership.epoch if self.ownership
                         else self.promotion.epoch if self.promotion
                         else 0)
                norm = tuple(sorted(
                    (k, v) for k, v in
                    urllib.parse.parse_qsl(query_string,
                                           keep_blank_values=True)))
                cache_key = (norm, epoch, int(self.rcache_ms))
                hit = self.rcache.get(cache_key)
                if hit is not None and time.monotonic() < hit[0]:
                    _M_RCACHE_HIT.inc()
                    return hit[1], hit[2], hit[3], hit[4]
                _M_RCACHE_MISS.inc()
            out = await self._query_admitted(
                query_string, q, params, ms,
                degrade=(verdict == DEGRADE))
            if cache_key is not None:
                status, ctype, body, extra = out
                # Approximate answers never cache either: the contract
                # is per-request (opt-in + budget), and a cached body
                # would keep serving the approximation to callers who
                # asked for exact.
                if status == 200 and "X-Tsd-Degraded" not in extra \
                        and "X-Tsd-Approx" not in extra:
                    self.rcache.put(
                        cache_key,
                        (time.monotonic() + self.rcache_ms / 1000.0,
                         status, ctype, body, extra))
            return out
        finally:
            self.admission.query_done()

    async def _query_admitted(self, query_string: str, q, params, ms,
                              degrade: bool) -> tuple:
        _M_FANOUTS.inc()
        want_trace = q.get("trace", "0") not in ("", "0")
        trace_id = obs_trace.new_trace_id()
        deadline = time.monotonic() + float(
            getattr(self.config, "router_deadline_ms", 10_000)) / 1000.0
        want_json = "json" in q or want_trace
        png = not ("json" in q or "ascii" in q)

        base = {k: v for k, v in
                urllib.parse.parse_qsl(query_string,
                                       keep_blank_values=True)
                if k != "m"}
        # Hops always speak JSON (the only mergeable body); the
        # client-facing format is rebuilt from the merged results.
        base.pop("ascii", None)
        base.pop("png", None)
        base.pop("trace", None)
        base.pop("trace_parent", None)
        if want_trace:
            base["trace"] = "1"
            base["trace_parent"] = trace_id
        if degrade:
            # The router's degraded ladder step IS the daemon's: strip
            # trace work and tell the replicas to serve rollup-only
            # (no raw stitching; raw-only queries come back 503 +
            # Retry-After, which is the declared contract — "reject
            # raw-stitch work first").
            base.pop("trace", None)
            base.pop("trace_parent", None)
            base["degrade"] = "rollup-only"
            want_trace = False

        if png:
            # PNG rendering can't be merged across hops: proxy the
            # whole query to one owner replica (retries still apply).
            # Built from the REWRITTEN base, not the raw query string:
            # the degradation ladder must bite the default output
            # format too, or browser dashboards dodge load shedding.
            target = "/q?" + urllib.parse.urlencode(
                list(base.items()) + [("m", m) for m in ms])
            if self.ownership is not None:
                # PNG can only proxy whole; that is correct ONLY when
                # every sub-query's full owner history is one writer.
                # Anything else would render with other owners' series
                # silently absent — refuse loudly instead (the JSON
                # path merges fine).
                idxs = {i for m in ms for i in self.ownership.readers(
                    self._m_metric(m).encode())}
                if len(idxs) > 1:
                    return (400, "text/plain",
                            b"PNG output cannot merge across writer "
                            b"ownership; add &json or &ascii\n", {})
                b = self.writer_backends[idxs.pop()]
                status, ctype, body, extra, _spans = \
                    await self._hop_writer(b, target, deadline,
                                           sub=ms[0])
            else:
                owner = self._owner_index(ms[0])
                status, ctype, body, extra, _spans = await self._hop(
                    target, owner, deadline, sub=ms[0])
            return status, ctype, body, extra

        # One hop per m= sub-query, all concurrent; each hop retries
        # and hedges independently. Ownership hashes the SUB-QUERY
        # spec (not just the metric): distinct aggregations of one
        # metric spread while repeats of the same panel stay hot on
        # one replica. Multi-writer mode instead consults the
        # ownership map: a sub-query hops to every writer in its
        # slot's owner HISTORY (one, absent handoffs) and the answers
        # merge.
        t0 = time.monotonic()
        if self.ownership is not None:
            hops = [self._hop_cluster(m, base, deadline) for m in ms]
        else:
            hops = [self._hop(
                "/q?" + urllib.parse.urlencode(
                    dict(base, m=m, json="")),
                self._owner_index(m),
                deadline, sub=m)
                for m in ms]
        outs = await asyncio.gather(*hops, return_exceptions=True)

        results: list[dict] = []
        degraded_tags: set[str] = set()
        approx_tags: set[str] = set()
        hop_spans: list[dict] = []
        for m, out in zip(ms, outs):
            if isinstance(out, BaseException):
                return (502, "text/plain",
                        f"all replicas failed for {m}: {out}\n"
                        .encode(), {})
            status, ctype, body, extra, spans = out
            hop_spans.extend(spans)
            if status != 200:
                return (status, ctype, body, extra)
            tag = extra.get("X-Tsd-Degraded")
            if tag:
                degraded_tags.update(tag.split(","))
            tag = extra.get("X-Tsd-Approx")
            if tag:
                approx_tags.add(tag)
            try:
                results.extend(json.loads(body))
            except ValueError:
                return (502, "text/plain",
                        f"bad replica body for {m}\n".encode(), {})
        if degrade:
            degraded_tags.add("rollup-only")

        extra = {}
        if approx_tags:
            # Error-contract propagation: hop answers that declared
            # themselves approximate stay declared end to end (the
            # per-result "approx" objects ride the merged JSON bodies
            # untouched; the header is the no-parse signal).
            # Re-aggregated into the single-node header FORM
            # ("kind1,kind2;rel_error=worst") — hop values already
            # use ';' internally, so joining them raw would be
            # unparseable.
            kinds: set[str] = set()
            rels: list[float] = []
            for tag in approx_tags:
                head, _, rel = tag.partition(";rel_error=")
                kinds.update(k for k in head.split(",") if k)
                try:
                    rels.append(float(rel))
                except ValueError:
                    pass
            tagv = ",".join(sorted(kinds))
            if rels:
                tagv += f";rel_error={max(rels):.6g}"
            extra["X-Tsd-Approx"] = tagv
        if degraded_tags:
            tag = ",".join(sorted(degraded_tags))
            extra["X-Tsd-Degraded"] = tag
            for ent in results:
                ent["degraded"] = ",".join(sorted(
                    set(ent.get("degraded", "").split(","))
                    - {""} | degraded_tags))
        wall_ms = (time.monotonic() - t0) * 1000.0

        if want_trace:
            record = {
                "ts": int(time.time()),
                "trace_id": trace_id,
                "q": query_string,
                "wall_ms": round(wall_ms, 3),
                "plan": "router",
                "slow": False,
                "router": True,
                "trace": {"name": "router.query",
                          "ms": round(wall_ms, 3),
                          "tags": {"q": query_string,
                                   "m": len(ms)},
                          "spans": hop_spans},
            }
            self.trace_ring.add(record)

        if "ascii" in q:
            out_lines = []
            for ent in results:
                tag_str = " ".join(f"{k}={v}" for k, v in
                                   sorted(ent["tags"].items()))
                for ts_s, v in sorted(ent["dps"].items(),
                                      key=lambda kv: int(kv[0])):
                    vs = (str(int(v)) if float(v).is_integer()
                          else repr(float(v)))
                    line = f"{ent['metric']} {ts_s} {vs}"
                    out_lines.append(
                        line + (" " + tag_str if tag_str else ""))
            body = ("\n".join(out_lines)
                    + ("\n" if out_lines else "")).encode()
            return 200, "text/plain", body, extra
        if want_trace:
            for ent in results:
                ent.setdefault("trace_id", trace_id)
        return (200, "application/json",
                json.dumps(results).encode(), extra)

    # ------------------------------------------------------------------
    # Multi-writer read fan-out (cluster/ownership.py)
    # ------------------------------------------------------------------

    @staticmethod
    def _m_metric(m: str) -> str:
        """The metric name inside an m-spec: the last colon segment
        before the optional tag filter — 'sum:1h-avg:rate:cpu{h=a}'
        → 'cpu'. The router routes on the METRIC (all aggregations of
        one metric live with its owner), unlike single-writer mode's
        whole-spec hash which only had cache affinity to optimize."""
        return m.split("{", 1)[0].split(":")[-1]

    def _owner_index(self, m: str) -> int:
        """Preferred backend for one sub-query. Mesh-aware: each backend
        advertises its serving-mesh width (resident hot-set shards) in
        /healthz, and ownership weights the series space by it — a
        backend with 4 resident shards owns 4x the slots of a 1-shard
        one. A uniform fleet (every width 1, or probes not yet landed)
        is the plain modulo, keeping existing layouts' cache affinity
        byte for byte. The JAX router's rule."""
        h = series_hash(m.encode())
        widths = [max(1, int((b.last_health.get("mesh") or {})
                             .get("width", 1)))
                  for b in self.backends]
        total = sum(widths)
        if total == len(widths):
            return h % len(widths)
        slot = h % total
        for i, w in enumerate(widths):
            slot -= w
            if slot < 0:
                return i
        return 0

    async def _hop_cluster(self, m: str, base: dict, deadline: float):
        """One sub-query in multi-writer mode: concurrent hops to
        every writer in the metric's slot-owner history, answers
        merged agg-aware. Returns the standard hop 5-tuple with the
        MERGED body."""
        metric = self._m_metric(m)
        target = "/q?" + urllib.parse.urlencode(
            dict(base, m=m, json=""))
        idxs = self.ownership.readers(metric.encode())
        outs = await asyncio.gather(
            *(self._hop_writer(self.writer_backends[i], target,
                               deadline, sub=m) for i in idxs),
            return_exceptions=True)
        parts: list[list[dict]] = []
        spans: list[dict] = []
        extra: dict = {}
        for i, out in zip(idxs, outs):
            if isinstance(out, BaseException):
                # Any owner-history writer missing = a wrong (partial)
                # answer; fail the sub-query loudly rather than serve
                # a silent hole.
                raise out if isinstance(out, HopError) else HopError(
                    f"{m}: writer {self.writer_backends[i].url} "
                    f"failed: {out}")
            status, ctype, body, hop_extra, hop_spans = out
            spans.extend(hop_spans)
            if status != 200:
                return status, ctype, body, hop_extra, spans
            for k, v in hop_extra.items():
                extra[k] = (v if k not in extra
                            else ",".join(sorted(set(extra[k].split(","))
                                                 | set(v.split(",")))))
            try:
                parts.append(json.loads(body))
            except ValueError:
                raise HopError(f"bad writer body for {m}") from None
        merged = self._merge_results(m, parts)
        return (200, "application/json", json.dumps(merged).encode(),
                extra, spans)

    @staticmethod
    def _merge_results(m: str, parts: list[list[dict]]) -> list[dict]:
        """Union per-(metric, tags) dps across the owner history
        (current owner's part FIRST). Ownership is per-METRIC (slot =
        hash of the metric name), so a metric's series NEVER split
        across owners by series — a slot only spans writers after a
        handoff, partitioned by TIME. A timestamp present on both
        sides is therefore the SAME logical cell(s): the old owner's
        stale copy vs a post-handoff rewrite (backfill/correction)
        that landed on the current owner. Single-store semantics for
        a re-put is last-write-wins, so the CURRENT owner's value
        stands for every aggregator — arithmetic combination (summing
        the superseded copy into the rewrite, or two partial
        downsample buckets into each other) would fabricate values no
        single-store deployment could ever return."""
        merged: dict[tuple, dict] = {}
        for part in parts:
            for ent in part:
                key = (ent.get("metric"),
                       tuple(sorted((ent.get("tags") or {}).items())))
                cur = merged.get(key)
                if cur is None:
                    merged[key] = ent
                    continue
                dps = cur["dps"]
                for ts, v in ent.get("dps", {}).items():
                    if ts not in dps:
                        dps[ts] = v
                    # else: the current owner's value stands
                if ent.get("degraded"):
                    cur["degraded"] = ",".join(sorted(
                        set((cur.get("degraded") or "").split(","))
                        - {""} | set(ent["degraded"].split(","))))
        return list(merged.values())

    async def _hop_writer(self, b: Backend, target: str,
                          deadline: float, sub: str):
        """One writer-directed hop: same deadline shares, backoff and
        5xx handling as the replica hop, but NO alternate candidates
        and no hedging — writers are not interchangeable (each owns
        its slice), so retries go to the same writer."""
        retries = int(getattr(self.config, "router_retries", 2) or 0)
        backoff = float(getattr(self.config, "router_backoff_ms",
                                50.0)) / 1000.0
        spans: list[dict] = []
        last_err: Exception | None = None
        for attempt in range(retries + 1):
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                break
            share = remaining / max(retries + 1 - attempt, 1)
            t0 = time.monotonic()
            try:
                with _M_HOP.time():
                    status, headers, body = await _http_fetch(
                        b.host, b.port, target,
                        timeout_s=max(share, 0.001))
                if status >= 500 and status != 503:
                    raise HopError(f"{b.url} answered {status}")
            except HopError as e:
                last_err = e
                _M_ERRORS.inc()
                if attempt < retries:
                    _M_RETRIES.inc()
                    await asyncio.sleep(
                        min(backoff * (2 ** attempt), 1.0,
                            max(deadline - time.monotonic(), 0)))
                continue
            ms_taken = (time.monotonic() - t0) * 1000.0
            b.latency.add(ms_taken)
            b.consecutive_fails = 0
            spans.append({
                "name": "hop",
                "ms": round(ms_taken, 3),
                "tags": {"m": sub, "backend": b.url,
                         "attempt": attempt, "status": status,
                         "writer": True},
            })
            extra = {}
            if "x-tsd-degraded" in headers:
                extra["X-Tsd-Degraded"] = headers["x-tsd-degraded"]
            if "x-tsd-approx" in headers:
                extra["X-Tsd-Approx"] = headers["x-tsd-approx"]
            if "retry-after" in headers:
                extra["Retry-After"] = headers["retry-after"]
            return (status,
                    headers.get("content-type", "text/plain"), body,
                    extra, spans)
        raise HopError(f"{sub}: writer {b.url} did not answer within "
                       f"the deadline ({last_err})")

    async def _hop(self, target: str, owner: int, deadline: float,
                   sub: str):
        """One sub-query against the fleet: owner-first candidate
        order, per-attempt share of the remaining deadline, capped
        exponential backoff between retries, and a hedged duplicate
        when the leader is slower than the hedge delay. Returns
        (status, ctype, body, extra_headers, hop_spans)."""
        retries = int(getattr(self.config, "router_retries", 2) or 0)
        backoff = float(getattr(self.config, "router_backoff_ms",
                                50.0)) / 1000.0
        cands = self._candidates(owner)
        spans: list[dict] = []
        last_err: Exception | None = None
        for attempt in range(retries + 1):
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                break
            # Per-attempt share of what's left: a wedged replica must
            # not eat the whole budget and starve the retries (the
            # last attempt gets everything that remains).
            share = remaining / max(retries + 1 - attempt, 1)
            b = cands[attempt % len(cands)]
            hedge_b = (cands[(attempt + 1) % len(cands)]
                       if len(cands) > 1 else None)
            try:
                out = await self._hop_once(
                    b, hedge_b, target, share, attempt, spans, sub)
            except HopError as e:
                last_err = e
                _M_ERRORS.inc()
                self._note_failure(b)
                if attempt < retries:
                    _M_RETRIES.inc()
                    await asyncio.sleep(
                        min(backoff * (2 ** attempt), 1.0,
                            max(deadline - time.monotonic(), 0)))
                continue
            return out
        raise HopError(f"{sub}: no replica answered within the "
                       f"deadline ({last_err})")

    def _hedge_delay_s(self, b: Backend, remaining: float) -> float | None:
        """None disables hedging for this hop."""
        cfg_ms = float(getattr(self.config, "router_hedge_ms", 0.0))
        if cfg_ms < 0 or len(self.backends) < 2:
            return None
        # Hedging is a TAIL-LATENCY tool, not an overload tool: a
        # hedge doubles a hop's cost exactly when the fleet is
        # saturated (inflated hop latency trips the p95 trigger on
        # every request), which is how hedged routers melt down under
        # load. At or beyond the admission ladder's first step, every
        # hop flies solo.
        n = int(getattr(self.config, "query_max_inflight", 0) or 0)
        if n and self.admission.inflight_queries >= n:
            return None
        if cfg_ms > 0:
            delay = cfg_ms / 1000.0
        elif b.latency.count >= 8:
            delay = max(b.latency.percentile(95) / 1000.0,
                        _HEDGE_FLOOR_MS / 1000.0)
        else:
            # Too few observations for a p95: hedge only as a deadline
            # backstop at half the remaining budget.
            delay = remaining / 2
        return min(delay, remaining / 2)

    async def _hop_once(self, b: Backend, hedge_b, target: str,
                        remaining: float, attempt: int,
                        spans: list, sub: str):
        """One attempt, possibly hedged: the primary fires now, the
        hedge after the delay; first success wins and the loser is
        cancelled + recorded as a cancelled span."""
        t0 = time.monotonic()

        async def fetch(backend: Backend):
            budget = remaining - (time.monotonic() - t0)
            with _M_HOP.time():
                status, headers, body = await _http_fetch(
                    backend.host, backend.port, target,
                    timeout_s=max(budget, 0.001))
            if status >= 500 and status != 503:
                raise HopError(f"{backend.url} answered {status}")
            return backend, status, headers, body

        primary = asyncio.create_task(fetch(b))
        tasks = [primary]
        hedge_delay = (self._hedge_delay_s(b, remaining)
                       if hedge_b is not None else None)
        hedged = False
        if hedge_delay is not None:
            done, _ = await asyncio.wait({primary},
                                         timeout=hedge_delay)
            if not done:
                hedged = True
                _M_HEDGES.inc()
                tasks.append(asyncio.create_task(fetch(hedge_b)))

        winner = None
        err: Exception | None = None
        pending = set(tasks)
        while pending and winner is None:
            done, pending = await asyncio.wait(
                pending, return_when=asyncio.FIRST_COMPLETED,
                timeout=max(remaining - (time.monotonic() - t0),
                            0.001))
            if not done:
                break  # deadline: everything still pending loses
            for t in done:
                if t.exception() is None:
                    winner = t
                    break
                err = t.exception()
        for t in tasks:
            if t is not winner and not t.done():
                t.cancel()
                # The cancelled-loser span: /api/traces shows WHICH
                # replica was slow and that its request was abandoned.
                loser = hedge_b if t is not primary else b
                spans.append({
                    "name": "hop",
                    "ms": round((time.monotonic() - t0) * 1000.0, 3),
                    "tags": {"m": sub, "backend": loser.url,
                             "attempt": attempt,
                             "cancelled": True},
                })
        if winner is None:
            raise err if isinstance(err, HopError) else HopError(
                f"{sub}: hop timed out")
        backend, status, headers, body = winner.result()
        ms_taken = (time.monotonic() - t0) * 1000.0
        backend.latency.add(ms_taken)
        backend.consecutive_fails = 0
        if hedged and backend is not b:
            _M_HEDGE_WINS.inc()
        span = {
            "name": "hop",
            "ms": round(ms_taken, 3),
            "tags": {"m": sub, "backend": backend.url,
                     "attempt": attempt, "status": status,
                     "hedged": hedged},
        }
        # Replica span trees ride the JSON results; graft them under
        # the hop so the router's tree is the WHOLE request.
        try:
            parsed = json.loads(body)
            subtrees = [ent["trace"] for ent in parsed
                        if isinstance(ent, dict) and "trace" in ent]
            if subtrees:
                span["spans"] = subtrees
        except ValueError:
            pass
        spans.append(span)
        extra = {}
        if "x-tsd-degraded" in headers:
            extra["X-Tsd-Degraded"] = headers["x-tsd-degraded"]
        if "x-tsd-approx" in headers:
            extra["X-Tsd-Approx"] = headers["x-tsd-approx"]
        if "retry-after" in headers:
            extra["Retry-After"] = headers["retry-after"]
        return (status, headers.get("content-type", "text/plain"),
                body, extra, spans)


# ---------------------------------------------------------------------------
# /topology: the browser view over the /api/topology JSON feed — the
# cluster-state dashboard (writers + epoch + promotion history, every
# replica's lag / ejection / hop p95, hedge + retry + rcache counters,
# the ownership map) rendered client-side and auto-refreshed. No
# external assets: one self-contained page the router serves from
# memory, so it works air-gapped and on a storage-free router.
# ---------------------------------------------------------------------------

_TOPOLOGY_HTML = """<!doctype html>
<html><head><meta charset="utf-8"><title>tsd topology</title>
<style>
 body{font:13px/1.45 system-ui,sans-serif;margin:1.2em;background:#fafafa;
      color:#222}
 h1{font-size:1.2em;margin:0 0 .2em}
 h2{font-size:1em;margin:1.2em 0 .3em}
 table{border-collapse:collapse;background:#fff;min-width:40em}
 th,td{border:1px solid #ddd;padding:.25em .6em;text-align:left;
       font-variant-numeric:tabular-nums}
 th{background:#f0f0f0;font-weight:600}
 .ok{color:#0a7d32}.bad{color:#c0392b}.warn{color:#b8860b}
 .muted{color:#888}
 #meta{color:#666;font-size:.9em;margin-bottom:.8em}
 .pill{display:inline-block;padding:0 .5em;border-radius:.8em;
       background:#eee;margin-right:.4em}
</style></head><body>
<h1>Cluster topology</h1>
<div id="meta">loading /api/topology&hellip;</div>
<div id="writers"></div><div id="replicas"></div>
<div id="promotion"></div><div id="ownership"></div>
<div id="counters"></div>
<script>
function esc(v){return String(v).replace(/&/g,"&amp;")
  .replace(/</g,"&lt;").replace(/>/g,"&gt;")
  .replace(/"/g,"&quot;");}
function cls(ok){return ok?"ok":"bad";}
function fmt(v){return v===null||v===undefined?"&mdash;":esc(v);}
function table(title, heads, rows){
  var h="<h2>"+title+"</h2><table><tr>"+heads.map(
    function(x){return "<th>"+x+"</th>";}).join("")+"</tr>";
  h+=rows.map(function(r){return "<tr>"+r.map(
    function(c){return "<td>"+c+"</td>";}).join("")+"</tr>";}).join("");
  return h+"</table>";
}
function render(t){
  document.getElementById("meta").innerHTML=
    "router up "+t.uptime_s+"s &middot; refreshed "+
    new Date().toLocaleTimeString();
  var w=(t.writers||[]).map(function(x){
    var h=x.health||{};
    var alive=!!h.ok, fenced=!!h.fenced;
    return [esc(x.url),
      "<span class='"+cls(alive)+"'>"+(alive?"alive":"down")+"</span>",
      fmt(h.writer_epoch),
      fenced?"<span class='bad'>FENCED</span>":"&mdash;",
      fmt(h.role)];});
  document.getElementById("writers").innerHTML=
    table("Writers", ["url","health","epoch","fence","role"], w);
  var r=(t.replicas||[]).map(function(x){
    var s=x.ejected?"<span class='bad'>ejected</span>"
      :(x.stale?"<span class='warn'>stale</span>"
        :"<span class='ok'>healthy</span>");
    return [esc(x.url), s, fmt(x.lag_ms), fmt(x.hop_p95_ms),
      fmt(x.consecutive_fails), fmt(x.writer_epoch)];});
  document.getElementById("replicas").innerHTML=
    table("Read backends",
      ["url","state","lag ms","hop p95 ms","consec fails","epoch"], r);
  var p=t.promotion;
  document.getElementById("promotion").innerHTML = p ?
    table("Promotion driver",
      ["enabled","grace ms","epoch","writer dead for","deposed",
       "recent events"],
      [[p.enabled?"yes":"no", fmt(p.writer_grace_ms), fmt(p.epoch),
        p.writer_dead_for_ms===null?"&mdash;":p.writer_dead_for_ms+" ms",
        fmt(p.deposed_url),
        (p.events||[]).slice(-5).map(function(e){
          return esc(JSON.stringify(e));}).join("<br>")||"&mdash;"]])
    : "";
  var o=t.ownership;
  if(o && o.writers){
    var counts=o.writers.map(function(){return 0;});
    (o.assign||[]).forEach(function(wi){
      if(wi>=0&&wi<counts.length)counts[wi]++;});
    var rows=o.writers.map(function(u,i){
      return [esc(u), counts[i], fmt(o.slots)];});
    document.getElementById("ownership").innerHTML=
      table("Ownership map (epoch "+fmt(o.epoch)+")",
        ["writer","slots owned","total slots"], rows);
  } else {
    document.getElementById("ownership").innerHTML="";
  }
  var c=t.counters||{};
  document.getElementById("counters").innerHTML=
    "<h2>Counters</h2>"+Object.keys(c).map(function(k){
      return "<span class='pill'>"+esc(k)+": "+esc(c[k])+
        "</span>";}).join("");
}
function tick(){
  fetch("/api/topology").then(function(r){return r.json();})
    .then(render)
    .catch(function(e){document.getElementById("meta").innerHTML=
      "<span class='bad'>fetch failed: "+esc(e)+"</span>";});
}
tick(); setInterval(tick, 2000);
</script></body></html>
"""
