"""The port's query router (``serve/router.py``, ROADMAP item 10b) against
the JAX package's.

Every scenario of tests/test_router.py runs over an in-process writer, two
replica daemons and a router in one event loop: fan-out parity and
ownership, ASCII output, a retry around a dead replica, the deadline on a
wedged one, a hedge that wins with its cancelled loser span, ejection and
readmission, the stale tag carried through, one trace id across router and
replicas, and put forwarding under an ingest quota. Each runs three ways:
the port's router over the port's replicas, and cross-wired, a JAX router
over the port's replicas and the port's router over JAX replicas. Then the
same queries through all four wirings: a router answers the bytes the
same-package router answers over the same replicas, and the port's
replicas answer the JAX replicas' values (the executor's contract). Last,
the router's HTTP surface (``/healthz``, ``/stats``, ``/metrics``,
``/api/topology``, the passthroughs, a 404) against the JAX router's."""

import asyncio
import json
import time
import types

import numpy as np
import pytest

import opentsdb_tpu.serve.router as jax_router
import opentsdb_tpu_torch.serve.router as port_router
from opentsdb_tpu.core.tsdb import TSDB as JaxTSDB
from opentsdb_tpu.obs.registry import METRICS as JAX_METRICS
from opentsdb_tpu.query.executor import QueryExecutor as JaxExecutor
from opentsdb_tpu.query.executor import QuerySpec as JaxSpec
from opentsdb_tpu.serve.tailer import WalTailer as JaxTailer
from opentsdb_tpu.server.tsd import TSDServer as JaxServer
from opentsdb_tpu.storage.kv import MemKVStore as JaxStore
from opentsdb_tpu.storage.sstable import series_hash as jax_series_hash
from opentsdb_tpu.utils.config import Config as JaxConfig
from opentsdb_tpu_torch.core.tsdb import TSDB
from opentsdb_tpu_torch.obs.registry import METRICS
from opentsdb_tpu_torch.query.executor import QueryExecutor, QuerySpec
from opentsdb_tpu_torch.serve.tailer import WalTailer
from opentsdb_tpu_torch.server.tsd import TSDServer
from opentsdb_tpu_torch.storage.kv import MemKVStore
from opentsdb_tpu_torch.utils.config import Config

BT = 1356998400
N_POINTS = 3000
LOOP = {"port": 0, "bind": "127.0.0.1"}

PKG = {
    "port": types.SimpleNamespace(
        TSDB=TSDB, Store=MemKVStore, Server=TSDServer, Tailer=WalTailer,
        Executor=QueryExecutor, Spec=QuerySpec, router=port_router,
        METRICS=METRICS,
        config=lambda wal=None, **kw: Config(device="cpu", **kw)),
    "jax": types.SimpleNamespace(
        TSDB=JaxTSDB, Store=JaxStore, Server=JaxServer, Tailer=JaxTailer,
        Executor=JaxExecutor, Spec=JaxSpec, router=jax_router,
        METRICS=JAX_METRICS,
        config=lambda wal=None, **kw: JaxConfig(wal_path=wal, **kw)),
}
# (router package, replica package): the port alone, then cross-wired.
WIRINGS = [("port", "port"), ("jax", "port"), ("port", "jax")]
WIRING_IDS = ["port", "jax-router-port-replicas", "port-router-jax-replicas"]


def owner_metric(owner: int, n_backends: int = 2) -> str:
    """A '<agg>:<metric>' m-spec whose hash routes to ``owner``."""
    for i in range(1000):
        m = f"sum:route.m{i}"
        if jax_series_hash(m.encode()) % n_backends == owner:
            return m
    raise AssertionError("no metric found")


def test_series_hash_is_the_storage_chain():
    """The router's own crc32 equals ``sstable.series_hash`` of both
    packages (it keeps a copy so as not to load the storage engine)."""
    from opentsdb_tpu_torch.storage.sstable import series_hash
    for i in range(2000):
        m = f"sum:1h-avg:route.m{i}{{host=h{i % 7}}}".encode()
        assert port_router.series_hash(m) == series_hash(m) \
            == jax_series_hash(m)


def make_writer(pkg, path):
    p = PKG[pkg]
    wal = str(path / "wal")
    w = p.TSDB(p.Store(wal_path=wal),
               p.config(wal, backend="cpu", auto_create_metrics=True,
                        enable_sketches=False, device_window=False),
               start_compaction_thread=False)
    for owner in (0, 1):
        metric = owner_metric(owner).split(":", 1)[1]
        ts = np.arange(N_POINTS, dtype=np.int64) * 60 + BT
        w.add_batch(metric, ts, ((ts % 11) + owner).astype(np.float64),
                    {"host": "a"})
    return w


def make_replica_server(pkg, path, **cfg_kw):
    p = PKG[pkg]
    wal = str(path / "wal")
    kw = dict(backend="cpu", enable_sketches=False, device_window=False,
              role="replica", max_staleness_ms=60_000.0, **LOOP)
    kw.update(cfg_kw)
    r = p.TSDB(p.Store(wal_path=wal, read_only=True), p.config(wal, **kw),
               start_compaction_thread=False)
    server = p.Server(r)
    tailer = p.Tailer(r, interval_s=3600.0)  # the tests drive run_once
    server.attach_tailer(tailer)
    return server, r, tailer


async def http_get(port, target):
    reader, writer = await asyncio.open_connection("127.0.0.1", port)
    writer.write(f"GET {target} HTTP/1.1\r\nHost: x\r\n"
                 "Connection: close\r\n\r\n".encode())
    await writer.drain()
    data = await reader.read()
    writer.close()
    head, _, body = data.partition(b"\r\n\r\n")
    status = int(head.split(b" ", 2)[1])
    headers = {}
    for ln in head.split(b"\r\n")[1:]:
        k, _, v = ln.partition(b":")
        headers[k.strip().lower().decode()] = v.strip().decode()
    return status, headers, body


class Deployment:
    """A writer TSDB, two replica daemons and a router, one loop."""

    def __init__(self, path, wiring=("port", "port"), **router_cfg):
        self.router_pkg, self.replica_pkg = wiring
        self.rp = PKG[self.router_pkg]
        self.writer = make_writer(self.replica_pkg, path)
        self.ra, self.tsdb_a, self.tail_a = make_replica_server(
            self.replica_pkg, path)
        self.rb, self.tsdb_b, self.tail_b = make_replica_server(
            self.replica_pkg, path)
        self.router_cfg = router_cfg
        self.router = None

    async def start(self):
        await self.ra.start()
        await self.rb.start()
        cfg = self.rp.config(
            role="router",
            router_backends=(f"http://127.0.0.1:{self.ra.port}",
                             f"http://127.0.0.1:{self.rb.port}"),
            **LOOP, **self.router_cfg)
        self.router = self.rp.router.RouterServer(cfg)
        await self.router.start()

    async def stop(self):
        if self.router is not None:
            await self.router.stop()
        for s in (self.ra, self.rb):
            s._pool.shutdown(wait=False)
            if s._server is not None:
                s._server.close()
                await s._server.wait_closed()

    def shutdown(self):
        self.tsdb_a.shutdown()
        self.tsdb_b.shutdown()
        self.writer.shutdown()

    def counter(self, name):
        return self.rp.METRICS.counter(name).value


def run_deployment(dep, coro_fn):
    async def main():
        await dep.start()
        try:
            return await coro_fn(dep)
        finally:
            await dep.stop()
    try:
        return asyncio.run(main())
    finally:
        dep.shutdown()


def writer_answer(dep, m_spec):
    """The writer's own answer (read before the deployment shuts down)."""
    p = PKG[dep.replica_pkg]
    agg, metric = m_spec.split(":", 1)
    ex = p.Executor(dep.writer, backend="cpu")
    got = ex.run(p.Spec(metric, {}, aggregator=agg), BT - 60,
                 BT + N_POINTS * 60)
    return {str(int(t)): float(v) for t, v in
            zip(got[0].timestamps, got[0].values)}


def q_target(*ms, fmt="json", extra=""):
    return (f"/q?start={BT - 60}&end={BT + N_POINTS * 60}"
            + "".join(f"&m={m}" for m in ms) + f"&{fmt}&nocache{extra}")


wirings = pytest.mark.parametrize("wiring", WIRINGS, ids=WIRING_IDS)


# ---------------------------------------------------------------------------
# tests/test_router.py's scenarios, each wired three ways
# ---------------------------------------------------------------------------

@wirings
def test_multi_m_fanout_parity_and_ownership(wiring, tmp_path):
    dep = Deployment(tmp_path, wiring, probe_interval_s=3600.0)
    m0, m1 = owner_metric(0), owner_metric(1)
    want = {m.split(":", 1)[1]: writer_answer(dep, m) for m in (m0, m1)}

    async def drive(dep):
        status, _, body = await http_get(dep.router.port, q_target(m0, m1))
        return status, json.loads(body), dep.ra.http_rpcs, dep.rb.http_rpcs

    status, res, rpcs_a, rpcs_b = run_deployment(dep, drive)
    assert status == 200 and len(res) == 2
    assert {r["metric"]: r["dps"] for r in res} == want
    # Ownership: each sub-query landed on its owner (beside the probes).
    assert rpcs_a >= 1 and rpcs_b >= 1


@wirings
def test_ascii_output(wiring, tmp_path):
    dep = Deployment(tmp_path, wiring, probe_interval_s=3600.0)
    m0 = owner_metric(0)

    async def drive(dep):
        return await http_get(dep.router.port, q_target(m0, fmt="ascii"))

    status, _, body = run_deployment(dep, drive)
    assert status == 200
    lines = body.decode().strip().split("\n")
    assert len(lines) == N_POINTS
    assert lines[0].split()[0] == m0.split(":", 1)[1]


@wirings
def test_retry_on_dead_replica(wiring, tmp_path):
    dep = Deployment(tmp_path, wiring, probe_interval_s=3600.0,
                     router_retries=2, router_backoff_ms=5.0,
                     router_hedge_ms=-1.0)
    m0 = owner_metric(0)
    want = writer_answer(dep, m0)
    retries0 = dep.counter("router.retries")

    async def drive(dep):
        # The owner's listener goes: the hop fails to connect and retries
        # on the other replica.
        dep.ra._server.close()
        await dep.ra._server.wait_closed()
        status, _, body = await http_get(dep.router.port, q_target(m0))
        return status, json.loads(body)

    status, res = run_deployment(dep, drive)
    assert status == 200
    assert res[0]["dps"] == want
    assert dep.counter("router.retries") > retries0


@wirings
def test_deadline_bounds_wedged_replica(wiring, tmp_path):
    dep = Deployment(tmp_path, wiring, probe_interval_s=3600.0,
                     router_retries=1, router_backoff_ms=5.0,
                     router_hedge_ms=-1.0, router_deadline_ms=800.0)
    m0 = owner_metric(0)
    want = writer_answer(dep, m0)
    real = dep.ra.executor.run_approx

    def slow(*a, **kw):
        time.sleep(5.0)
        return real(*a, **kw)

    dep.ra.executor.run_approx = slow

    async def drive(dep):
        t0 = time.monotonic()
        status, _, body = await http_get(dep.router.port, q_target(m0))
        return status, json.loads(body), time.monotonic() - t0

    status, res, wall = run_deployment(dep, drive)
    assert status == 200, "the retry on B must still answer"
    assert res[0]["dps"] == want
    assert wall < 4.0, f"the deadline must bound the wedged hop: {wall:.1f}s"


@wirings
def test_hedge_wins_and_records_cancelled_span(wiring, tmp_path):
    dep = Deployment(tmp_path, wiring, probe_interval_s=3600.0,
                     router_retries=0, router_hedge_ms=50.0,
                     router_deadline_ms=10_000.0)
    m0 = owner_metric(0)
    want = writer_answer(dep, m0)
    real = dep.ra.executor.run_approx
    hedges0 = dep.counter("router.hedges")
    wins0 = dep.counter("router.hedge_wins")

    def slow(*a, **kw):
        time.sleep(1.5)
        return real(*a, **kw)

    dep.ra.executor.run_approx = slow

    async def drive(dep):
        t0 = time.monotonic()
        status, _, body = await http_get(dep.router.port,
                                         q_target(m0, extra="&trace=1"))
        wall = time.monotonic() - t0
        _, _, traces = await http_get(dep.router.port, "/api/traces")
        return status, json.loads(body), wall, json.loads(traces)

    status, res, wall, traces = run_deployment(dep, drive)
    assert status == 200
    assert res[0]["dps"] == want
    assert wall < 1.4, "the hedge must win long before the wedged primary"
    assert dep.counter("router.hedges") > hedges0
    assert dep.counter("router.hedge_wins") > wins0
    spans = traces[-1]["trace"]["spans"]
    cancelled = [s for s in spans if s["tags"].get("cancelled")]
    won = [s for s in spans
           if s["tags"].get("hedged") and not s["tags"].get("cancelled")]
    assert cancelled and won
    assert cancelled[0]["tags"]["backend"] != won[0]["tags"]["backend"]


@wirings
def test_eject_and_readmit(wiring, tmp_path):
    dep = Deployment(tmp_path, wiring, probe_interval_s=0.05,
                     router_eject_after=2, router_retries=2,
                     router_backoff_ms=5.0, router_hedge_ms=-1.0)
    m0 = owner_metric(0)
    want = writer_answer(dep, m0)
    ej0 = dep.counter("router.ejections")
    re0 = dep.counter("router.readmissions")

    async def drive(dep):
        port_a = dep.ra.port
        dep.ra._server.close()
        await dep.ra._server.wait_closed()
        for _ in range(100):
            await asyncio.sleep(0.05)
            if not dep.router.backends[0].healthy:
                break
        assert not dep.router.backends[0].healthy, "never ejected"
        status, _, body = await http_get(dep.router.port, q_target(m0))
        assert status == 200
        # A back on its old port: the probes readmit it.
        dep.ra._server = await asyncio.start_server(
            dep.ra._handle_conn, "127.0.0.1", port_a)
        for _ in range(100):
            await asyncio.sleep(0.05)
            if dep.router.backends[0].healthy:
                break
        assert dep.router.backends[0].healthy, "never readmitted"
        _, _, hz = await http_get(dep.router.port, "/healthz")
        return json.loads(hz), json.loads(body)

    hz, res = run_deployment(dep, drive)
    assert hz["ok"] is True and all(b["healthy"] for b in hz["backends"])
    assert res[0]["dps"] == want
    assert dep.counter("router.ejections") > ej0
    assert dep.counter("router.readmissions") > re0


@wirings
def test_stale_replica_tag_propagates(wiring, tmp_path):
    dep = Deployment(tmp_path, wiring, probe_interval_s=3600.0,
                     router_retries=0, router_hedge_ms=-1.0)
    m0 = owner_metric(0)
    dep.tail_a.max_staleness_ms = 0.001
    dep.tail_b.max_staleness_ms = 0.001

    async def drive(dep):
        await asyncio.sleep(0.01)
        return await http_get(dep.router.port, q_target(m0))

    status, headers, body = run_deployment(dep, drive)
    assert status == 200
    assert "stale" in headers.get("x-tsd-degraded", "")
    assert "stale" in json.loads(body)[0]["degraded"]


@wirings
def test_one_trace_id_spans_router_and_replica(wiring, tmp_path):
    dep = Deployment(tmp_path, wiring, probe_interval_s=3600.0,
                     router_hedge_ms=-1.0)
    m0, m1 = owner_metric(0), owner_metric(1)

    async def drive(dep):
        status, _, body = await http_get(
            dep.router.port, q_target(m0, m1, extra="&trace=1"))
        _, _, rt = await http_get(dep.router.port, "/api/traces")
        _, _, ra = await http_get(dep.ra.port, "/api/traces")
        _, _, rb = await http_get(dep.rb.port, "/api/traces")
        return (status, json.loads(body), json.loads(rt), json.loads(ra),
                json.loads(rb))

    status, res, rt, ra, rb = run_deployment(dep, drive)
    assert status == 200
    tid = rt[-1]["trace_id"]
    assert tid
    assert any(r.get("trace_id") == tid for r in ra)
    assert any(r.get("trace_id") == tid for r in rb)
    hops = [s for s in rt[-1]["trace"]["spans"] if s["name"] == "hop"]
    assert len(hops) == 2
    for h in hops:
        assert h["tags"]["status"] == 200
        assert h.get("spans") and h["spans"][0]["name"] == "query", \
            "the replica's span tree grafts under the hop"
    assert all(r.get("trace_id") == tid for r in res)


@wirings
def test_put_forwards_to_writer_and_sheds_over_quota(wiring, tmp_path):
    # The router's writer is a third daemon over a store of its own (the
    # deployment's writer holds its store's lock).
    wp = PKG[wiring[1]]
    wdir = tmp_path / "w2"
    wdir.mkdir()
    wal = str(wdir / "wal")
    wtsdb = wp.TSDB(wp.Store(wal_path=wal),
                    wp.config(wal, backend="cpu", auto_create_metrics=True,
                              enable_sketches=False, device_window=False,
                              **LOOP),
                    start_compaction_thread=False)
    wserver = wp.Server(wtsdb)
    dep = Deployment(tmp_path, wiring, probe_interval_s=3600.0,
                     ingest_rate=2.0, ingest_burst_s=1.0)

    async def drive(dep):
        await wserver.start()
        try:
            dep.router.writer_url = f"http://127.0.0.1:{wserver.port}"
            dep.router._writer = dep.rp.router.Backend(dep.router.writer_url)
            reader, writer = await asyncio.open_connection(
                "127.0.0.1", dep.router.port)
            for i in range(6):
                writer.write(f"put fwd.m {BT + i} {i} host=h\n".encode())
            await writer.drain()
            await asyncio.sleep(0.3)
            writer.close()
            out = await reader.read()
            await asyncio.sleep(0.2)
            return out
        finally:
            wserver._pool.shutdown(wait=False)
            wserver._server.close()
            await wserver._server.wait_closed()

    out = run_deployment(dep, drive)
    assert b"Please throttle writes" in out
    assert dep.router.telnet_lines_forwarded >= 1
    got = wp.Executor(wtsdb, backend="cpu").run(
        wp.Spec("fwd.m", {}, aggregator="count"), BT - 60, BT + 60)
    wtsdb.shutdown()
    assert float(got[0].values.sum()) == dep.router.telnet_lines_forwarded


# ---------------------------------------------------------------------------
# Cross-wiring: the same queries through all four deployments
# ---------------------------------------------------------------------------

ALL_WIRINGS = [("port", "port"), ("jax", "jax"), ("jax", "port"),
               ("port", "jax")]


def _bodies(tmp_path, wiring):
    dep = Deployment(tmp_path / "-".join(wiring), wiring,
                     probe_interval_s=3600.0, router_hedge_ms=-1.0)
    m0, m1 = owner_metric(0), owner_metric(1)
    targets = [q_target(m0, m1), q_target(m0, fmt="ascii"),
               q_target(f"sum:1h-avg:{m1.split(':', 1)[1]}", m0)]

    async def drive(dep):
        return [await http_get(dep.router.port, t) for t in targets]

    return run_deployment(dep, drive)


def test_cross_wired_bodies_match_same_package(tmp_path):
    """A router of either package over replicas of a package answers the
    bytes that package's own router answers over them (the bodies are
    the replicas' JSON, merged the same way), and the port's replicas
    answer the JAX replicas' values."""
    out = {w: _bodies(tmp_path, w) for w in ALL_WIRINGS}
    for (status, headers, _) in sum(out.values(), []):
        assert status == 200
    assert [b for *_, b in out[("jax", "port")]] == \
        [b for *_, b in out[("port", "port")]]
    assert [b for *_, b in out[("port", "jax")]] == \
        [b for *_, b in out[("jax", "jax")]]
    port, jax = out[("port", "port")], out[("jax", "jax")]
    assert port[1][2] == jax[1][2]  # ASCII lines
    for (_, _, pb), (_, _, jb) in ((port[0], jax[0]), (port[2], jax[2])):
        pr, jr = json.loads(pb), json.loads(jb)
        assert [(r["metric"], r["tags"]) for r in pr] == \
            [(r["metric"], r["tags"]) for r in jr]
        for a, b in zip(pr, jr):
            assert list(a["dps"]) == list(b["dps"])
            np.testing.assert_allclose(list(a["dps"].values()),
                                       list(b["dps"].values()), rtol=1e-6)


# ---------------------------------------------------------------------------
# The router's own HTTP surface against the JAX router's
# ---------------------------------------------------------------------------

SURFACE = ["/healthz", "/stats", "/stats?json", "/metrics", "/api/traces",
           "/api/topology", "/topology", "/aggregators", "/version",
           "/suggest?type=metrics&q=route", "/api/tenants", "/nope",
           "/api/cluster/handoff?slot=0&to=1", "/q?m=sum:x"]


def _surface(tmp_path, router_pkg):
    dep = Deployment(tmp_path / router_pkg, (router_pkg, "port"),
                     probe_interval_s=3600.0, router_rcache=8)

    async def drive(dep):
        return {t: await http_get(dep.router.port, t) for t in SURFACE}

    return run_deployment(dep, drive)


def _stat_names(body: bytes) -> set:
    return {ln.split()[0] for ln in body.decode().splitlines() if ln}


def test_http_surface_matches_jax_router(tmp_path):
    port, jax = _surface(tmp_path, "port"), _surface(tmp_path, "jax")
    for t in SURFACE:
        assert port[t][0] == jax[t][0], t
        assert port[t][1].get("content-type") == \
            jax[t][1].get("content-type"), t
    for t in ("/topology", "/aggregators", "/suggest?type=metrics&q=route",
              "/api/tenants", "/nope", "/api/cluster/handoff?slot=0&to=1",
              "/q?m=sum:x", "/api/traces"):
        assert port[t][2] == jax[t][2], t
    # Both routers pass /version through to the (port) replicas.
    assert port["/version"][2].startswith(b"opentsdb_tpu_torch")
    assert jax["/version"][2].startswith(b"opentsdb_tpu_torch")
    for t in ("/healthz", "/api/topology"):
        p, j = json.loads(port[t][2]), json.loads(jax[t][2])
        assert set(p) == set(j), t
    hz = json.loads(port["/healthz"][2])
    assert hz["role"] == "router" and len(hz["backends"]) == 2
    assert set(hz["backends"][0]) == set(
        json.loads(jax["/healthz"][2])["backends"][0])
    assert _stat_names(port["/stats"][2]) >= {
        "tsd.router.backends", "tsd.router.backends_healthy",
        "tsd.router.http_rpcs", "tsd.router.put_lines_forwarded",
        "tsd.router.rcache.entries", "tsd.admission.inflight_queries"}
    for name in ("router_fanouts", "router_hop", "router_hedges"):
        assert name.encode() in port["/metrics"][2]
