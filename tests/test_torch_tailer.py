"""The WAL tailer, replica rollup reads and the replica daemon's surface
(ROADMAP item 10a) against the JAX package.

``serve/tailer.WalTailer``: the cases of tests/test_serve_tailer.py
(suffix tails, a tail across a writer checkpoint, the lag growing under
refresh failures and recovering, a dead writer leaving the replica
fresh), its instruments, and its stats against the JAX tailer's.
``ReadOnlyRollupTier``: a port replica's rollup answers bit-identical to
the writer's and to a JAX replica's over the same tier, through new
folds, and a pending tier degrading to raw. The daemons: ``/healthz``
key sets, statuses and the stale tag of a port and a JAX replica daemon
over one writer; telnet and ``/api/put`` replies of a replica and of a
fenced writer byte for byte against the JAX daemon's; ``/api/tenants``'
role; ``/fault``."""

import asyncio
import json
import os
import shutil
import time

import numpy as np
import pytest

import opentsdb_tpu.cluster.epoch as jax_epoch
from opentsdb_tpu.core.tsdb import TSDB as JaxTSDB
from opentsdb_tpu.query.executor import QueryExecutor as JaxExecutor
from opentsdb_tpu.query.executor import QuerySpec as JaxSpec
from opentsdb_tpu.serve.tailer import WalTailer as JaxTailer
from opentsdb_tpu.server.tsd import TSDServer as JaxServer
from opentsdb_tpu.storage.kv import MemKVStore as JaxStore
from opentsdb_tpu.utils.config import Config as JaxConfig
from opentsdb_tpu_torch.cluster import epoch as port_epoch
from opentsdb_tpu_torch.core.tsdb import TSDB
from opentsdb_tpu_torch.fault import faultpoints
from opentsdb_tpu_torch.obs.registry import METRICS
from opentsdb_tpu_torch.query.executor import QueryExecutor, QuerySpec
from opentsdb_tpu_torch.serve.tailer import WalTailer
from opentsdb_tpu_torch.server.tsd import TSDServer
from opentsdb_tpu_torch.stats.collector import StatsCollector
from opentsdb_tpu_torch.storage.kv import MemKVStore
from opentsdb_tpu_torch.utils.config import Config

BT = 1356998400
LOOP = {"port": 0, "bind": "127.0.0.1"}


def make_writer(tmp_path, rollups=False, **kw):
    wal = str(tmp_path / "wal")
    cfg = Config(device="cpu", backend="cpu", auto_create_metrics=True,
                 enable_sketches=False, device_window=False,
                 enable_rollups=rollups, rollup_catchup="sync", **LOOP,
                 **kw)
    return TSDB(MemKVStore(wal_path=wal), cfg,
                start_compaction_thread=False)


def make_replica(tmp_path, rollups=False, max_staleness_ms=0.0, **kw):
    wal = str(tmp_path / "wal")
    cfg = Config(device="cpu", backend="cpu", enable_sketches=False,
                 device_window=False, enable_rollups=rollups,
                 max_staleness_ms=max_staleness_ms, role="replica",
                 **LOOP, **kw)
    return TSDB(MemKVStore(wal_path=wal, read_only=True), cfg,
                start_compaction_thread=False)


def make_jax_replica(tmp_path, rollups=False, max_staleness_ms=0.0):
    wal = str(tmp_path / "wal")
    cfg = JaxConfig(wal_path=wal, backend="cpu", enable_sketches=False,
                    device_window=False, enable_rollups=rollups,
                    max_staleness_ms=max_staleness_ms, role="replica",
                    **LOOP)
    return JaxTSDB(JaxStore(wal_path=wal, read_only=True), cfg,
                   start_compaction_thread=False)


def ingest(tsdb, n=600, t0=BT, step=60, metric="serve.m", tags=None,
           base_val=0):
    ts = np.arange(n, dtype=np.int64) * step + t0
    vals = ((np.arange(n) % 97) + base_val).astype(np.float64)
    tsdb.add_batch(metric, ts, vals, tags or {"host": "a"})
    return ts


# ---------------------------------------------------------------------------
# WalTailer
# ---------------------------------------------------------------------------

def test_suffix_tail_converges_without_checkpoint(tmp_path):
    w = make_writer(tmp_path)
    ingest(w, 500)
    r = make_replica(tmp_path)
    try:
        t = WalTailer(r, interval_s=0.01)
        assert t.run_once()
        ingest(w, 100, t0=BT + 500 * 60)  # a WAL suffix only
        assert t.run_once()
        spec = QuerySpec("serve.m", {}, aggregator="sum")
        a = QueryExecutor(w).run(spec, BT, BT + 700 * 60)
        b = QueryExecutor(r).run(spec, BT, BT + 700 * 60)
        assert np.array_equal(a[0].values, b[0].values)
        assert t.refreshes == 2 and t.errors == 0
        assert r.store.rebuilds == 0
    finally:
        r.shutdown()
        w.shutdown()


def test_tail_across_writer_checkpoint(tmp_path):
    w = make_writer(tmp_path)
    ingest(w, 400)
    r = make_replica(tmp_path)
    try:
        t = WalTailer(r, interval_s=0.01)
        assert t.run_once()
        w.checkpoint()  # rotation: the rebuild path
        ingest(w, 50, t0=BT + 400 * 60)
        assert t.run_once()
        got = QueryExecutor(r).run(QuerySpec("serve.m", {},
                                             aggregator="count"),
                                   BT, BT + 500 * 60)
        assert float(got[0].values.sum()) == 450
        assert r.store.rebuilds == 1
    finally:
        r.shutdown()
        w.shutdown()


def test_lag_grows_on_refresh_failure_and_recovers(tmp_path):
    w = make_writer(tmp_path)
    r = make_replica(tmp_path, max_staleness_ms=40.0)
    c0 = {n: METRICS.counter(n).value for n in
          ("replica.refreshes", "replica.refresh_errors")}
    try:
        t = WalTailer(r, interval_s=0.01)
        assert t.run_once() and not t.stale()
        faultpoints.arm("replica.refresh", "ioerror", count=1000)
        try:
            assert not t.run_once()
            assert t.errors == 1 and "OSError" in t.last_error
            time.sleep(0.06)
            assert not t.run_once()
            assert t.stale()
            h = t.health()
            assert h["ok"] is False and h["stale"] is True
            assert h["lag_ms"] > 40.0
        finally:
            faultpoints.disarm("replica.refresh")
        assert t.run_once()
        assert not t.stale(), "a clean catch-up resets the clock"
        assert METRICS.counter("replica.refreshes").value - \
            c0["replica.refreshes"] == 2
        assert METRICS.counter("replica.refresh_errors").value - \
            c0["replica.refresh_errors"] == 2
        assert METRICS.timer("replica.refresh").count >= 4
        # The gauge reads the newest tailer.
        t2 = WalTailer(r)
        assert METRICS.gauge("replica.lag_ms", None).fn == t2.lag_ms
    finally:
        r.shutdown()
        w.shutdown()


def test_dead_writer_leaves_replica_fresh(tmp_path):
    w = make_writer(tmp_path)
    ingest(w, 100)
    w.shutdown()
    r = make_replica(tmp_path, max_staleness_ms=30.0)
    try:
        t = WalTailer(r, interval_s=0.01)
        assert t.run_once()
        time.sleep(0.05)
        assert t.run_once()
        assert not t.stale()
    finally:
        r.shutdown()


def test_tailer_thread_and_stats_match_jax(tmp_path):
    """The tailer's thread tails a live writer; its health keys and
    collect_stats names are the JAX tailer's; a writer store is
    refused."""
    w = make_writer(tmp_path)
    ingest(w, 100)
    with pytest.raises(ValueError, match="READ-ONLY"):
        WalTailer(w)
    r = make_replica(tmp_path, max_staleness_ms=5000.0,
                     tail_interval_s=0.02)
    jr = make_jax_replica(tmp_path, max_staleness_ms=5000.0)
    try:
        t, jt = WalTailer(r), JaxTailer(jr, interval_s=0.02)
        assert t.interval_s == 0.02
        t.start()
        ingest(w, 100, t0=BT + 100 * 60)
        deadline = time.monotonic() + 10
        spec = QuerySpec("serve.m", {}, aggregator="count")
        while time.monotonic() < deadline:
            got = QueryExecutor(r).run(spec, BT, BT + 300 * 60)
            if got and float(got[0].values.sum()) == 200:
                break
            time.sleep(0.02)
        else:
            pytest.fail("the tailer thread never caught up")
        t.stop()
        assert t._thread is None and t.refreshes >= 1
        assert jt.run_once()
        assert set(t.health()) == set(jt.health())
        c, jc = StatsCollector("tsd"), StatsCollector("tsd")
        t.collect_stats(c)
        jt.collect_stats(jc)
        assert [ln.split()[0] for ln in c.lines] == \
            [ln.split()[0] for ln in jc.lines]
    finally:
        r.shutdown()
        jr.shutdown()
        w.shutdown()


# ---------------------------------------------------------------------------
# ReadOnlyRollupTier
# ---------------------------------------------------------------------------

def _rollup_answers(ex, spec_cls, end):
    out = []
    for agg, ds in (("sum", (3600, "sum")), ("max", (3600, "max")),
                    ("avg", (86400, "avg"))):
        res, plan, _ = ex.run_with_plan(
            spec_cls("serve.m", {}, aggregator=agg, downsample=ds),
            BT, end)
        out.append((plan, [(np.asarray(x.timestamps),
                            np.asarray(x.values)) for x in res]))
    return out


def _bit_equal(a, b):
    assert [p for p, _ in a] == [p for p, _ in b]
    for (_, ra), (_, rb) in zip(a, b):
        assert len(ra) == len(rb)
        for (ta, va), (tb, vb) in zip(ra, rb):
            np.testing.assert_array_equal(ta, tb)
            assert va.tobytes() == np.asarray(vb, va.dtype).tobytes()


def test_rollup_reads_bit_identical_to_writer_and_jax_replica(tmp_path):
    """A port writer with the tier; a port and a JAX replica over it
    serve the writer's rollup answers ("1h", "1d") bit for bit, and keep
    doing so while the writer folds new checkpoints and both tail."""
    from opentsdb_tpu_torch.rollup.tier import ReadOnlyRollupTier
    w = make_writer(tmp_path, rollups=True)
    ingest(w, 5000)
    w.checkpoint()
    r = make_replica(tmp_path, rollups=True)
    jr = make_jax_replica(tmp_path, rollups=True)
    try:
        assert isinstance(r.rollups, ReadOnlyRollupTier)
        assert r.rollups.ready and jr.rollups.ready
        assert r.rollups.refreshes == 1
        with pytest.raises(RuntimeError):
            r.rollups.begin_spill()
        exw, exr = QueryExecutor(w), QueryExecutor(r)
        exj = JaxExecutor(jr, backend="cpu")
        t = WalTailer(r, interval_s=0.01)
        jt = JaxTailer(jr, interval_s=0.01)
        for rnd in range(3):
            end = BT + (5000 + rnd * 500) * 60
            want = _rollup_answers(exw, QuerySpec, end)
            assert {p for p, _ in want} == {"1h", "1d"}
            _bit_equal(_rollup_answers(exr, QuerySpec, end), want)
            _bit_equal(_rollup_answers(exj, JaxSpec, end), want)
            ingest(w, 500, t0=BT + (5000 + rnd * 500) * 60,
                   base_val=rnd)
            w.checkpoint()
            assert t.run_once() and jt.run_once()
        assert r.rollups.refreshes == 4
    finally:
        r.shutdown()
        jr.shutdown()
        w.shutdown()


def test_pending_state_degrades_to_raw(tmp_path):
    w = make_writer(tmp_path, rollups=True)
    ingest(w, 3000)
    w.checkpoint()
    r = make_replica(tmp_path, rollups=True)
    try:
        assert r.rollups.ready
        # The writer opens its spill bracket: the replica parks the tier
        # not-ready (raw answers) instead of trusting mid-fold records.
        w.rollups._write_state(pending=True)
        r.refresh_replica()
        assert not r.rollups.ready
        spec = QuerySpec("serve.m", {}, aggregator="sum",
                         downsample=(3600, "sum"))
        ex = QueryExecutor(r)
        raw, plan, _ = ex.run_with_plan(spec, BT, BT + 3000 * 60)
        assert plan == "raw"
        w.rollups._write_state(pending=False)
        r.refresh_replica()
        assert r.rollups.ready
        served, plan, _ = ex.run_with_plan(spec, BT, BT + 3000 * 60)
        assert plan == "1h"
        np.testing.assert_array_equal(served[0].values, raw[0].values)
    finally:
        r.shutdown()
        w.shutdown()


def test_replica_adopts_a_tier_that_appears_later(tmp_path):
    """A replica that opened before the writer had a tier serves raw, and
    its refresh adopts the tier once the writer's first fold lands."""
    wal = str(tmp_path / "wal")
    w0 = make_writer(tmp_path)
    ingest(w0, 3000)
    w0.shutdown()
    r = make_replica(tmp_path, rollups=True)
    try:
        assert r.rollups is not None and not r.rollups.ready
        w = make_writer(tmp_path, rollups=True)
        w.checkpoint()
        r.refresh_replica()
        assert r.rollups.ready and os.path.exists(wal + ".rollup.json")
        _, plan, _ = QueryExecutor(r).run_with_plan(
            QuerySpec("serve.m", {}, aggregator="sum",
                      downsample=(3600, "sum")), BT, BT + 3000 * 60)
        assert plan == "1h"
        w.shutdown()
    finally:
        r.shutdown()


# ---------------------------------------------------------------------------
# The daemons
# ---------------------------------------------------------------------------

async def http_req(port, target, body=None):
    reader, writer = await asyncio.open_connection("127.0.0.1", port)
    method = "POST" if body is not None else "GET"
    data = body or b""
    writer.write(f"{method} {target} HTTP/1.1\r\nHost: x\r\n"
                 f"Content-Length: {len(data)}\r\n"
                 "Connection: close\r\n\r\n".encode() + data)
    await writer.drain()
    raw = await asyncio.wait_for(reader.read(), 30)
    writer.close()
    head, _, body = raw.partition(b"\r\n\r\n")
    headers = {}
    for ln in head.split(b"\r\n")[1:]:
        k, _, v = ln.partition(b":")
        headers[k.strip().lower().decode()] = v.strip().decode()
    return int(head.split(b" ", 2)[1]), headers, body


async def telnet(port, lines, first_alone=True):
    """The daemon's replies to ``lines`` (the first alone, on the
    per-line path; the rest as a pipelined burst), then ``exit``."""
    reader, writer = await asyncio.open_connection("127.0.0.1", port)
    if first_alone:
        writer.write((lines[0] + "\n").encode())
        await writer.drain()
        await asyncio.sleep(0.2)
        lines = lines[1:]
    writer.write(("\n".join(lines) + "\nexit\n").encode())
    await writer.drain()
    out = await asyncio.wait_for(reader.read(), 30)
    writer.close()
    return out


def serve(servers, drive):
    async def main():
        for s in servers:
            await s.start()
        try:
            return await drive(*[s.port for s in servers])
        finally:
            for s in servers:
                s._pool.shutdown(wait=False)
                s._server.close()
                await s._server.wait_closed()
    return asyncio.run(main())


PUTS = ["put serve.m 1357000000 5 host=a",
        "put serve.m 1357000060 6 host=a",
        "put serve.new 1357000060 6 host=zz"]


def test_replica_daemons_match_jax(tmp_path):
    """A port and a JAX replica daemon over one writer, each with a
    tailer: /healthz (200 fresh, 503 stale) with the JAX key sets, the
    /q stale tag per result and in X-Tsd-Degraded, telnet and /api/put
    refusals byte for byte, /api/tenants' role; and the writer daemon's
    /healthz keys."""
    w = make_writer(tmp_path)
    ingest(w, 300)
    r = make_replica(tmp_path, max_staleness_ms=500.0)
    jr = make_jax_replica(tmp_path, max_staleness_ms=500.0)
    ps, js, ws = TSDServer(r), JaxServer(jr), TSDServer(w)
    jw = JaxServer(JaxTSDB(JaxStore(), JaxConfig(backend="cpu",
                                                 device_window=False,
                                                 **LOOP),
                           start_compaction_thread=False))
    for s, T in ((ps, WalTailer), (js, JaxTailer)):
        s.attach_tailer(T(s.tsdb, interval_s=0.01))
    q = (f"/q?start={BT - 60}&end={BT + 400 * 60}"
         f"&m=sum:serve.m&json&nocache")
    body = b"serve.m 1357000120 7 host=a\nserve.m 1357000180 8 host=b\n"

    async def drive(pp, jp, wp, jwp):
        out = {}
        for name, port, s in (("port", pp, ps), ("jax", jp, js)):
            s.tailer.run_once()
            fresh = await http_req(port, "/healthz")
            qf = await http_req(port, q)
            await asyncio.sleep(0.6)
            stale = await http_req(port, "/healthz")
            qs = await http_req(port, q)
            put = await telnet(port, PUTS)
            api = await http_req(port, "/api/put", body)
            ten = await http_req(port, "/api/tenants")
            out[name] = (fresh, qf, stale, qs, put, api, ten)
        out["writers"] = (await http_req(wp, "/healthz"),
                          await http_req(jwp, "/healthz"))
        return out

    try:
        out = serve([ps, js, ws, jw], drive)
    finally:
        for t in (r, jr, w, jw.tsdb):
            t.shutdown()
    P, J = out["port"], out["jax"]
    for (fp, qfp, sp, qsp, *_), tag in ((P, "port"), (J, "jax")):
        assert fp[0] == 200 and json.loads(fp[2])["ok"] is True, tag
        assert "x-tsd-degraded" not in qfp[1]
        assert all("degraded" not in e for e in json.loads(qfp[2]))
        assert sp[0] == 503 and json.loads(sp[2])["stale"] is True
        assert qsp[0] == 200 and qsp[1]["x-tsd-degraded"] == "stale"
        res = json.loads(qsp[2])
        assert res and all(e["degraded"] == "stale" for e in res)
    for i in (0, 2):
        assert set(json.loads(P[i][2])) == set(json.loads(J[i][2]))
    # The same answer under the stale tag.
    assert json.loads(P[3][2])[0]["dps"] == json.loads(J[3][2])[0]["dps"]
    assert P[4] == J[4] and b"put: read-only replica: " in P[4]
    assert P[5][0] == J[5][0] == 200 and P[5][2] == J[5][2]
    assert b"read-only replica" in P[5][2]
    assert json.loads(P[6][2]) == json.loads(J[6][2]) == {
        "enabled": False, "role": "replica"}
    (wst, _, wb), (jst, _, jb) = out["writers"]
    assert wst == jst == 200
    assert set(json.loads(wb)) == set(json.loads(jb))
    assert json.loads(wb)["role"] == "writer"
    assert json.loads(wb)["read_only"] is False


def _fenced_daemon_replies(tmp_path, pkg):
    """A cluster writer daemon of ``pkg`` at epoch 1 over tmp_path/wal,
    fenced by a bump to 2: its telnet and /api/put replies and /healthz."""
    wal = str(tmp_path / "wal")
    shutil.rmtree(tmp_path, ignore_errors=True)
    os.makedirs(tmp_path)
    ep = (port_epoch if pkg == "port" else jax_epoch)
    epath = ep.epoch_path_for_wal(wal)
    ep.write_epoch(epath, 1, "w")
    if pkg == "port":
        store = MemKVStore(wal_path=wal, writer_epoch=1,
                           epoch_guard=ep.EpochGuard(epath, 1, 0.0))
        t = TSDB(store, Config(device="cpu", backend="cpu",
                               auto_create_metrics=True,
                               enable_sketches=False, device_window=False,
                               **LOOP),
                 start_compaction_thread=False)
        server = TSDServer(t)
    else:
        store = JaxStore(wal_path=wal, writer_epoch=1,
                         epoch_guard=ep.EpochGuard(epath, 1, 0.0))
        t = JaxTSDB(store, JaxConfig(backend="cpu", auto_create_metrics=True,
                                     enable_sketches=False,
                                     device_window=False, **LOOP),
                    start_compaction_thread=False)
        server = JaxServer(t)
    ingest(t, 10)

    async def drive(port):
        ep.bump_epoch(epath, "promoted", expect=1)
        put = await telnet(port, PUTS)
        api = await http_req(port, "/api/put",
                             b"serve.m 1357000120 7 host=a\n")
        health = await http_req(port, "/healthz")
        return put, api, health

    try:
        return serve([server], drive)
    finally:
        try:
            t.shutdown()
        except Exception as e:
            assert "superseded" in str(e)


def test_fenced_writer_replies_match_jax(tmp_path):
    """A writer deposed by an epoch bump refuses every put with the JAX
    daemon's bytes (the per-line "superseded by epoch" line, the burst's
    [fenced] line, the /api/put body) and /healthz says fenced."""
    jp, ja, jh = _fenced_daemon_replies(tmp_path / "x", "jax")
    pp, pa, ph = _fenced_daemon_replies(tmp_path / "x", "port")
    assert pp == jp
    assert b"put: fenced writer (superseded by epoch 2): " in pp
    assert b"put: fenced writer: serve." in pp and b"[fenced]" in pp
    assert pa == ja and pa[0] == 200
    assert ph[0] == jh[0] == 200
    hp, hj = json.loads(ph[2]), json.loads(jh[2])
    assert set(hp) == set(hj)
    assert hp["fenced"] is True and hp["fenced_by_epoch"] == 2
    assert hp["writer_epoch"] == 1


def test_fault_route_arms_and_clears(tmp_path):
    w = make_writer(tmp_path)
    server = TSDServer(w)

    async def drive(port):
        a = await http_req(port, "/fault?arm=replica.refresh=ioerror"
                                 ":count=3")
        b = await http_req(port, "/fault?arm=nonsense")
        c = await http_req(port, "/fault?clear=1")
        return a, b, c

    try:
        a, b, c = serve([server], drive)
    finally:
        faultpoints.clear()
        w.shutdown()
    assert a[0] == 200 and "replica.refresh" in json.loads(a[2])["armed"]
    assert b[0] == 400
    assert c[0] == 200 and json.loads(c[2])["armed"] == {}


def test_cmd_tsd_roles(monkeypatch, tmp_path):
    """``tsd --role replica`` opens the store read-only under the role's
    5,000 ms contract and attaches a started tailer; ``--role router``
    starts a ``RouterServer`` over ``--backends`` without opening a store;
    ``--read-only`` polls every 5 s."""
    import opentsdb_tpu_torch.serve.router as prouter
    from opentsdb_tpu_torch.tools import cli as pcli
    w = make_writer(tmp_path)
    ingest(w, 10)
    seen = {}

    class FakeServer:
        port = 0

        def __init__(self, tsdb):
            self.tsdb, self.tailer = tsdb, None

        def attach_tailer(self, tailer):
            self.tailer = tailer

        async def start(self):
            pass

        async def serve_forever(self):
            seen["store_read_only"] = self.tsdb.store.read_only
            seen["cfg"] = (self.tsdb.config.role,
                           self.tsdb.config.max_staleness_ms,
                           self.tsdb.config.checkpoint_interval)
            seen["tailer"] = (self.tailer is not None
                              and self.tailer._thread is not None)
            if self.tailer is not None:
                self.tailer.stop()
            self.tsdb.shutdown()

        def request_shutdown(self):
            pass

    class FakeRouter:
        port = 0

        def __init__(self, cfg):
            seen["router"] = cfg

        async def start(self):
            pass

        async def serve_forever(self):
            pass

        def request_shutdown(self):
            pass

    monkeypatch.setattr(pcli, "tune_for_ingest", lambda: None)
    monkeypatch.setattr("opentsdb_tpu_torch.server.tsd.TSDServer", FakeServer)
    monkeypatch.setattr(prouter, "RouterServer", FakeRouter)
    base = ["tsd", "--device", "cpu", "--port", "0",
            "--wal", str(tmp_path / "wal")]
    try:
        assert pcli.main(base + ["--role", "replica"]) == 0
        assert seen == {"store_read_only": True,
                        "cfg": ("replica", 5000.0, 0.0), "tailer": True}
        assert pcli.main(base + ["--read-only"]) == 0
        assert seen["store_read_only"] and not seen["tailer"]
        assert seen["cfg"] == ("writer", 0.0, 5.0)
        assert pcli.main(["tsd", "--port", "0", "--role", "router",
                          "--backends", "http://127.0.0.1:1",
                          "--writer-url", "http://127.0.0.1:2"]) == 0
        cfg = seen["router"]
        assert (cfg.role, cfg.router_backends, cfg.writer_url) == (
            "router", ("http://127.0.0.1:1",), "http://127.0.0.1:2")
    finally:
        w.shutdown()
