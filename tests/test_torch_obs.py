"""The port's observability layer (``opentsdb_tpu_torch/obs/``, the stats
collector, the log ring) against the JAX package's: the registry, spans,
trace ring and collector alone, then the same seeded ingest and queries
through both daemons (``device="cpu"``): the ``/stats`` names and
counters, the ``/metrics`` families, the ``?trace=1`` span trees, and the
operator routes' bodies."""

import asyncio
import json
import logging
import sys
import time

import numpy as np
import pytest

from opentsdb_tpu.core.tsdb import TSDB as JaxTSDB
from opentsdb_tpu.fault import faultpoints as jax_fp
from opentsdb_tpu.obs import trace as jax_trace
from opentsdb_tpu.obs.registry import METRICS as JAX_METRICS
from opentsdb_tpu.obs.registry import MetricsRegistry as JaxRegistry
from opentsdb_tpu.obs.ring import make_record as jax_make_record
from opentsdb_tpu.server.tsd import TSDServer as JaxServer
from opentsdb_tpu.stats.collector import LatencyDigest as JaxDigest
from opentsdb_tpu.stats.collector import StatsCollector as JaxCollector
from opentsdb_tpu.storage.kv import MemKVStore as JaxStore
from opentsdb_tpu.storage.sharded import ShardedKVStore as JaxSharded
from opentsdb_tpu.tools import fsck as jax_fsck  # noqa: F401 (registers)
from opentsdb_tpu.utils.config import Config as JaxConfig
from opentsdb_tpu_torch.core.tsdb import TSDB
from opentsdb_tpu_torch.fault import faultpoints
from opentsdb_tpu_torch.obs import trace as obs_trace
from opentsdb_tpu_torch.obs.registry import (METRICS, MetricsRegistry,
                                             read_rss_bytes)
from opentsdb_tpu_torch.obs.ring import TraceRing, make_record
from opentsdb_tpu_torch.obs.selfmon import SelfMonitor
from opentsdb_tpu_torch.server import logbuffer
from opentsdb_tpu_torch.server.tsd import TSDServer
from opentsdb_tpu_torch.stats.collector import LatencyDigest, StatsCollector
from opentsdb_tpu_torch.storage.kv import MemKVStore
from opentsdb_tpu_torch.storage.sharded import ShardedKVStore
from opentsdb_tpu_torch.tools import fsck as port_fsck
from opentsdb_tpu_torch.utils.config import Config
from test_obs import validate_exposition

BT = 1356998400
HOUR = 3600

# /stats lines and /metrics families of the JAX daemon that the ``both``
# comparisons leave out, by prefix, each with the ROADMAP queue A item
# that brings its tier: expert-parallel serving's ``mesh.expert.*``
# (11b: both daemons register them at their first expert attempt, so
# ``test_expert_instrument_names_equal_jax`` compares them on daemons
# that make one), the router's and cluster's
# instruments (10b), and those of the rollup tier module (6), which other
# tests in the process may have imported. ``both_rollups`` compares the
# rollup ones with both tiers on. The mesh plane's ``mesh.*`` (11a) is
# compared: both daemons register it at import. Approximate serving's
# ``sketch.*`` instruments (9) are compared too: both daemons register
# them in /q; so are the replica tailer's ``replica.*`` (10a), registered
# at import.
LEFT_OUT = ("rollup", "mesh.expert", "mesh_expert", "router", "cluster")
# The router's and the promotion manager's instruments (``router.*``,
# ``cluster.*``, item 10b) register when their modules are imported, in
# either package; other test files import both (METRICS is process-wide),
# so they are left out of the port's names as of the JAX daemon's. The
# router's own surface is held against the JAX router's in
# tests/test_torch_router.py.
PORT_LEFT_OUT = ("router", "cluster")
# The port's rollup tier module, which registers the tier's instruments
# when it is imported: only a daemon with the tier on imports it.
PORT_TIER = "opentsdb_tpu_torch.rollup.tier"
# Instruments that exist only once their event happened in the process
# (METRICS is process-wide in each package): the fused plan's declines,
# which other tests in the same worker may have counted in one package,
# and the replica lag gauge, registered by the first WalTailer built.
HISTORY = ("compress.fused.decline", "compress_fused_decline",
           "replica.lag_ms", "replica_lag_ms")


def _left_out(name: str) -> bool:
    """A /stats name (tsd.x.y) or /metrics family (tsd_x_y) of a left-out
    tier."""
    rest = name[4:]
    return any(rest.startswith(t + sep) for t in LEFT_OUT
               for sep in "._")


def _history(name: str) -> bool:
    return name[4:] in HISTORY


def _port_names(names, got) -> set:
    """The port daemon's /stats names or /metrics families, history
    aside. The rollup tier's instruments are left out only when another
    test in this process had imported the port's tier module before the
    daemon ran (METRICS is process-wide); the daemon itself, tier off,
    never imports it (test_tier_off_daemon_imports_no_tier_module)."""
    return {n for n in names if not _history(n)
            and not n[4:].startswith(tuple(
                t + sep for t in PORT_LEFT_OUT for sep in "._"))
            and not (got["tier_preloaded"]
                     and n[4:].startswith(("rollup.", "rollup_")))}


def _no_ms(d):
    """A span tree without its timings."""
    out = {"name": d["name"], "tags": d.get("tags", {})}
    if "spans" in d:
        out["spans"] = [_no_ms(c) for c in d["spans"]]
    return out


def _names(tree) -> set:
    out = {tree["name"]}
    for c in tree.get("spans", ()):
        out |= _names(c)
    return out


# ---------------------------------------------------------------------------
# Registry
# ---------------------------------------------------------------------------

def test_counter_gauge_timer_roundtrip():
    r = MetricsRegistry()
    r.counter("c").inc()
    r.counter("c").inc(2)
    r.gauge("g", lambda: 7)
    with r.timer("t").time():
        pass
    r.timer("t").observe(5.0)
    c = StatsCollector("tsd", host_tag=False)
    r.collect(c)
    lines = {ln.split()[0]: ln for ln in c.lines}
    assert lines["tsd.c"].split()[2] == "3"
    assert lines["tsd.g"].split()[2] == "7"
    assert lines["tsd.t.count"].split()[2] == "2"
    assert "tsd.t" in lines
    assert any("percentile=99" in ln for ln in c.lines)


def test_same_key_same_instrument():
    r = MetricsRegistry()
    assert r.counter("x") is r.counter("x")
    assert r.counter("x", {"a": "1"}) is not r.counter("x")
    assert r.timer("t", {"s": "0"}) is r.timer("t", {"s": "0"})


def test_kind_conflict_rejected():
    r = MetricsRegistry()
    r.counter("x")
    with pytest.raises(ValueError):
        r.timer("x")


def test_failing_gauge_skipped():
    r = MetricsRegistry()
    r.gauge("bad", lambda: 1 / 0)
    c = StatsCollector("tsd", host_tag=False)
    r.collect(c)
    assert c.lines == []
    validate_exposition(r.prometheus_text())


def test_prometheus_text_valid_and_typed():
    r = MetricsRegistry()
    r.counter("wal.appends").inc(5)
    r.gauge("mem", lambda: 3.5)
    r.timer("ckpt.phase", {"phase": "freeze"}).observe(10.0)
    r.timer("ckpt.phase", {"phase": "commit"}).observe(20.0)
    text = r.prometheus_text()
    assert validate_exposition(text) == 1 + 1 + 2 * 5
    assert "# TYPE tsd_wal_appends counter" in text
    assert "# TYPE tsd_ckpt_phase_ms summary" in text
    assert 'phase="freeze",quantile="0.5"' in text


def test_prometheus_extra_lines_merge_and_dedup():
    r = MetricsRegistry()
    r.counter("dup").inc(9)
    now = int(time.time())
    text = r.prometheus_text(extra_lines=[
        f"tsd.dup {now} 1 host=x",
        f"tsd.classic {now} 2 host=x a=b",
        f"tsd.classic {now} 3 host=x a=b",
        f"tsd.classic {now} 4 host=x a=c",
        "malformed line",
    ])
    validate_exposition(text)
    assert "tsd_dup 9" in text
    assert text.count("tsd_classic{") == 2


def test_rss_readable():
    assert read_rss_bytes() > 1 << 20


def test_submillisecond_timer_percentiles_survive_collect():
    r = MetricsRegistry()
    t = r.timer("fast")
    for v in (0.4, 0.5, 0.6):
        t.observe(v)
    c = StatsCollector("tsd", host_tag=False)
    r.collect(c)
    p50 = next(ln for ln in c.lines if "percentile=50" in ln)
    assert 0.3 < float(p50.split()[2]) < 0.7


def test_no_duplicate_timer_spellings_in_metrics():
    r = MetricsRegistry()
    r.timer("dup.t").observe(2.0)
    c = StatsCollector("tsd", host_tag=False)
    r.collect(c)
    text = r.prometheus_text(extra_lines=c.lines)
    validate_exposition(text)
    assert "tsd_dup_t_ms_count" in text
    assert "# TYPE tsd_dup_t_count" not in text
    assert "# TYPE tsd_dup_t gauge" not in text


def _fill(r, rng):
    r.counter("wal.appends").inc(int(rng.integers(1, 100)))
    r.counter("x.y", {"k": "v"}).inc(3)
    r.gauge("g.z", lambda: 2.5, {"shard": "1"})
    t = r.timer("checkpoint.phase", {"phase": "spill"})
    for v in rng.gamma(2.0, 3.0, 500):
        t.observe(float(v))
    r.timer("ingest.parse").observe(0.25)


def test_registry_exports_equal_jax():
    """The same instruments and observations into both registries: the
    /stats lines (timestamps aside) and the Prometheus text equal."""
    regs = []
    for cls in (JaxRegistry, MetricsRegistry):
        r = cls()
        _fill(r, np.random.default_rng(7))
        regs.append(r)
    lines = []
    for r, coll in zip(regs, (JaxCollector, StatsCollector)):
        c = coll("tsd")
        r.collect(c)
        lines.append([ln.split(" ", 2)[0::2] for ln in c.lines])
    assert lines[0] == lines[1]
    extra = [f"tsd.classic {BT} 4 host=x a=c"]
    assert (regs[0].prometheus_text(extra_lines=extra)
            == regs[1].prometheus_text(extra_lines=extra))


# ---------------------------------------------------------------------------
# Collector and latency digest
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dist", ["small", "uniform", "lognormal",
                                  "bimodal", "over_fold"])
def test_latency_digest_equals_jax(dist):
    rng = np.random.default_rng(11)
    sample = {
        "small": np.array([3.0, 1.0, 2.0, 9.0]),
        "uniform": rng.uniform(0, 100, 2000),
        "lognormal": rng.lognormal(1.0, 1.2, 5000),
        "bimodal": np.concatenate([rng.normal(5, 1, 3000),
                                   rng.normal(200, 10, 300)]),
        "over_fold": rng.exponential(4.0, 20000),   # folds twice
    }[dist]
    a, b = JaxDigest(), LatencyDigest()
    for v in sample:
        a.add(v)
        b.add(v)
    for p in (0, 50, 75, 90, 95, 99, 99.9, 100):
        assert a.percentile(p) == b.percentile(p)
    assert a.count == b.count == len(sample)


def test_empty_digest_is_zero():
    assert LatencyDigest().percentile(99) == 0.0


def test_collector_lines_equal_jax():
    out = []
    for coll, dig in ((JaxCollector, JaxDigest), (StatsCollector,
                                                  LatencyDigest)):
        c = coll("tsd")
        c.add_extra_tag("role=w")
        c.record("a.b", 3)
        c.record("a.f", 2.5, "k=v")
        d = dig()
        for v in range(100):
            d.add(v)
        c.record("lat", d, "type=x")
        c.clear_extra_tag("role")
        c.record("after", 1)
        out.append([ln.split(" ", 2)[0::2] for ln in c.lines])
    assert out[0] == out[1]
    with pytest.raises(ValueError):
        StatsCollector("tsd").record("x", 1, "novalue")


def test_collector_emit_callback():
    got = []
    c = StatsCollector("p", emit=got.append, host_tag=False)
    c.record("n", 1)
    assert got == c.lines and got[0].startswith("p.n ")


# ---------------------------------------------------------------------------
# Spans and the trace ring
# ---------------------------------------------------------------------------

def test_span_noop_when_inactive():
    assert obs_trace.current_span() is None
    with obs_trace.span("x") as sp:
        assert sp is None


def test_span_tree_shape_and_timing():
    tr = obs_trace.Trace("q1", {"k": "v"})
    with obs_trace.activate(tr):
        with obs_trace.span("a", tag=1):
            with obs_trace.span("a.1"):
                time.sleep(0.01)
        with obs_trace.span("b"):
            pass
    assert obs_trace.current_span() is None
    d = tr.to_dict()
    assert d["name"] == "query" and d["tags"]["q"] == "q1"
    assert [c["name"] for c in d["spans"]] == ["a", "b"]
    assert d["spans"][0]["spans"][0]["name"] == "a.1"
    assert d["spans"][0]["ms"] >= d["spans"][0]["spans"][0]["ms"] >= 9
    assert d["ms"] >= d["spans"][0]["ms"]


def test_timed_iter_accumulates_and_attaches():
    tr = obs_trace.Trace("q")
    with obs_trace.activate(tr):
        parent = obs_trace.current_span()

        def gen():
            yield 1
            time.sleep(0.01)
            yield 2

        out = list(obs_trace.timed_iter(gen(), parent, "shard.scan",
                                        {"shard": 0}))
    assert out == [1, 2]
    (sp,) = tr.root.children
    assert sp.name == "shard.scan" and sp.tags == {"shard": 0, "rows": 2}
    assert sp.ms >= 9


def _span_program(mod):
    tr = mod.Trace("sum:m", {"z": 1}, trace_id="00ff")
    with mod.activate(tr):
        with mod.span("planner.pick", plan="raw"):
            pass
        with mod.span("scan") as sp:
            sp.tags["cached"] = False
            list(mod.timed_iter(iter(range(3)), sp, "shard.scan",
                                {"shard": 1}))
        with mod.span("aggregate"):
            pass
    return tr


def test_span_trees_equal_jax():
    a, b = _span_program(jax_trace), _span_program(obs_trace)
    assert _no_ms(a.to_dict()) == _no_ms(b.to_dict())
    ra = jax_make_record("sum:m", a, "raw", False, 0.0, 2, False)
    rb = make_record("sum:m", b, "raw", False, 0.0, 2, False)
    assert sorted(ra) == sorted(rb)
    for k in ("trace_id", "q", "plan", "cached", "slow", "shards",
              "replica"):
        assert ra[k] == rb[k], k


def test_ring_capacity_and_counts():
    ring = TraceRing(2)
    tr = obs_trace.Trace("q")
    with obs_trace.activate(tr):
        pass
    for i in range(3):
        ring.add(make_record(f"q{i}", tr, "raw", False,
                             slow_ms=0 if i < 2 else 1e9, shards=1,
                             replica=False))
    assert len(ring) == 2 and ring.recorded == 3
    assert [r["q"] for r in ring.snapshot()] == ["q1", "q2"]


def test_ring_record_shape():
    tr = obs_trace.Trace("sum:m")
    with obs_trace.activate(tr):
        with obs_trace.span("scan"):
            time.sleep(0.002)
    rec = make_record("sum:m", tr, "raw", True, slow_ms=0.001, shards=4,
                      replica=False)
    assert rec["slow"] is True and rec["plan"] == "raw"
    assert rec["cached"] is True and rec["shards"] == 4
    assert rec["wall_ms"] >= 2
    assert rec["trace"]["spans"][0]["name"] == "scan"
    json.dumps(rec)


# ---------------------------------------------------------------------------
# Log ring
# ---------------------------------------------------------------------------

def test_log_ring_formats_newest_first_and_sets_level():
    ring = logbuffer.RingBufferHandler(capacity=3)
    log = logging.getLogger("opentsdb_tpu_torch.test_obs_ring")
    log.addHandler(ring)
    log.setLevel(logging.INFO)
    try:
        for i in range(4):
            log.info("event %d", i)
    finally:
        log.removeHandler(ring)
    lines = ring.formatted()
    assert len(lines) == 3 and lines[0].endswith("event 3")
    assert lines[0].split("\t")[1:4:2] == [
        "INFO", "opentsdb_tpu_torch.test_obs_ring"]
    root = logging.getLogger()
    old = root.level
    try:
        logbuffer.set_level("error")
        assert root.level == logging.ERROR
        with pytest.raises(ValueError, match="Unrecognized"):
            logbuffer.set_level("loud")
    finally:
        root.setLevel(old)


# ---------------------------------------------------------------------------
# Engine instruments
# ---------------------------------------------------------------------------

def _port_tsdb(wal=None, **kw):
    cfg = dict(auto_create_metrics=True, device="cpu", backend="cpu",
               enable_sketches=False, device_window=False)
    cfg.update(kw)
    return TSDB(MemKVStore(wal_path=wal), Config(**cfg),
                start_compaction_thread=False)


def test_wal_fsync_delay_lengthens_exactly_that_span(tmp_path):
    """An armed delay on kv.wal.fsync stretches the wal.fsync span of a
    traced ingest, with a fault.delay child naming the site; the next,
    disarmed ingest's span is short again."""
    tsdb = _port_tsdb(str(tmp_path / "wal"))
    try:
        faultpoints.arm("kv.wal.fsync", "delay", delay=0.15, count=1)
        tr = obs_trace.Trace("ingest")
        with obs_trace.activate(tr):
            tsdb.add_point("m.delay", BT, 1, {"h": "a"})
        faultpoints.clear()
        d = tr.to_dict()
        fsync = [s for s in d.get("spans", []) if s["name"] == "wal.fsync"]
        assert fsync and fsync[0]["ms"] >= 140
        (child,) = fsync[0]["spans"]
        assert child["name"] == "fault.delay"
        assert child["tags"]["site"] == "kv.wal.fsync"
        for s in d["spans"]:
            if s["name"] != "wal.fsync":
                assert s["ms"] < 100
        tr2 = obs_trace.Trace("ingest2")
        with obs_trace.activate(tr2):
            tsdb.add_point("m.delay", BT + 10, 2, {"h": "a"})
        fsync2 = [s for s in tr2.to_dict().get("spans", [])
                  if s["name"] == "wal.fsync"]
        assert fsync2 and fsync2[0]["ms"] < 100
        assert not fsync2[0].get("spans")
    finally:
        faultpoints.clear()
        tsdb.shutdown()


def test_wal_and_checkpoint_instruments(tmp_path):
    """One columnar batch: one WAL record counted with its bytes and one
    wal.append observation; a checkpoint observes each phase once; with
    fsync on, wal.fsync times the fsync."""
    tsdb = _port_tsdb(str(tmp_path / "wal"))
    try:
        tsdb.store._fsync = True
        appends, nbytes = (METRICS.counter("wal.appends"),
                           METRICS.counter("wal.append_bytes"))
        app, fsync = METRICS.timer("wal.append"), METRICS.timer("wal.fsync")
        tsdb.add_point("m.i", BT, 1, {"h": "a"})   # mints the UIDs
        a0, b0, t0, f0 = appends.value, nbytes.value, app.count, fsync.count
        size0 = tsdb.store._wal.tell()
        tsdb.add_batch("m.i", BT + np.arange(1, 4000, 10),
                       np.ones(400), {"h": "a"})
        assert appends.value == a0 + 1 and app.count == t0 + 1
        assert nbytes.value - b0 == tsdb.store._wal.tell() - size0
        assert fsync.count == f0 + 1
        phases = [METRICS.timer("checkpoint.phase", {"phase": p})
                  for p in ("freeze", "spill", "commit")]
        before = [t.count for t in phases]
        assert tsdb.checkpoint() > 0
        assert [t.count for t in phases] == [b + 1 for b in before]
    finally:
        tsdb.shutdown()


def test_fsck_records_duration_sample():
    tsdb = _port_tsdb()
    tsdb.add_point("m.fsck", BT, 1, {"h": "a"})
    t = METRICS.timer("fsck.duration")
    before = t.count
    rep = port_fsck.run_fsck(tsdb)
    assert rep.errors == 0
    assert t.count == before + 1
    tsdb.shutdown()


def test_uid_suggest_and_caches_match_jax():
    jt = JaxTSDB(JaxStore(), JaxConfig(auto_create_metrics=True,
                                       enable_sketches=False,
                                       device_window=False,
                                       backend="cpu"),
                 start_compaction_thread=False)
    pt = _port_tsdb()
    try:
        for t in (jt, pt):
            for i in range(30):
                t.add_point(f"sys.m{i % 7}.x", BT + i, i,
                            {"host": f"h{i:02d}", "dc": f"d{i % 3}"})
            t.drop_caches()
            t.metrics.get_id("sys.m1.x")
        for kind in ("metrics", "tagk", "tagv"):
            for prefix in ("", "sys.m", "h0", "d", "\xff", "zz"):
                a = getattr(jt, {"metrics": "metrics", "tagk": "tagk",
                                 "tagv": "tagv"}[kind])
                b = getattr(pt, kind)
                assert a.suggest(prefix, 5) == b.suggest(prefix, 5)
        assert jt.suggest_metrics("sys") == pt.suggest_metrics("sys")
        assert jt.suggest_tag_names() == pt.suggest_tag_names()
        assert jt.suggest_tag_values("d") == pt.suggest_tag_values("d")
        for a, b in ((jt.metrics, pt.metrics), (jt.tagk, pt.tagk),
                     (jt.tagv, pt.tagv)):
            assert (a.kind(), a.cache_hits, a.cache_misses,
                    a.cache_size()) == (b.kind(), b.cache_hits,
                                        b.cache_misses, b.cache_size())
    finally:
        jt.shutdown()
        pt.shutdown()


# ---------------------------------------------------------------------------
# Self-monitor
# ---------------------------------------------------------------------------

def test_selfmon_timestamps_strictly_monotonic():
    tsdb = _port_tsdb()
    mon = SelfMonitor(tsdb, lambda: [f"tsd.x {int(time.time())} 1"], 0.0)
    assert mon.run_once() == 1
    t1 = mon._last_ts
    assert mon.run_once() == 1
    assert mon._last_ts > t1
    tsdb.shutdown()


def test_selfmon_reentrancy_guard():
    tsdb = _port_tsdb()
    inner = []
    mon = None

    def stats_fn():
        inner.append(mon.run_once())
        return [f"tsd.x {int(time.time())} 1"]

    mon = SelfMonitor(tsdb, stats_fn, 0.0)
    assert mon.run_once() == 1
    assert inner == [0]
    tsdb.shutdown()


def test_selfmon_thread_cycles_and_stops():
    tsdb = _port_tsdb()
    mon = SelfMonitor(tsdb, lambda: [f"tsd.y {int(time.time())} 2.5 a=b"],
                      0.02)
    mon.start()
    deadline = time.time() + 10
    while mon.cycles < 2 and time.time() < deadline:
        time.sleep(0.01)
    mon.stop()
    assert mon.cycles >= 2 and mon.errors == 0
    n = mon.cycles
    time.sleep(0.05)
    assert mon.cycles == n
    tsdb.shutdown()


def test_selfmon_thread_runs_on_the_tsdbs_card(monkeypatch):
    """A TSDB on "cuda" (the constructing thread's card, here 3): the loop's
    thread makes that card current before its first cycle."""
    import types
    import torch
    calls = []
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 3)
    monkeypatch.setattr(torch.cuda, "set_device", calls.append)
    fake = types.SimpleNamespace(device=torch.device("cuda"))
    mon = SelfMonitor(fake, lambda: [], 0.01)
    mon.start()
    deadline = time.time() + 10
    while mon.cycles < 1 and time.time() < deadline:
        time.sleep(0.01)
    mon.stop()
    assert calls == [3] and mon.cycles >= 1
    fake.device = torch.device("cuda", 1)
    assert SelfMonitor(fake, lambda: [], 0.01)._cuda_index == 1


# ---------------------------------------------------------------------------
# Both daemons over the same seeded traffic
# ---------------------------------------------------------------------------

async def _http(port, target):
    reader, writer = await asyncio.open_connection("127.0.0.1", port)
    writer.write(f"GET {target} HTTP/1.1\r\nHost: x\r\n"
                 "Connection: close\r\n\r\n".encode())
    await writer.drain()
    raw = await asyncio.wait_for(reader.read(), 60)
    writer.close()
    head, _, body = raw.partition(b"\r\n\r\n")
    return int(head.split()[1]), body


async def _post(port, target, body: bytes):
    reader, writer = await asyncio.open_connection("127.0.0.1", port)
    writer.write((f"POST {target} HTTP/1.1\r\nHost: x\r\n"
                  f"Content-Length: {len(body)}\r\nConnection: close"
                  "\r\n\r\n").encode() + body)
    await writer.drain()
    raw = await asyncio.wait_for(reader.read(), 60)
    writer.close()
    return int(raw.split(b" ", 2)[1])


async def _telnet(port, lines, alone_first=False):
    reader, writer = await asyncio.open_connection("127.0.0.1", port)
    if alone_first:
        writer.write((lines[0] + "\n").encode())
        await writer.drain()
        await asyncio.sleep(0.2)
        lines = lines[1:]
    writer.write(("\n".join(lines) + "\nexit\n").encode())
    await writer.drain()
    out = await asyncio.wait_for(reader.read(), 60)
    writer.close()
    return out


def _put_lines(seed=21):
    rng = np.random.default_rng(seed)
    out = []
    for h in ("h0", "h1", "h2"):
        ts = np.sort(rng.choice(12 * HOUR, 300, replace=False)) + BT
        for t in ts.tolist():
            out.append(f"put obs.m {t} {round(float(rng.normal(9, 2)), 3)} "
                       f"host={h} dc=d{int(h[1]) % 2}")
    return out


Q = f"/q?start={BT}&end={BT + 12 * HOUR}&json"
QUERIES = {
    "raw_cold": Q + "&m=sum:1h-avg:obs.m&trace=1",
    "untraced": Q + "&m=sum:1h-avg:obs.m",
    "raw_miss": Q + "&m=sum:1h-avg:obs.m&trace=1",
    "raw_hit": Q + "&m=sum:1h-avg:obs.m&trace=1",
    "group_by": Q + "&m=max:30m-max:obs.m%7Bhost=*%7D&trace=1",
    "filter": Q + "&m=sum:obs.m%7Bdc=d0%7D&trace=1",
}
ROUTES = ["/suggest?type=metrics&q=obs", "/suggest?type=tagk",
          "/suggest?type=tagv&q=h&max=2", "/suggest?type=bad",
          "/suggest?max=x", "/dropcaches", "/favicon.ico",
          "/logs?level=loud"]


def _scenario(server, tsdb):
    """The same requests to either daemon; returns what it answered and
    the registry counters' deltas over the run."""
    lines = _put_lines()

    async def main():
        await server.start()
        port = server.port
        out = {}
        try:
            reg = (JAX_METRICS if isinstance(server, JaxServer)
                   else METRICS)
            c0 = {n: reg.counter(n).value
                  for n in ("wal.appends", "wal.append_bytes")}
            said = await _telnet(port, lines[:1] + lines[1:400]
                                 + ["put obs.m x 1 host=h0"] + lines[400:],
                                 alone_first=True)
            out["put_errors"] = said.count(b"illegal argument")
            out["api_put"] = await _post(
                port, "/api/put?tenant=web",
                f"obs.m {BT + 7} 1 host=h9 dc=d1\n".encode())
            fp = jax_fp if isinstance(server, JaxServer) else faultpoints
            fp.arm("query.scan", "delay", delay=0.001, count=1)
            try:
                out["raw_cold"] = await _http(port, QUERIES["raw_cold"])
            finally:
                fp.clear()
            out["untraced"] = await _http(port, QUERIES["untraced"])
            tsdb.checkpoint()
            for k in ("raw_miss", "raw_hit", "group_by", "filter"):
                out[k] = await _http(port, QUERIES[k])
            out["routes"] = {r: await _http(port, r) for r in ROUTES}
            out["help"] = await _telnet(port, ["help", "dropcaches"])
            out["stats"] = await _http(port, "/stats")
            out["stats_json"] = await _http(port, "/stats?json")
            out["metrics"] = await _http(port, "/metrics")
            out["telnet_stats"] = await _telnet(port, ["stats"])
            out["queries"] = await _http(port, "/api/queries")
            out["queries_page"] = await _http(port, "/queries")
            out["traces"] = await _http(port, "/api/traces")
            out["traces_slow"] = await _http(port, "/api/traces?slow=1")
            out["logs"] = await _http(port, "/logs?json")
            out["deltas"] = {n: reg.counter(n).value - v
                             for n, v in c0.items()}
            out["diediedie"] = await _http(port, "/diediedie")
            out["shutdown_requested"] = server._shutdown.is_set()
        finally:
            await server.stop()
        return out
    return asyncio.run(main())


@pytest.fixture(scope="module")
def both(tmp_path_factory):
    """The scenario through a JAX and a port daemon, each over a 2-shard
    store with sketches and tenant accounting on (the window off: its
    /stats lines are held by test_resident_trace_matches_jax), both
    packages on their Python storage and wire paths."""
    from test_torch_native import use
    base = tmp_path_factory.mktemp("obs")
    cfg = dict(auto_create_metrics=True, port=0, bind="127.0.0.1",
               device_window=False, backend="cpu")
    with pytest.MonkeyPatch.context() as mp:
        use(mp, (None, None), False, False)
        jt = JaxTSDB(JaxSharded(str(base / "j"), shards=2),
                     JaxConfig(**cfg), start_compaction_thread=False)
        want = _scenario(JaxServer(jt), jt)
        preloaded = PORT_TIER in sys.modules
        pt = TSDB(ShardedKVStore(str(base / "p"), shards=2),
                  Config(device="cpu", **cfg),
                  start_compaction_thread=False)
        got = _scenario(TSDServer(pt), pt)
        got["tier_preloaded"] = preloaded
        got["tier_imported"] = PORT_TIER in sys.modules and not preloaded
    return want, got


def _stat_lines(body: bytes) -> dict:
    """name -> {tags (host aside) -> value} of a /stats body."""
    out: dict = {}
    for ln in body.decode().splitlines():
        parts = ln.split()
        tags = " ".join(t for t in parts[3:] if not t.startswith("host="))
        out.setdefault(parts[0], {})[tags] = parts[2]
    return out


def test_stats_names_equal_but_for_the_left_out_tiers(both):
    want, got = both
    jn = {n for n in _stat_lines(want["stats"][1])
          if not _left_out(n) and not _history(n)}
    pn = _port_names(_stat_lines(got["stats"][1]), got)
    assert pn == jn
    # Approximate serving's instruments, registered by /q in both.
    assert {"tsd.sketch.serve.hit", "tsd.sketch.serve.fallback",
            "tsd.sketch.error.reported",
            "tsd.sketch.error.reported.count"} <= pn
    assert {"tsd.wal.appends", "tsd.checkpoint.phase.count",
            "tsd.checkpoint.shard_spill", "tsd.ingest.parse",
            "tsd.http.handler", "tsd.telnet.handler", "tsd.fsck.duration",
            "tsd.storage.memtable.rows", "tsd.tenant.series",
            "tsd.admission.shed", "tsd.uptime_s",
            "tsd.process.rss_bytes"} <= pn
    # The mesh plane's instruments, in both daemons (item 11a).
    assert {"tsd.mesh.compile", "tsd.mesh.dispatch", "tsd.mesh.cache.hit",
            "tsd.mesh.cache.miss", "tsd.mesh.cache.size",
            "tsd.mesh.devices"} <= pn


COUNTERS = ["tsd.datapoints.added", "tsd.uid.cache-hit",
            "tsd.uid.cache-miss", "tsd.uid.cache-size",
            "tsd.compaction.count", "tsd.compaction.deleted_cells",
            "tsd.compaction.errors", "tsd.compaction.queue.size",
            "tsd.qcache.hit", "tsd.qcache.miss", "tsd.qcache.bypass",
            "tsd.tenant.count", "tsd.tenant.tracked_series",
            "tsd.tenant.recovered_series", "tsd.tenant.refused",
            "tsd.tenant.would_refuse", "tsd.tenant.series",
            "tsd.tenant.hh.series_points", "tsd.tenant.hh.prefix_series",
            "tsd.admission.inflight_queries",
            "tsd.admission.inflight_ingest_points", "tsd.admission.shed",
            "tsd.admission.degraded_queries", "tsd.admission.tenants",
            "tsd.admission.tenants_evicted",
            "tsd.admission.tenants_collapsed", "tsd.sketches.series",
            "tsd.storage.shards", "tsd.storage.memtable.rows",
            "tsd.bloom.shards_skipped", "tsd.dirty_set.size",
            "tsd.query.plan", "tsd.rpc.requests", "tsd.rpc.errors",
            "tsd.rpc.received", "tsd.traces.recorded",
            "tsd.http.graph.requests",
            "tsd.storage.wal.swallowed_flush_errors"]


@pytest.mark.parametrize("name", COUNTERS)
def test_counters_equal(both, name):
    want, got = both
    w, g = _stat_lines(want["stats"][1]), _stat_lines(got["stats"][1])
    assert name in g
    assert g[name] == w[name]


@pytest.mark.parametrize("name", ["wal.appends", "wal.append_bytes"])
def test_registry_counter_deltas_equal(both, name):
    want, got = both
    assert got["deltas"][name] == want["deltas"][name] > 0


def test_stats_json_and_telnet_stats_answer(both):
    _, got = both
    st, body = got["stats_json"]
    assert st == 200
    lines = json.loads(body)
    assert lines and all(ln.startswith("tsd.") for ln in lines)
    said = got["telnet_stats"].decode().splitlines()
    assert {ln.split()[0] for ln in said} == {ln.split()[0] for ln in lines}


def test_tier_off_daemon_imports_no_tier_module(both):
    """The tier-off port daemon's whole scenario (puts, traced /q, the
    checkpoint, /stats, /metrics, /api/queries) leaves the rollup tier's
    module unimported, so it registers none of the tier's instruments."""
    _, got = both
    assert not got["tier_imported"]


TIER_OFF_PROCESS = """
import sys
from opentsdb_tpu_torch.core.tsdb import TSDB
from opentsdb_tpu_torch.obs.registry import METRICS
from opentsdb_tpu_torch.query.executor import QueryExecutor, QuerySpec
from opentsdb_tpu_torch.server.tsd import TSDServer
from opentsdb_tpu_torch.storage.kv import MemKVStore
from opentsdb_tpu_torch.tools import cli
from opentsdb_tpu_torch.utils.config import Config
tsdb = TSDB(MemKVStore(wal_path=sys.argv[1]),
            Config(device="cpu", auto_create_metrics=True,
                   device_window=False), start_compaction_thread=False)
TSDServer(tsdb)
tsdb.add_point("m", 1356998400, 1.0, {"host": "a"})
tsdb.checkpoint()
QueryExecutor(tsdb).run(QuerySpec("m", {}, downsample=(3600, "avg")),
                        1356998400, 1357002000)
print(sorted(n for n in METRICS.names() if n.startswith("rollup")))
print("opentsdb_tpu_torch.rollup.tier" in sys.modules)
tsdb.shutdown()
"""


def test_tier_off_process_registers_no_rollup_instrument(tmp_path):
    """A fresh process that imports the daemon's modules (server, CLI,
    executor) and serves a downsample with the tier off registers no
    rollup.* instrument, so its /stats and /metrics show none (the JAX
    daemon's tier-off surface)."""
    import os
    import subprocess
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run(
        [sys.executable, "-c", TIER_OFF_PROCESS, str(tmp_path / "wal")],
        cwd=root, env=dict(os.environ, PYTHONPATH=root),
        capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.split("\n")[:2] == ["[]", "False"]


def _families(text: str) -> dict:
    return {ln.split()[2]: ln.split()[3] for ln in text.splitlines()
            if ln.startswith("# TYPE ")}


def test_metrics_families_and_types_equal(both):
    want, got = both
    assert got["metrics"][0] == 200
    wt, gt = want["metrics"][1].decode(), got["metrics"][1].decode()
    assert validate_exposition(gt) > 50
    jf = {f: t for f, t in _families(wt).items()
          if not _left_out(f) and not _history(f)}
    pf = _families(gt)
    assert {f: pf[f] for f in _port_names(pf, got)} == jf
    assert 'endpoint="/q"' in gt and 'cmd="help"' in gt
    assert {f for f in pf if f.startswith("tsd_sketch_")} == {
        f for f in jf if f.startswith("tsd_sketch_")} != set()


@pytest.mark.parametrize("key", ["raw_cold", "raw_miss", "raw_hit",
                                 "group_by", "filter"])
def test_trace_trees_equal(both, key):
    """Names, tags and nesting of each traced /q's span tree, the ms
    left out: planner.pick, scan with its fragment-cache tags (and the
    query.scan fault's fault.delay on the cold run), chunk.decode with
    one shard.scan per shard, aggregate."""
    want, got = both
    (sw, bw), (sg, bg) = want[key], got[key]
    assert sg == sw == 200
    jw, jg = json.loads(bw), json.loads(bg)
    assert len(jg) == len(jw) > 0
    def check(d):
        # The children of each span take no more than the span itself.
        kids = d.get("spans", ())
        assert sum(k["ms"] for k in kids) <= d["ms"] + 1e-3
        for k in kids:
            check(k)

    assert {"planner.pick", "scan", "aggregate"} <= _names(jg[0]["trace"])
    for w, g in zip(jw, jg):
        assert _no_ms(g["trace"]) == _no_ms(w["trace"])
        check(g["trace"])
        assert g.keys() == w.keys()


def test_cold_trace_holds_the_scan_fault_and_shards(both):
    _, got = both
    tree = json.loads(got["raw_cold"][1])[0]["trace"]
    scan = next(s for s in tree["spans"] if s["name"] == "scan")
    assert "fault.delay" in _names(scan)
    assert "shard.scan" in _names(scan)
    assert scan["tags"]["cached"] is False


def test_untraced_answers_have_no_trace_and_match(both):
    want, got = both
    assert got["untraced"] == want["untraced"]
    assert all("trace" not in g for g in json.loads(got["untraced"][1]))


@pytest.mark.parametrize("route", ROUTES)
def test_operator_route_bodies_identical(both, route):
    want, got = both
    if route == "/logs?level=loud":
        assert got["routes"][route][0] == want["routes"][route][0] == 400
    assert got["routes"][route] == want["routes"][route]


def test_help_and_dropcaches_identical(both):
    want, got = both
    assert got["help"] == want["help"]
    assert got["help"].startswith(
        b"available commands: diediedie dropcaches exit help put stats "
        b"tenant version\nCaches dropped.\n")


def test_diediedie_identical_and_shuts_down(both):
    want, got = both
    assert got["diediedie"] == want["diediedie"]
    assert got["shutdown_requested"] and want["shutdown_requested"]


def test_ingest_replies_identical(both):
    want, got = both
    assert got["put_errors"] == want["put_errors"] == 1
    assert got["api_put"] == want["api_put"] == 200


def test_api_queries_sections(both):
    want, got = both
    w, g = json.loads(want["queries"][1]), json.loads(got["queries"][1])
    assert g.keys() == w.keys()
    for k in ("plans", "rollup", "qcache", "admission"):
        assert g[k] == w[k], k
    # Each package's fused section sums its process-wide registry counters
    # (other tests' daemons count into them): the same shape, and counts
    # that agree with each other.
    assert g["fused"].keys() == w["fused"].keys()
    assert g["fused"]["devcache"].keys() == w["fused"]["devcache"].keys()
    f = g["fused"]
    assert 0 <= f["served"] <= f["attempt"]
    assert f["coverage"] == (f["served"] / f["attempt"]
                             if f["attempt"] else 0.0)
    assert g["ingest"].keys() == w["ingest"].keys()
    assert g["ingest"]["group"].keys() == w["ingest"]["group"].keys()
    assert g["ingest"]["parse"]["count"] > 0
    mesh = dict(w["mesh"], compile_cache=g["mesh"]["compile_cache"])
    assert g["mesh"] == mesh
    # Approximate serving's counters: the JAX daemon's labels (the values
    # are process-wide registry counts).
    assert sorted(g["sketch"]) == sorted(w["sketch"]) == [
        "error.reported.count", "error.reported.p95", "serve.fallback",
        "serve.hit"]
    assert got["queries_page"] == want["queries_page"]


@pytest.fixture(scope="module")
def both_rollups(tmp_path_factory):
    """A JAX and a port daemon, each over a WAL store with the rollup tier
    on (catch-up sync): the same puts, a checkpoint, rollup-served,
    declined and ranged-sketch queries, then /stats, /metrics and
    /api/queries."""
    from test_torch_native import use
    base = tmp_path_factory.mktemp("obs_rollup")
    cfg = dict(auto_create_metrics=True, port=0, bind="127.0.0.1",
               device_window=False, backend="cpu", enable_rollups=True,
               rollup_catchup="sync", enable_compactions=False)
    lines = _put_lines()
    targets = [Q + "&m=sum:1h-avg:obs.m",
               Q + "&m=max:1h-max:obs.m%7Bhost=*%7D",
               Q + "&m=sum:rate:1h-avg:obs.m", Q + "&m=sum:30m-avg:obs.m",
               f"/sketch?m=obs.m&start={BT}&end={BT + 12 * HOUR}",
               f"/distinct?metric=obs.m&tagk=host&start={BT}"
               f"&end={BT + 12 * HOUR}", "/stats", "/metrics",
               "/api/queries"]

    def scenario(server, tsdb):
        async def main():
            await server.start()
            try:
                await _telnet(server.port, lines)
                tsdb.checkpoint()
                return [await _http(server.port, q) for q in targets]
            finally:
                await server.stop()
        return asyncio.run(main())

    with pytest.MonkeyPatch.context() as mp:
        use(mp, (None, None), False, False)
        jt = JaxTSDB(JaxStore(wal_path=str(base / "j" / "wal")),
                     JaxConfig(**cfg), start_compaction_thread=False)
        want = scenario(JaxServer(jt), jt)
        pt = TSDB(MemKVStore(wal_path=str(base / "p" / "wal")),
                  Config(device="cpu", **cfg),
                  start_compaction_thread=False)
        got = scenario(TSDServer(pt), pt)
        jt.shutdown()
        pt.shutdown()
    return dict(zip(targets, want)), dict(zip(targets, got))


ROLLUP_TIER_LINES = ("tsd.rollup.ready", "tsd.rollup.fold",
                     "tsd.rollup.folds", "tsd.rollup.records",
                     "tsd.rollup.rebuilds", "tsd.rollup.miss",
                     "tsd.rollup.hit", "tsd.rollup.fallback",
                     "tsd.sketch.bytes")


def test_rollup_stats_names_and_tier_lines_equal(both_rollups):
    """With both tiers open, every rollup.* /stats name (the tier's lines
    and the fold timers and counters) is the JAX daemon's, and the tier's
    own lines carry its values (the timers and the fold split counters
    are process-wide, so their values are not compared)."""
    want, got = both_rollups
    w = _stat_lines(want["/stats"][1])
    g = _stat_lines(got["/stats"][1])
    wn = {n for n in w if n.startswith(("tsd.rollup", "tsd.sketch.bytes"))}
    gn = {n for n in g if n.startswith(("tsd.rollup", "tsd.sketch.bytes"))}
    assert gn == wn
    assert set(ROLLUP_TIER_LINES) | {"tsd.rollup.fold.count",
                                     "tsd.rollup.fold.delta",
                                     "tsd.rollup.fold.full"} <= gn
    for name in ROLLUP_TIER_LINES:
        # tsd.rollup.fold is also the fold timer's name (its percentile
        # lines): only the tier's kind=... line is the tier's.
        assert {k: v for k, v in g[name].items()
                if "percentile=" not in k} == \
            {k: v for k, v in w[name].items()
             if "percentile=" not in k}, name
    assert g["tsd.rollup.fold"]["kind=host-f64"] == "1"
    assert g["tsd.query.plan"] == w["tsd.query.plan"]
    jf = {f: t for f, t in _families(want["/metrics"][1].decode()).items()
          if f.startswith(("tsd_rollup", "tsd_sketch_bytes"))}
    assert {f: t for f, t in _families(got["/metrics"][1].decode()).items()
            if f.startswith(("tsd_rollup", "tsd_sketch_bytes"))} == jf


def test_api_queries_rollup_section_equal(both_rollups):
    want, got = both_rollups
    w = json.loads(want["/api/queries"][1])
    g = json.loads(got["/api/queries"][1])
    assert g["rollup"] == w["rollup"]
    # Two /q, the ranged /sketch (moment columns at 1h) and /distinct.
    assert g["rollup"]["ready"] and g["rollup"]["hits"]["1h"] == 4
    assert g["rollup"]["fallbacks"] == {"rate": 1, "interval": 1}
    assert g["plans"] == w["plans"]
    for q in list(want)[:6]:
        assert got[q] == want[q], q


def test_trace_ring_records_match(both):
    want, got = both
    w, g = json.loads(want["traces"][1]), json.loads(got["traces"][1])
    assert len(g) == len(w) == 5
    for a, b in zip(w, g):
        assert a.keys() == b.keys()
        for k in ("q", "plan", "cached", "slow", "shards", "replica"):
            assert a[k] == b[k], k
        assert _no_ms(a["trace"]) == _no_ms(b["trace"])
    assert json.loads(got["traces_slow"][1]) == []


def test_logs_route_answers(both):
    _, got = both
    st, body = got["logs"]
    assert st == 200 and isinstance(json.loads(body), list)


def _serve_one(server, drive):
    async def main():
        await server.start()
        try:
            return await drive(server.port)
        finally:
            await server.stop()
    return asyncio.run(main())


def test_slow_query_log_and_flag(caplog):
    tsdb = _port_tsdb(slow_query_ms=0.0001, port=0, bind="127.0.0.1")
    tsdb.add_batch("obs.s", BT + np.arange(0, HOUR, 60), np.ones(60),
                   {"host": "a"})
    server = TSDServer(tsdb)

    async def drive(port):
        st, _ = await _http(port, f"/q?start={BT}&end={BT + HOUR}"
                                  "&m=sum:obs.s&json")
        assert st == 200
        return await _http(port, "/api/traces?slow=1")

    with caplog.at_level(logging.WARNING, "opentsdb_tpu_torch.slowquery"):
        st, body = _serve_one(server, drive)
    recs = json.loads(body)
    assert recs and all(r["slow"] for r in recs)
    logged = [r for r in caplog.records
              if r.name == "opentsdb_tpu_torch.slowquery"]
    rec = json.loads(logged[0].getMessage())
    assert rec["q"].startswith("sum:") and rec["slow"] is True
    assert rec["trace"]["spans"]


def test_trace_sampling_one_in_n():
    tsdb = _port_tsdb(trace_sample_n=2, port=0, bind="127.0.0.1")
    tsdb.add_batch("obs.n", BT + np.arange(0, HOUR, 60), np.ones(60),
                   {"host": "a"})
    server = TSDServer(tsdb)

    async def drive(port):
        for _ in range(4):
            st, body = await _http(port, f"/q?start={BT}&end={BT + HOUR}"
                                         "&m=sum:obs.n&json")
            assert st == 200 and "trace" not in json.loads(body)[0]
        return await _http(port, "/api/traces")

    st, body = _serve_one(server, drive)
    recs = json.loads(body)
    assert len(recs) == 2 and all(r["sampled"] for r in recs)
    assert server.trace_ring.slow == 0


def test_selfmon_series_readable_through_q():
    """Two self-monitor cycles of the daemon's own /stats: its tsd.*
    series come back through /q, one point per cycle."""
    tsdb = _port_tsdb(port=0, bind="127.0.0.1")
    server = TSDServer(tsdb)

    async def drive(port):
        n = [server.selfmon.run_once(), server.selfmon.run_once()]
        return (n, await _http(port, "/q?start=0&end=4102444800"
                                     "&m=sum:tsd.datapoints.added&json"),
                await _http(port, "/q?start=0&end=4102444800"
                                  "&m=sum:tsd.uptime_s&json"),
                await _http(port, "/stats"))

    n, (st, body), (st2, body2), (_, stats) = _serve_one(server, drive)
    assert n[0] > 50 and n[1] >= n[0] - 5
    assert st == st2 == 200
    out = json.loads(body)
    assert out and len(out[0]["dps"]) == 2
    assert list(out[0]["dps"].values())[1] > 0
    assert len(json.loads(body2)[0]["dps"]) == 2
    lines = _stat_lines(stats)
    assert lines["tsd.selfmon.cycles"] == {"": "2"}
    assert int(lines["tsd.selfmon.points"][""]) == sum(n)


def test_resident_trace_matches_jax():
    """With the window on in both packages: a resident /q's span tree is
    the root (plan resident, not cached) over one planner.pick, in both,
    and both daemons report the window's /stats lines alike."""
    from opentsdb_tpu_torch.storage.devstore import DeviceWindow  # noqa
    cfg = dict(auto_create_metrics=True, port=0, bind="127.0.0.1",
               enable_sketches=False)
    jt = JaxTSDB(JaxStore(), JaxConfig(**cfg),
                 start_compaction_thread=False)
    pt = TSDB(MemKVStore(), Config(device="cpu", **cfg),
              start_compaction_thread=False)
    for t in (jt, pt):
        for h in range(3):
            t.add_batch("obs.r", BT + np.arange(0, 4 * HOUR, 60),
                        np.arange(240, dtype=np.float32), {"host": f"h{h}"})
    target = (f"/q?start={BT}&end={BT + 4 * HOUR}"
              "&m=sum:1h-avg:obs.r%7Bhost=*%7D&json&trace=1")

    async def drive(port):
        return await _http(port, target), await _http(port, "/stats")

    (sw, bw), (_, statw) = _serve_one(JaxServer(jt), drive)
    (sg, bg), (_, statg) = _serve_one(TSDServer(pt), drive)
    assert sw == sg == 200
    w, g = json.loads(bw), json.loads(bg)
    assert [x["rollup"] for x in g] == [x["rollup"] for x in w] == \
        ["resident"] * 3
    for a, b in zip(w, g):
        assert _no_ms(b["trace"]) == _no_ms(a["trace"])
    assert _no_ms(g[0]["trace"]) == {
        "name": "query",
        "tags": {"q": "sum:1h-avg:obs.r{host=*}", "plan": "resident",
                 "cached": False},
        "spans": [{"name": "planner.pick", "tags": {"plan": "resident"}}]}
    lw, lg = _stat_lines(statw), _stat_lines(statg)
    for name in ("tsd.devwindow.points.appended", "tsd.devwindow.hits",
                 "tsd.devwindow.misses", "tsd.devwindow.metrics",
                 "tsd.devwindow.points.resident", "tsd.query.plan"):
        assert lg[name] == lw[name], name


# ---------------------------------------------------------------------------
# The stats subcommand
# ---------------------------------------------------------------------------

def _cli_store(tmp_path):
    tsdb = _port_tsdb(str(tmp_path / "wal"))
    tsdb.add_point("cli.m", BT, 1, {"a": "b"})
    tsdb.add_point("cli.m", BT + 10, 2, {"a": "b"})
    tsdb.shutdown()
    return str(tmp_path / "wal")


def test_cli_stats_store_mode_lines(tmp_path, capsys):
    from opentsdb_tpu_torch.tools.cli import main
    wal = _cli_store(tmp_path)
    assert main(["stats", "--wal", wal, "--device", "cpu"]) == 0
    lines = [ln for ln in capsys.readouterr().out.splitlines() if ln]
    assert any(ln.startswith("tsd.datapoints.added ") for ln in lines)
    assert any(ln.startswith("tsd.fsck.duration.count ") for ln in lines)
    assert any(ln.startswith("tsd.uid.cache-size ") for ln in lines)
    for ln in lines:
        parts = ln.split()
        assert len(parts) >= 3 and parts[1].isdigit()
        float(parts[2])
        assert all("=" in t for t in parts[3:])


def test_cli_stats_store_mode_metrics_valid(tmp_path, capsys):
    from opentsdb_tpu_torch.tools.cli import main
    wal = _cli_store(tmp_path)
    assert main(["stats", "--wal", wal, "--device", "cpu",
                 "--metrics"]) == 0
    out = capsys.readouterr().out
    assert validate_exposition(out) > 10
    assert "tsd_datapoints_added" in out


@pytest.mark.parametrize("metrics", [False, True], ids=["stats", "metrics"])
def test_cli_stats_url_mode(capsys, metrics):
    from opentsdb_tpu_torch.tools.cli import main
    tsdb = _port_tsdb(port=0, bind="127.0.0.1")
    server = TSDServer(tsdb)

    async def drive(port):
        loop = asyncio.get_running_loop()
        argv = ["stats", "--url", f"http://127.0.0.1:{port}"]
        return await loop.run_in_executor(
            None, main, argv + (["--metrics"] if metrics else []))

    assert _serve_one(server, drive) == 0
    out = capsys.readouterr().out
    if metrics:
        assert validate_exposition(out) > 10
        assert "# TYPE tsd_http_handler_ms summary" in out
    else:
        assert "tsd.connectionmgr.connections " in out
        assert "tsd.uptime_s " in out


def _expert_stats(server):
    """A served and a declined (rate) dashboard, then /stats."""
    async def main():
        await server.start()
        try:
            await _telnet(server.port, _put_lines())
            for ms in ("m=sum:1h-avg:obs.m&m=p95:1h-avg:obs.m",
                       "m=sum:1h-avg:obs.m&m=sum:1h-avg:rate:obs.m"):
                status, _ = await _http(server.port, f"{Q}&{ms}")
                assert status == 200
            return (await _http(server.port, "/stats"))[1]
        finally:
            await server.stop()
    return asyncio.run(main())


def test_expert_instrument_names_equal_jax():
    """``mesh.expert.serve`` and ``mesh.expert.decline{reason=}``: the
    same /stats names and reason tags in both daemons once each has
    served and declined a dashboard (``--expert-parallel``, a 4-shard
    mesh)."""
    from opentsdb_tpu_torch.parallel.compile import set_mesh_devices
    cfg = dict(auto_create_metrics=True, port=0, bind="127.0.0.1",
               device_window=False, enable_sketches=False,
               mesh_shape="4", expert_parallel=True)
    jt = JaxTSDB(JaxStore(), JaxConfig(**cfg),
                 start_compaction_thread=False)
    want = _stat_lines(_expert_stats(JaxServer(jt)))
    pt = TSDB(MemKVStore(), Config(device="cpu", **cfg),
              start_compaction_thread=False)
    try:
        got = _stat_lines(_expert_stats(TSDServer(pt)))
    finally:
        set_mesh_devices(1)
    names = {"tsd.mesh.expert.serve", "tsd.mesh.expert.decline"}
    assert {n for n in got if n.startswith("tsd.mesh.expert")} == \
        {n for n in want if n.startswith("tsd.mesh.expert")} == names
    assert "reason=rate" in got["tsd.mesh.expert.decline"]
    assert "reason=rate" in want["tsd.mesh.expert.decline"]
