"""The port's rollup tier (opentsdb_tpu_torch/rollup/) against the JAX
package's (opentsdb_tpu/rollup/) on the same seeded ingest, over one store
and over four shards.

- the tier's files (moment and sketch maps, ROLLSUM blocks under tsst4,
  the state file) are byte-identical after each of two checkpoints;
- rollup-served /q answers (sum, avg, min, max, count downsamples at 1h,
  2h and 1d, grouped by sum, dev and p95) carry the JAX package's plan
  label and equal its answers, and equal the port's raw-served answers on
  the same backend (bit for bit where a bucket is one window; within
  float64 associativity over 2h buckets; within the float32 contract on
  the device backend's torch path);
- dirty windows are stitched from raw, declines are counted by reason as
  the JAX tier counts them, a crash between spill and fold owes a rebuild
  (incremental or full), a delete reaches the records, a resolution
  change rebuilds, close() stops a catch-up mid-way, and each package
  opens the other's tier without a rebuild;
- ranged /sketch and /distinct through both daemons: bodies, labels and
  the X-Tsd-Approx header byte for byte;
- the device fold (the window-fold kernel's plain version here) declares
  device-f64 and matches the host tier's records within its contract;
- a sketch byte budget opens a tier with the JAX tier's allocation, and
  a tier on disk with enable_rollups=False refuses a checkpoint;
- the CLI: ``tsd --rollups``, ``--rollup-resolutions``,
  ``--rollup-device-fold``, the auto-adopt, and ``stats``' rollup lines.
"""

import asyncio
import functools
import json
import os
import shutil
import time

import numpy as np
import pytest

import opentsdb_tpu.fault.faultpoints as jax_fp
import opentsdb_tpu_torch.fault.faultpoints as port_fp
from opentsdb_tpu.core.tsdb import TSDB as JaxTSDB
from opentsdb_tpu.query.executor import QueryExecutor as JaxExecutor
from opentsdb_tpu.query.executor import QuerySpec as JaxSpec
from opentsdb_tpu.server.tsd import TSDServer as JaxServer
from opentsdb_tpu.storage.kv import MemKVStore as JaxKV
from opentsdb_tpu.storage.sharded import ShardedKVStore as JaxSharded
from opentsdb_tpu.utils.config import Config as JaxConfig
from opentsdb_tpu_torch.core.tsdb import TSDB
from opentsdb_tpu_torch.query.executor import QueryExecutor, QuerySpec
from opentsdb_tpu_torch.rollup import tier as port_tier
from opentsdb_tpu_torch.server.tsd import TSDServer
from opentsdb_tpu_torch.storage.kv import MemKVStore
from opentsdb_tpu_torch.storage.sharded import ShardedKVStore
from opentsdb_tpu_torch.tools import cli
from opentsdb_tpu_torch.utils.config import Config

BASE = 1356998400
DAY = 86400
METRIC = "roll.m"
COMMON = dict(auto_create_metrics=True, enable_rollups=True,
              enable_sketches=False, device_window=False,
              rollup_catchup="sync", enable_compactions=False)
END = BASE + 3 * DAY - 1


def port_tsdb(path, shards=1, **over):
    os.makedirs(path, exist_ok=True)
    cfg = Config(device="cpu", backend="cpu", **{**COMMON, **over})
    store = (ShardedKVStore(path, shards=shards) if shards > 1
             else MemKVStore(wal_path=os.path.join(path, "wal")))
    return TSDB(store, cfg, start_compaction_thread=False)


def jax_tsdb(path, shards=1, **over):
    os.makedirs(path, exist_ok=True)
    wal = os.path.join(path, "wal")
    cfg = JaxConfig(wal_path=wal, shards=shards, backend="cpu",
                    **{**COMMON, **over})
    store = (JaxSharded(path, shards=shards) if shards > 1
             else JaxKV(wal_path=wal))
    return JaxTSDB(store, cfg, start_compaction_thread=False)


def ingest(tsdb, part, seed=5):
    """Part 0: days 0 to 1.5, part 1: days 1.5 to 3, of 12 hosts in 3 dcs
    (one integer host), 5-minute steps with a per-series jitter."""
    rng = np.random.default_rng(seed)
    lo, hi = (0, 36 * 3600) if part == 0 else (36 * 3600, 3 * DAY)
    for h in range(12):
        jit = int(rng.integers(0, 290))
        ts = BASE + np.arange(lo, hi, 300, dtype=np.int64) + jit
        if h == 7:
            vals = rng.integers(-500, 5000, len(ts))
        else:
            vals = np.round(50 + np.cumsum(rng.normal(0, 2, len(ts))), 3)
        tsdb.add_batch(METRIC, ts, vals, {"host": f"h{h:02d}",
                                          "dc": f"d{h % 3}"})


def tier_files(root) -> dict:
    """Every file of the rollup tier under ``root``, byte for byte."""
    out = {}
    for d, _, fns in os.walk(root):
        for fn in fns:
            p = os.path.join(d, fn)
            rel = os.path.relpath(p, root)
            if "rollup" in rel or fn == "ROLLUP.json":
                with open(p, "rb") as f:
                    out[rel] = f.read()
    return out


def crash(tsdb):
    """Process death: both tiers drop their locks unflushed."""
    if tsdb.rollups is not None:
        tsdb.rollups._simulate_crash()
    tsdb.store._simulate_crash()


def run(tsdb, spec, start=BASE, end=END, backend="cpu"):
    """(results, plan) of ``spec`` on either package."""
    if isinstance(tsdb, JaxTSDB):
        r, plan, _ = JaxExecutor(tsdb, backend=backend).run_with_plan(
            JaxSpec(*spec), start, end)
    else:
        r, plan, _ = QueryExecutor(tsdb, backend=backend).run_with_plan(
            QuerySpec(*spec), start, end)
    return r, plan


def raw(tsdb, spec, start=BASE, end=END, backend="cpu"):
    saved, tsdb.rollups = tsdb.rollups, None
    try:
        return run(tsdb, spec, start, end, backend)
    finally:
        tsdb.rollups = saved


def as_dict(results):
    return {tuple(sorted(r.tags.items())): (r.timestamps, r.values)
            for r in results}


def assert_same(a, b, rtol=0.0):
    da, db = as_dict(a), as_dict(b)
    assert da.keys() == db.keys() and da
    for k in da:
        assert np.array_equal(da[k][0], db[k][0]), k
        if rtol:
            np.testing.assert_allclose(da[k][1], db[k][1], rtol=rtol,
                                       atol=1e-9)
        else:
            assert np.array_equal(da[k][1], db[k][1]), k


# ---------------------------------------------------------------------------
# One store per package, ingested and checkpointed twice
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module", params=[1, 4], ids=["s1", "s4"])
def pair(request, tmp_path_factory):
    shards = request.param
    base = tmp_path_factory.mktemp(f"rollup{shards}")
    jt = jax_tsdb(str(base / "j"), shards)
    pt = port_tsdb(str(base / "p"), shards)
    files = []
    for part in (0, 1):
        for t in (jt, pt):
            ingest(t, part)
            t.checkpoint()
        files.append((tier_files(str(base / "j")),
                      tier_files(str(base / "p"))))
    yield {"jax": jt, "port": pt, "files": files, "shards": shards}
    jt.shutdown()
    pt.shutdown()


def test_tier_files_identical_after_each_checkpoint(pair):
    for j, p in pair["files"]:
        assert sorted(p) == sorted(j)
        assert [k for k in j if j[k] != p[k]] == []
    state = json.loads(next(v for k, v in pair["files"][-1][1].items()
                            if k.endswith(("ROLLUP.json", ".rollup.json"))))
    assert state["pending"] is False and state["fold"] == "host-f64"
    assert pair["port"].rollups.records_written == \
        pair["jax"].rollups.records_written > 0


@pytest.mark.parametrize("shards", [1, 4])
def test_tsst4_tier_spills_identical_rollsum_blocks(tmp_path, shards):
    """Under sstable_codec="tsst4" the tier's spills are ROLLSUM blocks,
    byte-identical to the JAX package's, and scan_records serves them
    block-direct (no row scan) with the JAX tier's records."""
    jt = jax_tsdb(str(tmp_path / "j"), shards, sstable_codec="tsst4")
    pt = port_tsdb(str(tmp_path / "p"), shards, sstable_codec="tsst4")
    try:
        for part in (0, 1):
            for t in (jt, pt):
                ingest(t, part)
                t.checkpoint()
            assert tier_files(str(tmp_path / "p")) == \
                tier_files(str(tmp_path / "j"))
            uid = pt.metrics.get_id(METRIC)
            for r in pt.rollups.resolutions:
                # One generation reads block-direct; the second
                # checkpoint's re-folded superrows overlay the first's,
                # which both tiers leave to the row scan.
                direct = [
                    [t.rollups._block_rows(s, uid, uid + b"\xff", None)
                     for s in t.rollups.stores[r]] for t in (pt, jt)]
                assert [[x is None for x in d] for d in direct] == \
                    [[part == 1] * max(shards, 1)] * 2
                got = pt.rollups.scan_records(r, uid, BASE, END,
                                              want_sketches=True)
                want = jt.rollups.scan_records(r, uid, BASE, END,
                                               want_sketches=True)
                assert got.keys() == want.keys() and got
                for k in got:
                    assert np.array_equal(got[k][0], want[k][0])
                    assert got[k][1].tobytes() == want[k][1].tobytes()
                    assert got[k][2] == want[k][2]
    finally:
        jt.shutdown()
        pt.shutdown()


DSAGGS = ("sum", "avg", "min", "max", "count")
INTERVALS = (3600, 7200, DAY)
GROUPS = ((("sum", {}), ("dev", {"dc": "*"}), ("p95", {"host": "*"})))


@pytest.mark.parametrize("dsagg", DSAGGS)
@pytest.mark.parametrize("interval", INTERVALS)
@pytest.mark.parametrize("agg,tags", GROUPS, ids=[g[0] for g in GROUPS])
def test_rollup_answers_equal_jax_and_raw(pair, dsagg, interval, agg, tags):
    spec = (METRIC, tags, agg, False, (interval, dsagg))
    jr, jplan = run(pair["jax"], spec)
    pr, pplan = run(pair["port"], spec)
    assert pplan == jplan == ("1d" if interval == DAY else "1h")
    assert_same(pr, jr)
    rr, rplan = raw(pair["port"], spec)
    assert rplan == "raw"
    exact = interval != 7200 or dsagg in ("count", "min", "max")
    assert_same(pr, rr, rtol=0.0 if exact else 1e-12)


def test_collect_stats_lines_equal(pair):
    """After the same queries on both, the tier's /stats lines (the
    device-backend test below runs on the port alone)."""
    from opentsdb_tpu.stats.collector import StatsCollector as JaxStats
    from opentsdb_tpu_torch.stats.collector import StatsCollector
    j, p = JaxStats("tsd", host_tag=False), StatsCollector(
        "tsd", host_tag=False)
    pair["jax"].rollups.collect_stats(j)
    pair["port"].rollups.collect_stats(p)
    strip = [ln.split(" ", 2)[::2] for ln in j.lines]
    assert [ln.split(" ", 2)[::2] for ln in p.lines] == strip
    assert any(ln.startswith("tsd.rollup.fold ") and "kind=host-f64" in ln
               for ln in p.lines)


@pytest.mark.parametrize("spec", [
    (METRIC, {}, "sum", False, (3600, "avg")),
    (METRIC, {"dc": "*"}, "max", False, (DAY, "max")),
    (METRIC, {"host": "*"}, "p95", False, (7200, "sum"))])
def test_device_backend_group_stage_over_rollup_spans(pair, spec):
    """The device backend (torch on CPU tensors here, the kernels on the
    card) runs its group stage over the planner's spans: the raw answer's
    grid, values within the float32 contract."""
    pr, plan = run(pair["port"], spec, backend="device")
    assert plan in ("1h", "1d")
    rr, rplan = raw(pair["port"], spec, backend="device")
    assert rplan in ("raw", "fused")
    assert_same(pr, rr, rtol=1e-5)


@pytest.mark.parametrize("spec,reason", [
    ((METRIC, {}, "sum", True, (3600, "avg")), "rate"),
    ((METRIC, {}, "sum", False, (3600, "p95")), "dsagg-p95"),
    ((METRIC, {}, "sum", False, None), "no-downsample"),
    ((METRIC, {}, "sum", False, (1800, "avg")), "interval")])
def test_declines_by_reason_counted_alike(pair, spec, reason):
    before = {n: dict(pair[n].rollups.fallbacks) for n in ("jax", "port")}
    for name in ("jax", "port"):
        r, plan = run(pair[name], spec)
        assert plan == "raw"
        got = pair[name].rollups.fallbacks
        assert got.get(reason, 0) == before[name].get(reason, 0) + 1
    assert pair["port"].rollups.fallbacks == pair["jax"].rollups.fallbacks


# ---------------------------------------------------------------------------
# Dirty windows, crashes, deletes, layout changes, close, cross-opens
# ---------------------------------------------------------------------------

@pytest.fixture
def both(tmp_path):
    made = []

    def make(shards=1, **over):
        jt = jax_tsdb(str(tmp_path / f"j{len(made)}"), shards, **over)
        pt = port_tsdb(str(tmp_path / f"p{len(made)}"), shards, **over)
        made.append((jt, pt))
        return jt, pt

    yield make
    for jt, pt in made:
        for t in (jt, pt):
            try:
                t.shutdown()
            except Exception:
                pass


@pytest.mark.parametrize("shards", [1, 4])
def test_backfill_into_a_folded_hour_is_stitched_from_raw(both, shards):
    jt, pt = both(shards)
    spec = (METRIC, {"host": "*"}, "sum", False, (3600, "sum"))
    for t in (jt, pt):
        ingest(t, 0)
        t.checkpoint()
        t.add_batch(METRIC, np.array([BASE + 3600 + 11, BASE + 7200 + 5]),
                    np.array([1e3, 2e3]), {"host": "h00", "dc": "d0"})
    assert set(pt.rollups.dirty_hour_bases().tolist()) == {
        BASE + 3600, BASE + 7200}
    jr, jplan = run(jt, spec)
    pr, pplan = run(pt, spec)
    assert pplan == jplan == "1h"
    assert_same(pr, jr)
    assert_same(pr, raw(pt, spec)[0])


@pytest.mark.parametrize("incremental", [True, False],
                         ids=["incremental", "full"])
@pytest.mark.parametrize("shards", [1, 4])
def test_crash_between_spill_and_fold_rebuilds(both, tmp_path, shards,
                                               incremental):
    """A raise at rollup.fold.start (the spilled keys drained, the fold
    not run), then process death: the state stays pending with its
    in-flight windows, and the reopen catches up (incrementally, or with
    the full rebuild) to the same cells and answers as the JAX
    package's, equal to raw."""
    jt, pt = both(shards)
    paths = {}
    for name, t, fp in (("jax", jt, jax_fp), ("port", pt, port_fp)):
        ingest(t, 0)
        t.checkpoint()
        ingest(t, 1)
        fp.arm("rollup.fold.start", "raise")
        try:
            with pytest.raises(fp.FaultInjected):
                t.checkpoint()
        finally:
            fp.clear()
        st = json.load(open(t.rollups.state_path))
        assert st["pending"] is True and st["inflight"]
        crash(t)
        paths[name] = os.path.dirname(t.rollups.state_path) \
            if shards > 1 else os.path.dirname(t.store._wal_path)
    jt = jax_tsdb(paths["jax"], shards,
                  rollup_incremental_catchup=incremental)
    pt = port_tsdb(paths["port"], shards,
                   rollup_incremental_catchup=incremental)
    try:
        assert pt.rollups.rebuilds == jt.rollups.rebuilds == 1
        assert pt.rollups.ready and jt.rollups.ready
        assert tier_files(paths["port"]).keys() == \
            tier_files(paths["jax"]).keys()
        for spec in [(METRIC, {}, "sum", False, (3600, "sum")),
                     (METRIC, {"dc": "*"}, "max", False, (DAY, "max"))]:
            pr, pplan = run(pt, spec)
            jr, jplan = run(jt, spec)
            assert pplan == jplan != "raw"
            assert_same(pr, jr)
            assert_same(pr, raw(pt, spec)[0])
    finally:
        jt.shutdown()
        pt.shutdown()


@pytest.mark.parametrize("shards", [1, 4])
def test_delete_reaches_the_rollups(both, shards):
    jt, pt = both(shards)
    spec = (METRIC, {"host": "*"}, "sum", False, (3600, "count"))
    for t in (jt, pt):
        ingest(t, 0)
        t.checkpoint()
        t.store.delete_row(t.table, t.row_key_for(
            METRIC, {"host": "h03", "dc": "d0"}, BASE + 5 * 3600))
        t.checkpoint()
    pr, plan = run(pt, spec)
    assert plan == "1h"
    assert_same(pr, run(jt, spec)[0])
    assert_same(pr, raw(pt, spec)[0])
    h03 = as_dict(pr)[(("dc", "d0"), ("host", "h03"))]
    assert BASE + 5 * 3600 not in h03[0].tolist()


def test_resolution_change_rebuilds(both, tmp_path):
    jt, pt = both()
    for t in (jt, pt):
        ingest(t, 0)
        t.shutdown()
    res = (3600, 7200, DAY)
    pt = port_tsdb(str(tmp_path / "p0"), rollup_resolutions=res)
    jt = jax_tsdb(str(tmp_path / "j0"), rollup_resolutions=res)
    try:
        assert pt.rollups.rebuilds == jt.rollups.rebuilds == 1
        spec = (METRIC, {}, "avg", False, (7200, "avg"))
        pr, pplan = run(pt, spec)
        jr, jplan = run(jt, spec)
        assert pplan == jplan == "2h"
        assert_same(pr, jr)
        assert tier_files(str(tmp_path / "p0")) == \
            tier_files(str(tmp_path / "j0"))
    finally:
        pt.shutdown()
        jt.shutdown()


def test_close_mid_rebuild_leaves_the_rebuild_owed(tmp_path, monkeypatch):
    """A background catch-up that close() interrupts aborts at a coarse
    window without an error; the state stays pending, and the next open
    rebuilds to the cells of an uninterrupted rebuild."""
    path = str(tmp_path / "p")
    t = port_tsdb(path, enable_rollups=False)
    ingest(t, 0)
    ingest(t, 1)
    t.shutdown()
    shutil.copytree(path, str(tmp_path / "ctl"))
    started = __import__("threading").Event()
    real = port_tier.RollupTier._summarize_group

    def slow(self, rows, buf, seen):
        started.set()
        time.sleep(0.05)
        return real(self, rows, buf, seen)

    monkeypatch.setattr(port_tier.RollupTier, "_summarize_group", slow)
    t = port_tsdb(path, rollup_catchup="background")
    assert started.wait(30)
    t.shutdown()
    assert t.rollups._rebuild_error is None and not t.rollups.ready
    assert json.load(open(t.rollups.state_path))["pending"] is True
    monkeypatch.undo()
    t = port_tsdb(path)
    ctl = port_tsdb(str(tmp_path / "ctl"))
    try:
        assert t.rollups.rebuilds == ctl.rollups.rebuilds == 1
        spec = (METRIC, {"host": "*"}, "max", False, (DAY, "max"))
        assert_same(run(t, spec)[0], run(ctl, spec)[0])
    finally:
        t.shutdown()
        ctl.shutdown()


@pytest.mark.parametrize("writer", ["jax", "port"])
@pytest.mark.parametrize("shards", [1, 4])
def test_each_package_opens_the_others_tier(tmp_path, writer, shards):
    """No rebuild, the same answers, and the reader's next checkpoint
    folds on top (the state file stays the writer's but for nothing)."""
    path = str(tmp_path / "s")
    open_w, open_r = ((jax_tsdb, port_tsdb) if writer == "jax"
                      else (port_tsdb, jax_tsdb))
    w = open_w(path, shards)
    ingest(w, 0)
    w.checkpoint()
    ingest(w, 1)
    w.checkpoint()
    specs = [(METRIC, {"dc": "*"}, "sum", False, (3600, "avg")),
             (METRIC, {}, "p95", False, (DAY, "max"))]
    want = [run(w, s) for s in specs]
    w.shutdown()
    r = open_r(path, shards)
    try:
        assert r.rollups.rebuilds == 0 and r.rollups.ready
        for s, (wr, wplan) in zip(specs, want):
            got, plan = run(r, s)
            assert plan == wplan != "raw"
            assert_same(got, wr)
        r.add_batch(METRIC, np.array([BASE + 3 * DAY + 60]),
                    np.array([1.0]), {"host": "h00", "dc": "d0"})
        r.checkpoint()
        assert r.rollups.ready and r.rollups.folds == 1
    finally:
        r.shutdown()


# ---------------------------------------------------------------------------
# Ranged /sketch and /distinct through both daemons
# ---------------------------------------------------------------------------

async def _get(port, target):
    reader, writer = await asyncio.open_connection("127.0.0.1", port)
    writer.write(f"GET {target} HTTP/1.1\r\nConnection: close\r\n\r\n"
                 .encode())
    await writer.drain()
    data = await asyncio.wait_for(reader.read(), 60)
    writer.close()
    head, _, body = data.partition(b"\r\n\r\n")
    lines = head.decode().split("\r\n")
    hdrs = dict(ln.split(": ", 1) for ln in lines[1:])
    return int(lines[0].split()[1]), hdrs.get("X-Tsd-Approx"), body


TARGETS = [
    f"/sketch?m={METRIC}&start={BASE}&end={END}",
    f"/sketch?m={METRIC}%7Bdc=d1%7D&start={BASE}&end={END}&q=p50,p99",
    f"/sketch?m={METRIC}&start={BASE + 1800}&end={BASE + 7 * 3600}",
    f"/sketch?m={METRIC}&start={BASE}&end={END}&max_error=0.0001",
    f"/distinct?metric={METRIC}&tagk=host&start={BASE}&end={END}",
    f"/distinct?metric={METRIC}&tagk=dc&start={BASE + 600}"
    f"&end={BASE + 5 * 3600}",
    f"/distinct?metric={METRIC}&tagk=host&start={BASE}&end={END}"
    f"&tags=dc=d2",
    f"/q?start={BASE}&end={END}&m=sum:1h-avg:{METRIC}%7Bdc=*%7D&json",
    f"/q?start={BASE}&end={END}&m=max:1d-max:{METRIC}&json",
    f"/q?start={BASE}&end={END}&m=sum:rate:1h-avg:{METRIC}&json",
    "/api/queries",
]


def _answers(server):
    async def main():
        await server.start()
        try:
            return [await _get(server.port, t) for t in TARGETS]
        finally:
            await server.stop()
    return asyncio.run(main())


def test_ranged_sketch_and_distinct_and_q_match_the_jax_daemon(both):
    jt, pt = both(port=0, bind="127.0.0.1")
    for t in (jt, pt):
        ingest(t, 0)
        t.checkpoint()
        ingest(t, 1)
        t.checkpoint()
        # A dirty hour, stitched from raw on every route.
        t.add_batch(METRIC, np.array([BASE + 10 * 3600 + 1]),
                    np.array([9.5]), {"host": "h01", "dc": "d1"})
    want = _answers(JaxServer(jt))
    got = _answers(TSDServer(pt))
    for target, g, w in zip(TARGETS, got, want):
        if target == "/api/queries":
            gj, wj = json.loads(g[2]), json.loads(w[2])
            assert gj["rollup"] == wj["rollup"], gj["rollup"]
            assert gj["plans"] == wj["plans"] == {"rollup": 2, "raw": 1}
            continue
        assert g == w, target
    labels = [json.loads(b).get("rollup") if t.startswith("/sketch")
              else json.loads(b).get("source") for t, (_, _, b)
              in zip(TARGETS[:7], got[:7])]
    assert labels == ["1d", "1d", "1h", "raw", "rollup", "rollup", "scan"]
    assert got[0][1].startswith("tdigest;rel_error=")
    assert got[2][1].startswith("moment;rel_error=")
    assert got[3][1] is None
    assert {g["rollup"] for g in json.loads(got[7][2])} == {"1h"}
    assert {g["rollup"] for g in json.loads(got[9][2])} == {"raw"}


def test_distinct_values_from_the_rollups_equal_jax(both):
    jt, pt = both()
    for t in (jt, pt):
        ingest(t, 0)
        t.checkpoint()
    for start, end in ((BASE, BASE + 36 * 3600 - 1), (BASE, BASE + 3000)):
        want = JaxExecutor(jt, backend="cpu").sketch_distinct_values(
            METRIC, {}, start, end)
        got = QueryExecutor(pt, backend="cpu").sketch_distinct_values(
            METRIC, {}, start, end)
        assert got == want
    assert got["rollup"] == "raw"
    assert want["rollup"] == "raw"


# ---------------------------------------------------------------------------
# The device fold, the port's limits, the CLI
# ---------------------------------------------------------------------------

def test_device_folded_tier_declares_f64_and_matches_the_host_tier(both):
    from opentsdb_tpu_torch.rollup.summary import decode_moment_map
    _, host = both()
    _, dev = both(rollup_device_fold=True)
    for t in (host, dev):
        ingest(t, 0)
        t.checkpoint()
        ingest(t, 1)
        t.checkpoint()
    st = json.load(open(dev.rollups.state_path))
    assert st["fold"] == dev.rollups.fold_kind == "device-f64"
    for r in host.rollups.resolutions:
        h = dict(host.rollups.stores[r][0].scan_raw("tsdb", b"", b"",
                                                    family=b"r"))
        d = dict(dev.rollups.stores[r][0].scan_raw("tsdb", b"", b"",
                                                   family=b"r"))
        assert h.keys() == d.keys()
        for key in h:
            hq, dq = dict(h[key]), dict(d[key])
            assert hq[b"\x01"] == dq[b"\x01"]      # sketch columns
            a, b = decode_moment_map(hq[b"\x00"]), decode_moment_map(
                dq[b"\x00"])
            assert np.array_equal(a["idx"], b["idx"])
            for f in ("count", "min", "max", "first", "last", "first_dt",
                      "last_dt"):
                assert np.array_equal(a["rec"][f], b["rec"][f]), f
            np.testing.assert_allclose(b["rec"]["sum"], a["rec"]["sum"],
                                       rtol=1e-12, atol=0)
    spec = (METRIC, {"dc": "*"}, "sum", False, (3600, "sum"))
    assert_same(run(dev, spec)[0], run(host, spec)[0], rtol=1e-12)


@pytest.mark.parametrize("res", [(3600, 86400), (3600, 21600, 86400)],
                         ids=["1h,1d", "1h,6h,1d"])
def test_device_tier_group_fold_equals_the_per_series_fold(tmp_path,
                                                           monkeypatch,
                                                           res):
    """A device-kind tier folds each (metric, coarse window) group of
    _summarize_group in one call of the group fold; its stored cells are
    byte for byte those of the same tier folding one series at a time
    through the one-series entry window_summaries_device (the
    order-emulating plain version here), and both declare device-f64."""
    from opentsdb_tpu_torch.rollup import summary as port_summary
    calls = []
    group = port_summary.group_summaries_device

    def counted(ts, *a, **k):
        calls.append(len(ts))
        return group(ts, *a, **k)

    monkeypatch.setattr(port_summary, "group_summaries_device", counted)
    per_series = functools.partial(
        port_summary.group_summaries,
        fold=functools.partial(port_summary.window_summaries_device,
                               device="cpu"))
    made = []
    for name in ("group", "series"):
        t = port_tsdb(str(tmp_path / name), rollup_device_fold=True,
                      rollup_resolutions=res)
        if name == "series":
            t.rollups._group_fold = per_series
        made.append(t)
    try:
        for part in (0, 1):
            for t in made:
                ingest(t, part)
                t.checkpoint()
        assert calls and sum(calls) > 0
        # One group a coarse day of the one metric: three days, the
        # second checkpoint refolding day 1 and folding day 2.
        assert len(calls) == 4
        files = [tier_files(str(tmp_path / n)) for n in ("group", "series")]
        assert files[0] == files[1]
        for t in made:
            st = json.load(open(t.rollups.state_path))
            assert st["fold"] == t.rollups.fold_kind == "device-f64"
            assert t.rollups.resolutions == res
    finally:
        for t in made:
            t.shutdown()


def test_fold_kind_change_is_a_layout_change(tmp_path):
    """The JAX package folding on its device declares device-f32 here
    (its jax lacks enable_x64); the port's device fold is device-f64, so
    opening that tier rebuilds it, and so does opening a host-f64 tier
    with the device fold on. The same kind adopts without a rebuild."""
    j = jax_tsdb(str(tmp_path / "j"), rollup_device_fold=True)
    ingest(j, 0)
    j.checkpoint()
    kind = j.rollups.fold_kind
    j.shutdown()
    assert kind == "device-f32"
    p = port_tsdb(str(tmp_path / "j"), rollup_device_fold=True)
    try:
        assert p.rollups.rebuilds == 1 and p.rollups.ready
    finally:
        p.shutdown()
    p = port_tsdb(str(tmp_path / "j"), rollup_device_fold=True)
    try:
        assert p.rollups.rebuilds == 0
    finally:
        p.shutdown()
    p = port_tsdb(str(tmp_path / "j"))
    try:
        assert p.rollups.rebuilds == 1
        assert json.load(open(p.rollups.state_path))["fold"] == "host-f64"
    finally:
        p.shutdown()


def test_sketch_byte_budget_is_refused_until_item_9(tmp_path):
    """Item 9 brought the allocator (sketch/budget.py): a budget no
    longer raises, and the port's tier spends it as the JAX tier does
    (tests/test_torch_sketch_serving.py holds the budgeted tiers' bytes
    and their crossing)."""
    p = port_tsdb(str(tmp_path / "p"), sketch_byte_budget=1 << 20)
    j = jax_tsdb(str(tmp_path / "j"), sketch_byte_budget=1 << 20)
    try:
        assert p.rollups.sketch_byte_budget == 1 << 20
        assert p.rollups.sketch_alloc == j.rollups.sketch_alloc
    finally:
        p.shutdown()
        j.shutdown()


@pytest.mark.parametrize("shards", [1, 4])
def test_a_tier_on_disk_without_enable_rollups_refuses_a_checkpoint(
        tmp_path, shards):
    path = str(tmp_path / "s")
    t = port_tsdb(path, shards)
    ingest(t, 0)
    t.shutdown()
    t = port_tsdb(path, shards, enable_rollups=False)
    try:
        assert t.rollups is None
        t.add_batch(METRIC, np.array([BASE + 2 * DAY]), np.array([1.0]),
                    {"host": "h00", "dc": "d0"})
        with pytest.raises(RuntimeError, match="enable_rollups=True"):
            t.checkpoint()
    finally:
        if shards > 1:
            t.store.close()
        else:
            t.store.close()


class _FakeServer:
    """tsd's server, replaced: keeps the TSDB, shuts it down at once."""
    seen = []

    def __init__(self, tsdb):
        self.tsdb = tsdb
        self.port = 0
        _FakeServer.seen.append((tsdb.config, tsdb.rollups))

    async def start(self):
        pass

    async def serve_forever(self):
        self.tsdb.shutdown()

    def request_shutdown(self):
        pass


@pytest.mark.parametrize("flags,want", [
    (["--rollups"], ((3600, 86400), "host-f64")),
    (["--rollup-resolutions", "3600,21600"], ((3600, 21600), "host-f64")),
    (["--rollups", "--rollup-device-fold"], ((3600, 86400), "device-f64")),
    ([], None)])
def test_cli_tsd_rollup_flags(tmp_path, monkeypatch, flags, want):
    monkeypatch.setattr("opentsdb_tpu_torch.server.tsd.TSDServer", _FakeServer)
    monkeypatch.setattr(cli, "tune_for_ingest", lambda: None)
    _FakeServer.seen.clear()
    wal = str(tmp_path / "wal")
    assert cli.main(["tsd", "--device", "cpu", "--port", "0", "--wal", wal,
                     *flags]) == 0
    cfg, tier = _FakeServer.seen[0]
    if want is None:
        assert tier is None and not cfg.enable_rollups
    else:
        assert (tier.resolutions, tier.fold_kind) == want
        assert os.path.exists(wal + ".rollup.json")


@pytest.mark.parametrize("shards", [0, 4])
def test_cli_adopts_an_existing_tier(tmp_path, monkeypatch, shards):
    """A store whose tier exists opens with it, flag or no flag, in its
    own layout: no rebuild; ``tenants`` (which checkpoints at its end)
    keeps it current, and ``stats`` prints its lines."""
    path = str(tmp_path / "s")
    t = port_tsdb(path, max(shards, 1), rollup_resolutions=(3600, 21600))
    ingest(t, 0)
    t.shutdown()
    wal = path if shards else os.path.join(path, "wal")
    monkeypatch.setattr("opentsdb_tpu_torch.server.tsd.TSDServer", _FakeServer)
    monkeypatch.setattr(cli, "tune_for_ingest", lambda: None)
    _FakeServer.seen.clear()
    assert cli.main(["tsd", "--device", "cpu", "--port", "0", "--wal",
                     wal]) == 0
    cfg, tier = _FakeServer.seen[0]
    assert cfg.enable_rollups and tier.resolutions == (3600, 21600)
    assert tier.rebuilds == 0 and tier.ready
    assert cli.main(["tenants", "--wal", wal, "--device", "cpu",
                     "--json"]) == 0


def test_cli_stats_prints_the_tier_lines(tmp_path, capsys):
    path = str(tmp_path / "s")
    t = port_tsdb(path)
    ingest(t, 0)
    t.shutdown()
    capsys.readouterr()
    assert cli.main(["stats", "--wal", os.path.join(path, "wal"),
                     "--device", "cpu"]) == 0
    lines = capsys.readouterr().out.splitlines()
    names = {ln.split()[0] for ln in lines}
    assert {"tsd.rollup.ready", "tsd.rollup.fold", "tsd.rollup.records",
            "tsd.rollup.hit", "tsd.sketch.bytes"} <= names
    assert any(ln.startswith("tsd.rollup.ready ") and ln.split()[2] == "1"
               for ln in lines)
