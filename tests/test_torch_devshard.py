"""The port's mesh-sharded resident hot set (opentsdb_tpu_torch/storage/
devshard.py), the executor's mesh legs and the daemon's serving-mesh
surface, against the JAX package's on the same seeded data.

Shards are logical (more shards than the one CPU device), as in the JAX
package's tests. Tolerances: grids (timestamps) and group sets exact;
count / min / max answers byte-identical across shard widths within the
port; sums and averages within rtol 1e-5, atol 1e-4 of the scan path and
of the JAX answers (float32 sums that reassociate across chunk and shard
boundaries); routing, shard contents, window verdicts (hit / decline),
generations and reshard counters equal to the JAX window's.
"""

import asyncio
import json

import numpy as np
import pytest

from opentsdb_tpu.core.tsdb import TSDB as JaxTSDB
from opentsdb_tpu.query.executor import QueryExecutor as JaxExecutor
from opentsdb_tpu.query.executor import QuerySpec as JaxSpec
from opentsdb_tpu.storage.devshard import ShardedDeviceWindow as JaxSDW
from opentsdb_tpu.storage.kv import MemKVStore as JaxStore
from opentsdb_tpu.utils.config import Config as JaxConfig
from opentsdb_tpu_torch.core.tsdb import TSDB
from opentsdb_tpu_torch.fault import faultpoints
from opentsdb_tpu_torch.parallel.mesh import Mesh
from opentsdb_tpu_torch.query.executor import QueryExecutor, QuerySpec
from opentsdb_tpu_torch.storage.devshard import ShardedDeviceWindow
from opentsdb_tpu_torch.storage.kv import MemKVStore
from opentsdb_tpu_torch.utils.config import Config

BT = 1356998400
SPAN = 7200


def make_tsdb(shards=4, **over):
    kw = dict(auto_create_metrics=True, enable_sketches=False,
              device_window=True, devwindow_shards=shards)
    kw.update(over)
    return TSDB(MemKVStore(), Config(device="cpu", **kw),
                start_compaction_thread=False)


def make_jax_tsdb(shards=4, **over):
    kw = dict(auto_create_metrics=True, enable_sketches=False,
              device_window=True, devwindow_shards=shards)
    kw.update(over)
    return JaxTSDB(JaxStore(), JaxConfig(**kw),
                   start_compaction_thread=False)


def load(t, series=10, points=240, metric="m.cpu", seed=7):
    rng = np.random.default_rng(seed)
    for i in range(series):
        ts = BT + np.sort(rng.choice(SPAN, points, replace=False))
        t.add_batch(metric, ts, rng.normal(100, 10, points),
                    {"host": f"h{i}", "dc": "east" if i % 2 else "west"})


def answers_close(got, want):
    assert [r.tags for r in got] == [r.tags for r in want]
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.timestamps, b.timestamps)
        np.testing.assert_allclose(a.values, b.values, rtol=1e-5,
                                   atol=1e-4)


def run_pair(t, spec, start=BT, end=BT + SPAN, expect_hit=True, ex=None):
    """Resident-plan answer vs the scan answer over the same TSDB."""
    ex = ex or QueryExecutor(t, backend="device")
    dw = t.devwindow
    h0 = dw.window_hits
    got = ex.run(spec, start, end)
    assert (dw.window_hits > h0) == expect_hit
    keep, t.devwindow = t.devwindow, None
    try:
        want = ex.run(spec, start, end)
    finally:
        t.devwindow = keep
    answers_close(got, want)
    return got


def jax_spec(spec):
    return JaxSpec(*spec)


SPECS = {
    "count": QuerySpec("m.cpu", {}, "sum", downsample=(600, "count")),
    "min": QuerySpec("m.cpu", {"host": "*"}, "min",
                     downsample=(600, "min")),
    "max": QuerySpec("m.cpu", {"dc": "east"}, "max",
                     downsample=(300, "max")),
    "sum": QuerySpec("m.cpu", {}, "sum", downsample=(600, "sum")),
    "avg": QuerySpec("m.cpu", {"host": "*"}, "avg",
                     downsample=(600, "avg")),
    "p95": QuerySpec("m.cpu", {"dc": "*"}, "p95", downsample=(600, "avg")),
    "rate": QuerySpec("m.cpu", {}, "sum", rate=True,
                      downsample=(600, "avg")),
}


# ---------------------------------------------------------------------------
# The window against the JAX window
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shards", [1, 3, 5])
def test_routing_matches_jax(shards):
    t, j = make_tsdb(shards), make_jax_tsdb(shards)
    try:
        load(t)
        load(j)
        t.devwindow.flush()
        j.devwindow.flush()
        uid = t.metrics.get_id("m.cpu")
        assert uid == j.metrics.get_id("m.cpu")
        pc = t.devwindow.chunk_columns(uid, BT, BT + SPAN)
        jc = j.devwindow.chunk_columns(uid, BT, BT + SPAN)
        assert pc.series_keys == jc.series_keys
        assert pc.shard_starts == jc.shard_starts
        assert [s is None for s in pc.shards] == \
            [s is None for s in jc.shards]
        for key in pc.series_keys:
            assert t.devwindow.shard_of(key) == j.devwindow.shard_of(key)
        for i, per in enumerate(pc.shards):
            if per is not None:
                assert all(t.devwindow.shard_of(k) == i
                           for k in per.series_keys)
    finally:
        t.shutdown()
        j.shutdown()


@pytest.mark.parametrize("kind", sorted(SPECS))
def test_resident_parity_across_widths_and_with_jax(kind):
    spec = SPECS[kind]
    by_width = {}
    for shards in (1, 3, 4, 9):
        t = make_tsdb(shards=shards)
        try:
            load(t)
            t.devwindow.flush()
            by_width[shards] = run_pair(t, spec)
        finally:
            t.shutdown()
    for shards, got in by_width.items():
        if kind in ("count", "min", "max"):
            for a, b in zip(got, by_width[1]):
                np.testing.assert_array_equal(a.timestamps, b.timestamps)
                assert a.values.tobytes() == b.values.tobytes(), shards
        else:
            answers_close(got, by_width[1])
    j = make_jax_tsdb(4)
    try:
        load(j)
        j.devwindow.flush()
        h0 = j.devwindow.window_hits
        want = JaxExecutor(j, backend="tpu").run(jax_spec(spec), BT,
                                                 BT + SPAN)
        assert j.devwindow.window_hits > h0
    finally:
        j.shutdown()
    answers_close(by_width[4], want)


def test_per_shard_eviction_declines_like_jax():
    """A shard over its budget evicts its own oldest chunks: full-range
    queries on that metric fall back (never a partial union), the covered
    suffix serves with parity, a small recent metric keeps serving; the
    window verdicts and per-shard floors' presence equal the JAX window's."""
    def fill(t):
        rng = np.random.default_rng(31)
        span = 6 * 3600
        slice_s = span // 12
        for blk in range(12):
            for i in range(4):
                ts = BT + blk * slice_s + np.sort(
                    rng.choice(slice_s, 1100, replace=False))
                t.add_batch("m.ev", ts, rng.normal(100, 10, 1100),
                            {"host": f"h{i}"})
        t.add_batch("m.ok", BT + span - 600 + np.arange(60) * 10,
                    rng.normal(5, 1, 60), {"host": "solo"})
        t.devwindow.flush()
        return span

    kw = dict(device_window_staging=1 << 12, device_window_points=1 << 14)
    t, j = make_tsdb(2, **kw), make_jax_tsdb(2, **kw)
    try:
        span = fill(t)
        fill(j)
        dw = t.devwindow
        assert sum(s.evicted_points for s in dw._shards) > 0
        uid = t.metrics.get_id("m.ev")
        floors = [s._metrics[uid].complete_from for s in dw._shards
                  if uid in s._metrics]
        jfloors = [s._metrics[uid].complete_from for s in j.devwindow._shards
                   if uid in s._metrics]
        assert floors and all(f is not None for f in floors)
        assert len(floors) == len(jfloors)
        assert all(f is not None for f in jfloors)
        lo = max(floors + jfloors) + 60
        assert lo < BT + span - 600
        spec = QuerySpec("m.ev", {}, "sum", downsample=(600, "avg"))
        jex = JaxExecutor(j, backend="tpu")
        for start, end, hit in ((lo, BT + span, True),
                                (BT, BT + span, False)):
            got = run_pair(t, spec, start=start, end=end, expect_hit=hit)
            h0 = j.devwindow.window_hits
            want = jex.run(jax_spec(spec), start, end)
            assert (j.devwindow.window_hits > h0) == hit
            answers_close(got, want)
        run_pair(t, QuerySpec("m.ok", {}, "sum", downsample=(60, "avg")),
                 start=BT + span - 600, end=BT + span)
    finally:
        t.shutdown()
        j.shutdown()


def test_shards_split_the_budget():
    w = ShardedDeviceWindow(devices=["cpu"], n_shards=4,
                            max_points=1 << 12)
    jw = JaxSDW(devices=None, n_shards=4, max_points=1 << 12)
    assert [s.max_points for s in w._shards] == \
        [s.max_points for s in jw._shards] == [1 << 10] * 4
    assert all(str(s.device) == "cpu" for s in w._shards)


# ---------------------------------------------------------------------------
# Reshard
# ---------------------------------------------------------------------------

def test_grow_shrink_identical_answers_and_counters_match_jax():
    t, j = make_tsdb(4), make_jax_tsdb(4)
    try:
        load(t)
        load(j)
        t.devwindow.flush()
        j.devwindow.flush()
        spec = QuerySpec("m.cpu", {"host": "*"}, "sum",
                         downsample=(600, "count"))
        base = run_pair(t, spec)
        for n in (8, 2):
            r = t.devwindow.reshard(n_shards=n)
            jr = j.devwindow.reshard(n_shards=n)
            assert {k: v for k, v in r.items() if k != "reshard_ms"} == \
                {k: v for k, v in jr.items() if k != "reshard_ms"}
            got = run_pair(t, spec)
            for a, b in zip(got, base):
                np.testing.assert_array_equal(a.timestamps, b.timestamps)
                assert a.values.tobytes() == b.values.tobytes()
        dw = t.devwindow
        assert dw.generation == j.devwindow.generation == 2
        assert dw.reshard_count == 2 and dw.reshard_ms >= 0.0
        uid = t.metrics.get_id("m.cpu")
        pc = dw.chunk_columns(uid, BT, BT + SPAN)
        jc = j.devwindow.chunk_columns(uid, BT, BT + SPAN)
        assert pc.series_keys == jc.series_keys
        assert pc.generation[0] == jc.generation[0] == 2
        load(t, seed=8, metric="m.cpu2")
        dw.flush()
        run_pair(t, QuerySpec("m.cpu2", {}, "sum", downsample=(600, "avg")))
    finally:
        t.shutdown()
        j.shutdown()


def test_journaled_appends_survive_the_swap(monkeypatch):
    """Ingest landing during the rebuild goes to the journal too; the
    drained journal puts those points in the new shard set."""
    t = make_tsdb(shards=3)
    try:
        load(t)
        dw = t.devwindow
        dw.flush()
        orig = ShardedDeviceWindow._split_series
        fired = []

        def mid_reshard_split(metric_snaps):
            if not fired:
                fired.append(True)
                t.add_batch("m.cpu", BT + SPAN + np.arange(30) * 60,
                            np.arange(30, dtype=np.float64),
                            {"host": "late"})
            return orig(metric_snaps)

        monkeypatch.setattr(ShardedDeviceWindow, "_split_series",
                            staticmethod(mid_reshard_split))
        dw.reshard(n_shards=6)
        assert fired
        dw.flush()
        got = run_pair(t, QuerySpec("m.cpu", {"host": "late"}, "sum",
                                    downsample=(60, "avg")),
                       start=BT + SPAN, end=BT + SPAN + 1800)
        assert len(got) == 1 and len(got[0].timestamps) == 30
    finally:
        t.shutdown()


def test_invalidate_during_reshard_falls_back_to_scan(monkeypatch):
    """An invalidation that lands while a reshard rebuilds is carried
    into the new set: the metric falls back to the scan path after the
    swap (the new shards never serve what storage has diverged from),
    and the other metric stays resident."""
    t = make_tsdb(shards=3)
    try:
        load(t)
        load(t, series=4, metric="m.mem", seed=9)
        dw = t.devwindow
        dw.flush()
        uid = t.metrics.get_id("m.cpu")
        orig = ShardedDeviceWindow._split_series
        fired = []

        def mid_reshard_split(metric_snaps):
            if not fired:
                fired.append(True)
                dw.invalidate(uid)
            return orig(metric_snaps)

        monkeypatch.setattr(ShardedDeviceWindow, "_split_series",
                            staticmethod(mid_reshard_split))
        stats = dw.reshard(n_shards=5)
        assert fired and stats["dirty_metrics"] == 1
        assert uid not in dw._metric_shards
        assert all(s._metrics[uid].dirty for s in dw._shards
                   if uid in s._metrics)
        # Points the window skips from now on are in storage only.
        t.add_batch("m.cpu", BT + SPAN + np.arange(30) * 60,
                    np.arange(30, dtype=np.float64), {"host": "late"})
        dw.flush()
        f0 = dw.dirty_fallbacks
        spec = QuerySpec("m.cpu", {}, "sum", downsample=(60, "avg"))
        got = run_pair(t, spec, end=BT + SPAN + 1800, expect_hit=False)
        assert dw.dirty_fallbacks > f0
        assert len(got[0].timestamps) > SPAN // 60
        run_pair(t, QuerySpec("m.mem", {}, "sum", downsample=(60, "avg")))
    finally:
        t.shutdown()


def test_appends_from_another_thread_during_reshard():
    """A writer thread appends while reshards run: every acknowledged
    point is served resident afterwards, with scan parity."""
    import threading
    t = make_tsdb(shards=2)
    try:
        load(t, series=6)
        t.devwindow.flush()
        stop = threading.Event()
        written = []

        def writer():
            k = 0
            while not stop.is_set() and k < 200:
                ts = BT + SPAN + k * 10 + np.arange(5)
                t.add_batch("m.cpu", ts, np.full(5, float(k)),
                            {"host": "w"})
                written.append(k)
                k += 1

        th = threading.Thread(target=writer)
        th.start()
        for n in (5, 3, 4):
            t.devwindow.reshard(n_shards=n)
        stop.set()
        th.join()
        t.devwindow.flush()
        end = BT + SPAN + 200 * 10
        got = run_pair(t, QuerySpec("m.cpu", {"host": "w"}, "sum",
                                    downsample=(10, "count")),
                       start=BT + SPAN, end=end)
        assert float(got[0].values.sum()) == 5 * len(written)
        assert t.devwindow.generation == 3
    finally:
        t.shutdown()


def test_complete_from_carried_through_reshard():
    """The old shards' eviction floors carry into the new set: shrinking
    2 -> 1 shard gives the one shard the whole budget, so nothing more is
    evicted and its floor is exactly the old shards' highest."""
    kw = dict(device_window_staging=1 << 12, device_window_points=1 << 14)
    t, j = make_tsdb(2, **kw), make_jax_tsdb(2, **kw)
    try:
        for tsdb in (t, j):
            rng = np.random.default_rng(5)
            for blk in range(12):
                for i in range(4):
                    ts = BT + blk * 1800 + np.sort(
                        rng.choice(1800, 1100, replace=False))
                    tsdb.add_batch("m.ev", ts, rng.normal(1, 1, 1100),
                                   {"host": f"h{i}"})
            tsdb.devwindow.flush()
        dw = t.devwindow
        uid = t.metrics.get_id("m.ev")
        floor = max(s._metrics[uid].complete_from for s in dw._shards
                    if uid in s._metrics)
        dw.reshard(n_shards=1)
        j.devwindow.reshard(n_shards=1)
        dw.flush()
        j.devwindow.flush()
        assert dw._shards[0]._metrics[uid].complete_from == floor == \
            j.devwindow._shards[0]._metrics[uid].complete_from
        spec = QuerySpec("m.ev", {}, "sum", downsample=(600, "avg"))
        run_pair(t, spec, start=BT, end=BT + 6 * 3600, expect_hit=False)
        run_pair(t, spec, start=floor + 60, end=BT + 6 * 3600)
    finally:
        t.shutdown()
        j.shutdown()


def test_aborted_reshard_keeps_old_generation_serving():
    t = make_tsdb(shards=4)
    try:
        load(t)
        dw = t.devwindow
        dw.flush()
        spec = QuerySpec("m.cpu", {}, "sum", downsample=(600, "sum"))
        base = run_pair(t, spec)
        faultpoints.arm("mesh.reshard.commit", "raise")
        try:
            with pytest.raises(faultpoints.FaultInjected):
                dw.reshard(n_shards=8)
        finally:
            faultpoints.disarm("mesh.reshard.commit")
        assert dw.generation == 0 and dw.reshard_count == 0
        assert dw.n_shards == 4 and dw._journal is None
        got = run_pair(t, spec)
        for a, b in zip(got, base):
            np.testing.assert_array_equal(a.values, b.values)
        assert dw.reshard(n_shards=8)["n_shards"] == 8
        run_pair(t, spec)
    finally:
        t.shutdown()


def test_concurrent_reshard_refused():
    t = make_tsdb(shards=2)
    try:
        load(t, series=4)
        dw = t.devwindow
        with dw._lock:
            dw._journal = []
            with pytest.raises(RuntimeError, match="in progress"):
                dw.reshard(n_shards=4)
            dw._journal = None
    finally:
        t.shutdown()


def test_mesh_resident_gauges_match_jax():
    class Sink:
        def __init__(self):
            self.lines = {}

        def record(self, name, value, tag=None):
            self.lines[name] = value

    sinks = []
    for mk, ex_cls, sp in ((make_tsdb, QueryExecutor, lambda s: s),
                           (make_jax_tsdb, JaxExecutor, jax_spec)):
        t = mk(3)
        try:
            load(t)
            dw = t.devwindow
            dw.flush()
            ex_cls(t, backend="device" if mk is make_tsdb else "tpu").run(
                sp(QuerySpec("m.cpu", {}, "sum", downsample=(600, "avg"))),
                BT, BT + SPAN)
            dw.reshard(n_shards=2)
            dw.flush()
            sink = Sink()
            dw.collect_stats(sink)
            sinks.append(sink.lines)
        finally:
            t.shutdown()
    got, want = sinks
    assert set(got) == set(want)
    for k in got:
        if k != "mesh.resident.reshard_ms":
            assert got[k] == want[k], k
    assert got["mesh.resident.shards"] == 2
    assert got["mesh.resident.points"] == got["devwindow.points.resident"]


# ---------------------------------------------------------------------------
# The executor's mesh legs
# ---------------------------------------------------------------------------

def _scan_specs():
    return [
        QuerySpec("m.cpu", {}, "sum", downsample=(600, "avg")),
        QuerySpec("m.cpu", {}, "dev", downsample=(600, "avg")),
        QuerySpec("m.cpu", {}, "p95", downsample=(600, "avg")),
        QuerySpec("m.cpu", {"dc": "*"}, "sum", downsample=(600, "avg")),
        QuerySpec("m.cpu", {"dc": "*"}, "p95", downsample=(600, "avg")),
        QuerySpec("m.cpu", {"host": "*"}, "max", downsample=(300, "max")),
        QuerySpec("m.cpu", {}, "sum", rate=True, downsample=(600, "avg")),
        # Time-sharded: one series, 16+ buckets a shard.
        QuerySpec("m.cpu", {"host": "h1"}, "sum", downsample=(60, "avg")),
        QuerySpec("m.cpu", {"host": "h1"}, "p95", downsample=(60, "avg")),
        QuerySpec("m.cpu", {"host": "h1"}, "sum", rate=True,
                  downsample=(60, "avg")),
        # Neither layout: one series, few buckets (single-device).
        QuerySpec("m.cpu", {"host": "h2"}, "sum",
                  downsample=(3600, "avg")),
    ]


def _jax_mesh(D):
    import jax
    from opentsdb_tpu.parallel.mesh import make_mesh as jmake_mesh
    return jmake_mesh(D, devices=jax.devices("cpu"))


@pytest.mark.parametrize("D", [1, 2, 4, 8])
def test_scan_mesh_legs_match_jax_and_no_mesh(D):
    """The scan path's mesh legs (series-sharded, multigroup, time-
    sharded and the single-device fallback) against the JAX executor
    with a mesh over the same data, and against the port without one.
    Every leg dispatches through the plane but the last at D = 8: one
    series over 16 padded buckets is under 4 buckets a shard there, so
    both packages run it single-device."""
    from opentsdb_tpu_torch.parallel import compile as plane
    t = make_tsdb(0, device_window=False)
    j = make_jax_tsdb(0, device_window=False)
    try:
        load(t)
        load(j)
        ex = QueryExecutor(t, backend="device", mesh=Mesh(["cpu"] * D))
        plain = QueryExecutor(t, backend="device")
        jex = JaxExecutor(j, backend="tpu", mesh=_jax_mesh(D))
        for i, spec in enumerate(_scan_specs()):
            before = plane._M_DISPATCH.count
            got = ex.run(spec, BT, BT + SPAN)
            sharded = i < len(_scan_specs()) - 1 or D < 8
            assert (plane._M_DISPATCH.count > before) == sharded, spec
            answers_close(got, jex.run(jax_spec(spec), BT, BT + SPAN))
            answers_close(got, plain.run(spec, BT, BT + SPAN))
    finally:
        t.shutdown()
        j.shutdown()


def test_mesh_executor_declines_an_unsharded_window():
    t = make_tsdb(0)
    try:
        load(t)
        t.devwindow.flush()
        ex = QueryExecutor(t, backend="device", mesh=Mesh(["cpu"] * 2))
        h0 = t.devwindow.window_hits
        spec = QuerySpec("m.cpu", {}, "sum", downsample=(600, "avg"))
        got = ex.run(spec, BT, BT + SPAN)
        assert t.devwindow.window_hits == h0
        answers_close(got, QueryExecutor(t, backend="device").run(
            spec, BT, BT + SPAN))
    finally:
        t.shutdown()


@pytest.mark.parametrize("kind", ["sum", "p95", "rate"])
def test_resident_mesh_leg_matches_jax(kind):
    """A mesh executor over the sharded window (_dw_sharded_stage)
    against the JAX executor with a mesh over its sharded window."""
    spec = SPECS[kind]
    t, j = make_tsdb(4), make_jax_tsdb(4)
    try:
        load(t)
        load(j)
        t.devwindow.flush()
        j.devwindow.flush()
        got = run_pair(t, spec, ex=QueryExecutor(
            t, backend="device", mesh=Mesh(["cpu"] * 4)))
        h0 = j.devwindow.window_hits
        want = JaxExecutor(j, backend="tpu", mesh=_jax_mesh(4)).run(
            jax_spec(spec), BT, BT + SPAN)
        assert j.devwindow.window_hits > h0
        answers_close(got, want)
    finally:
        t.shutdown()
        j.shutdown()


# ---------------------------------------------------------------------------
# Both daemons with --mesh 4 --devwindow-shards 4
# ---------------------------------------------------------------------------

async def _get(port, target):
    reader, writer = await asyncio.open_connection("127.0.0.1", port)
    writer.write(f"GET {target} HTTP/1.1\r\nConnection: close\r\n\r\n"
                 .encode())
    await writer.drain()
    raw = await asyncio.wait_for(reader.read(), 60)
    writer.close()
    head, _, body = raw.partition(b"\r\n\r\n")
    return int(head.split()[1]), body


async def _put(port, lines):
    reader, writer = await asyncio.open_connection("127.0.0.1", port)
    writer.write(("\n".join(lines) + "\nversion\nexit\n").encode())
    await writer.drain()
    await asyncio.wait_for(reader.read(), 60)
    writer.close()


Q_TARGETS = [
    f"/q?start={BT}&end={BT + SPAN}&m=sum:10m-avg:m.cpu&json",
    f"/q?start={BT}&end={BT + SPAN}&m=p95:10m-avg:m.cpu%7Bdc=*%7D&json",
    f"/q?start={BT}&end={BT + SPAN}&m=max:5m-max:m.cpu%7Bhost=*%7D&json",
    f"/q?start={BT}&end={BT + SPAN}&m=sum:10m-avg:rate:m.cpu&json",
]


def _lines():
    rng = np.random.default_rng(9)
    out = []
    for i in range(8):
        ts = BT + np.sort(rng.choice(SPAN, 120, replace=False))
        for a, v in zip(ts.tolist(), rng.normal(50, 5, 120).tolist()):
            out.append(f"put m.cpu {a} {round(v, 3)} host=h{i} "
                       f"dc={'e' if i % 2 else 'w'}")
    return out


def _daemon_run(server_cls, tsdb, sharded=True):
    server = server_cls(tsdb)

    async def main():
        await server.start()
        try:
            await _put(server.port, _lines())
            out = {"q": [await _get(server.port, t) for t in Q_TARGETS]}
            out["healthz"] = await _get(server.port, "/healthz")
            out["queries"] = await _get(server.port, "/api/queries")
            out["reshard"] = await _get(server.port,
                                        "/api/mesh/reshard?shards=2")
            out["bad"] = await _get(server.port,
                                    "/api/mesh/reshard?shards=0")
            out["q2"] = [await _get(server.port, t) for t in Q_TARGETS]
            out["healthz2"] = await _get(server.port, "/healthz")
            out["stats"] = await _get(server.port, "/stats")
            return out
        finally:
            await server.stop()
    return asyncio.run(main())


def _dps_close(gb, wb):
    g, w = json.loads(gb), json.loads(wb)
    assert [(r["metric"], r["tags"]) for r in g] == \
        [(r["metric"], r["tags"]) for r in w]
    for a, b in zip(g, w):
        assert list(a["dps"]) == list(b["dps"])
        np.testing.assert_allclose(list(a["dps"].values()),
                                   list(b["dps"].values()), rtol=1e-5,
                                   atol=1e-4)


def test_daemons_with_mesh_and_sharded_window():
    from opentsdb_tpu.server.tsd import TSDServer as JaxServer
    from opentsdb_tpu_torch.server.tsd import TSDServer
    cfg = dict(auto_create_metrics=True, port=0, bind="127.0.0.1",
               enable_sketches=False, mesh_shape="4", devwindow_shards=4)
    want = _daemon_run(JaxServer, JaxTSDB(
        JaxStore(), JaxConfig(**cfg), start_compaction_thread=False))
    got = _daemon_run(TSDServer, TSDB(
        MemKVStore(), Config(device="cpu", **cfg),
        start_compaction_thread=False))
    for key in ("q", "q2"):
        for (gs, gb), (ws, wb) in zip(got[key], want[key]):
            assert gs == ws == 200
            _dps_close(gb, wb)
            assert json.loads(gb) and all(
                r.get("rollup", "resident") == "resident"
                for r in json.loads(gb))
    gh, wh = (json.loads(x["healthz"][1]) for x in (got, want))
    assert gh["mesh"]["width"] == wh["mesh"]["width"] == 4
    assert set(gh["mesh"]["resident"]) == set(wh["mesh"]["resident"])
    assert gh["mesh"]["resident"]["points"] == \
        wh["mesh"]["resident"]["points"] == 8 * 120
    gq, wq = (json.loads(x["queries"][1])["mesh"] for x in (got, want))
    assert set(gq) == set(wq)
    assert gq["devices"] == wq["devices"] == 4
    assert set(gq["compile_cache"]) == set(wq["compile_cache"])
    assert gq["compile_cache"]["devices"] == 4
    assert gq["serving"]["width"] == 4
    (gs, gb), (ws, wb) = got["reshard"], want["reshard"]
    assert gs == ws == 200
    g, w = json.loads(gb), json.loads(wb)
    assert set(g) == set(w)
    assert {k: v for k, v in g.items() if k != "reshard_ms"} == \
        {k: v for k, v in w.items() if k != "reshard_ms"}
    assert got["bad"][0] == want["bad"][0] == 400
    gh2 = json.loads(got["healthz2"][1])
    assert gh2["mesh"]["width"] == 2
    assert gh2["mesh"]["resident"]["reshards"] == 1
    for line in (b"tsd.mesh.resident.shards", b"tsd.mesh.devices",
                 b"tsd.mesh.cache.size"):
        assert line in got["stats"][1]
    from opentsdb_tpu_torch.parallel.compile import set_mesh_devices
    set_mesh_devices(1)


def test_unsharded_daemon_refuses_reshard():
    from opentsdb_tpu.server.tsd import TSDServer as JaxServer
    from opentsdb_tpu_torch.server.tsd import TSDServer
    cfg = dict(auto_create_metrics=True, port=0, bind="127.0.0.1",
               enable_sketches=False)
    res = []
    for cls, tsdb in (
            (JaxServer, JaxTSDB(JaxStore(), JaxConfig(**cfg),
                                start_compaction_thread=False)),
            (TSDServer, TSDB(MemKVStore(), Config(device="cpu", **cfg),
                             start_compaction_thread=False))):
        server = cls(tsdb)

        async def main():
            await server.start()
            try:
                return (await _get(server.port,
                                   "/api/mesh/reshard?shards=2"),
                        await _get(server.port, "/healthz"))
            finally:
                await server.stop()
        res.append(asyncio.run(main()))
    (js_, jb), jh = res[0]
    (ps, pb), ph = res[1]
    assert ps == js_ == 400
    assert b"not sharded" in pb and b"not sharded" in jb
    assert "mesh" not in json.loads(ph[1]) and "mesh" not in json.loads(
        jh[1])


# ---------------------------------------------------------------------------
# The router's mesh-weighted ownership
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("widths", [(1, 1), (1, 2), (4, 1), (2, 4, 1),
                                    (4, 4, 4), (1, 2, 4)])
def test_owner_index_weights_by_mesh_width(widths):
    from opentsdb_tpu.serve.router import RouterServer as JaxRouter
    from opentsdb_tpu.utils.config import Config as JCfg
    from opentsdb_tpu_torch.serve.router import RouterServer
    urls = tuple(f"http://127.0.0.1:{9000 + i}" for i in range(len(widths)))
    routers = [JaxRouter(JCfg(role="router", router_backends=urls)),
               RouterServer(Config(role="router", router_backends=urls))]
    for r in routers:
        for b, w in zip(r.backends, widths):
            b.last_health = {"mesh": {"width": w}} if w > 1 else {}
    specs = [f"sum:m{i}.cpu{{host=*}}" for i in range(300)]
    want = [routers[0]._owner_index(m) for m in specs]
    assert [routers[1]._owner_index(m) for m in specs] == want
    counts = np.bincount(want, minlength=len(widths))
    if len(set(widths)) > 1:
        # Wider backends own more of the series space.
        wide, narrow = int(np.argmax(widths)), int(np.argmin(widths))
        assert counts[wide] > counts[narrow]


def test_fused_plan_keeps_its_single_device_leg_under_a_mesh(tmp_path,
                                                             monkeypatch):
    """Under a mesh the fused plan (TSST4 blocks) still serves through its
    single-device leg (its mesh leg is item 11b): plan "fused", no mesh
    dispatch, the answer equal to the executor's without a mesh."""
    from test_torch_compress import SPECS as FUSED_SPECS
    from test_torch_compress import _ingest, _port_tsdb
    from test_torch_native import use
    from opentsdb_tpu_torch.parallel import compile as plane
    use(monkeypatch, (None, None), False, False)
    t = _port_tsdb(str(tmp_path / "port"), 1)
    try:
        for blk in range(3):
            _ingest(t, blk)
            t.checkpoint()
        ex = QueryExecutor(t, mesh=Mesh(["cpu"] * 4))
        plain = QueryExecutor(t)
        for metric, tags, agg, ds, rate in FUSED_SPECS:
            spec = QuerySpec(metric, tags, agg, rate=rate, downsample=ds)
            d0 = plane._M_DISPATCH.count
            got, plan, _ = ex.run_with_plan(spec, BT + 100, BT + 11 * 3600)
            assert plan == "fused" and plane._M_DISPATCH.count == d0
            want, wplan, _ = plain.run_with_plan(spec, BT + 100,
                                                 BT + 11 * 3600)
            assert wplan == "fused"
            answers_close(got, want)
    finally:
        t.shutdown()
