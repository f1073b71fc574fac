"""The port's resident device window (opentsdb_tpu_torch/storage/devstore.py)
and its exact-or-fall-back contract, mirroring the JAX package's
tests/test_devstore.py on device="cpu" (minus the mid-batch throttle and
the mesh, which the port does not have yet).

The window must be invisible semantically: every query it serves equals
the storage scan path's (grids identical, values to float32 tolerance),
and anything it cannot guarantee (out-of-order writes, evicted ranges,
un-downsampled queries, a wedged uploader) falls back rather than
approximates.
"""

import threading
import time

import numpy as np
import pytest

from opentsdb_tpu.core.tsdb import TSDB as JaxTSDB
from opentsdb_tpu.query.executor import QueryExecutor as JaxExecutor
from opentsdb_tpu.query.executor import QuerySpec as JaxSpec
from opentsdb_tpu.storage.kv import MemKVStore as JaxStore
from opentsdb_tpu.utils.config import Config as JaxConfig
from opentsdb_tpu_torch.core.tsdb import TSDB
from opentsdb_tpu_torch.query.aggregators import Aggregators
from opentsdb_tpu_torch.query.executor import QueryExecutor, QuerySpec
from opentsdb_tpu_torch.storage.devstore import DeviceWindow
from opentsdb_tpu_torch.storage.kv import MemKVStore
from opentsdb_tpu_torch.utils.config import Config

BT = 1356998400
SUM_AVG = QuerySpec("m.cpu", {}, "sum", downsample=(600, "avg"))


def _tsdb(wal=None, **kw):
    return TSDB(MemKVStore(wal_path=wal),
                Config(auto_create_metrics=True, device="cpu", **kw),
                start_compaction_thread=False)


@pytest.fixture
def tsdb():
    t = _tsdb()
    yield t
    t.shutdown()


def _load(tsdb, series=12, points=200, span=7200, metric="m.cpu"):
    rng = np.random.default_rng(7)
    for i in range(series):
        ts = BT + np.sort(rng.choice(span, points, replace=False))
        tsdb.add_batch(metric, ts, rng.normal(100, 10, points),
                       {"host": f"h{i}", "dc": "east" if i % 2 else "west"})


def _compare(tsdb, spec, start=BT, end=BT + 7200, expect_hit=True):
    """Answer with the window, then with the window set aside (the scan
    path), on one executor; the hit counter says which served."""
    ex = QueryExecutor(tsdb)
    h0 = tsdb.devwindow.window_hits
    got = ex.run(spec, start, end)
    hit = tsdb.devwindow.window_hits > h0
    assert hit == expect_hit, f"window hit={hit}, wanted {expect_hit}"
    dw, tsdb.devwindow = tsdb.devwindow, None
    try:
        want = ex.run(spec, start, end)
    finally:
        tsdb.devwindow = dw
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert a.tags == b.tags
        assert a.aggregated_tags == b.aggregated_tags
        np.testing.assert_array_equal(a.timestamps, b.timestamps)
        np.testing.assert_allclose(a.values, b.values, rtol=1e-5,
                                   atol=1e-5)
    return got


def _window(**kw):
    return DeviceWindow(device="cpu", **kw)


def _concat(cols):
    """A chunk_columns() answer's (rel_ts, values, sid) as numpy, its
    chunks joined in order."""
    return [np.concatenate([c[i].numpy() for c in cols.chunks])
            for i in range(3)]


def _ones(n):
    return np.ones(n, np.float32)


def _ts(first, n):
    return first + np.arange(n, dtype=np.int64)


# ---------------------------------------------------------------------------
# Fallbacks
# ---------------------------------------------------------------------------

class TestFallbacks:
    def test_undownsampled_declined(self, tsdb):
        """The window declines un-downsampled queries (as the JAX one
        does); the scan path answers them on the union grid, to float32
        tolerance of the float64 oracle."""
        _load(tsdb, series=2)
        ex = QueryExecutor(tsdb)
        for agg in ("sum", "p95"):
            spec = QuerySpec("m.cpu", {}, agg)
            h0 = tsdb.devwindow.window_hits
            assert ex._run_devwindow(spec, BT, BT + 7200,
                                     Aggregators.get(agg)) is None
            got, plan, _ = ex.run_with_plan(spec, BT, BT + 7200)
            assert plan == "raw" and got
            assert tsdb.devwindow.window_hits == h0
            (want,) = QueryExecutor(tsdb, backend="cpu").run(spec, BT,
                                                             BT + 7200)
            np.testing.assert_array_equal(got[0].timestamps,
                                          want.timestamps)
            np.testing.assert_allclose(got[0].values, want.values,
                                       rtol=1e-5, atol=1e-4)

    def test_oracle_backend_skips_window(self, tsdb):
        _load(tsdb, series=2)
        h0 = tsdb.devwindow.window_hits
        got, plan, _ = QueryExecutor(tsdb, backend="cpu").run_with_plan(
            SUM_AVG, BT, BT + 7200)
        assert plan == "raw" and got
        assert tsdb.devwindow.window_hits == h0

    def test_out_of_order_write_marks_dirty(self, tsdb):
        _load(tsdb, series=2)
        tsdb.add_point("m.cpu", BT + 1, 42.0, {"host": "h0", "dc": "west"})
        assert tsdb.devwindow._metrics[
            tsdb.metrics.get_id("m.cpu")].dirty
        _compare(tsdb, SUM_AVG, expect_hit=False)
        assert tsdb.devwindow.dirty_fallbacks >= 1

    def test_eviction_advances_coverage(self):
        dw = _window(staging_points=100, max_points=250)
        muid = b"\x00\x00\x01"
        for hour in range(5):
            dw.append(muid, b"skey", _ts(BT + hour * 3600, 100), _ones(100))
        dw.flush()
        assert dw.evicted_points > 0
        mw = dw._metrics[muid]
        assert mw.complete_from is not None
        # A query reaching before complete_from misses...
        assert dw.chunk_columns(muid, BT, BT + 5 * 3600) is None
        # ...and one inside the kept window hits.
        assert dw.chunk_columns(muid, mw.complete_from,
                                BT + 5 * 3600) is not None

    def test_eviction_budget_is_global_across_metrics(self):
        """max_points caps the SUM across metrics (the device memory
        budget is per card): many metrics must not each claim a full
        budget."""
        dw = _window(staging_points=100, max_points=350, background=False)
        for m in range(4):
            dw.append(bytes([0, 0, m]), b"sk", _ts(BT, 100), _ones(100))
            dw.flush()
        assert dw._total_points <= 350
        assert dw.evicted_points >= 50
        assert dw._metrics[bytes([0, 0, 0])].complete_from is not None

    def test_timespan_beyond_int32_marks_dirty(self):
        """>68 years from the metric's epoch would wrap the int32 rel
        column; the window falls back instead of mis-bucketing."""
        dw = _window(staging_points=10, background=False)
        muid = b"\x00\x00\x07"
        dw.append(muid, b"sk", _ts(0, 20), _ones(20))
        dw.append(muid, b"sk", _ts(2**31 + 100, 20), _ones(20))
        dw.flush()
        assert dw._metrics[muid].dirty
        assert dw.chunk_columns(muid, 0, 2**31 + 200) is None

    def test_epoch_past_int32_query_falls_back(self, tsdb):
        """All-time query against a metric whose epoch is past 2^31: the
        shift (qbase - epoch) doesn't fit int32, so the window declines;
        the scan path serves it (the float64 oracle for the wide
        range)."""
        ts = np.int64(2**31) + 1000 + np.arange(50, dtype=np.int64) * 60
        tsdb.add_batch("m.late", ts, np.arange(50.0), {"host": "h0"})
        spec = QuerySpec("m.late", {}, "sum", downsample=(600, "avg"))
        ex = QueryExecutor(tsdb)
        agg = Aggregators.get("sum")
        # Wide range: caught by the range-width guard first.
        assert ex._run_devwindow(spec, 0, int(0xFFFFFFFF), agg) is None
        # Narrow range whose qbase is > 2^31 before the epoch: the shift
        # guard itself.
        assert ex._run_devwindow(spec, 0, 1000, agg) is None
        assert ex.run(spec, 0, 1000) == []
        got = ex.run(spec, 0, int(0xFFFFFFFF))
        want = QueryExecutor(tsdb, backend="cpu").run(
            spec, 0, int(0xFFFFFFFF))
        assert len(got) == len(want) == 1
        np.testing.assert_array_equal(got[0].timestamps,
                                      want[0].timestamps)
        np.testing.assert_allclose(got[0].values, want[0].values,
                                   rtol=1e-5)

    def test_upload_failure_frees_residency(self):
        """A failed device upload runs the full dirty-mark under the
        lock: the metric's resident chunks stop counting toward the
        budget."""
        dw = _window(staging_points=10, background=False)
        a = b"\x00\x00\x01"
        dw.append(a, b"sk", _ts(BT, 20), _ones(20))
        assert dw._total_points == 20

        def boom(mw, batch, seq):
            raise RuntimeError("device gone")

        dw._upload = boom
        dw.append(a, b"sk", _ts(BT + 1000, 20), _ones(20))
        mw = dw._metrics[a]
        assert mw.dirty
        assert dw._total_points == 0
        assert mw.inflight == 0
        assert dw.chunk_columns(a, BT, BT + 2000) is None

    def test_query_does_not_wait_on_other_metrics_uploads(self):
        """chunk_columns() waits only for ITS metric's in-flight
        uploads; a stuck upload of another metric must not stall the
        query."""
        dw = _window(staging_points=10, background=True)
        a, b = b"\x00\x00\x01", b"\x00\x00\x02"
        dw.append(a, b"ska", _ts(BT, 20), _ones(20))
        dw.flush()
        gate = threading.Event()
        orig = dw._upload

        def slow(mw, batch, seq):
            if mw is dw._metrics.get(b):
                gate.wait(8)
            return orig(mw, batch, seq)

        dw._upload = slow
        try:
            dw.append(b, b"skb", _ts(BT, 20), _ones(20))
            time.sleep(0.2)  # the worker picks b's batch up and blocks
            # a gets more points, below the staging threshold:
            # chunk_columns() uploads them itself, not behind b's stuck
            # batch.
            dw.append(a, b"ska", _ts(BT + 100, 5), _ones(5))
            t0 = time.time()
            cols = dw.chunk_columns(a, BT, BT + 200)
            dt = time.time() - t0
        finally:
            gate.set()
        dw.flush()
        assert cols is not None
        assert len(_concat(cols)[0]) == 25  # staged points included
        assert dt < 3, f"query stalled {dt:.1f}s on another metric's upload"

    def test_invalidate_drops_metric(self, tsdb):
        _load(tsdb, series=2)
        muid = tsdb.metrics.get_id("m.cpu")
        assert tsdb.devwindow.chunk_columns(muid, BT, BT + 7200) is not None
        tsdb.devwindow.invalidate(muid)
        assert tsdb.devwindow.chunk_columns(muid, BT, BT + 7200) is None
        # Sticky: new appends don't resurrect a window that would claim
        # coverage it never had.
        tsdb.add_batch("m.cpu", _ts(BT + 9000, 3), np.ones(3),
                       {"host": "h0", "dc": "west"})
        _compare(tsdb, SUM_AVG, expect_hit=False)

    def test_staged_copies_not_aliases(self):
        """The window owns its staged buffers: a caller reusing its batch
        arrays does not rewrite staged points."""
        dw = _window(staging_points=1000, background=False)
        ts, vals = _ts(BT, 10), np.arange(10, dtype=np.float32)
        dw.append(b"\x00\x00\x01", b"sk", ts, vals)
        ts += 5000
        vals[:] = -1
        rel_ts, values, _ = _concat(
            dw.chunk_columns(b"\x00\x00\x01", BT, BT + 100))
        np.testing.assert_array_equal(rel_ts, np.arange(10))
        np.testing.assert_array_equal(values, np.arange(10))


# ---------------------------------------------------------------------------
# Warm-up from existing storage
# ---------------------------------------------------------------------------

class TestWarmup:
    def test_warm_from_existing_storage(self, tmp_path):
        """A restarted TSDB (WAL replay) re-covers pre-existing data, so
        the window serves history from before the process started."""
        wal = str(tmp_path / "wal")
        t1 = _tsdb(wal)
        _load(t1, series=3)
        t1.shutdown()
        t2 = _tsdb(wal)
        try:
            assert t2.devwindow.appended_points == 3 * 200
            _compare(t2, QuerySpec("m.cpu", {"host": "*"}, "sum",
                                   downsample=(600, "avg")))
        finally:
            t2.shutdown()

    def test_port_serves_jax_wal_resident(self, tmp_path):
        """A WAL the JAX package wrote warms the port's window; the port
        serves from it answers equal to the JAX package's window
        answers."""
        wal = str(tmp_path / "wal")
        jt = JaxTSDB(JaxStore(wal_path=wal),
                     JaxConfig(auto_create_metrics=True,
                               enable_sketches=False),
                     start_compaction_thread=False)
        _load(jt, series=4)
        fields = dict(metric="m.cpu", tags={"dc": "*"}, aggregator="max",
                      downsample=(600, "max"))
        h0 = jt.devwindow.window_hits
        want = JaxExecutor(jt, backend="tpu").run(JaxSpec(**fields), BT,
                                                  BT + 7200)
        assert jt.devwindow.window_hits == h0 + 1
        jt.shutdown()
        pt = _tsdb(wal)
        try:
            got, plan, _ = QueryExecutor(pt).run_with_plan(
                QuerySpec(**fields), BT, BT + 7200)
            assert plan == "resident"
            assert len(got) == len(want) == 2
            for a, b in zip(got, want):
                assert a.tags == b.tags
                np.testing.assert_array_equal(a.timestamps, b.timestamps)
                np.testing.assert_array_equal(a.values, b.values)
        finally:
            pt.shutdown()

    def test_conflicting_duplicates_disable_window(self, tmp_path):
        """Corrupt storage (the fsck signal) disables the window instead
        of warming a partial one."""
        wal = str(tmp_path / "wal")
        t1 = _tsdb(wal, device_window=False)
        t1.add_point("m.cpu", BT, 1.0, {"host": "h0"})
        t1.add_point("m.cpu", BT, 2, {"host": "h0"})  # same ts, int cell
        t1.shutdown()
        t2 = _tsdb(wal)
        try:
            assert t2.devwindow is None
        finally:
            t2.shutdown()


# ---------------------------------------------------------------------------
# Uploader stalls (each with a stall_timeout under one second)
# ---------------------------------------------------------------------------

KEY = b"\x00\x00\x01\x00\x00\x01\x00\x00\x02"
TS0 = 1_700_000_000


def test_wedged_uploader_degrades_instead_of_blocking():
    """A hung device must not hang ingest or queries: once the uploader
    stalls past stall_timeout, appends dirty-mark the metric (sticky
    scan-path fallback) instead of blocking on the full queue."""
    dw = _window(staging_points=64, max_points=1 << 20, stall_timeout=0.3)
    gate = threading.Event()
    real_upload = dw._run_upload

    def stuck_upload(work):
        gate.wait()             # a hung device call
        real_upload(work)

    dw._run_upload = stuck_upload
    muid = KEY[:3]
    try:
        t0 = time.monotonic()
        for i in range(8):      # enough batches to fill queue + stall
            dw.append(muid, KEY, _ts(TS0 + i * 1000, 100), _ones(100))
        assert time.monotonic() - t0 < 5.0
        mw = dw._metrics[muid]
        assert mw.dirty and dw.upload_stalls >= 1
        # Sticky degraded mode: IMMEDIATE scan fallback, and dropped
        # work items released their in-flight counts.
        for _ in range(3):
            t0 = time.monotonic()
            assert dw.chunk_columns(muid, TS0, TS0 + 10_000) is None
            assert time.monotonic() - t0 < 0.1
        assert dw.dirty_fallbacks >= 3
    finally:
        gate.set()


def test_slow_but_progressing_uploader_is_not_dirty_marked():
    """A backlogged-but-ALIVE uploader must never trigger the sticky
    dirty mark: ingest applies backpressure, and once the backlog drains
    the window serves again."""
    dw = _window(staging_points=64, max_points=1 << 20, stall_timeout=0.8)
    real_upload = dw._run_upload

    def slow_upload(work):
        time.sleep(0.1)         # slower than queue turnover, << timeout
        real_upload(work)

    dw._run_upload = slow_upload
    muid = KEY[:3]
    for i in range(8):          # fills the bounded queue repeatedly
        dw.append(muid, KEY, _ts(TS0 + i * 1000, 100), _ones(100))
    mw = dw._metrics[muid]
    assert not mw.dirty, "slow-but-progressing uploader was dirty-marked"
    assert dw.upload_stalls == 0
    deadline = time.monotonic() + 10
    while time.monotonic() < deadline:
        with dw._cond:
            if mw.inflight == 0:
                break
        time.sleep(0.02)
    cols = dw.chunk_columns(muid, TS0, TS0 + 10_000)
    assert cols is not None and not mw.dirty
    assert mw.device_points == 800


def test_per_metric_stuck_upload_degrades_despite_global_progress():
    """Other metrics' completed uploads must not mask one metric whose
    own upload is wedged: after 4x stall_timeout without progress on ITS
    oldest in-flight batch it turns sticky dirty."""
    dw = _window(staging_points=1 << 20, max_points=1 << 20,
                 stall_timeout=0.2)
    gate = threading.Event()
    real_upload = dw._run_upload
    MUID_A, MUID_B = b"\x00\x00\x01", b"\x00\x00\x02"

    def upload(work):
        if work[0] is dw._metrics.get(MUID_A):
            gate.wait()         # only A's transfer is stuck
        real_upload(work)

    dw._run_upload = upload
    keyA = MUID_A + KEY[3:]
    keyB = MUID_B + KEY[3:]
    dw.append(MUID_A, keyA, _ts(TS0, 100), _ones(100))
    stop = threading.Event()

    def churn_b():
        i = 0
        while not stop.is_set():
            i += 1
            dw.append(MUID_B, keyB, _ts(TS0 + i * 1000, 10), _ones(10))
            with dw._lock:
                w = dw._take_staged(dw._metrics[MUID_B])
            if w is not None:
                dw._submit(w)
            time.sleep(0.05)

    t = threading.Thread(target=churn_b, daemon=True)
    t.start()
    try:
        mwA = None
        deadline = time.monotonic() + 15
        while time.monotonic() < deadline:
            assert dw.chunk_columns(MUID_A, TS0, TS0 + 10_000) is None
            mwA = dw._metrics[MUID_A]
            if mwA.dirty:
                break
        assert mwA is not None and mwA.dirty, \
            "stuck metric never degraded while global progress continued"
        t0 = time.monotonic()
        assert dw.chunk_columns(MUID_A, TS0, TS0 + 10_000) is None
        assert time.monotonic() - t0 < 0.1
    finally:
        stop.set()
        gate.set()
        t.join(5)
    assert not t.is_alive()


# ---------------------------------------------------------------------------
# Counters and concurrency
# ---------------------------------------------------------------------------

def test_counters_flow(tsdb):
    _load(tsdb, series=2)
    QueryExecutor(tsdb).run(SUM_AVG, BT, BT + 7200)
    lines = []

    class Collector:
        def record(self, name, value, tag=None):
            lines.append((name, value))

    tsdb.devwindow.collect_stats(Collector())
    stats = dict(lines)
    assert stats["devwindow.points.appended"] == 2 * 200
    assert stats["devwindow.points.resident"] == 2 * 200
    assert stats["devwindow.hits"] == 1
    assert stats["devwindow.metrics"] == 1


def test_concurrent_appends_and_queries_lose_nothing():
    """Stress: more appending and querying threads than cores, a tiny
    switch interval, small staging (the background uploader and the
    query-side drains race), two metrics. No point may be lost or
    reordered: every series reads back complete and strictly increasing,
    and the residency accounting matches the chunks."""
    import sys

    dw = _window(staging_points=97, max_points=1 << 20, stall_timeout=5.0)
    metrics = (b"\x00\x00\x01", b"\x00\x00\x02")
    n_threads, batches, per = 12, 40, 7
    errors = []

    def writer(t):
        try:
            muid = metrics[t % 2]
            key = muid + b"\x00\x00\x01" + t.to_bytes(3, "big")
            for i in range(batches):
                dw.append(muid, key, _ts(TS0 + i * per, per),
                          np.full(per, t, np.float32))
        except Exception as e:  # reported below
            errors.append(e)

    def reader():
        try:
            for _ in range(20):
                for muid in metrics:
                    dw.chunk_columns(muid, TS0, TS0 + 10_000)
        except Exception as e:
            errors.append(e)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=writer, args=(t,))
                   for t in range(n_threads)]
        threads += [threading.Thread(target=reader) for _ in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    assert not errors, errors
    dw.flush()
    total = 0
    for muid in metrics:
        cols = dw.chunk_columns(muid, TS0, TS0 + 10_000)
        assert cols is not None and not dw._metrics[muid].dirty
        rel_ts, vals, sid = _concat(cols)
        ts = rel_ts.astype(np.int64) + cols.epoch
        assert len(cols.series_keys) == n_threads // 2
        for s, key in enumerate(cols.series_keys):
            mine = sid == s
            np.testing.assert_array_equal(
                ts[mine], _ts(TS0, batches * per))
            assert (vals[mine] == int.from_bytes(key[-3:], "big")).all()
        total += len(ts)
    assert total == dw._total_points == n_threads * batches * per
    assert dw.appended_points == total and dw.upload_stalls == 0
