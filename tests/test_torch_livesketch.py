"""The port's live sketches (opentsdb_tpu_torch/stats/livesketch.py) and
their TSDB hooks, on the CPU, mirroring tests/test_livesketch.py and held
against the JAX package on the same observe sequences.

Contracts:
- slot maps, stack shapes and HLL registers identical to the JAX
  package's; each digest row's total weight exact;
- quantiles after a stream of folds within the t-digest tolerance the JAX
  tests hold against exact values (rtol 0.02), against the JAX answers
  and against exact_quantile; "series" counts and distinct estimates
  equal;
- a snapshot either package saves loads in the other with bit-equal
  state arrays.
"""

import os

import numpy as np
import pytest

from opentsdb_tpu.core.tsdb import TSDB as JaxTSDB
from opentsdb_tpu.query.executor import QueryExecutor as JaxExecutor
from opentsdb_tpu.stats.livesketch import LiveSketches as JaxSketches
from opentsdb_tpu.storage.kv import MemKVStore as JaxStore
from opentsdb_tpu.utils.config import Config as JaxConfig
from opentsdb_tpu_torch.core.errors import (BadRequestError,
                                             PleaseThrottleError)
from opentsdb_tpu_torch.core.tsdb import TSDB
from opentsdb_tpu_torch.query.executor import QueryExecutor
from opentsdb_tpu_torch.stats.livesketch import LiveSketches
from opentsdb_tpu_torch.storage.kv import MemKVStore
from opentsdb_tpu_torch.utils.config import Config

BT = 1356998400
M1, K1 = b"\x00\x00\x01", b"\x00\x00\x02"


def _both(**kw):
    return LiveSketches(device="cpu", **kw), JaxSketches(**kw)


def _observe(sks, key, values, tags=()):
    for sk in sks:
        sk.observe(key, values, list(tags))


def _state(sk):
    sk.flush()
    arrs = [np.asarray(a.cpu() if hasattr(a, "cpu") else a)
            for a in (sk._td_means, sk._td_weights, sk._hll_regs)]
    return sk._td_slots, sk._hll_slots, arrs


def _assert_same_state(port, jax_sk):
    """Slots and shapes identical, HLL registers bit-identical, each
    digest row's total weight exact."""
    ps, ph, (pm, pw, pr) = _state(port)
    js, jh, (jm, jw, jr) = _state(jax_sk)
    assert ps == js and ph == jh
    assert pm.shape == jm.shape and pr.shape == jr.shape
    np.testing.assert_array_equal(pr, jr)
    np.testing.assert_array_equal(pw.sum(1), jw.sum(1))


def _assert_quantiles(port, jax_sk, keys, qs, raw=None):
    got = port.quantile(keys, qs)
    want = np.asarray(jax_sk.quantile(keys, qs))
    np.testing.assert_allclose(got, want, rtol=0.02)
    if raw is not None:
        np.testing.assert_allclose(got, np.quantile(raw, qs), rtol=0.02)
    return got


class TestLiveSketchesUnit:
    def test_quantile_accuracy_single_series(self):
        rng = np.random.default_rng(23)
        sks = _both(flush_points=1000)
        vals = rng.normal(100.0, 15.0, 20_000)
        for chunk in np.split(vals, 20):
            _observe(sks, b"series-a", chunk)
        _assert_quantiles(*sks, [b"series-a"], [0.5, 0.95, 0.99], vals)
        _assert_same_state(*sks)

    def test_quantile_merges_series(self):
        rng = np.random.default_rng(1)
        sks = _both()
        a = rng.normal(0.0, 1.0, 5000)
        b = rng.normal(50.0, 1.0, 5000)
        _observe(sks, b"s-a", a)
        _observe(sks, b"s-b", b)
        got = sks[0].quantile([b"s-a", b"s-b"], [0.5])
        assert abs(float(got[0]) - np.quantile(np.concatenate([a, b]),
                                               0.5)) < 2.0
        got_a = _assert_quantiles(*sks, [b"s-a"], [0.5])
        assert abs(float(got_a[0]) - np.quantile(a, 0.5)) < 0.1

    def test_quantile_unknown_series_is_none(self):
        assert LiveSketches(device="cpu").quantile([b"nope"], [0.5]) is None

    def test_distinct_accuracy_and_registers(self):
        rng = np.random.default_rng(2)
        sks = _both()
        n = 5000
        for u in rng.choice(100_000, size=n, replace=False):
            _observe(sks, b"", np.empty(0),
                     [(M1, K1, int(u).to_bytes(3, "big"))])
        est = sks[0].distinct(M1, K1)
        assert est == sks[1].distinct(M1, K1)
        assert abs(est - n) / n < 0.05
        assert sks[0].distinct(b"\x00\x00\x09", K1) is None
        _assert_same_state(*sks)

    def test_distinct_idempotent_refold(self):
        sk = LiveSketches(device="cpu")
        tv = [int(u).to_bytes(3, "big") for u in range(500)]
        for v in tv:
            sk.observe(b"", np.empty(0), [(b"m1", b"k1", v)])
        before = sk.distinct(b"m1", b"k1")
        for v in tv:
            sk.observe(b"", np.empty(0), [(b"m1", b"k1", v)])
        assert sk.distinct(b"m1", b"k1") == before

    def test_auto_flush_bounds_buffer(self):
        rng = np.random.default_rng(3)
        sks = _both(flush_points=100)
        for _ in range(30):
            _observe(sks, b"s", rng.normal(0, 1, 10))
        assert sks[0]._buffered < 100
        assert sks[0].hand_offs == 3
        sks[0]._pending.join()
        assert float(sks[0]._td_weights.sum()) >= 200
        _assert_same_state(*sks)

    def test_many_series_slot_growth(self):
        sks = _both()
        for i in range(100):
            _observe(sks, b"s%03d" % i, np.full(5, float(i)))
        sks[0].flush()
        assert sks[0].series_count() == 100
        np.testing.assert_allclose(sks[0].quantile([b"s%03d" % 7], [0.5]),
                                   [7.0], atol=0.01)
        _assert_same_state(*sks)
        assert sks[0]._td_means.shape == (128, 128)

    def test_hot_series_among_cold_ones(self):
        rng = np.random.default_rng(4)
        sks = _both(flush_points=10**9)
        hot = rng.normal(200.0, 10.0, 3 * LiveSketches._MAX_CHUNK + 17)
        _observe(sks, b"hot", hot)
        for i in range(50):
            _observe(sks, b"c%02d" % i, rng.normal(float(i), 0.1, 3))
        sks[0].flush()
        _assert_quantiles(*sks, [b"hot"], [0.5, 0.99], hot)
        np.testing.assert_allclose(sks[0].quantile([b"c07"], [0.5]), [7.0],
                                   atol=0.2)
        # Rounds of one chunk per slot: the hot series folds four times,
        # the cold ones once, in the JAX package's calls.
        assert sks[0].fold_calls == 5
        _assert_same_state(*sks)

    @pytest.mark.parametrize("writer", ["port", "jax"])
    def test_save_load_crosses_packages(self, tmp_path, writer):
        rng = np.random.default_rng(5)
        port, jax_sk = _both()
        vals = rng.normal(10, 2, 3000)
        tags = [(b"m1", b"k1", b"v01"), (b"m1", b"k1", b"v02")]
        for i in range(20):
            _observe((port, jax_sk), b"sr%02d" % i, vals[i::20], tags)
        path = str(tmp_path / "s.npz")
        src = port if writer == "port" else jax_sk
        src.save(path)
        loaded = (JaxSketches.load(path) if writer == "port"
                  else LiveSketches.load(path, device="cpu"))
        ls, lh, larr = _state(loaded)
        ss, sh, sarr = _state(src)
        assert ls == ss and lh == sh
        for a, b in zip(larr, sarr):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
        z = np.load(path, allow_pickle=True)
        assert sorted(z.files) == sorted(
            ["td_keys", "hll_metric", "hll_tagk", "td_means", "td_weights",
             "hll_regs", "meta"])
        assert loaded.distinct(b"m1", b"k1") == 2
        np.testing.assert_allclose(
            np.asarray(loaded.quantile([b"sr03"], [0.5])),
            np.asarray(src.quantile([b"sr03"], [0.5])), rtol=1e-6)

    def test_merge_from(self):
        rng = np.random.default_rng(6)
        pa, pb = LiveSketches(device="cpu"), LiveSketches(device="cpu")
        ja, jb = JaxSketches(), JaxSketches()
        va = rng.normal(0, 1, 4000)
        vb = rng.normal(0, 1, 4000)
        _observe((pa, ja), b"s", va, [(b"m", b"k", b"v01")])
        _observe((pb, jb), b"s", vb, [(b"m", b"k", b"v02")])
        _observe((pb, jb), b"t", vb[:10], [(b"m", b"j", b"v03")])
        pa.merge_from(pb)
        ja.merge_from(jb)
        got = _assert_quantiles(pa, ja, [b"s"], [0.9],
                                np.concatenate([va, vb]))
        assert abs(float(got[0]) - np.quantile(np.concatenate([va, vb]),
                                               0.9)) < 0.1
        assert pa.distinct(b"m", b"k") == 2 == ja.distinct(b"m", b"k")
        _assert_same_state(pa, ja)


def _port(wal=None, **kw):
    return TSDB(MemKVStore(wal_path=wal),
                Config(auto_create_metrics=True, device="cpu", **kw),
                start_compaction_thread=False)


def _jax(wal=None, **kw):
    return JaxTSDB(JaxStore(wal_path=wal),
                   JaxConfig(auto_create_metrics=True, device_window=False,
                             **kw),
                   start_compaction_thread=False)


class TestTSDBIntegration:
    def test_ingest_folds_sketches(self):
        rng = np.random.default_rng(7)
        t, j = _port(), _jax()
        for h in range(20):
            ts = BT + np.arange(100) * 30
            vals = rng.normal(50, 10, 100)
            for db in (t, j):
                db.add_batch("sys.cpu", ts, vals,
                             {"host": f"h{h:02d}", "dc": "east"})
        ex, jex = QueryExecutor(t), JaxExecutor(j)
        for tagk, n in (("host", 20), ("dc", 1)):
            assert ex.sketch_distinct("sys.cpu", tagk) == n \
                == jex.sketch_distinct("sys.cpu", tagk)
        assert ex.sketch_distinct("sys.cpu", "rack") is None
        out = ex.sketch_quantiles("sys.cpu", {}, [0.5, 0.99])
        want = jex.sketch_quantiles("sys.cpu", {}, [0.5, 0.99])
        assert out["series"] == want["series"] == 20
        assert list(out["quantiles"]) == list(want["quantiles"])
        np.testing.assert_allclose(list(out["quantiles"].values()),
                                   list(want["quantiles"].values()),
                                   rtol=0.02)
        assert 45 < out["quantiles"]["0.5"] < 55
        one = ex.sketch_quantiles("sys.cpu", {"host": "h03"}, [0.5])
        assert one["series"] == 1
        assert ex.sketch_quantiles("sys.cpu", {"host": "h03|h04"},
                                   [0.5])["series"] == 2
        _assert_same_state(t.sketches, j.sketches)

    def test_add_point_folds_too(self):
        t, j = _port(), _jax()
        for i in range(50):
            for db in (t, j):
                db.add_point("m.p", BT + i, float(i), {"h": "x"})
        out = QueryExecutor(t).sketch_quantiles("m.p", {}, [0.5])
        assert abs(out["quantiles"]["0.5"] - 24.5) < 2.0
        _assert_same_state(t.sketches, j.sketches)

    def test_throttled_batch_registers_but_folds_nothing(self):
        t = TSDB(MemKVStore(throttle_rows=2),
                 Config(auto_create_metrics=True, device="cpu"),
                 start_compaction_thread=False)
        with pytest.raises(PleaseThrottleError):
            t.add_batch("m", BT + np.arange(5) * 3600, np.arange(5.0),
                        {"host": "a"})
        assert t.sketches.series_count() == 1
        t.sketches.flush()
        assert float(t.sketches._td_weights.sum()) == 0.0
        assert not t.sketches._hll_slots

    def test_clean_restart_recovers_sketches(self, tmp_path):
        rng = np.random.default_rng(8)
        wal = str(tmp_path / "wal")
        t = _port(wal)
        vals = rng.normal(75, 5, 2000)
        for chunk in np.split(vals, 10):
            t.add_batch("m.r", BT + np.arange(200) * 5, chunk,
                        {"host": "a"})
        before = t.sketches.quantile(list(t.sketches.series_keys()), [0.9])
        t.shutdown()
        t2 = _port(wal)
        try:
            after = t2.sketches.quantile(list(t2.sketches.series_keys()),
                                         [0.9])
            np.testing.assert_array_equal(after, before)
            assert t2.sketch_load_seconds > 0
        finally:
            t2.shutdown()

    @pytest.mark.parametrize("checkpoint", [False, True])
    def test_crash_recovery_matches_jax(self, tmp_path, checkpoint):
        """Crash with no snapshot (full rebuild from the WAL-replayed
        memtable) or after a checkpoint (snapshot + the tail re-folded):
        the port's recovered state is the JAX package's after the same
        crash. Each series spans three row-hours of 400 values (more than
        a digest keeps) and the sketches hand off every 500 points, so
        the digests depend on the re-fold reading
        rows in row-key order (hours across series), as the JAX package
        does: the digests are held equal (the same compress sequence;
        cluster weights exact, means within rtol 1e-6)."""
        rng = np.random.default_rng(9)
        parts = [[(f"pre{h}", BT + np.arange(400) * 27,
                   rng.normal(10, 1, 400)) for h in range(5)],
                 [(f"post{h}", BT + 3600 + np.arange(400) * 27,
                   rng.normal(20, 1, 400)) for h in range(5, 9)]]
        recovered = []
        for name, make in (("port", _port), ("jax", _jax)):
            wal = str(tmp_path / name / "wal")
            db = make(wal, sketch_flush_points=500)
            for i, part in enumerate(parts):
                for host, ts, v in part:
                    db.add_batch("m.k", ts, v, {"host": host})
                if i == 0 and checkpoint:
                    assert db.checkpoint() > 0
            db.store.flush()
            db.store._simulate_crash() if name == "jax" else \
                db.store.close()
            recovered.append(make(wal, sketch_flush_points=500))
        t2, j2 = recovered
        try:
            ex = QueryExecutor(t2)
            assert ex.sketch_distinct("m.k", "host") == 9
            out = ex.sketch_quantiles("m.k", {}, [0.5])
            assert 9 < out["quantiles"]["0.5"] < 21 and out["series"] == 9
            _assert_same_state(t2.sketches, j2.sketches)
            np.testing.assert_array_equal(
                t2.sketches._td_weights.numpy(),
                np.asarray(j2.sketches._td_weights))
            np.testing.assert_allclose(t2.sketches._td_means.numpy(),
                                       np.asarray(j2.sketches._td_means),
                                       rtol=1e-6)
            _assert_quantiles(t2.sketches, j2.sketches,
                              t2.sketches.series_keys(), [0.1, 0.5, 0.9])
        finally:
            t2.shutdown()
            j2.shutdown()

    def test_checkpoint_then_crash_does_not_lose_folds(self, tmp_path):
        rng = np.random.default_rng(10)
        wal = str(tmp_path / "wal")
        t = _port(wal)
        for h in range(6):
            t.add_batch("m.w", BT + np.arange(40) * 11,
                        rng.normal(5, 1, 40), {"host": f"h{h}"})
        t.checkpoint()
        t.store.close()  # crash: no shutdown, memtable empty on reopen
        t2 = _port(wal)
        try:
            assert QueryExecutor(t2).sketch_distinct("m.w", "host") == 6
            assert t2.sketches.series_count() == 6
        finally:
            t2.shutdown()

    def test_sketches_disabled(self, tmp_path):
        wal = str(tmp_path / "wal")
        t = _port(wal, enable_sketches=False)
        t.add_point("m", BT, 1, {"a": "b"})
        assert t.sketches is None
        ex = QueryExecutor(t)
        assert ex.sketch_distinct("m", "a") is None
        with pytest.raises(BadRequestError):
            ex.sketch_quantiles("m", {}, [0.5])
        # A stale snapshot beside the WAL is removed by the checkpoint:
        # it would not cover the rows spilled now.
        open(wal + ".sketches", "wb").close()
        assert t.checkpoint() > 0
        assert not os.path.exists(wal + ".sketches")
        t.shutdown()
