"""The port's scan fast path against the JAX package's: the store's
dirty-base index and transition stamps (``MemKVStore.dirty_bases`` /
``chunk_state``), the bloom-pruned scan (``scan_raw``'s ``series_hint``),
the executor's fragment cache (``_scan_selector``, shared per store) and
the ``cached`` flag of ``/q``.

Contracts (opentsdb_tpu/query/executor.py ``_scan_selector``): a warm
answer is bit-identical to a cold scan through every mutation the store
supports; the incrementally kept dirty-base set equals a full sweep of
the keys and the JAX store's at every step; a fragment tagged at one step
is valid at a later one in the port exactly when it is in the JAX
package; a hinted scan returns what an unhinted one returns while
skipping the same generations.
"""

import asyncio
import gc
import json
import threading

import numpy as np
import pytest

import opentsdb_tpu.storage.kv as jax_kv
import opentsdb_tpu_torch.storage.kv as port_kv
from opentsdb_tpu.core.tsdb import TSDB as JaxTSDB
from opentsdb_tpu.query.executor import QueryExecutor as JaxExecutor
from opentsdb_tpu.query.executor import QuerySpec as JaxSpec
from opentsdb_tpu.server.tsd import TSDServer as JaxServer
from opentsdb_tpu.utils.config import Config as JaxConfig
from opentsdb_tpu.utils.lru import LRUCache as JaxLRU
from opentsdb_tpu_torch.core.const import TIMESTAMP_BYTES, UID_WIDTH
from opentsdb_tpu_torch.core.tsdb import TSDB
from opentsdb_tpu_torch.query import executor as executor_mod
from opentsdb_tpu_torch.query.executor import QueryExecutor, QuerySpec
from opentsdb_tpu_torch.server.tsd import TSDServer
from opentsdb_tpu_torch.storage.kv import MemKVStore
from opentsdb_tpu_torch.utils.config import Config
from opentsdb_tpu_torch.utils.lru import LRUCache

BT = 1356998400
HOUR = 3600
CHUNK = 2 * HOUR
F = b"t"


def _configs(sketches=True, **kw):
    common = dict(auto_create_metrics=True, device_window=False,
                  enable_sketches=sketches, qcache_chunk_s=CHUNK, **kw)
    return JaxConfig(**common), Config(device="cpu", **common)


def _pair(tmp_path, sketches=True, throttle=None, **kw):
    """A JAX TSDB and a port TSDB, each on its own WAL, same config."""
    jc, pc = _configs(sketches, **kw)
    jt = JaxTSDB(jax_kv.MemKVStore(wal_path=str(tmp_path / "jax" / "wal"),
                                   throttle_rows=throttle),
                 jc, start_compaction_thread=False)
    pt = TSDB(MemKVStore(wal_path=str(tmp_path / "port" / "wal"),
                         throttle_rows=throttle),
              pc, start_compaction_thread=False)
    return jt, pt


def _port(tmp_path, name="store", **kw):
    _, pc = _configs(**kw)
    return TSDB(MemKVStore(wal_path=str(tmp_path / name / "wal")), pc,
                start_compaction_thread=False)


def _ingest(tsdb, metric, n_series, start, n, step, seed=0, hosts=None):
    """Seeded float values per series; returns the last timestamp."""
    rng = np.random.default_rng(seed)
    ts = start + np.arange(n, dtype=np.int64) * step
    for si in (range(n_series) if hosts is None else hosts):
        vals = np.round(rng.normal(20.0 + si, 3.0, n), 3)
        tsdb.add_batch(metric, ts, vals, {"host": f"h{si:02d}"})
    return int(ts[-1])


def _sweep(store, table="tsdb"):
    """The dirty-base set from a full sweep of the port store's keys (live
    rows and row tombstones, and the frozen tier's): the oracle of the
    incremental index."""
    with store._lock:
        tiers = [store._table(table)]
        if store._frozen is not None and table in store._frozen:
            tiers.append(store._frozen[table])
        keys = [k for t in tiers for ks in (t.rows, t.row_tombs) for k in ks
                if len(k) >= UID_WIDTH + TIMESTAMP_BYTES]
    if not keys:
        return np.empty(0, np.int64)
    blob = b"".join(k[UID_WIDTH:UID_WIDTH + TIMESTAMP_BYTES] for k in keys)
    return np.unique(np.frombuffer(blob, ">u4").astype(np.int64))


# ---------------------------------------------------------------------------
# Dirty sets and fragment validity through a sequence of mutations
# ---------------------------------------------------------------------------

FAR = BT + 5000 * HOUR
# Chunk starts probed at every step: the ingested range, the backfill's,
# one empty chunk and the far chunk.
PROBES = [BT - BT % CHUNK + i * CHUNK for i in range(-1, 10)] \
    + [FAR - FAR % CHUNK]


def _row(tsdb, host, base):
    return tsdb.row_key_for("dirt.metric", {"host": host}, base)


def _cells_delete(tsdb, host, base):
    row = _row(tsdb, host, base)
    cells = tsdb.store.get(tsdb.table, row, F)
    tsdb.store.delete(tsdb.table, row, F, [c.qualifier for c in cells[:1]])


def _far_put(tsdb):
    tsdb.store.put(tsdb.table, _row(tsdb, "h00", FAR), F, b"\x00\x10",
                   b"\x05")


def _far_delete(tsdb):
    tsdb.store.delete(tsdb.table, _row(tsdb, "h00", FAR), F, [b"\x00\x10"])


B0 = BT - BT % HOUR
STEPS = [
    ("ingest", lambda t: _ingest(t, "dirt.metric", 3, BT, 240, 60)),
    ("checkpoint", lambda t: t.checkpoint()),
    ("more-ingest",
     lambda t: _ingest(t, "dirt.metric", 3, BT + 240 * 60, 120, 60, 1)),
    ("put-over-spilled-row", lambda t: t.store.put(
        t.table, _row(t, "h01", B0 + HOUR), F, b"\xff\xf0", b"\x07")),
    ("delete-row-spilled",
     lambda t: t.store.delete_row(t.table, _row(t, "h00", B0))),
    ("delete-cells-spilled",
     lambda t: _cells_delete(t, "h02", B0 + 2 * HOUR)),
    ("far-put", _far_put),
    ("far-delete", _far_delete),
    ("checkpoint-full-merge", lambda t: t.checkpoint()),
    ("backfill", lambda t: _ingest(t, "dirt.metric", 2, BT + 7, 50, 60, 2)),
    ("checkpoint-2", lambda t: t.checkpoint()),
    ("empty-checkpoint", lambda t: t.checkpoint()),
    ("memtable-put-then-delete-row", lambda t: (
        t.store.put(t.table, _row(t, "h05", B0 + 7 * HOUR), F, b"\x00\x20",
                    b"\x01"),
        t.store.delete_row(t.table, _row(t, "h05", B0 + 7 * HOUR)))),
    ("checkpoint-3", lambda t: t.checkpoint()),
]


def _states(store):
    return [store.chunk_state("tsdb", c, c + CHUNK) for c in PROBES]


def _verdicts(history):
    """{(i, j, chunk): valid}: a fragment tagged with the state of step i
    is still exact at step j (the executor's test)."""
    out = {}
    for i, tag in enumerate(history):
        for j in range(i, len(history)):
            for c, (t_st, n_st) in enumerate(zip(tag, history[j])):
                seqs = t_st[0]
                _, floors, stamps, dirty = n_st
                out[i, j, c] = (not t_st[3] and not dirty and all(
                    e >= f and m <= e
                    for e, f, m in zip(seqs, floors, stamps)))
    return out


def test_dirty_sets_and_fragment_verdicts_match_jax(tmp_path):
    """After every step both stores name the same dirty bases, equal to
    the sweep of the port's keys, and every (tag step, later step, chunk)
    fragment verdict agrees."""
    jt, pt = _pair(tmp_path)
    try:
        hist_j, hist_p = [], []
        for name, step in STEPS:
            step(jt)
            step(pt)
            dj = jt.store.dirty_bases(jt.table)
            dp = pt.store.dirty_bases(pt.table)
            assert np.array_equal(dp, dj), (name, dp.tolist(), dj.tolist())
            assert np.array_equal(dp, _sweep(pt.store)), name
            hist_j.append(_states(jt.store))
            hist_p.append(_states(pt.store))
            assert [s[3] for s in hist_p[-1]] == [s[3] for s in hist_j[-1]]
        vj, vp = _verdicts(hist_j), _verdicts(hist_p)
        assert vp == vj
        # The sequence exercises both verdicts.
        assert any(vp.values()) and not all(vp.values())
    finally:
        jt.shutdown()
        pt.shutdown()


def test_net_zero_create_delete_still_invalidates(tmp_path):
    """A create-then-delete nets a base's refcount back to zero (clean
    again) but stamps it past every earlier tag, across the checkpoint
    that retires the tier (the JAX TestTransitionStamps)."""
    jt, pt = _pair(tmp_path)
    try:
        for t in (jt, pt):
            _ingest(t, "dirt.metric", 2, BT, 60, 60)
            t.checkpoint()
        lo = BT - BT % CHUNK
        seq0 = {id(t): t.store.chunk_state(t.table, lo, lo + CHUNK)
                for t in (jt, pt)}
        for t in (jt, pt):
            assert not seq0[id(t)][3]
            t.store.put(t.table, _row(t, "h00", B0), F, b"\xff\xf0", b"\x05")
            assert t.store.chunk_state(t.table, lo, lo + CHUNK)[3]
            t.store.delete(t.table, _row(t, "h00", B0), F, [b"\xff\xf0"])
            assert t.store.chunk_state(t.table, lo, lo + CHUNK)[2][0] \
                > seq0[id(t)][0][0]
            t.checkpoint()
            st = t.store.chunk_state(t.table, lo, lo + CHUNK)
            assert not st[3] and st[2][0] > seq0[id(t)][0][0]
            flo = FAR - FAR % CHUNK
            before = t.store.chunk_state(t.table, flo, flo + CHUNK)
            _far_put(t)
            _far_delete(t)
            after = t.store.chunk_state(t.table, flo, flo + CHUNK)
            assert not after[3] and after[2][0] > before[0][0]
        assert np.array_equal(pt.store.dirty_bases(pt.table),
                              jt.store.dirty_bases(jt.table))
    finally:
        jt.shutdown()
        pt.shutdown()


@pytest.mark.parametrize("fail", [False, True], ids=["spill", "thaw"])
def test_checkpoint_phase_two_and_thaw_match_jax(tmp_path, monkeypatch,
                                                 fail):
    """While the spill runs unlocked (phase 2) the frozen tier's bases
    read dirty; a failed spill thaws the tier back with every base
    re-stamped. Both packages agree at each point."""
    seen = {}

    def wrap(mod, tag):
        orig = mod.write_sstable_bulk

        def spill(*a, **k):
            st = stores[tag]
            seen[tag] = (st.dirty_bases("tsdb").tolist(),
                         [s[3] for s in _states(st)])
            if fail:
                raise OSError("disk full")
            return orig(*a, **k)
        monkeypatch.setattr(mod, "write_sstable_bulk", spill)

    jt, pt = _pair(tmp_path)
    stores = {"jax": jt.store, "port": pt.store}
    wrap(jax_kv, "jax")
    wrap(port_kv, "port")
    try:
        lo = BT - BT % CHUNK
        tags = {}
        for tag, t in (("jax", jt), ("port", pt)):
            _ingest(t, "dirt.metric", 3, BT, 200, 60)
            tags[tag] = _states(t.store)
            if fail:
                with pytest.raises(OSError):
                    t.checkpoint()
            else:
                t.checkpoint()
        assert seen["port"] == seen["jax"]
        assert seen["port"][0] and all(seen["port"][1][1:3])
        after = {tag: _states(stores[tag]) for tag in stores}
        assert [s[3] for s in after["port"]] == [s[3] for s in after["jax"]]
        assert _verdicts([tags["port"], after["port"]]) \
            == _verdicts([tags["jax"], after["jax"]])
        assert np.array_equal(pt.store.dirty_bases("tsdb"),
                              _sweep(pt.store))
        st = pt.store.chunk_state("tsdb", lo, lo + CHUNK)
        assert st[2][0] > tags["port"][1][0][0] or not fail
    finally:
        monkeypatch.undo()
        jt.shutdown()
        pt.shutdown()


def test_throttled_partial_batch_dirty_matches_jax(tmp_path):
    """A batch cut by the row throttle indexes exactly the rows it
    created, as the JAX store does."""
    jt, pt = _pair(tmp_path, throttle=30)
    try:
        for t in (jt, pt):
            with pytest.raises(Exception, match="holds >= 30 rows"):
                _ingest(t, "dirt.metric", 1, BT, 100, HOUR)
        assert len(pt.store.dirty_bases("tsdb")) > 0
        assert np.array_equal(pt.store.dirty_bases("tsdb"),
                              jt.store.dirty_bases("tsdb"))
        assert np.array_equal(pt.store.dirty_bases("tsdb"),
                              _sweep(pt.store))
    finally:
        jt.shutdown()
        pt.shutdown()


def test_replay_at_open_indexes_memtable(tmp_path):
    """A store reopened on its WAL rebuilds the dirty index from the
    replay: the same bases as before the close, in the port as in JAX."""
    jt, pt = _pair(tmp_path)
    for t in (jt, pt):
        _ingest(t, "dirt.metric", 2, BT, 120, 60)
        t.checkpoint()
        _ingest(t, "dirt.metric", 2, BT + 120 * 60, 60, 60, 1)
    want = pt.store.dirty_bases("tsdb").tolist()
    pt.store.flush()
    pt.store.close()
    jt.store.flush()
    jt.store.close()
    js = jax_kv.MemKVStore(wal_path=str(tmp_path / "jax" / "wal"))
    ps = MemKVStore(wal_path=str(tmp_path / "port" / "wal"))
    try:
        assert ps.dirty_bases("tsdb").tolist() == want \
            == js.dirty_bases("tsdb").tolist()
        assert np.array_equal(ps.dirty_bases("tsdb"), _sweep(ps))
    finally:
        js.close()
        ps.close()


def test_concurrent_ingest_dirty_equals_sweep(tmp_path):
    """Ingest, delete_row and checkpoint threads on one store, joined
    before each comparison (no race between the two derivations): the
    incremental set equals the sweep after every round."""
    pt = _port(tmp_path)
    try:
        for rnd in range(3):
            errors = []

            def ingester(si):
                try:
                    for i in range(8):
                        ts = BT + (np.arange(50, dtype=np.int64)
                                   + (rnd * 8 + i) * 50) * 60
                        pt.add_batch("con.metric", ts, np.ones(50) * si,
                                     {"host": f"c{si}"})
                        if i % 3 == 1:
                            row = pt.row_key_for(
                                "con.metric", {"host": f"c{si}"},
                                int(ts[0]) - int(ts[0]) % HOUR)
                            pt.store.delete_row(pt.table, row)
                except Exception as e:  # pragma: no cover
                    errors.append(e)

            def checkpointer():
                try:
                    for _ in range(3):
                        pt.checkpoint()
                except Exception as e:  # pragma: no cover
                    errors.append(e)

            threads = [threading.Thread(target=ingester, args=(si,))
                       for si in range(3)]
            threads.append(threading.Thread(target=checkpointer))
            for th in threads:
                th.start()
            for th in threads:
                th.join(120)
                assert not th.is_alive()
            assert not errors, errors
            assert np.array_equal(pt.store.dirty_bases(pt.table),
                                  _sweep(pt.store))
    finally:
        pt.shutdown()


# ---------------------------------------------------------------------------
# Warm equals cold equals JAX
# ---------------------------------------------------------------------------

SELECTORS = [{}, {"host": "*"}, {"host": "h01"}, {"host": "h01|h03"}]
BATTERY = [
    ("sum", None, False, {}),
    ("avg", (HOUR, "avg"), False, {}),
    ("max", (HOUR, "max"), False, {"host": "*"}),
    ("sum", None, False, {"host": "h01"}),
    ("sum", None, True, {}),
    ("p95", (HOUR, "sum"), False, {}),
]


def _assert_spans_equal(got, want, label):
    assert sorted(got) == sorted(want), label
    for g in want:
        a, b = got[g], want[g]
        assert [s.series_key for s in a] == [s.series_key for s in b], label
        for sa, sb in zip(a, b):
            assert sa.tags == sb.tags, label
            assert np.array_equal(sa.timestamps, sb.timestamps), label
            assert np.array_equal(sa.values, sb.values), label


def _check_stage(jt, pt, ex_j, ex_p, start, end, stage):
    for tags in SELECTORS:
        want = ex_j._find_spans(JaxSpec("par.metric", tags), start, end)
        spec = QuerySpec("par.metric", tags)
        warm1 = ex_p._find_spans(spec, start, end)
        info = {}
        warm2 = ex_p._find_spans(spec, start, end, info)
        pt.config.qcache = False
        try:
            cold = ex_p._find_spans(spec, start, end)
        finally:
            pt.config.qcache = True
        for label, got in (("warm1", warm1), ("warm2", warm2),
                           ("cold", cold)):
            _assert_spans_equal(got, want, f"{stage}/{tags}/{label}")
    for agg, ds, rate, tags in BATTERY:
        spec = QuerySpec("par.metric", tags, agg, rate=rate, downsample=ds)
        warm = ex_p.run(spec, start, end)
        pt.config.qcache = False
        try:
            cold = ex_p.run(spec, start, end)
        finally:
            pt.config.qcache = True
        assert len(warm) == len(cold)
        for w, c in zip(warm, cold):
            assert w.tags == c.tags and w.aggregated_tags == c.aggregated_tags
            assert np.array_equal(w.timestamps, c.timestamps), (stage, agg)
            assert np.array_equal(w.values, c.values), (stage, agg)


def test_warm_equals_cold_equals_jax_through_mutations(tmp_path):
    jt, pt = _pair(tmp_path)
    try:
        ex_j = JaxExecutor(jt, backend="cpu")
        ex_p = QueryExecutor(pt)
        end = max(_ingest(t, "par.metric", 5, BT, 600, 60) for t in (jt, pt))
        start = BT - 1
        _check_stage(jt, pt, ex_j, ex_p, start, end, "memtable")
        # The chunk before BT holds no rows: clean, so cached (empty).
        assert ex_p.qcache_bypasses > 0
        for t in (jt, pt):
            t.checkpoint()
        _check_stage(jt, pt, ex_j, ex_p, start, end, "spilled")
        hits = ex_p.qcache_hits
        assert hits > 0
        for t in (jt, pt):
            end = _ingest(t, "par.metric", 5, BT + 600 * 60, 300, 60, 1)
        _check_stage(jt, pt, ex_j, ex_p, start, end, "hot-tail")
        for t in (jt, pt):
            _ingest(t, "par.metric", 2, BT + 7, 50, 60, 2)
        _check_stage(jt, pt, ex_j, ex_p, start, end, "backfill")
        for t in (jt, pt):
            t.checkpoint()
        _check_stage(jt, pt, ex_j, ex_p, start, end, "backfill-spilled")
        for t in (jt, pt):
            t.store.delete_row(t.table, t.row_key_for(
                "par.metric", {"host": "h00"}, B0))
            row1 = t.row_key_for("par.metric", {"host": "h01"}, B0)
            cells = t.store.get(t.table, row1, F)
            t.store.delete(t.table, row1, F,
                           [c.qualifier for c in cells[:1]])
        _check_stage(jt, pt, ex_j, ex_p, start, end, "deleted")
        for t in (jt, pt):
            t.checkpoint()
        _check_stage(jt, pt, ex_j, ex_p, start, end, "deleted-merged")
        assert ex_p.qcache_hits > hits and ex_p.qcache_misses > 0
    finally:
        jt.shutdown()
        pt.shutdown()


def test_cached_flag_and_counters_match_jax(tmp_path):
    """run_with_plan's third value and the hit/miss/bypass counters move
    as the JAX executor's do: bypass before a checkpoint, miss then hit
    after it, and a live tail makes a chunk bypass again."""
    jt, pt = _pair(tmp_path)
    try:
        ex_j = JaxExecutor(jt, backend="cpu")
        ex_p = QueryExecutor(pt)
        seen = []
        for t in (jt, pt):
            _ingest(t, "par.metric", 3, BT, 300, 60)
        spec = ("par.metric", {}, "sum")

        def run():
            a = ex_j.run_with_plan(JaxSpec(*spec), BT, BT + 5 * HOUR)
            b = ex_p.run_with_plan(QuerySpec(*spec), BT, BT + 5 * HOUR)
            assert a[1:] == b[1:]
            seen.append(b[2])
            assert (ex_p.qcache_hits, ex_p.qcache_misses,
                    ex_p.qcache_bypasses) == (
                ex_j.qcache_hits, ex_j.qcache_misses, ex_j.qcache_bypasses)

        run()
        for t in (jt, pt):
            t.checkpoint()
        run()
        run()
        for t in (jt, pt):
            t.add_point("par.metric", BT + 4 * HOUR + 5, 1.5,
                        {"host": "h00"})
        run()
        assert seen == [False, False, True, False]
    finally:
        jt.shutdown()
        pt.shutdown()


# ---------------------------------------------------------------------------
# The bloom-pruned scan and the candidate-series hint
# ---------------------------------------------------------------------------

def _two_generations(t):
    end = _ingest(t, "bl.one", 3, BT, 200, 60)
    t.checkpoint()
    _ingest(t, "bl.two", 3, BT, 200, 60, 1)
    t.checkpoint()
    return end


@pytest.mark.parametrize("tags", [{"host": "h01"}, {}],
                         ids=["regexp", "tiered"])
def test_bloom_prunes_disjoint_generations_like_jax(tmp_path, tags):
    """Generations holding different metrics: a query of one skips the
    other's generation in both packages alike, answers unchanged against
    an unhinted, uncached scan, and the skipped generation is never read
    (the tiered branch included)."""
    jt, pt = _pair(tmp_path)
    try:
        end = max(_two_generations(t) for t in (jt, pt))
        assert len(pt.store._ssts) == len(jt.store._ssts) == 2
        ex_j = JaxExecutor(jt, backend="cpu")
        ex_p = QueryExecutor(pt)
        sj, sp = jt.store.bloom_files_skipped, pt.store.bloom_files_skipped

        def boom(*a, **k):
            raise AssertionError("read a generation the bloom ruled out")
        skipped = pt.store._ssts[1]
        skipped.iter_rows_range = skipped.scan_keys = boom
        want = ex_j._find_spans(JaxSpec("bl.one", tags), BT - 1, end)
        got = ex_p._find_spans(QuerySpec("bl.one", tags), BT - 1, end)
        del skipped.iter_rows_range, skipped.scan_keys
        _assert_spans_equal(got, want, "hinted")
        assert pt.store.bloom_files_skipped - sp \
            == jt.store.bloom_files_skipped - sj > 0
        pt.config.qcache = False
        sk, pt.sketches = pt.sketches, None
        try:
            oracle = ex_p._find_spans(QuerySpec("bl.one", tags), BT - 1, end)
        finally:
            pt.sketches = sk
            pt.config.qcache = True
        _assert_spans_equal(got, oracle, "unhinted")
    finally:
        jt.shutdown()
        pt.shutdown()


def test_empty_or_missing_hint_never_prunes(tmp_path):
    pt = _port(tmp_path)
    try:
        _two_generations(pt)
        for hint in (None, np.zeros(0, np.uint64)):
            rows = list(pt.store.scan_raw(pt.table, b"", b"\xff",
                                          series_hint=hint))
            assert len(rows) == len(list(pt.store.scan_raw(
                pt.table, b"", b"\xff")))
        assert pt.store.bloom_files_skipped == 0
    finally:
        pt.shutdown()


@pytest.mark.parametrize("tags", [{"host": "h01"}, {"host": "*"},
                                  {"host": "h00|h02"}, {}],
                         ids=["exact", "wildcard", "alternation", "none"])
def test_series_hint_matches_jax(tmp_path, tags):
    jt, pt = _pair(tmp_path)
    try:
        for t in (jt, pt):
            _ingest(t, "hint.metric", 4, BT, 30, 60)
            _ingest(t, "hint.other", 2, BT, 30, 60)
        ex_j, ex_p = JaxExecutor(jt, backend="cpu"), QueryExecutor(pt)
        mj = jt.metrics.get_id("hint.metric")
        mp = pt.metrics.get_id("hint.metric")
        assert mj == mp
        hj = ex_j._series_hint(mj, *ex_j._tag_filters(tags))
        hp = ex_p._series_hint(mp, *ex_p._tag_filters(tags))
        assert hp.dtype == np.uint64
        assert sorted(hp.tolist()) == sorted(hj.tolist())
        assert len(hp) == (1 if tags.get("host", "*") == "h01" else
                           2 if "|" in tags.get("host", "") else 4)
        # Cached per (metric, filter) until the metric's directory grows.
        assert ex_p._series_hint(mp, *ex_p._tag_filters(tags)) is hp
    finally:
        jt.shutdown()
        pt.shutdown()


def test_series_hint_none_without_sketches(tmp_path):
    jt, pt = _pair(tmp_path, sketches=False)
    try:
        for t in (jt, pt):
            _ingest(t, "hint.metric", 2, BT, 30, 60)
        ex_j, ex_p = JaxExecutor(jt, backend="cpu"), QueryExecutor(pt)
        m = pt.metrics.get_id("hint.metric")
        assert ex_j._series_hint(m, [], []) is None
        assert ex_p._series_hint(m, [], []) is None
    finally:
        jt.shutdown()
        pt.shutdown()


# ---------------------------------------------------------------------------
# The LRU and the shared per-store cache
# ---------------------------------------------------------------------------

LRU_OPS = [("put", "a", 1, 6), ("put", "b", 2, 6), ("get", "a"),
           ("put", "big", 3, 11), ("put", "b", 9, 2), ("put", "c", 4, 3),
           ("put", "d", 5, 1), ("get", "b"), ("resize", 2, 5),
           ("put", "e", 6, 1), ("pop", "e"), ("resize", 3, None),
           ("put", "f", 7, 50), ("peek", "d")]


def test_lru_matches_jax_step_for_step():
    """Entry and cost bounds, the over-budget refusal, replacement cost,
    recency, resize and pop: the port's LRU and the JAX package's hold
    the same keys, cost and evictions after every operation."""
    caches = (LRUCache(3, max_cost=10), JaxLRU(3, max_cost=10))
    for op, *args in LRU_OPS:
        got = []
        for c in caches:
            if op == "put":
                key, val, cost = args
                got.append(c.put(key, val, cost=cost))
            elif op == "resize":
                got.append(c.resize(args[0], max_cost=args[1]))
            else:
                got.append(getattr(c, op)(args[0]))
        assert got[0] == got[1], op
        assert (list(caches[0].keys()), caches[0].cost,
                caches[0].evictions) == (list(caches[1].keys()),
                                         caches[1].cost,
                                         caches[1].evictions), (op, args)
    c = LRUCache(3)
    for i in range(4):
        c.put(i, i)
    assert 0 not in c and len(c) == 3
    c.get(1)
    c.put(4, 4)
    assert 2 not in c and 1 in c
    with pytest.raises(ValueError):
        c.resize(0)
    c.clear()
    assert len(c) == 0 and c.cost == 0


def test_second_executor_starts_warm(tmp_path):
    pt = _port(tmp_path)
    try:
        end = _ingest(pt, "m.shared", 3, BT, 500, 60)
        pt.checkpoint()
        spec = QuerySpec("m.shared", {}, "sum", downsample=(HOUR, "sum"))
        ex1 = QueryExecutor(pt)
        r1 = ex1.run(spec, BT, end)
        assert ex1.qcache_misses > 0
        ex2 = QueryExecutor(pt)
        assert ex2._frag_cache is ex1._frag_cache
        r2 = ex2.run(spec, BT, end)
        assert ex2.qcache_hits > 0 and ex2.qcache_misses == 0
        for a, b in zip(r1, r2):
            assert np.array_equal(a.timestamps, b.timestamps)
            assert np.array_equal(a.values, b.values)
    finally:
        pt.shutdown()


def test_mutation_invalidates_for_every_executor(tmp_path):
    pt = _port(tmp_path)
    try:
        end = _ingest(pt, "m.inval", 2, BT, 300, 60)
        pt.checkpoint()
        spec = QuerySpec("m.inval", {}, "sum")
        ex1, ex2 = QueryExecutor(pt), QueryExecutor(pt)
        ex1.run(spec, BT, end)
        before = ex2.run(spec, BT, end)
        pt.add_point("m.inval", BT + 30, 1000.0, {"host": "h00"})
        after = ex2.run(spec, BT, end)
        assert not np.array_equal(before[0].values, after[0].values)
        pt.config.qcache = False
        cold = ex1.run(spec, BT, end)
        assert np.array_equal(after[0].values, cold[0].values)
    finally:
        pt.shutdown()


def test_distinct_stores_do_not_share_and_rebound_in_place(tmp_path):
    t1 = _port(tmp_path, name="s1")
    t2 = _port(tmp_path, name="s2")
    try:
        e1, e2 = QueryExecutor(t1), QueryExecutor(t2)
        assert e1._frag_cache is not e2._frag_cache
        t1.config.qcache_points = 12345
        t1.config.qcache_fragments = 7
        e3 = QueryExecutor(t1)
        assert e3._frag_cache is e1._frag_cache
        assert (e1._frag_cache.max_cost, e1._frag_cache.max_entries) \
            == (12345, 7)
        assert e2._frag_cache.max_cost == 1 << 24
    finally:
        t1.shutdown()
        t2.shutdown()


def test_cache_dies_with_store(tmp_path):
    pt = _port(tmp_path, name="s3")
    QueryExecutor(pt)
    n0 = len(executor_mod._FRAG_CACHES)
    assert pt.store in executor_mod._FRAG_CACHES
    pt.shutdown()
    del pt
    gc.collect()
    assert len(executor_mod._FRAG_CACHES) < n0


def test_default_config_mirrors_jax():
    jc, pc = JaxConfig(), Config(device="cpu")
    for name in ("qcache", "qcache_chunk_s", "qcache_points",
                 "qcache_fragments", "qcache_max_chunks"):
        assert getattr(pc, name) == getattr(jc, name), name


def test_wide_range_scans_unchunked(tmp_path):
    """A range of more than qcache_max_chunks chunks scans whole and
    touches no counter, as in the JAX package."""
    pt = _port(tmp_path, qcache_max_chunks=2)
    try:
        end = _ingest(pt, "m.wide", 2, BT, 600, 60)
        pt.checkpoint()
        ex = QueryExecutor(pt)
        info = {}
        ex._find_spans(QuerySpec("m.wide", {}), BT, end, info)
        assert (ex.qcache_hits, ex.qcache_misses, ex.qcache_bypasses) \
            == (0, 0, 0) and info == {}
    finally:
        pt.shutdown()


# ---------------------------------------------------------------------------
# The daemons: /q twice
# ---------------------------------------------------------------------------

async def _get(port, target):
    reader, writer = await asyncio.open_connection("127.0.0.1", port)
    writer.write(f"GET {target} HTTP/1.1\r\nConnection: close\r\n\r\n"
                 .encode())
    await writer.drain()
    raw = await asyncio.wait_for(reader.read(), 30)
    writer.close()
    head, _, body = raw.partition(b"\r\n\r\n")
    return int(head.split()[1]), body


async def _telnet(port, lines):
    reader, writer = await asyncio.open_connection("127.0.0.1", port)
    writer.write((lines[0] + "\n").encode())
    await writer.drain()
    await asyncio.sleep(0.2)
    writer.write(("\n".join(lines[1:]) + "\nversion\nexit\n").encode())
    await writer.drain()
    out = await asyncio.wait_for(reader.read(), 30)
    writer.close()
    return out.decode()


Q_TARGETS = [
    f"/q?start={BT}&end={BT + 5 * HOUR}&m=sum:1h-avg:srv.metric&json",
    f"/q?start={BT}&end={BT + 5 * HOUR}&m=sum:srv.metric%7Bhost=*%7D"
    f"&m=max:srv.metric%7Bhost=h01%7D&json",
]


def _drive(server_cls, tsdb, lines):
    """Telnet puts (one line alone, then the rest pipelined), a
    checkpoint, then each /q target twice. Returns the answers, the
    executor's (hits, misses, bypasses) and the stored series keys."""
    server = server_cls(tsdb)

    async def main():
        await server.start()
        try:
            said = await _telnet(server.port, lines)
            assert "put:" not in said, said
            stored = {k[:UID_WIDTH] + k[UID_WIDTH + TIMESTAMP_BYTES:]
                      for k, _ in tsdb.store.scan_raw(tsdb.table, b"",
                                                      b"\xff")}
            tsdb.checkpoint()
            got = [await _get(server.port, t) for t in Q_TARGETS
                   for _ in range(2)]
            ex = server.executor
            return got, (ex.qcache_hits, ex.qcache_misses,
                         ex.qcache_bypasses), stored
        finally:
            await server.stop()
    return asyncio.run(main())


def test_q_twice_matches_jax_daemon(tmp_path):
    """The same puts and /q requests to both daemons: every body
    byte-identical between them, the repeat "cached": true and otherwise
    the first body's bytes, the counters equal; every stored series is
    in the port's sketch directory (the hint's superset) on both telnet
    paths."""
    rng = np.random.default_rng(5)
    lines = []
    for h in ("h00", "h01", "h02"):
        for t in np.sort(rng.choice(5 * HOUR, 120, replace=False)):
            lines.append(f"put srv.metric {BT + int(t)} "
                         f"{round(float(rng.normal(50, 5)), 3)} host={h}")
    cfg = dict(auto_create_metrics=True, port=0, bind="127.0.0.1",
               device_window=False, backend="cpu", qcache_chunk_s=CHUNK)
    jt = JaxTSDB(jax_kv.MemKVStore(wal_path=str(tmp_path / "j" / "wal")),
                 JaxConfig(**cfg), start_compaction_thread=False)
    pt = TSDB(MemKVStore(wal_path=str(tmp_path / "p" / "wal")),
              Config(device="cpu", **cfg), start_compaction_thread=False)
    want, want_counts, _ = _drive(JaxServer, jt, lines)
    pt_init = pt.sketches
    got, counts, stored = _drive(TSDServer, pt, lines)
    assert got == want
    assert counts == want_counts and counts[0] > 0
    for (s1, b1), (s2, b2) in zip(got[::2], got[1::2]):
        assert s1 == s2 == 200
        d1, d2 = json.loads(b1), json.loads(b2)
        assert d1 and all(g["cached"] is False for g in d1)
        assert all(g["cached"] is True for g in d2)
        assert b1.replace(b'"cached": false', b'"cached": true') == b2
    known = set(pt_init.metric_series_keys(pt.metrics.get_id(
        "srv.metric")))
    assert len(stored) == 3 and stored <= known
