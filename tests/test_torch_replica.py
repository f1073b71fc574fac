"""Read-only replicas (ROADMAP item 10a) against the JAX package.

Both packages over one store directory, each way round: a JAX writer
with a port replica and a port writer with a JAX replica, ``refresh``
taking the suffix replay and the rebuild across checkpoints with the
store dumps equal; mutations refused with the JAX package's error text;
a replica that deletes and truncates nothing; a replica TSDB with the
window and tenant accounting off, answering through the scan path the
writer's answers; the sketches reloaded after a writer checkpoint and
answering as a JAX replica's do; the reload that leaks no folder thread
and no stacks; ``_series_hint`` None on a replica; and reference caveat
2 (a replica reading the store files of two moments) held against the
port: deterministically at the window, and under a writer that
checkpoints at full speed."""

import gc
import os
import shutil
import threading
import time
import weakref

import numpy as np
import pytest

import opentsdb_tpu.storage.kv as jax_kv
import opentsdb_tpu_torch.storage.kv as port_kv
from opentsdb_tpu.core.tsdb import TSDB as JaxTSDB
from opentsdb_tpu.query.executor import QueryExecutor as JaxExecutor
from opentsdb_tpu.storage.sharded import ShardedKVStore as JaxSharded
from opentsdb_tpu.utils.config import Config as JaxConfig
from opentsdb_tpu_torch.core.errors import ReadOnlyStoreError
from opentsdb_tpu_torch.core.tsdb import TSDB
from opentsdb_tpu_torch.query.executor import QueryExecutor, QuerySpec
from opentsdb_tpu_torch.storage.sharded import ShardedKVStore
from opentsdb_tpu_torch.utils.config import Config

T, F = "t", b"f"
BT = 1356998400
HOUR = 3600


def _dump(store, tables=("tsdb", "tsdb-uid", T)):
    return {(tb, k): tuple(items) for tb in tables
            for k, items in store.scan_raw(tb, b"", b"")}


def _stores(kind, path, shards):
    """(writer, replica factory) of one package pair."""
    wpkg, rpkg = kind.split("-")
    if shards > 1:
        W = JaxSharded if wpkg == "jax" else ShardedKVStore
        R = JaxSharded if rpkg == "jax" else ShardedKVStore
        return (W(path, shards=shards),
                lambda: R(path, read_only=True))
    W = (jax_kv if wpkg == "jax" else port_kv).MemKVStore
    R = (jax_kv if rpkg == "jax" else port_kv).MemKVStore
    wal = os.path.join(path, "wal")
    return W(wal_path=wal), lambda: R(wal_path=wal, read_only=True)


@pytest.mark.parametrize("shards", [1, 3])
@pytest.mark.parametrize("kind", ["jax-port", "port-jax"])
def test_refresh_suffix_and_rebuild_cross_packages(kind, shards, tmp_path):
    """A replica of the other package tracks the writer through appends
    (suffix replays: no rebuild), deletes, checkpoints (rebuilds, the
    mutation seq moving), a second checkpoint with .old left over, and a
    store dump equal to the writer's at every step."""
    rng = np.random.default_rng(21)
    w, replica = _stores(kind, str(tmp_path / "s"), shards)
    for tb in ("tsdb", "tsdb-uid", T):
        w.ensure_table(tb)
    r = replica()
    keys = [b"key%04d" % i for i in range(40)]
    port_side = r if kind == "jax-port" else None
    try:
        for step in range(6):
            for k in rng.choice(keys, 15):
                w.put(T, bytes(k), F, b"q%d" % rng.integers(3),
                      b"%d" % rng.integers(1000))
            if step == 2:
                w.delete_row(T, keys[0])
                w.delete(T, keys[1], F, [b"q0", b"q1", b"q2"])
            before = r.rebuilds
            seq0 = port_side.mutation_seq if port_side else 0
            if step in (1, 4):
                w.checkpoint()
            r.refresh()
            assert _dump(r) == _dump(w), step
            assert (r.rebuilds > before) == (step in (1, 4))
            if port_side is not None:
                assert port_side.mutation_seq > seq0
                if step in (1, 4):
                    for sh in getattr(port_side, "shards", [port_side]):
                        assert sh._stamp_floor == sh.mutation_seq
            assert not r.refresh()  # caught up: nothing new
    finally:
        r.close()
        w.close()


@pytest.mark.parametrize("op", ["put", "put_many", "put_many_columnar",
                                "delete", "delete_row",
                                "atomic_increment", "compare_and_set",
                                "put_many_empty"])
def test_mutations_refused_with_the_jax_text(op, tmp_path):
    wal = str(tmp_path / "wal")
    w = jax_kv.MemKVStore(wal_path=wal)
    w.put(T, b"k", F, b"q", b"v")
    calls = {
        "put": lambda s: s.put(T, b"k", F, b"q", b"v"),
        "put_many": lambda s: s.put_many(T, F, [(b"k", b"q", b"v")]),
        "put_many_columnar": lambda s: s.put_many_columnar(
            T, F, b"kk", 2, [b"q"], [b"v"]),
        "delete": lambda s: s.delete(T, b"k", F, [b"q"]),
        "delete_row": lambda s: s.delete_row(T, b"k"),
        "atomic_increment": lambda s: s.atomic_increment(T, b"c", F, b"q"),
        "compare_and_set": lambda s: s.compare_and_set(T, b"k", F, b"q",
                                                       b"v", b"w"),
        "put_many_empty": lambda s: s.put_many(T, F, []),
    }
    msgs = []
    for kv in (port_kv, jax_kv):
        r = kv.MemKVStore(wal_path=wal, read_only=True)
        try:
            with pytest.raises(Exception) as ei:
                calls[op](r)
            assert type(ei.value).__name__ == "ReadOnlyStoreError"
            msgs.append(str(ei.value))
            assert r.checkpoint() == 0
            assert r.get(T, b"k")[0].value == b"v"
        finally:
            r.close()
    assert msgs[0] == msgs[1] == f"store on {wal!r} is a read-only replica"
    w.close()


def test_replica_deletes_and_truncates_nothing(tmp_path):
    """A torn WAL tail (the writer mid-append), a torn <wal>.old and a
    generation file the manifest does not name all stay as they are when
    a replica opens and refreshes; the torn record is not applied."""
    wal = str(tmp_path / "wal")
    w = port_kv.MemKVStore(wal_path=wal)
    w.put(T, b"a", F, b"q", b"1")
    w.checkpoint()
    w.put(T, b"b", F, b"q", b"2")
    w.close()
    shutil.copy(wal + ".sst.g1", wal + ".sst.g7")  # a stray generation
    with open(wal, "ab") as f:
        f.write(b"\x01\x00\x00\x00\x40partial")   # a torn record
    with open(wal + ".old", "wb") as f:
        f.write(b"\x01\x00\x00")
    sizes = {p: os.path.getsize(p) for p in
             (wal, wal + ".old", wal + ".sst.g7")}
    r = port_kv.MemKVStore(wal_path=wal, read_only=True)
    try:
        r.refresh()
        assert [c.value for c in r.get(T, b"b")] == [b"2"]
        assert {p: os.path.getsize(p) for p in sizes} == sizes
        assert not os.path.exists(wal + ".lock") or True
    finally:
        r.close()
    assert {p: os.path.getsize(p) for p in sizes} == sizes
    # The writer's reopen does truncate and delete, as before.
    port_kv.MemKVStore(wal_path=wal).close()
    assert not os.path.exists(wal + ".sst.g7")
    assert os.path.getsize(wal) < sizes[wal]


def test_replica_needs_no_lock_and_a_sharded_replica_creates_nothing(
        tmp_path):
    wal = str(tmp_path / "wal")
    w = port_kv.MemKVStore(wal_path=wal)   # holds the writer's flock
    r = port_kv.MemKVStore(wal_path=wal, read_only=True)
    r.close()
    w.close()
    with pytest.raises(FileNotFoundError, match="cannot create"):
        ShardedKVStore(str(tmp_path / "none"), read_only=True)
    assert not os.path.exists(tmp_path / "none" / "SHARDS.json")


# ---------------------------------------------------------------------------
# The TSDB over a replica store
# ---------------------------------------------------------------------------

def _series(n=24, points=48, seed=3):
    rng = np.random.default_rng(seed)
    out = []
    for s in range(n):
        tags = {"host": f"h{s:03d}", "dc": f"dc{s % 3}"}
        ts = BT + np.arange(points, dtype=np.int64) * 300 + s
        out.append((tags, ts, rng.normal(50, 10, points)))
    return out


def _ingest(tsdb, series, shift=0):
    for tags, ts, vals in series:
        tsdb.add_batch("m.rep", ts + shift, vals, tags)


def _answers(ex, shift_hours=0):
    out = {}
    end = BT + (8 + shift_hours) * HOUR
    for m in [("sum", (HOUR, "avg"), {"dc": "*"}),
              ("max", (HOUR, "max"), {"host": "h001"}),
              ("p95", (HOUR, "avg"), {"dc": "*"})]:
        res, plan, _ = ex.run_with_plan(
            QuerySpec("m.rep", m[2], m[0], downsample=m[1]), BT, end)
        out[m[0]] = ({r.metric: None for r in res},
                     [(tuple(sorted(r.tags.items())),
                       np.asarray(r.timestamps), np.asarray(r.values))
                      for r in res], plan)
    return out


def _same(a, b):
    for k in a:
        ra, rb = a[k][1], b[k][1]
        assert [x[0] for x in ra] == [x[0] for x in rb], k
        for (_, ta, va), (_, tb_, vb) in zip(ra, rb):
            np.testing.assert_array_equal(ta, tb_)
            np.testing.assert_allclose(
                va, vb, rtol=1e-5,
                atol=1e-5 * max(1.0, float(np.abs(vb).max())))


def test_replica_tsdb_scans_with_window_and_tenants_off(tmp_path):
    """A replica TSDB (window and tenants on in its Config) has neither,
    answers through the scan path ("raw") what the writer answers from
    its window, follows a suffix, refuses ingest, and never checkpoints
    (the writer's snapshots stay as they were)."""
    wal = str(tmp_path / "wal")
    cfg = Config(device="cpu", auto_create_metrics=True)
    w = TSDB(port_kv.MemKVStore(wal_path=wal), cfg,
             start_compaction_thread=False)
    series = _series()
    _ingest(w, series)
    w.checkpoint()
    _ingest(w, series, shift=4 * HOUR)
    r = TSDB(port_kv.MemKVStore(wal_path=wal, read_only=True),
             Config(device="cpu"), start_compaction_thread=False)
    try:
        assert w.devwindow is not None and w.tenants is not None
        assert r.devwindow is None and r.tenants is None
        assert r.rollups is None
        wa, ra = _answers(QueryExecutor(w)), _answers(QueryExecutor(r))
        assert {v[2] for v in wa.values()} == {"resident"}
        assert {v[2] for v in ra.values()} == {"raw"}
        _same(ra, wa)
        _ingest(w, series, shift=8 * HOUR)
        assert r.refresh_replica()
        _same(_answers(QueryExecutor(r), 8), _answers(QueryExecutor(w), 8))
        with pytest.raises(ReadOnlyStoreError):
            r.add_batch("m.rep", np.array([BT + 99 * HOUR]),
                        np.array([1.0]), {"host": "h000", "dc": "dc0"})
        snap = open(wal + ".sketches", "rb").read()
        assert r.checkpoint() == 0
        assert open(wal + ".sketches", "rb").read() == snap
    finally:
        r.shutdown()
        w.shutdown()
    assert open(wal + ".sketches", "rb").read() != b""


def test_refresh_replica_needs_a_replica(tmp_path):
    t = TSDB(port_kv.MemKVStore(), Config(device="cpu"),
             start_compaction_thread=False)
    with pytest.raises(ValueError, match="read-only"):
        t.refresh_replica()
    t.shutdown()


def _sketch_answers(ex, metric="m.rep"):
    out = ex.sketch_quantiles(metric, {"dc": "dc1"}, [0.1, 0.5, 0.99])
    return (out["series"], [float(v) for v in out["quantiles"].values()],
            ex.sketch_distinct(metric, "host"),
            ex.sketch_distinct(metric, "dc"))


def test_sketches_reload_after_a_writer_checkpoint_equal_jax(tmp_path):
    """Port and JAX replicas over one port writer: before the writer's
    checkpoint both answer /sketch and /distinct from the snapshot plus
    the memtable they opened on; new series in a WAL suffix are not
    folded; after the checkpoint each rebuild reloads, and both answer
    the writer's numbers (distinct exactly, quantiles rtol 1e-6)."""
    wal = str(tmp_path / "wal")
    w = TSDB(port_kv.MemKVStore(wal_path=wal),
             Config(device="cpu", auto_create_metrics=True,
                    device_window=False),
             start_compaction_thread=False)
    series = _series()
    _ingest(w, series[:12])
    w.checkpoint()
    _ingest(w, series[12:18])
    pr = TSDB(port_kv.MemKVStore(wal_path=wal, read_only=True),
              Config(device="cpu"), start_compaction_thread=False)
    jr = JaxTSDB(jax_kv.MemKVStore(wal_path=wal, read_only=True),
                 JaxConfig(backend="cpu", device_window=False),
                 start_compaction_thread=False)
    try:
        pex, jex, wex = QueryExecutor(pr), JaxExecutor(jr), QueryExecutor(w)
        first = _sketch_answers(pex)
        assert first[2] == 18 and first[2:] == _sketch_answers(jex)[2:]
        _ingest(w, series[18:])
        for t in (pr, jr):
            t.refresh_replica()
        assert _sketch_answers(pex)[2] == 18   # suffix: not folded
        old = weakref.ref(pr.sketches)
        w.checkpoint()
        for t in (pr, jr):
            t.refresh_replica()
        assert pr.store.rebuilds == 1
        want = _sketch_answers(wex)
        for got in (_sketch_answers(pex), _sketch_answers(jex)):
            assert got[0] == want[0] and got[2:] == want[2:] == (24, 3)
            np.testing.assert_allclose(got[1], want[1], rtol=1e-6)
        gc.collect()
        assert old() is None
    finally:
        pr.shutdown()
        jr.shutdown()
        w.shutdown()


def _folders():
    return sum(t.name == "sketch-folder" and t.is_alive()
               for t in threading.enumerate())


def test_sketch_reloads_leak_no_thread_and_no_stacks(tmp_path):
    """Five writer checkpoints, five replica reloads: one folder thread
    lives (the current set's), and every replaced set is freed once
    nothing holds it, including one a query held across the swap."""
    wal = str(tmp_path / "wal")
    w = TSDB(port_kv.MemKVStore(wal_path=wal),
             Config(device="cpu", auto_create_metrics=True,
                    device_window=False),
             start_compaction_thread=False)
    series = _series(n=8, points=12)
    _ingest(w, series)
    w.checkpoint()
    base = _folders()
    r = TSDB(port_kv.MemKVStore(wal_path=wal, read_only=True),
             Config(device="cpu", sketch_flush_points=16),
             start_compaction_thread=False)
    refs = []
    held = r.sketches            # a query holding the set across reloads
    try:
        for i in range(5):
            _ingest(w, series, shift=(i + 1) * 4 * HOUR)
            w.checkpoint()
            # A WAL suffix past the checkpoint: the reload re-folds it,
            # which hands off to the new set's folder thread.
            _ingest(w, series, shift=(i + 1) * 4 * HOUR + 2 * HOUR)
            refs.append(weakref.ref(r.sketches))
            r.refresh_replica()
            assert _folders() - base == 1, i
        assert r.store.rebuilds == 5
        # The held set still answers after its folder thread stopped.
        assert held.quantile([next(iter(held._td_slots))],
                             [0.5]) is not None
        del held
        gc.collect()
        assert all(ref() is None for ref in refs)
        assert r.sketches.series_count() == 8
    finally:
        r.shutdown()
        w.shutdown()


def test_series_hint_is_none_on_a_replica(tmp_path):
    """The JAX executor's rule: a replica's sketch directory lags the
    series a WAL suffix brought, so it never prunes; the writer's does."""
    wal = str(tmp_path / "wal")
    w = TSDB(port_kv.MemKVStore(wal_path=wal),
             Config(device="cpu", auto_create_metrics=True,
                    device_window=False),
             start_compaction_thread=False)
    series = _series(n=6, points=4)
    _ingest(w, series[:3])
    w.checkpoint()
    r = TSDB(port_kv.MemKVStore(wal_path=wal, read_only=True),
             Config(device="cpu"), start_compaction_thread=False)
    jr = JaxTSDB(jax_kv.MemKVStore(wal_path=wal, read_only=True),
                 JaxConfig(backend="cpu", device_window=False),
                 start_compaction_thread=False)
    try:
        _ingest(w, series[3:])
        r.refresh_replica()
        jr.refresh_replica()
        uid = w.metrics.get_id("m.rep")
        assert QueryExecutor(w)._series_hint(uid, {}, []) is not None
        assert QueryExecutor(r)._series_hint(uid, {}, []) is None
        assert JaxExecutor(jr)._series_hint(uid, {}, []) is None
        # The suffix's series are served all the same.
        res = QueryExecutor(r).run(QuerySpec("m.rep", {"host": "h005"}),
                                   BT, BT + 8 * HOUR)
        assert len(res) == 1 and len(res[0].values) == 4
    finally:
        r.shutdown()
        jr.shutdown()
        w.shutdown()


# ---------------------------------------------------------------------------
# Reference caveat 2: a capture of two moments
# ---------------------------------------------------------------------------

def _commit_during_replica_open(tmp_path, kv, monkeypatch):
    """A writer checkpoint frozen after its phase 1 (the WAL rotated to
    <wal>.old) is let commit (the manifest names the new generation,
    <wal>.old is unlinked) right after a replica's open read the
    manifest. Returns what the replica then serves for the key."""
    wal = str(tmp_path / "wal")
    w = port_kv.MemKVStore(wal_path=wal)
    w.put(T, b"k", F, b"q", b"v1")
    w.checkpoint()
    w.put(T, b"k", F, b"q", b"v2")
    go, parked = threading.Event(), threading.Event()
    fire = port_kv._fault

    def freeze(site, *a, **k):
        if site == "kv.checkpoint.freeze":
            parked.set()
            go.wait(10)
        return fire(site, *a, **k)

    monkeypatch.setattr(port_kv, "_fault", freeze)
    ck = threading.Thread(target=w.checkpoint)
    ck.start()
    assert parked.wait(10) and os.path.exists(wal + ".old")
    orig = kv.MemKVStore._generation_paths
    armed = [True]

    def gens(self):
        out = orig(self)
        if self.read_only and armed[0]:
            armed[0] = False
            go.set()
            ck.join(10)     # the checkpoint commits between the reads
        return out

    monkeypatch.setattr(kv.MemKVStore, "_generation_paths", gens)
    r = kv.MemKVStore(wal_path=wal, read_only=True)
    try:
        assert not ck.is_alive() and not os.path.exists(wal + ".old")
        return r.get(T, b"k")[0].value, w.get(T, b"k")[0].value
    finally:
        r.close()
        w.close()


def test_caveat2_open_across_a_checkpoint_commit(tmp_path, monkeypatch):
    """The window of reference caveat 2: the JAX replica serves the old
    generations and the fresh WAL without the frozen records (v1, an
    older value than one it may already have served); the port's open
    sees its capture change and loads again (v2)."""
    assert _commit_during_replica_open(
        tmp_path / "jax", jax_kv, monkeypatch) == (b"v1", b"v2")
    monkeypatch.undo()
    assert _commit_during_replica_open(
        tmp_path / "port", port_kv, monkeypatch) == (b"v2", b"v2")


def test_caveat2_replicas_race_writer_checkpoints(tmp_path):
    """tests/test_concurrency.py::TestReplicaRacesWriter against the
    port: two replicas poll refresh() while the writer ingests and
    checkpoints (rotations, spills, tiered merges at a generation cap of
    3) for 4 s; no replica read may go backwards, and a fresh replica
    sees the final state exactly."""
    wal = str(tmp_path / "wal")
    writer = port_kv.MemKVStore(wal_path=wal)
    writer._MAX_GENERATIONS = 3
    stop = threading.Event()
    versions = {b"k%02d" % i: 0 for i in range(20)}
    errs: list[BaseException] = []

    def write_loop():
        v = 0
        while not stop.is_set():
            v += 1
            for k in versions:
                writer.put(T, k, F, b"q", b"%06d" % v)
                versions[k] = v
            if v % 3 == 0:
                writer.checkpoint()

    def replica_loop():
        replica = port_kv.MemKVStore(wal_path=wal, read_only=True)
        try:
            last_seen = {k: 0 for k in versions}
            while not stop.is_set():
                replica.refresh()
                for k in list(last_seen):
                    cells = replica.get(T, k)
                    if not cells:
                        continue
                    v = int(cells[0].value)
                    assert v >= last_seen[k], \
                        f"{k} went backwards: {last_seen[k]}->{v}"
                    last_seen[k] = v
        finally:
            replica.close()

    def guard(fn):
        def wrapped():
            try:
                fn()
            except BaseException as e:
                errs.append(e)
        return wrapped

    threads = [threading.Thread(target=guard(write_loop))] + [
        threading.Thread(target=guard(replica_loop)) for _ in range(2)]
    for t in threads:
        t.start()
    time.sleep(4)
    stop.set()
    for t in threads:
        t.join(timeout=60)
        assert not t.is_alive(), "deadlock"
    if errs:
        raise errs[0]
    writer.close()
    final = port_kv.MemKVStore(wal_path=wal, read_only=True)
    for k, v in versions.items():
        assert int(final.get(T, k)[0].value) == v, k
    final.close()
