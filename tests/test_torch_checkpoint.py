"""The port's spill tier (opentsdb_tpu_torch/storage/sstable.py and the
checkpoint of storage/kv.py) against the JAX package's.

Contracts:
- the same rows, puts and checkpoints give byte-identical TSST3 files and
  manifests in both packages, the generation cap and the full merge
  included;
- each package opens a store directory the other checkpointed (or left in
  the middle of a checkpoint) and recovers the same rows; /q answers then
  match the JAX package's (opentsdb_tpu/query/executor.py:16-18: grids
  identical, count/min/max exact, float32 sums within rtol 1e-5);
- a directory the port checkpointed gives the JAX package the tenant and
  sketch counts of a run that never saw the port, and the sketch snapshot
  the port saved in its checkpoints is the one the JAX run saved (HLL
  registers and digest weights equal, means within rtol 1e-6);
- throttling applies a batch in part exactly as the JAX store does, and
  the telnet reply is byte-identical.
"""

import asyncio
import os

import numpy as np
import pytest

import opentsdb_tpu.storage.kv as jax_kv
import opentsdb_tpu.storage.sstable as jax_sst
import opentsdb_tpu_torch.storage.kv as port_kv
import opentsdb_tpu_torch.storage.sstable as port_sst
from opentsdb_tpu.core.errors import PleaseThrottleError as JaxThrottle
from opentsdb_tpu.core.tsdb import TSDB as JaxTSDB
from opentsdb_tpu.query.executor import QueryExecutor as JaxExecutor
from opentsdb_tpu.query.executor import QuerySpec as JaxSpec
from opentsdb_tpu.query.grammar import parse_m
from opentsdb_tpu.server.tsd import TSDServer as JaxServer
from opentsdb_tpu.utils.config import Config as JaxConfig
from opentsdb_tpu_torch.core.errors import PleaseThrottleError
from opentsdb_tpu_torch.core.tsdb import TSDB
from opentsdb_tpu_torch.query.executor import QueryExecutor, QuerySpec
from opentsdb_tpu_torch.server.tsd import TSDServer
from opentsdb_tpu_torch.utils.config import Config

T = "tsdb"
F = b"t"
BT = 1356998400  # hour-aligned epoch
START, END = BT, BT + 6 * 3600
PKGS = {"jax": (jax_kv, jax_sst), "port": (port_kv, port_sst)}


def _wal(tmp_path, sub=""):
    d = tmp_path / sub if sub else tmp_path
    d.mkdir(parents=True, exist_ok=True)
    return str(d / "wal")


def _dir_bytes(wal):
    """{file name: bytes} of the generation files and the manifest."""
    d = os.path.dirname(wal)
    return {fn: open(os.path.join(d, fn), "rb").read()
            for fn in sorted(os.listdir(d)) if ".sst" in fn}


def _dump(store, tables=(T, "tsdb-uid")):
    return {tb: list(store.scan_raw(tb, b"", b"")) for tb in tables}


# ---------------------------------------------------------------------------
# Byte identity of the files
# ---------------------------------------------------------------------------

def _seeded_tables(seed=0, n=300):
    """{table: (sorted keys, parallel sorted cell lists)}: data-table keys
    long enough to carry a series identity (bloomed) and short UID-table
    keys (bloomless)."""
    rng = np.random.default_rng(seed)
    out = {}
    for table, klen in ((T, 13), ("tsdb-uid", 4)):
        keys = sorted({rng.integers(0, 256, klen, np.uint8).tobytes()
                       for _ in range(n)})
        cells = []
        for _ in keys:
            quals = sorted({rng.integers(0, 256, 2, np.uint8).tobytes()
                            for _ in range(int(rng.integers(1, 4)))})
            cells.append([(F, q, rng.integers(0, 256, int(
                rng.integers(0, 9)), np.uint8).tobytes()) for q in quals])
        out[table] = (keys, cells)
    return out


def _write(mod, path, how, tables):
    if how == "rows":
        return mod.write_sstable(path, iter(
            (tb, k, c) for tb in sorted(tables)
            for k, c in zip(*tables[tb])))
    if how == "memtable":
        return mod.write_sstable_bulk(path, {
            tb: (keys, {k: {(f, q): v for f, q, v in c}
                        for k, c in zip(keys, cells)})
            for tb, (keys, cells) in tables.items()})
    return mod.write_sstable_bulk(path, tables)


@pytest.mark.parametrize("how", ["rows", "cell_lists", "memtable"])
def test_writers_byte_identical(tmp_path, how):
    tables = _seeded_tables()
    got = {}
    for name, (_, sst) in PKGS.items():
        path = str(tmp_path / f"{name}.sst")
        assert _write(sst, path, how, tables) == sum(
            len(k) for k, _ in tables.values())
        got[name] = open(path, "rb").read()
    assert got["port"] == got["jax"]
    assert got["port"].startswith(b"TSST3")


def _frozen_payload(seed=1):
    """A frozen tier over _seeded_tables: overwrites of spilled keys,
    cell tombstones, row tombstones and frozen-only rows."""
    rng = np.random.default_rng(seed)
    keys = _seeded_tables()[T][0]
    rows, tombs = {}, set()
    for k in rng.choice(len(keys), 40, replace=False).tolist():
        r = rng.random()
        if r < 0.3:
            tombs.add(keys[k])
        elif r < 0.6:
            rows[keys[k]] = {(F, b"\x00\x01"): None,
                             (F, b"\x7f\x7f"): b"new"}
        else:
            rows[keys[k]] = {(F, b"\x00\x02"): b"over"}
    for _ in range(30):
        k = rng.integers(0, 256, 13, np.uint8).tobytes()
        rows.setdefault(k, {(F, b"\x00\x03"): b"fresh"})
    return {T: (rows, tombs, True)}


def test_merge_byte_identical(tmp_path):
    """Two generations (the second overlapping the first) and a frozen
    tier with tombstones, through both copy-merges."""
    g1, g2 = _seeded_tables(0), _seeded_tables(0, n=120)
    got = {}
    for name, (_, sst) in PKGS.items():
        paths = [str(tmp_path / f"{name}.g{i}") for i in (1, 2)]
        _write(sst, paths[0], "rows", g1)
        _write(sst, paths[1], "rows", g2)
        gens = [sst.SSTable(p) for p in paths]
        out = str(tmp_path / f"{name}.merged")
        n = sst.merge_sstables(out, gens, _frozen_payload())
        for g in gens:
            g.close()
        got[name] = (n, open(out, "rb").read())
    assert got["port"] == got["jax"]


def _churn(store, rnd, rng, deletes):
    for _ in range(25):
        k = b"\x00\x00\x01" + (BT + 3600 * int(rng.integers(0, 12))
                               ).to_bytes(4, "big") + bytes(
            [0, 0, 1, 0, 0, int(rng.integers(1, 6))])
        q = int(rng.integers(0, 4)).to_bytes(2, "big")
        if deletes and rng.random() < 0.15:
            store.delete(T, k, F, [q])
        elif deletes and rng.random() < 0.05:
            store.delete_row(T, k)
        else:
            store.put(T, k, F, q, b"v%d" % rnd)
    store.put("tsdb-uid", b"r%d" % rnd, b"id", b"metrics", b"x")


@pytest.mark.parametrize("deletes,cap", [(False, None), (True, None),
                                         (False, 3)])
def test_checkpoint_sequence_byte_identical(tmp_path, deletes, cap):
    """The same puts (and deletes, which force full merges) and
    checkpoints, past the generation cap: after every checkpoint both
    directories hold the same manifest and generation bytes."""
    stores = {name: kv.MemKVStore(wal_path=_wal(tmp_path, name),
                                  max_generations=cap)
              for name, (kv, _) in PKGS.items()}
    rngs = {name: np.random.default_rng(4) for name in PKGS}
    for rnd in range(12):
        for name, s in stores.items():
            _churn(s, rnd, rngs[name], deletes)
            s.checkpoint()
        jax_files = _dir_bytes(stores["jax"]._wal_path)
        assert _dir_bytes(stores["port"]._wal_path) == jax_files
        assert "wal.sst.manifest" in jax_files
    assert len(stores["port"]._ssts) < (cap or 8)
    assert _dump(stores["port"]) == _dump(stores["jax"])
    for s in stores.values():
        s.close()


@pytest.mark.parametrize("fmt", [2, 3])
def test_reader_matches_jax_reader(tmp_path, monkeypatch, fmt):
    """TSST2 and TSST3 files the JAX package wrote read the same through
    both readers: rows, key ranges, bounds and bloom probes."""
    monkeypatch.setattr(jax_sst, "WRITE_FORMAT", fmt)
    tables = _seeded_tables(2)
    path = str(tmp_path / "x.sst")
    _write(jax_sst, path, "rows", tables)
    j, p = jax_sst.SSTable(path), port_sst.SSTable(path)
    try:
        assert p.format == j.format == fmt
        for tb, (keys, cells) in tables.items():
            assert list(p.iter_rows(tb)) == list(j.iter_rows(tb)) \
                == list(zip(keys, cells))
            lo, hi = keys[10], keys[-10]
            assert p.scan_keys(tb, lo, hi) == j.scan_keys(tb, lo, hi)
            assert list(p.iter_rows_range(tb, lo, hi, skip={keys[20]})) \
                == list(j.iter_rows_range(tb, lo, hi, skip={keys[20]}))
            assert p.key_bounds(tb) == j.key_bounds(tb)
            assert p.get(tb, keys[5]) == j.get(tb, keys[5])
            assert p.get(tb, b"\xff" * 14) is j.get(tb, b"\xff" * 14)
            h = np.asarray([port_sst.series_hash(k[:3] + k[7:])
                            for k in keys[:50]] + [12345], np.uint64)
            assert p.bloom_may_contain(tb, h) == j.bloom_may_contain(tb, h)
            for x in h.tolist():
                assert p.bloom_may_contain_hash(tb, x) \
                    == j.bloom_may_contain_hash(tb, x)
            assert (p.bloom_bits(tb) is None) == (j.bloom_bits(tb) is None)
            for a, b in zip(p.record_extents(tb), j.record_extents(tb)):
                np.testing.assert_array_equal(a, b)
        # Bloomed only where keys carry a series identity, and only in v3.
        assert (p.bloom_bits(T) is not None) == (fmt == 3)
        assert p.bloom_bits("tsdb-uid") is None
    finally:
        j.close()
        p.close()


# ---------------------------------------------------------------------------
# Crash recovery: the JAX package's tests/test_checkpoint.py cases, run
# against both stores (each asserts the same rows).
# ---------------------------------------------------------------------------

@pytest.fixture(params=list(PKGS))
def kv(request):
    return PKGS[request.param][0]


def _cell(kv, key, q, v):
    return [kv.Cell(key, F, q, v)]


def test_crash_between_rename_and_truncate(tmp_path, kv):
    """Replaying a stale <wal>.old over the new generation is
    idempotent."""
    w = _wal(tmp_path)
    store = kv.MemKVStore(wal_path=w)
    store.put(T, b"k", F, b"q", b"v")
    store.flush()
    wal_bytes = open(w, "rb").read()
    store.checkpoint()
    store.close()
    with open(w + ".old", "wb") as f:
        f.write(wal_bytes)
    again = kv.MemKVStore(wal_path=w)
    assert again.get(T, b"k") == _cell(kv, b"k", b"q", b"v")
    assert again.row_count(T) == 1
    again.checkpoint()
    assert not os.path.exists(w + ".old")
    assert again.get(T, b"k") == _cell(kv, b"k", b"q", b"v")
    again.close()


def test_crash_before_rename_keeps_old_wal_live(tmp_path, kv):
    """Crash mid-spill: .old + WAL + the old generation reconstruct every
    write, including one that lands during the recovered checkpoint."""
    w = _wal(tmp_path)
    store = kv.MemKVStore(wal_path=w)
    store.put(T, b"pre", F, b"q", b"v1")
    store.checkpoint()
    store.put(T, b"frozenrow", F, b"q", b"v2")
    store.close()
    # Phase 1 only: the WAL rotated, no new generation renamed in.
    os.replace(w, w + ".old")
    open(w, "wb").close()
    again = kv.MemKVStore(wal_path=w)
    assert again.get(T, b"pre")[0].value == b"v1"
    assert again.get(T, b"frozenrow")[0].value == b"v2"
    again.put(T, b"during", F, b"q", b"v3")
    again.checkpoint()
    again.close()
    final = kv.MemKVStore(wal_path=w)
    assert final.row_count(T) == 3
    assert [k for k, _ in final.scan_raw(T, b"", b"")] == [
        b"during", b"frozenrow", b"pre"]
    final.close()


def test_torn_old_wal_tail_truncated_on_open(tmp_path, kv):
    w = _wal(tmp_path)
    store = kv.MemKVStore(wal_path=w)
    store.put(T, b"k", F, b"q", b"v")
    store.close()
    os.replace(w, w + ".old")
    with open(w + ".old", "ab") as f:
        f.write(b"\x01\x00\x00")  # torn record header
    open(w, "wb").close()
    again = kv.MemKVStore(wal_path=w)
    assert again.get(T, b"k")[0].value == b"v"
    # The torn bytes are gone, so later appends stay reachable.
    assert not open(w + ".old", "rb").read().endswith(b"\x01\x00\x00")
    again.put(T, b"k2", F, b"q", b"v2")
    again.close()
    final = kv.MemKVStore(wal_path=w)
    assert final.row_count(T) == 2
    final.close()


def test_failed_spill_thaws_frozen_tier(tmp_path, monkeypatch, kv):
    """A failed spill (disk full) must not wedge checkpointing: the
    frozen tier folds back under the live memtable and a retry works.
    The module-level writers are the seam the failure is injected at."""
    w = _wal(tmp_path)
    store = kv.MemKVStore(wal_path=w)
    store.put(T, b"a", F, b"q", b"v1")
    store.checkpoint()
    store.put(T, b"b", F, b"q", b"v2")

    def boom(path, *a, **k):
        raise OSError("disk full")

    monkeypatch.setattr(kv, "merge_sstables", boom)
    monkeypatch.setattr(kv, "write_sstable_bulk", boom)
    with pytest.raises(OSError):
        store.checkpoint()
    assert store._frozen is None
    store.put(T, b"c", F, b"q", b"v3")
    assert store.row_count(T) == 3
    assert store.get(T, b"b")[0].value == b"v2"
    monkeypatch.undo()
    assert store.checkpoint() == 2      # b and c; a is in generation 1
    assert not os.path.exists(w + ".old")
    store.close()
    again = kv.MemKVStore(wal_path=w)
    assert again.row_count(T) == 3
    again.close()


def test_manifest_ignores_and_cleans_stray_generations(tmp_path, kv):
    """A generation file the manifest does not name (a crash between a
    merge's manifest write and its unlinks) is never loaded, and is
    deleted at open."""
    w = _wal(tmp_path)
    store = kv.MemKVStore(wal_path=w)
    store.put(T, b"row", F, b"q", b"v")
    store.checkpoint()
    live = [s.path for s in store._ssts]
    store.close()
    stray = w + ".sst.g99"
    port_sst.write_sstable(stray, iter([(T, b"zombie",
                                         [(F, b"q", b"boo")])]))
    again = kv.MemKVStore(wal_path=w)
    assert [s.path for s in again._ssts] == live
    assert again.get(T, b"zombie") == []
    assert not os.path.exists(stray)
    again.close()


def test_delete_forces_full_merge_and_never_resurrects(tmp_path, kv):
    w = _wal(tmp_path)
    store = kv.MemKVStore(wal_path=w)
    store.put(T, b"keep", F, b"q", b"v")
    store.put(T, b"gone", F, b"q", b"v")
    store.put(T, b"row", F, b"q", b"v")
    store.checkpoint()
    store.put(T, b"fresh", F, b"q", b"v")
    store.delete(T, b"gone", F, [b"q"])
    store.delete_row(T, b"row")
    assert store.get(T, b"gone") == [] and store.get(T, b"row") == []
    store.checkpoint()              # tombstones -> full merge
    assert len(store._ssts) == 1
    store.close()
    again = kv.MemKVStore(wal_path=w)
    assert again.get(T, b"gone") == [] and again.get(T, b"row") == []
    assert again.get(T, b"keep")[0].value == b"v"
    assert again.row_count(T) == 2
    again.close()


def test_size_tiered_partial_merge_keeps_big_generation(
        tmp_path, monkeypatch, kv):
    """At the cap with no tombstones only the newest size-comparable
    suffix merges: the large first generation is never rewritten."""
    monkeypatch.setattr(kv.MemKVStore, "_MAX_GENERATIONS", 4)
    w = _wal(tmp_path)
    store = kv.MemKVStore(wal_path=w)
    big_val = b"x" * 100
    for i in range(1000):
        store.put(T, b"big%04d" % i, F, b"q", big_val)
    store.checkpoint()
    big_path = store._ssts[0].path
    big_ino = os.stat(big_path).st_ino
    for r in range(8):
        store.put(T, b"small%d" % r, F, b"q", b"v%d" % r)
        store.checkpoint()
        assert len(store._ssts) < 4
    assert store._ssts[0].path == big_path
    assert os.stat(big_path).st_ino == big_ino
    store.close()
    again = kv.MemKVStore(wal_path=w)
    assert again.row_count(T) == 1008
    assert again.get(T, b"big0500")[0].value == big_val
    assert again.get(T, b"small7")[0].value == b"v7"
    again.close()


def test_churn_to_empty_memtable_still_truncates_wal(tmp_path, kv):
    w = _wal(tmp_path)
    store = kv.MemKVStore(wal_path=w)
    for i in range(20):
        store.put(T, b"tmp%d" % i, F, b"q", b"v")
        store.delete(T, b"tmp%d" % i, F, [b"q"])
    store.flush()
    assert os.path.getsize(w) > 0
    assert store.checkpoint() == 0
    assert os.path.getsize(w) == 0
    assert not os.path.exists(w + ".old")
    store.close()
    again = kv.MemKVStore(wal_path=w)
    assert again.row_count(T) == 0
    again.close()


def test_reads_merge_all_tiers_mid_checkpoint(tmp_path, kv):
    """With a spill in flight (frozen tier present), reads and scans see
    the generations, the frozen tier and the live memtable, and deletes
    tombstone over the lower tiers."""
    w = _wal(tmp_path)
    store = kv.MemKVStore(wal_path=w)
    store.put(T, b"sstrow", F, b"q", b"gen1")
    store.checkpoint()
    store.put(T, b"frozenrow", F, b"q", b"mid")
    store.put(T, b"sstrow", F, b"q2", b"mid2")
    with store._lock:
        store._frozen = store._tables
        store._tables = {n: type(t)() for n, t in store._frozen.items()}
    store.put(T, b"fresh", F, b"q", b"new")
    assert store.get(T, b"sstrow") == [kv.Cell(b"sstrow", F, b"q", b"gen1"),
                                       kv.Cell(b"sstrow", F, b"q2", b"mid2")]
    assert [k for k, _ in store.scan_raw(T, b"", b"", chunk=2)] == [
        b"fresh", b"frozenrow", b"sstrow"]
    store.delete(T, b"frozenrow", F, [b"q"])
    store.delete_row(T, b"sstrow")
    assert store.get(T, b"frozenrow") == [] == store.get(T, b"sstrow")
    assert list(store.scan_raw(T, b"", b"")) == [(b"fresh",
                                                   [(b"q", b"new")])]
    with store._lock:
        store._thaw_frozen_locked()
    store.checkpoint()
    store.close()
    again = kv.MemKVStore(wal_path=w)
    assert list(again.scan_raw(T, b"", b"")) == [(b"fresh",
                                                   [(b"q", b"new")])]
    again.close()


# ---------------------------------------------------------------------------
# Throttling
# ---------------------------------------------------------------------------

def _key(base, host):
    return b"\x00\x00\x01" + (BT + 3600 * base).to_bytes(4, "big") \
        + bytes([0, 0, 1, 0, 0, host])


@pytest.mark.parametrize("case", ["memtable", "spilled", "duplicates"])
def test_partial_batch_matches_jax(tmp_path, case):
    """A batch that crosses throttle_rows applies its prefix in both
    packages alike: the same partial_existed, the same rows and the same
    WAL bytes; updates of existing rows keep flowing."""
    out = {}
    for name, (kv, _) in PKGS.items():
        w = _wal(tmp_path, name)
        store = kv.MemKVStore(wal_path=w, throttle_rows=6)
        for h in (1, 2):
            store.put(T, _key(0, h), F, b"\x00\x01", b"a")
        if case == "spilled":
            store.checkpoint()
            store.put(T, _key(1, 1), F, b"\x00\x01", b"b")
        keys = [_key(0, 1), _key(1, 1), _key(2, 1), _key(2, 2),
                _key(2, 2), _key(3, 1), _key(3, 2), _key(4, 1), _key(4, 2),
                _key(5, 1)]
        if case == "duplicates":
            keys = keys[:3] + keys[:3] + keys[3:]
        quals = [b"\x00%c" % (16 * (i + 1)) for i in range(len(keys))]
        with pytest.raises((JaxThrottle, PleaseThrottleError)) as ei:
            store.put_many_columnar(T, F, b"".join(keys), len(keys[0]),
                                    quals, [b"x"] * len(keys))
        # Updating an existing row is never throttled.
        store.put(T, _key(0, 1), F, b"\x00\x02", b"u")
        with pytest.raises((JaxThrottle, PleaseThrottleError)):
            store.put(T, _key(9, 9), F, b"\x00\x01", b"n")
        store.close()
        again = kv.MemKVStore(wal_path=w)
        out[name] = (ei.value.partial_existed, str(ei.value),
                     open(w, "rb").read(), _dump(again))
        again.close()
    assert out["port"] == out["jax"]
    assert 0 < len(out["port"][0]) < 10


def test_throttled_batch_invalidates_window_and_queues_compactions():
    """TSDB.add_batch under a throttle: the applied rows are queued for
    compaction exactly as the JAX TSDB queues them, the error propagates,
    and the metric's window stops answering (the scan path does)."""
    rng = np.random.default_rng(3)
    # Even seconds over two hours, then odd ones over six: the second
    # batch hits the first one's rows without duplicating a point.
    ts1 = BT + 2 * np.sort(rng.choice(3600, 50, replace=False))
    ts2 = BT + 1 + 2 * np.sort(rng.choice(3 * 3600, 200, replace=False))
    queued = {}
    for name in ("jax", "port"):
        if name == "jax":
            t = JaxTSDB(jax_kv.MemKVStore(throttle_rows=4),
                        JaxConfig(auto_create_metrics=True,
                                  enable_sketches=False),
                        start_compaction_thread=False)
        else:
            t = TSDB(port_kv.MemKVStore(throttle_rows=4),
                     Config(auto_create_metrics=True, device="cpu"),
                     start_compaction_thread=False)
        t.add_batch("m", ts1, rng.normal(size=50), {"host": "a"})
        with pytest.raises((JaxThrottle, PleaseThrottleError)):
            t.add_batch("m", ts2, np.arange(200.0), {"host": "a"})
        queued[name] = sorted(t.compactionq._queue)
        if name == "port":
            spec = QuerySpec("m", {}, "sum", downsample=(600, "avg"))
            got, plan, _ = QueryExecutor(t).run_with_plan(spec, START, END)
            assert plan == "raw"
            t.devwindow = None
            want, plan, _ = QueryExecutor(t).run_with_plan(spec, START, END)
            assert plan == "raw"
            for a, b in zip(got, want):
                np.testing.assert_array_equal(a.values, b.values)
        t.shutdown()
    assert queued["port"] == queued["jax"] and len(queued["port"]) == 2


def _serve_telnet(server, lines):
    async def main():
        await server.start()
        try:
            reader, writer = await asyncio.open_connection("127.0.0.1",
                                                           server.port)
            out = b""
            for chunk in lines:
                writer.write(chunk)
                await writer.drain()
                await asyncio.sleep(0.2)
            writer.write(b"exit\n")
            await writer.drain()
            out = await asyncio.wait_for(reader.read(), 30)
            writer.close()
            return out
        finally:
            server._pool.shutdown(wait=False)
            server._server.close()
            await server._server.wait_closed()
    return asyncio.run(main())


def test_telnet_throttle_reply_byte_identical():
    """A throttled single put line and a throttled pipelined burst get
    the same reply bytes from both daemons."""
    single = [f"put m {BT + 3600 * h} 1 host=a\n".encode()
              for h in range(4)]
    burst = "".join(f"put m {BT + 3600 * h + 1} 2 host=b\n"
                    for h in range(6)).encode()
    said = {}
    for name in ("jax", "port"):
        if name == "jax":
            tsdb = JaxTSDB(jax_kv.MemKVStore(throttle_rows=3),
                           JaxConfig(auto_create_metrics=True,
                                     enable_sketches=False,
                                     device_window=False, port=0,
                                     bind="127.0.0.1"),
                           start_compaction_thread=False)
            server = JaxServer(tsdb)
        else:
            tsdb = TSDB(port_kv.MemKVStore(throttle_rows=3),
                        Config(auto_create_metrics=True, device="cpu",
                               port=0, bind="127.0.0.1"),
                        start_compaction_thread=False)
            server = TSDServer(tsdb)
        try:
            said[name] = _serve_telnet(server, single + [burst])
        finally:
            tsdb.shutdown()
    assert said["port"] == said["jax"]
    assert said["port"].startswith(
        b"put: Please throttle writes: table 'tsdb' holds >= 3 rows\n")
    assert said["port"].count(b"\n") == 2


# ---------------------------------------------------------------------------
# Crossing store directories between the packages
# ---------------------------------------------------------------------------

def _parts(seed=5):
    """Four ingest parts of 12 series (sys.cpu.user and the integer
    counter net.bytes on six hosts in two dcs) over 6 hours. Part 0 holds
    the first two hours of sys.cpu.user on h0-h2; host h5 first appears
    in part 2, the rest in part 1. Time cuts fall mid-hour, so rows
    straddle checkpoints and compaction rewrites them across tiers."""
    rng = np.random.default_rng(seed)
    cuts = BT + np.array([7200, 9000, 16200])
    parts = [[], [], [], []]
    for h in range(6):
        tags = {"host": f"h{h}", "dc": "east" if h % 2 else "west"}
        for metric, n in (("sys.cpu.user", 300), ("net.bytes", 80)):
            ts = BT + np.sort(rng.choice(6 * 3600, n, replace=False))
            vals = (rng.normal(50, 10, n) if metric == "sys.cpu.user"
                    else np.cumsum(rng.integers(0, 1000, n)))
            first = (0 if metric == "sys.cpu.user" and h < 3
                     else 2 if h == 5 else 1)
            part = np.maximum(np.searchsorted(cuts, ts, "right"), first)
            for i in range(4):
                m = part == i
                if m.any():
                    parts[i].append((metric, tags, ts[m], vals[m]))
    return parts


def _ingest(tsdb, part):
    for metric, tags, ts, vals in part:
        tsdb.add_batch(metric, ts, vals, tags)


QUERIES = ["sum:1h-avg:sys.cpu.user",
           "max:10m-max:sys.cpu.user{host=*}",
           "dev:30m-avg:sys.cpu.user{dc=*}",
           "p95:1h-avg:sys.cpu.user{dc=*}",
           "sum:rate:1h-avg:net.bytes"]
RAW = "sum:sys.cpu.user{dc=east}"


def _specs(expr):
    p = parse_m(expr)
    fields = dict(metric=p.metric, tags=p.tags, aggregator=p.aggregator,
                  rate=p.rate, downsample=p.downsample, counter=p.counter,
                  counter_max=p.counter_max, reset_value=p.reset_value)
    return JaxSpec(**fields), QuerySpec(**fields)


def _assert_same(want, got, expr):
    assert got and len(got) == len(want), expr
    p = parse_m(expr)
    exact = p.aggregator in ("min", "max") and not p.rate \
        and p.downsample is not None
    for w, g in zip(want, got):
        assert g.tags == w.tags and g.aggregated_tags == w.aggregated_tags
        np.testing.assert_array_equal(g.timestamps, w.timestamps)
        if exact:
            np.testing.assert_array_equal(g.values, w.values)
        else:
            np.testing.assert_allclose(g.values, w.values, rtol=1e-5,
                                       atol=1e-6)


def _jax_answers(jt):
    ex = JaxExecutor(jt, backend="tpu")
    return {e: ex.run(_specs(e)[0], START, END) for e in QUERIES + [RAW]}


def _jax_tsdb(wal, **kw):
    return JaxTSDB(jax_kv.MemKVStore(wal_path=wal),
                   JaxConfig(auto_create_metrics=True, device_window=False,
                             **kw),
                   start_compaction_thread=False)


def _port_tsdb(wal, **kw):
    return TSDB(port_kv.MemKVStore(wal_path=wal),
                Config(auto_create_metrics=True, device="cpu", **kw),
                start_compaction_thread=False)


@pytest.mark.parametrize("sketches", [True, False])
def test_port_serves_jax_checkpointed_store(tmp_path, sketches):
    """A JAX TSDB ingests, checkpoints and shuts down (with sketches on,
    its default, the shutdown checkpoints too; off, the last part stays in
    the WAL). The port opens the directory, warms its window from the
    generations and the WAL, and answers like the JAX TSDB did, from the
    window and from the scan."""
    w = _wal(tmp_path)
    jt = _jax_tsdb(w, enable_sketches=sketches)
    parts = _parts()
    for i, part in enumerate(parts):
        _ingest(jt, part)
        if i < 2:
            jt.checkpoint()
    jt.compactionq.flush()
    want = _jax_answers(jt)
    jt.shutdown()
    files = set(os.listdir(tmp_path))
    assert {"wal.sst.manifest", "wal.tenants.json"} <= files
    assert any(fn.startswith("wal.sst.g") for fn in files)
    assert ("wal.sketches" in files) == sketches
    assert (os.path.getsize(w) == 0) == sketches

    pt = _port_tsdb(w)
    try:
        assert pt.devwindow.appended_points == sum(
            len(ts) for part in parts for _, _, ts, _ in part)
        ex = QueryExecutor(pt)
        for expr in QUERIES:
            got, plan, _ = ex.run_with_plan(_specs(expr)[1], START, END)
            assert plan == "resident", expr
            _assert_same(want[expr], got, expr)
        dw, pt.devwindow = pt.devwindow, None
        for expr in QUERIES + [RAW]:
            got, plan, _ = ex.run_with_plan(_specs(expr)[1], START, END)
            assert plan == "raw", expr
            _assert_same(want[expr], got, expr)
        pt.devwindow = dw
    finally:
        pt.shutdown()
    # The port keeps sketches (its default): its checkpoints save the
    # snapshot in place of removing it.
    assert os.path.exists(w + ".sketches")


def test_jax_serves_port_checkpointed_store(tmp_path):
    """The JAX package ingests part 0 and shuts down (its snapshots cover
    part 0); the port ingests the rest with two checkpoints and shuts
    down. The JAX package then opens the directory and answers, counts
    tenant series and estimates distinct tag values exactly as a JAX run
    that never saw the port: no snapshot under-covers the spilled tier.
    The same puts and checkpoints leave byte-identical generations."""
    parts = _parts()
    wa, wb = _wal(tmp_path, "a"), _wal(tmp_path, "b")
    jt = _jax_tsdb(wa)
    _ingest(jt, parts[0])
    jt.shutdown()
    pt = _port_tsdb(wa)
    for i, part in enumerate(parts[1:]):
        _ingest(pt, part)
        if i < 2:
            pt.checkpoint()
    pt.shutdown()
    # The reference: the same puts and checkpoints, all through JAX.
    ref = _jax_tsdb(wb)
    _ingest(ref, parts[0])
    ref.checkpoint()
    for i, part in enumerate(parts[1:]):
        _ingest(ref, part)
        if i < 2:
            ref.checkpoint()
    ref.shutdown()
    assert _dir_bytes(wa) == _dir_bytes(wb)
    snaps = [np.load(w + ".sketches", allow_pickle=True) for w in (wa, wb)]
    for key in ("td_keys", "hll_metric", "hll_tagk", "meta", "hll_regs",
                "td_weights"):
        np.testing.assert_array_equal(snaps[0][key], snaps[1][key])
    # Means: float32 sums in the same order; asin may differ in the last
    # ulp, which moves no entry here (the weights are equal).
    np.testing.assert_allclose(snaps[0]["td_means"], snaps[1]["td_means"],
                               rtol=1e-6)

    out = {}
    for name, w in (("port", wa), ("ref", wb)):
        jt = _jax_tsdb(w)
        try:
            info = jt.tenants.snapshot_info()
            uid = jt.metrics.get_id("sys.cpu.user")
            out[name] = (
                _jax_answers(jt),
                info["total_series"], info["tracked_series"],
                {t: e["series"] for t, e in info["tenants"].items()},
                jt.sketches.series_count(),
                [jt.sketches.distinct(uid, jt.tagk.get_id(k))
                 for k in ("host", "dc")])
        finally:
            jt.shutdown()
    (got, *counts), (want, *want_counts) = out["port"], out["ref"]
    assert counts == want_counts
    assert counts[:4] == [12, 12, {"default": 12}, 12]
    assert counts[4] == [6, 2]
    for expr in QUERIES + [RAW]:
        assert len(got[expr]) == len(want[expr])
        for g, r in zip(got[expr], want[expr]):
            assert g.tags == r.tags
            np.testing.assert_array_equal(g.timestamps, r.timestamps)
            np.testing.assert_array_equal(g.values, r.values)


# ---------------------------------------------------------------------------
# What the port cannot read or keep yet is refused, not half-done
# ---------------------------------------------------------------------------

def test_refuses_sharded_store(tmp_path):
    """A sharded store's root handed to MemKVStore is refused with an
    error naming the class that opens it; ShardedKVStore reads it."""
    from opentsdb_tpu.storage.sharded import ShardedKVStore
    from opentsdb_tpu_torch.storage.sharded import \
        ShardedKVStore as PortSharded
    d = str(tmp_path / "store")
    s = ShardedKVStore(d, shards=2)
    s.put(T, _key(0, 1), F, b"\x00\x01", b"v")
    s.close()
    with pytest.raises(RuntimeError, match="ShardedKVStore"):
        port_kv.MemKVStore(wal_path=d)
    p = PortSharded(d)
    try:
        assert [c.value for c in p.get(T, _key(0, 1))] == [b"v"]
    finally:
        p.close()


def test_refuses_wal_epoch_header(tmp_path):
    w = _wal(tmp_path)
    s = jax_kv.MemKVStore(wal_path=w, writer_epoch=1)
    s.put(T, _key(0, 1), F, b"\x00\x01", b"v")
    s.close()
    # Refused again, not "locked": the failed open released its lock.
    for _ in range(2):
        with pytest.raises(RuntimeError, match="item 10"):
            port_kv.MemKVStore(wal_path=w)


def test_refuses_store_missing_a_named_generation(tmp_path):
    """A generation the manifest names but the disk lacks (external
    damage: checkpoints unlink a generation only once the manifest no
    longer names it) fails the open instead of serving the rest."""
    w = _wal(tmp_path)
    s = jax_kv.MemKVStore(wal_path=w)
    for i in range(2):
        s.put(T, _key(i, 1), F, b"\x00\x01", b"v")
        s.checkpoint()
    s.close()
    os.unlink(w + ".sst.g1")
    with pytest.raises(FileNotFoundError):
        port_kv.MemKVStore(wal_path=w)


def test_refuses_to_checkpoint_beside_a_rollup_tier(tmp_path):
    """A JAX rollup tier opens and reads, but the port will not spill
    under it: the tier's summaries would miss the spilled rows."""
    w = _wal(tmp_path)
    jt = _jax_tsdb(w, enable_rollups=True, enable_sketches=False)
    _ingest(jt, _parts()[0])
    jt.shutdown()
    assert any(fn.startswith("wal.rollup") for fn in os.listdir(tmp_path))
    pt = _port_tsdb(w, device_window=False)
    try:
        assert pt.store.row_count(T) > 0
        _ingest(pt, _parts()[1][:1])
        with pytest.raises(RuntimeError, match="item 6"):
            pt.checkpoint()
        assert pt.store._frozen is None
    finally:
        with pytest.raises(RuntimeError, match="item 6"):
            pt.shutdown()
    again = _port_tsdb(w, device_window=False)
    try:
        assert again.store.row_count(T) > 0
    finally:
        again.store.close()


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_sketch_snapshot_crosses(tmp_path, writer):
    """One package (rollups off, sketches on: the defaults) ingests part
    0, checkpoints (saving <wal>.sketches before the spill), ingests part
    1 and crashes. Each package then opens its own copy of the directory:
    it loads the snapshot and re-folds the WAL-replayed memtable on top.
    Rows the memtable does not touch are the snapshot's, bit for bit, in
    both; the slot maps and HLL registers of the two recovered states are
    identical, each digest's total weight equal, and their quantiles
    within the t-digest tolerance (rtol 0.02)."""
    import shutil
    parts = _parts()
    # After the checkpoint, only hosts h0 and h1 write (and h5 first
    # appears in part 2, so its series are new to the snapshot).
    tail = [x for x in parts[1] + parts[2]
            if x[1]["host"] in ("h0", "h1", "h5")]
    w = _wal(tmp_path, "w")
    db = _jax_tsdb(w) if writer == "jax" else _port_tsdb(w)
    _ingest(db, parts[0] + [x for x in parts[1]
                            if x[1]["host"] not in ("h0", "h1")])
    assert db.checkpoint() > 0
    _ingest(db, tail)
    db.store.flush()
    if writer == "jax":
        db.store._simulate_crash()
    else:
        db.store.close()
    snap = np.load(w + ".sketches", allow_pickle=True)
    copies = {}
    for name in ("jax", "port"):
        d = tmp_path / name
        shutil.copytree(tmp_path / "w", d)
        copies[name] = str(d / "wal")
    jt = _jax_tsdb(copies["jax"])
    pt = _port_tsdb(copies["port"])
    try:
        js, ps = jt.sketches, pt.sketches
        js.flush()
        ps.flush()
        assert ps._td_slots == js._td_slots
        assert ps._hll_slots == js._hll_slots
        np.testing.assert_array_equal(ps._hll_regs.numpy(),
                                      np.asarray(js._hll_regs))
        pw = ps._td_weights.numpy()
        np.testing.assert_array_equal(pw.sum(1),
                                      np.asarray(js._td_weights).sum(1))
        refolded = {pt.metrics.get_id(m) + b"".join(
            k + v for k, v in pt.resolve_tags(tags, create=False))
            for m, tags, _, _ in tail}
        kept = [s for k, s in ps._td_slots.items() if k not in refolded]
        assert kept and len(kept) < len(ps._td_slots)
        np.testing.assert_array_equal(pw[kept], snap["td_weights"][kept])
        np.testing.assert_array_equal(ps._td_means.numpy()[kept],
                                      snap["td_means"][kept])
        keys = ps.series_keys()
        np.testing.assert_allclose(
            ps.quantile(keys, [0.05, 0.5, 0.95]),
            np.asarray(js.quantile(keys, [0.05, 0.5, 0.95])), rtol=0.02)
        for tagk in ("host", "dc"):
            uid = (pt.metrics.get_id("sys.cpu.user"),
                   pt.tagk.get_id(tagk))
            assert ps.distinct(*uid) == js.distinct(*uid)
    finally:
        jt.shutdown()
        pt.shutdown()
