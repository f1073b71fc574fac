"""The port's series-sharded store (opentsdb_tpu_torch/storage/sharded.py)
against the JAX package's (opentsdb_tpu/storage/sharded.py).

The cases of tests/test_sharded.py that need no replica, run on the port,
and checks across the packages on seeded numpy inputs:
- the routing is the JAX package's, key for key;
- the same ingest and checkpoints give byte-identical SHARDS.json,
  per-shard WALs, generations and manifests, and root TENANTS.json;
- each package opens the other's 4-shard directory and reads the same
  rows, dirty sets and chunk_state;
- /q answers at shards=1 and shards=4 are the same (grids bit-identical,
  values exact: one summation order), warm fragment-cache answers over
  four shards equal cold ones, and both equal the JAX package's at its
  contracts (opentsdb_tpu/query/executor.py:16-18).
"""

import json
import os
import shutil
import struct

import numpy as np
import pytest

import opentsdb_tpu.storage.kv as jax_kv
import opentsdb_tpu.storage.sharded as jax_sharded
import opentsdb_tpu_torch.storage.kv as port_kv
import opentsdb_tpu_torch.storage.sharded as port_sharded
from opentsdb_tpu.core.tsdb import TSDB as JaxTSDB
from opentsdb_tpu.query.executor import QueryExecutor as JaxExecutor
from opentsdb_tpu.query.executor import QuerySpec as JaxSpec
from opentsdb_tpu.utils.config import Config as JaxConfig
from opentsdb_tpu_torch.core.errors import PleaseThrottleError
from opentsdb_tpu_torch.core.tsdb import TSDB
from opentsdb_tpu_torch.query.executor import QueryExecutor, QuerySpec
from opentsdb_tpu_torch.storage.kv import Cell, MemKVStore
from opentsdb_tpu_torch.storage.sharded import ShardedKVStore
from opentsdb_tpu_torch.tools.cli import open_store
from opentsdb_tpu_torch.utils.config import Config

T = "tsdb"
F = b"t"
BT = 1356998400


def rowkey(tag: int, hour: int = 0, metric: int = 1) -> bytes:
    """3B metric + 4B base time + one 6B (tagk, tagv) pair."""
    return (metric.to_bytes(3, "big")
            + struct.pack(">I", BT + hour * 3600)
            + b"\x00\x00\x01" + tag.to_bytes(3, "big"))


# ---------------------------------------------------------------------------
# Routing
# ---------------------------------------------------------------------------

def test_series_hours_colocate_and_series_spread():
    s = ShardedKVStore(None, shards=4)
    for tag in range(32):
        shards = {s._route(T, rowkey(tag, hour)) for hour in range(8)}
        assert len(shards) == 1, "one series straddled shards"
    assert len({s._route(T, rowkey(tag)) for tag in range(32)}) > 1


@pytest.mark.parametrize("n", [1, 2, 3, 4, 8])
def test_routing_equals_the_jax_package(n):
    """The same shard for every key: data-table keys of several lengths
    (series bytes only), short keys and UID-table keys (whole key)."""
    rng = np.random.default_rng(n)
    keys = [rng.integers(0, 256, int(rng.integers(1, 32)),
                         np.uint8).tobytes() for _ in range(2000)]
    keys += [rowkey(t, h) for t in range(64) for h in range(3)]
    port = ShardedKVStore(None, shards=n)
    jax = jax_sharded.ShardedKVStore(None, shards=n)
    for table in (T, "tsdb-uid"):
        assert [port._route(table, k) for k in keys] == \
            [jax._route(table, k) for k in keys]
    # The shard skip relies on the routing hash being the bloom's
    # identity hash.
    from opentsdb_tpu_torch.core import codec
    from opentsdb_tpu_torch.storage.sstable import series_hash
    for k in keys[-64:]:
        assert port._route(T, k) == series_hash(codec.series_key(k)) % n


def test_route_stable_across_instances(tmp_path):
    a = ShardedKVStore(str(tmp_path / "s"), shards=4)
    keys = [rowkey(t, h) for t in range(16) for h in range(2)]
    routes = [a._route(T, k) for k in keys]
    for k in keys:
        a.put(T, k, F, b"q", b"v")
    a.close()
    b = ShardedKVStore(str(tmp_path / "s"))
    assert [b._route(T, k) for k in keys] == routes
    for k in keys:
        assert b.get(T, k, F) == [Cell(k, F, b"q", b"v")]
    b.close()


# ---------------------------------------------------------------------------
# Fan-in, point ops, batches, throttle
# ---------------------------------------------------------------------------

def test_scan_is_globally_ordered():
    s = ShardedKVStore(None, shards=4)
    keys = [rowkey(t, h) for t in range(20) for h in range(3)]
    for k in reversed(keys):
        s.put(T, k, F, b"q", b"v" + k[-1:])
    assert list(s.scan_raw(T, b"", b"")) == \
        [(k, [(b"q", b"v" + k[-1:])]) for k in sorted(keys)]


def test_scan_range_and_regexp():
    s = ShardedKVStore(None, shards=3)
    for t in range(10):
        s.put(T, rowkey(t), F, b"q", b"v")
    lo, hi = rowkey(2), rowkey(7)
    assert [r[0] for r in s.scan_raw(T, lo, hi)] == \
        sorted(rowkey(t) for t in range(2, 7))
    rx = b"(?s)^.{7}.{3}" + struct.pack(">I", 4)[1:] + b"$"
    assert [r[0] for r in s.scan_raw(T, b"", b"", key_regexp=rx)] == \
        [rowkey(4)]


def test_point_ops_route():
    s = ShardedKVStore(None, shards=4)
    k = rowkey(9)
    s.put(T, k, F, b"q1", b"a")
    s.put(T, k, F, b"q2", b"b")
    assert s.has_row(T, k) and not s.has_row(T, rowkey(10))
    assert s.cell_count(T, k) == 2
    s.delete(T, k, F, [b"q1"])
    assert s.cell_count(T, k) == 1
    s.delete_row(T, k)
    assert not s.has_row(T, k)
    assert s.atomic_increment("u", b"ctr", F, b"q", 5) == 5
    assert s.atomic_increment("u", b"ctr", F, b"q", 2) == 7
    assert s.compare_and_set("u", b"cas", F, b"q", None, b"x")
    assert not s.compare_and_set("u", b"cas", F, b"q", None, b"y")


def test_columnar_mixed_batch_routes_per_series():
    """A mixed columnar batch splits into per-shard sub-blobs; the flags
    and each shard's WAL bytes are the JAX store's."""
    keys = [rowkey(t) for t in range(12)]
    blob = b"".join(keys)
    stores = {}
    for name, mod in (("port", port_sharded), ("jax", jax_sharded)):
        s = stores[name] = mod.ShardedKVStore(None, shards=4)
        assert s.put_many_columnar(T, F, blob, 13, [b"q"] * 12,
                                   [b"v"] * 12) == [False] * 12
        for k in keys:
            assert [(c.qualifier, c.value) for c in s.get(T, k, F)] == \
                [(b"q", b"v")]
        assert s.put_many_columnar(T, F, blob, 13, [b"r"] * 12,
                                   [b"w"] * 12) == [True] * 12
    assert [dict(sh._tables[T].rows) for sh in stores["port"].shards] == \
        [dict(sh._tables[T].rows) for sh in stores["jax"].shards]


def test_columnar_mixed_batch_wal_bytes_match(tmp_path):
    keys = [rowkey(t, h) for t in range(9) for h in range(2)]
    blob = b"".join(keys)
    quals = [struct.pack(">H", i << 4) for i in range(len(keys))]
    vals = [bytes([i]) for i in range(len(keys))]
    for name, mod in (("port", port_sharded), ("jax", jax_sharded)):
        s = mod.ShardedKVStore(str(tmp_path / name), shards=4)
        s.put_many_columnar(T, F, blob, 13, quals, vals)
        s.put_many(T, F, [(rowkey(50), b"q", b"x"), (b"short", b"q", b"y")])
        s.close()
    for i in range(4):
        a = open(tmp_path / "port" / f"shard-{i}" / "wal", "rb").read()
        b = open(tmp_path / "jax" / f"shard-{i}" / "wal", "rb").read()
        assert a == b, i


def test_put_many_groups_and_flags():
    s = ShardedKVStore(None, shards=3)
    cells = [(rowkey(t), b"q", b"v") for t in range(9)]
    assert s.put_many(T, F, cells) == [False] * 9
    cells2 = cells[:4] + [(rowkey(99), b"q", b"v")]
    assert s.put_many(T, F, cells2) == [True] * 4 + [False]


def test_throttle_partial_existed_full_length():
    """A throttled batch applies per shard up to the per-shard cap (the
    ceiling of 1/N of the store's); the full-length flags and the applied
    rows are the JAX store's."""
    got = {}
    for name, mod in (("port", port_sharded), ("jax", jax_sharded)):
        s = mod.ShardedKVStore(None, shards=2, throttle_rows=4)
        cells = [(rowkey(t), b"q", b"v") for t in range(16)]
        s.put_many(T, F, cells[:1])
        with pytest.raises(Exception) as ei:
            s.put_many(T, F, cells)
        assert "throttle" in type(ei.value).__name__.lower()
        part = ei.value.partial_existed
        assert len(part) == 16
        assert s.row_count(T) <= 4
        got[name] = (list(part), sorted(r[0] for r in s.scan_raw(
            T, b"", b"")), [sh.throttle_rows for sh in s.shards])
    assert got["port"] == got["jax"]
    assert isinstance(ei.value, Exception)
    s = ShardedKVStore(None, shards=2, throttle_rows=4)
    with pytest.raises(PleaseThrottleError):
        s.put_many_columnar(T, F, b"".join(rowkey(t) for t in range(16)),
                            13, [b"q"] * 16, [b"v"] * 16)


# ---------------------------------------------------------------------------
# Persistence
# ---------------------------------------------------------------------------

def test_manifest_pins_count_table_and_routing(tmp_path):
    d = str(tmp_path / "store")
    s = ShardedKVStore(d, shards=4)
    s.put(T, rowkey(1), F, b"q", b"v")
    s.close()
    with pytest.raises(ValueError, match="shard-count mismatch"):
        ShardedKVStore(d, shards=2)
    with pytest.raises(ValueError, match="data-table mismatch"):
        ShardedKVStore(d, data_table="other")
    s2 = ShardedKVStore(d)  # the count from the manifest
    assert s2.shard_count == 4
    s2.close()
    with pytest.raises(ValueError, match="no SHARDS.json"):
        ShardedKVStore(str(tmp_path / "nope"), shards=None)
    man = port_sharded.manifest_path(d)
    rec = json.load(open(man))
    rec["series_bytes_excluded"] = [4, 9]
    json.dump(rec, open(man, "w"))
    with pytest.raises(ValueError, match="routing mismatch"):
        ShardedKVStore(d)


def test_manifest_bytes_and_cli_store_choice(tmp_path):
    """SHARDS.json is the JAX package's byte for byte; the CLI's store
    choice opens a sharded store by its manifest (--shards 0), refuses a
    disagreeing count, and keeps a plain WAL store otherwise."""
    for name, mod in (("port", port_sharded), ("jax", jax_sharded)):
        mod.ShardedKVStore(str(tmp_path / name), shards=4).close()
    assert open(tmp_path / "port" / "SHARDS.json", "rb").read() == \
        open(tmp_path / "jax" / "SHARDS.json", "rb").read()
    cfg = Config(device="cpu", fsync=True)
    s = open_store(cfg, str(tmp_path / "jax"))
    assert isinstance(s, ShardedKVStore) and s.shard_count == 4
    assert all(sh._fsync for sh in s.shards)
    s.close()
    with pytest.raises(ValueError, match="shard-count mismatch"):
        open_store(Config(device="cpu"), str(tmp_path / "jax"), shards=1)
    s = open_store(cfg, str(tmp_path / "plain" / "wal"))
    assert isinstance(s, MemKVStore) and s._fsync
    s.close()
    s = open_store(Config(device="cpu"), str(tmp_path / "new"), shards=3)
    assert s.shard_count == 3 and not s.shards[0]._fsync
    s.close()


def test_crash_replay_per_shard(tmp_path):
    d = str(tmp_path / "store")
    s = ShardedKVStore(d, shards=3)
    keys = [rowkey(t, h) for t in range(12) for h in range(2)]
    s.put_many(T, F, [(k, b"q", b"v" + k[-1:]) for k in keys])
    s._simulate_crash()
    s2 = ShardedKVStore(d)
    assert [r[0] for r in s2.scan_raw(T, b"", b"")] == sorted(keys)
    for k in keys:
        assert s2.get(T, k, F) == [Cell(k, F, b"q", b"v" + k[-1:])]
    s2.close()


def test_checkpoint_spills_all_shards_and_reopens(tmp_path):
    d = str(tmp_path / "store")
    s = ShardedKVStore(d, shards=4)
    keys = [rowkey(t, h) for t in range(16) for h in range(2)]
    s.put_many(T, F, [(k, b"q", b"v") for k in keys])
    assert s.checkpoint() == len(keys)
    assert len(s.spill_seconds) == 4
    for sh in s.shards:
        assert os.path.getsize(sh._wal_path) == 0
        # No shard writes a tenant file of its own; the marker sits at
        # the root.
        assert not os.path.exists(sh._wal_path + ".tenants.json")
    assert json.load(open(os.path.join(d, "TENANTS.json")))["version"] == 0
    s.put(T, rowkey(99), F, b"q", b"post")
    s.close()
    s2 = ShardedKVStore(d)
    assert s2.row_count(T) == len(keys) + 1
    assert s2.get(T, rowkey(99), F) == [Cell(rowkey(99), F, b"q", b"post")]
    s2.close()


def test_staggered_generation_caps():
    caps = [sh._MAX_GENERATIONS
            for sh in ShardedKVStore(None, shards=4).shards]
    assert len(set(caps)) == 4
    assert caps == [sh._MAX_GENERATIONS for sh in
                    jax_sharded.ShardedKVStore(None, shards=4).shards]
    assert [sh._MAX_GENERATIONS for sh in
            ShardedKVStore(None, shards=12).shards] == \
        [sh._MAX_GENERATIONS for sh in
         jax_sharded.ShardedKVStore(None, shards=12).shards]


def test_failed_creation_removes_fresh_manifest(tmp_path, monkeypatch):
    d = str(tmp_path / "store")
    real_init = MemKVStore.__init__
    calls = {"n": 0}

    def boom(self, *a, **k):
        calls["n"] += 1
        if calls["n"] == 3:
            raise OSError("simulated stale shard lock")
        real_init(self, *a, **k)

    monkeypatch.setattr(MemKVStore, "__init__", boom)
    with pytest.raises(OSError):
        ShardedKVStore(d, shards=4)
    monkeypatch.undo()
    assert not os.path.exists(port_sharded.manifest_path(d))
    s = ShardedKVStore(d, shards=8)
    assert s.shard_count == 8
    s.close()


def test_shard_lock_excludes_the_jax_writer(tmp_path):
    d = str(tmp_path / "store")
    s = ShardedKVStore(d, shards=2)
    with pytest.raises(RuntimeError, match="locked"):
        jax_sharded.ShardedKVStore(d)
    s.close()
    jax_sharded.ShardedKVStore(d).close()


# ---------------------------------------------------------------------------
# The same ingest through both packages' TSDBs
# ---------------------------------------------------------------------------

def _series(seed=7, n=8, points=400):
    rng = np.random.default_rng(seed)
    out = []
    for si in range(n):
        ts = BT + np.sort(rng.choice(6 * 3600, points, replace=False))
        out.append(("par.metric", {"host": f"h{si}", "dc": f"d{si % 2}"},
                    ts, np.round(rng.normal(50, 10, points), 3)))
    return out


def _port_tsdb(store, **kw):
    return TSDB(store, Config(auto_create_metrics=True, device="cpu",
                              **kw), start_compaction_thread=False)


def _jax_tsdb(store, **kw):
    return JaxTSDB(store, JaxConfig(auto_create_metrics=True,
                                    device_window=False, **kw),
                   start_compaction_thread=False)


def _ingest(tsdb, series):
    for metric, tags, ts, vals in series:
        tsdb.add_batch(metric, ts, vals, tags)


def _files(d):
    out = {}
    for root, _, fns in os.walk(d):
        for fn in fns:
            if fn.endswith(".lock"):
                continue
            p = os.path.join(root, fn)
            out[os.path.relpath(p, d)] = open(p, "rb").read()
    return out


def _run_both(tmp_path, steps, shards=4, **kw):
    """Each package ingests and checkpoints by ``steps`` (lists of
    series, "checkpoint", or "shutdown" last) into its own directory; the
    store is closed at the end (without sketches the JAX shutdown takes
    no checkpoint, the port's does, so the file test closes instead)."""
    dirs = {}
    for name in ("port", "jax"):
        d = dirs[name] = str(tmp_path / name)
        if name == "port":
            t = _port_tsdb(ShardedKVStore(d, shards=shards), **kw)
        else:
            t = _jax_tsdb(jax_sharded.ShardedKVStore(d, shards=shards), **kw)
        for step in steps:
            if step == "checkpoint":
                t.checkpoint()
            elif step == "shutdown":
                t.shutdown()
            else:
                _ingest(t, step)
        t.store.close()
    return dirs


@pytest.fixture(scope="module")
def jax_native(tmp_path_factory):
    from test_torch_native import build_jax_native
    return build_jax_native(str(tmp_path_factory.mktemp("jax_native")))


@pytest.mark.parametrize("c", [False, True], ids=["python", "native"])
def test_files_byte_identical_to_the_jax_package(tmp_path, monkeypatch,
                                                 request, c):
    """SHARDS.json, every shard's WAL, generations and manifest, and the
    root TENANTS.json: the same bytes (sketches off here: their snapshot
    is held below), both packages on their Python writers or both on
    their C (the two differ on a shard's empty table: ROADMAP queue C,
    reference note 9)."""
    from test_torch_native import use
    if c:
        use(monkeypatch, request.getfixturevalue("jax_native"), True, True)
    else:
        use(monkeypatch, (None, None), False, False)
    s = _series()
    steps = [s[:3], "checkpoint", s[3:6], "checkpoint", s[6:]]
    dirs = _run_both(tmp_path, steps, enable_sketches=False)
    got, want = _files(dirs["port"]), _files(dirs["jax"])
    assert sorted(got) == sorted(want)
    assert "SHARDS.json" in got and "TENANTS.json" in got
    gens = [fn for fn in got if ".sst.g" in fn]
    assert len({fn.split(os.sep)[0] for fn in gens}) >= 3
    for fn in sorted(want):
        assert got[fn] == want[fn], fn
    # No shard directory holds a tenant or sketch file.
    assert not [fn for fn in got if os.sep in fn
                and ("tenants" in fn or "sketches" in fn)]


def test_wal_bytes_identical_before_any_checkpoint(tmp_path):
    s = _series(seed=3)
    for name, mod in (("port", port_sharded), ("jax", jax_sharded)):
        d = str(tmp_path / name)
        t = (_port_tsdb if name == "port" else _jax_tsdb)(
            mod.ShardedKVStore(d, shards=4), enable_sketches=False)
        _ingest(t, s)
        t.store.flush()
        t.store._simulate_crash()
    for i in range(4):
        assert open(tmp_path / "port" / f"shard-{i}" / "wal", "rb").read() \
            == open(tmp_path / "jax" / f"shard-{i}" / "wal", "rb").read()


def test_root_snapshots_match_the_jax_package(tmp_path):
    """With the defaults (sketches and tenant accounting on), the root
    TENANTS.json is the JAX package's byte for byte, and store.sketches
    sits at the root in both, loadable by each package with the same
    state (the snapshot contract of tests/test_torch_checkpoint.py: slot
    maps and HLL registers equal, digest weights equal, means within rtol
    1e-6)."""
    s = _series(seed=11)
    dirs = _run_both(tmp_path, [s[:4], "checkpoint", s[4:], "shutdown"])
    for name in ("port", "jax"):
        files = set(os.listdir(dirs[name]))
        assert {"TENANTS.json", "store.sketches", "SHARDS.json"} <= files
    assert open(os.path.join(dirs["port"], "TENANTS.json"), "rb").read() \
        == open(os.path.join(dirs["jax"], "TENANTS.json"), "rb").read()
    from opentsdb_tpu.stats.livesketch import LiveSketches as JaxSketches
    from opentsdb_tpu_torch.stats.livesketch import LiveSketches
    ps = LiveSketches.load(os.path.join(dirs["port"], "store.sketches"),
                           device="cpu")
    js = JaxSketches.load(os.path.join(dirs["jax"], "store.sketches"))
    assert ps._td_slots == js._td_slots
    assert ps._hll_slots == js._hll_slots
    np.testing.assert_array_equal(ps._hll_regs.numpy(),
                                  np.asarray(js._hll_regs))
    pm, pw = ps._td_means.numpy(), ps._td_weights.numpy()
    jm, jw = np.asarray(js._td_means), np.asarray(js._td_weights)
    np.testing.assert_array_equal(pw, jw)
    np.testing.assert_allclose(pm, jm, rtol=1e-6)


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_each_package_opens_the_others_store(tmp_path, writer):
    """A 4-shard directory one package wrote (two checkpoints, then a
    crash with rows in every shard's WAL) opens in the other with the
    same rows, dirty-base sets and chunk_state per shard, and both
    TSDBs answer /q alike."""
    s = _series(seed=5)
    d = str(tmp_path / "w")
    if writer == "jax":
        t = _jax_tsdb(jax_sharded.ShardedKVStore(d, shards=4))
    else:
        t = _port_tsdb(ShardedKVStore(d, shards=4))
    _ingest(t, s[:3])
    t.checkpoint()
    _ingest(t, s[3:6])
    t.checkpoint()
    _ingest(t, s[6:])
    t.store.flush()
    t.store._simulate_crash()
    copies = {}
    for name in ("jax", "port"):
        shutil.copytree(d, tmp_path / name)
        copies[name] = str(tmp_path / name)
    pt = _port_tsdb(ShardedKVStore(copies["port"]))
    jt = _jax_tsdb(jax_sharded.ShardedKVStore(copies["jax"]))
    try:
        assert pt.store.shard_count == jt.store.shard_count == 4
        for tb in (T, "tsdb-uid"):
            assert list(pt.store.scan_raw(tb, b"", b"")) == \
                list(jt.store.scan_raw(tb, b"", b""))
        np.testing.assert_array_equal(pt.store.dirty_bases(T),
                                      jt.store.dirty_bases(T))
        assert len(pt.store.dirty_bases(T))
        for lo in range(BT - 3600, BT + 8 * 3600, 3600):
            assert pt.store.chunk_state(T, lo, lo + 7200) == \
                jt.store.chunk_state(T, lo, lo + 7200)
        assert len(pt.store.chunk_state(T, BT, BT + 3600)[0]) == 4
        assert pt.store.mutation_seqs == jt.store.mutation_seqs
        end = BT + 6 * 3600
        for spec_kw in (dict(aggregator="sum", downsample=(600, "avg")),
                        dict(aggregator="max", downsample=(3600, "max")),
                        dict(aggregator="sum")):
            want = JaxExecutor(jt, backend="tpu").run(
                JaxSpec("par.metric", {"host": "*"}, **spec_kw), BT, end)
            got = QueryExecutor(pt).run(
                QuerySpec("par.metric", {"host": "*"}, **spec_kw), BT, end)
            assert len(got) == len(want) == 8
            for g, w in zip(got, want):
                assert g.tags == w.tags
                np.testing.assert_array_equal(g.timestamps, w.timestamps)
                np.testing.assert_allclose(g.values, w.values, rtol=1e-5)
    finally:
        pt.shutdown()
        jt.shutdown()


# ---------------------------------------------------------------------------
# Golden /q parity, shards=1 vs shards=4, and the fragment cache
# ---------------------------------------------------------------------------

SPECS = [
    dict(metric="par.metric", tags={}, aggregator="sum",
         downsample=(600, "avg")),
    dict(metric="par.metric", tags={}, aggregator="sum", rate=True,
         downsample=(600, "avg")),
    dict(metric="par.metric", tags={}, aggregator="p95",
         downsample=(600, "avg")),
    dict(metric="par.metric", tags={"dc": "*"}, aggregator="sum",
         downsample=(600, "avg")),
    dict(metric="par.metric", tags={"host": "*"}, aggregator="max",
         downsample=(3600, "max")),
    dict(metric="par.metric", tags={"host": "h3"}, aggregator="dev",
         downsample=(1800, "avg")),
    dict(metric="par.metric", tags={}, aggregator="max"),
    dict(metric="par.metric", tags={"dc": "d0"}, aggregator="p95"),
]


def _assert_identical(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert x.tags == y.tags and x.aggregated_tags == y.aggregated_tags
        np.testing.assert_array_equal(x.timestamps, y.timestamps)
        np.testing.assert_array_equal(x.values, y.values)


@pytest.mark.parametrize("window", [True, False])
def test_golden_queries_match_one_shard(tmp_path, window):
    """The same ingest, one checkpoint and more ingest into a 1-shard and
    a 4-shard store: every /q answer identical (resident window on and
    off), and the sketch routes too."""
    s = _series(seed=13)
    t1 = _port_tsdb(MemKVStore(wal_path=str(tmp_path / "one" / "wal")),
                    device_window=window)
    t4 = _port_tsdb(ShardedKVStore(str(tmp_path / "four"), shards=4),
                    device_window=window)
    end = BT + 6 * 3600
    try:
        for t in (t1, t4):
            _ingest(t, s[:5])
            t.checkpoint()
            _ingest(t, s[5:])
        e1, e4 = QueryExecutor(t1), QueryExecutor(t4)
        for kw in SPECS:
            r1, p1, _ = e1.run_with_plan(QuerySpec(**kw), BT, end)
            r4, p4, _ = e4.run_with_plan(QuerySpec(**kw), BT, end)
            assert p1 == p4
            _assert_identical(r1, r4)
        assert e1.sketch_quantiles("par.metric", {}, [0.5, 0.95]) == \
            e4.sketch_quantiles("par.metric", {}, [0.5, 0.95])
        assert e1.distinct_tagv("par.metric", {}, "host", BT, end) == \
            e4.distinct_tagv("par.metric", {}, "host", BT, end)
    finally:
        t1.shutdown()
        t4.shutdown()


def test_fragment_cache_warm_equals_cold_over_four_shards(tmp_path):
    """After a checkpoint every chunk is clean: the first scan fills the
    cache from four shards, the repeat serves from it with the cold
    answer's bytes; a write into one shard invalidates only what it
    touches, and a write after a second checkpoint is seen."""
    s = _series(seed=17)
    t4 = _port_tsdb(ShardedKVStore(str(tmp_path / "four"), shards=4),
                    device_window=False, qcache_chunk_s=3600)
    end = BT + 6 * 3600
    try:
        _ingest(t4, s)
        t4.checkpoint()
        ex = QueryExecutor(t4)
        spec = QuerySpec("par.metric", {"host": "*"}, "sum",
                         downsample=(600, "avg"))
        cold, _, _ = ex.run_with_plan(spec, BT, end)
        misses = ex.qcache_misses
        assert misses > 0 and ex.qcache_hits == 0
        warm, _, _ = ex.run_with_plan(spec, BT, end)
        assert ex.qcache_hits == misses
        _assert_identical(cold, warm)
        # A write into one series' shard: its chunk goes dirty and is
        # re-read; the answer equals a fresh executor's cold scan.
        t4.add_batch("par.metric", np.array([BT + 5]), np.array([1e3]),
                     {"host": "h0", "dc": "d0"})
        again, _, _ = ex.run_with_plan(spec, BT, end)
        fresh, _, _ = QueryExecutor(t4).run_with_plan(spec, BT, end)
        _assert_identical(again, fresh)
        t4.checkpoint()
        after, _, _ = ex.run_with_plan(spec, BT, end)
        _assert_identical(after, fresh)
    finally:
        t4.shutdown()


def test_series_hint_skips_shards(tmp_path):
    """A one-host selector's scan skips the three shards its series does
    not route to (bloom_shards_skipped), as the JAX store's does."""
    s = _series(seed=19)
    stores = {}
    for name in ("port", "jax"):
        d = str(tmp_path / name)
        if name == "port":
            t = _port_tsdb(ShardedKVStore(d, shards=4),
                           device_window=False)
        else:
            t = _jax_tsdb(jax_sharded.ShardedKVStore(d, shards=4))
        _ingest(t, s)
        t.checkpoint()
        stores[name] = t
    try:
        spec = dict(metric="par.metric", tags={"host": "h1"},
                    aggregator="sum", downsample=(600, "avg"))
        got = QueryExecutor(stores["port"]).run(QuerySpec(**spec), BT,
                                                BT + 6 * 3600)
        want = JaxExecutor(stores["jax"], backend="tpu").run(
            JaxSpec(**spec), BT, BT + 6 * 3600)
        assert stores["port"].store.bloom_shards_skipped == \
            stores["jax"].store.bloom_shards_skipped > 0
        assert stores["port"].store.bloom_shards_skipped % 3 == 0
        np.testing.assert_array_equal(got[0].timestamps, want[0].timestamps)
        np.testing.assert_allclose(got[0].values, want[0].values,
                                   rtol=1e-5)
    finally:
        for t in stores.values():
            t.shutdown()


def test_tsdb_over_sharded_store_checkpoints_and_recovers(tmp_path):
    d = str(tmp_path / "store")
    tsdb = _port_tsdb(ShardedKVStore(d, shards=4), device_window=False)
    ts = BT + np.arange(1000, dtype=np.int64) * 13
    for si in range(6):
        tsdb.add_batch("it.metric", ts, np.full(1000, float(si)),
                       {"host": f"h{si}"})
    assert tsdb.checkpoint() > 0
    tsdb.store._simulate_crash()
    tsdb2 = _port_tsdb(ShardedKVStore(d), device_window=False)
    try:
        res = QueryExecutor(tsdb2, backend="cpu").run(
            QuerySpec("it.metric", {}, "sum"), BT, int(ts[-1]))
        assert len(res) == 1
        assert np.allclose(res[0].values, 15.0)
        assert len(res[0].timestamps) == 1000
        assert tsdb2.tenants.total_tracked() == 6
        assert not tsdb2.tenants.rebuilt
    finally:
        tsdb2.shutdown()
