"""The port's fault points, WAL group commit and fsck against the JAX
package's (opentsdb_tpu/fault/faultpoints.py, the group commit of
opentsdb_tpu/storage/kv.py, opentsdb_tpu/tools/fsck.py).

- the spec grammar, schedules and status are the JAX module's;
- every fault site fires where the JAX site fires, in the same order,
  with the same file and torn span, over one store and over four shards,
  with and without the rollup tier (its six sites among them), and an
  armed ``raise`` at each site breaks the same step and leaves the same
  rows (and rollup cells);
- the WAL bytes are the same with group commit on and off (and the JAX
  package's); a put under group commit does not return before its
  covering flush (a patched os.fsync that blocks shows it), unless the
  ``ack-before-fsync`` sabotage flag is set;
- fsck reports the JAX fsck's counts and lines on one hand-corrupted store
  (a bad qualifier, an out-of-order compacted cell, a bloom false
  negative), and ``--fix`` repairs both packages' copies to the same rows.
"""

import json
import os
import shutil
import struct
import threading
import time

import numpy as np
import pytest

import opentsdb_tpu.fault.faultpoints as jax_fp
import opentsdb_tpu.storage.kv as jax_kv
import opentsdb_tpu.storage.sharded as jax_sharded
import opentsdb_tpu_torch.fault.faultpoints as port_fp
import opentsdb_tpu_torch.storage.kv as port_kv
import opentsdb_tpu_torch.storage.sharded as port_sharded
import opentsdb_tpu_torch.storage.sstable as port_sst
from opentsdb_tpu.core.tsdb import TSDB as JaxTSDB
from opentsdb_tpu.query.executor import QueryExecutor as JaxExecutor
from opentsdb_tpu.query.executor import QuerySpec as JaxSpec
from opentsdb_tpu.tools.fsck import run_fsck as jax_fsck
from opentsdb_tpu.utils.config import Config as JaxConfig
from opentsdb_tpu_torch.core.tsdb import TSDB
from opentsdb_tpu_torch.query.executor import QueryExecutor, QuerySpec
from opentsdb_tpu_torch.server.wire import decode_puts, ingest_batch
from opentsdb_tpu_torch.tools import cli
from opentsdb_tpu_torch.tools.fsck import run_fsck as port_fsck
from opentsdb_tpu_torch.utils.config import Config

T = "tsdb"
F = b"t"
BT = 1356998400
FP = {"jax": jax_fp, "port": port_fp}

# Every fault site the port has (the JAX package's names).
PORT_SITES = ("kv.wal.append", "kv.wal.fsync", "kv.wal.group.write",
              "kv.wal.group.fsync", "kv.checkpoint.freeze",
              "kv.checkpoint.commit", "kv.checkpoint.manifest",
              "sst.write.footer", "sst.write.body", "sst.rename",
              "tenant.snapshot.write", "tenant.snapshot.commit",
              "query.scan", "sharded.spill.shard",
              "rollup.fold.flush", "rollup.begin_spill",
              "rollup.fold.start", "rollup.fold.commit",
              "rollup.bracket.flip", "rollup.catchup.commit")
ROLLUP_SITES = tuple(s for s in PORT_SITES if s.startswith("rollup."))


@pytest.fixture(autouse=True)
def _disarmed(monkeypatch):
    """Nothing armed before or after a test, each package's cumulative
    fired counters fresh for the test (other test files in the process
    fire sites in one package only), and both packages on their
    Python storage paths (the JAX package runs without its native build
    here; the port's C paths differ from it on an empty table, ROADMAP
    queue C note 9). ``native`` cases point both at their C."""
    from test_torch_native import use
    use(monkeypatch, (None, None), False, False)
    for fp in FP.values():
        fp.clear()
        monkeypatch.setattr(fp, "FIRED", {})
    yield
    for fp in FP.values():
        fp.clear()


@pytest.fixture(scope="module")
def jax_native(tmp_path_factory):
    from test_torch_native import build_jax_native
    return build_jax_native(str(tmp_path_factory.mktemp("jax_native")))


# ---------------------------------------------------------------------------
# The registry
# ---------------------------------------------------------------------------

SPECS = ["kv.wal.append=crash",
         "kv.wal.fsync=torn:skip=3:count=2:seed=9",
         " sst.rename=raise ; query.scan=delay:delay=0.25 ;",
         "a=ioerror:count=4;b=delay;c=crash:skip=1:seed=77"]
BAD_SPECS = ["kv.wal.append", "x=explode", "x=crash:skip=-1",
             "x=crash:count=0", "x=crash:bogus=1", "x=crash:skip"]


@pytest.mark.parametrize("spec", SPECS)
def test_parse_spec_and_status_match_jax(spec):
    for fp in FP.values():
        fp.install_spec(spec)
    assert port_fp.status() == jax_fp.status()
    got = [(a.site, a.mode, a.skip, a.count, a.delay, a.seed)
           for a in port_fp.parse_spec(spec)]
    assert got == [(a.site, a.mode, a.skip, a.count, a.delay, a.seed)
                   for a in jax_fp.parse_spec(spec)]
    for a in port_fp.parse_spec(spec):
        args = (a.site, a.mode, a.skip, a.count, a.delay, a.seed)
        assert port_fp.format_spec(*args) == jax_fp.format_spec(*args)
        assert port_fp.parse_spec(port_fp.format_spec(*args))[0].snapshot() \
            == a.snapshot()


@pytest.mark.parametrize("spec", BAD_SPECS)
def test_bad_specs_refused_alike(spec):
    for fp in FP.values():
        with pytest.raises(ValueError):
            fp.parse_spec(spec)


def test_schedule_and_torn_offset_match_jax(tmp_path):
    """skip/count schedules, the fired counters and the torn cut (a
    truncation inside the last record, the child's exit patched) are the
    JAX module's."""
    cut = {}
    for name, fp in FP.items():
        p = tmp_path / name
        p.write_bytes(bytes(range(256)) * 4)
        fp.arm("s", "raise", skip=2, count=2)
        hits = []
        for i in range(6):
            try:
                fp.fire("s")
            except fp.FaultInjected:
                hits.append(i)
        assert hits == [2, 3]
        fp.arm("t", "torn", skip=1, seed=5)
        exits = []
        real = fp.os._exit
        fp.os._exit = exits.append
        try:
            fp.fire("t", str(p), 100)
            fp.fire("t", str(p), 100)
        finally:
            fp.os._exit = real
        assert exits == [fp.EXIT_CODE]
        cut[name] = (os.path.getsize(p), fp.status())
    assert cut["port"] == cut["jax"]
    assert 1024 - 100 <= cut["port"][0] < 1024


def test_unarmed_fire_is_a_dict_check():
    assert not port_fp._ARMED
    t0 = time.perf_counter()
    for _ in range(200_000):
        port_fp.fire("kv.wal.append", "/nonexistent", 12)
    assert time.perf_counter() - t0 < 1.0


# ---------------------------------------------------------------------------
# The sites fire where the JAX package's do
# ---------------------------------------------------------------------------

def _parts(seed=4):
    rng = np.random.default_rng(seed)
    parts = [[], [], []]
    for h in range(6):
        tags = {"host": f"h{h}", "dc": f"d{h % 2}"}
        ts = BT + np.sort(rng.choice(4 * 3600, 90, replace=False))
        vals = np.round(rng.normal(10, 2, 90), 2)
        cut = np.searchsorted(ts, [BT + 3600, BT + 7200])
        for i, (a, b) in enumerate(zip([0, *cut], [*cut, 90])):
            if b > a:
                parts[i].append(("m", tags, ts[a:b], vals[a:b]))
    return parts


def _open(name, d, shards, rollups=False, **kw):
    if rollups:
        kw.update(enable_rollups=True, rollup_catchup="sync")
    if name == "port":
        store = (port_sharded.ShardedKVStore(d, shards=shards) if shards > 1
                 else port_kv.MemKVStore(wal_path=os.path.join(d, "wal")))
        return TSDB(store, Config(auto_create_metrics=True, device="cpu",
                                  device_window=False,
                                  enable_sketches=False, **kw),
                    start_compaction_thread=False)
    store = (jax_sharded.ShardedKVStore(d, shards=shards) if shards > 1
             else jax_kv.MemKVStore(wal_path=os.path.join(d, "wal")))
    return JaxTSDB(store, JaxConfig(auto_create_metrics=True,
                                    device_window=False,
                                    enable_sketches=False, **kw),
                   start_compaction_thread=False)


def _steps(name, tsdb):
    """The workload as a list of callables: ingest, a checkpoint, a
    delete over spilled rows (so the next checkpoint merges), puts of
    several kinds, a query, and a last checkpoint."""
    parts = _parts()

    def ingest(i):
        def run():
            for metric, tags, ts, vals in parts[i]:
                tsdb.add_batch(metric, ts, vals, tags)
        return run

    def delete():
        key = tsdb.row_key_for("m", {"host": "h1", "dc": "d1"}, BT,
                               create_metric=False, create_tags=False)
        tsdb.store.delete_row(tsdb.table, key)

    def puts():
        tsdb.store.put("tsdb-uid", b"k1", F, b"q", b"v")
        tsdb.store.put_many("tsdb-uid", F, [(b"k2", b"q", b"a"),
                                            (b"k345", b"q", b"b")])

    def query():
        if name == "port":
            QueryExecutor(tsdb).run(QuerySpec("m", {"host": "*"}, "sum",
                                              downsample=(600, "avg")),
                                    BT, BT + 4 * 3600)
        else:
            JaxExecutor(tsdb, backend="tpu").run(
                JaxSpec("m", {"host": "*"}, "sum", downsample=(600, "avg")),
                BT, BT + 4 * 3600)

    return [ingest(0), tsdb.checkpoint, ingest(1), delete, puts,
            tsdb.checkpoint, query, ingest(2), tsdb.checkpoint]


def _dump(store):
    return {tb: list(store.scan_raw(tb, b"", b"")) for tb in (T, "tsdb-uid")}


def _rollup_cells(tsdb):
    tier = tsdb.rollups
    if tier is None:
        return None
    return {(r, si): list(s.scan_raw(T, b"", b""))
            for r, stores in tier.stores.items()
            for si, s in enumerate(stores)}


def _close(tsdb):
    """Close without a checkpoint: the rollup tier first (its stores hold
    flocks), then the store."""
    if tsdb.rollups is not None:
        tsdb.rollups.close()
    tsdb.store.close()


@pytest.mark.parametrize("shards,group_ms,c,rollups", [
    (1, 0.0, False, False), (4, 0.0, False, False), (1, 2.0, False, False),
    (4, 2.0, False, False), (4, 0.0, True, False), (1, 0.0, False, True),
    (4, 0.0, False, True)])
def test_sites_fire_in_the_jax_order(tmp_path, monkeypatch, request, shards,
                                     group_ms, c, rollups):
    """With every site passed through a recorder, the same workload visits
    the same sites in the same order, with the same file names and torn
    spans, in both packages (on their Python paths, or both on their
    C)."""
    if c:
        from test_torch_native import use
        use(monkeypatch, request.getfixturevalue("jax_native"), True, True)
    seen = {}
    for name, fp in FP.items():
        log = seen[name] = []
        monkeypatch.setattr(fp, "_fire_armed", lambda site, path, n, log=log:
                            log.append((site, path and os.path.relpath(
                                path, str(tmp_path / name)), n)))
        fp.arm("nothing.here", "delay")
        t = _open(name, str(tmp_path / name), shards, rollups,
                  wal_group_ms=group_ms)
        for step in _steps(name, t):
            step()
        _close(t)
        fp.clear()
    assert seen["port"] == seen["jax"]
    sites = {s for s, _, _ in seen["port"]}
    want = {"kv.wal.fsync", "kv.checkpoint.freeze", "kv.checkpoint.commit",
            "kv.checkpoint.manifest", "sst.write.footer", "sst.write.body",
            "sst.rename", "tenant.snapshot.write", "tenant.snapshot.commit",
            "query.scan"}
    want |= ({"kv.wal.group.write", "kv.wal.group.fsync"} if group_ms
             else {"kv.wal.append"})
    if shards > 1:
        want.add("sharded.spill.shard")
    if rollups:
        want |= set(ROLLUP_SITES) - {"rollup.catchup.commit"}
    assert want <= sites <= set(PORT_SITES)


@pytest.mark.parametrize("site", [s for s in PORT_SITES
                                  if s not in ("kv.wal.group.write",
                                               "rollup.catchup.commit")])
def test_armed_raise_breaks_the_same_step(tmp_path, site):
    """An armed raise at a site breaks the same step of the workload in
    both packages, and the stores hold the same rows after the rest of
    the workload ran (the thaw and manifest rollback paths included)."""
    shards = 4 if site == "sharded.spill.shard" else 1
    group = 2.0 if site.startswith("kv.wal.group") else 0.0
    rollups = site in ROLLUP_SITES
    got = {}
    for name, fp in FP.items():
        t = _open(name, str(tmp_path / name), shards, rollups,
                  wal_group_ms=group)
        # The second hit (the merging checkpoint's, for the checkpoint
        # sites); the query scans once.
        fp.arm(site, "raise", skip=0 if site == "query.scan" else 1)
        broke = []
        for i, step in enumerate(_steps(name, t)):
            try:
                step()
            except fp.FaultInjected:
                broke.append(i)
        fp.clear()
        got[name] = (broke, _dump(t.store), _rollup_cells(t))
        _close(t)
    assert got["port"][0] == got["jax"][0] != []
    assert got["port"][1:] == got["jax"][1:]


def test_catchup_commit_raise_leaves_the_tier_owing_its_rebuild(tmp_path):
    """rollup.catchup.commit fires only in a catch-up: a store spilled
    without its tier reopens with it (no state file: a full rebuild, run
    synchronously). A raise there is kept as the rebuild's error in both
    packages: the tier is not ready, its state stays pending, and the
    next open rebuilds it to the same cells."""
    got = {}
    for name, fp in FP.items():
        d = str(tmp_path / name)
        t = _open(name, d, 1)
        for step in _steps(name, t)[:2]:      # ingest, checkpoint
            step()
        _close(t)
        fp.arm("rollup.catchup.commit", "raise")
        t = _open(name, d, 1, rollups=True)
        fp.clear()
        state = json.load(open(t.rollups.state_path))
        got[name] = [t.rollups.ready,
                     type(t.rollups._rebuild_error).__name__,
                     state["pending"], _rollup_cells(t)]
        _close(t)
        t = _open(name, d, 1, rollups=True)
        got[name] += [t.rollups.ready, t.rollups.rebuilds,
                      _rollup_cells(t)]
        _close(t)
    assert got["port"] == got["jax"]
    assert got["port"][:3] == [False, "FaultInjected", True]
    assert got["port"][4:6] == [True, 1] and got["port"][6]


def test_group_write_raise_breaks_the_same_step(tmp_path):
    got = {}
    for name, fp in FP.items():
        t = _open(name, str(tmp_path / name), 1, wal_group_ms=2.0)
        fp.arm("kv.wal.group.write", "raise", skip=3)
        broke = []
        for i, step in enumerate(_steps(name, t)):
            try:
                step()
            except fp.FaultInjected:
                broke.append(i)
        fp.clear()
        got[name] = broke
        t.store.close()
    assert got["port"] == got["jax"] != []


# ---------------------------------------------------------------------------
# Group commit
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shards", [1, 4])
def test_wal_bytes_identical_with_group_commit_on_and_off(tmp_path,
                                                          shards):
    walls = {}
    for name, group in (("off", 0.0), ("on", 2.0), ("jax", 2.0)):
        pkg = "jax" if name == "jax" else "port"
        t = _open(pkg, str(tmp_path / name), shards, wal_group_ms=group)
        steps = _steps(pkg, t)
        for step in steps[:5]:      # up to the puts, before checkpoint 2
            step()
        t.store.flush()
        t.store._simulate_crash()
        walls[name] = {
            os.path.relpath(os.path.join(r, fn), str(tmp_path / name)):
            open(os.path.join(r, fn), "rb").read()
            for r, _, fns in os.walk(str(tmp_path / name))
            for fn in fns if fn == "wal" or fn == "wal.old"}
    assert walls["on"] == walls["off"] == walls["jax"]
    assert sum(map(len, walls["on"].values())) > 0


def _blocking_fsync(monkeypatch):
    """os.fsync patched to block until released; returns (entered,
    release)."""
    entered, release = threading.Event(), threading.Event()
    real = os.fsync

    def fsync(fd):
        entered.set()
        assert release.wait(10)
        real(fd)

    monkeypatch.setattr(port_kv.os, "fsync", fsync)
    return entered, release


def test_put_waits_for_its_covering_flush(tmp_path, monkeypatch):
    """With fsync and group commit on, a writer's put parks until the
    covering group flush has fsynced: while the fsync blocks, the put has
    not returned; once it completes, the put returns, and one flush
    covered it."""
    s = port_kv.MemKVStore(wal_path=str(tmp_path / "wal"), fsync=True)
    s.wal_group_ms = 2.0
    entered, release = _blocking_fsync(monkeypatch)
    done = threading.Event()
    th = threading.Thread(target=lambda: (s.put(T, b"k" * 13, F, b"q",
                                                b"v"), done.set()))
    th.start()
    assert entered.wait(5)
    time.sleep(0.2)
    assert not done.is_set(), "the put acknowledged before its fsync"
    release.set()
    th.join(5)
    assert done.is_set()
    assert s.wal_group_flushes == 1
    monkeypatch.undo()
    s.close()


def test_ack_before_fsync_flag_acknowledges_early(tmp_path, monkeypatch):
    """The sabotage flag the crash matrix's bug gate sets: the put returns
    at once, with no covering flush at all."""
    s = port_kv.MemKVStore(wal_path=str(tmp_path / "wal"), fsync=True)
    s.wal_group_ms = 2.0
    entered, release = _blocking_fsync(monkeypatch)
    monkeypatch.setattr(port_kv.MemKVStore, "_ACK_BEFORE_FSYNC", True)
    done = threading.Event()
    th = threading.Thread(target=lambda: (s.put(T, b"k" * 13, F, b"q",
                                                b"v"), done.set()))
    th.start()
    th.join(5)
    assert done.is_set() and not entered.is_set()
    assert s.wal_group_flushes == 0
    release.set()
    monkeypatch.undo()
    s.close()


def test_concurrent_writers_share_group_flushes(tmp_path):
    """Many writer threads under group commit: every put lands, and the
    flushes number fewer than the puts (the leader covers followers)."""
    s = port_kv.MemKVStore(wal_path=str(tmp_path / "wal"))
    s.wal_group_ms = 5.0
    keys = [struct.pack(">I", i) * 4 for i in range(64)]

    def writer(ks):
        for k in ks:
            s.put(T, k, F, b"q", b"v")

    ths = [threading.Thread(target=writer, args=(keys[i::8],))
           for i in range(8)]
    for th in ths:
        th.start()
    for th in ths:
        th.join(10)
    assert 0 < s.wal_group_flushes < len(keys)
    s._simulate_crash()
    r = port_kv.MemKVStore(wal_path=str(tmp_path / "wal"))
    assert sorted(k for k, _ in r.scan_raw(T, b"", b"")) == sorted(keys)
    r.close()


def test_ingest_batch_takes_one_barrier(tmp_path, monkeypatch):
    """A wire batch of several series: each put skips its own wait
    (sync=False) and one covering barrier runs at the end."""
    t = TSDB(port_kv.MemKVStore(wal_path=str(tmp_path / "wal")),
             Config(auto_create_metrics=True, device="cpu",
                    device_window=False, enable_sketches=False,
                    wal_group_ms=2.0), start_compaction_thread=False)
    assert t.store.wal_group_ms == 2.0
    syncs, barriers = [], []
    real_put = t.store.put_many_columnar
    monkeypatch.setattr(t.store, "put_many_columnar",
                        lambda *a, **k: (syncs.append(k.get("sync")),
                                         real_put(*a, **k))[1])
    real_barrier = t.store.wal_barrier
    monkeypatch.setattr(t.store, "wal_barrier",
                        lambda *a: (barriers.append(1), real_barrier())[1])
    lines = ["".join(f"put m {BT + 60 * j + i} {i} host=h{i % 5}\n"
                     for i in range(50)).encode() for j in range(2)]
    # The first batch mints the UIDs (each UID put waits for its own
    # flush); the second writes five known series.
    assert ingest_batch(t, decode_puts(lines[0])) == (50, [])
    syncs.clear(), barriers.clear()
    flushes = t.store.wal_group_flushes
    assert ingest_batch(t, decode_puts(lines[1])) == (50, [])
    assert syncs == [False] * 5 and barriers == [1]
    assert t.store.wal_group_flushes == flushes + 1
    t.shutdown()


# ---------------------------------------------------------------------------
# fsck
# ---------------------------------------------------------------------------

def _zero_blooms(path):
    """Clear every bloom bit of a TSST3 file: each indexed key becomes a
    false negative."""
    buf = bytearray(open(path, "rb").read())
    ntables, _, bloom_start = port_sst._TRAILER_V3.unpack_from(
        buf, len(buf) - port_sst._TRAILER_V3.size)
    off = bloom_start
    for _ in range(ntables):
        (n,) = port_sst._U16.unpack_from(buf, off)
        off += 2 + n
        _, nbits = port_sst._BLOOM_HDR.unpack_from(buf, off)
        off += port_sst._BLOOM_HDR.size
        buf[off:off + nbits // 8] = bytes(nbits // 8)
        off += nbits // 8
    open(path, "wb").write(bytes(buf))


def _corrupt_store(d):
    """A 4-shard store (written by the port) with a bad qualifier, an
    out-of-order compacted cell, a duplicate point across cells and, in
    one shard's generation, a bloom that excludes its keys."""
    t = _open("port", d, 4)
    parts = _parts()
    for metric, tags, ts, vals in parts[0]:
        t.add_batch(metric, ts, vals, tags)
    t.checkpoint()
    for metric, tags, ts, vals in parts[1]:
        t.add_batch(metric, ts, vals, tags)
    k = lambda h: t.row_key_for("m", {"host": f"h{h}", "dc": f"d{h % 2}"},
                                BT + 3600, create_metric=False,
                                create_tags=False)
    # A qualifier of odd length.
    t.store.put(T, k(0), F, b"\x00\x10\x00", b"\x01")
    # A compacted cell whose deltas go backwards (20 s, then 10 s).
    t.store.put(T, k(2), F, b"\x01\x40\x00\xa0", b"\x05\x06\x00")
    # The same second twice with different values, in two cells.
    t.store.put(T, k(4), F, b"\x00\x50", b"\x07")
    t.store.put(T, k(4), F, b"\x00\x50\x00\x60", b"\x08\x09\x00")
    t.store.flush()
    t.store.close()
    gens = sorted(os.path.join(r, fn) for r, _, fns in os.walk(d)
                  for fn in fns if ".sst.g" in fn)
    _zero_blooms(gens[0])


def test_fsck_counts_match_jax_and_fix_repairs_alike(tmp_path):
    src = str(tmp_path / "src")
    _corrupt_store(src)
    reps, logs, after = {}, {}, {}
    for name in ("port", "jax"):
        d = str(tmp_path / name)
        shutil.copytree(src, d)
        t = _open(name, d, 4)
        lines = logs[name] = []
        reps[name] = (port_fsck if name == "port" else jax_fsck)(
            t, log=lines.append)
        fixed = (port_fsck if name == "port" else jax_fsck)(t, fix=True)
        again = (port_fsck if name == "port" else jax_fsck)(t)
        after[name] = (fixed.fixed, again.errors - again.bloom_misses,
                       _dump(t.store))
        t.store.close()
    p, j = reps["port"], reps["jax"]
    for f in ("kvs", "rows", "errors", "fixed", "bloomed", "plain",
              "bloom_misses", "format_counts"):
        assert getattr(p, f) == getattr(j, f), f
    assert p.bloom_misses > 0 and p.errors > p.bloom_misses
    assert logs["port"] == [ln.replace(str(tmp_path / "jax"),
                                       str(tmp_path / "port"))
                            for ln in logs["jax"]]
    assert any("odd qualifier" in ln for ln in logs["port"])
    assert any("out-of-order" in ln for ln in logs["port"])
    assert after["port"] == after["jax"]
    assert after["port"][0] == 3 and after["port"][1] == 0


def test_fsck_cli_expect_clean(tmp_path, capsys):
    src = str(tmp_path / "bad")
    _corrupt_store(src)
    assert cli.main(["fsck", "--wal", src, "--device", "cpu"]) == 1
    assert cli.main(["fsck", "--wal", src, "--device", "cpu", "--fix",
                     "--expect-clean"]) == 2
    out = capsys.readouterr().out
    assert "Found" in out and "Fixed 3 rows." in out
    good = str(tmp_path / "good")
    t = _open("port", good, 1)
    for metric, tags, ts, vals in _parts()[0]:
        t.add_batch(metric, ts, vals, tags)
    t.shutdown()
    assert cli.main(["fsck", "--wal", os.path.join(good, "wal"), "--device",
                     "cpu", "--expect-clean"]) == 0
    assert "Found 0 errors." in capsys.readouterr().out
