"""The port's native ingest extension and telnet decoder
(opentsdb_tpu_torch/native/, built by opentsdb_tpu_torch/utils/nativeext.py)
against its Python reference paths and against the JAX package's own C.

The JAX package's C is built here from the repo's native/ into a temporary
directory and patched into its modules (``_EXT`` of storage/kv.py,
storage/sstable.py and core/codec_np.py, ``_NATIVE`` of server/wire.py);
nothing under opentsdb_tpu/ or native/ is written. Each test runs the same
seeded inputs four ways where it can: the port with its C, the port's
Python, the JAX package's Python and the JAX package's C.

Contracts:
- generation files (both checkpoints, a copy-merge) and WAL records are
  byte-identical four ways; the rows, ``pending`` index, dirty-base
  refcounts and the ``existed`` flags too (and the port's two paths leave
  the same mutation seq and stamps), but for one corner: a live
  all-tombstone row, which the C upsert reports as existing (the JAX
  store's comment, opentsdb_tpu/storage/kv.py:2527-2533);
- a table with no rows: both packages' C framers write a zero-key footer
  entry where both Python writers leave the table out (the files differ,
  the readers agree);
- ``slice_cells`` equals the list path; the native telnet decoder gives
  the points and series of the numpy decoder and the JAX native decoder's
  exact output, errors included;
- a throttle trip mid-batch still raises with ``partial_existed``;
- a failed build raises with the compiler's log.
"""

import importlib.util
import os
import subprocess
import sysconfig

import numpy as np
import pytest

import opentsdb_tpu.core.codec_np as jax_cnp
import opentsdb_tpu.server.wire as jax_wire
import opentsdb_tpu.storage.kv as jax_kv
import opentsdb_tpu.storage.sstable as jax_sst
import opentsdb_tpu_torch.core.codec_np as port_cnp
import opentsdb_tpu_torch.server.wire as port_wire
import opentsdb_tpu_torch.storage.kv as port_kv
import opentsdb_tpu_torch.storage.sstable as port_sst
from opentsdb_tpu.core.errors import PleaseThrottleError as JaxThrottle
from opentsdb_tpu.core.tsdb import TSDB as JaxTSDB
from opentsdb_tpu.utils.config import Config as JaxConfig
from opentsdb_tpu_torch.core.errors import PleaseThrottleError
from opentsdb_tpu_torch.core.tsdb import TSDB
from opentsdb_tpu_torch.utils import nativeext
from opentsdb_tpu_torch.utils.config import Config

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
T = "tsdb"
F = b"t"
BT = 1356998400  # hour-aligned epoch

# (package, C on): the four ways.
WAYS = [("port", True), ("port", False), ("jax", False), ("jax", True)]
KV = {"jax": jax_kv, "port": port_kv}
SST = {"jax": jax_sst, "port": port_sst}
CNP = {"jax": jax_cnp, "port": port_cnp}


def build_jax_native(out_dir):
    """Build the JAX package's native/ sources into ``out_dir`` with the
    flags of native/Makefile; (ingest module, configured wire library)."""
    src = os.path.join(ROOT, "native")
    inc = sysconfig.get_paths()["include"]
    so = os.path.join(out_dir, "tsd_ingest_ext"
                      + sysconfig.get_config_var("EXT_SUFFIX"))
    wire = os.path.join(out_dir, "libtsdwire.so")
    procs = [subprocess.Popen(
        ["gcc", "-O3", "-fPIC", "-Wall", "-Wextra", "-march=native",
         "-I" + inc, "-shared", "-o", so,
         os.path.join(src, "ingest_ext.c")],
        stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL),
        subprocess.Popen(
        ["g++", "-O3", "-std=c++17", "-fPIC", "-Wall", "-Wextra",
         "-march=native", "-shared", "-o", wire,
         os.path.join(src, "wire_decoder.cpp")],
        stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL)]
    for p in procs:
        assert p.wait(timeout=300) == 0
    spec = importlib.util.spec_from_file_location("tsd_ingest_ext", so)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_wire, "_LIB_PATHS", (wire,))
        lib = jax_wire._load_native()
    assert lib is not None
    return mod, lib


@pytest.fixture(scope="module")
def jax_native(tmp_path_factory):
    return build_jax_native(str(tmp_path_factory.mktemp("jax_native")))


def use(mp, jax_native, jax_c, port_c):
    """Point both packages' native handles at their C or at None."""
    mod, lib = jax_native
    for m in (jax_kv, jax_sst, jax_cnp):
        mp.setattr(m, "_EXT", mod if jax_c else None)
    mp.setattr(jax_wire, "_NATIVE", lib if jax_c else None)
    for m in (port_kv, port_sst, port_cnp):
        mp.setattr(m, "_EXT", nativeext.EXT if port_c else None)
    mp.setattr(port_wire, "_NATIVE", nativeext.WIRE if port_c else None)


def _use_way(mp, jax_native, pkg, c):
    use(mp, jax_native, jax_c=pkg == "jax" and c,
        port_c=pkg == "port" and c)


def _dir_bytes(wal):
    d = os.path.dirname(wal)
    return {fn: open(os.path.join(d, fn), "rb").read()
            for fn in sorted(os.listdir(d)) if ".sst" in fn}


def _state(store):
    """Per table: rows, pending and dirty refcounts."""
    return {name: (t.rows, set(t.pending), t.dirty)
            for name, t in sorted(store._tables.items())}


def _stamps(store):
    """The mutation seq and, per table, the touch stamps."""
    return store.mutation_seq, {name: t.touch for name, t
                                in sorted(store._tables.items())}


def _assert_four_ways(out, stamps):
    """Every way equals the JAX Python path's output, and the port's two
    paths leave the same stamps. (The JAX store hands a batch its bulk
    path refuses to ``put_many``, which bumps ``mutation_seq`` a second
    time; the port bumps once a batch on every path. Stamps only ever
    compare with the same store's.)"""
    for way, got in out.items():
        assert got == out["jax", False], way
    assert stamps["port", True] == stamps["port", False]


def _key(base, host, metric=1):
    return (metric.to_bytes(3, "big") + (BT + 3600 * base).to_bytes(4, "big")
            + bytes([0, 0, 1, 0, 0, host]))


# ---------------------------------------------------------------------------
# The sources, the build and the loader
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name,marker", [
    ("ingest_ext.c", "#define PY_SSIZE_T_CLEAN"),
    ("wire_decoder.cpp", "#include <cstdint>")])
def test_sources_are_the_jax_packages_but_the_module_name(name, marker):
    """The port's copy differs from the JAX package's only in its header
    comment and, for the CPython module, its name."""
    jax = open(os.path.join(ROOT, "native", name)).read()
    port = open(os.path.join(nativeext.NATIVE_DIR, name)).read()
    port = port.replace("tsd_ingest_ext_torch", "tsd_ingest_ext")
    assert port[port.index(marker):] == jax[jax.index(marker):]


def test_builds_into_the_package_and_loads_beside_the_jax_module(
        jax_native):
    mod = nativeext.ingest_module()
    lib = nativeext.wire_library()
    assert mod.__name__ == "tsd_ingest_ext_torch"
    for path in (mod.__file__, lib._name):
        assert os.path.dirname(path) == nativeext.BUILD_DIR
        assert nativeext.BUILD_DIR == os.path.join(
            ROOT, "opentsdb_tpu_torch", "_build")
    # Both packages' modules live in one process, apart.
    assert jax_native[0].__name__ == "tsd_ingest_ext"
    assert jax_native[0] is not mod
    assert mod.slice_keys(b"abcd", 2) == jax_native[0].slice_keys(b"abcd",
                                                                  2)


def test_calls_are_counted_per_site(monkeypatch):
    assert port_wire.native_available()
    monkeypatch.setattr(port_wire, "_NATIVE", None)
    assert not port_wire.native_available()
    monkeypatch.undo()
    before = dict(nativeext.calls)
    nativeext.EXT.slice_keys(b"ab" * 3, 2)
    nativeext.EXT.slice_varlen(b"abc", b"\x00\x00\x00\x03")
    port_wire.decode_puts(b"put m 1 1 a=b\n")
    after = nativeext.calls
    assert after["slice_keys"] == before["slice_keys"] + 1
    assert after["slice_varlen"] == before["slice_varlen"] + 1
    assert after["tsd_parse"] == before["tsd_parse"] + 1
    assert set(after) == set(nativeext.SITES)


@pytest.mark.parametrize("fault", ["missing_compiler", "compile_error"])
@pytest.mark.parametrize("lib", ["ingest", "wire"])
def test_failed_build_raises(tmp_path, monkeypatch, fault, lib):
    """No quiet fallback: a build that cannot run or that fails raises
    RuntimeError (with the compiler's log), and so does the call site."""
    monkeypatch.setattr(nativeext, "BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(nativeext, "_loaded", {})
    if fault == "missing_compiler":
        monkeypatch.setattr(nativeext, "CC", str(tmp_path / "no-gcc"))
        monkeypatch.setattr(nativeext, "CXX", str(tmp_path / "no-g++"))
        match = "cannot run"
    else:
        src = tmp_path / "src"
        src.mkdir()
        for fn in ("ingest_ext.c", "wire_decoder.cpp"):
            (src / fn).write_text("this is not C\n")
        monkeypatch.setattr(nativeext, "NATIVE_DIR", str(src))
        match = "failed for"
    with pytest.raises(RuntimeError, match=match) as ei:
        if lib == "ingest":
            port_kv.MemKVStore().put_many_columnar(
                T, F, _key(0, 1), 13, [b"\x00\x01"], [b"v"])
        else:
            port_wire.decode_puts(b"put m 1 1 a=b\n")
    if fault == "compile_error":
        assert "error" in str(ei.value)
    assert not os.path.exists(tmp_path / "build") or not any(
        fn.endswith((".so", ".tmp"))
        for fn in os.listdir(tmp_path / "build"))


# ---------------------------------------------------------------------------
# core/codec_np.py: slice_cells
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("all_float", [True, False])
def test_slice_cells_equals_the_list_path(monkeypatch, jax_native,
                                          all_float):
    rng = np.random.default_rng(11)
    n = 4000
    row_starts = np.unique(np.concatenate(
        [[0], rng.choice(np.arange(1, n), 700, replace=False)]))
    deltas = np.concatenate([np.sort(rng.choice(3600, m, replace=False))
                             for m in np.diff(np.append(row_starts, n))])
    fv = rng.normal(0, 1e3, n)
    iv = rng.integers(-2 ** 40, 2 ** 40, n) >> rng.integers(0, 40, n)
    isf = (np.ones(n, bool) if all_float else rng.random(n) < 0.4)
    got = {}
    for pkg, c in WAYS:
        _use_way(monkeypatch, jax_native, pkg, c)
        before = nativeext.calls["slice_cells"]
        got[pkg, c] = CNP[pkg].encode_cells_multi(deltas, fv, iv, isf,
                                                  row_starts)
        assert nativeext.calls["slice_cells"] - before == int(
            pkg == "port" and c)
    ref = got["jax", False]
    assert len(ref[0]) == len(row_starts)
    for way, out in got.items():
        assert tuple(map(list, out)) == tuple(map(list, ref)), way


# ---------------------------------------------------------------------------
# storage/kv.py: the bulk upsert, the WAL, the replay
# ---------------------------------------------------------------------------

def _batches(rng):
    """Columnar batches over 3 metrics x 6 hours x 8 hosts: new rows,
    rows of earlier batches, and keys repeated inside one batch."""
    out = []
    for b in range(10):
        m = int(rng.integers(4, 40))
        keys = [_key(int(rng.integers(0, 6)), int(rng.integers(1, 9)),
                     int(rng.integers(1, 4))) for _ in range(m)]
        if b % 3 == 2:
            keys += keys[:3]          # intra-batch duplicates
        elif b % 3 == 1:
            keys = list(dict.fromkeys(keys))   # one cell a row
        quals = [int(rng.integers(0, 3600 << 4)).to_bytes(2, "big")
                 for _ in keys]
        vals = [rng.bytes(int(rng.integers(1, 9))) for _ in keys]
        out.append((keys, quals, vals))
    return out


def _run_batches(store, batches, checkpoint_at=()):
    existed = []
    for i, (keys, quals, vals) in enumerate(batches):
        if i in checkpoint_at:
            store.checkpoint()
        existed.append(store.put_many_columnar(
            T, F, b"".join(keys), len(keys[0]), quals, vals))
    return existed


@pytest.mark.parametrize("case", ["memtable", "spilled"])
def test_columnar_batches_four_ways(tmp_path, monkeypatch, jax_native,
                                    case):
    """The same batches give the same existed flags, WAL bytes, rows,
    pending index and dirty bases four ways; after a checkpoint the
    lower-tier branch (the Python bulk branch with rows_update_new, and
    the per-cell loop for a batch with duplicates) runs too."""
    ckpt = (4, 7) if case == "spilled" else ()
    out, stamps = {}, {}
    calls0 = dict(nativeext.calls)
    for pkg, c in WAYS:
        _use_way(monkeypatch, jax_native, pkg, c)
        wal = str(tmp_path / f"{pkg}{int(c)}" / "wal")
        os.makedirs(os.path.dirname(wal))
        store = KV[pkg].MemKVStore(wal_path=wal)
        existed = _run_batches(store, _batches(np.random.default_rng(2)),
                               ckpt)
        stamps[pkg, c] = _stamps(store)
        state = _state(store)
        store.close()
        out[pkg, c] = (existed, open(wal, "rb").read(), state,
                       _dir_bytes(wal))
    _assert_four_ways(out, stamps)
    calls = {k: nativeext.calls[k] - calls0[k] for k in calls0}
    assert calls["slice_keys"] == 10 and calls["upsert_cells"] > 0
    if case == "spilled":
        assert calls["rows_update_new"] > 0
        assert calls["frame_rows_dict"] == 2


def test_wal_replay_four_ways(tmp_path, monkeypatch, jax_native):
    """One WAL (batch records, single puts, deletes, a row delete) over
    one generation replays to the same rows, pending index, dirty bases
    and stamps four ways."""
    src = tmp_path / "src"
    src.mkdir()
    use(monkeypatch, jax_native, False, False)
    store = port_kv.MemKVStore(wal_path=str(src / "wal"))
    batches = _batches(np.random.default_rng(5))
    _run_batches(store, batches[:4])
    store.checkpoint()
    _run_batches(store, batches[4:])
    k0 = batches[0][0][0]
    store.put(T, _key(9, 9), F, b"\x00\x01", b"single")
    store.delete(T, k0, F, [batches[0][1][0]])
    store.delete_row(T, batches[1][0][0])
    store.close()
    files = {fn: open(src / fn, "rb").read() for fn in os.listdir(src)}
    out = {}
    for pkg, c in WAYS:
        _use_way(monkeypatch, jax_native, pkg, c)
        d = tmp_path / f"{pkg}{int(c)}"
        d.mkdir()
        for fn, data in files.items():
            (d / fn).write_bytes(data)
        before = nativeext.calls["upsert_cells"]
        again = KV[pkg].MemKVStore(wal_path=str(d / "wal"))
        if pkg == "port":
            assert (nativeext.calls["upsert_cells"] > before) == c
        out[pkg, c] = (_state(again), _stamps(again),
                       list(again.scan_raw(T, b"", b"")))
        again.close()
    ref = out["jax", False]
    for way, got in out.items():
        assert got == ref, way


def test_all_tombstone_row_is_the_one_existed_difference(
        tmp_path, monkeypatch, jax_native):
    """A live row whose every cell is a tombstone, for a key outside every
    generation's range: the C upsert reports existed=True, the exact
    probe False (in both packages). The stored bytes are the same."""
    out = {}
    for pkg, c in WAYS:
        _use_way(monkeypatch, jax_native, pkg, c)
        wal = str(tmp_path / f"{pkg}{int(c)}" / "wal")
        os.makedirs(os.path.dirname(wal))
        store = KV[pkg].MemKVStore(wal_path=wal)
        store.put(T, _key(0, 1), F, b"\x00\x01", b"a")
        store.checkpoint()
        k = _key(5, 5)
        t = store._table(T)
        t.rows[k] = {(F, b"\x00\x01"): None}   # the corner's state
        t.tombs += 1
        existed = store.put_many_columnar(T, F, k + _key(4, 4), 13,
                                          [b"\x00\x02", b"\x00\x03"],
                                          [b"x", b"y"])
        out[pkg, c] = (existed, _state(store), open(wal, "rb").read())
        store.close()
    for pkg, c in WAYS:
        assert out[pkg, c][0] == [c, False]
        assert out[pkg, c][1:] == out["jax", False][1:]


@pytest.mark.parametrize("dups", [False, True])
def test_throttle_trip_mid_batch_raises_with_partial_existed(
        tmp_path, monkeypatch, jax_native, dups):
    """A batch that can cross throttle_rows never takes the C pass: the
    per-cell loop applies its prefix and raises with partial_existed,
    the same four ways, WAL bytes included."""
    out, stamps = {}, {}
    for pkg, c in WAYS:
        _use_way(monkeypatch, jax_native, pkg, c)
        wal = str(tmp_path / f"{pkg}{int(c)}" / "wal")
        os.makedirs(os.path.dirname(wal))
        store = KV[pkg].MemKVStore(wal_path=wal, throttle_rows=6)
        store.put(T, _key(0, 1), F, b"\x00\x01", b"a")
        keys = [_key(0, 1)] + [_key(1, h) for h in range(1, 9)]
        if dups:
            keys = keys[:3] + keys
        before = nativeext.calls["upsert_cells"]
        with pytest.raises((JaxThrottle, PleaseThrottleError)) as ei:
            store.put_many_columnar(
                T, F, b"".join(keys), 13,
                [b"\x00%c" % (16 * (i + 1)) for i in range(len(keys))],
                [b"x"] * len(keys))
        assert nativeext.calls["upsert_cells"] == before
        out[pkg, c] = (ei.value.partial_existed, str(ei.value),
                       _state(store), open(wal, "rb").read())
        stamps[pkg, c] = _stamps(store)
        store.close()
    assert 0 < len(out["jax", False][0]) < (12 if dups else 9)
    _assert_four_ways(out, stamps)


# ---------------------------------------------------------------------------
# storage/sstable.py and the checkpoint
# ---------------------------------------------------------------------------

def _parts(seed=5):
    """Three ingest parts of 12 series over 6 hours (sys.cpu.user floats,
    net.bytes integers); host h5 first appears in part 1, so the second
    checkpoint mints UIDs too."""
    rng = np.random.default_rng(seed)
    parts = [[], [], []]
    for h in range(6):
        tags = {"host": f"h{h}", "dc": "east" if h % 2 else "west"}
        for metric, n in (("sys.cpu.user", 300), ("net.bytes", 80)):
            ts = BT + np.sort(rng.choice(6 * 3600, n, replace=False))
            vals = (rng.normal(50, 10, n) if metric == "sys.cpu.user"
                    else np.cumsum(rng.integers(0, 1000, n)))
            part = np.minimum(ts - BT, 6 * 3600 - 1) // 7200
            part = np.maximum(part, 1 if h == 5 else 0)
            for i in range(3):
                m = part == i
                if m.any():
                    parts[i].append((metric, tags, ts[m], vals[m]))
    return parts


def _tsdb(pkg, wal):
    if pkg == "jax":
        return JaxTSDB(jax_kv.MemKVStore(wal_path=wal),
                       JaxConfig(auto_create_metrics=True,
                                 device_window=False),
                       start_compaction_thread=False)
    return TSDB(port_kv.MemKVStore(wal_path=wal),
                Config(auto_create_metrics=True, device="cpu",
                       device_window=False),
                start_compaction_thread=False)


def test_checkpoints_byte_identical_four_ways(tmp_path, monkeypatch,
                                              jax_native):
    """TSDB.add_batch of the same parts, a checkpoint after each of the
    first two: the WAL before each checkpoint, both generations and the
    manifest are byte-identical four ways; the port's C path framed both
    checkpoints in C."""
    parts = _parts()
    out = {}
    for pkg, c in WAYS:
        _use_way(monkeypatch, jax_native, pkg, c)
        wal = str(tmp_path / f"{pkg}{int(c)}" / "wal")
        os.makedirs(os.path.dirname(wal))
        tsdb = _tsdb(pkg, wal)
        before = nativeext.calls["frame_rows_dict"]
        got = []
        for i, part in enumerate(parts):
            for metric, tags, ts, vals in part:
                tsdb.add_batch(metric, ts, vals, tags)
            got.append(open(wal, "rb").read())
            if i < 2:
                tsdb.checkpoint()
                got.append(_dir_bytes(wal))
        if pkg == "port":
            assert nativeext.calls["frame_rows_dict"] - before == (
                4 if c else 0)       # two tables, two checkpoints
        tsdb.compactionq.shutdown()
        tsdb.store.close()
        out[pkg, c] = got
    ref = out["jax", False]
    assert len(ref[3]) == 3          # two generations and the manifest
    for way, got in out.items():
        assert got == ref, way


def _seeded_tables(seed=0, n=300):
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


def _frozen(seed, tombstones):
    """A frozen tier over _seeded_tables: overwrites of spilled keys and
    frozen-only rows, with cell and row tombstones or without."""
    rng = np.random.default_rng(seed)
    keys = _seeded_tables()[T][0]
    rows, tombs = {}, set()
    for k in rng.choice(len(keys), 40, replace=False).tolist():
        r = rng.random()
        if tombstones and r < 0.3:
            tombs.add(keys[k])
        elif tombstones and r < 0.6:
            rows[keys[k]] = {(F, b"\x00\x01"): None,
                             (F, b"\x7f\x7f"): b"new"}
        else:
            rows[keys[k]] = {(F, b"\x00\x02"): b"over"}
    for _ in range(30):
        k = rng.integers(0, 256, 13, np.uint8).tobytes()
        cells = {(F, b"\x00\x03"): b"fresh"}
        if rng.random() < 0.3:
            cells[(F, b"\x00\x00")] = b"two"
        rows.setdefault(k, cells)
    return {T: (rows, tombs, tombstones)}


@pytest.mark.parametrize("tombstones", [False, True])
def test_merge_byte_identical_four_ways(tmp_path, monkeypatch, jax_native,
                                        tombstones):
    """Two overlapping generations and a frozen tier through the
    copy-merge; without tombstones the frozen-only rows are C-framed."""
    g1, g2 = _seeded_tables(0), _seeded_tables(0, n=120)
    out = {}
    for pkg, c in WAYS:
        _use_way(monkeypatch, jax_native, pkg, c)
        sst = SST[pkg]
        d = tmp_path / f"{pkg}{int(c)}"
        d.mkdir()
        paths = [str(d / f"g{i}") for i in (1, 2)]
        sst.write_sstable_bulk(paths[0], g1)
        sst.write_sstable_bulk(paths[1], g2)
        gens = [sst.SSTable(p) for p in paths]
        before = nativeext.calls["frame_rows_dict"]
        n = sst.merge_sstables(str(d / "merged"), gens,
                               _frozen(1, tombstones))
        if pkg == "port":
            assert nativeext.calls["frame_rows_dict"] - before == int(
                c and not tombstones)
        for g in gens:
            g.close()
        out[pkg, c] = (n, open(d / "merged", "rb").read(),
                       open(paths[0], "rb").read())
    ref = out["jax", False]
    for way, got in out.items():
        assert got == ref, way


def test_a_table_with_no_rows_differs_between_c_and_python(
        tmp_path, monkeypatch, jax_native):
    """Both packages' C framers keep an empty table as a zero-key footer
    entry with an empty bloom; both Python writers leave it out. Each
    pair of like writers is byte-identical, and every reader reads the
    same rows and tables from both files."""
    tables = {"a": ([], {}), T: (_seeded_tables()[T][0], {
        k: {(f, q): v for f, q, v in c}
        for k, c in zip(*_seeded_tables()[T])})}
    out = {}
    for pkg, c in WAYS:
        _use_way(monkeypatch, jax_native, pkg, c)
        path = str(tmp_path / f"{pkg}{int(c)}.sst")
        SST[pkg].write_sstable_bulk(path, tables)
        out[pkg, c] = open(path, "rb").read()
    assert out["port", True] == out["jax", True]
    assert out["port", False] == out["jax", False]
    assert out["port", True] != out["port", False]
    reads = set()
    for pkg, c in WAYS:
        for sst in SST.values():
            r = sst.SSTable(str(tmp_path / f"{pkg}{int(c)}.sst"))
            reads.add(repr((r.scan_keys(T, b"", b"\xff" * 14),
                            [r.get(T, k) for k in tables[T][0]],
                            r.scan_keys("a", b"", b"\xff"))))
            r.close()
    assert len(reads) == 1


# ---------------------------------------------------------------------------
# server/wire.py: the telnet decoder
# ---------------------------------------------------------------------------

def _mixed_lines(seed=7, n=600):
    """Good put lines (ints, floats, exponents, unsorted and repeated
    tags, CRLF, extra spaces) mixed with bad ones of every kind."""
    rng = np.random.default_rng(seed)
    bad = ["put", "put m 1", "get m 1 1 a=b", "put m! 1 1 a=b",
           "put m x 1 a=b", "put m 0 1 a=b", "put m 99999999999 1 a=b",
           "put m 1 1 a", "put m 1 1 =b", "put m 1 1 a=", "put m 1 1 a=b a=c",
           "put m 1 nan a=b", "put m 1 1e a=b", "put m 1 0x10 a=b",
           "put m 1 1_0 a=b", "put m 1 1 a=b$", "put m 1 inf a=b",
           "put m 1 99999999999999999999 a=b"]
    lines = []
    for i in range(n):
        r = rng.random()
        if r < 0.15:
            lines.append(bad[int(rng.integers(len(bad)))])
            continue
        ts = BT + int(rng.integers(0, 7200))
        kind = int(rng.integers(0, 4))
        v = (str(int(rng.integers(-10 ** 6, 10 ** 6))) if kind == 0
             else f"{rng.normal(0, 100):.4f}" if kind == 1
             else f"{rng.normal(0, 1):.3e}" if kind == 2 else "-.5")
        tags = [f"host=h{int(rng.integers(0, 5))}",
                f"dc=d{int(rng.integers(0, 2))}"]
        if rng.random() < 0.5:
            tags.reverse()
        if rng.random() < 0.1:
            tags.append(tags[0])
        sep = "  " if rng.random() < 0.05 else " "
        line = sep.join(["put", f"m.{int(rng.integers(0, 3))}", str(ts), v]
                        + tags)
        if rng.random() < 0.05:
            line += "\r"
        lines.append(line)
    return ("\n".join(lines) + "\nput m.0 " + str(BT)).encode()


def test_decode_puts_native_equals_python(monkeypatch, jax_native):
    """Over mixed good and bad lines (and an unterminated tail): the
    port's native decoder gives the numpy decoder's points and series and
    the same number of errors; it gives the JAX native decoder's whole
    output, errors included, and the numpy decoder the JAX numpy
    decoder's."""
    buf = _mixed_lines()
    use(monkeypatch, jax_native, True, True)
    before = nativeext.calls["tsd_parse"]
    nat = port_wire.decode_puts(buf)
    assert nativeext.calls["tsd_parse"] == before + 1
    py = port_wire.decode_puts(buf, use_native=False, line_base=3)
    jnat = jax_wire.decode_puts(buf)
    jpy = jax_wire.decode_puts(buf, use_native=False, line_base=3)
    for a, b in ((nat, py), (nat, jnat), (py, jpy)):
        for x, y in zip(a[:5], b[:5]):
            np.testing.assert_array_equal(x, y)
            assert x.dtype == y.dtype
        assert a.series == b.series
        assert a.consumed == b.consumed == buf.rfind(b"\n") + 1
        assert len(a.errors) == len(b.errors)
    assert nat.errors == jnat.errors and list(nat.error_lines) == []
    assert py.errors == jpy.errors
    assert list(py.error_lines) == list(jpy.error_lines)
    assert len(nat.timestamps) > 300 and len(nat.errors) > 40
    # The native decoder names a series' tags in sorted order.
    assert all(list(tags) == sorted(tags) for _, tags in nat.series)
