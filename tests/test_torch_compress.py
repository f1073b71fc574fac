"""The port's compressed blocks (opentsdb_tpu_torch/compress/, format v4 of
storage/sstable.py and the fused plan of query/executor.py) against the
JAX package's.

Contracts:
- codecs: encode_block, encode_block_split, decode_block and
  parse_ts_block give the JAX package's bytes and fields on the fixtures
  of tests/test_compress.py, and raise where it raises;
- TSST4 files: the same rows give byte-identical v4 generations with the
  encode pool off and on, merges across formats are byte-identical, each
  package opens, spills into, merges and fscks the other's 1- and 4-shard
  v4 stores with the same rows and counts, and a corrupt block is counted
  alike;
- decode_points: bit-identical to the JAX function (jitted on the CPU) on
  rel_ts and the value bits, both value kinds, streams whose running sums
  overflow int32, both padding layouts, an empty payload, and the layouts
  whose lookups cross the card kernel's 4,096-point tiles (records of
  3,600 points, first_idx more than a tile back, starts on tile edges,
  n one off a multiple of the tile);
- the five stage functions on one gather: grids and masks exact, count /
  min / max exact, sums, averages and deviations within rtol 1e-5 (the
  executor's float32 contract, opentsdb_tpu/query/executor.py:16-18);
- the executors: the same battery served plan "fused" by both (answers
  within that contract), the port's fused answers equal to its own raw
  answers, and every decline reason and compress.* counter delta equal to
  the JAX package's on the shared scenarios.

Both packages run on their Python storage paths (the JAX package has no
native build here), the port on the CPU (``device="cpu"``: the decode
kernel's plain version).
"""

import os
import shutil

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import opentsdb_tpu.compress.codecs as jax_codecs
import opentsdb_tpu.compress.kernels as jax_ck
import opentsdb_tpu.storage.sstable as jax_sst
import opentsdb_tpu_torch.compress.codecs as port_codecs
import opentsdb_tpu_torch.compress.kernels as port_ck
import opentsdb_tpu_torch.storage.sstable as port_sst
from opentsdb_tpu.compress import fused as jax_fused
from opentsdb_tpu.compress.devcache import DeviceBlockCache as JaxCache
from opentsdb_tpu.core.tsdb import TSDB as JaxTSDB
from opentsdb_tpu.obs.registry import METRICS as JAX_METRICS
from opentsdb_tpu.query.executor import QueryExecutor as JaxExecutor
from opentsdb_tpu.query.executor import QuerySpec as JaxSpec
from opentsdb_tpu.storage.kv import MemKVStore as JaxMem
from opentsdb_tpu.storage.sharded import ShardedKVStore as JaxSharded
from opentsdb_tpu.tools.fsck import run_fsck as jax_fsck
from opentsdb_tpu.utils.config import Config as JaxConfig
from opentsdb_tpu_torch.compress.devcache import DeviceBlockCache
from opentsdb_tpu_torch.core.tsdb import TSDB
from opentsdb_tpu_torch.obs.registry import METRICS as PORT_METRICS
from opentsdb_tpu_torch.ops.block_decode import decode_points
from opentsdb_tpu_torch.query.executor import QueryExecutor, QuerySpec
from opentsdb_tpu_torch.storage.kv import MemKVStore
from opentsdb_tpu_torch.storage.sharded import ShardedKVStore
from opentsdb_tpu_torch.tools.fsck import run_fsck as port_fsck
from opentsdb_tpu_torch.utils.config import Config
import test_compress as jax_tests
from test_compress import build_run, data_key, float_cell, frame, int_cell

BASE = 1356998400
CODECS = {"jax": jax_codecs, "port": port_codecs}
SSTS = {"jax": jax_sst, "port": port_sst}


@pytest.fixture(autouse=True)
def _python_paths(monkeypatch):
    """Both packages on their Python storage paths, the encode pool in
    its default (off) state afterwards."""
    from test_torch_native import use
    use(monkeypatch, (None, None), False, False)
    yield
    jax_sst.set_encode_workers(0)
    port_sst.set_encode_workers(0)


# ---------------------------------------------------------------------------
# Codecs
# ---------------------------------------------------------------------------

def _codec_fixture(name):
    """(raw, offs) of tests/test_compress.py's codec fixtures, seeded."""
    if name == "float":
        rng = np.random.default_rng(3)
        rows = []
        for r in range(120):
            n = int(rng.integers(1, 12))
            deltas = np.sort(rng.choice(3600, n, replace=False)).tolist()
            vals = np.cumsum(rng.normal(0, 1, n)) + 100
            rows.append(frame("tsdb", data_key(1, BASE + r * 3600,
                                               (r % 9) + 1),
                              [(b"t",) + float_cell(deltas, vals)]))
        return build_run(rows)
    if name == "int_widths":
        rows = []
        for r, vals in enumerate([[0], [127, -128], [200, -32768, 32767],
                                  [2**31 - 1, -2**31, 5],
                                  [2**62, -2**62, 1, -1]]):
            deltas = list(range(0, 300 * len(vals), 300))
            rows.append(frame("tsdb", data_key(1, BASE + r * 3600, 1),
                              [(b"t",) + int_cell(deltas, vals)]))
        return build_run(rows)
    if name == "foreign":
        rows = [frame("tsdb-uid", b"name%03d" % i,
                      [(b"id", b"metrics", bytes([0, 0, i & 0xFF])),
                       (b"id", b"tagk", bytes([0, 1, i & 0xFF]))])
                for i in range(30)]
        return build_run(rows)
    if name == "verbatim":
        rng = np.random.default_rng(4)
        raw = frame("x", rng.bytes(16), [(b"f", rng.bytes(64),
                                          rng.bytes(512))])
        return raw, np.array([0])
    if name == "mixed":
        q1, v1 = float_cell([100], [1.5])
        q2, v2 = int_cell([200], [42])
        return build_run([frame("tsdb", data_key(1, BASE, 1),
                                [(b"t", q1 + q2, v1 + v2[:1] + b"\x00")])])
    rng = np.random.default_rng(5)
    return build_run([frame("tsdb", data_key(1, BASE + r * 3600, 1),
                            [(b"t",) + float_cell(list(range(0, 600, 60)),
                                                  rng.normal(100, 1, 10))])
                      for r in range(10)])


_TS_FIELDS = ("tag", "n", "P", "table", "fam", "klen", "kpre", "npts",
              "first_pt", "rec_of_pt", "within", "ts_nb", "ts_pay", "v_nb",
              "v_pay", "K")


def _same_ts_block(a, b):
    for f in _TS_FIELDS:
        x, y = getattr(a, f), getattr(b, f)
        if isinstance(x, np.ndarray) or isinstance(y, np.ndarray):
            assert (x is None) == (y is None), f
            if x is not None:
                assert np.array_equal(np.asarray(x), np.asarray(y)), f
        else:
            assert x == y, f


@pytest.mark.parametrize("name", ["float", "int_widths", "foreign",
                                  "verbatim", "mixed", "truncated"])
def test_codecs_byte_equal(name):
    raw, offs = _codec_fixture(name)
    tag, enc = port_codecs.encode_block(raw, offs)
    assert (tag, enc) == jax_codecs.encode_block(raw, offs)
    assert port_codecs.encode_block_split(raw, offs) \
        == jax_codecs.encode_block_split(raw, offs)
    assert port_codecs.decode_block(tag, enc, len(raw)) == raw
    want_tag = {"float": jax_codecs.TSF32, "int_widths": jax_codecs.TSINT,
                "truncated": jax_codecs.TSF32}.get(name)
    if want_tag is not None:
        assert tag == want_tag
    if tag in (jax_codecs.TSF32, jax_codecs.TSINT):
        for keys_only in (False, True):
            _same_ts_block(
                port_codecs.parse_ts_block(tag, enc, keys_only=keys_only),
                jax_codecs.parse_ts_block(tag, enc, keys_only=keys_only))
    if name == "truncated":
        for mod in CODECS.values():
            with pytest.raises(mod.BlockCodecError):
                mod.decode_block(tag, enc[:len(enc) // 2], len(raw))
            with pytest.raises(mod.BlockCodecError):
                mod.parse_ts_block(tag, enc[:len(enc) // 2])


def test_codecs_unknown_tag_and_size_mismatch_raise_alike():
    raw = frame("tsdb", data_key(1, BASE, 1),
                [(b"t",) + float_cell([5], [1.0])])
    tag, enc = port_codecs.encode_block(raw, [0])
    for mod in CODECS.values():
        with pytest.raises(mod.BlockCodecError):
            mod.decode_block(99, enc, len(raw))
        with pytest.raises(mod.BlockCodecError):
            mod.decode_block(tag, enc, len(raw) + 1)
    assert port_codecs.SELF_CHECK is True
    assert port_codecs.CODEC_NAMES == jax_codecs.CODEC_NAMES


# ---------------------------------------------------------------------------
# TSST4 files
# ---------------------------------------------------------------------------

def _v4_rows(seed=5, n=3000):
    return jax_tests.TestSSTableV4()._rows(seed=seed, n=n)


@pytest.mark.parametrize("workers", [0, 2])
def test_v4_files_byte_identical(tmp_path, workers):
    """write_sstable and write_sstable_bulk, both packages, the encode
    pool off (0) and on (2): one set of bytes, several blocks."""
    rows = _v4_rows()
    out = {}
    for name, mod in SSTS.items():
        mod.set_encode_workers(workers)
        p = str(tmp_path / f"{name}-stream")
        mod.write_sstable(p, iter(rows), codec="tsst4")
        out[name] = open(p, "rb").read()
        tables: dict = {}
        for t, k, c in rows:
            keys, cells = tables.setdefault(t, ([], []))
            keys.append(k)
            cells.append(c)
        pb = str(tmp_path / f"{name}-bulk")
        mod.write_sstable_bulk(pb, tables, codec="tsst4")
        assert open(pb, "rb").read() == out[name]
    assert out["port"] == out["jax"]
    s = port_sst.SSTable(str(tmp_path / "jax-stream"))
    try:
        assert s.format == 4 and s.block_count > 1
        raw, enc = s.codec_stats()
        assert raw > enc > 0
        assert s.block_audit() == 0
    finally:
        s.close()


@pytest.mark.parametrize("src_codec,out_codec", [
    ("none", "tsst4"), ("tsst4", "none"), ("tsst4", "tsst4")])
def test_merge_across_formats_byte_identical(tmp_path, src_codec,
                                             out_codec):
    """merge_sstables re-encodes v3 <-> v4 with a frozen overlay: the
    port's output equals the JAX package's byte for byte, and each
    package reads the other's output row for row."""
    rows = _v4_rows(seed=9, n=1500)
    src = str(tmp_path / "src")
    jax_sst.write_sstable(src, iter(rows),
                          codec=None if src_codec == "none" else src_codec)
    frozen = {"tsdb": ({rows[5][1]: {(b"t", b"\x01\x00"): b"\x07"},
                        rows[9][1]: {(b"t", b"\x02\x00"): None}},
                       set(), True)}
    outs = {}
    for name, mod in SSTS.items():
        g = mod.SSTable(src)
        p = str(tmp_path / f"m-{name}")
        mod.merge_sstables(p, [g], dict(frozen),
                           codec=None if out_codec == "none" else out_codec)
        g.close()
        outs[name] = p
    assert open(outs["port"], "rb").read() == open(outs["jax"], "rb").read()
    a, b = port_sst.SSTable(outs["jax"]), jax_sst.SSTable(outs["port"])
    try:
        assert a.format == (4 if out_codec == "tsst4" else 3)
        for t in b.tables():
            assert list(a.iter_rows_range(t, b"", None)) \
                == list(b.iter_rows_range(t, b"", None))
            keys = b._index[t][0]
            for k in keys[::37]:
                assert a.get(t, k) == b.get(t, k)
    finally:
        a.close()
        b.close()


def test_block_audit_counts_corruption_alike(tmp_path):
    rows = _v4_rows(seed=21, n=1500)
    p = str(tmp_path / "g4")
    port_sst.write_sstable(p, iter(rows), codec="tsst4")
    s = port_sst.SSTable(p)
    _tag, _raw_len, enc_len = s.block_header(0)
    mid = s._blk_file[0] + 9 + enc_len // 2
    hdr = s._blk_file[1] + 1
    s.close()
    data = bytearray(open(p, "rb").read())
    data[mid] ^= 0xFF      # inside block 0's payload
    data[hdr] ^= 0xFF      # block 1's header raw_len
    open(p, "wb").write(bytes(data))
    got = {}
    for name, mod in SSTS.items():
        g = mod.SSTable(p)
        msgs = []
        got[name] = (g.block_audit(msgs.append), len(msgs))
        g.close()
    assert got["port"] == got["jax"]
    assert got["port"][0] >= 1


# ---------------------------------------------------------------------------
# Stores crossing between the packages
# ---------------------------------------------------------------------------

def _cfg(**kw):
    return {**dict(auto_create_metrics=True, enable_sketches=False,
                   device_window=False, sstable_codec="tsst4"), **kw}


def _jax_tsdb(path, shards, **kw):
    store = (JaxSharded(path, shards=shards) if shards > 1
             else JaxMem(wal_path=os.path.join(path, "wal")))
    return JaxTSDB(store, JaxConfig(**_cfg(**kw)),
                   start_compaction_thread=False)


def _port_tsdb(path, shards, **kw):
    store = (ShardedKVStore(path, shards=shards) if shards > 1
             else MemKVStore(wal_path=os.path.join(path, "wal")))
    return TSDB(store, Config(device="cpu", **_cfg(**kw)),
                start_compaction_thread=False)


OPEN = {"jax": _jax_tsdb, "port": _port_tsdb}


def _ingest(t, blk, float_series=6, int_series=3, seed=11):
    """One 4-hour slab: float series (TSF32 blocks) and integer series
    (TSINT blocks), seeded."""
    rng = np.random.default_rng(seed + blk)
    for si in range(float_series):
        ts = BASE + blk * 4 * 3600 \
            + np.arange(0, 4 * 3600, 300, dtype=np.int64) + si
        t.add_batch("m.cpu", ts, np.cumsum(rng.normal(0, 1, len(ts))) + 50,
                    {"host": f"h{si}", "dc": "e" if si % 2 else "w"})
    for si in range(int_series):
        ts = BASE + blk * 4 * 3600 \
            + np.arange(0, 4 * 3600, 600, dtype=np.int64) + si
        t.add_batch("m.int", ts, rng.integers(-500, 5000, len(ts)),
                    {"host": f"h{si}"})


def _rows(store):
    return {tb: list(store.scan_raw(tb, b"", b""))
            for tb in ("tsdb", "tsdb-uid")}


def _fsck_counts(rep):
    return (rep.errors, rep.rows, rep.kvs, rep.blocks, rep.codec_errors,
            rep.codec_counts, rep.format_counts)


@pytest.mark.parametrize("shards", [1, 4])
@pytest.mark.parametrize("writer", ["jax", "port"])
def test_store_crosses_packages(tmp_path, writer, shards):
    """One package ingests and checkpoints twice (two v4 generations per
    shard); the other opens the directory (same rows, same fsck counts),
    spills into it and merges it (a full merge: a row tombstone), and the
    first reopens the result: the same rows again, every generation v4."""
    reader = "port" if writer == "jax" else "jax"
    d = str(tmp_path / "store")
    w = OPEN[writer](d, shards)
    for blk in range(3):
        _ingest(w, blk)
        if blk:
            w.checkpoint()
    want = _rows(w.store)
    w.shutdown()
    copy = str(tmp_path / "copy")
    shutil.copytree(d, copy)
    r = OPEN[reader](d, shards)
    r2 = OPEN[writer](copy, shards)
    try:
        assert _rows(r.store) == want
        fr = (port_fsck if reader == "port" else jax_fsck)(r)
        fw = (port_fsck if writer == "port" else jax_fsck)(r2)
        assert _fsck_counts(fr) == _fsck_counts(fw)
        assert fr.errors == 0 and fr.blocks > 0
        assert set(fr.format_counts) == {4}
        assert {"tsf32", "tsint"} <= set(fr.codec_counts)
    finally:
        r2.shutdown()
    _ingest(r, 3)
    r.checkpoint()
    key = r.row_key_for("m.cpu", {"host": "h1", "dc": "e"}, BASE + 3600,
                        create_metric=False, create_tags=False)
    r.store.delete_row(r.table, key)
    r.checkpoint()
    want = _rows(r.store)
    assert r.store.compress_stats()[0] > r.store.compress_stats()[1] > 0
    r.shutdown()
    w = OPEN[writer](d, shards)
    try:
        assert _rows(w.store) == want
        assert set(w.store.sstable_format_bytes()) == {4}
    finally:
        w.shutdown()


def test_checkpoint_generations_byte_identical(tmp_path):
    """The same batches through both TSDBs (codec tsst4, pool on): the
    spilled and merged generation files and manifests are equal."""
    out = {}
    for name in ("jax", "port"):
        d = str(tmp_path / name)
        t = OPEN[name](d, 1, spill_encode_workers=2)
        for blk in range(3):
            _ingest(t, blk)
            t.checkpoint()
        key = t.row_key_for("m.cpu", {"host": "h3", "dc": "e"}, BASE,
                            create_metric=False, create_tags=False)
        t.store.delete_row(t.table, key)
        t.checkpoint()
        t.shutdown()
        out[name] = {fn: open(os.path.join(d, fn), "rb").read()
                     for fn in sorted(os.listdir(d)) if ".sst" in fn}
    assert out["port"] == out["jax"]
    assert any(v.startswith(b"TSST4") for v in out["port"].values())


def test_fsck_counts_codec_errors_alike(tmp_path):
    d = str(tmp_path / "s")
    t = _jax_tsdb(d, 1)
    for blk in range(2):
        _ingest(t, blk)
    t.checkpoint()
    sst = t.store._ssts[-1]
    pos = sst._blk_file[0] + 1   # the header's raw_len
    path = sst.path
    t.shutdown()
    data = bytearray(open(path, "rb").read())
    data[pos] ^= 0xFF
    open(path, "wb").write(bytes(data))
    reps = {}
    for name, fsck in (("jax", jax_fsck), ("port", port_fsck)):
        t = OPEN[name](d, 1)
        try:
            reps[name] = _fsck_counts(fsck(t))
        finally:
            t.compactionq.shutdown()
            t.store.close()
    assert reps["port"] == reps["jax"]
    assert reps["port"][4] >= 1


# ---------------------------------------------------------------------------
# decode_points
# ---------------------------------------------------------------------------

def _stream(rng, P, pad=0, pad_layout="bytes", scalar_base=False,
            rec=None, blk_recs=5):
    """A seeded decode input (random byte counts and payload bytes, so the
    running sums wrap and the value words take every float32 bit
    pattern), records of random length (or of ``rec`` points each),
    blocks of ``blk_recs`` records, and ``pad`` padding points in the
    byte-stream layout (first_idx = blk_first = 0) or the device cache's
    (each pointing at itself)."""
    ts_nb = rng.integers(0, 5, P).astype(np.int32)
    v_nb = rng.integers(0, 5, P).astype(np.int32)
    if rec is None:
        starts = np.sort(rng.choice(P, min(P, max(P // 20, 1)),
                                    replace=False))
    else:
        starts = np.arange(0, P, rec)
    starts[0] = 0
    first = starts[np.searchsorted(starts, np.arange(P), "right") - 1]
    bstarts = starts[::blk_recs]
    blk = bstarts[np.searchsorted(bstarts, np.arange(P), "right") - 1]
    pad_idx = (np.zeros(pad, np.int64) if pad_layout == "bytes"
               else np.arange(P, P + pad))
    ts_nb = np.concatenate([ts_nb, np.zeros(pad, np.int32)])
    v_nb = np.concatenate([v_nb, np.zeros(pad, np.int32)])
    ts_pay = rng.integers(0, 256, int(ts_nb.sum()) + 3).astype(np.uint8)
    v_pay = rng.integers(0, 256, int(v_nb.sum())).astype(np.uint8)
    n = P + pad
    base = (np.int32(rng.integers(-2**31, 2**31)) if scalar_base else
            rng.integers(-2**31, 2**31, n).astype(np.int32))
    return [ts_nb, ts_pay, v_nb, v_pay,
            np.concatenate([first, pad_idx]).astype(np.int32),
            np.concatenate([blk, pad_idx]).astype(np.int32), base]


def _decode_both(args, vkind, port_args=None):
    jr, jv = jax_ck.decode_points_jit(*[jnp.asarray(a) for a in args],
                                      vkind=vkind)
    pa = args if port_args is None else port_args
    pr, pv = decode_points(
        *[torch.from_numpy(np.asarray(a)) if np.ndim(a) else int(a)
          for a in pa], vkind=vkind)
    jr, jv = np.asarray(jr), np.asarray(jv)
    assert np.array_equal(pr.numpy(), jr)
    assert np.array_equal(pv.numpy().view(np.uint32), jv.view(np.uint32))
    return jr, jv


@pytest.mark.parametrize("vkind", ["f32", "int"])
@pytest.mark.parametrize("case", ["wrap", "bytes_padding",
                                  "devcache_padding", "scalar_base"])
def test_decode_points_bit_identical(case, vkind):
    rng = np.random.default_rng(len(case) + 7)
    kw = {"wrap": dict(P=4000), "bytes_padding": dict(P=3000, pad=500),
          "devcache_padding": dict(P=3000, pad=500, pad_layout="self"),
          "scalar_base": dict(P=2000, scalar_base=True)}[case]
    args = _stream(rng, **kw)
    jr, jv = _decode_both(args, vkind)
    if case == "wrap":
        # The global running sums really wrap: the timestamp entries'
        # int64 prefix sum leaves int32.
        nb = args[0].astype(np.int64)
        off = np.cumsum(nb) - nb
        z = np.zeros(len(nb), np.int64)
        for j in range(4):
            byte = args[1][np.minimum(off + j, len(args[1]) - 1)]
            z |= np.where(j < nb, byte.astype(np.int64)
                          << np.maximum(8 * (nb - 1 - j), 0), 0)
        ent = (z >> 1) ^ -(z & 1)
        assert np.abs(np.cumsum(ent)).max() > 2**31
        assert np.isnan(jv).any() or vkind == "int"
    if case == "devcache_padding":
        P = kw["P"]
        assert not jv[P:].any() and not (jr[P:] - args[6][P:]).any()


TILE = 4096  # the decode kernel's tile (csrc/block_decode.cu kTile)

TILE_LAYOUTS = {
    # 1-second records (3,600 points) spanning several tiles, 2 a block.
    "long_records": dict(P=4 * 3600 + 11, rec=3600, blk_recs=2, pad=300),
    # first_idx and blk_first more than one tile back, device-cache
    # padding.
    "first_idx_far": dict(P=6 * (2 * TILE + 3), rec=2 * TILE + 3,
                          blk_recs=1, pad=77, pad_layout="self"),
    # record and block starts exactly on tile edges.
    "tile_edges": dict(P=6 * TILE, rec=TILE, blk_recs=2, pad=TILE),
}
# n = k * tile - 1, k * tile, k * tile + 1 in both padding layouts.
for _d in (-1, 0, 1):
    for _lay in ("bytes", "self"):
        TILE_LAYOUTS[f"n_3tile{_d:+d}_{_lay}"] = dict(
            P=3 * TILE + _d - 40, pad=40, pad_layout=_lay,
            rec=TILE // 3 + 5)


@pytest.mark.parametrize("vkind", ["f32", "int"])
@pytest.mark.parametrize("case", list(TILE_LAYOUTS))
def test_decode_points_tile_layouts(case, vkind):
    """The layouts whose lookups cross the kernel's tiles: the plain
    version against the JAX function, bit for bit."""
    kw = TILE_LAYOUTS[case]
    args = _stream(np.random.default_rng(sum(map(ord, case))), **kw)
    n = kw["P"] + kw.get("pad", 0)
    assert len(args[0]) == n
    first = args[4]
    if case == "first_idx_far":
        assert (np.arange(n) - first).max() > TILE
    if case == "tile_edges":
        assert np.all(np.unique(first)[1:] % TILE == 0)
    _decode_both(args, vkind)


@pytest.mark.parametrize("vkind", ["f32", "int"])
def test_decode_points_empty_payload(vkind):
    """A gather without payload bytes: the executor pads the buffers to
    one zero byte (JAX's gather refuses an empty operand); the port's
    kernel also takes the empty buffers as they are, with the same
    output."""
    z = np.zeros(6, np.int32)
    one = np.zeros(1, np.uint8)
    empty = np.zeros(0, np.uint8)
    for nb in (z, z + 2):
        args = [nb, one, nb, one, z, z, np.int32(7)]
        _decode_both(args, vkind, port_args=[nb, empty, nb, empty, z, z,
                                             np.int32(7)])


def _real_gather(tmp_path, metric="m.cpu", tags=None):
    """A JAX v4 store and the JAX gather of its metric over the day, with
    the selector of ``tags`` pushed down when given."""
    t = _jax_tsdb(str(tmp_path / "g"), 1)
    for blk in range(3):
        _ingest(t, blk)
    t.checkpoint()
    uid = t.metrics.get_id(metric)
    selector = None
    if tags is not None:
        ex = JaxExecutor(t, backend="tpu")
        selector = ex._series_selector(*ex._tag_filters(tags))
    src = jax_fused.gather(t.store, t.table, uid, BASE, BASE + 11 * 3600,
                           selector=selector)
    return t, src


@pytest.mark.parametrize("metric", ["m.cpu", "m.int"])
def test_decode_points_on_real_blocks(tmp_path, metric):
    t, src = _real_gather(tmp_path, metric)
    try:
        assert src.kind == ("f32" if metric == "m.cpu" else "int")
        _decode_both([src.ts_nb, src.ts_pay, src.v_nb, src.v_pay,
                      src.first_idx, src.blk_first,
                      src.rel_base_pt.astype(np.int32)], src.kind)
    finally:
        t.shutdown()


# ---------------------------------------------------------------------------
# The stage functions on one gather
# ---------------------------------------------------------------------------

def _close(got, want, exact):
    got = got.numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    if exact:
        assert np.array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("agg_down", ["sum", "avg", "min", "max", "count",
                                      "dev"])
@pytest.mark.parametrize("leg", ["bytes", "bytes_sel", "devcache",
                                 "devcache_sel"])
def test_stage_functions_match_jax(tmp_path, leg, agg_down):
    """One gather through the JAX stage function and the port's, as the
    executors call them: masks, in_range and presence exact; values exact
    for count / min / max, within rtol 1e-5 otherwise."""
    from opentsdb_tpu.compress.devcache import pad_fine
    t, src = _real_gather(
        tmp_path, tags={"dc": "e"} if leg.endswith("sel") else None)
    try:
        S_pad = 16
        nb = 16
        iv = 3600
        lo, hi, shift = 100, 11 * 3600, 0
        kw = dict(num_series=S_pad, num_buckets=nb, interval=iv,
                  agg_down=agg_down)
        P_pad = pad_fine(src.npoints)

        def pad(a, dtype, fill=0, n=P_pad):
            out = np.full(n, fill, dtype)
            out[:len(a)] = a
            return out

        def padbuf(a):
            n = max(len(a), 1)
            out = np.zeros(1 << (n - 1).bit_length(), np.uint8)
            out[:len(a)] = a
            return out

        streams = [pad(src.ts_nb, np.int32), padbuf(src.ts_pay),
                   pad(src.v_nb, np.int32), padbuf(src.v_pay),
                   pad(src.first_idx, np.int32),
                   pad(src.blk_first, np.int32)]
        if leg == "bytes":
            args = streams + [pad(src.rel_base_pt, np.int32),
                              pad(src.sid_pt, np.int32),
                              pad(src.valid, bool, False)]
            jfn, pfn = jax_ck.fused_block_stage, port_ck.fused_block_stage
        elif leg == "bytes_sel":
            m = np.flatnonzero(src.valid)
            assert 0 < len(m) < src.npoints
            M = pad_fine(len(m))
            args = streams + [pad(m, np.int32, n=M),
                              pad(src.rel_base_pt[m], np.int32, n=M),
                              pad(src.sid_pt[m], np.int32, n=M),
                              pad(np.ones(len(m), bool), bool, False, n=M)]
            jfn = jax_ck.fused_block_stage_sel
            pfn = port_ck.fused_block_stage_sel
        if leg.startswith("bytes"):
            jout = jfn(*args, np.int32(lo), np.int32(hi), np.int32(shift),
                       vkind=src.kind, **kw)
            pout = pfn(*[torch.from_numpy(a) for a in args], lo, hi, shift,
                       vkind=src.kind, **kw)
        else:
            jcols = JaxCache(1 << 22).columns(src)
            pcols = DeviceBlockCache(1 << 22, torch.device("cpu")) \
                .columns(src)
            for a, b, exact in zip(pcols[:3], jcols[:3], (1, 1, 1)):
                _close(a, b, True)
            assert pcols[3:] == jcols[3:]
            rb, sd, vd, sel = JaxCache.record_inputs(
                src, S_pad, selective=leg.endswith("sel"))
            assert [np.array_equal(a, b) if a is not None else b is None
                    for a, b in zip(
                        DeviceBlockCache.record_inputs(
                            src, S_pad, selective=leg.endswith("sel")),
                        (rb, sd, vd, sel))] == [True] * 4
            tail = (np.int32(lo), np.int32(hi), np.int32(shift),
                    np.float32(0), np.float32(0))
            ptail = (lo, hi, shift, 0.0, 0.0)
            recs = (rb, sd, vd)
            if leg == "devcache_sel":
                assert sel is not None
                jout = jax_ck.devcache_window_stage_sel(
                    *jcols[:3], sel, *recs, *tail, **kw)
                pout = port_ck.devcache_window_stage_sel(
                    *pcols[:3], torch.from_numpy(sel),
                    *[torch.from_numpy(a) for a in recs], *ptail, **kw)
            else:
                jout = jax_ck.devcache_window_stage(*jcols[:3], *recs,
                                                    *tail, **kw)
                pout = port_ck.devcache_window_stage(
                    *pcols[:3], *[torch.from_numpy(a) for a in recs],
                    *ptail, **kw)
        exact = agg_down in ("count", "min", "max")
        sv, sm, filled, in_range, presence = pout
        jsv, jsm, jfilled, jin, jpres = jout
        _close(sm, jsm, True)
        _close(in_range, jin, True)
        _close(presence, jpres, True)
        assert np.asarray(jsm).any()
        _close(torch.where(sm, sv, 0.0), np.where(jsm, jsv, 0.0), exact)
        _close(torch.where(in_range, filled, 0.0),
               np.where(jin, jfilled, 0.0), exact and agg_down == "count")
    finally:
        t.shutdown()


def test_block_decode_columns_match_jax(tmp_path):
    t, src = _real_gather(tmp_path)
    try:
        from opentsdb_tpu.compress.devcache import pad_fine
        P = src.npoints
        n = pad_fine(P + 1)
        args = []
        for a, self_idx in ((src.ts_nb, False), (src.v_nb, False),
                            (src.first_idx, True), (src.blk_first, True)):
            out = (np.arange(n, dtype=np.int32) if self_idx
                   else np.zeros(n, np.int32))
            out[:P] = a
            args.append(out)
        ts_nb, v_nb, fi, bf = args
        jq, jv = jax_ck.block_decode_columns_jit(
            ts_nb, src.ts_pay, v_nb, src.v_pay, fi, bf, vkind=src.kind)
        pq, pv = port_ck.block_decode_columns(
            *[torch.from_numpy(np.ascontiguousarray(a)) for a in
              (ts_nb, src.ts_pay, v_nb, src.v_pay, fi, bf)],
            vkind=src.kind)
        assert np.array_equal(pq.numpy(), np.asarray(jq))
        assert np.array_equal(pv.numpy().view(np.uint32),
                              np.asarray(jv).view(np.uint32))
        assert not pq.numpy()[P:].any() and not pv.numpy()[P:].any()
    finally:
        t.shutdown()


# ---------------------------------------------------------------------------
# The executors
# ---------------------------------------------------------------------------

SPECS = [("m.cpu", {}, "sum", (3600, "avg"), False),
         ("m.cpu", {"host": "*"}, "max", (3600, "max"), False),
         ("m.cpu", {"dc": "e"}, "p95", (3600, "sum"), False),
         ("m.cpu", {"host": "h2", "dc": "*"}, "sum", (7200, "sum"), False),
         ("m.cpu", {}, "sum", (3600, "avg"), True),
         ("m.cpu", {}, "zimsum", (7200, "count"), False),
         ("m.int", {}, "sum", (3600, "sum"), False),
         ("m.int", {"host": "*"}, "dev", (3600, "min"), False)]


def _answer(rs):
    return {tuple(sorted(r.tags.items())): r for r in rs}


def _assert_contract(got, want, exact=False):
    a, b = _answer(got), _answer(want)
    assert set(a) == set(b) and a
    for k in a:
        assert a[k].aggregated_tags == b[k].aggregated_tags
        assert np.array_equal(a[k].timestamps, b[k].timestamps)
        if exact:
            assert np.array_equal(a[k].values, b[k].values)
        else:
            np.testing.assert_allclose(a[k].values, b[k].values,
                                       rtol=1e-5, atol=1e-5)


@pytest.fixture(scope="module")
def fused_pair(tmp_path_factory):
    """A JAX (backend "tpu") and a port (backend "device", on the CPU)
    TSDB over the same v4 store contents, one generation per slab."""
    from test_torch_native import use
    base = tmp_path_factory.mktemp("fused")
    with pytest.MonkeyPatch.context() as mp:
        use(mp, (None, None), False, False)
        tsdbs = {}
        for name in ("jax", "port"):
            t = OPEN[name](str(base / name), 1)
            for blk in range(5):
                _ingest(t, blk)
                t.checkpoint()
            tsdbs[name] = t
        yield tsdbs
        for t in tsdbs.values():
            t.shutdown()


@pytest.mark.parametrize("i", range(len(SPECS)))
def test_battery_fused_in_both_and_equal_to_raw(fused_pair, i):
    metric, tags, agg, ds, rate = SPECS[i]
    lo, hi = BASE + 100, BASE + 19 * 3600
    jex = JaxExecutor(fused_pair["jax"], backend="tpu")
    pex = QueryExecutor(fused_pair["port"])
    j, jplan, _ = jex.run_with_plan(
        JaxSpec(metric, tags, agg, rate=rate, downsample=ds), lo, hi)
    spec = QuerySpec(metric, tags, agg, rate=rate, downsample=ds)
    p, pplan, _ = pex.run_with_plan(spec, lo, hi)
    assert jplan == pplan == "fused"
    _assert_contract(p, j)
    cfg = fused_pair["port"].config
    cfg.sstable_fused_agg = False
    try:
        r, rplan, _ = pex.run_with_plan(spec, lo, hi)
    finally:
        cfg.sstable_fused_agg = True
    assert rplan == "raw"
    _assert_contract(p, r)
    # The byte-stream leg gives the device-cache leg's answer exactly.
    pex._devcache = None
    pex._fused_stage_cache.clear()
    b, bplan, _ = pex.run_with_plan(spec, lo, hi)
    assert bplan == "fused"
    _assert_contract(b, p, exact=True)


def _counts(metrics):
    out = {}
    for name, kind, tkey, obj in metrics._snapshot():
        if name.startswith("compress.") and kind == "counter":
            out[(name, tkey)] = obj.value
    return out


def _delta(before, after):
    return {k: v - before.get(k, 0) for k, v in after.items()
            if v != before.get(k, 0)}


def _run_scenario(tmp_path, name, build, specs, devblock_points=1 << 23):
    """``build(t)`` on a fresh tsst4 TSDB of each package, then ``specs``
    [(spec args, lo, hi)] through its executor: the plans and the
    compress.* counter deltas of each package."""
    out = {}
    for pkg, metrics in (("jax", JAX_METRICS), ("port", PORT_METRICS)):
        t = OPEN[pkg](str(tmp_path / f"{name}-{pkg}"), 1,
                      devblock_points=devblock_points)
        try:
            build(t)
            ex = (JaxExecutor(t, backend="tpu") if pkg == "jax"
                  else QueryExecutor(t))
            mk = JaxSpec if pkg == "jax" else QuerySpec
            before = _counts(metrics)
            plans = [ex.run_with_plan(mk(*a), lo, hi)[1]
                     for a, lo, hi in specs]
            out[pkg] = (plans, _delta(before, _counts(metrics)))
        finally:
            t.shutdown()
    assert out["port"] == out["jax"]
    return out["port"]


def _int_batch(t, host, t0, span, step, seed):
    rng = np.random.default_rng(seed)
    ts = t0 + np.arange(0, span, step, dtype=np.int64)
    t.add_batch("m.d", ts, rng.integers(-500, 5000, len(ts)),
                {"host": host})


SPEC_D = (("m.d", {}, "sum", False, (3600, "sum")), BASE + 100,
          BASE + 5 * 3600)


def _decl(reason):
    return ("compress.fused.decline", (("reason", reason),))


def test_decline_dirty_counted_alike(tmp_path):
    def build(t):
        _int_batch(t, "a", BASE, 6 * 3600, 300, 5)
        t.checkpoint()
        t.add_batch("m.d", np.array([BASE + 3600 + 7]), np.array([11.0]),
                    {"host": "a"})
    plans, delta = _run_scenario(tmp_path, "dirty", build, [SPEC_D])
    assert plans == ["raw"]
    assert delta[_decl("dirty")] == 1


def test_decline_mixed_codec_counted_alike(tmp_path):
    def build(t):
        _int_batch(t, "a", BASE, 6 * 3600, 300, 6)
        t.checkpoint()
        rng = np.random.default_rng(7)
        ts = BASE + np.arange(0, 6 * 3600, 300, dtype=np.int64) + 3
        t.add_batch("m.d", ts, np.cumsum(rng.normal(0, 1, len(ts))),
                    {"host": "b"})
        t.checkpoint()
    plans, delta = _run_scenario(tmp_path, "mixed", build, [SPEC_D])
    assert plans == ["raw"]
    assert delta[_decl("mixed-codec")] == 1


def test_decline_duplicate_overlap_and_disjoint_alike(tmp_path):
    def overlap(t):
        _int_batch(t, "a", BASE, 4 * 3600, 600, 8)
        t.checkpoint()
        _int_batch(t, "a", BASE + 300, 4 * 3600, 600, 9)
        t.checkpoint()

    def disjoint(t):
        for h in range(4):
            _int_batch(t, "a", BASE + h * 3600, 1800, 300, 10 + h)
        t.checkpoint()
        for h in range(4):
            _int_batch(t, "a", BASE + h * 3600 + 1800, 1800, 300, 20 + h)
        t.checkpoint()
    spec = (SPEC_D[0], BASE + 100, BASE + 4 * 3600)
    plans, delta = _run_scenario(tmp_path, "ov", overlap, [spec])
    assert plans == ["raw"]
    assert delta[_decl("duplicate-overlap")] == 1
    plans, delta = _run_scenario(tmp_path, "dj", disjoint, [spec])
    assert plans == ["fused"]
    assert not any(k[0] == "compress.fused.decline" for k in delta)


def test_decline_on_v3_store_alike(tmp_path):
    def build(t):
        t.store.sstable_codec = "none"
        _int_batch(t, "a", BASE, 6 * 3600, 300, 3)
        t.checkpoint()
    plans, delta = _run_scenario(tmp_path, "v3", build, [SPEC_D])
    assert plans == ["raw"]
    assert delta[_decl("no-encoded-range")] == 1
    assert delta[("compress.fused.attempt", ())] == 1


def test_devcache_hit_miss_evict_alike(tmp_path):
    """The same queries over two days, one generation each: the device
    block cache's hits, misses and evictions equal the JAX package's,
    with a budget that holds both days' columns and with one that holds
    one day's alone."""
    def build(t):
        for day in range(2):
            for si in range(4):
                _int_batch(t, f"h{si}", BASE + day * 86400, 24 * 3600, 300,
                           30 + si + 10 * day)
            t.checkpoint()
    d1 = BASE + 86400
    specs = [(("m.d", {}, "sum", False, (3600, "sum")), BASE + 100,
              BASE + 20 * 3600),
             (("m.d", {}, "max", False, (7200, "max")), BASE + 50,
              BASE + 18 * 3600),
             (("m.d", {"host": "h1"}, "sum", False, (3600, "avg")),
              d1 + 100, d1 + 20 * 3600),
             (("m.d", {}, "min", False, (3600, "min")), BASE + 100,
              BASE + 20 * 3600)]
    plans, delta = _run_scenario(tmp_path, "dc", build, specs)
    assert plans == ["fused"] * 4
    assert (delta[("compress.devcache.miss", ())],
            delta[("compress.devcache.hit", ())]) == (2, 2)
    assert ("compress.devcache.evict", ()) not in delta
    # One day's gather pads to 1,280 points: a budget of 2,000 holds one.
    plans, delta = _run_scenario(tmp_path, "dce", build, specs,
                                 devblock_points=2000)
    assert plans == ["fused"] * 4
    assert (delta[("compress.devcache.miss", ())],
            delta[("compress.devcache.hit", ())],
            delta[("compress.devcache.evict", ())]) == (3, 1, 2)
    assert delta[("compress.fused.served", ())] == 4


def test_daemon_serves_fused_and_reports_it(tmp_path):
    """/q over HTTP on a TSST4 store takes the fused plan (the JSON's
    "rollup" label), and /api/queries, /stats and /metrics report the
    fused coverage, the device block cache and the compression ratio."""
    import asyncio
    import json

    from opentsdb_tpu_torch.server.tsd import TSDServer
    from test_torch_server import _get
    t = _port_tsdb(str(tmp_path / "d"), 1, port=0, bind="127.0.0.1")
    for blk in range(3):
        _ingest(t, blk)
    t.checkpoint()
    server = TSDServer(t)
    q = (f"/q?start={BASE + 100}&end={BASE + 10 * 3600}"
         f"&m=sum:1h-avg:m.cpu%7Bhost=*%7D&json")

    async def main():
        await server.start()
        try:
            return [await _get(server.port, target) for target in
                    (q, q, "/api/queries", "/stats?json", "/metrics")]
        finally:
            await server.stop()

    try:
        (s1, b1), (s2, b2), (sq, bq), (ss, bs), (sm, bm) = \
            asyncio.run(main())
    finally:
        t.shutdown()
    assert (s1, s2, sq, ss, sm) == (200,) * 5
    first, second = json.loads(b1), json.loads(b2)
    assert len(first) == 6
    assert {g["rollup"] for g in first + second} == {"fused"}
    assert [g["dps"] for g in first] == [g["dps"] for g in second]
    feed = json.loads(bq)["fused"]
    assert feed["attempt"] >= 2 and feed["served"] >= 2
    assert 0 < feed["coverage"] <= 1.0
    assert feed["devcache"]["miss"] >= 1
    assert json.loads(bq)["plans"].get("fused") == 2
    lines = json.loads(bs)
    names = {ln.split()[0] for ln in lines}
    assert {"tsd.compress.fused.coverage", "tsd.compress.devcache.hit",
            "tsd.compress.devcache.miss", "tsd.compress.ratio",
            "tsd.compress.fused_agg"} <= names
    ratio = [float(ln.split()[2]) for ln in lines
             if ln.startswith("tsd.compress.ratio ")]
    assert ratio and ratio[0] > 1.0
    assert b"tsd_compress_fused_coverage" in bm


def test_unknown_codec_refused_alike(tmp_path):
    """An unknown Config.sstable_codec is refused at open by both TSDBs
    with the same message; the encode pool's width follows
    Config.spill_encode_workers."""
    msgs = []
    for name in ("jax", "port"):
        with pytest.raises(ValueError) as e:
            OPEN[name](str(tmp_path / name), 1, sstable_codec="lz4")
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]
    t = _port_tsdb(str(tmp_path / "w"), 1, spill_encode_workers=3)
    try:
        assert port_sst._ENC_WORKERS == 3
        assert t.store.sstable_codec == "tsst4"
    finally:
        t.shutdown()
