"""The cluster tier's epoch fence (ROADMAP item 10a) against the JAX
package: ``cluster/epoch.py`` (EPOCH.json bytes, the CAS bump, the
guard), the WAL's epoch headers and the replay fence
(``storage/kv.py``), store promotion and demotion (one store and
sharded), ``TSDB.promote``'s rollback, and the CLI's writer boot bumping
the epoch. Mirrors tests/test_cluster.py's epoch, fence, promotion and
boot classes (the router and ownership classes wait for item 10b); each
byte-level check runs both packages on the same input."""

import concurrent.futures
import fcntl
import json
import os
import struct

import pytest

import opentsdb_tpu.cluster.epoch as jax_epoch
import opentsdb_tpu.storage.kv as jax_kv
import opentsdb_tpu.storage.sharded as jax_sharded
import opentsdb_tpu_torch.cluster.epoch as port_epoch
import opentsdb_tpu_torch.storage.kv as port_kv
import opentsdb_tpu_torch.storage.sharded as port_sharded
from opentsdb_tpu.core.errors import FencedWriterError as JaxFenced
from opentsdb_tpu_torch.core.errors import (FencedWriterError,
                                             ReadOnlyStoreError)
from opentsdb_tpu_torch.core.tsdb import TSDB
from opentsdb_tpu_torch.fault import faultpoints
from opentsdb_tpu_torch.tools import cli
from opentsdb_tpu_torch.utils.config import Config

PKGS = {"port": (port_epoch, port_kv, port_sharded, FencedWriterError),
        "jax": (jax_epoch, jax_kv, jax_sharded, JaxFenced)}


def guard(path, epoch, mod=port_epoch):
    """A zero-interval guard: every check re-stats."""
    return mod.EpochGuard(path, epoch, interval_s=0.0)


def _frame_epoch(e):
    p = struct.pack(">I", 8) + struct.pack(">Q", e)
    return port_kv._REC.pack(port_kv._OP_EPOCH, len(p)) + p


def _frame_put(key, val):
    parts = [b"t", key, b"f", b"q", val]
    p = b"".join(struct.pack(">I", len(x)) + x for x in parts)
    return port_kv._REC.pack(1, len(p)) + p


# ---------------------------------------------------------------------------
# EPOCH.json and EpochGuard
# ---------------------------------------------------------------------------

def test_epoch_file_bytes_equal_jax(tmp_path, monkeypatch):
    """write_epoch and bump_epoch write the JAX package's bytes (the same
    clock), and each package reads and bumps the other's file."""
    monkeypatch.setattr(port_epoch.time, "time", lambda: 1700000000.5)
    monkeypatch.setattr(jax_epoch.time, "time", lambda: 1700000000.5)
    for owner in ("w0", None):
        a, b = str(tmp_path / "a.json"), str(tmp_path / "b.json")
        port_epoch.write_epoch(a, 3, owner)
        jax_epoch.write_epoch(b, 3, owner)
        assert open(a, "rb").read() == open(b, "rb").read()
        assert port_epoch.bump_epoch(a, "r", expect=3) == 4
        assert jax_epoch.bump_epoch(b, "r", expect=3) == 4
        assert open(a, "rb").read() == open(b, "rb").read()
        assert port_epoch.read_epoch(b) == jax_epoch.read_epoch(a) == (4, "r")
        # Crossing: each package bumps the other's file.
        assert port_epoch.bump_epoch(b, "x", expect=4) == 5
        assert jax_epoch.read_epoch(b) == (5, "x")


@pytest.mark.parametrize("pkg", sorted(PKGS))
def test_roundtrip_cas_and_refusals(pkg, tmp_path):
    ep = PKGS[pkg][0]
    p = str(tmp_path / "EPOCH.json")
    assert ep.read_epoch(p) == (0, None)
    ep.write_epoch(p, 1, owner="w0")
    assert ep.read_epoch(p) == (1, "w0")
    assert ep.bump_epoch(p, owner="r1", expect=1) == 2
    with pytest.raises(ep.EpochConflictError):
        ep.bump_epoch(p, expect=1)
    with pytest.raises(ValueError):
        ep.write_epoch(str(tmp_path / "E.json"), 0)
    bad = tmp_path / "bad.json"
    bad.write_text(json.dumps({"version": 99, "epoch": 5}))
    with pytest.raises(ValueError):
        ep.read_epoch(str(bad))


def test_guard_fences_and_stays_fenced(tmp_path):
    p = str(tmp_path / "EPOCH.json")
    port_epoch.write_epoch(p, 1)
    g, jg = guard(p, 1), guard(p, 1, jax_epoch)
    g.check()
    jg.check()
    jax_epoch.write_epoch(p, 2)
    with pytest.raises(FencedWriterError) as ei:
        g.check()
    with pytest.raises(JaxFenced) as ej:
        jg.check()
    assert str(ei.value) == str(ej.value)
    assert ei.value.current_epoch == 2 and ei.value.own_epoch == 1
    # Tripped stays tripped, even if the file regresses.
    port_epoch.write_epoch(p, 1)
    with pytest.raises(FencedWriterError):
        g.check()
    g.reset(2)
    g.check()


def test_concurrent_bumps_serialize(tmp_path):
    p = str(tmp_path / "EPOCH.json")
    port_epoch.write_epoch(p, 1)
    with concurrent.futures.ThreadPoolExecutor(8) as ex:
        got = sorted(ex.map(lambda i: (port_epoch if i % 2 else
                                       jax_epoch).bump_epoch(p), range(8)))
    assert got == list(range(2, 10))
    assert port_epoch.read_epoch(p)[0] == 9


def test_epoch_path_for_wal(tmp_path):
    d = tmp_path / "store"
    d.mkdir()
    for ep in (port_epoch, jax_epoch):
        assert ep.epoch_path_for_wal(str(d)) == str(d / "EPOCH.json")
        assert ep.epoch_path_for_wal(str(tmp_path / "wal")) == \
            str(tmp_path / "wal") + ".epoch.json"
        assert ep.epoch_path_for_wal("nowhere", is_dir=True) == \
            os.path.join("nowhere", "EPOCH.json")


# ---------------------------------------------------------------------------
# WAL epoch headers and the replay fence
# ---------------------------------------------------------------------------

def _script(kv, wal, epoch):
    s = kv.MemKVStore(wal_path=wal, writer_epoch=epoch)
    s.ensure_table("t")
    s.put("t", b"k1", b"f", b"q", b"v1")
    s.put_many("t", b"f", [(b"k2", b"q", b"v2"), (b"k3", b"q", b"v3")])
    s.checkpoint()
    s.put("t", b"k4", b"f", b"q", b"v4")
    s.delete("t", b"k2", b"f", [b"q"])
    s.close()


@pytest.mark.parametrize("epoch", [None, 1, 7])
def test_wal_bytes_equal_jax_and_cross(epoch, tmp_path, monkeypatch):
    """The same script through both packages at one epoch (None: not a
    cluster store) leaves the same WAL bytes and generation files; each
    package replays the other's WAL; a non-cluster WAL has no header."""
    monkeypatch.setattr(port_kv, "_EXT", None)
    monkeypatch.setattr(jax_kv, "_EXT", None)
    pw, jw = str(tmp_path / "p" / "wal"), str(tmp_path / "j" / "wal")
    _script(port_kv, pw, epoch)
    _script(jax_kv, jw, epoch)
    pb, jb = open(pw, "rb").read(), open(jw, "rb").read()
    assert pb == jb
    assert (pb[0] == port_kv._OP_EPOCH) == (epoch is not None)
    assert open(pw + ".sst.g1", "rb").read() == \
        open(jw + ".sst.g1", "rb").read()
    for kv, w in ((port_kv, jw), (jax_kv, pw)):
        s = kv.MemKVStore(wal_path=w, read_only=True)
        try:
            got = {k: [c.value for c in s.get("t", k)]
                   for k in (b"k1", b"k2", b"k3", b"k4")}
            assert got == {b"k1": [b"v1"], b"k2": [], b"k3": [b"v3"],
                           b"k4": [b"v4"]}
            assert s._replay_epoch == (epoch or 0)
        finally:
            s.close()


@pytest.mark.parametrize("pkg", sorted(PKGS))
def test_same_epoch_reopen_does_not_restamp(pkg, tmp_path):
    kv, Fenced = PKGS[pkg][1], PKGS[pkg][3]
    wal = str(tmp_path / "wal")
    s = kv.MemKVStore(wal_path=wal, writer_epoch=2)
    s.put("t", b"k", b"f", b"q", b"v")
    s.close()
    size1 = os.path.getsize(wal)
    kv.MemKVStore(wal_path=wal, writer_epoch=2).close()
    assert os.path.getsize(wal) == size1
    with pytest.raises(Fenced):
        kv.MemKVStore(wal_path=wal, writer_epoch=1)


def test_zombie_segment_refused_alike(tmp_path):
    """A stale-epoch segment appended after a newer writer's records is
    cut at the fence line by both packages, with the same refused byte
    count; a replica stops its cursor there; the writer's truncation
    removes it."""
    wal = str(tmp_path / "wal")
    s = port_kv.MemKVStore(wal_path=wal, writer_epoch=1)
    s.put("t", b"k1", b"f", b"q", b"v1")
    s.close()
    with open(wal, "ab") as f:
        f.write(_frame_epoch(2) + _frame_put(b"k2", b"new"))
        f.write(_frame_epoch(1) + _frame_put(b"k9", b"ZOMBIE"))
    refused = {}
    for name, kv in (("port", port_kv), ("jax", jax_kv)):
        r = kv.MemKVStore(wal_path=wal, read_only=True)
        try:
            assert r.get("t", b"k2") and not r.get("t", b"k9")
            refused[name] = r.fenced_bytes_refused
        finally:
            r.close()
    assert refused["port"] == refused["jax"] == len(
        _frame_epoch(1) + _frame_put(b"k9", b"ZOMBIE"))
    s2 = port_kv.MemKVStore(wal_path=wal, writer_epoch=2)
    try:
        assert s2.get("t", b"k1") and s2.get("t", b"k2")
        assert not s2.get("t", b"k9")
        assert s2.fenced_bytes_refused == refused["port"]
    finally:
        s2.close()
    s3 = jax_kv.MemKVStore(wal_path=wal, writer_epoch=2)
    try:
        assert s3.fenced_bytes_refused == 0 and not s3.get("t", b"k9")
    finally:
        s3.close()


# ---------------------------------------------------------------------------
# Promotion and demotion at the store level
# ---------------------------------------------------------------------------

def _boot(tmp_path, writer_kv=port_kv, writer_ep=port_epoch):
    wal = str(tmp_path / "wal")
    ep = port_epoch.epoch_path_for_wal(wal)
    port_epoch.write_epoch(ep, 1, "w0")
    w = writer_kv.MemKVStore(wal_path=wal, writer_epoch=1,
                             epoch_guard=guard(ep, 1, writer_ep))
    w.put("t", b"k1", b"f", b"q", b"v1")
    w.flush()
    r = port_kv.MemKVStore(wal_path=wal, read_only=True)
    return wal, ep, w, r


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_promote_fences_zombie_and_keeps_data(writer, tmp_path):
    """A port replica promoted over a live writer of either package: the
    zombie (still holding its flock) is fenced at its next mutation, the
    promoted store serves the old rows and takes new ones, and recovery
    keeps everything but the zombie's writes. The promoted WAL begins with
    the new epoch's header."""
    ep_mod, kv = PKGS[writer][0], PKGS[writer][1]
    Fenced = PKGS[writer][3]
    wal, ep, w, r = _boot(tmp_path, kv, ep_mod)
    new = port_epoch.bump_epoch(ep, "r0", expect=1)
    r.promote_writable(new, epoch_guard=guard(ep, new))
    assert not r.read_only and r.rebuilds == 1
    with pytest.raises(Fenced):
        w.put("t", b"k2", b"f", b"q", b"v2")
    assert r.get("t", b"k1")
    r.put("t", b"k3", b"f", b"q", b"v3")
    with open(wal, "rb") as f:
        op, plen = port_kv._REC.unpack(f.read(port_kv._REC.size))
        assert op == port_kv._OP_EPOCH
        assert struct.unpack(">Q", f.read(plen)[4:])[0] == new
    r.close()
    w.close()
    for kv in (port_kv, jax_kv):
        chk = kv.MemKVStore(wal_path=wal, writer_epoch=new)
        try:
            assert chk.get("t", b"k1") and chk.get("t", b"k3")
            assert not chk.get("t", b"k2")
        finally:
            chk.close()


def test_unguarded_zombie_appends_are_orphaned(tmp_path):
    """A zombie without a guard keeps acking, but the promotion's
    fresh-inode rotation strands its appends on an unlinked inode."""
    wal = str(tmp_path / "wal")
    ep = port_epoch.epoch_path_for_wal(wal)
    port_epoch.write_epoch(ep, 1, "w0")
    w = port_kv.MemKVStore(wal_path=wal, writer_epoch=1)
    w.put("t", b"k1", b"f", b"q", b"v1")
    r = port_kv.MemKVStore(wal_path=wal, read_only=True)
    new = port_epoch.bump_epoch(ep, "r0", expect=1)
    r.promote_writable(new, epoch_guard=guard(ep, new))
    w.put("t", b"zz", b"f", b"q", b"unfenced")
    w.flush()
    r.put("t", b"k3", b"f", b"q", b"v3")
    r.close()
    w.close()
    chk = port_kv.MemKVStore(wal_path=wal, writer_epoch=new)
    try:
        assert chk.get("t", b"k1") and chk.get("t", b"k3")
        assert not chk.get("t", b"zz")
    finally:
        chk.close()


def test_demote_back_to_tailing(tmp_path):
    wal, ep, w, r = _boot(tmp_path)
    new = port_epoch.bump_epoch(ep, "r0", expect=1)
    r.promote_writable(new, epoch_guard=guard(ep, new))
    w.demote_readonly()
    assert w.read_only and w.writer_epoch is None
    with pytest.raises(ReadOnlyStoreError, match="read-only replica"):
        w.put("t", b"x", b"f", b"q", b"v")
    r.put("t", b"k3", b"f", b"q", b"v3")
    r.flush()
    w.refresh()
    assert w.get("t", b"k3")
    w.close()
    r.close()


@pytest.mark.parametrize("site", ["cluster.promote.take",
                                  "cluster.promote.rotate"])
def test_promote_failure_leaves_coherent_replica(site, tmp_path):
    wal, ep, w, r = _boot(tmp_path)
    new = port_epoch.bump_epoch(ep, "r0", expect=1)
    faultpoints.arm(site, "raise")
    try:
        with pytest.raises(faultpoints.FaultInjected):
            r.promote_writable(new, epoch_guard=guard(ep, new))
    finally:
        faultpoints.disarm(site)
    assert r.read_only and r.writer_epoch is None
    assert r.get("t", b"k1")
    with pytest.raises(ReadOnlyStoreError):
        r.put("t", b"x", b"f", b"q", b"v")
    r.promote_writable(new, epoch_guard=guard(ep, new))
    assert not r.read_only
    r.close()
    w.close()


@pytest.mark.parametrize("site", ["cluster.promote.take",
                                  "cluster.promote.rotate"])
def test_failed_promotion_releases_the_lock(site, tmp_path):
    """A promotion that takes the free single-writer lock and then fails
    gives the lock back with the rest of its state: another writer can
    take it, and the replica promotes again."""
    wal, ep, w, r = _boot(tmp_path)
    w.close()
    new = port_epoch.bump_epoch(ep, "r0", expect=1)
    faultpoints.arm(site, "raise")
    try:
        with pytest.raises(faultpoints.FaultInjected):
            r.promote_writable(new, epoch_guard=guard(ep, new))
    finally:
        faultpoints.disarm(site)
    fd = os.open(wal + ".lock", os.O_RDWR)
    try:
        fcntl.flock(fd, fcntl.LOCK_EX | fcntl.LOCK_NB)
        fcntl.flock(fd, fcntl.LOCK_UN)
    finally:
        os.close(fd)
    r.promote_writable(new, epoch_guard=guard(ep, new))
    assert not r.read_only and r._lockfd is not None
    r.close()


def test_tsdb_promote_rolls_back_on_post_store_failure(tmp_path,
                                                       monkeypatch):
    """A failure after the store committed its takeover (a torn sketch
    snapshot) demotes the store back: a genuine replica, still
    refreshing."""
    wal = str(tmp_path / "wal")
    ep = port_epoch.epoch_path_for_wal(wal)
    port_epoch.write_epoch(ep, 1)
    w = port_kv.MemKVStore(wal_path=wal, writer_epoch=1)
    w.put("t", b"k1", b"f", b"q", b"v1")
    w.close()
    cfg = Config(device="cpu", backend="cpu", device_window=False)
    r = TSDB(port_kv.MemKVStore(wal_path=wal, read_only=True), cfg,
             start_compaction_thread=False)
    monkeypatch.setattr(
        TSDB, "_init_sketches",
        lambda self: (_ for _ in ()).throw(OSError("torn")))
    new = port_epoch.bump_epoch(ep, expect=1)
    with pytest.raises(OSError):
        r.promote(new, epoch_guard=guard(ep, new))
    assert r.store.read_only and r.tenants is None
    r.store.refresh()
    r.shutdown()


@pytest.mark.parametrize("fail_shard", [None, 1])
def test_sharded_promote_all_or_nothing(fail_shard, tmp_path,
                                        monkeypatch):
    """A sharded replica promotes every shard, or, when one shard fails,
    none: the promoted prefix demotes back."""
    d = str(tmp_path / "store")
    ep = os.path.join(d, "EPOCH.json")
    w = jax_sharded.ShardedKVStore(d, shards=2, writer_epoch=1)
    port_epoch.write_epoch(ep, 1, "w0")
    for i in range(8):
        w.put("tsdb", f"k{i}".encode() * 4, b"f", b"q", b"v")
    w.flush()
    r = port_sharded.ShardedKVStore(d, read_only=True)
    new = port_epoch.bump_epoch(ep, "r0", expect=1)
    if fail_shard is not None:
        bad = r.shards[fail_shard]

        def boom(*a, **k):
            raise OSError("disk full")
        monkeypatch.setattr(bad, "promote_writable", boom)
        with pytest.raises(OSError):
            r.promote_writable(new, epoch_guard=guard(ep, new))
        assert r.read_only and all(s.read_only for s in r.shards)
        assert r.get("tsdb", b"k3" * 4)
        monkeypatch.undo()
    r.promote_writable(new, epoch_guard=guard(ep, new))
    assert not r.read_only and all(not s.read_only for s in r.shards)
    assert r.writer_epoch == new and r.fenced_bytes_refused == 0
    assert r.get("tsdb", b"k3" * 4)
    r.put("tsdb", b"new-key-xx", b"f", b"q", b"v")
    with pytest.raises(JaxFenced):
        w.epoch_guard = guard(ep, 1, jax_epoch)
        for s in w.shards:
            s.epoch_guard = w.epoch_guard
        w.put("tsdb", b"k0" * 4, b"f", b"q", b"zombie")
    r.demote_readonly()
    assert r.read_only and r.rebuilds >= 2
    r.close()
    w.close()


# ---------------------------------------------------------------------------
# The CLI's writer boot
# ---------------------------------------------------------------------------

def _stat(tsdb, name):
    """The value of one ``tsd.<name>`` line of collect_stats, or None."""
    from opentsdb_tpu_torch.stats.collector import StatsCollector
    c = StatsCollector("tsd")
    tsdb.collect_stats(c)
    vals = [ln.split()[2] for ln in c.lines
            if ln.split()[0] == "tsd." + name]
    return vals[0] if vals else None


@pytest.mark.parametrize("shards", [0, 2])
def test_each_writer_boot_is_a_new_epoch(shards, tmp_path):
    """A --cluster writer boot claims a fresh epoch (1 on a new file, a
    bump after), stamps it and exports cluster.epoch; a replica boot
    bumps nothing and reads the file's epoch."""
    wal = str(tmp_path / "wal")

    def boot(read_only=False):
        cfg = Config(device="cpu", backend="cpu", auto_create_metrics=True,
                     cluster=True, cluster_owner="t",
                     enable_sketches=False)
        return cli.make_tsdb(cfg, wal, shards=shards, read_only=read_only,
                             start_compaction_thread=False)

    p = port_epoch.epoch_path_for_wal(wal, is_dir=shards > 1)
    for want in (1, 2):
        t = boot()
        try:
            assert t.store.writer_epoch == want
            assert t.cluster_epoch_path == p
            assert port_epoch.read_epoch(p) == (want, "t")
            t.add_point("m", 1356998400 + want, 1.0, {"h": "a"})
            assert _stat(t, "cluster.epoch") == str(want)
            assert _stat(t, "cluster.fenced") == "0"
        finally:
            t.shutdown()
    r = boot(read_only=True)
    try:
        assert r.store.writer_epoch is None
        assert port_epoch.read_epoch(p)[0] == 2
        assert _stat(r, "cluster.epoch") == "2"
        assert _stat(r, "cluster.fenced") is None
    finally:
        r.shutdown()


def test_tsdb_promote_then_demote(tmp_path):
    """A replica TSDB promoted over a stopped writer ingests as a writer
    (tenant accounting adopted, sketches folding, its WAL under the new
    epoch), then demotes back to a replica that refuses and follows the
    next writer's checkpoint."""
    wal = str(tmp_path / "wal")
    ep = port_epoch.epoch_path_for_wal(wal)
    cfg = lambda: Config(device="cpu", backend="cpu",  # noqa: E731
                         auto_create_metrics=True, device_window=False)
    w = TSDB(port_kv.MemKVStore(wal_path=wal), cfg(),
             start_compaction_thread=False)
    w.add_point("m.p", 1356998400, 1.0, {"h": "a"})
    w.shutdown()
    r = TSDB(port_kv.MemKVStore(wal_path=wal, read_only=True), cfg(),
             start_compaction_thread=False)
    assert r.tenants is None
    new = port_epoch.bump_epoch(ep, "r")
    r.promote(new, epoch_guard=guard(ep, new))
    assert not r.store.read_only and r.tenants is not None
    assert set(r.promote_seconds) == {"store", "sketches", "tenants",
                                      "rollups"}
    r.add_point("m.p", 1356998460, 2.0, {"h": "b"})
    assert r.sketches.series_count() == 2
    assert r.tenants.total_tracked() == 2
    r.demote()
    assert r.store.read_only and r.tenants is None
    with pytest.raises(ReadOnlyStoreError):
        r.add_point("m.p", 1356998520, 3.0, {"h": "c"})
    w2 = TSDB(port_kv.MemKVStore(wal_path=wal), cfg(),
              start_compaction_thread=False)
    w2.add_point("m.p", 1356998580, 4.0, {"h": "d"})
    w2.checkpoint()
    r.refresh_replica()
    assert r.sketches.series_count() == 3
    w2.shutdown()
    r.shutdown()
