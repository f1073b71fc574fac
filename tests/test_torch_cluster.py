"""The cluster tier (ROADMAP items 10a and 10b) against the JAX package:
``cluster/epoch.py`` (EPOCH.json bytes, the CAS bump, the guard and its
split-brain switch), the WAL's epoch headers and the replay fence
(``storage/kv.py``), store promotion and demotion (one store and
sharded), ``TSDB.promote``'s rollback, and the CLI's writer boot bumping
the epoch; then ``cluster/ownership.py`` (``slot_of`` over seeded names,
``CLUSTER.json`` bytes after the same transfers, each package loading the
other's), the daemon's ``/promote`` and ``/demote`` (the failover
handshake and its refusals through both daemons), ``cluster/promote.py``'s
``PromotionManager`` on a stub router (the same events as the JAX
manager's from the same probe answers), and the router's multi-writer
mode (``_merge_results`` through both packages, reads by ownership, a
handoff, ``/api/tenants`` merged, ``/api/topology``, the result cache).
Mirrors tests/test_cluster.py; each byte-level check runs both packages
on the same input."""

import asyncio
import concurrent.futures
import fcntl
import json
import os
import struct
import types

import numpy as np
import pytest

import opentsdb_tpu.cluster.epoch as jax_epoch
import opentsdb_tpu.cluster.ownership as jax_own
import opentsdb_tpu.cluster.promote as jax_promote
import opentsdb_tpu.serve.router as jax_router
import opentsdb_tpu.storage.kv as jax_kv
import opentsdb_tpu.storage.sharded as jax_sharded
import opentsdb_tpu_torch.cluster.epoch as port_epoch
import opentsdb_tpu_torch.cluster.ownership as port_own
import opentsdb_tpu_torch.cluster.promote as port_promote
import opentsdb_tpu_torch.serve.router as port_router
import opentsdb_tpu_torch.storage.kv as port_kv
import opentsdb_tpu_torch.storage.sharded as port_sharded
from opentsdb_tpu.core.errors import FencedWriterError as JaxFenced
from opentsdb_tpu.core.tsdb import TSDB as JaxTSDB
from opentsdb_tpu.serve.tailer import WalTailer as JaxTailer
from opentsdb_tpu.server.tsd import TSDServer as JaxServer
from opentsdb_tpu.utils.config import Config as JaxConfig
from opentsdb_tpu_torch.core.errors import (FencedWriterError,
                                             ReadOnlyStoreError)
from opentsdb_tpu_torch.core.tsdb import TSDB
from opentsdb_tpu_torch.fault import faultpoints
from opentsdb_tpu_torch.obs.registry import METRICS
from opentsdb_tpu_torch.serve.tailer import WalTailer
from opentsdb_tpu_torch.server.tsd import TSDServer
from opentsdb_tpu_torch.tools import cli
from opentsdb_tpu_torch.utils.config import Config

BT = 1356998400
LOOP = {"port": 0, "bind": "127.0.0.1"}
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


@pytest.mark.parametrize("pkg", sorted(PKGS))
def test_guard_split_brain_switch_disables_fence(pkg, tmp_path,
                                                 monkeypatch):
    """``TSDB_CLUSTER_BUG=split-brain`` keeps a deposed guard unfenced in
    both packages (the serve matrix's cluster gate)."""
    ep, Fenced = PKGS[pkg][0], PKGS[pkg][3]
    p = str(tmp_path / "EPOCH.json")
    ep.write_epoch(p, 2)
    g = guard(p, 1, ep)
    monkeypatch.setenv("TSDB_CLUSTER_BUG", "split-brain")
    g.check()
    monkeypatch.delenv("TSDB_CLUSTER_BUG")
    with pytest.raises(Fenced):
        g.check()


# ---------------------------------------------------------------------------
# cluster/ownership.py: slot_of and CLUSTER.json against the JAX package
# ---------------------------------------------------------------------------



def _names(n, seed=7):
    rng = np.random.default_rng(seed)
    return [("m." + "".join(chr(97 + c) for c in rng.integers(0, 26, k))
             + f".{i}").encode()
            for i, k in enumerate(rng.integers(1, 24, n))]


@pytest.mark.parametrize("slots", [64, 1024])
def test_slot_of_equals_jax(slots):
    names = _names(10_000)
    assert [port_own.slot_of(n, slots) for n in names] == \
        [jax_own.slot_of(n, slots) for n in names]
    pm = port_own.OwnershipMap(["http://a:1", "http://b:2", "http://c:3"],
                               slots=slots)
    jm = jax_own.OwnershipMap(["http://a:1", "http://b:2", "http://c:3"],
                              slots=slots)
    assert [pm.owner(n) for n in names] == [jm.owner(n) for n in names]
    assert [pm.readers(n) for n in names[:500]] == \
        [jm.readers(n) for n in names[:500]]


def test_cluster_json_bytes_equal_jax_and_cross(tmp_path):
    """The same transfers give byte-identical CLUSTER.json files, and each
    package loads the other's (and refuses the same bad ones)."""
    writers = ["http://127.0.0.1:1/", "http://127.0.0.1:2",
               "http://127.0.0.1:3"]
    pm = port_own.OwnershipMap(writers, slots=16)
    jm = jax_own.OwnershipMap(writers, slots=16)
    pp, jp = str(tmp_path / "p" / "CLUSTER.json"), str(tmp_path / "j.json")
    for slot, to in ((0, 2), (5, 1), (0, 1), (15, 0), (5, 1)):
        pm.transfer(slot, to)
        jm.transfer(slot, to)
        pm.save(pp)
        jm.save(jp)
        assert open(pp, "rb").read() == open(jp, "rb").read()
    assert pm.epoch == jm.epoch == 6
    assert port_own.OwnershipMap.load(jp).snapshot() == jm.snapshot()
    assert jax_own.OwnershipMap.load(pp).snapshot() == pm.snapshot()
    for bad in ((0, 3), (16, 0), (-1, 0)):
        for m in (pm, jm):
            with pytest.raises(ValueError):
                m.transfer(*bad)
    (tmp_path / "v9.json").write_text(json.dumps(
        dict(pm.snapshot(), version=9)))
    for mod in (port_own, jax_own):
        with pytest.raises(ValueError):
            mod.OwnershipMap.load(str(tmp_path / "v9.json"))
        with pytest.raises(ValueError):
            mod.OwnershipMap([], slots=4)


def test_handoff_commit_fault_point_keeps_old_map(tmp_path):
    """A crash at ``cluster.handoff.commit`` leaves the durable tmp and the
    old map: the handoff is lost, the map never torn."""
    p = str(tmp_path / "CLUSTER.json")
    m = port_own.OwnershipMap(["http://a:1", "http://b:2"], slots=8)
    m.save(p)
    m.transfer(0, 1)
    faultpoints.arm("cluster.handoff.commit", "raise")
    try:
        with pytest.raises(Exception):
            m.save(p)
    finally:
        faultpoints.clear()
    assert port_own.OwnershipMap.load(p).epoch == 1
    assert os.path.exists(p + ".tmp")


# ---------------------------------------------------------------------------
# The daemon's /promote and /demote against the JAX daemon's
# ---------------------------------------------------------------------------

async def _http(port, target):
    reader, writer = await asyncio.open_connection("127.0.0.1", port)
    writer.write(f"GET {target} HTTP/1.1\r\nHost: x\r\n"
                 "Connection: close\r\n\r\n".encode())
    await writer.drain()
    data = await reader.read()
    writer.close()
    head, _, body = data.partition(b"\r\n\r\n")
    return int(head.split(b" ", 2)[1]), body


DAEMONS = {
    "port": types.SimpleNamespace(
        TSDB=TSDB, kv=port_kv, ep=port_epoch, Server=TSDServer,
        Tailer=WalTailer, Fenced=FencedWriterError,
        config=lambda wal, **kw: Config(device="cpu", **kw)),
    "jax": types.SimpleNamespace(
        TSDB=JaxTSDB, kv=jax_kv, ep=jax_epoch, Server=JaxServer,
        Tailer=JaxTailer, Fenced=JaxFenced,
        config=lambda wal, **kw: JaxConfig(wal_path=wal, **kw)),
}


def _writer_tsdb(d, wal, ep, epoch=1):
    t = d.TSDB(d.kv.MemKVStore(wal_path=wal, writer_epoch=epoch,
                               epoch_guard=guard(ep, epoch, d.ep)),
               d.config(wal, backend="cpu", auto_create_metrics=True,
                        enable_sketches=False, device_window=False,
                        cluster=True, **LOOP),
               start_compaction_thread=False)
    t.cluster_epoch_path = ep
    return t


def _replica_tsdb(d, wal, ep):
    t = d.TSDB(d.kv.MemKVStore(wal_path=wal, read_only=True),
               d.config(wal, backend="cpu", enable_sketches=False,
                        device_window=False, role="replica",
                        max_staleness_ms=60_000.0, cluster=True,
                        epoch_check_interval_s=0.0, **LOOP),
               start_compaction_thread=False)
    t.cluster_epoch_path = ep
    server = d.Server(t)
    server.attach_tailer(d.Tailer(t, interval_s=3600.0))
    return t, server


async def _stop(*servers):
    for s in servers:
        if s.tailer is not None:
            s.tailer.stop()
        s._pool.shutdown(wait=False)
        if s._server is not None:
            s._server.close()
            await s._server.wait_closed()


def _handshake(pkg, tmp_path):
    """tests/test_cluster.py's full failover handshake through ``pkg``'s
    daemons, returning every HTTP answer it read."""
    d = DAEMONS[pkg]
    wal = str(tmp_path / pkg / "wal")
    os.makedirs(os.path.dirname(wal))
    ep = d.ep.epoch_path_for_wal(wal)
    d.ep.write_epoch(ep, 1, "w0")
    w = _writer_tsdb(d, wal, ep)
    for i in range(50):
        w.add_point("m.c", BT + i * 60, i % 7, {"host": "a"})
    w.store.flush()
    r, rserver = _replica_tsdb(d, wal, ep)
    wserver = d.Server(w)
    out = {}
    q = f"/q?start={BT - 60}&end={BT + 7300}&m=sum:m.c&json"

    async def drive():
        await wserver.start()
        await rserver.start()
        try:
            out["promote"] = await _http(rserver.port, "/promote")
            assert not r.store.read_only and rserver.tailer is None
            out["again"] = await _http(rserver.port, "/promote")
            # Through the locked path too: no second bump.
            assert rserver._do_promote(ep, None) == 2
            assert d.ep.read_epoch(ep)[0] == 2
            out["healthz_new"] = await _http(rserver.port, "/healthz")
            with pytest.raises(d.Fenced):
                w.add_point("m.c", BT + 9999 * 60, 1, {"host": "a"})
            out["healthz_old"] = await _http(wserver.port, "/healthz")
            out["demote"] = await _http(wserver.port, "/demote")
            assert w.store.read_only and wserver.tailer is not None
            out["demote_again"] = await _http(wserver.port, "/demote")
            out["promote_bad"] = await _http(wserver.port,
                                             "/promote?expect=x")
            r.add_point("m.c", BT + 7200, 3, {"host": "a"})
            r.store.flush()
            wserver.tailer.run_once()
            out["tailed"] = await _http(wserver.port, q)
            out["healthz_demoted"] = await _http(wserver.port, "/healthz")
        finally:
            await _stop(wserver, rserver)

    try:
        asyncio.run(drive())
    finally:
        r.shutdown()
        w.shutdown()
    return out


def test_promote_demote_handshake_matches_jax(tmp_path):
    """The failover handshake through the port's daemons answers what the
    JAX daemons answer: ``/promote`` (the epoch, idempotent on repeat),
    the new writer's and the fenced writer's ``/healthz``, ``/demote``
    (idempotent), a bad ``expect=``, and the demoted daemon tailing the
    new writer's point."""
    p, j = _handshake("port", tmp_path), _handshake("jax", tmp_path)
    assert p["promote"] == j["promote"] == (
        200, b'{"role": "writer", "epoch": 2}')
    assert p["again"] == j["again"]
    assert json.loads(p["again"][1])["already_writer"] is True
    for k in ("demote", "demote_again", "promote_bad"):
        assert p[k] == j[k], k
    assert p["promote_bad"][0] == 400
    for k in ("healthz_new", "healthz_old", "healthz_demoted"):
        hp, hj = json.loads(p[k][1]), json.loads(j[k][1])
        assert p[k][0] == j[k][0], k
        for key in ("role", "writer_epoch", "fenced", "fenced_by_epoch",
                    "ok", "read_only"):
            assert hp.get(key) == hj.get(key), (k, key)
    assert json.loads(p["healthz_old"][1])["fenced"] is True
    assert json.loads(p["healthz_demoted"][1])["role"] == "replica"
    tp, tj = json.loads(p["tailed"][1]), json.loads(j["tailed"][1])
    assert tp[0]["dps"] == tj[0]["dps"]
    assert tp[0]["dps"][str(BT + 7200)] == 3.0


@pytest.mark.parametrize("pkg", sorted(DAEMONS))
def test_promote_demote_refusals(pkg, tmp_path, monkeypatch):
    """400 without --cluster (both routes), the split-brain switch's 500
    on /demote, and a failing ``TSDB.promote`` going back to tailing."""
    d = DAEMONS[pkg]
    wal = str(tmp_path / "plain" / "wal")
    os.makedirs(os.path.dirname(wal))
    t = d.TSDB(d.kv.MemKVStore(wal_path=wal),
               d.config(wal, backend="cpu", enable_sketches=False,
                        device_window=False, **LOOP),
               start_compaction_thread=False)
    server = d.Server(t)
    cwal = str(tmp_path / "c" / "wal")
    os.makedirs(os.path.dirname(cwal))
    ep = d.ep.epoch_path_for_wal(cwal)
    d.ep.write_epoch(ep, 1, "w0")
    w = _writer_tsdb(d, cwal, ep)
    w.store.flush()
    r, rserver = _replica_tsdb(d, cwal, ep)
    wserver = d.Server(w)

    def boom(*a, **kw):
        raise RuntimeError("promotion failed")

    async def drive():
        for s in (server, wserver, rserver):
            await s.start()
        try:
            out = [await _http(server.port, "/promote"),
                   await _http(server.port, "/demote")]
            monkeypatch.setenv("TSDB_CLUSTER_BUG", "split-brain")
            out.append(await _http(wserver.port, "/demote"))
            monkeypatch.delenv("TSDB_CLUSTER_BUG")
            assert not w.store.read_only
            monkeypatch.setattr(r, "promote", boom)
            out.append((await _http(rserver.port, "/promote"))[0])
            assert r.store.read_only and rserver.tailer is not None
            assert rserver.tailer._thread is not None
            return out
        finally:
            await _stop(server, wserver, rserver)

    try:
        out = asyncio.run(drive())
    finally:
        for x in (t, r, w):
            try:
                x.shutdown()
            except d.Fenced as e:
                # The failed promotion's bump deposed w: the port's
                # shutdown checkpoint refuses.
                assert x is w and "superseded" in str(e)
    assert [o[0] for o in out[:3]] == [400, 400, 500]
    assert b"cluster" in out[0][1] and b"cluster" in out[1][1]
    assert out[2][1] == b"demote sabotaged by TSDB_CLUSTER_BUG\n"
    assert out[3] == 500


# ---------------------------------------------------------------------------
# PromotionManager on a stub router, against the JAX manager
# ---------------------------------------------------------------------------

class _Clock:
    def __init__(self):
        self.now = 1000.0

    def monotonic(self):
        return self.now

    def time(self):
        return 1_700_000_000.0 + self.now


class _Fleet:
    """Scripted daemons behind fake ``_http_fetch``: which are up, what
    each /healthz says, which /promote fails; records every call."""

    def __init__(self, router_mod):
        self.mod = router_mod
        self.up: set = set()
        self.health: dict = {}
        self.promote_fails: set = set()
        self.epoch = 1
        self.calls: list = []

    async def fetch(self, host, port, target, timeout_s):
        self.calls.append((port, target))
        if port not in self.up:
            raise self.mod.HopError(f"hop to {host}:{port} failed")
        if target == "/healthz":
            return 200, {}, json.dumps(self.health[port]).encode()
        if target == "/promote":
            if port in self.promote_fails:
                return 500, {}, b"promotion failed\n"
            self.epoch += 1
            self.health[port] = {"role": "writer", "ok": True,
                                 "writer_epoch": self.epoch}
            return 200, {}, json.dumps({"role": "writer",
                                        "epoch": self.epoch}).encode()
        if target == "/demote":
            self.health[port] = {"role": "replica", "ok": True}
            return 200, {}, b'{"role": "replica"}'
        raise AssertionError(target)


def _failover_events(pkg, monkeypatch):
    router_mod, promote_mod = ((port_router, port_promote) if pkg == "port"
                               else (jax_router, jax_promote))
    clock = _Clock()
    monkeypatch.setattr(promote_mod, "time", clock)
    fleet = _Fleet(router_mod)
    monkeypatch.setattr(router_mod, "_http_fetch", fleet.fetch)
    W, A, B, C = 9000, 9001, 9002, 9003
    url = lambda p: f"http://127.0.0.1:{p}"  # noqa: E731
    router = types.SimpleNamespace(
        config=types.SimpleNamespace(writer_grace_ms=1000.0),
        backends=[router_mod.Backend(url(p)) for p in (A, B, C)],
        _writer=router_mod.Backend(url(W)))
    router.backends[0].healthy = False   # ejected: walked last, never here
    fleet.up = {W, A, B, C}
    fleet.health = {W: {"role": "writer", "ok": True, "writer_epoch": 1}}
    fleet.health.update({p: {"role": "replica", "ok": True}
                         for p in (A, B, C)})
    fleet.promote_fails = {B}
    mgr = promote_mod.PromotionManager(router)
    trail = []

    async def cycle(dt):
        clock.now += dt
        await mgr.probe_writer()
        for name in ("_promote_task", "_demote_task"):
            task = getattr(mgr, name, None)
            if task is not None:
                await task
        trail.append((router._writer.url, mgr.dead_since is not None,
                      mgr._deposed_url, mgr.epoch))

    async def drive():
        await cycle(0.0)                 # the writer answers at epoch 1
        fleet.up.discard(W)              # ... then dies
        for dt in (0.2, 0.5, 0.6):       # grace 1,000 ms: promote at 1.3 s
            await cycle(dt)
        await cycle(0.2)                 # the promoted writer answers
        await cycle(0.2)                 # the deposed one is still dark
        fleet.up.add(W)                  # it returns, fenced
        fleet.health[W] = {"role": "writer", "ok": True, "writer_epoch": 1,
                           "fenced": True, "fenced_by_epoch": 2}
        await cycle(0.2)                 # demoted on return
        await cycle(0.2)
        # Grace 0 (operator mode): a fenced writer is replaced by adopting
        # the daemon that already reports itself the writer.
        mgr.grace_ms = 0.0
        router._writer = router_mod.Backend(url(A))
        fleet.health[A] = {"role": "writer", "ok": True, "writer_epoch": 2,
                           "fenced": True}
        router.backends[0].healthy = True
        router.backends[2].last_health = {"role": "writer",
                                          "writer_epoch": 3}
        await cycle(0.2)

    asyncio.run(drive())
    events = [{k: v for k, v in e.items() if k != "ts"} for e in mgr.events]
    return events, trail, fleet.calls, mgr.snapshot()


def test_promotion_manager_matches_jax(monkeypatch):
    """Grace, the walk (the ejected replica skipped, a failing candidate
    passed over), the flip, demote on return and adopt-before-mint: the
    port's manager makes the JAX manager's calls and records its events
    from the same probe answers."""
    promos = METRICS.counter("cluster.promotions").value
    fails = METRICS.counter("cluster.promote_failures").value
    demotes = METRICS.counter("cluster.demotions").value
    port = _failover_events("port", monkeypatch)
    jax = _failover_events("jax", monkeypatch)
    assert port[0] == jax[0]
    assert port[1] == jax[1]
    assert port[2] == jax[2]
    snap_p, snap_j = port[3], jax[3]
    snap_p["events"] = snap_j["events"] = None
    assert snap_p == snap_j
    assert [e["event"] for e in port[0]] == [
        "promote-failed", "promoted", "demoted", "writer-fenced",
        "adopted-writer"]
    promoted = port[0][1]
    assert promoted["url"] == "http://127.0.0.1:9003"
    assert promoted["deposed"] == "http://127.0.0.1:9000"
    # No promotion before the grace ran out.
    assert [t[0] for t in port[1][:3]] == ["http://127.0.0.1:9000"] * 3
    assert METRICS.counter("cluster.promotions").value == promos + 1
    assert METRICS.counter("cluster.promote_failures").value == fails + 1
    assert METRICS.counter("cluster.demotions").value == demotes + 1


# ---------------------------------------------------------------------------
# The router's multi-writer mode (tests/test_cluster.py's classes)
# ---------------------------------------------------------------------------

MERGE_CASES = [
    ("sum", [[{"metric": "m", "tags": {"h": "a"},
               "dps": {"10": 1.0, "20": 2.0}}],
             [{"metric": "m", "tags": {"h": "a"}, "dps": {"30": 3.0}}]]),
    ("sum:1h-avg:m", [[{"metric": "m", "tags": {}, "dps": {"0": 4.0,
                                                           "3600": 6.0}}],
                      [{"metric": "m", "tags": {}, "dps": {"0": 8.0}}]]),
    ("sum", [[{"metric": "m", "tags": {"h": "a"}, "dps": {"10": 1.0}}],
             [{"metric": "m", "tags": {"h": "b"}, "dps": {"10": 2.0}}]]),
    ("max:m", [[{"metric": "m", "tags": {}, "dps": {"10": 5.0},
                 "degraded": "stale"}],
               [{"metric": "m", "tags": {}, "dps": {"10": 9.0, "20": 1.0},
                 "degraded": "rollup-only"}],
               [{"metric": "m", "tags": {}, "dps": {"5": 2.0}}]]),
] + [(f"{agg}:m", [[{"metric": "m", "tags": {}, "dps": {"10": 5.0}}],
                   [{"metric": "m", "tags": {}, "dps": {"10": 9.0}}]])
     for agg in ("sum", "max", "min", "avg", "count")]


@pytest.mark.parametrize("m,parts", MERGE_CASES)
def test_merge_results_equals_jax(m, parts):
    want = jax_router.RouterServer._merge_results(m, json.loads(
        json.dumps(parts)))
    got = port_router.RouterServer._merge_results(m, json.loads(
        json.dumps(parts)))
    assert json.dumps(got) == json.dumps(want)


def test_m_metric_extraction():
    for m in ("sum:cpu.user", "sum:1h-avg:rate:cpu{h=a}", "p95:x.y{a=b,c=d}"):
        assert port_router.RouterServer._m_metric(m) == \
            jax_router.RouterServer._m_metric(m)


class _Cluster:
    """Two in-process port writer daemons and a port router fanning by the
    ownership map."""

    def __init__(self, tmp_path, **router_cfg):
        self.writers, self.servers = [], []
        for i in range(2):
            wal = str(tmp_path / f"store-w{i}" / "wal")
            os.makedirs(os.path.dirname(wal))
            t = TSDB(port_kv.MemKVStore(wal_path=wal),
                     Config(device="cpu", backend="cpu",
                            auto_create_metrics=True, enable_sketches=False,
                            device_window=False, **LOOP),
                     start_compaction_thread=False)
            self.writers.append(t)
            self.servers.append(TSDServer(t))
        self.map_path = str(tmp_path / "CLUSTER.json")
        self.router_cfg = router_cfg
        self.router = None

    def owner(self, metric):
        return port_own.OwnershipMap.load(self.map_path).owner(
            metric.encode())

    async def start(self):
        for s in self.servers:
            await s.start()
        cfg = Config(role="router", router_writers=tuple(
            f"http://127.0.0.1:{s.port}" for s in self.servers),
            cluster_map=self.map_path, probe_interval_s=3600.0, **LOOP,
            **self.router_cfg)
        self.router = port_router.RouterServer(cfg)
        await self.router.start()

    async def stop(self):
        if self.router is not None:
            await self.router.stop()
        await _stop(*self.servers)

    def shutdown(self):
        for t in self.writers:
            t.shutdown()


def _cluster_metric(clu, owner_idx, salt=0):
    m = port_own.OwnershipMap.load(clu.map_path)
    found = 0
    for i in range(2000):
        name = f"clu.m{i}"
        if m.owner(name.encode()) == owner_idx:
            if found == salt:
                return name
            found += 1
    raise AssertionError


def _run_cluster(clu, coro_fn):
    async def main():
        await clu.start()
        try:
            return await coro_fn(clu)
        finally:
            await clu.stop()
    try:
        return asyncio.run(main())
    finally:
        clu.shutdown()


def test_multiwriter_reads_route_by_ownership_and_merge(tmp_path):
    clu = _Cluster(tmp_path)

    async def drive(clu):
        m0, m1 = _cluster_metric(clu, 0), _cluster_metric(clu, 1)
        for mi, metric in ((0, m0), (1, m1)):
            for i in range(30):
                clu.writers[mi].add_point(metric, BT + i * 60, i % 9 + mi,
                                          {"h": "a"})
        q = (f"/q?start={BT - 60}&end={BT + 3600}&m=sum:{m0}&m=sum:{m1}"
             f"&json&nocache")
        await asyncio.sleep(0.3)  # the boot-time probes land
        base = [s.http_rpcs for s in clu.servers]
        status, body = await _http(clu.router.port, q)
        assert status == 200, body
        res = {r["metric"]: r["dps"] for r in json.loads(body)}
        assert len(res[m0]) == 30 and len(res[m1]) == 30
        assert [s.http_rpcs - b for s, b in zip(clu.servers, base)] == [1, 1]
        # A put line routes to its metric's owner.
        reader, writer = await asyncio.open_connection(
            "127.0.0.1", clu.router.port)
        writer.write(f"put {m1} {BT + 3000} 42 h=a\n".encode())
        await writer.drain()
        writer.close()
        await reader.read()
        await asyncio.sleep(0.3)
        status, body = await _http(clu.servers[1].port, q.replace(
            f"&m=sum:{m0}", ""))
        assert json.loads(body)[0]["dps"][str(BT + 3000)] == 42.0
        return True

    assert _run_cluster(clu, drive)


def test_multiwriter_handoff_epoch_bump_and_merged_reads(tmp_path):
    clu = _Cluster(tmp_path)
    handoffs = METRICS.counter("cluster.handoffs").value

    async def drive(clu):
        m0 = _cluster_metric(clu, 0)
        for i in range(20):
            clu.writers[0].add_point(m0, BT + i * 60, 2, {"h": "a"})
        slot = port_own.slot_of(m0.encode(), clu.router.ownership.slots)
        before = clu.router.ownership.epoch
        status, body = await _http(
            clu.router.port, f"/api/cluster/handoff?metric={m0}&to=1")
        assert status == 200, body
        rec = json.loads(body)
        assert rec == {"slot": slot, "from": 0, "to": 1,
                       "epoch": before + 1}
        assert port_own.OwnershipMap.load(clu.map_path).epoch == before + 1
        assert jax_own.OwnershipMap.load(clu.map_path).epoch == before + 1
        assert clu.owner(m0) == 1
        for i in range(20, 30):
            clu.writers[1].add_point(m0, BT + i * 60, 2, {"h": "a"})
        status, body = await _http(
            clu.router.port, f"/q?start={BT - 60}&end={BT + 3600}"
            f"&m=sum:{m0}&json&nocache")
        res = json.loads(body)
        assert status == 200 and len(res) == 1 and len(res[0]["dps"]) == 30
        for bad in ("slot=x&to=1", "to=1", "slot=0&to=x", "slot=99&to=1"):
            status, _ = await _http(clu.router.port,
                                    f"/api/cluster/handoff?{bad}")
            assert status == 400, bad
        return True

    assert _run_cluster(clu, drive)
    assert METRICS.counter("cluster.handoffs").value == handoffs + 1


def test_multiwriter_api_tenants_fans_out_and_merges(tmp_path):
    clu = _Cluster(tmp_path)

    async def drive(clu):
        m0, m1 = _cluster_metric(clu, 0), _cluster_metric(clu, 1)
        for i in range(3):
            clu.writers[0].add_point(m0, BT + i * 60, 1, {"id": str(i)},
                                     tenant="t")
        for i in range(2):
            clu.writers[1].add_point(m1, BT + i * 60, 1, {"id": str(i)},
                                     tenant="t")
        clu.writers[1].add_point(m1, BT, 1, {"id": "u0"}, tenant="u")
        status, body = await _http(clu.router.port, "/api/tenants")
        assert status == 200, body
        data = json.loads(body)
        assert data["enabled"] is True
        assert data["writers"] == 2 and data["writers_unreachable"] == 0
        assert data["tenants"]["t"]["series"] == 5
        assert data["tenants"]["t"]["points"] == 5
        assert data["tenants"]["u"]["series"] == 1
        assert data["tracked_series"] == 6
        assert data["tenants"]["t"]["top_prefixes"]
        return True

    assert _run_cluster(clu, drive)


def test_multiwriter_topology_endpoint(tmp_path):
    clu = _Cluster(tmp_path)

    async def drive(clu):
        status, body = await _http(clu.router.port, "/api/topology")
        assert status == 200
        top = json.loads(body)
        assert len(top["writers"]) == 2 and len(top["replicas"]) == 2
        assert top["ownership"]["epoch"] >= 1
        assert top["ownership"]["slots"] == 64
        assert "hedges" in top["counters"]
        assert "rcache_hit" in top["counters"]
        for r in top["replicas"]:
            assert {"url", "healthy", "ejected", "stale", "lag_ms",
                    "hop_p95_ms"} <= set(r)
        status, body = await _http(clu.router.port, "/topology")
        assert status == 200
        assert b"Cluster topology" in body and b"/api/topology" in body
        return True

    assert _run_cluster(clu, drive)


def test_multiwriter_result_cache_hit_and_epoch_invalidation(tmp_path):
    clu = _Cluster(tmp_path, router_rcache=32, router_rcache_ms=60_000.0)

    async def drive(clu):
        m0 = _cluster_metric(clu, 0)
        for i in range(10):
            clu.writers[0].add_point(m0, BT + i * 60, 1, {"h": "a"})
        q = f"/q?start={BT - 60}&end={BT + 3600}&m=sum:{m0}&json"
        status, body1 = await _http(clu.router.port, q)
        assert status == 200
        rpcs = clu.servers[0].http_rpcs
        status, body2 = await _http(clu.router.port, q)
        assert status == 200 and body2 == body1
        assert clu.servers[0].http_rpcs == rpcs
        assert len(clu.router.rcache) == 1
        await _http(clu.router.port, "/api/cluster/handoff?slot=0&to=1")
        status, _ = await _http(clu.router.port, q)
        assert status == 200
        assert clu.servers[0].http_rpcs > rpcs
        return True

    assert _run_cluster(clu, drive)


def test_router_refuses_writers_that_disagree_with_the_map(tmp_path):
    p = str(tmp_path / "CLUSTER.json")
    port_own.OwnershipMap(["http://127.0.0.1:1", "http://127.0.0.1:2"]).save(p)
    for mod in (port_router, jax_router):
        cfg = (Config if mod is port_router else JaxConfig)(
            role="router", cluster_map=p,
            router_writers=("http://127.0.0.1:3", "http://127.0.0.1:2"))
        with pytest.raises(ValueError) as ei:
            mod.RouterServer(cfg)
        assert "disagrees with the cluster map" in str(ei.value)


def test_promoted_writer_opens_its_tier_once_the_zombie_lets_go(tmp_path):
    """Promoted over a live writer that holds the rollup tier's lock, the
    new writer serves raw and refuses to spill under stale summaries; once
    the deposed writer is demoted (its lock freed), the next checkpoint
    opens the owning tier and spills through it."""
    wal = str(tmp_path / "wal")
    kw = dict(device="cpu", auto_create_metrics=True, device_window=False,
              enable_rollups=True, cluster=True, enable_sketches=False)
    w = cli.make_tsdb(Config(**kw), wal, start_compaction_thread=False)
    ts = BT + np.arange(100, dtype=np.int64) * 600
    w.add_batch("m.t", ts, np.arange(100.0), {"h": "a"})
    w.checkpoint()
    r = cli.make_tsdb(Config(role="replica", **kw), wal, read_only=True,
                      start_compaction_thread=False)
    new = port_epoch.bump_epoch(r.cluster_epoch_path, "r")
    r.promote(new, epoch_guard=guard(r.cluster_epoch_path, new))
    try:
        assert r.rollups is None and r._tier_pending
        r.add_batch("m.t", ts + 86400, np.arange(100.0), {"h": "a"})
        with pytest.raises(RuntimeError, match="rollup tier beside it"):
            r.checkpoint()
        w.demote()
        assert r.checkpoint() > 0
        assert r.rollups is not None and r.rollups.ready
        assert not r._tier_pending
    finally:
        r.shutdown()
        w.shutdown()
