"""The port's delta rollup folds (opentsdb_tpu_torch/rollup/delta.py):
byte-parity with its own full re-read fold and with the JAX package's
records, mirroring tests/test_rollup_delta.py.

Every scenario runs three daemons on the same seeded ingest: the port
with delta folds, the port without (every fold re-reads the raw rows),
and the JAX package (delta folds on, its default). Every stored rollup
cell, moment and sketch columns at every resolution, must be
byte-identical across the three, at 1 and 4 shards, through append-only
checkpoint cycles, integers past 2^53, backfill, deletes and scalar
puts, duplicate re-ingest, compaction, the eviction cap and a restart
over prior data; and the fast path must engage where the JAX tests say
it does (or fall back where they say it does)."""

import functools
import os

import numpy as np
import pytest

from opentsdb_tpu.core.tsdb import TSDB as JaxTSDB
from opentsdb_tpu.storage.kv import MemKVStore as JaxKV
from opentsdb_tpu.storage.sharded import ShardedKVStore as JaxSharded
from opentsdb_tpu.utils.config import Config as JaxConfig
from opentsdb_tpu_torch.core.tsdb import TSDB
from opentsdb_tpu_torch.query.executor import QueryExecutor, QuerySpec
from opentsdb_tpu_torch.rollup.summary import ROLLUP_FAMILY
from opentsdb_tpu_torch.storage.kv import MemKVStore
from opentsdb_tpu_torch.storage.sharded import ShardedKVStore
from opentsdb_tpu_torch.utils.config import Config

BASE = 1356998400
METRIC = "delta.metric"
COMMON = dict(auto_create_metrics=True, enable_rollups=True,
              enable_sketches=False, device_window=False, backend="cpu",
              rollup_catchup="sync")


def port_tsdb(path, shards=1, delta=True, **over):
    os.makedirs(path, exist_ok=True)
    cfg = Config(device="cpu", rollup_delta_fold=delta,
                 **{**COMMON, **over})
    store = (ShardedKVStore(path, shards=shards) if shards > 1
             else MemKVStore(wal_path=os.path.join(path, "wal")))
    return TSDB(store, cfg, start_compaction_thread=False)


def jax_tsdb(path, shards=1, **over):
    os.makedirs(path, exist_ok=True)
    wal = os.path.join(path, "wal")
    cfg = JaxConfig(wal_path=wal, shards=shards, **{**COMMON, **over})
    store = (JaxSharded(path, shards=shards) if shards > 1
             else JaxKV(wal_path=wal))
    return JaxTSDB(store, cfg, start_compaction_thread=False)


def dump_records(tsdb):
    """Every rollup cell of the tier: {(res, shard, key, qual): value}."""
    tier = tsdb.rollups
    out = {}
    for r, stores in tier.stores.items():
        for si, s in enumerate(stores):
            for key, items in s.scan_raw(tier.table, b"", b"",
                                         family=ROLLUP_FAMILY):
                for q, v in items:
                    out[(r, si, bytes(key), bytes(q))] = bytes(v)
    return out


def assert_same_records(*tsdbs):
    first = dump_records(tsdbs[0])
    assert first
    for t in tsdbs[1:]:
        other = dump_records(t)
        assert set(other) == set(first)
        diff = [k for k in first if first[k] != other[k]]
        assert not diff, f"{len(diff)} rollup cells differ: {diff[:3]}"


def batches(series=3, cycles=3, hours=30, step=60, seed=7,
            big_ints=False):
    """Per-cycle per-series append-only batches (the JAX test's): mixed
    int and float typing, float32-stressing values, optionally integers
    above 2^53."""
    rng = np.random.default_rng(seed)
    per = (hours * 3600) // step // cycles
    for c in range(cycles):
        out = []
        for i in range(series):
            ts = (BASE + c * per * step
                  + np.arange(0, per * step, step, dtype=np.int64)
                  + int(rng.integers(0, step // 3)))
            if big_ints and i == 0:
                vals = rng.integers(1 << 52, 1 << 60, len(ts))
            elif i % 2:
                vals = rng.integers(-1000, 1000, len(ts))
            else:
                vals = rng.normal(0.1, 3.0, len(ts))
            out.append((f"h{i}", ts, vals))
        yield out


def drive(tsdb, gen):
    for cycle in gen:
        for host, ts, vals in cycle:
            tsdb.add_batch(METRIC, ts, vals, {"host": host})
        tsdb.checkpoint()


class Trio:
    """The port with and without delta folds, and the JAX package."""

    def __init__(self, tmp_path, shards=1, **over):
        self.d = port_tsdb(str(tmp_path / "d"), shards, True, **over)
        self.f = port_tsdb(str(tmp_path / "f"), shards, False)
        self.j = jax_tsdb(str(tmp_path / "j"), shards, **over)

    def __iter__(self):
        return iter((self.d, self.f, self.j))

    def close(self):
        for t in self:
            t.shutdown()


@pytest.fixture
def trio_of(tmp_path):
    made = []

    def make(shards=1, **over):
        made.append(Trio(tmp_path, shards, **over))
        return made[-1]

    yield make
    for t in made:
        t.close()


@pytest.mark.parametrize("shards", [1, 4])
def test_append_only_parity_and_engagement(trio_of, shards):
    tr = trio_of(shards)
    for t in tr:
        drive(t, batches())
    assert_same_records(tr.d, tr.f, tr.j)
    assert tr.f.rollups.delta is None
    assert tr.d.rollups.fold_delta > 0 and tr.d.rollups.delta.served > 0
    assert tr.d.rollups.fold_full == 0
    assert (tr.d.rollups.fold_delta, tr.d.rollups.fold_full) == (
        tr.j.rollups.fold_delta, tr.j.rollups.fold_full)
    spec = QuerySpec(METRIC, {}, "sum", downsample=(3600, "sum"))
    ra, pa, _ = QueryExecutor(tr.d, backend="cpu").run_with_plan(
        spec, BASE, BASE + 40 * 3600)
    rb, pb, _ = QueryExecutor(tr.f, backend="cpu").run_with_plan(
        spec, BASE, BASE + 40 * 3600)
    assert pa == pb == "1h"
    np.testing.assert_array_equal(ra[0].values, rb[0].values)


@pytest.mark.parametrize("shards", [1, 4])
def test_device_kind_delta_folds_batch_the_plan(tmp_path, monkeypatch,
                                                shards):
    """A device-kind tier (rollup_device_fold, the plain version here)
    folds a delta plan's series in one call of the group fold; its cells
    are byte for byte those of the same tier folding one series at a
    time through window_summaries_device, and of the same tier without
    delta folds."""
    from opentsdb_tpu_torch.rollup import summary as port_summary
    calls = []
    group = port_summary.group_summaries_device

    def counted(ts, vals, bounds, *a, **k):
        calls.append(len(bounds) - 1)
        return group(ts, vals, bounds, *a, **k)

    monkeypatch.setattr(port_summary, "group_summaries_device", counted)
    grouped = port_tsdb(str(tmp_path / "g"), shards, True,
                        rollup_device_fold=True)
    single = port_tsdb(str(tmp_path / "s"), shards, True,
                       rollup_device_fold=True)
    single.rollups._group_fold = functools.partial(
        port_summary.group_summaries,
        fold=functools.partial(port_summary.window_summaries_device,
                               device="cpu"))
    full = port_tsdb(str(tmp_path / "f"), shards, False,
                     rollup_device_fold=True)
    try:
        for t in (grouped, single):
            drive(t, batches(series=5))
        n_delta = len(calls)
        drive(full, batches(series=5))
        assert grouped.rollups.delta.served > 0
        assert single.rollups.delta.served == grouped.rollups.delta.served
        assert grouped.rollups.fold_full == 0
        # Every delta-served group took one call for all its series.
        assert n_delta > 0 and max(calls[:n_delta]) > 1
        assert_same_records(grouped, single, full)
        assert grouped.rollups.fold_kind == "device-f64"
    finally:
        for t in (grouped, single, full):
            t.shutdown()


@pytest.mark.parametrize("shards", [1, 4])
def test_big_int_parity(trio_of, shards):
    tr = trio_of(shards)
    for t in tr:
        drive(t, batches(big_ints=True))
    assert_same_records(tr.d, tr.f, tr.j)
    assert tr.d.rollups.fold_delta > 0


@pytest.mark.parametrize("shards", [1, 4])
def test_backfill_into_folded_window(trio_of, shards):
    tr = trio_of(shards)
    late = BASE + np.arange(30, 3600, 300, dtype=np.int64)
    for t in tr:
        drive(t, batches(cycles=2, hours=20))
        t.add_batch(METRIC, late, np.full(len(late), 2.5), {"host": "h0"})
        t.add_batch(METRIC, late + 7, np.full(len(late), 3.5),
                    {"host": "h9"})
        t.checkpoint()
    assert_same_records(tr.d, tr.f, tr.j)
    assert tr.d.rollups.fold_delta > 0


@pytest.mark.parametrize("shards", [1, 4])
def test_delete_and_scalar_put_parity(trio_of, shards):
    """A raw delete (the store's delete hook) and a scalar add_point (the
    feed bypass) force the full path; the records stay identical, count-0
    zeroing of the deleted row included."""
    tr = trio_of(shards)
    for t in tr:
        drive(t, batches(cycles=2, hours=20))
        t.add_point(METRIC, BASE + 26 * 3600 + 11, 42, {"host": "h0"})
        key = t.row_key_for(METRIC, {"host": "h1"}, BASE)
        t.store.delete_row(t.table, key)
        t.checkpoint()
    assert_same_records(tr.d, tr.f, tr.j)
    assert tr.d.rollups.delta.killed == tr.j.rollups.delta.killed > 0


def test_duplicate_reingest_falls_back(trio_of):
    tr = trio_of()
    ts = BASE + np.arange(0, 7200, 60, dtype=np.int64)
    vals = np.arange(len(ts), dtype=np.int64)
    for t in tr:
        t.add_batch(METRIC, ts, vals, {"host": "h0"})
        t.add_batch(METRIC, ts[:40], vals[:40], {"host": "h0"})
        t.checkpoint()
    assert_same_records(tr.d, tr.f, tr.j)
    assert tr.d.rollups.fold_full > 0 and tr.d.rollups.fold_delta == 0


def test_compaction_preserves_eligibility(trio_of):
    tr = trio_of()
    ts1 = BASE + np.arange(0, 1800, 60, dtype=np.int64)
    ts2 = BASE + np.arange(1800, 3600, 60, dtype=np.int64)
    for t in tr:
        t.add_batch(METRIC, ts1, ts1 % 97, {"host": "h0"})
        t.add_batch(METRIC, ts2, ts2 % 89, {"host": "h0"})
        t.compact_row(t.row_key_for(METRIC, {"host": "h0"}, BASE))
        t.checkpoint()
    assert_same_records(tr.d, tr.f, tr.j)
    assert tr.d.rollups.fold_delta > 0 and tr.d.rollups.fold_full == 0


def test_eviction_cap_falls_back_soundly(trio_of):
    tr = trio_of(rollup_delta_points=64)
    for t in tr:
        drive(t, batches())
    assert_same_records(tr.d, tr.f, tr.j)
    assert tr.d.rollups.delta.evicted == tr.j.rollups.delta.evicted > 0


def test_restart_over_prior_data_falls_back(tmp_path):
    """A reopened process has empty buffers: appends to a coarse window
    folded before it must take the full path (the prior-records check),
    and the records equal a full fold's and the JAX package's."""
    ts1 = BASE + np.arange(0, 1800, 60, dtype=np.int64)
    ts2 = BASE + 3600 + np.arange(0, 1800, 60, dtype=np.int64)
    path = str(tmp_path / "d")
    t = port_tsdb(path)
    t.add_batch(METRIC, ts1, ts1 % 97, {"host": "h0"})
    t.checkpoint()
    t.shutdown()
    t = port_tsdb(path)
    tf = port_tsdb(str(tmp_path / "f"), delta=False)
    j = jax_tsdb(str(tmp_path / "j"))
    try:
        t.add_batch(METRIC, ts2, ts2 % 89, {"host": "h0"})
        t.checkpoint()
        for other in (tf, j):
            other.add_batch(METRIC, ts1, ts1 % 97, {"host": "h0"})
            other.checkpoint()
            other.add_batch(METRIC, ts2, ts2 % 89, {"host": "h0"})
            other.checkpoint()
        assert_same_records(t, tf, j)
        assert t.rollups.fold_full > 0 and t.rollups.fold_delta == 0
    finally:
        for x in (t, tf, j):
            x.shutdown()
