"""Series-sharded storage: N independent ``MemKVStore`` shards behind one
``KVStore``.

Mirrors ``opentsdb_tpu/storage/sharded.py`` of the JAX package, copied
rather than imported, with the same directory layout and routing, so each
package opens, ingests into and checkpoints the other's sharded stores:

    <dir>/SHARDS.json          the pinned layout (written atomically)
    <dir>/shard-<i>/wal[...]   shard i, a MemKVStore with its own WAL,
                               generations, manifest and flock
    <dir>/TENANTS.json         the tenant snapshot (core/tsdb.py)
    <dir>/store.sketches       the sketch snapshot (naming root <dir>/store)

One store funnels every write through one memtable lock, one WAL and one
generation tier, so its whole-history checkpoint is the largest ingest
stall at scale. Rows partition by a stable hash of the row key's series
identity (metric UID + tag UID pairs; the base-time bytes are left out,
so every row-hour of a series lands in one shard):

- **Ingest** routes columnar batches without re-encoding: ``add_batch``
  sends one series per ``put_many_columnar`` call, so the key blob flows
  to one shard untouched; mixed batches split into per-shard sub-blobs by
  numpy row indexing.
- **Checkpoint** runs every shard's three-phase spill in a bounded worker
  pool; each freeze is its own brief per-shard lock, and the generation
  caps are staggered across shards (shard i caps at base + i % min(n, 8))
  so size-tiered collapses fall on different checkpoints. The pause a
  writer can see is one shard's spill, not the whole history's. While any
  fault point is armed the shards spill serially, with the
  ``sharded.spill.shard`` fault point after each.
- **Reads** fan a scan out and merge the ordered per-shard iterators
  (keys are disjoint across shards, so the merge is an interleave); a
  series hint drops the shards no candidate routes to before the fan-out
  (``bloom_shards_skipped``). Point operations route.

Durability: each shard is a ``MemKVStore`` (per-shard WAL replay,
manifest and flock); the count and routing are pinned by ``SHARDS.json``
and reopening with another count, data table or routing is a hard error.
There is no cross-shard atomic cut: a crash recovers each shard to its own
last durable record.

The rollup tier's surface (``record_spill_keys``, ``peek_spill_keys`` /
``take_spill_keys``, ``pending_keys``, ``delete_hook``, ``spilled``) fans
out over the shards; the tier keeps ``shard-<i>/rollup-<res>/`` beside
each shard and ``ROLLUP.json`` at the root.

Replicas and the cluster tier (ROADMAP item 10a): ``read_only=True``
opens every shard as a replica (a replica cannot create a sharded store),
``refresh`` catches each shard up, ``rebuilds`` and
``fenced_bytes_refused`` sum over them. One epoch (``EPOCH.json`` at the
root, beside ``SHARDS.json``) covers all shards, and one guard is shared
by every shard's mutation path. ``promote_writable`` is all or nothing:
a shard that fails demotes the promoted prefix back; ``demote_readonly``
demotes every shard.

``sstable_codec`` sets every shard's spill codec; ``compress_stats`` and
``encoded_range`` fan in over the shards (the fused query plan's source
check: shards are key-disjoint by the series routing, so the union of
their disjoint spans is disjoint).

Instruments (``obs/``): a traced scan gets one ``shard.scan`` span per
shard (the time pulled from that shard's iterator), and each shard's
spill the ``checkpoint.shard_spill`` timer tagged with its index.
"""

from __future__ import annotations

import heapq
import json
import os
import time
import zlib
from concurrent.futures import ThreadPoolExecutor
from typing import Iterator

import numpy as np

from opentsdb_tpu_torch.core.const import TIMESTAMP_BYTES, UID_WIDTH
from opentsdb_tpu_torch.core.errors import PleaseThrottleError
from opentsdb_tpu_torch.fault import faultpoints as _fp
from opentsdb_tpu_torch.obs import trace as _trace
from opentsdb_tpu_torch.obs.registry import METRICS as _metrics
from opentsdb_tpu_torch.storage.kv import (Cell, KVStore, MemKVStore,
                                           write_tenant_marker)

MANIFEST_NAME = "SHARDS.json"
# The tenant snapshot's name at the root (the JAX package's
# tenant/accounting.py STATE_NAME).
TENANTS_NAME = "TENANTS.json"

# Byte range of the row key holding the base time (left out of the routing
# hash so a series never straddles shards).
_TS_LO = UID_WIDTH
_TS_HI = UID_WIDTH + TIMESTAMP_BYTES


def manifest_path(dir_path: str) -> str:
    return os.path.join(dir_path, MANIFEST_NAME)


class ShardedKVStore(KVStore):
    """N series-hash-partitioned MemKVStore shards behind one KVStore.

    ``dir_path=None`` builds an in-memory sharded store (no WALs, no
    manifest) for tests.

    On a mid-batch ``PleaseThrottleError`` the attached
    ``partial_existed`` is full length (one flag per input cell, False for
    cells that did not apply), since cells route to shards out of input
    order; every True cell applied onto an existing row, which is all its
    one consumer (the compaction queue) reads."""

    def __init__(self, dir_path: str | None, shards: int | None = None,
                 data_table: str = "tsdb",
                 throttle_rows: int | None = None,
                 fsync: bool = False, read_only: bool = False,
                 writer_epoch: int | None = None,
                 epoch_guard=None) -> None:
        self._dir = dir_path
        self.data_table = data_table
        self.read_only = read_only
        self.writer_epoch = writer_epoch
        self.epoch_guard = epoch_guard
        # Whole shards dropped from a fan-out by the series hint.
        self.bloom_shards_skipped = 0
        # Seconds each shard's last checkpoint took, by shard index.
        self.spill_seconds: list[float] = []
        created_manifest = False
        if dir_path is not None:
            man = manifest_path(dir_path)
            if os.path.exists(man):
                with open(man) as f:
                    rec = json.load(f)
                n_disk = int(rec["shards"])
                if shards is not None and shards != n_disk:
                    raise ValueError(
                        f"shard-count mismatch: store at {dir_path!r} "
                        f"was created with {n_disk} shards, reopen "
                        f"requested {shards} (rows would route to the "
                        f"wrong shard; re-shard via export/import)")
                if rec.get("data_table", data_table) != data_table:
                    raise ValueError(
                        f"data-table mismatch: store at {dir_path!r} "
                        f"routes table {rec['data_table']!r} by series, "
                        f"reopen requested {data_table!r}")
                # The routing parameters pin as hard as the count: a
                # build hashing other byte ranges would route point ops
                # to the wrong shard.
                if rec.get("version", 1) != 1 or list(
                        rec.get("series_bytes_excluded",
                                [_TS_LO, _TS_HI])) != [_TS_LO, _TS_HI]:
                    raise ValueError(
                        f"routing mismatch: store at {dir_path!r} was "
                        f"created with manifest version "
                        f"{rec.get('version')} / series bytes "
                        f"{rec.get('series_bytes_excluded')}, this "
                        f"build routes with v1 / {[_TS_LO, _TS_HI]}")
                n = n_disk
            else:
                if read_only:
                    raise FileNotFoundError(
                        f"no {MANIFEST_NAME} at {dir_path!r}: a replica "
                        f"cannot create a sharded store")
                if shards is None:
                    raise ValueError(
                        f"no {MANIFEST_NAME} at {dir_path!r} and no "
                        f"shard count given")
                n = shards
                if n >= 1:
                    self._write_manifest(dir_path, n, data_table)
                    created_manifest = True
        else:
            if shards is None:
                raise ValueError("in-memory sharded store needs an "
                                 "explicit shard count")
            n = shards
        if n < 1:
            raise ValueError(f"shard count must be >= 1, got {n}")
        self.shard_count = n
        # The naming root of the store-global snapshots (TSDB's
        # _sketch_path): they live beside the manifest, in no shard.
        self._wal_path = (os.path.join(dir_path, "store")
                          if dir_path else None)
        per_throttle = (None if throttle_rows is None
                        else max((throttle_rows + n - 1) // n, 1))
        self.shards: list[MemKVStore] = []
        try:
            for i in range(n):
                wal = (os.path.join(dir_path, f"shard-{i}", "wal")
                       if dir_path else None)
                # Staggered generation caps: every shard receives ~1/N of
                # each spill, so with equal caps every shard would
                # collapse on the same checkpoint and the pauses would
                # line up into one whole-history stall.
                self.shards.append(MemKVStore(
                    wal_path=wal, throttle_rows=per_throttle, fsync=fsync,
                    max_generations=(MemKVStore._MAX_GENERATIONS
                                     + i % min(n, 8)),
                    read_only=read_only, writer_epoch=writer_epoch,
                    epoch_guard=epoch_guard))
        except BaseException:
            for s in self.shards:
                try:
                    s.close()
                except Exception:
                    pass
            if created_manifest:
                # A first creation that failed (a shard's lock held, the
                # disk full) must not pin a count for a store holding no
                # data: every retry with another count would fail.
                try:
                    os.unlink(manifest_path(dir_path))
                except OSError:
                    pass
            raise

    @staticmethod
    def _write_manifest(dir_path: str, n: int, data_table: str) -> None:
        """Pin the layout atomically (tmp + rename + directory fsync, the
        per-shard manifests' contract)."""
        os.makedirs(dir_path, exist_ok=True)
        man = manifest_path(dir_path)
        tmp = man + ".tmp"
        with open(tmp, "w") as f:
            json.dump({"version": 1, "shards": n,
                       "data_table": data_table,
                       "series_bytes_excluded": [_TS_LO, _TS_HI]}, f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, man)
        dfd = os.open(dir_path, os.O_RDONLY)
        try:
            os.fsync(dfd)
        finally:
            os.close(dfd)

    # -- routing ----------------------------------------------------------

    def _route(self, table: str, key: bytes) -> int:
        """The shard of a key: a data-table key hashes its series bytes
        (base time left out) with crc32, which is also the series bloom's
        identity hash (``sstable.series_hash``); other keys hash whole.
        Identical across processes, restarts and both packages."""
        if self.shard_count == 1:
            return 0
        if table == self.data_table and len(key) >= _TS_HI:
            h = zlib.crc32(key[_TS_HI:], zlib.crc32(key[:_TS_LO]))
        else:
            h = zlib.crc32(key)
        return h % self.shard_count

    # -- point operations (route and delegate) ------------------------------

    def get(self, table: str, key: bytes,
            family: bytes | None = None) -> list[Cell]:
        return self.shards[self._route(table, key)].get(table, key, family)

    def has_row(self, table: str, key: bytes) -> bool:
        return self.shards[self._route(table, key)].has_row(table, key)

    def cell_count(self, table: str, key: bytes) -> int:
        return self.shards[self._route(table, key)].cell_count(table, key)

    def row_count(self, table: str) -> int:
        return sum(s.row_count(table) for s in self.shards)

    def put(self, table: str, key: bytes, family: bytes, qualifier: bytes,
            value: bytes, durable: bool = True) -> None:
        self.shards[self._route(table, key)].put(
            table, key, family, qualifier, value, durable=durable)

    def delete(self, table: str, key: bytes, family: bytes,
               qualifiers: list[bytes]) -> None:
        self.shards[self._route(table, key)].delete(
            table, key, family, qualifiers)

    def delete_row(self, table: str, key: bytes) -> None:
        self.shards[self._route(table, key)].delete_row(table, key)

    def atomic_increment(self, table: str, key: bytes, family: bytes,
                         qualifier: bytes, amount: int = 1) -> int:
        return self.shards[self._route(table, key)].atomic_increment(
            table, key, family, qualifier, amount)

    def compare_and_set(self, table: str, key: bytes, family: bytes,
                        qualifier: bytes, expected: bytes | None,
                        value: bytes) -> bool:
        return self.shards[self._route(table, key)].compare_and_set(
            table, key, family, qualifier, expected, value)

    # -- batched writes -----------------------------------------------------

    def put_many(self, table: str, family: bytes,
                 cells: list[tuple[bytes, bytes, bytes]],
                 durable: bool = True, sync: bool = True) -> list[bool]:
        if self.shard_count == 1:
            return self.shards[0].put_many(table, family, cells,
                                           durable=durable, sync=sync)
        by_shard: dict[int, list[int]] = {}
        for i, (key, _, _) in enumerate(cells):
            by_shard.setdefault(self._route(table, key), []).append(i)
        existed = [False] * len(cells)
        for si in sorted(by_shard):
            idx = by_shard[si]
            try:
                flags = self.shards[si].put_many(
                    table, family, [cells[i] for i in idx],
                    durable=durable, sync=sync)
            except PleaseThrottleError as e:
                for i, f in zip(idx, getattr(e, "partial_existed", [])):
                    existed[i] = f
                e.partial_existed = existed  # full length (class doc)
                raise
            for i, f in zip(idx, flags):
                existed[i] = f
        return existed

    def put_many_columnar(self, table: str, family: bytes,
                          key_blob: bytes, key_len: int,
                          quals: list[bytes], vals: list[bytes],
                          durable: bool = True,
                          sync: bool = True) -> list[bool]:
        n = len(quals)
        if len(vals) != n or len(key_blob) != n * key_len:
            raise ValueError(
                f"columnar batch mismatch: {len(key_blob)} key bytes, "
                f"key_len {key_len}, {n} quals, {len(vals)} vals")
        if n == 0:
            return []
        if self.shard_count == 1:
            return self.shards[0].put_many_columnar(
                table, family, key_blob, key_len, quals, vals,
                durable=durable, sync=sync)
        L = key_len
        mat = np.frombuffer(key_blob, np.uint8).reshape(n, L)
        # One series per batch (add_batch's shape: keys differ only in
        # their base-time bytes): one route, and the blob flows to the
        # shard's columnar WAL record unchanged.
        if table == self.data_table and L >= _TS_HI:
            same = bool(
                (mat[:, :_TS_LO] == mat[0, :_TS_LO]).all()
                and (mat[:, _TS_HI:] == mat[0, _TS_HI:]).all())
        else:
            same = n == 1 or key_blob == key_blob[:L] * n
        if same:
            return self.shards[self._route(table, key_blob[:L])] \
                .put_many_columnar(table, family, key_blob, L, quals,
                                   vals, durable=durable, sync=sync)
        # A mixed batch: route per key and regroup into per-shard
        # sub-blobs (a numpy row gather keeps them columnar).
        routes = np.fromiter(
            (self._route(table, key_blob[i * L:(i + 1) * L])
             for i in range(n)), np.int64, n)
        existed = [False] * n
        for si in np.unique(routes):
            idx = np.flatnonzero(routes == si)
            try:
                flags = self.shards[int(si)].put_many_columnar(
                    table, family, mat[idx].tobytes(), L,
                    [quals[i] for i in idx], [vals[i] for i in idx],
                    durable=durable, sync=sync)
            except PleaseThrottleError as e:
                for i, f in zip(idx.tolist(),
                                getattr(e, "partial_existed", [])):
                    existed[i] = f
                e.partial_existed = existed
                raise
            for i, f in zip(idx.tolist(), flags):
                existed[i] = f
        return existed

    # -- scans (cross-shard fan-in) -----------------------------------------

    def scan_raw(self, table: str, start: bytes, stop: bytes,
                 family: bytes | None = None,
                 key_regexp: bytes | None = None,
                 series_hint=None,
                 ) -> Iterator[tuple[bytes, list[tuple[bytes, bytes]]]]:
        """Fan-in scan. With a ``series_hint`` (uint64 identity hashes, a
        superset of the series the caller keeps) the fan-out first drops
        the shards no candidate routes to: the routing hash is the
        identity hash, so ``h % N`` is exact. Then each shard's series
        blooms prune its generations."""
        shards = self.shards
        if (series_hint is not None and len(series_hint)
                and table == self.data_table and self.shard_count > 1):
            live = np.unique(series_hint
                             % np.uint64(self.shard_count)).tolist()
            if len(live) < self.shard_count:
                self.bloom_shards_skipped += self.shard_count - len(live)
                shards = [self.shards[int(i)] for i in live]
        its = [s.scan_raw(table, start, stop, family=family,
                          key_regexp=key_regexp, series_hint=series_hint)
               for s in shards]
        parent = _trace.current_span()
        if parent is not None:
            # Per-shard fan-out spans: each accumulates only the time
            # spent pulling from its shard's iterator (the heap merge
            # interleaves them) and attaches to the span current at
            # fan-out time once its iterator is exhausted.
            idx_of = {id(s): i for i, s in enumerate(self.shards)}
            its = [_trace.timed_iter(it, parent, "shard.scan",
                                     {"shard": idx_of[id(s)]})
                   for it, s in zip(its, shards)]
            if len(shards) < self.shard_count:
                parent.tags["shards_skipped"] = (
                    self.shard_count - len(shards))
        return heapq.merge(*its, key=lambda row: row[0])

    # -- memtable introspection (the start-up re-folds) ---------------------

    def memtable_keys(self, table: str) -> list[bytes]:
        out: list[bytes] = []
        for s in self.shards:
            out.extend(s.memtable_keys(table))
        return out

    def memtable_cells(self, table: str, key: bytes,
                       family: bytes | None = None) -> list[Cell]:
        return self.shards[self._route(table, key)].memtable_cells(
            table, key, family)

    @property
    def wal_group_ms(self) -> float:
        return self.shards[0].wal_group_ms if self.shards else 0.0

    @wal_group_ms.setter
    def wal_group_ms(self, ms: float) -> None:
        for s in self.shards:
            s.wal_group_ms = ms

    @property
    def wal_group_flushes(self) -> int:
        return sum(s.wal_group_flushes for s in self.shards)

    def wal_barrier(self, ticket: int | None = None) -> None:
        """Group-commit barrier across every shard (per-shard tickets are
        not comparable store-wide, so it waits for each shard's own
        current watermark)."""
        for s in self.shards:
            s.wal_barrier()

    @property
    def mutation_seq(self) -> int:
        return sum(s.mutation_seq for s in self.shards)

    @property
    def mutation_seqs(self) -> tuple[int, ...]:
        """Per-shard mutation seqs, so consumers can revalidate per shard
        instead of treating a put anywhere as a change everywhere."""
        return tuple(s.mutation_seq for s in self.shards)

    def pending_keys(self, table: str) -> list[bytes]:
        out: list[bytes] = []
        for s in self.shards:
            out.extend(s.pending_keys(table))
        return out

    def peek_spill_keys(self) -> dict[str, list[bytes]]:
        out: dict[str, list[bytes]] = {}
        for s in self.shards:
            for name, ks in s.peek_spill_keys().items():
                out.setdefault(name, []).extend(ks)
        return out

    def take_spill_keys(self) -> dict[str, list[bytes]]:
        out: dict[str, list[bytes]] = {}
        for s in self.shards:
            for name, ks in s.take_spill_keys().items():
                out.setdefault(name, []).extend(ks)
        return out

    @property
    def record_spill_keys(self) -> bool:
        return all(s.record_spill_keys for s in self.shards)

    @record_spill_keys.setter
    def record_spill_keys(self, value: bool) -> None:
        for s in self.shards:
            s.record_spill_keys = value

    @property
    def delete_hook(self):
        return self.shards[0].delete_hook if self.shards else None

    @delete_hook.setter
    def delete_hook(self, fn) -> None:
        for s in self.shards:
            s.delete_hook = fn

    @property
    def spilled(self) -> bool:
        return any(s.spilled for s in self.shards)

    def dirty_bases(self, table: str) -> np.ndarray:
        """Union of every shard's dirty-base set (each with its undrained
        spill record), sorted unique."""
        arrs = [a for a in (s.dirty_bases(table) for s in self.shards)
                if len(a)]
        if not arrs:
            return np.empty(0, np.int64)
        if len(arrs) == 1:
            return arrs[0]
        return np.unique(np.concatenate(arrs))

    def chunk_state(self, table: str, lo: int, hi: int):
        """Per-shard fragment-cache validation vectors (see
        ``MemKVStore.chunk_state``); ``dirty`` is the OR across shards,
        since a fan-in fragment merges every shard's rows."""
        epochs: list[int] = []
        floors: list[int] = []
        marks: list[int] = []
        dirty = False
        for s in self.shards:
            e, f, m, d = s.chunk_state(table, lo, hi)
            epochs.extend(e)
            floors.extend(f)
            marks.extend(m)
            dirty = dirty or d
        return tuple(epochs), tuple(floors), tuple(marks), dirty

    @property
    def bloom_files_skipped(self) -> int:
        return sum(s.bloom_files_skipped for s in self.shards)

    @property
    def bloom_point_skips(self) -> int:
        return sum(s.bloom_point_skips for s in self.shards)

    @property
    def wal_swallowed_flush_errors(self) -> int:
        return sum(s.wal_swallowed_flush_errors for s in self.shards)

    def memtable_row_counts(self, table: str) -> list[int]:
        """Live-memtable rows per shard, in shard order."""
        return [s.memtable_row_counts(table)[0] for s in self.shards]

    def sstable_format_bytes(self) -> dict[int, int]:
        """On-disk generation bytes by format version, over every
        shard."""
        out: dict[int, int] = {}
        for s in self.shards:
            for fmt, n in s.sstable_format_bytes().items():
                out[fmt] = out.get(fmt, 0) + n
        return out

    @property
    def sstable_codec(self) -> str:
        return self.shards[0].sstable_codec if self.shards else "none"

    @sstable_codec.setter
    def sstable_codec(self, codec: str) -> None:
        for s in self.shards:
            s.sstable_codec = codec

    def compress_stats(self) -> tuple[int, int]:
        raw = enc = 0
        for s in self.shards:
            r, e = s.compress_stats()
            raw += r
            enc += e
        return raw, enc

    def encoded_range(self, table: str, start: bytes,
                      stop: bytes | None):
        """Per-shard encoded_range fan-in; None if any shard declines."""
        out = []
        for s in self.shards:
            got = s.encoded_range(table, start, stop)
            if got is None:
                return None
            out.extend(got)
        return out

    @property
    def open_seconds(self) -> dict:
        return {k: sum(s.open_seconds[k] for s in self.shards)
                for k in ("generations", "replay")}

    # -- lifecycle ----------------------------------------------------------

    def ensure_table(self, table: str) -> None:
        for s in self.shards:
            s.ensure_table(table)

    def flush(self) -> None:
        for s in self.shards:
            s.flush()

    def checkpoint(self, tenant_marker: bool = True) -> int:
        """Checkpoint every shard, their spills overlapped in a bounded
        worker pool; returns the rows spilled. Each shard's freeze is its
        own brief lock, so ingest into other shards never waits, and the
        longest pause a writer can see is one shard's spill.
        ``spill_seconds`` keeps each shard's time.

        The snapshots are store-global: ``TENANTS.json`` sits at the root,
        so ``tenant_marker`` writes its version-0 marker there, once, and
        every shard checkpoints with ``tenant_marker=False`` (a shard
        writes no tenant file of its own)."""
        if self._dir is None or self.read_only:
            return 0
        self._retire_root(tenant_marker)
        self.spill_seconds = [0.0] * self.shard_count
        if _fp.active():
            # A fault point is armed: spill serially, so the hit schedule
            # and with it the crash state are deterministic. The join site
            # fires after each shard's spill, so a crash at hit k leaves
            # exactly k shards spilled.
            total = 0
            for i in range(self.shard_count):
                total += self._timed_spill(i)
                _fp.fire("sharded.spill.shard", self._dir)
            return total
        if self.shard_count == 1:
            return self._timed_spill(0)
        workers = min(self.shard_count, max(os.cpu_count() or 2, 2))
        with ThreadPoolExecutor(max_workers=workers,
                                thread_name_prefix="shard-spill") as pool:
            return sum(pool.map(self._timed_spill,
                                range(self.shard_count)))

    def _timed_spill(self, i: int) -> int:
        """One shard's checkpoint, timed per shard: ``spill_seconds[i]``
        and the ``checkpoint.shard_spill`` timer tagged with the shard
        (a writer blocks on one shard's spill; the per-shard timer shows
        the skew)."""
        t0 = time.perf_counter()
        try:
            with _metrics.timer("checkpoint.shard_spill",
                                {"shard": str(i)}).time():
                return self.shards[i].checkpoint(tenant_marker=False)
        finally:
            self.spill_seconds[i] = time.perf_counter() - t0

    def _retire_root(self, tenant_marker: bool) -> None:
        """The root's share of ``MemKVStore._retire_snapshots``: refuse a
        rollup tier on disk (``shard-<i>/rollup-<res>/``) unless it is
        open (``record_spill_keys``), and write the version-0 tenant
        marker at the root when asked."""
        for i in range(self.shard_count if not self.record_spill_keys
                       else 0):
            d = os.path.join(self._dir, f"shard-{i}")
            rollups = sorted(fn for fn in os.listdir(d)
                             if fn.startswith("rollup"))
            if rollups:
                raise RuntimeError(
                    f"{d!r} has a rollup tier ({rollups}); checkpointing "
                    f"it without the tier open would leave its summaries "
                    f"behind the spilled rows: open it with "
                    f"enable_rollups=True (ROADMAP queue A item 6)")
        if tenant_marker:
            write_tenant_marker(os.path.join(self._dir, TENANTS_NAME))

    def close(self) -> None:
        first: BaseException | None = None
        for s in self.shards:
            try:
                s.close()
            except BaseException as e:
                # Close every shard even when one fails (a shard left open
                # holds its flock); raise the first failure after.
                if first is None:
                    first = e
        if first is not None:
            raise first

    def _simulate_crash(self) -> None:
        """Test hook: process death across every shard (see
        ``MemKVStore._simulate_crash``)."""
        for s in self.shards:
            s._simulate_crash()

    # -- replicas and the cluster tier (item 10a) ----------------------------

    def refresh(self) -> bool:
        """Replica catch-up across every shard (each shard's suffix replay
        or rebuild)."""
        changed = False
        for s in self.shards:
            changed |= s.refresh()
        return changed

    @property
    def rebuilds(self) -> int:
        return sum(s.rebuilds for s in self.shards)

    @property
    def fenced_bytes_refused(self) -> int:
        return sum(s.fenced_bytes_refused for s in self.shards)

    def promote_writable(self, writer_epoch: int,
                         epoch_guard=None) -> None:
        """Replica promotion across every shard. A shard that fails to
        promote demotes the already-promoted prefix back: the store comes
        out all writer or all replica, never mixed."""
        done: list[MemKVStore] = []
        try:
            for s in self.shards:
                s.promote_writable(writer_epoch, epoch_guard=epoch_guard)
                done.append(s)
        except BaseException:
            for s in done:
                try:
                    s.demote_readonly()
                except Exception:
                    pass
            raise
        self.read_only = False
        self.writer_epoch = int(writer_epoch)
        self.epoch_guard = epoch_guard

    def demote_readonly(self) -> None:
        for s in self.shards:
            s.demote_readonly()
        self.read_only = True
        self.writer_epoch = None
        self.epoch_guard = None
