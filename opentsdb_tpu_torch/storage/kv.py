"""Ordered key-value store: memtable + append-only WAL + sstable spill tier.

Mirrors ``opentsdb_tpu/storage/kv.py`` of the JAX package, copied rather
than imported: ``KVStore`` and ``MemKVStore`` with the WAL append and
replay, batched and columnar puts, ordered scans with a row-key regexp,
the atomic counter/CAS pair the UID tables need, throttling, and the
spill tier: ``checkpoint()`` spills the memtable to immutable sstable
generations (``storage/sstable.py``) named by a manifest and truncates the
WAL. The WAL records, the generation files and the manifest are
byte-identical to the JAX package's, so each package opens a store
directory the other wrote, checkpointed or crashed in the middle of a
checkpoint.

- Reads merge the tiers (generations oldest first, then a frozen
  mid-checkpoint memtable, then the live memtable); deletes over spilled
  rows leave tombstones (a None cell, or a row key in ``_Table.row_tombs``)
  that the next checkpoint applies in a full merge.
- ``checkpoint()`` never stalls ingest on the spill: under the lock it
  freezes the memtable and rotates the WAL to ``<wal>.old``; the spill
  runs without the lock; a second brief lock swaps the generations in,
  writes the manifest and unlinks ``<wal>.old``. A crash anywhere recovers
  by replaying ``<wal>.old`` then the WAL over whichever generations the
  manifest names (replay is idempotent).
- Backpressure: once a table holds ``throttle_rows`` live rows, puts that
  would create a new row raise PleaseThrottleError (a batch applies its
  prefix and reports it in ``partial_existed``).
- The query fast path's invalidation spine: ``mutation_seq`` moves on
  every mutating call and every checkpoint tier transition; each tier
  keeps, per base time, a refcount of the rows and row tombstones that
  name it (``_Table.dirty``, O(1) per created or removed row) and the seq
  of the last such transition (``_Table.touch``), folded into
  ``_base_stamps`` when the tier retires. ``dirty_bases`` and
  ``chunk_state`` read them; the executor's fragment cache validates
  against them. ``scan_raw``'s ``series_hint`` skips generations whose
  series bloom holds none of the candidate series
  (``bloom_files_skipped``).
- The native ingest extension (``utils/nativeext.py``, built at first
  use) runs the columnar batch's bulk upsert, the WAL replay's batch
  records and, in ``storage/sstable.py``, the checkpoint's framing, as
  the JAX store does where its extension is built; the Python paths stay
  as the reference (a test sets ``_EXT`` to None to take them).

Not ported yet, each refused rather than half-read where it leaves
something on disk: a sharded store (``SHARDS.json``; ROADMAP queue A item
3), the cluster epoch fence and WAL epoch headers (item 10), TSST4
generations (item 5, refused by the sstable reader); and without an
on-disk trace: read-only replicas with their ``refresh`` and the rebuild's
stamp-floor jump (item 10), WAL group commit, fault points and per-shard
mutation seqs (item 3), and the rollup tier's spill-key record with its
undrained dirty set ``_spill_dirty`` (item 6).
"""

from __future__ import annotations

import fcntl
import json
import os
import re
import struct
import threading
import time
import zlib
from bisect import bisect_left
from typing import Iterator, NamedTuple

import numpy as np

from opentsdb_tpu_torch.core.const import TIMESTAMP_BYTES, UID_WIDTH
from opentsdb_tpu_torch.core.errors import PleaseThrottleError
from opentsdb_tpu_torch.storage.sstable import (SSTable, merge_sstables,
                                                write_sstable_bulk)
from opentsdb_tpu_torch.utils.nativeext import EXT as _EXT

_REC = struct.Struct(">BI")  # op, payload length

# WAL opcodes (the JAX store's numbering).
_OP_PUT = 1
_OP_DELETE = 2
_OP_DELETE_ROW = 3
_OP_PUT_BATCH = 4   # one columnar record for a whole put_many batch
_OP_EPOCH = 5       # cluster-mode segment header (fence not ported)

# Row-key bytes holding the base time (core/codec.row_key): the bloom
# probe hashes the key around them.
_BASE_LO = UID_WIDTH
_BASE_HI = UID_WIDTH + TIMESTAMP_BYTES

# A sharded store's manifest, at the root of the directory its --wal
# names (the JAX package's storage/sharded.py).
_SHARDS_NAME = "SHARDS.json"

# Version written into <wal>.tenants.json at a checkpoint by a writer that
# keeps no tenant accounting: any value but the snapshot's 1 makes the
# next open (either package's) rebuild tenant accounting from storage
# (MemKVStore._retire_snapshots).
_FOREIGN_TENANTS_VERSION = 0


class Cell(NamedTuple):
    key: bytes
    family: bytes
    qualifier: bytes
    value: bytes


class KVStore:
    """Abstract ordered-KV interface; see MemKVStore for the semantics."""

    def get(self, table: str, key: bytes,
            family: bytes | None = None) -> list[Cell]:
        raise NotImplementedError

    def put(self, table: str, key: bytes, family: bytes, qualifier: bytes,
            value: bytes, durable: bool = True) -> None:
        raise NotImplementedError

    def put_many_columnar(self, table: str, family: bytes,
                          key_blob: bytes, key_len: int,
                          quals: list[bytes], vals: list[bytes],
                          durable: bool = True) -> list[bool]:
        raise NotImplementedError

    def delete(self, table: str, key: bytes, family: bytes,
               qualifiers: list[bytes]) -> None:
        raise NotImplementedError

    def delete_row(self, table: str, key: bytes) -> None:
        raise NotImplementedError

    def scan_raw(self, table: str, start: bytes, stop: bytes,
                 family: bytes | None = None,
                 key_regexp: bytes | None = None,
                 series_hint: np.ndarray | None = None,
                 ) -> Iterator[tuple[bytes, list[tuple[bytes, bytes]]]]:
        """``series_hint``: optional uint64 array of series-identity
        hashes (sstable.series_hash), a SUPERSET of the series the caller
        keeps; a pure pruning hint that a store may ignore."""
        raise NotImplementedError

    def atomic_increment(self, table: str, key: bytes, family: bytes,
                         qualifier: bytes, amount: int = 1) -> int:
        raise NotImplementedError

    def compare_and_set(self, table: str, key: bytes, family: bytes,
                        qualifier: bytes, expected: bytes | None,
                        value: bytes) -> bool:
        raise NotImplementedError

    def flush(self) -> None:
        raise NotImplementedError

    def ensure_table(self, table: str) -> None:
        raise NotImplementedError


def _merge_unique(a: list[bytes], b: list[bytes]) -> list[bytes]:
    """Merge two sorted unique lists into one, dropping cross-duplicates
    (a key deleted and re-inserted can appear in both runs)."""
    out: list[bytes] = []
    i = j = 0
    na, nb = len(a), len(b)
    while i < na and j < nb:
        ka, kb = a[i], b[j]
        if ka < kb:
            out.append(ka)
            i += 1
        elif kb < ka:
            out.append(kb)
            j += 1
        else:
            out.append(ka)
            i += 1
            j += 1
    out.extend(a[i:])
    out.extend(b[j:])
    return out


class _Table:
    """Row storage + an incremental sorted key index.

    The index is two sorted runs, ``base`` (large, rebuilt rarely) and
    ``delta`` (small, absorbing recent inserts), plus an unsorted
    ``pending`` set of brand-new keys: inserts are O(1), a scan absorbs
    pending into delta and folds delta into base only when delta
    outgrows ~sqrt(base). Runs may carry deleted keys; readers filter on
    ``k in rows`` and a purge rewrites the runs when those dominate.
    """

    __slots__ = ("rows", "base", "delta", "pending", "stale", "row_tombs",
                 "tombs", "dirty", "touch")

    def __init__(self) -> None:
        # Cell value None = tombstone masking a spilled sstable cell.
        self.rows: dict[bytes, dict[tuple[bytes, bytes], bytes | None]] = {}
        self.base: list[bytes] = []
        self.delta: list[bytes] = []
        self.pending: set[bytes] = set()
        self.stale = 0  # deleted keys still present in base/delta
        self.row_tombs: set[bytes] = set()  # whole-row masks over sstables
        # Cell tombstones ever written into rows: a tier with none cannot
        # mask lower-generation cells, so checkpoint may spill it as a new
        # generation without a merge.
        self.tombs = 0
        # Dirty-base index: base time -> refcount of the keys (rows and
        # row_tombs entries, counted apart: a key can be in both) whose
        # base-time bytes name it, kept O(1) per row created or removed so
        # dirty_bases never sweeps the key list.
        self.dirty: dict[int, int] = {}
        # Per base, the store mutation_seq of the last row create/remove.
        # A create-then-delete nets the refcount back to zero (the base
        # reads clean again), but a fragment scanned in between may hold
        # the transient row: the stamp outlives the refcount, so such a
        # fragment never validates (MemKVStore.chunk_state).
        self.touch: dict[int, int] = {}

    def dirty_add(self, key: bytes, seq: int) -> None:
        if len(key) >= _BASE_HI:
            b = int.from_bytes(key[_BASE_LO:_BASE_HI], "big")
            d = self.dirty
            d[b] = d.get(b, 0) + 1
            self.touch[b] = seq

    def dirty_sub(self, key: bytes, seq: int) -> None:
        if len(key) >= _BASE_HI:
            b = int.from_bytes(key[_BASE_LO:_BASE_HI], "big")
            d = self.dirty
            n = d.get(b, 0) - 1
            if n <= 0:
                d.pop(b, None)
            else:
                d[b] = n
            self.touch[b] = seq

    def rebuild_dirty(self, seq: int) -> None:
        """Recompute the dirty-base index from the keys (the thaw, where
        refcounting through the merge-back would be error-prone for an
        exceptional branch). Every involved base's stamp jumps to
        ``seq``: any fragment built across the thaw is invalid."""
        d: dict[int, int] = {}
        for ks in (self.rows, self.row_tombs):
            for k in ks:
                if len(k) >= _BASE_HI:
                    b = int.from_bytes(k[_BASE_LO:_BASE_HI], "big")
                    d[b] = d.get(b, 0) + 1
        for b in d:
            self.touch[b] = seq
        self.dirty = d

    def _absorb(self) -> None:
        """Fold pending inserts into delta; compact when thresholds hit.
        Caller holds the store lock."""
        if self.pending:
            new = sorted(self.pending)
            self.pending.clear()
            self.delta = _merge_unique(self.delta, new) if self.delta \
                else new
        if len(self.delta) ** 2 > max(len(self.base), 64):
            self.base = _merge_unique(self.base, self.delta)
            self.delta = []
        if self.stale * 2 > len(self.base) + len(self.delta):
            rows = self.rows
            self.base = [k for k in self.base if k in rows]
            self.delta = [k for k in self.delta if k in rows]
            self.stale = 0

    def range_keys(self, start: bytes, stop: bytes | None) -> list[bytes]:
        """Sorted live keys in [start, stop); stop falsy = to the end.
        Caller holds the store lock."""
        self._absorb()
        a, b = self.base, self.delta
        i, j = bisect_left(a, start), bisect_left(b, start)
        ahi = bisect_left(a, stop) if stop else len(a)
        bhi = bisect_left(b, stop) if stop else len(b)
        rows = self.rows
        out: list[bytes] = []
        while i < ahi and j < bhi:
            ka, kb = a[i], b[j]
            if ka < kb:
                k = ka
                i += 1
            elif kb < ka:
                k = kb
                j += 1
            else:
                k = ka
                i += 1
                j += 1
            if k in rows:
                out.append(k)
        out.extend(k for k in a[i:ahi] if k in rows)
        out.extend(k for k in b[j:bhi] if k in rows)
        return out


class MemKVStore(KVStore):
    """In-memory ordered KV with optional WAL persistence and spill tier.

    Thread-safe: a single lock guards all mutation (ingest is batched above
    this layer, so lock traffic is per batch, not per point). Every
    mutation's WAL record is flushed past the userspace buffer before the
    call returns; ``flush()`` fsyncs.
    """

    # _REC frames a payload with a u32 length: batches whose blobs approach
    # that split into several _OP_PUT_BATCH records (replay applies them in
    # order, so the split is invisible).
    _WAL_BATCH_LIMIT = 1 << 30

    # Generation cap: at this many, a checkpoint collapses a size-tiered
    # suffix of the generations (_select_merge_suffix).
    _MAX_GENERATIONS = 8

    def __init__(self, wal_path: str | None = None,
                 throttle_rows: int | None = None,
                 max_generations: int | None = None) -> None:
        """``throttle_rows``: live rows per table past which puts that
        create a row raise PleaseThrottleError. ``max_generations``
        overrides the generation cap (at least 2)."""
        self._tables: dict[str, _Table] = {}
        self._lock = threading.RLock()
        if max_generations is not None:
            if max_generations < 2:
                raise ValueError(
                    f"max_generations must be >= 2, got {max_generations}")
            self._MAX_GENERATIONS = max_generations
        self.throttle_rows = throttle_rows
        self._wal_path = wal_path
        self._wal = None
        self._lockfd: int | None = None
        # Spill tier: sstable generations, OLDEST FIRST.
        self._ssts: list[SSTable] = []
        self._sst_path = wal_path + ".sst" if wal_path else None
        # Immutable middle tier while a checkpoint's spill is in flight.
        self._frozen: dict[str, _Table] | None = None
        # Seconds the last open spent loading generations and replaying
        # <wal>.old + the WAL.
        self.open_seconds = {"generations": 0.0, "replay": 0.0}
        # Monotonic mutation counter, bumped per mutating CALL (not per
        # cell) and per checkpoint tier transition: an unchanged seq means
        # the stored rows cannot have changed.
        self.mutation_seq = 0
        # The fragment cache's invalidation spine: per (table, base), the
        # mutation_seq of the last row create/remove that touched it,
        # folded in from each tier's ``touch`` map when the tier retires
        # (phase-3 drop, empty-checkpoint drop, thaw), so the signal
        # outlives the memtable generation that made it. A fragment built
        # at seq E over a clean base range is still exact iff no base in
        # the range carries a stamp > E and E >= _stamp_floor: rows enter
        # or leave the visible data only through stamped memtable
        # transitions, and a checkpoint merely moves them between tiers.
        # The floor stays 0 here: only a replica's rebuild (not ported)
        # raises it.
        self._base_stamps: dict[str, dict[int, int]] = {}
        self._stamp_floor = 0
        # Lazy snapshots for range queries, rebuilt when mutation_seq
        # moves: table -> (seq, sorted bases, aligned stamps) and
        # table -> (seq, sorted dirty bases).
        self._stamps_snap: dict[str, tuple[int, np.ndarray,
                                           np.ndarray]] = {}
        self._dirty_snap: dict[str, tuple[int, np.ndarray]] = {}
        # Generations skipped by the series-bloom prefilter (scan_raw
        # with a series_hint).
        self.bloom_files_skipped = 0
        if not wal_path:
            return
        if os.path.exists(os.path.join(wal_path, _SHARDS_NAME)):
            raise RuntimeError(
                f"{wal_path!r} is a sharded store ({_SHARDS_NAME}); "
                f"sharded stores are not ported yet (ROADMAP queue A "
                f"item 3)")
        os.makedirs(os.path.dirname(os.path.abspath(wal_path)),
                    exist_ok=True)
        # Single-writer lock on a side file (the JAX store's convention,
        # so the two packages also exclude each other on one WAL), taken
        # before recovery touches disk: _generation_paths deletes stray
        # generation files.
        self._lockfd = os.open(wal_path + ".lock",
                               os.O_CREAT | os.O_RDWR, 0o644)
        try:
            fcntl.flock(self._lockfd, fcntl.LOCK_EX | fcntl.LOCK_NB)
        except OSError:
            os.close(self._lockfd)
            self._lockfd = None
            raise RuntimeError(
                f"WAL path {wal_path!r} is locked by another store")
        try:
            self._open_tiers(wal_path)
        except BaseException:
            for sst in self._ssts:
                sst.close()
            self._ssts = []
            os.close(self._lockfd)
            self._lockfd = None
            raise

    def _open_tiers(self, wal_path: str) -> None:
        """Load the generations, replay <wal>.old (a checkpoint that a
        crash interrupted) then the WAL, truncating a torn tail of either,
        and open the WAL for append."""
        t0 = time.perf_counter()
        for path in self._generation_paths():
            sst = SSTable(path)
            self._ssts.append(sst)
            for name in sst.tables():
                self._table(name)
        t1 = time.perf_counter()
        for path in (wal_path + ".old", wal_path):
            if os.path.exists(path):
                valid = self._replay(path)
                if valid < os.path.getsize(path):
                    # Torn record at the tail (crash mid-write): truncate
                    # so appends continue from the last valid boundary.
                    with open(path, "r+b") as f:
                        f.truncate(valid)
        self._wal = open(wal_path, "ab")
        self.open_seconds = {"generations": t1 - t0,
                             "replay": time.perf_counter() - t1}

    # -- generation set -----------------------------------------------------

    def _generation_paths(self) -> list[str]:
        """Live spill generations, oldest first. The manifest (written
        atomically on every checkpoint) is the source of truth: generation
        files it does not name (crash leftovers between a merge's manifest
        write and its unlinks) are deleted here, because loading them
        would resurrect cells a merge already dropped. No manifest = the
        legacy layout, the single ``<wal>.sst``."""
        man = self._sst_path + ".manifest"
        d = os.path.dirname(os.path.abspath(self._sst_path))
        if not os.path.exists(man):
            return [self._sst_path] if os.path.exists(self._sst_path) \
                else []
        with open(man) as f:
            names = json.load(f)
        liveset = set(names)
        base = os.path.basename(self._sst_path)
        for fn in os.listdir(d):
            if (fn == base or fn.startswith(base + ".g")) \
                    and fn not in liveset \
                    and not fn.endswith(".tmp") \
                    and not fn.endswith(".manifest"):
                try:
                    os.unlink(os.path.join(d, fn))
                except OSError:
                    pass
        # A generation the manifest names but the disk lacks is not
        # skipped (the JAX store skips it): opening it raises, since the
        # store cannot be read whole.
        return [os.path.join(d, fn) for fn in names]

    def _write_manifest(self, paths: list[str]) -> None:
        """Atomically record the live generation set (tmp + rename +
        directory fsync, the sstable writer's durability contract)."""
        man = self._sst_path + ".manifest"
        tmp = man + ".tmp"
        with open(tmp, "w") as f:
            json.dump([os.path.basename(p) for p in paths], f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, man)
        dfd = os.open(os.path.dirname(os.path.abspath(man)), os.O_RDONLY)
        try:
            os.fsync(dfd)
        finally:
            os.close(dfd)

    def _next_generation_path(self) -> str:
        used = set()
        d = os.path.dirname(os.path.abspath(self._sst_path))
        prefix = os.path.basename(self._sst_path) + ".g"
        for fn in os.listdir(d):
            if fn.startswith(prefix) and not fn.endswith(".tmp") \
                    and not fn.endswith(".manifest"):
                try:
                    used.add(int(fn[len(prefix):]))
                except ValueError:
                    continue
        n = 1
        while n in used:
            n += 1
        return self._sst_path + f".g{n}"

    # -- table helpers ----------------------------------------------------

    def _table(self, name: str) -> _Table:
        t = self._tables.get(name)
        if t is None:
            t = self._tables[name] = _Table()
        return t

    def ensure_table(self, table: str) -> None:
        with self._lock:
            self._table(table)

    @property
    def mutation_seqs(self) -> tuple[int, ...]:
        """Per-shard mutation sequence vector (a single store is one
        shard)."""
        return (self.mutation_seq,)

    def dirty_bases(self, table: str) -> np.ndarray:
        """Sorted unique base times whose rows the immutable sstable
        tiers do not fully cover: live memtable rows and row tombstones,
        and the frozen mid-checkpoint tier's. Kept incrementally
        (``_Table.dirty``), so deriving it never sweeps the key list;
        cached per mutation_seq."""
        with self._lock:
            snap = self._dirty_snap.get(table)
            if snap is not None and snap[0] == self.mutation_seq:
                return snap[1]
            bases = set(self._table(table).dirty)
            if self._frozen is not None:
                ft = self._frozen.get(table)
                if ft is not None:
                    bases.update(ft.dirty)
            arr = np.fromiter(bases, np.int64, len(bases))
            arr.sort()
            self._dirty_snap[table] = (self.mutation_seq, arr)
            return arr

    def chunk_state(self, table: str, lo: int, hi: int,
                    ) -> tuple[tuple[int, ...], tuple[int, ...],
                               tuple[int, ...], bool]:
        """Fragment-cache validation state for base range [lo, hi):
        ``(seqs, floors, stamps, dirty)``, one element per shard (one,
        here). A fragment tagged with seq E over this range is still
        exact iff the range is clean (not ``dirty``), E >= floor, and no
        base in the range carries a transition stamp > E (``stamps`` is
        the range's newest stamp across the store-level map and every
        live tier's touch map)."""
        d = self.dirty_bases(table)
        dirty = bool(len(d)) and \
            int(np.searchsorted(d, lo)) < int(np.searchsorted(d, hi))
        with self._lock:
            seq = self.mutation_seq
            snap = self._stamps_snap.get(table)
            if snap is None or snap[0] != seq:
                m = dict(self._base_stamps.get(table, {}))
                tiers = [self._table(table)]
                if self._frozen is not None:
                    ft = self._frozen.get(table)
                    if ft is not None:
                        tiers.append(ft)
                for t in tiers:
                    for b, v in t.touch.items():
                        if m.get(b, -1) < v:
                            m[b] = v
                bases = np.fromiter(m.keys(), np.int64, len(m))
                stamps = np.fromiter(m.values(), np.int64, len(m))
                order = np.argsort(bases)
                snap = (seq, bases[order], stamps[order])
                self._stamps_snap[table] = snap
            _, bases, stamps = snap
            a = int(np.searchsorted(bases, lo))
            b = int(np.searchsorted(bases, hi))
            stamp = int(stamps[a:b].max()) if b > a else 0
            return ((seq,), (self._stamp_floor,), (stamp,), dirty)

    def memtable_keys(self, table: str) -> list[bytes]:
        """Row keys in the live memtable only (excludes spilled tiers).
        After crash recovery this is exactly the WAL-replayed set."""
        with self._lock:
            return list(self._table(table).rows)

    def memtable_cells(self, table: str, key: bytes,
                       family: bytes | None = None) -> list[Cell]:
        """Live-memtable cells of one row, without the spilled tiers
        (tombstones excluded): the sketch re-fold at start-up reads rows
        through this, so cells the snapshot covers are not folded
        twice."""
        with self._lock:
            row = self._table(table).rows.get(key)
            if not row:
                return []
            return [Cell(key, f, q, v) for (f, q), v in row.items()
                    if v is not None and (family is None or f == family)]

    def row_count(self, table: str) -> int:
        with self._lock:
            keys = set(self._table(table).rows)
            ft = self._frozen.get(table) if self._frozen else None
            if ft is not None:
                keys |= set(ft.rows)
            for sst in self._ssts:
                keys.update(sst.scan_keys(table, b"", None))
            return sum(1 for k in keys if self._merged_row(table, k))

    def has_row(self, table: str, key: bytes) -> bool:
        with self._lock:
            return self._has_row_locked(table, key)

    def _has_row_locked(self, table: str, key: bytes) -> bool:
        row = self._table(table).rows.get(key)
        if row:
            # Tombstones (None cells) only exist once a lower tier does;
            # the pure-memtable path stays one dict probe.
            if not self._ssts and self._frozen is None:
                return True
            if any(v is not None for v in row.values()):
                return True
        return self._merged_row(table, key) is not None

    def _merged_row(self, table: str,
                    key: bytes) -> dict[tuple[bytes, bytes], bytes] | None:
        """Lower tiers (generations, then the frozen memtable) overlaid
        with the live memtable's cells and tombstones. Caller holds the
        lock."""
        t = self._table(table)
        if not self._ssts and self._frozen is None:
            return t.rows.get(key) or None
        ft = self._frozen.get(table) if self._frozen else None
        merged: dict[tuple[bytes, bytes], bytes] = {}
        if not (key in t.row_tombs
                or (ft is not None and key in ft.row_tombs)):
            # Generations never hold tombstones (a tombstoned frozen tier
            # forces a full merge), so a plain overlay is the whole story.
            for sst in self._ssts:
                cells = sst.get(table, key)
                if cells:
                    for f, q, v in cells:
                        merged[(f, q)] = v
        rows = [t.rows.get(key)]
        if ft is not None and key not in t.row_tombs:
            rows.insert(0, ft.rows.get(key))
        for row in rows:
            if row:
                for ck, v in row.items():
                    if v is None:
                        merged.pop(ck, None)
                    else:
                        merged[ck] = v
        return merged or None

    def _lower_tier_has(self, table: str, key: bytes) -> bool:
        """Does any tier below the live memtable hold this key? (Decides
        whether a delete must leave tombstones.) Each generation's series
        bloom is probed before its key bisect: blooms cover every indexed
        key, so present keys always pass."""
        ft = self._frozen.get(table) if self._frozen else None
        if ft is not None and key in ft.rows:
            return True
        if not self._ssts:
            return False
        h = None
        if len(key) >= _BASE_HI:
            h = zlib.crc32(key[_BASE_HI:], zlib.crc32(key[:_BASE_LO]))
        for sst in self._ssts:
            if h is not None and not sst.bloom_may_contain_hash(table, h):
                continue
            if sst.has_key(table, key):
                return True
        return False

    # -- WAL --------------------------------------------------------------

    def _wal_append(self, op: int, *parts: bytes) -> None:
        if self._wal is None:
            return
        payload = b"".join(struct.pack(">I", len(p)) + p for p in parts)
        self._wal.write(_REC.pack(op, len(payload)) + payload)
        self._wal_flush()

    def _wal_flush(self) -> None:
        # Past the userspace buffer before the mutation returns: a crash
        # of the process then loses nothing acknowledged (flush() adds the
        # fsync that survives power loss).
        self._wal.flush()

    @classmethod
    def _batch_splits(cls, cell_bytes: np.ndarray) -> list[tuple[int, int]]:
        """[(start, stop)) cell ranges whose blob bytes each fit
        _WAL_BATCH_LIMIT; one range in the common case."""
        n = len(cell_bytes)
        limit = cls._WAL_BATCH_LIMIT
        csum = np.cumsum(cell_bytes, dtype=np.int64)
        if n <= 1 or csum[-1] <= limit:
            return [(0, n)]
        out = []
        lo = base = 0
        while lo < n:
            hi = max(int(np.searchsorted(csum, base + limit, side="right")),
                     lo + 1)
            out.append((lo, hi))
            base = int(csum[hi - 1])
            lo = hi
        return out

    def _wal_append_batch_columnar(self, table: bytes, family: bytes,
                                   key_blob: bytes, n: int, key_len: int,
                                   quals: list[bytes],
                                   vals: list[bytes]) -> None:
        """One _OP_PUT_BATCH record for a whole batch: header, three >u4
        length arrays, then the key/qualifier/value blobs."""
        if self._wal is None:
            return
        ql = np.fromiter(map(len, quals), ">u4", n)
        vl = np.fromiter(map(len, vals), ">u4", n)
        for lo, hi in self._batch_splits(ql.astype(np.int64)
                                         + vl.astype(np.int64) + key_len):
            payload = b"".join((
                struct.pack(">IHH", hi - lo, len(table), len(family)),
                table, family,
                np.full(hi - lo, key_len, ">u4").tobytes(),
                ql[lo:hi].tobytes(), vl[lo:hi].tobytes(),
                key_blob[lo * key_len:hi * key_len],
                b"".join(quals[lo:hi]), b"".join(vals[lo:hi])))
            self._wal.write(_REC.pack(_OP_PUT_BATCH, len(payload))
                            + payload)
        self._wal_flush()

    @staticmethod
    def _split_payload(payload: bytes) -> list[bytes]:
        parts = []
        off = 0
        while off < len(payload):
            (n,) = struct.unpack_from(">I", payload, off)
            off += 4
            parts.append(payload[off:off + n])
            off += n
        return parts

    def _replay(self, path: str) -> int:
        """Apply every complete WAL record; returns the valid byte count."""
        valid = 0
        with open(path, "rb") as f:
            while True:
                hdr = f.read(_REC.size)
                if len(hdr) < _REC.size:
                    break  # truncated tail: stop at last complete record
                op, plen = _REC.unpack(hdr)
                payload = f.read(plen)
                if len(payload) < plen:
                    break
                valid += _REC.size + plen
                if op == _OP_PUT_BATCH:
                    self._replay_batch(payload)
                    continue
                if op == _OP_EPOCH:
                    raise RuntimeError(
                        f"WAL {path!r} carries cluster epoch headers; the "
                        f"cluster write tier is not ported yet (ROADMAP "
                        f"queue A item 10)")
                parts = self._split_payload(payload)
                table = parts[0].decode()
                if op == _OP_PUT:
                    _, key, fam, qual, value = parts
                    self._apply_put(table, key, fam, qual, value)
                elif op == _OP_DELETE:
                    _, key, fam, *quals = parts
                    self._apply_delete(table, key, fam, quals)
                elif op == _OP_DELETE_ROW:
                    _, key = parts
                    self._apply_delete_row(table, key)
                else:
                    raise RuntimeError(f"unknown WAL opcode {op} in {path!r}")
        return valid

    def _replay_batch(self, payload: bytes) -> None:
        n, tl, fl = struct.unpack_from(">IHH", payload, 0)
        off = 8
        table = payload[off:off + tl].decode()
        off += tl
        fam = payload[off:off + fl]
        off += fl
        lo = off            # the three u32 length arrays
        kl = np.frombuffer(payload, ">u4", n, off)
        ql = np.frombuffer(payload, ">u4", n, off + 4 * n)
        vl = np.frombuffer(payload, ">u4", n, off + 8 * n)
        # Blob starts: keys, then quals, then values.
        ko = off + 12 * n
        qo = ko + int(kl.sum())
        vo = qo + int(ql.sum())
        if _EXT is not None:
            # Bulk replay: slice the three blobs in C and upsert the
            # whole record in one pass. Exactly _apply_put per cell (set
            # the cell, create the row + pending entry when absent; no
            # tier probes, no throttle on replay), so the result is the
            # loop's below.
            with memoryview(payload) as mv:
                keys = _EXT.slice_varlen(mv[ko:qo], mv[lo:lo + 4 * n])
                quals = _EXT.slice_varlen(mv[qo:vo],
                                          mv[lo + 4 * n:lo + 8 * n])
                vals = _EXT.slice_varlen(mv[vo:vo + int(vl.sum())],
                                         mv[lo + 8 * n:lo + 12 * n])
            t = self._table(table)
            existed = _EXT.upsert_cells(t.rows, keys, fam, quals, vals,
                                        t.pending)
            self._dirty_add_new(t, keys, existed)
            return
        for lk, lq, lv in zip(kl.tolist(), ql.tolist(), vl.tolist()):
            self._apply_put(table, payload[ko:ko + lk], fam,
                            payload[qo:qo + lq], payload[vo:vo + lv])
            ko += lk
            qo += lq
            vo += lv

    def flush(self) -> None:
        """Force the WAL to stable storage."""
        with self._lock:
            if self._wal is not None:
                self._wal.flush()
                os.fsync(self._wal.fileno())

    def close(self) -> None:
        with self._lock:
            try:
                if self._wal is not None:
                    try:
                        self.flush()
                    finally:
                        self._wal.close()
                        self._wal = None
            finally:
                for sst in self._ssts:
                    sst.close()
                self._ssts = []
                if self._lockfd is not None:
                    os.close(self._lockfd)
                    self._lockfd = None

    # -- checkpoint / spill -----------------------------------------------

    def checkpoint(self, tenant_marker: bool = True) -> int:
        """Spill the memtable to a new sstable generation and drop the
        pre-checkpoint WAL records. Returns rows written (0: no WAL, a
        checkpoint already in flight, or nothing to spill).
        ``tenant_marker=False`` (a writer that saved its own tenant
        snapshot just before) leaves ``<wal>.tenants.json`` alone
        (``_retire_snapshots``).

        Normally the frozen memtable spills alone as a new generation.
        When the generation count reaches _MAX_GENERATIONS, a size-tiered
        partial merge collapses only the newest suffix of generations
        (plus the frozen tier) that the next-older generation does not
        dwarf. A FULL merge of every generation runs when the frozen tier
        holds tombstones: they must mask cells in every lower generation,
        and a partial merge would drop them for the kept prefix.

        Three phases, so that ingest and queries never wait on the spill:
          1. (lock) freeze the memtable as an immutable middle tier and
             rotate the WAL: pre-checkpoint records move to <wal>.old.
          2. (no lock) write the new generation to a temp file, fsync,
             rename it into place.
          3. (lock) open it, write the manifest (the authoritative
             generation set), drop the frozen tier, unlink the merged
             generations and <wal>.old.
        <wal>.old survives until the new generation is durable; recovery
        replays <wal>.old then the WAL, idempotently, over any manifest
        state."""
        if self._sst_path is None:
            return 0
        old_path = self._wal_path + ".old"
        with self._lock:
            if self._frozen is not None:
                return 0  # a spill is already in flight
            self._retire_snapshots(tenant_marker)
            self._frozen = self._tables
            self._tables = {name: _Table() for name in self._frozen}
            self.mutation_seq += 1
            if self._wal is not None:
                self._wal.close()
                if os.path.exists(old_path):
                    # A crash-recovered .old is still live state: append
                    # the current WAL to it rather than clobbering it.
                    with open(old_path, "ab") as dst, \
                            open(self._wal_path, "rb") as src:
                        dst.write(src.read())
                        dst.flush()
                        os.fsync(dst.fileno())
                    # Recreate the WAL under a fresh inode (empty tmp +
                    # os.replace, allocated while the old WAL is still
                    # linked) rather than truncating in place: readers
                    # that key a replay position on the WAL's inode never
                    # see a reset offset in the same file.
                    tmp = self._wal_path + ".rotate"
                    self._wal = open(tmp, "wb")
                    os.replace(tmp, self._wal_path)
                else:
                    os.replace(self._wal_path, old_path)
                    self._wal = open(self._wal_path, "ab")
            frozen = self._frozen
            gens = list(self._ssts)
            tombstoned = any(ft.row_tombs or ft.tombs
                             for ft in frozen.values())
            if tombstoned:
                keep: list[SSTable] = []
                merge_gens = gens
            elif len(gens) + 1 >= self._MAX_GENERATIONS:
                keep, merge_gens = self._select_merge_suffix(gens)
            else:
                keep, merge_gens = gens, []
            use_merge = tombstoned or bool(merge_gens)
            empty = not any(ft.rows or ft.row_tombs
                            for ft in frozen.values())
            out_path = self._next_generation_path()

        if empty:
            # Nothing to spill, but the rotation above must still
            # conclude: a WAL whose records net out to an empty memtable
            # holds no state the generations lack, and keeping <wal>.old
            # would let churn grow it without bound.
            with self._lock:
                self._fold_touch_locked(self._frozen)
                self._frozen = None
                self.mutation_seq += 1
                if os.path.exists(old_path):
                    os.unlink(old_path)
            return 0

        try:
            if use_merge:
                n = merge_sstables(out_path, merge_gens, {
                    name: (ft.rows, ft.row_tombs, bool(ft.tombs))
                    for name, ft in frozen.items()})
            else:
                # No tombstones in the frozen tier: every cell value is
                # bytes and no lower generation needs reading.
                n = write_sstable_bulk(out_path, {
                    name: ([k for k in sorted(ft.rows) if ft.rows[k]],
                           ft.rows)
                    for name, ft in frozen.items()})
        except Exception:
            # Disk full or similar: thaw the frozen tier back under the
            # live memtable so the store is not wedged. <wal>.old stays;
            # the next checkpoint appends the live WAL to it.
            with self._lock:
                self._thaw_frozen_locked()
            raise

        with self._lock:
            new_sst = None
            unlink_new = True
            try:
                new_sst = SSTable(out_path)
                # The new generation replaces exactly the merged suffix
                # (all of them on a full merge, none on a plain spill);
                # everything in `keep` is older than what it holds.
                self._ssts = keep + [new_sst]
                try:
                    # Manifest BEFORE unlinking: a crash in between
                    # leaves strays the next open deletes.
                    self._write_manifest([s.path for s in self._ssts])
                except Exception:
                    old = keep + merge_gens
                    self._ssts = old
                    # The new manifest may already be durable (the
                    # rename landed, the directory fsync failed):
                    # restore the old one before unlinking the new file,
                    # or keep the file if even that fails. Both (old
                    # manifest, stray new file) and (new manifest, new
                    # file) are consistent.
                    try:
                        self._write_manifest([s.path for s in old])
                    except Exception:
                        unlink_new = False
                    raise
            except Exception:
                if new_sst is not None:
                    new_sst.close()
                if unlink_new:
                    try:
                        os.unlink(out_path)
                    except OSError:
                        pass
                self._thaw_frozen_locked()
                raise
            self._frozen = None
            self.mutation_seq += 1
            # The frozen tier retires: its transition stamps fold into the
            # store-level map, so fragments built while (or before) its
            # rows were live keep invalidating, bases a create-then-delete
            # netted back to clean included.
            self._fold_touch_locked(frozen)
            for g in merge_gens:
                path = g.path
                g.close()
                try:
                    os.unlink(path)
                except OSError:
                    pass
            if os.path.exists(old_path):
                os.unlink(old_path)
        return n

    def _retire_snapshots(self, tenant_marker: bool = True) -> None:
        """Leave the snapshots beside the WAL in a state the next open
        (either package's) rebuilds exactly from, before anything spills.

        A writer keeps ``<wal>.tenants.json`` (and ``<wal>.sketches``,
        which ``TSDB.checkpoint`` saves or removes), covering the sstable
        tier, and on open re-folds only the WAL-replayed memtable on top
        of it. ``TSDB.checkpoint`` saves a real tenant snapshot first
        when it keeps accounting (``tenant_marker=False``).

        Otherwise (``tenant_accounting=False``, or this store checkpointed
        alone) the tenant snapshot would miss the rows spilled now, so it
        is replaced by a file of a foreign version, which the next open
        rejects and answers with a full storage rescan (exact totals). A
        missing tenant file is not enough: without one, and without
        tenant limits, an open skips the rescan. The JAX package leaves
        its stale snapshot in place here (ROADMAP queue C, reference
        note 8).

        A JAX rollup tier (``<wal>.rollup-<res>/``) would need its
        summaries folded at every spill, which this port cannot do yet:
        such a store is refused here (ROADMAP queue A item 6)."""
        d = os.path.dirname(os.path.abspath(self._wal_path))
        base = os.path.basename(self._wal_path)
        rollups = sorted(fn for fn in os.listdir(d)
                         if fn.startswith(base + ".rollup"))
        if rollups:
            raise RuntimeError(
                f"{self._wal_path!r} has a rollup tier beside it "
                f"({rollups}); checkpointing it would leave its summaries "
                f"behind the spilled rows, and rollups are not ported yet "
                f"(ROADMAP queue A item 6)")
        if not tenant_marker:
            return
        tenants = self._wal_path + ".tenants.json"
        with open(tenants + ".tmp", "w") as f:
            json.dump({"version": _FOREIGN_TENANTS_VERSION,
                       "written_by": "opentsdb_tpu_torch",
                       "note": "this store keeps no tenant accounting; "
                               "rebuild it from storage"}, f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tenants + ".tmp", tenants)
        dfd = os.open(d, os.O_RDONLY)
        try:
            os.fsync(dfd)
        finally:
            os.close(dfd)

    @staticmethod
    def _select_merge_suffix(gens: list[SSTable],
                             ) -> tuple[list[SSTable], list[SSTable]]:
        """Size-tiered pick at the generation cap: absorb older
        generations into the merge only while each is no larger than
        everything newer already being merged, so the oldest, largest
        generations are kept verbatim and write amplification stays
        logarithmic. The frozen tier's footprint is estimated as the
        newest generation's size. Returns (keep-prefix, merge-suffix),
        both age-ordered."""
        def size(g):
            try:
                return os.path.getsize(g.path)
            except OSError:
                return None  # unreadable: too big to absorb
        i = len(gens) - 1          # always absorb the newest
        acc = 2 * (size(gens[-1]) or 0)
        while i > 0:
            s = size(gens[i - 1])
            if s is None or s > acc:
                break
            acc += s
            i -= 1
        return gens[:i], gens[i:]

    def _fold_touch_locked(self, tables: dict[str, _Table]) -> None:
        """Fold retiring tiers' transition stamps into the store-level
        map (max wins). Caller holds the lock."""
        for name, ft in tables.items():
            if not ft.touch:
                continue
            st = self._base_stamps.setdefault(name, {})
            for b, v in ft.touch.items():
                if st.get(b, -1) < v:
                    st[b] = v

    def _thaw_frozen_locked(self) -> None:
        """Fold the frozen tier back under the live memtable after a
        failed checkpoint (caller holds the lock). Live cells win; row
        tombstones written while the spill was in flight keep masking the
        thawed rows; the tombstone count travels with the rows, so the
        retry still takes the full merge."""
        for name, ft in self._frozen.items():
            live = self._table(name)
            for k, row in ft.rows.items():
                if k in live.row_tombs:
                    continue  # deleted while the spill was in flight
                merged = dict(row)
                merged.update(live.rows.get(k, {}))
                live.rows[k] = merged
            live.row_tombs |= ft.row_tombs
            live.tombs += ft.tombs
            live.pending.update(ft.rows)
            live.rebuild_dirty(self.mutation_seq + 1)
        self._fold_touch_locked(self._frozen)
        self._frozen = None
        self.mutation_seq += 1

    # -- mutation ---------------------------------------------------------

    def _apply_put(self, table: str, key: bytes, family: bytes,
                   qualifier: bytes, value: bytes) -> None:
        t = self._table(table)
        row = t.rows.get(key)
        if row is None:
            row = t.rows[key] = {}
            t.pending.add(key)
            t.dirty_add(key, self.mutation_seq)
        row[(family, qualifier)] = value

    def _apply_delete(self, table: str, key: bytes, family: bytes,
                      qualifiers: list[bytes]) -> None:
        t = self._table(table)
        spilled = (key not in t.row_tombs
                   and self._lower_tier_has(table, key))
        row = t.rows.get(key)
        if row is None:
            if not spilled:
                return
            row = t.rows[key] = {}
            t.pending.add(key)
            t.dirty_add(key, self.mutation_seq)
        for q in qualifiers:
            if spilled:
                row[(family, q)] = None  # tombstone masks the sstable cell
                t.tombs += 1
            else:
                row.pop((family, q), None)
        if not row:
            del t.rows[key]
            t.stale += 1
            t.dirty_sub(key, self.mutation_seq)

    def _apply_delete_row(self, table: str, key: bytes) -> None:
        t = self._table(table)
        if t.rows.pop(key, None) is not None:
            t.stale += 1
            t.dirty_sub(key, self.mutation_seq)
        if key not in t.row_tombs and self._lower_tier_has(table, key):
            t.row_tombs.add(key)
            t.dirty_add(key, self.mutation_seq)

    def _throttle_error(self, table: str) -> PleaseThrottleError:
        return PleaseThrottleError(
            f"table '{table}' holds >= {self.throttle_rows} rows")

    def _check_throttle(self, table: str, key: bytes) -> None:
        # Only puts that would create a NEW row throttle: updates to
        # existing rows (compaction rewrites among them, which relieve
        # pressure) must keep flowing or backpressure never clears.
        rows = self._table(table).rows
        if self.throttle_rows is not None \
                and len(rows) >= self.throttle_rows and key not in rows:
            raise self._throttle_error(table)

    def put(self, table: str, key: bytes, family: bytes, qualifier: bytes,
            value: bytes, durable: bool = True) -> None:
        with self._lock:
            self._check_throttle(table, key)
            self.mutation_seq += 1
            if durable:
                self._wal_append(_OP_PUT, table.encode(), key, family,
                                 qualifier, value)
            self._apply_put(table, key, family, qualifier, value)

    def _dirty_add_new(self, t: _Table, keys: list[bytes],
                       existed: list[bool]) -> None:
        """Index the bases of the rows a bulk upsert created (existed
        False: the C pass reports intra-batch duplicates as existing, so
        each new row counts exactly once)."""
        add = t.dirty_add
        seq = self.mutation_seq
        for k, e in zip(keys, existed):
            if not e:
                add(k, seq)

    def _try_fast_batch(self, table: str, t: _Table, family: bytes,
                        keys: list[bytes], quals: list[bytes],
                        vals: list[bytes]) -> list[bool] | None:
        """The bulk upsert of a columnar batch (the JAX store's
        ``_try_fast_batch``). Caller holds the lock and has validated
        lengths. Returns existed, or None when the batch is irregular (a
        possible mid-batch throttle trip, or duplicate keys without the
        C upsert) and must take the per-cell loop.

        Bulk set/dict operations, or one C pass, replace that loop, whose
        per-cell work the JAX package measured at ~3.7 us a cell, the
        dominant cost of ingest at scale."""
        rows = t.rows
        n = len(keys)
        pure_mem = not self._ssts and self._frozen is None
        throttle = self.throttle_rows
        # Conservative bound (every key new): when it holds, a mid-batch
        # throttle trip is impossible.
        throttle_ok = throttle is None or len(rows) + n <= throttle
        ks = None
        lower: set[bytes] = set()
        if not pure_mem:
            # Lower-tier candidates: a key can exist below the live
            # memtable only if the frozen memtable holds it or it lies
            # inside a generation's key range. The exact probe
            # (_has_row_locked) stays the oracle for every survivor.
            ks = set(keys)
            if self._frozen is not None:
                ft = self._frozen.get(table)
                if ft is not None:
                    lower |= ft.rows.keys() & ks
            for sst in self._ssts:
                bounds = sst.key_bounds(table)
                if bounds is not None:
                    lo, hi = bounds
                    lower |= {k for k in ks if lo <= k <= hi}
        if _EXT is not None and throttle_ok and not lower:
            # No batch key can touch a lower tier, so memtable presence
            # is existence: one C pass sets every cell, creates rows with
            # their pending entries and reports existed, intra-batch
            # duplicates included. One nuance: a live all-tombstone row
            # reads as existed=True where the exact probe says False;
            # existed only queues a compaction, which then does nothing.
            existed = _EXT.upsert_cells(rows, keys, family, quals, vals,
                                        t.pending)
            self._dirty_add_new(t, keys, existed)
            return existed
        if ks is None:
            ks = set(keys)
        if len(ks) != n:
            return None
        dups = rows.keys() & ks
        if throttle is not None and len(rows) + n - len(dups) > throttle:
            return None
        if pure_mem:
            existed = ([False] * n if not dups
                       else [k in dups for k in keys])
        else:
            candidates = dups | lower
            if candidates:
                hrl = self._has_row_locked
                present = {k for k in candidates if hrl(table, k)}
                existed = [k in present for k in keys]
            else:
                existed = [False] * n
        seq = self.mutation_seq
        if not dups:
            if _EXT is not None:
                _EXT.rows_update_new(rows, keys, family, quals, vals)
            else:
                rows.update((k, {(family, q): v})
                            for k, q, v in zip(keys, quals, vals))
            t.pending.update(ks)
            for k in ks:
                t.dirty_add(k, seq)
        else:
            for k, q, v in zip(keys, quals, vals):
                row = rows.get(k)
                if row is None:
                    rows[k] = {(family, q): v}
                    t.dirty_add(k, seq)
                else:
                    row[(family, q)] = v
            t.pending.update(ks - dups)
        return existed

    def put_many_columnar(self, table: str, family: bytes,
                          key_blob: bytes, key_len: int,
                          quals: list[bytes], vals: list[bytes],
                          durable: bool = True) -> list[bool]:
        """Batched put with cell i's key the i-th ``key_len``-byte slice of
        ``key_blob``. Returns, per cell, True when the row held other
        cells by the time this one landed (it existed before the batch,
        in any tier, or an earlier cell of the batch hit it): the rows
        the caller must queue for compaction.

        A regular batch lands in bulk (``_try_fast_batch``); the rest
        takes the per-cell loop, where a cell that would create a row
        past ``throttle_rows`` stops the batch: the cells before it stay
        applied, their WAL record is written, and the PleaseThrottleError
        raised carries their flags as ``partial_existed``."""
        n = len(quals)
        L = key_len
        if len(vals) != n or len(key_blob) != n * L:
            # The WAL record trusts n * key_len: a mis-framed batch would
            # corrupt durable state on replay.
            raise ValueError(
                f"columnar batch mismatch: {len(key_blob)} key bytes, "
                f"key_len {L}, {n} quals, {len(vals)} vals")
        if n == 0:
            return []
        if _EXT is not None:
            keys = _EXT.slice_keys(key_blob, L)
        else:
            keys = [key_blob[i:i + L] for i in range(0, n * L, L)]
        existed: list[bool] = []
        with self._lock:
            self.mutation_seq += 1
            seq = self.mutation_seq
            t = self._table(table)
            fast = self._try_fast_batch(table, t, family, keys, quals, vals)
            if fast is not None:
                if durable:
                    self._wal_append_batch_columnar(
                        table.encode(), family, key_blob, n, L, quals, vals)
                return fast
            rows = t.rows
            # With no lower tiers the memtable is the whole truth, so
            # existence is one dict probe.
            pure_mem = not self._ssts and self._frozen is None
            throttle = self.throttle_rows
            batch_ok = False
            try:
                for k, q, v in zip(keys, quals, vals):
                    row = rows.get(k)
                    if row is None:
                        if throttle is not None and len(rows) >= throttle:
                            err = self._throttle_error(table)
                            err.partial_existed = existed
                            raise err
                        e = not pure_mem and self._has_row_locked(table, k)
                        row = rows[k] = {}
                        t.pending.add(k)
                        # One dirty entry per created row, never per point.
                        t.dirty_add(k, seq)
                    else:
                        e = pure_mem or self._has_row_locked(table, k)
                    row[(family, q)] = v
                    existed.append(e)
                batch_ok = True
            finally:
                # The applied prefix is acknowledged (on success, or via
                # partial_existed), so its record reaches the OS before
                # the call returns or raises. A WAL failure must not
                # replace a throttle error in flight: callers rely on
                # partial_existed.
                m = len(existed)
                if durable and m:
                    try:
                        self._wal_append_batch_columnar(
                            table.encode(), family, key_blob[:m * L], m, L,
                            quals[:m], vals[:m])
                    except Exception:
                        if batch_ok:
                            raise
        return existed

    def delete(self, table: str, key: bytes, family: bytes,
               qualifiers: list[bytes]) -> None:
        with self._lock:
            self.mutation_seq += 1
            self._wal_append(_OP_DELETE, table.encode(), key, family,
                             *qualifiers)
            self._apply_delete(table, key, family, qualifiers)

    def delete_row(self, table: str, key: bytes) -> None:
        with self._lock:
            self.mutation_seq += 1
            self._wal_append(_OP_DELETE_ROW, table.encode(), key)
            self._apply_delete_row(table, key)

    # -- reads ------------------------------------------------------------

    def get(self, table: str, key: bytes,
            family: bytes | None = None) -> list[Cell]:
        with self._lock:
            row = self._merged_row(table, key)
            if not row:
                return []
            cells = [Cell(key, f, q, v) for (f, q), v in row.items()
                     if family is None or f == family]
        cells.sort(key=lambda c: (c.family, c.qualifier))
        return cells

    def _snapshot_keys(self, table: str, start: bytes, stop: bytes,
                       skip_paths: set[str] | None = None) -> list[bytes]:
        """Key snapshot across all tiers (live memtable, frozen tier,
        generations; row tombstones excluded). ``skip_paths``:
        generations the series-bloom prefilter proved irrelevant. Caller
        holds the lock."""
        t = self._table(table)
        keys = t.range_keys(start, stop)
        ft = self._frozen.get(table) if self._frozen else None
        extra = set()
        if ft is not None:
            extra.update(k for k in ft.range_keys(start, stop)
                         if k not in t.rows and k not in t.row_tombs)
        for sst in self._ssts:
            if skip_paths and sst.path in skip_paths:
                continue
            extra.update(
                k for k in sst.scan_keys(table, start, stop)
                if k not in t.rows and k not in t.row_tombs
                and not (ft is not None and (k in ft.rows
                                             or k in ft.row_tombs)))
        if extra:
            keys = sorted(set(keys) | extra)
        return keys

    def scan_raw(self, table: str, start: bytes, stop: bytes,
                 family: bytes | None = None,
                 key_regexp: bytes | None = None, chunk: int = 1024,
                 series_hint: np.ndarray | None = None,
                 ) -> Iterator[tuple[bytes, list[tuple[bytes, bytes]]]]:
        """Rows with key in [start, stop) as (key, sorted [(qualifier,
        value), ...]), the lock taken once per ``chunk`` keys.
        ``key_regexp`` applies a DOTALL bytes regex to the whole key (the
        HBase KeyRegexpFilter the reference's tag filtering uses).

        ``series_hint`` (see KVStore.scan_raw) prunes the generations
        whose series bloom holds none of the candidates. The skips are
        decided once per scan, under the lock, against the generation set
        of that moment and matched by path afterwards: a generation
        swapped in mid-scan is not skipped, and one dropped mid-scan
        vanishes from the tiers as in any scan. A hint of None or an
        empty one never prunes.

        Snapshot semantics: keys are snapshotted at call time; rows deleted
        mid-scan are skipped, rows mutated mid-scan show their new cells."""
        pattern = re.compile(key_regexp, re.S) if key_regexp else None
        with self._lock:
            skip_paths: set[str] | None = None
            if series_hint is not None and len(series_hint) \
                    and self._ssts:
                skip_paths = set()
                for sst in self._ssts:
                    if not sst.bloom_may_contain(table, series_hint):
                        skip_paths.add(sst.path)
                        self.bloom_files_skipped += 1
                skip_paths = skip_paths or None
            keys = self._snapshot_keys(table, start, stop, skip_paths)
        if pattern is not None:
            keys = [k for k in keys if pattern.match(k)]
        for i in range(0, len(keys), chunk):
            ck = keys[i:i + chunk]
            with self._lock:
                # Tier state is read under the lock each chunk: a
                # checkpoint may freeze the memtable between chunks.
                if not self._ssts and self._frozen is None:
                    rows_get = self._table(table).rows.get
                    rows = ((key, rows_get(key)) for key in ck)
                elif pattern is not None:
                    # Selective regexp scans touch few rows: per-key
                    # merged reads beat extracting whole key ranges.
                    rows = ((key, self._merged_row(table, key))
                            for key in ck)
                else:
                    hi = keys[i + chunk] if i + chunk < len(keys) \
                        else (stop or None)
                    rows = self._merged_range(table, ck, hi, skip_paths)
                out = []
                for key, row in rows:
                    if not row:
                        continue
                    items = [(q, v) for (f, q), v in row.items()
                             if v is not None
                             and (family is None or f == family)]
                    if items:
                        items.sort()
                        out.append((key, items))
            yield from out

    def _merged_range(self, table: str, ck: list[bytes],
                      hi: bytes | None, skip_paths: set[str] | None):
        """(key, merged row) for the sorted keys ``ck`` (all < ``hi``):
        each generation is range-read once for the chunk instead of probed
        per key, those in ``skip_paths`` not at all. Overlay order and
        tombstones are _merged_row's. Caller holds the lock."""
        t = self._table(table)
        ft = self._frozen.get(table) if self._frozen else None
        # Row tombstones suppress generation rows before the decode.
        masked = t.row_tombs
        if ft is not None and ft.row_tombs:
            masked = masked | ft.row_tombs
        merged: dict[bytes, dict] = {}
        lo = ck[0]
        for sst in self._ssts:
            if skip_paths and sst.path in skip_paths:
                continue
            for key, cells in sst.iter_rows_range(table, lo, hi,
                                                  skip=masked):
                row = merged.get(key)
                if row is None:
                    row = merged[key] = {}
                for f, q, v in cells:
                    row[(f, q)] = v
        if ft is not None:
            for key in ft.range_keys(lo, hi):
                if key in t.row_tombs:
                    continue
                row = merged.setdefault(key, {})
                for ckey, v in ft.rows[key].items():
                    if v is None:
                        row.pop(ckey, None)
                    else:
                        row[ckey] = v
        live_get = t.rows.get
        for key in ck:
            row = merged.get(key)
            lrow = live_get(key)
            if lrow:
                if row is None:
                    row = dict(lrow)
                else:
                    for ckey, v in lrow.items():
                        if v is None:
                            row.pop(ckey, None)
                        else:
                            row[ckey] = v
            yield key, row

    # -- atomics ----------------------------------------------------------

    def atomic_increment(self, table: str, key: bytes, family: bytes,
                         qualifier: bytes, amount: int = 1) -> int:
        """Increment an 8-byte big-endian counter cell, returning the new
        value (initialized from 0 like HBase's ICV); logged as the
        absolute value so replay is idempotent."""
        with self._lock:
            row = self._merged_row(table, key)
            cur = row.get((family, qualifier)) if row else None
            value = (struct.unpack(">q", cur)[0] if cur else 0) + amount
            packed = struct.pack(">q", value)
            self.mutation_seq += 1
            self._wal_append(_OP_PUT, table.encode(), key, family,
                             qualifier, packed)
            self._apply_put(table, key, family, qualifier, packed)
        return value

    def compare_and_set(self, table: str, key: bytes, family: bytes,
                        qualifier: bytes, expected: bytes | None,
                        value: bytes) -> bool:
        """Atomic CAS: write only if the cell currently equals ``expected``
        (None = cell must not exist). Returns success."""
        with self._lock:
            row = self._merged_row(table, key)
            cur = row.get((family, qualifier)) if row else None
            if cur != expected:
                return False
            self.mutation_seq += 1
            self._wal_append(_OP_PUT, table.encode(), key, family,
                             qualifier, value)
            self._apply_put(table, key, family, qualifier, value)
        return True
