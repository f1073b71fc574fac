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
- Durability knobs: ``fsync=True`` adds an ``os.fsync`` to every WAL
  flush (power-loss safety); ``wal_group_ms > 0`` (``Config.wal_group_ms``)
  turns on WAL group commit: appends take a ticket under the store lock
  and the acknowledging call parks, after releasing it, until one
  leader's covering flush (+ fsync) has covered its ticket. Nothing
  acknowledges before its covering flush; only the number of fsyncs
  changes, and the WAL bytes are the same either way.
- Fault points (``fault/faultpoints.py``) sit where the JAX store's do:
  ``kv.wal.append``, ``kv.wal.fsync``, ``kv.wal.group.write`` /
  ``.fsync`` and ``kv.checkpoint.freeze`` / ``.commit`` / ``.manifest``,
  with the same path and byte arguments, so a torn write cuts the same
  span.
- Instruments (``obs/registry.py``, the JAX store's names, always on):
  ``wal.appends`` / ``wal.append_bytes`` per WAL record, the
  ``wal.append`` timer per batch record, ``wal.fsync`` (a timer around the
  ``os.fsync`` and a trace span around the flush's fault point and
  fsync), the group commit's ``wal.group.batches`` / ``.points`` /
  ``.fsyncs`` and ``wal.group.wait_ms``, and ``checkpoint.phase`` timers
  tagged ``phase=freeze|spill|commit``. Each fires per WAL batch or
  checkpoint phase, never per point.

A sharded store (``SHARDS.json`` at the root of a directory of
``shard-<i>/`` stores) opens through ``storage/sharded.py``; handing its
root to this class is an error.

``sstable_codec`` (``Config.sstable_codec``, set after open as in the JAX
package) picks the spill's format: "none" writes TSST3, "tsst4"
compressed columnar blocks; the checkpoint's merge re-encodes into it,
and generations of every format mix in one store. ``compress_stats`` sums
the v4 generations' raw and stored record bytes (``compress.ratio``), and
``encoded_range`` is the fused query plan's source check.

The rollup tier's hooks (rollup/tier.py): ``record_spill_keys`` makes the
checkpoint record the spilled row keys (``peek_spill_keys`` /
``take_spill_keys``), whose bases stay in ``dirty_bases`` until drained
(``_spill_dirty``); ``pending_keys`` is the fold's dirty source, and
``delete_hook`` tells the delta accumulators of deletes. A store with a
rollup tier on disk refuses to checkpoint unless the tier is open.

Read-only replicas (``read_only=True``, ROADMAP item 10a) open another
daemon's store without the single-writer lock: they never truncate a
torn tail (the writer may be mid-append), never delete a generation the
manifest does not name, and refuse every mutation with
``ReadOnlyStoreError``. ``refresh()`` catches a replica up: a suffix
replay on the open WAL fd while the writer only appended, else a full
rebuild (``rebuilds``; ``mutation_seq`` moves and the fragment cache's
stamp floor jumps, since what changed is unknown). An open or rebuild
validates its capture: the manifest, ``<wal>.old`` and the WAL's inode
must be what they were while it loaded, else it loads again (the JAX
replica can read the generations of one moment and the WAL files of
another, ROADMAP queue C). Fault points ``replica.refresh`` and
``replica.rebuild``.

The cluster epoch fence (``cluster/epoch.py``): a store opened with
``writer_epoch`` begins every WAL segment it opens with an ``_OP_EPOCH``
record, and replay refuses everything from a header whose epoch is lower
than one already replayed (``fenced_bytes_refused``); ``epoch_guard`` is
checked at every mutation and, forced, around the checkpoint's rotation
and commit. A store without an epoch writes no header, so a non-cluster
WAL's bytes are unchanged. ``promote_writable`` turns a replica into the
writer (fault points ``cluster.promote.take`` and
``cluster.promote.rotate``: the WAL is copied into ``<wal>.old`` and
reopened under a fresh inode, so a zombie's open fd appends to a file
nobody replays) and ``demote_readonly`` turns it back.
"""

from __future__ import annotations

import fcntl
import json
import logging
import os
import re
import shutil
import struct
import threading
import time
import zlib
from bisect import bisect_left
from typing import Iterator, NamedTuple

import numpy as np

from opentsdb_tpu_torch.core.const import TIMESTAMP_BYTES, UID_WIDTH
from opentsdb_tpu_torch.core.errors import (FencedWriterError,
                                             PleaseThrottleError,
                                             ReadOnlyStoreError)
from opentsdb_tpu_torch.fault.faultpoints import fire as _fault
from opentsdb_tpu_torch.obs import trace as _trace
from opentsdb_tpu_torch.obs.registry import METRICS as _metrics
from opentsdb_tpu_torch.storage.sstable import (SSTable, merge_sstables,
                                                write_sstable_bulk)
from opentsdb_tpu_torch.utils.nativeext import EXT as _EXT

_REC = struct.Struct(">BI")  # op, payload length
_perf = time.perf_counter

# Engine instruments (obs/registry.py): registered once at import, so the
# hot paths pay one attribute increment or one perf_counter pair per WAL
# batch or checkpoint phase, never per point.
_M_WAL_APPENDS = _metrics.counter("wal.appends")
_M_WAL_BYTES = _metrics.counter("wal.append_bytes")
_M_WAL_APPEND = _metrics.timer("wal.append")
_M_WAL_FSYNC = _metrics.timer("wal.fsync")
# Group commit (Config.wal_group_ms): batches = appends whose flush was
# deferred to a group leader, points = the records' cells, fsyncs = the
# covering group flushes, wait_ms = the time acknowledging calls spent
# parked in the barrier.
_M_GRP_BATCHES = _metrics.counter("wal.group.batches")
_M_GRP_POINTS = _metrics.counter("wal.group.points")
_M_GRP_FSYNCS = _metrics.counter("wal.group.fsyncs")
_M_GRP_WAIT = _metrics.timer("wal.group.wait_ms")
_M_CKPT_PHASE = {ph: _metrics.timer("checkpoint.phase", {"phase": ph})
                 for ph in ("freeze", "spill", "commit")}

# WAL opcodes (the JAX store's numbering).
_OP_PUT = 1
_OP_DELETE = 2
_OP_DELETE_ROW = 3
_OP_PUT_BATCH = 4   # one columnar record for a whole put_many batch
# WAL segment epoch header (cluster/epoch.py): a cluster-mode writer
# begins every WAL segment it opens with its epoch, and replay refuses any
# segment whose header epoch is LOWER than one already seen.
_OP_EPOCH = 5

# Bounded retries of a replica's open (_open_tiers_retrying): a writer's
# merge can unlink a generation, or its checkpoint move the WAL files,
# while the replica loads.
_RO_OPEN_TRIES = 64

# Row-key bytes holding the base time (core/codec.row_key): the bloom
# probe hashes the key around them.
_BASE_LO = UID_WIDTH
_BASE_HI = UID_WIDTH + TIMESTAMP_BYTES

# A sharded store's manifest, at the root of the directory its --wal
# names (storage/sharded.py).
_SHARDS_NAME = "SHARDS.json"

# Version written into <wal>.tenants.json at a checkpoint by a writer that
# keeps no tenant accounting: any value but the snapshot's 1 makes the
# next open (either package's) rebuild tenant accounting from storage
# (MemKVStore._retire_snapshots).
_FOREIGN_TENANTS_VERSION = 0


def write_tenant_marker(path: str) -> None:
    """Replace the tenant snapshot at ``path`` with a file of a foreign
    version (durably: tmp + fsync + rename + directory fsync), which the
    next open of either package answers with a full rebuild from storage
    (``MemKVStore._retire_snapshots``)."""
    with open(path + ".tmp", "w") as f:
        json.dump({"version": _FOREIGN_TENANTS_VERSION,
                   "written_by": "opentsdb_tpu_torch",
                   "note": "this store keeps no tenant accounting; "
                           "rebuild it from storage"}, f)
        f.flush()
        os.fsync(f.fileno())
    os.replace(path + ".tmp", path)
    dfd = os.open(os.path.dirname(os.path.abspath(path)), os.O_RDONLY)
    try:
        os.fsync(dfd)
    finally:
        os.close(dfd)


class _CaptureChanged(Exception):
    """A replica's open read the store files of two moments (the writer
    checkpointed meanwhile): load again."""


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

    def has_row(self, table: str, key: bytes) -> bool:
        raise NotImplementedError

    def put(self, table: str, key: bytes, family: bytes, qualifier: bytes,
            value: bytes, durable: bool = True) -> None:
        raise NotImplementedError

    def put_many(self, table: str, family: bytes,
                 cells: list[tuple[bytes, bytes, bytes]],
                 durable: bool = True, sync: bool = True) -> list[bool]:
        """Write (key, qualifier, value) cells; returns, per cell, True
        when the row holds other cells by the time this one lands (it
        existed before the batch, or an earlier cell of the batch hit it:
        the caller queues a compaction). On a PleaseThrottleError
        mid-batch, its ``partial_existed`` carries the flags of the cells
        that did apply. ``sync=False`` defers the WAL group-commit wait
        (stores without group commit ignore it): the caller must call
        ``wal_barrier()`` before acknowledging."""
        raise NotImplementedError

    def put_many_columnar(self, table: str, family: bytes,
                          key_blob: bytes, key_len: int,
                          quals: list[bytes], vals: list[bytes],
                          durable: bool = True,
                          sync: bool = True) -> list[bool]:
        """``put_many`` with cell i's key the i-th ``key_len``-byte slice
        of ``key_blob``."""
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

    def wal_barrier(self, ticket: int | None = None) -> None:
        """Wait for the WAL group-commit flush covering everything
        appended so far (see MemKVStore). Default: nothing to wait for, a
        store without group commit is durable when a mutation returns."""

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
    mutation's WAL record is flushed past the userspace buffer (and, with
    ``fsync``, to stable storage) before the call acknowledges: at once,
    or under group commit by the covering group flush; ``flush()`` fsyncs.
    """

    # Sabotage gate for the crash matrix (fault/harness.py --bug
    # ack-before-fsync): True makes _wal_barrier return at once, so
    # group-commit writes acknowledge before their covering flush, the
    # regression the kv.wal.group.* rows must catch.
    _ACK_BEFORE_FSYNC = False

    # _REC frames a payload with a u32 length: batches whose blobs approach
    # that split into several _OP_PUT_BATCH records (replay applies them in
    # order, so the split is invisible).
    _WAL_BATCH_LIMIT = 1 << 30

    # Generation cap: at this many, a checkpoint collapses a size-tiered
    # suffix of the generations (_select_merge_suffix).
    _MAX_GENERATIONS = 8

    def __init__(self, wal_path: str | None = None,
                 throttle_rows: int | None = None, fsync: bool = False,
                 max_generations: int | None = None,
                 read_only: bool = False,
                 writer_epoch: int | None = None,
                 epoch_guard=None) -> None:
        """``throttle_rows``: live rows per table past which puts that
        create a row raise PleaseThrottleError. ``fsync``: fsync the WAL
        at every flush. ``max_generations`` overrides the generation cap
        (at least 2; the sharded store staggers it per shard).

        ``read_only=True`` opens another daemon's store without the
        single-writer lock, as a replica (module docstring).
        ``writer_epoch`` (cluster mode) stamps this writer's epoch into
        every WAL segment it opens; ``epoch_guard`` (an ``EpochGuard``)
        fences every mutation and the checkpoint. Both default off."""
        self._tables: dict[str, _Table] = {}
        self._lock = threading.RLock()
        if max_generations is not None:
            if max_generations < 2:
                raise ValueError(
                    f"max_generations must be >= 2, got {max_generations}")
            self._MAX_GENERATIONS = max_generations
        self.throttle_rows = throttle_rows
        self._fsync = fsync
        self._wal_path = wal_path
        self._wal = None
        self._lockfd: int | None = None
        self.read_only = read_only
        # Cluster write tier: the epoch this writer owns (None: no
        # headers, no fence), its mutation-path guard, the highest header
        # epoch the replay stream has produced, and the bytes replay
        # refused past a fence line (zombie segments).
        self.writer_epoch = writer_epoch
        self.epoch_guard = epoch_guard
        self._replay_epoch = 0
        self.fenced_bytes_refused = 0
        # Replica full rebuilds (each follows a writer checkpoint); the
        # TSDB reloads its sketches when this moves.
        self.rebuilds = 0
        # Replica replay position: {"wal": (inode, replayed bytes),
        # "old": (inode, size) | None}, as of the last open or refresh.
        self._ro_state: dict | None = None
        # Spill tier: sstable generations, OLDEST FIRST.
        self._ssts: list[SSTable] = []
        self._sst_path = wal_path + ".sst" if wal_path else None
        # Immutable middle tier while a checkpoint's spill is in flight.
        self._frozen: dict[str, _Table] | None = None
        # Write-side sstable codec: "none" spills TSST3, "tsst4"
        # compressed blocks. The read side sniffs each file's format, so
        # this affects only later spills and merges.
        self.sstable_codec = "none"
        # Seconds the last open spent loading generations and replaying
        # <wal>.old + the WAL.
        self.open_seconds = {"generations": 0.0, "replay": 0.0}
        # Monotonic mutation counter, bumped per mutating CALL (not per
        # cell) and per checkpoint tier transition: an unchanged seq means
        # the stored rows cannot have changed.
        self.mutation_seq = 0
        # Rollup-tier hooks (rollup/tier.py). ``record_spill_keys``: the
        # checkpoint records the row keys of every spilled frozen tier
        # (row tombstones included) so the fold covers exactly what left
        # the memtable; ``take_spill_keys`` drains the record, and
        # ``_spill_dirty`` carries its base refcounts, so the undrained
        # spill stays in ``dirty_bases``. ``delete_hook(table, key)`` runs
        # on every delete / delete_row, so the delta accumulators
        # (rollup/delta.py) learn of out-of-band point-set changes.
        self.record_spill_keys = False
        self._last_spill_keys: dict[str, list[bytes]] = {}
        self._spill_dirty: dict[str, dict[int, int]] = {}
        self.delete_hook = None
        # The fragment cache's invalidation spine: per (table, base), the
        # mutation_seq of the last row create/remove that touched it,
        # folded in from each tier's ``touch`` map when the tier retires
        # (phase-3 drop, empty-checkpoint drop, thaw), so the signal
        # outlives the memtable generation that made it. A fragment built
        # at seq E over a clean base range is still exact iff no base in
        # the range carries a stamp > E and E >= _stamp_floor: rows enter
        # or leave the visible data only through stamped memtable
        # transitions, and a checkpoint merely moves them between tiers.
        # The floor stays 0 on a writer: a replica's rebuild (and a
        # promotion), where what changed is unknown, jumps it instead.
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
        # Point lookups (_lower_tier_has) a generation's bloom answered
        # without a bisect; WAL flush failures swallowed because an
        # exception was already in flight (the applied cells are not
        # durable until the next flush succeeds). Both /stats lines.
        self.bloom_point_skips = 0
        self.wal_swallowed_flush_errors = 0
        # WAL group commit (Config.wal_group_ms, set after open like the
        # JAX store's): > 0 defers the per-append flush (+ fsync) to a
        # leader-elected group flush. Appends bump _grp_written (a ticket
        # counter) under the store lock; acknowledging calls run
        # _wal_barrier(ticket) after releasing it and park on _grp_cond
        # until _grp_flushed covers their ticket. Lock order: store lock,
        # then _grp_cond, everywhere.
        self._wal_group_ms = 0.0
        self._grp_cond = threading.Condition()
        self._grp_written = 0     # tickets issued (appends recorded)
        self._grp_flushed = 0     # tickets covered by a flush
        self._grp_leader = False  # a leader is collecting or flushing
        self._grp_file_epoch = 0  # bumped per WAL rotation
        # Last byte offset covered by a group flush: bounds the span the
        # kv.wal.group.fsync fault point may tear (never bytes an earlier
        # group flush made durable).
        self._grp_synced_pos = 0
        # Covering group flushes done (the smoke's fsyncs per second).
        self.wal_group_flushes = 0
        if not wal_path:
            return
        if os.path.exists(os.path.join(wal_path, _SHARDS_NAME)):
            raise RuntimeError(
                f"{wal_path!r} is the root of a sharded store "
                f"({_SHARDS_NAME}): open it with "
                f"storage.sharded.ShardedKVStore")
        if read_only:
            self._open_tiers_retrying(wal_path)
            return
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
        and open the WAL for append (stamping this writer's epoch header).
        A replica truncates nothing, opens nothing for append, and
        validates its capture (``_open_replica_wals``)."""
        t0 = time.perf_counter()
        self._replay_epoch = 0
        gens = self._generation_paths()
        for path in gens:
            sst = SSTable(path)
            self._ssts.append(sst)
            for name in sst.tables():
                self._table(name)
        t1 = time.perf_counter()
        if self.read_only:
            self._open_replica_wals(wal_path, gens)
        else:
            for path in (wal_path + ".old", wal_path):
                if os.path.exists(path):
                    valid = self._replay(path)
                    if valid < os.path.getsize(path):
                        # Torn record at the tail (crash mid-write, or a
                        # zombie segment past a fence line): truncate so
                        # appends continue from the last valid boundary.
                        with open(path, "r+b") as f:
                            f.truncate(valid)
            self._wal = open(wal_path, "ab")
            self._stamp_epoch_header()
        self.open_seconds = {"generations": t1 - t0,
                             "replay": time.perf_counter() - t1}

    def _open_replica_wals(self, wal_path: str, gens: list[str]) -> None:
        """A replica's replay of <wal>.old then the WAL over the
        generations ``gens`` named, each through one open fd, then a check
        that the capture is of one moment: the manifest still names
        ``gens``, <wal>.old is the file (inode and size) that was
        replayed, or still absent, and the WAL is the inode replayed.

        A writer's checkpoint moves records from the WAL to <wal>.old
        (phase 1) and from <wal>.old into a generation (phase 3: the
        manifest, then the unlink). A replica that read the manifest
        before phase 3 and looked for <wal>.old after it would serve the
        old generations and the new WAL without the frozen records; one
        that replayed <wal>.old and then opened a WAL that phase 1 had
        just rotated would miss the rotated records. Either way one of
        the three signatures changed, and ``_CaptureChanged`` makes
        ``_open_tiers_retrying`` load again."""
        old_path = wal_path + ".old"
        old_seen = None
        try:
            with open(old_path, "rb") as f:
                st = os.fstat(f.fileno())
                old_seen = (st.st_ino, st.st_size)
                self._replay_file(f)
        except FileNotFoundError:
            pass
        valid, ino = 0, -1
        try:
            with open(wal_path, "rb") as f:
                ino = os.fstat(f.fileno()).st_ino
                valid = self._replay_file(f)
        except FileNotFoundError:
            pass
        try:
            ino_now = os.stat(wal_path).st_ino
        except FileNotFoundError:
            ino_now = -1
        if (self._generation_paths() != gens
                or self._stat_old() != old_seen or ino_now != ino):
            raise _CaptureChanged(wal_path)
        self._ro_state = {"wal": (ino, valid), "old": old_seen}

    def _open_tiers_retrying(self, wal_path: str) -> None:
        """_open_tiers for replicas, retrying while the writer moves the
        files under it: a merge can unlink a generation between the
        manifest read and the file open (FileNotFoundError), and a
        checkpoint can change the capture (_CaptureChanged). The writer's
        state converges, so a bounded re-read wins the race; the later
        tries back off a millisecond each."""
        for attempt in range(_RO_OPEN_TRIES):
            for sst in self._ssts:
                sst.close()
            self._tables = {}
            self._ssts = []
            try:
                self._open_tiers(wal_path)
                return
            except (FileNotFoundError, _CaptureChanged):
                if attempt >= 8:
                    time.sleep(0.001 * (attempt - 7))
        for sst in self._ssts:
            sst.close()
        self._ssts = []
        raise FileNotFoundError(
            f"store files for {wal_path!r} kept changing mid-open "
            f"(writer checkpointing continuously?); gave up after "
            f"{_RO_OPEN_TRIES} tries")

    def _stat_old(self) -> "tuple[int, int] | None":
        try:
            st = os.stat(self._wal_path + ".old")
            return (st.st_ino, st.st_size)
        except OSError:
            return None

    def refresh(self) -> bool:
        """Catch a read-only replica up to the writer's current durable
        state. Returns True when anything changed.

        When the WAL is the same file and has only grown, just the suffix
        replays, read through the open fd whose inode was checked (a
        rotation between a path stat and the open would otherwise seek
        the old offset inside the new file). A changed manifest, a
        <wal>.old that appeared or changed, or a rotated WAL (the writer
        checkpointed) triggers a full rebuild, which is crash recovery,
        so it is correct in any in-flight writer state."""
        if not self.read_only:
            raise ValueError("refresh() is for read-only stores")
        if not self._wal_path:
            return False
        # raise / ioerror here stand for a poll hitting writer churn or a
        # flaky volume: the replica keeps serving its pre-refresh view.
        _fault("replica.refresh", self._wal_path)
        with self._lock:
            if [s.path for s in self._ssts] != self._generation_paths():
                self._rebuild_locked()
                return True
            state = self._ro_state or {"wal": (-1, 0), "old": None}
            if self._stat_old() != state["old"]:
                # A checkpoint is in flight (or a new crash remnant): its
                # records precede the current WAL, so only a rebuild
                # catches up. Recording its (inode, size) makes a long
                # merge cost one rebuild, not one per poll.
                self._rebuild_locked()
                return True
            try:
                f = open(self._wal_path, "rb")
            except OSError:
                return False
            with f:
                st = os.fstat(f.fileno())
                ino, off = state["wal"]
                if st.st_ino != ino or st.st_size < off:
                    self._rebuild_locked()
                    return True
                if st.st_size == off:
                    return False
                valid = self._replay_file(f, start=off)
            self._ro_state = {"wal": (ino, valid), "old": state["old"]}
            if valid > off:
                # The suffix mutated the memtable outside the put and
                # delete entry points: caches keyed on mutation_seq must
                # see it move.
                self.mutation_seq += 1
            return valid > off

    def _rebuild_locked(self) -> None:
        """Full replica reload: fresh tables, the current generations,
        <wal>.old + WAL replay (crash recovery without truncation). Caller
        holds the lock. Handles of dropped generations close afterwards
        (an unlinked file stays readable until its fd closes). On failure
        the pre-rebuild view stays, whole."""
        old_ssts, old_tables = self._ssts, self._tables
        old_state = self._ro_state
        _fault("replica.rebuild", self._wal_path)
        self._ssts = []
        self._ro_state = None
        try:
            self._open_tiers_retrying(self._wal_path)
        except BaseException:
            for sst in self._ssts:
                sst.close()
            self._ssts, self._tables = old_ssts, old_tables
            self._ro_state = old_state
            raise
        self.rebuilds += 1
        self._jump_stamp_floor()
        for sst in old_ssts:
            sst.close()

    def _jump_stamp_floor(self) -> None:
        """The generation set was replaced whole and what changed inside
        it is unknown: move mutation_seq and raise the stamp floor to it,
        so every fragment cached against an earlier seq is invalid."""
        self.mutation_seq += 1
        self._stamp_floor = self.mutation_seq
        self._base_stamps = {}
        self._stamps_snap = {}
        self._dirty_snap = {}

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
        if self.read_only:
            # A replica never deletes (a "stray" may be the live writer's
            # generation mid-rename) and never filters on existence: a
            # generation a merge unlinked since the manifest read makes
            # the open raise FileNotFoundError, and the retry re-reads.
            return [os.path.join(d, fn) for fn in names]
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

    def _check_writable(self) -> None:
        if self.read_only:
            raise ReadOnlyStoreError(
                f"store on {self._wal_path!r} is a read-only replica")
        if self.epoch_guard is not None:
            # The zombie fence: raises FencedWriterError once a promotion
            # has bumped the persisted epoch past ours (stat-cached).
            self.epoch_guard.check()

    @property
    def mutation_seqs(self) -> tuple[int, ...]:
        """Per-shard mutation sequence vector (a single store is one
        shard)."""
        return (self.mutation_seq,)

    def pending_keys(self, table: str) -> list[bytes]:
        """Row keys (and row tombstones) the rollup fold does not cover
        yet: the live memtable, a frozen mid-checkpoint tier, and the
        undrained spilled-key record. Spilled keys stay pending until the
        fold drains them (``take_spill_keys``), so no instant exists where
        a spilled-but-unfolded window is in neither this set nor the
        tier's in-flight set."""
        with self._lock:
            t = self._table(table)
            out = list(t.rows)
            out.extend(t.row_tombs)
            if self._frozen is not None:
                ft = self._frozen.get(table)
                if ft is not None:
                    out.extend(ft.rows)
                    out.extend(ft.row_tombs)
            out.extend(self._last_spill_keys.get(table, ()))
            return out

    def peek_spill_keys(self) -> dict[str, list[bytes]]:
        """Non-draining copy of the spilled-key record: the rollup fold
        marks their windows in flight while the keys still read as
        pending, then drains with ``take_spill_keys``."""
        with self._lock:
            return {name: list(ks)
                    for name, ks in self._last_spill_keys.items()}

    def take_spill_keys(self) -> dict[str, list[bytes]]:
        """Drain the spilled-key record (see ``record_spill_keys``)."""
        with self._lock:
            out, self._last_spill_keys = self._last_spill_keys, {}
            self._spill_dirty = {}
            self.mutation_seq += 1  # the dirty-base set just shrank
            return out

    @property
    def spilled(self) -> bool:
        """Whether any sstable generation exists (data outside the
        WAL-replayable memtable)."""
        return bool(self._ssts)

    def dirty_bases(self, table: str) -> np.ndarray:
        """Sorted unique base times whose rows the immutable sstable
        tiers do not fully cover: live memtable rows and row tombstones,
        the frozen mid-checkpoint tier's, and the undrained spill record
        (``_spill_dirty``, while a rollup tier records). Kept incrementally
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
            sd = self._spill_dirty.get(table)
            if sd:
                bases.update(sd)
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

    def memtable_row_counts(self, table: str) -> list[int]:
        """Live-memtable row count, one element per shard (one here):
        the /stats ``storage.memtable.rows`` lines."""
        with self._lock:
            return [len(self._table(table).rows)]

    def sstable_format_bytes(self) -> dict[int, int]:
        """On-disk bytes of the live generations by sstable format
        version: the /stats ``sstable.bytes`` lines."""
        out: dict[int, int] = {}
        with self._lock:
            gens = list(self._ssts)
        for sst in gens:
            try:
                sz = os.path.getsize(sst.path)
            except OSError:
                continue
            out[sst.format] = out.get(sst.format, 0) + sz
        return out

    def compress_stats(self) -> tuple[int, int]:
        """(uncompressed_record_bytes, stored_record_bytes) summed over
        the v4 generations: ``compress.ratio`` = raw / stored. (0, 0)
        when no generation is compressed."""
        raw = enc = 0
        with self._lock:
            gens = list(self._ssts)
        for sst in gens:
            cs = sst.codec_stats()
            if cs is not None:
                raw += cs[0]
                enc += cs[1]
        return raw, enc

    def encoded_range(self, table: str, start: bytes,
                      stop: bytes | None):
        """The fused plan's source check: when every generation holding
        keys in [start, stop) is format v4, [(sstable, lo_idx, hi_idx)]
        ordered by first key. None whenever serving the range off raw
        blocks could diverge from a scan: a frozen mid-checkpoint tier,
        live row tombstones, or a non-v4 generation in range. Two overlay
        risks stay the CALLER's: memtable rows (the executor's
        chunk_state declines on any dirty base) and duplicate keys across
        generations (compress/fused.gather serves them only when the
        copies' qualifier-delta ranges are disjoint)."""
        with self._lock:
            if self._frozen is not None:
                return None
            t = self._tables.get(table)
            if t is not None and t.row_tombs:
                return None
            gens = list(self._ssts)
        spans = []
        for g in gens:
            idx = g._index.get(table)
            if not idx or not idx[0]:
                continue
            keys, _ = idx
            lo = bisect_left(keys, start)
            hi = bisect_left(keys, stop) if stop else len(keys)
            if lo == hi:
                continue
            if g.format != 4:
                return None
            spans.append((g, lo, hi, keys[lo]))
        spans.sort(key=lambda sp: sp[3])
        return [(g, lo, hi) for g, lo, hi, _ in spans]

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

    def cell_count(self, table: str, key: bytes) -> int:
        with self._lock:
            row = self._merged_row(table, key)
            return len(row) if row else 0

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
                self.bloom_point_skips += 1
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
        _M_WAL_APPENDS.inc()
        _M_WAL_BYTES.inc(_REC.size + len(payload))
        if self._wal_group_ms > 0:
            self._grp_note(1)
        else:
            self._wal_flush()
            _fault("kv.wal.append", self._wal_path,
                   _REC.size + len(payload))

    def _wal_flush(self) -> None:
        # Past the userspace buffer before the mutation acknowledges: a
        # crash of the process then loses nothing acknowledged; ``fsync``
        # also survives power loss.
        self._wal.flush()
        # Between the userspace flush and the optional fsync: a crash here
        # loses nothing on process death, everything unsynced on power
        # loss; ioerror stands for the fsync itself failing. The span
        # brackets the fault point too, so an armed delay stretches
        # exactly the wal.fsync span of a traced ingest.
        with _trace.span("wal.fsync"):
            _fault("kv.wal.fsync", self._wal_path)
            if self._fsync:
                with _M_WAL_FSYNC.time():
                    os.fsync(self._wal.fileno())
        # In group mode every direct flush runs under the store lock
        # (checkpoint rotation, close, flush) and covers every record
        # written so far: every issued ticket is durable.
        if self._wal_group_ms > 0:
            self._grp_sync_locked()

    # -- WAL group commit (Config.wal_group_ms) ---------------------------
    #
    # Appends write into the WAL's userspace buffer under the store lock,
    # but the per-append flush (+ fsync) is deferred: each append takes a
    # ticket, and the acknowledging call parks in _wal_barrier, after
    # releasing the store lock, until a group flush covers its ticket. The
    # first parked thread elects itself leader, lingers up to wal_group_ms
    # collecting followers, then flushes once for everything written so
    # far.

    def _grp_note(self, points: int) -> None:
        """Record a deferred-flush append of ``points`` cells (store lock
        held). The fault point has no path on purpose: the record may
        still sit in the userspace buffer, so a torn cut could reach bytes
        an earlier group flush made durable; torn degrades to a crash
        here."""
        _fault("kv.wal.group.write")
        with self._grp_cond:
            self._grp_written += 1
        _M_GRP_BATCHES.inc()
        _M_GRP_POINTS.inc(points)

    def _grp_ticket(self) -> int:
        """The ticket for _wal_barrier, read under the store lock (every
        _grp_written bump happens under it); 0 outside group mode."""
        if self._wal_group_ms > 0 and self._wal is not None:
            return self._grp_written
        return 0

    def _grp_sync_locked(self) -> None:
        """After a direct full flush under the store lock: every issued
        ticket is covered. Advance the watermark and the durable byte
        position, and wake the parked barriers."""
        pos = 0
        if self._wal is not None:
            try:
                pos = self._wal.tell()
            except ValueError:
                pos = 0
        with self._grp_cond:
            self._grp_flushed = self._grp_written
            self._grp_synced_pos = max(self._grp_synced_pos, pos)
            self._grp_cond.notify_all()

    def _grp_rotated_locked(self) -> None:
        """The WAL was just rotated to a fresh file (store lock held):
        reset the durable position and bump the file epoch, so a leader
        still flushing the old file cannot move the new file's
        position."""
        with self._grp_cond:
            self._grp_file_epoch += 1
            self._grp_synced_pos = 0

    def _wal_group_flush(self) -> None:
        """The leader's covering flush (+ fsync), without the store lock
        (the buffered writer serializes against concurrent appends).
        Raises ValueError or OSError when a rotation closed the file
        underneath (the barrier decides)."""
        wal = self._wal
        if wal is None:
            return
        with self._grp_cond:
            epoch = self._grp_file_epoch
            synced = self._grp_synced_pos
        # The position before the flush is at most the file's size after
        # it, so the torn span below never reaches bytes an earlier group
        # flush covered.
        tell_pos = wal.tell()
        wal.flush()
        with _trace.span("wal.fsync"):
            _fault("kv.wal.group.fsync", self._wal_path,
                   max(tell_pos - synced, 1))
            if self._fsync:
                with _M_WAL_FSYNC.time():
                    os.fsync(wal.fileno())
        with self._grp_cond:
            if self._grp_file_epoch == epoch:
                self._grp_synced_pos = max(self._grp_synced_pos, tell_pos)
            self.wal_group_flushes += 1
        _M_GRP_FSYNCS.inc()

    def _wal_barrier(self, ticket: int) -> None:
        """Park until a group flush covers ``ticket``; the first caller not
        yet covered lingers wal_group_ms to collect followers, then
        flushes for everyone. Call after releasing the store lock."""
        if not ticket or MemKVStore._ACK_BEFORE_FSYNC:
            return
        t0 = _perf()
        cond = self._grp_cond
        linger = self._wal_group_ms / 1000.0
        while True:
            with cond:
                if self._grp_flushed >= ticket:
                    break
                if self._grp_leader:
                    # A leader is collecting or flushing; the timeout
                    # guards against a lost notify.
                    cond.wait(0.05)
                    continue
                self._grp_leader = True
                if linger > 0:
                    cond.wait(linger)
                target = self._grp_written
            err = None
            try:
                self._wal_group_flush()
            except BaseException as e:
                err = e
            with cond:
                self._grp_leader = False
                if err is None:
                    self._grp_flushed = max(self._grp_flushed, target)
                covered = self._grp_flushed >= ticket
                cond.notify_all()
            if err is not None:
                # A rotation or close may close the file under a leader,
                # but only after its own full flush covered every issued
                # ticket.
                if covered and isinstance(err, (ValueError, OSError)):
                    break
                raise err
        _M_GRP_WAIT.observe((_perf() - t0) * 1000.0)

    def wal_barrier(self, ticket: int | None = None) -> None:
        """Block until every WAL record appended so far (or up to
        ``ticket``) is covered by a group flush. Nothing to do outside
        group mode; safe to call without the store lock. Batch ingest
        calls it once per wire batch (``put_many(..., sync=False)`` per
        series, then one barrier)."""
        if self._wal_group_ms <= 0 or self._wal is None:
            return
        if ticket is None:
            with self._grp_cond:
                ticket = self._grp_written
        self._wal_barrier(ticket)

    @property
    def wal_group_ms(self) -> float:
        return self._wal_group_ms

    @wal_group_ms.setter
    def wal_group_ms(self, ms: float) -> None:
        """Set after open (``TSDB`` plumbs ``Config.wal_group_ms``).
        Turning it on seeds the durable byte position from the WAL's end:
        replayed history must never fall inside a torn group span."""
        self._wal_group_ms = float(ms)
        if self._wal_group_ms > 0 and self._wal is not None:
            with self._grp_cond:
                try:
                    self._grp_synced_pos = max(self._grp_synced_pos,
                                               self._wal.tell())
                except ValueError:
                    pass

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

    def _wal_batch_written(self, rec_bytes: int, cells: int,
                           t_app0: float) -> None:
        """After a batch's records (its ``cells``, written from
        ``t_app0``): note the group-commit ticket, or flush and pass the
        ``kv.wal.append`` fault point (its torn span is the last record);
        then the ``wal.append`` timer."""
        if self._wal_group_ms > 0:
            self._grp_note(cells)
            _M_WAL_APPEND.observe((_perf() - t_app0) * 1000.0)
            return
        self._wal_flush()
        _M_WAL_APPEND.observe((_perf() - t_app0) * 1000.0)
        _fault("kv.wal.append", self._wal_path, rec_bytes)

    def _wal_append_batch(self, table: bytes, family: bytes,
                          keys: list[bytes], quals: list[bytes],
                          vals: list[bytes]) -> None:
        """The _OP_PUT_BATCH record of a batch whose keys may differ in
        length (``put_many``); with keys of one length its bytes are the
        columnar record's."""
        if self._wal is None:
            return
        t_app0 = _perf()
        n = len(keys)
        kl = np.fromiter(map(len, keys), ">u4", n)
        ql = np.fromiter(map(len, quals), ">u4", n)
        vl = np.fromiter(map(len, vals), ">u4", n)
        for lo, hi in self._batch_splits(kl.astype(np.int64)
                                         + ql.astype(np.int64)
                                         + vl.astype(np.int64)):
            payload = b"".join((
                struct.pack(">IHH", hi - lo, len(table), len(family)),
                table, family,
                kl[lo:hi].tobytes(), ql[lo:hi].tobytes(),
                vl[lo:hi].tobytes(),
                b"".join(keys[lo:hi]), b"".join(quals[lo:hi]),
                b"".join(vals[lo:hi])))
            self._wal.write(_REC.pack(_OP_PUT_BATCH, len(payload))
                            + payload)
            _M_WAL_APPENDS.inc()
            _M_WAL_BYTES.inc(_REC.size + len(payload))
        self._wal_batch_written(_REC.size + len(payload), n, t_app0)

    def _wal_append_batch_columnar(self, table: bytes, family: bytes,
                                   key_blob: bytes, n: int, key_len: int,
                                   quals: list[bytes],
                                   vals: list[bytes]) -> None:
        """One _OP_PUT_BATCH record for a whole batch: header, three >u4
        length arrays, then the key/qualifier/value blobs."""
        if self._wal is None:
            return
        t_app0 = _perf()
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
            _M_WAL_APPENDS.inc()
            _M_WAL_BYTES.inc(_REC.size + len(payload))
        self._wal_batch_written(_REC.size + len(payload), n, t_app0)

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
        with open(path, "rb") as f:
            return self._replay_file(f)

    def _replay_file(self, f, start: int = 0) -> int:
        """_replay over an open file from byte ``start``; returns the
        valid byte count (absolute). An epoch header LOWER than one
        already replayed is a deposed writer's segment landing after a
        newer writer's: replay stops there (a writer's torn-tail
        truncation then cuts it; a replica's cursor stops) and the bytes
        from it on count in ``fenced_bytes_refused``."""
        valid = start
        if start:
            f.seek(start)
        while True:
            hdr = f.read(_REC.size)
            if len(hdr) < _REC.size:
                break  # truncated tail: stop at last complete record
            op, plen = _REC.unpack(hdr)
            payload = f.read(plen)
            if len(payload) < plen:
                break
            if op == _OP_EPOCH:
                (e,) = struct.unpack(">Q", self._split_payload(payload)[0])
                if e < self._replay_epoch:
                    try:
                        end = os.fstat(f.fileno()).st_size
                    except OSError:
                        end = valid
                    self.fenced_bytes_refused += max(end - valid, 0)
                    break
                self._replay_epoch = e
                valid += _REC.size + plen
                continue
            valid += _REC.size + plen
            if op == _OP_PUT_BATCH:
                self._replay_batch(payload)
                continue
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
                raise RuntimeError(
                    f"unknown WAL opcode {op} in {f.name!r}")
        return valid

    def _stamp_epoch_header(self, force: bool = False) -> None:
        """Begin (or continue) this writer's span in the WAL with an
        ``_OP_EPOCH`` record. ``force`` stamps unconditionally (a freshly
        rotated segment always needs a header); otherwise the stamp is
        skipped when the replayed stream already ended inside this
        writer's epoch (a clean same-epoch restart). A replayed epoch
        ABOVE our own means this process was deposed while down: refuse
        the WAL."""
        if self._wal is None or self.writer_epoch is None:
            return
        if self._replay_epoch > self.writer_epoch:
            raise FencedWriterError(
                f"WAL at {self._wal_path!r} already carries epoch "
                f"{self._replay_epoch}, this writer owns "
                f"{self.writer_epoch}: superseded while down",
                self.writer_epoch, self._replay_epoch)
        if force or self._replay_epoch < self.writer_epoch:
            self._wal_append(_OP_EPOCH, struct.pack(">Q", self.writer_epoch))
            self._replay_epoch = self.writer_epoch

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
                if self._wal_group_ms > 0:
                    self._grp_sync_locked()

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
                self._release_lock()

    def _simulate_crash(self) -> None:
        """Test hook: release the single-writer lock without flushing or
        closing, as process death does (the OS drops a dead process's
        flock; unflushed state is lost). Crash-recovery tests reopen the
        WAL path after calling this."""
        with self._lock:
            self._release_lock()

    # -- cluster promotion / demotion (cluster/) ----------------------------

    def _try_take_lock(self) -> bool:
        """Non-blocking attempt at the single-writer flock (a promotion,
        and a lockless promoted writer's later checkpoints). True when
        held after the call."""
        if self._lockfd is not None:
            return True
        lockfd = os.open(self._wal_path + ".lock",
                         os.O_CREAT | os.O_RDWR, 0o644)
        try:
            fcntl.flock(lockfd, fcntl.LOCK_EX | fcntl.LOCK_NB)
        except OSError:
            os.close(lockfd)
            return False
        self._lockfd = lockfd
        logging.getLogger(__name__).info(
            "took the single-writer lock at %s.lock", self._wal_path)
        return True

    def _release_lock(self) -> None:
        if self._lockfd is not None:
            os.close(self._lockfd)
            self._lockfd = None

    def promote_writable(self, writer_epoch: int,
                         epoch_guard=None) -> None:
        """Take write ownership of this replica's store. The caller has
        already bumped the persisted epoch (``bump_epoch``); this is the
        storage half:

        1. Try the single-writer flock, but do not let a wedged zombie
           that still holds it block the takeover: in cluster mode the
           epoch is the authority. The zombie is fenced by its guard at
           its next mutation, and its appends land on an unlinked inode.
        2. Run the writer's recovery over the store (torn tails
           truncated, <wal>.old + WAL replayed).
        3. Reopen the WAL under a fresh inode (``_promote_rotate_locked``)
           and stamp the new epoch header.

        Any failure leaves a coherent replica: the pre-promotion view,
        read-only, the lock released."""
        with self._lock:
            if not self.read_only:
                raise ValueError("promote_writable() is for read-only "
                                 "replica stores")
            if not self._wal_path:
                raise ValueError("an in-memory store cannot be promoted")
            if writer_epoch < 1:
                raise ValueError(f"writer epoch must be >= 1, got "
                                 f"{writer_epoch}")
            if not self._try_take_lock():
                logging.getLogger(__name__).warning(
                    "promoting over a held writer lock at %s.lock — "
                    "epoch fence (epoch %d) deposes the holder",
                    self._wal_path, writer_epoch)
            old_ssts, old_tables = self._ssts, self._tables
            old_state = self._ro_state
            self._ssts = []
            self._tables = {}
            self._ro_state = None
            self.read_only = False
            self.writer_epoch = int(writer_epoch)
            try:
                _fault("cluster.promote.take", self._wal_path)
                self._open_tiers(self._wal_path)
                self._promote_rotate_locked()
            except BaseException:
                for sst in self._ssts:
                    sst.close()
                if self._wal is not None:
                    self._wal.close()
                    self._wal = None
                self._ssts, self._tables = old_ssts, old_tables
                self._ro_state = old_state
                self.read_only = True
                self.writer_epoch = None
                self._release_lock()
                raise
            self.epoch_guard = epoch_guard
            for sst in old_ssts:
                sst.close()
            # The generation set was replaced whole: a rebuild, as far as
            # the sketch reload and the fragment cache can tell.
            self.rebuilds += 1
            self._jump_stamp_floor()

    def _promote_rotate_locked(self) -> None:
        """The fresh-inode WAL rotation of a promotion (the checkpoint's
        rotation, minus the spill): the WAL's records are COPIED into
        <wal>.old (appended to a crash remnant), never renamed there: a
        rename would keep the zombie's open inode linked at a name
        recovery replays. tmp + ``os.replace`` then mints the new WAL,
        whose first record is this writer's epoch header. Recovery
        replays .old then the WAL (an upsert, so a crash between the copy
        and the replace double-applies harmlessly)."""
        _fault("cluster.promote.rotate", self._wal_path)
        if self._wal is not None:
            self._wal_flush()
            self._wal.close()
            self._wal = None
        old_path = self._wal_path + ".old"
        if os.path.exists(self._wal_path):
            with open(old_path, "ab") as dst, \
                    open(self._wal_path, "rb") as src:
                # Streamed: the WAL at failover time can be the whole
                # ingest history.
                shutil.copyfileobj(src, dst, 1 << 20)
                dst.flush()
                os.fsync(dst.fileno())
            tmp = self._wal_path + ".rotate"
            self._wal = open(tmp, "wb")
            os.replace(tmp, self._wal_path)
        else:
            self._wal = open(self._wal_path, "ab")
        self._grp_rotated_locked()
        self._stamp_epoch_header(force=True)
        self._wal_flush()

    def demote_readonly(self) -> None:
        """Deposed writer -> tailing replica, in place: drop the WAL fd
        and the flock, flip read-only, and rebuild the view through the
        replica's recovery (which never truncates: the new writer owns
        the files). The caller (TSDB.demote) holds the checkpoint lock,
        so no spill is in flight."""
        with self._lock:
            if self.read_only:
                return
            if self._wal is not None:
                try:
                    self._wal.flush()
                except OSError:
                    pass  # likely an unlinked inode already
                self._wal.close()
                self._wal = None
            self._release_lock()
            # A frozen tier (fence tripped mid-checkpoint) is covered by
            # <wal>.old (the rotation preceded the freeze).
            self._frozen = None
            self.read_only = True
            self.writer_epoch = None
            self.epoch_guard = None
            self._rebuild_locked()

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
        if self._sst_path is None or self.read_only:
            return 0
        if self.epoch_guard is not None:
            # Fence BEFORE the rotation: a deposed writer's checkpoint
            # renames WAL files by path and rewrites the manifest, the
            # most destructive thing a zombie can do to its successor's
            # store. Forced: a checkpoint can afford a fresh read.
            self.epoch_guard.check(force=True)
        if self._lockfd is None and self.writer_epoch is not None:
            # A promotion over a still-held zombie flock came out
            # lockless (the epoch was the authority): take the lock once
            # the zombie is gone, so a later non-cluster writer is refused
            # by it as on any other store.
            self._try_take_lock()
        old_path = self._wal_path + ".old"
        t_p1 = _perf()
        with self._lock:
            if self._frozen is not None:
                return 0  # a spill is already in flight
            self._retire_snapshots(tenant_marker)
            self._frozen = self._tables
            self._tables = {name: _Table() for name in self._frozen}
            self.mutation_seq += 1
            if self._wal is not None:
                # Cover every deferred group-commit ticket before the file
                # goes away: parked barriers wake durable, and a leader
                # racing the close finds its ticket covered.
                if self._wal_group_ms > 0:
                    self._wal_flush()
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
                self._grp_rotated_locked()
                # A cluster-mode writer begins the fresh segment with its
                # epoch header (the replay fence's anchor).
                self._stamp_epoch_header(force=True)
            frozen = self._frozen
            spill_keys = None
            if self.record_spill_keys:
                # Keys leaving the memtable this checkpoint (row
                # tombstones included: a delete of spilled data must
                # reach the rollup fold too, or stale summaries would
                # keep serving the deleted points).
                spill_keys = {
                    name: list(ft.rows) + list(ft.row_tombs)
                    for name, ft in frozen.items()
                    if ft.rows or ft.row_tombs}
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
        _M_CKPT_PHASE["freeze"].observe((_perf() - t_p1) * 1000.0)

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
            # End of phase 1: the WAL is rotated (<wal>.old holds every
            # pre-checkpoint record), nothing spilled yet. A crash here
            # recovers from .old and the WAL alone; raise takes the thaw
            # below.
            _fault("kv.checkpoint.freeze", self._wal_path)
            # The codec keyword only when compressing, so the default
            # spill calls keep their shape.
            kw = ({"codec": self.sstable_codec}
                  if self.sstable_codec not in (None, "none") else {})
            with _M_CKPT_PHASE["spill"].time():
                if use_merge:
                    n = merge_sstables(out_path, merge_gens, {
                        name: (ft.rows, ft.row_tombs, bool(ft.tombs))
                        for name, ft in frozen.items()}, **kw)
                else:
                    # No tombstones in the frozen tier: every cell value
                    # is bytes and no lower generation needs reading.
                    n = write_sstable_bulk(out_path, {
                        name: ([k for k in sorted(ft.rows) if ft.rows[k]],
                               ft.rows)
                        for name, ft in frozen.items()}, **kw)
        except Exception:
            # Disk full or similar: thaw the frozen tier back under the
            # live memtable so the store is not wedged. <wal>.old stays;
            # the next checkpoint appends the live WAL to it.
            with self._lock:
                self._thaw_frozen_locked()
            raise

        t_p3 = _perf()
        with self._lock:
            new_sst = None
            unlink_new = True
            try:
                if self.epoch_guard is not None:
                    # Re-fence at the commit: a promotion that landed
                    # while phase 2 spilled must stop this checkpoint
                    # before it rewrites the manifest and unlinks
                    # <wal>.old under the new owner (the handler below
                    # backs the commit out).
                    self.epoch_guard.check(force=True)
                new_sst = SSTable(out_path)
                # Durable, but no manifest names it yet: a crash leaves a
                # stray the next open deletes (.old still replays
                # everything); raise takes the unlink-and-thaw below.
                _fault("kv.checkpoint.commit", out_path)
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
            # Manifest durable, the merged generations and <wal>.old not
            # yet unlinked: a crash leaves strays the next open deletes
            # and a .old that replays idempotently.
            _fault("kv.checkpoint.manifest", self._wal_path)
            # The frozen tier retires: its transition stamps fold into the
            # store-level map, so fragments built while (or before) its
            # rows were live keep invalidating, bases a create-then-delete
            # netted back to clean included.
            self._fold_touch_locked(frozen)
            if spill_keys is not None:
                for name, ks in spill_keys.items():
                    self._last_spill_keys.setdefault(name, []).extend(ks)
                # The frozen tier's dirty index is the spilled keys' base
                # refcounts (rows and row tombstones): carry it as the
                # undrained spill's dirty set, summed like the key record.
                for name, ft in frozen.items():
                    if ft.dirty:
                        sd = self._spill_dirty.setdefault(name, {})
                        for b, c in ft.dirty.items():
                            sd[b] = sd.get(b, 0) + c
            for g in merge_gens:
                path = g.path
                g.close()
                try:
                    os.unlink(path)
                except OSError:
                    pass
            if os.path.exists(old_path):
                os.unlink(old_path)
        _M_CKPT_PHASE["commit"].observe((_perf() - t_p3) * 1000.0)
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

        A rollup tier on disk (``<wal>.rollup-<res>/``) needs its
        summaries folded at every spill: unless the tier is open
        (``record_spill_keys``, set by ``rollup/tier.py``), such a store is
        refused here rather than spilled under stale summaries (ROADMAP
        queue C, the note on item 6: the JAX package spills without
        folding)."""
        if not self.record_spill_keys:
            d = os.path.dirname(os.path.abspath(self._wal_path))
            base = os.path.basename(self._wal_path)
            rollups = sorted(fn for fn in os.listdir(d)
                             if fn.startswith(base + ".rollup"))
            if rollups:
                raise RuntimeError(
                    f"{self._wal_path!r} has a rollup tier beside it "
                    f"({rollups}); checkpointing it without the tier open "
                    f"would leave its summaries behind the spilled rows: "
                    f"open it with enable_rollups=True (ROADMAP queue A "
                    f"item 6)")
        if tenant_marker:
            write_tenant_marker(self._wal_path + ".tenants.json")

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
        self._check_writable()
        with self._lock:
            self._check_throttle(table, key)
            self.mutation_seq += 1
            if durable:
                self._wal_append(_OP_PUT, table.encode(), key, family,
                                 qualifier, value)
            self._apply_put(table, key, family, qualifier, value)
            ticket = self._grp_ticket()
        self._wal_barrier(ticket)

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

    def put_many(self, table: str, family: bytes,
                 cells: list[tuple[bytes, bytes, bytes]],
                 durable: bool = True, sync: bool = True) -> list[bool]:
        """Batched put of (key, qualifier, value) cells under one lock, with
        one WAL record: ``put_many_columnar``'s semantics for keys of any
        length."""
        self._check_writable()
        if not cells:
            return []
        keys = [c[0] for c in cells]
        quals = [c[1] for c in cells]
        vals = [c[2] for c in cells]
        tenc = table.encode()
        return self._put_batch(
            table, family, keys, quals, vals, durable, sync,
            lambda m: self._wal_append_batch(tenc, family, keys[:m],
                                             quals[:m], vals[:m]))

    def put_many_columnar(self, table: str, family: bytes,
                          key_blob: bytes, key_len: int,
                          quals: list[bytes], vals: list[bytes],
                          durable: bool = True,
                          sync: bool = True) -> list[bool]:
        """Batched put with cell i's key the i-th ``key_len``-byte slice of
        ``key_blob``. Returns, per cell, True when the row held other
        cells by the time this one landed (it existed before the batch,
        in any tier, or an earlier cell of the batch hit it): the rows
        the caller must queue for compaction.

        A regular batch lands in bulk (``_try_fast_batch``); the rest
        takes the per-cell loop, where a cell that would create a row
        past ``throttle_rows`` stops the batch: the cells before it stay
        applied, their WAL record is written, and the PleaseThrottleError
        raised carries their flags as ``partial_existed``.

        ``sync=False`` (group commit only) returns without waiting for
        the covering group flush: the caller batches several puts and
        calls ``wal_barrier()`` once before acknowledging any of them
        (``server/wire.ingest_batch``)."""
        self._check_writable()
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
        tenc = table.encode()
        return self._put_batch(
            table, family, keys, quals, vals, durable, sync,
            lambda m: self._wal_append_batch_columnar(
                tenc, family, key_blob[:m * L], m, L, quals[:m], vals[:m]))

    def _put_batch(self, table: str, family: bytes, keys: list[bytes],
                   quals: list[bytes], vals: list[bytes], durable: bool,
                   sync: bool, wal_record) -> list[bool]:
        """The batched put under one lock; ``wal_record(m)`` writes the
        record of the first m cells."""
        existed: list[bool] = []
        wal = durable and self._wal is not None
        try:
            with self._lock:
                self.mutation_seq += 1
                seq = self.mutation_seq
                t = self._table(table)
                fast = self._try_fast_batch(table, t, family, keys, quals,
                                            vals)
                if fast is not None:
                    if wal:
                        wal_record(len(keys))
                    existed = fast
                else:
                    self._put_loop_locked(table, t, family, keys, quals,
                                          vals, seq, existed, wal,
                                          wal_record)
                ticket = self._grp_ticket()
        except BaseException:
            # A mid-batch throttle has applied, and will acknowledge
            # through partial_existed, a prefix whose records in group
            # mode are still unflushed tickets: cover them before the
            # exception escapes. A barrier failure must not replace the
            # error in flight.
            if sync and self._wal_group_ms > 0:
                try:
                    self.wal_barrier()
                except Exception:
                    self.wal_swallowed_flush_errors += 1
                    logging.getLogger(__name__).exception(
                        "group-commit barrier failed during "
                        "exceptional put_many exit")
            raise
        if sync:
            self._wal_barrier(ticket)
        return existed

    def _put_loop_locked(self, table: str, t: _Table, family: bytes,
                         keys: list[bytes], quals: list[bytes],
                         vals: list[bytes], seq: int, existed: list[bool],
                         wal: bool, wal_record) -> None:
        """The per-cell loop of an irregular batch (lock held), appending
        each applied cell's flag to ``existed``."""
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
            # partial_existed), so its record reaches the OS before the
            # call returns or raises. A WAL failure must not replace a
            # throttle error in flight: callers rely on partial_existed.
            m = len(existed)
            if wal and m:
                try:
                    wal_record(m)
                except Exception:
                    if batch_ok:
                        raise
                    self.wal_swallowed_flush_errors += 1
                    logging.getLogger(__name__).exception(
                        "WAL batch append failed during exceptional "
                        "put_many exit; %d applied cells not yet durable",
                        m)

    def delete(self, table: str, key: bytes, family: bytes,
               qualifiers: list[bytes]) -> None:
        self._check_writable()
        hook = self.delete_hook
        if hook is not None:
            hook(table, key)
        with self._lock:
            self.mutation_seq += 1
            self._wal_append(_OP_DELETE, table.encode(), key, family,
                             *qualifiers)
            self._apply_delete(table, key, family, qualifiers)
            ticket = self._grp_ticket()
        self._wal_barrier(ticket)

    def delete_row(self, table: str, key: bytes) -> None:
        self._check_writable()
        hook = self.delete_hook
        if hook is not None:
            hook(table, key)
        with self._lock:
            self.mutation_seq += 1
            self._wal_append(_OP_DELETE_ROW, table.encode(), key)
            self._apply_delete_row(table, key)
            ticket = self._grp_ticket()
        self._wal_barrier(ticket)

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
        self._check_writable()
        with self._lock:
            row = self._merged_row(table, key)
            cur = row.get((family, qualifier)) if row else None
            value = (struct.unpack(">q", cur)[0] if cur else 0) + amount
            packed = struct.pack(">q", value)
            self.mutation_seq += 1
            self._wal_append(_OP_PUT, table.encode(), key, family,
                             qualifier, packed)
            self._apply_put(table, key, family, qualifier, packed)
            ticket = self._grp_ticket()
        self._wal_barrier(ticket)
        return value

    def compare_and_set(self, table: str, key: bytes, family: bytes,
                        qualifier: bytes, expected: bytes | None,
                        value: bytes) -> bool:
        """Atomic CAS: write only if the cell currently equals ``expected``
        (None = cell must not exist). Returns success."""
        self._check_writable()
        with self._lock:
            row = self._merged_row(table, key)
            cur = row.get((family, qualifier)) if row else None
            if cur != expected:
                return False
            self.mutation_seq += 1
            self._wal_append(_OP_PUT, table.encode(), key, family,
                             qualifier, value)
            self._apply_put(table, key, family, qualifier, value)
            ticket = self._grp_ticket()
        self._wal_barrier(ticket)
        return True
