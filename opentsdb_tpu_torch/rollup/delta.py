"""Incremental delta accumulators for checkpoint rollup folds.

Mirrors ``opentsdb_tpu/rollup/delta.py`` of the JAX package, copied whole
(numpy only), so a delta-served fold writes the bytes of the JAX tier.

The checkpoint fold (tier.py ``_fold``) recomputes every summary record
whose coarse window holds a spilled row key by RE-READING the window's
raw rows — replace-from-raw keeps re-folds idempotent across WAL
replay, duplicate ingest, backfill, and deletes. That rescan is also
the dominant cost of checkpoints under sustained ingest, where almost
every spilled window is append-only: the points being rescanned are
exactly the points ``add_batch`` just wrote.

``DeltaFolds`` keeps those points in memory, per (series key, coarse
window), as the SAME columns the rescan would decode — timestamps and
f64 values with floats quantized through f32 (the stored width) and
ints widened i64→f64 — so a fold can feed them to ``_emit_series``
directly and produce bit-identical records without touching the raw
store.

Correctness does NOT rest on the tombstone set; a window is served
from its buffer only when four independent checks pass:

1. Feed cleanliness: every row-hour fed carried ``existed=False`` from
   ``put_many_columnar`` (the row had no cells we didn't feed) or was
   fed by us before. A pre-existing row (WAL replay, scalar puts,
   pre-buffer history) kills the window.
2. Coverage at serve time: the checkpoint spills the WHOLE memtable,
   so any unfolded raw data of the window has its row key in the same
   fold's spilled-key set — the fold serves a window from its buffer
   only if every spilled hour of the window was fed.
3. No prior records: data spilled AND folded in an earlier checkpoint
   (or a previous process) left a summary record in the coarse rollup
   row. A window whose record slot is already populated by anyone but
   this buffer falls back to the full rescan forever.
4. Invalidation hooks: scalar ``add_point`` writes, raw-table deletes
   (fsck, CLI, sabotage harness), and throttled partial batches kill
   their windows explicitly — they bypass the feed path, so checks
   1-2 cannot see them.

Anything killed, evicted (the ``Config.rollup_delta_points`` cap), or
simply never buffered takes the existing full re-read path; the two
paths emit through the same ``_MapBuffer`` under the same fold lock,
so mixing them within one fold is safe.
"""

from __future__ import annotations

import threading

import numpy as np

from opentsdb_tpu_torch.core import codec
from opentsdb_tpu_torch.core.const import TIMESTAMP_BYTES, UID_WIDTH
from opentsdb_tpu_torch.rollup import summary
from opentsdb_tpu_torch.rollup.summary import QUAL_MOMENTS, ROLLUP_FAMILY

# Tombstone-set bound: past this the set is cleared outright (sound —
# the serve-time checks carry correctness; tombstones only save the
# cost of re-buffering known-dead windows).
_DEAD_CAP = 1 << 20


class _Buf:
    """One (series, coarse window) accumulator: parallel ts/value
    chunk lists, merged lazily at serve time."""

    __slots__ = ("ts_chunks", "val_chunks", "fed", "gmin", "gmax",
                 "n", "folded")

    def __init__(self) -> None:
        self.ts_chunks: list[np.ndarray] = []
        self.val_chunks: list[np.ndarray] = []
        self.fed: set[int] = set()       # row-hour bases fed by us
        self.gmin = 0
        self.gmax = -1                   # empty: gmax < gmin
        self.n = 0
        # True once a fold emitted this window FROM THIS BUFFER: the
        # records now in the store are ours, so the no-prior-records
        # check is bypassed on later folds of the same (still
        # complete, still appended-to) window.
        self.folded = False

    def append(self, ts: np.ndarray, vals: np.ndarray) -> None:
        self.ts_chunks.append(ts)
        self.val_chunks.append(vals)
        lo, hi = int(ts[0]), int(ts[-1])
        if self.n == 0:
            self.gmin, self.gmax = lo, hi
        else:
            self.gmin = min(self.gmin, lo)
            self.gmax = max(self.gmax, hi)
        self.n += len(ts)

    def merged_ts(self) -> np.ndarray:
        if len(self.ts_chunks) > 1:
            self._compact()
        return self.ts_chunks[0]

    def _compact(self) -> None:
        ts = np.concatenate(self.ts_chunks)
        vals = np.concatenate(self.val_chunks)
        order = np.argsort(ts, kind="stable")
        self.ts_chunks = [ts[order]]
        self.val_chunks = [vals[order]]

    def columns(self) -> tuple[np.ndarray, np.ndarray]:
        """(ts, vals) sorted ascending — the ``_emit_series`` input
        shape. Chunks are individually sorted (``sort_dedup`` slices),
        so a single merged sort is exact."""
        if len(self.ts_chunks) > 1:
            self._compact()
        return self.ts_chunks[0], self.val_chunks[0]


class DeltaFolds:
    """In-memory per-(series, coarse window) point accumulators.

    Fed from ``TSDB.add_batch`` (the columnar fast path), consumed by
    ``RollupTier._fold``. All public methods are thread-safe;
    ``self.lock`` is strictly innermost — ``serve`` runs under the
    tier's fold lock, ``feed`` under no tier lock at all."""

    def __init__(self, coarse: int, cap_points: int) -> None:
        self.coarse = int(coarse)
        self.cap = max(int(cap_points), 1)
        self.lock = threading.Lock()
        self.bufs: dict[tuple[bytes, int], _Buf] = {}
        self.dead: set[tuple[bytes, int]] = set()
        self.total = 0
        self.enabled = True
        # Compaction rewrites rows delete-after-put with the SAME point
        # set; its deletes must not kill eligibility. Thread-local — the
        # compaction thread's preserve window must not mask a concurrent
        # real delete from another thread.
        self.preserve = threading.local()
        # Best-effort counters (stats surface; GIL discipline).
        self.served = 0
        self.killed = 0
        self.evicted = 0

    # -- ingest side -----------------------------------------------------

    def feed(self, skey: bytes, ts: np.ndarray, f: np.ndarray,
             i: np.ndarray, isf: np.ndarray, base: np.ndarray,
             row_starts: np.ndarray, existed) -> None:
        """Account one applied ``add_batch`` (post sort_dedup columns,
        per-row ``existed`` flags from ``put_many_columnar``)."""
        if not self.enabled:
            return
        skey = bytes(skey)
        nrows = len(row_starts)
        ends = np.concatenate((row_starts[1:], [len(ts)]))
        hb = base[row_starts]
        coarse = self.coarse
        with self.lock:
            r0 = 0
            while r0 < nrows:
                h0 = int(hb[r0])
                cb = h0 - h0 % coarse
                r1 = r0
                while (r1 + 1 < nrows
                       and int(hb[r1 + 1]) - int(hb[r1 + 1]) % coarse
                       == cb):
                    r1 += 1
                self._feed_cb(skey, cb, ts, f, i, isf, hb, row_starts,
                              ends, existed, r0, r1)
                r0 = r1 + 1
            if self.total > self.cap:
                self._evict()

    def _feed_cb(self, skey: bytes, cb: int, ts, f, i, isf, hb,
                 row_starts, ends, existed, r0: int, r1: int) -> None:
        key = (skey, cb)
        if key in self.dead:
            return
        b = self.bufs.get(key)
        fed = b.fed if b is not None else ()
        for r in range(r0, r1 + 1):
            # existed=True on an hour we never fed means the row holds
            # cells that bypassed this buffer — window incomplete.
            if existed[r] and int(hb[r]) not in fed:
                self._kill(key)
                return
        lo, hi = int(row_starts[r0]), int(ends[r1])
        tchunk = ts[lo:hi]
        if b is not None and b.n:
            # A timestamp collision across batches means the raw cell
            # was overwritten (same qualifier, last-writer-wins) or a
            # type/value conflict the full fold would fsck-error on —
            # either way the buffer's view diverges from storage.
            # sort_dedup already settled within-batch duplicates.
            if int(tchunk[0]) <= b.gmax and int(tchunk[-1]) >= b.gmin:
                if np.isin(tchunk, b.merged_ts()).any():
                    self._kill(key)
                    return
        # Values exactly as the raw rescan decodes them: floats are
        # stored 4-byte (encode_cells_multi) and widened f32→f64 by
        # decode_cells_flat; ints widen i64→f64.
        s = slice(lo, hi)
        vchunk = np.where(isf[s],
                          f[s].astype(np.float32).astype(np.float64),
                          i[s].astype(np.float64))
        if b is None:
            b = self.bufs[key] = _Buf()
        b.append(np.ascontiguousarray(tchunk), vchunk)
        for r in range(r0, r1 + 1):
            b.fed.add(int(hb[r]))
        self.total += hi - lo

    # -- invalidation hooks ----------------------------------------------

    def invalidate(self, skey: bytes, hour_base: int) -> None:
        """A write or delete bypassed the feed path (scalar add_point,
        fsck/CLI row deletes): its coarse window can no longer be
        served from the buffer."""
        if not self.enabled:
            return
        cb = int(hour_base) - int(hour_base) % self.coarse
        with self.lock:
            self._kill((bytes(skey), cb))

    def invalidate_key(self, row_key: bytes) -> None:
        """Row-key flavored ``invalidate`` for raw-table delete sites
        (the store delete hook). No-op inside a preserve window — a
        point-set-preserving rewrite (compact_row) is not a delete."""
        if not self.enabled or getattr(self.preserve, "on", False):
            return
        if len(row_key) < UID_WIDTH + TIMESTAMP_BYTES:
            return
        self.invalidate(codec.series_key(row_key),
                        codec.key_base_time(row_key))

    def kill_batch(self, skey: bytes, hour_bases: np.ndarray) -> None:
        """A batch partially applied (throttle): which rows landed is
        unknowable here, so every window it touched dies."""
        if not self.enabled:
            return
        skey = bytes(skey)
        coarse = self.coarse
        with self.lock:
            for cb in {int(h) - int(h) % coarse for h in hour_bases}:
                self._kill((skey, cb))

    def _kill(self, key: tuple[bytes, int]) -> None:
        b = self.bufs.pop(key, None)
        if b is not None:
            self.total -= b.n
            self.killed += 1
        self.dead.add(key)
        if len(self.dead) > _DEAD_CAP:
            # Sound to forget: tombstones are an optimization (module
            # docstring); serve-time checks reject stale re-buffers.
            self.dead.clear()

    def _evict(self) -> None:
        """Oldest coarse windows first, down to 3/4 of the cap — old
        windows are the least likely to see more appends, and their
        next fold (if any) just takes the full path."""
        target = self.cap - self.cap // 4
        for key in sorted(self.bufs, key=lambda k: k[1]):
            if self.total <= target:
                break
            b = self.bufs.pop(key)
            self.total -= b.n
            self.evicted += 1
            self.dead.add(key)
        if len(self.dead) > _DEAD_CAP:
            self.dead.clear()

    # -- fold side -------------------------------------------------------

    def serve(self, tier, cb: int, keys: list[bytes], buf, seen: set,
              ) -> bool:
        """Try to fold one (metric, coarse window) group of spilled row
        ``keys`` from buffers. On True the group's records were emitted
        into ``buf`` (every resolution, sketches included) and its keys
        added to ``seen``; on False nothing was emitted and the caller
        owns the full rescan. Runs under the tier's fold lock."""
        if not self.enabled:
            return False
        with self.lock:
            groups: dict[bytes, list[bytes]] = {}
            for k in keys:
                groups.setdefault(bytes(codec.series_key(k)),
                                  []).append(bytes(k))
            plan = []
            for skey, ks in groups.items():
                b = self.bufs.get((skey, cb))
                if b is None or b.n == 0:
                    return False
                # Whole-memtable spills: unfolded raw data of this
                # window not in the buffer would have spilled its row
                # key right here — an unfed spilled hour proves the
                # buffer incomplete.
                if not {codec.key_base_time(k) for k in ks} <= b.fed:
                    return False
                plan.append((skey, ks, b))
            # All-or-nothing per (metric, window): the fallback rescan
            # is per metric+window and re-emits every series in it, so
            # mixing paths inside one group would double work, not
            # break anything — rejecting whole groups keeps it simple.
            for skey, ks, b in plan:
                if not b.folded and self._has_prior_records(tier, skey,
                                                            cb):
                    self._kill((skey, cb))
                    return False
            for skey, ks, b in plan:
                ts, vals = b.columns()
                if len(ts) > 1 and (ts[1:] == ts[:-1]).any():
                    # Can't happen (feed kills on collision); degrade
                    # to the rescan rather than risk divergence.
                    self._kill((skey, cb))
                    return False
            for skey, ks, b in plan:
                ts, vals = b.columns()
                tier._emit_series(skey, ts, vals, buf)
                b.folded = True
                seen.update(ks)
            self.served += len(plan)
            return True

    def _has_prior_records(self, tier, skey: bytes, cb: int) -> bool:
        """Does the coarse rollup row already record this window?
        (Folded by an earlier checkpoint, a catch-up rebuild, or a
        previous process — the buffer cannot prove it covers that
        data, so the window is not delta-eligible.)"""
        r = tier.resolutions[-1]
        span = r * tier.pack
        sb = cb - cb % span
        key = (skey[:UID_WIDTH] + int(sb).to_bytes(4, "big")
               + skey[UID_WIDTH:])
        idx = (cb - sb) // r
        store = tier.stores[r][tier._shard_of(key)]
        for c in store.get(tier.table, key, ROLLUP_FAMILY):
            if (c.qualifier != QUAL_MOMENTS
                    or len(c.value) % summary.ENTRY_SIZE):
                continue
            if (summary.decode_moment_map(c.value)["idx"] == idx).any():
                return True
        return False

    def stats(self) -> dict:
        return {
            "enabled": self.enabled,
            "windows": len(self.bufs),
            "points": self.total,
            "served": self.served,
            "killed": self.killed,
            "evicted": self.evicted,
        }
