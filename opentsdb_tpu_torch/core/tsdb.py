"""TSDB — the thread-safe facade over storage, UIDs, and compaction.

Mirrors ``opentsdb_tpu/core/tsdb.py`` of the JAX package: the write path
(``add_point``, the columnar ``add_batch`` that stores one pre-compacted
cell per row-hour), row-key construction, row compaction and the
columnar read path (``scan_series``) — byte for byte the same rows, so
either package reads what the other wrote — and the resident device
window (``storage/devstore.py``): on by default on the device backend,
mirrored from every write and warmed from what storage already holds.

Live sketches (``stats/livesketch.py``, on by default as in the JAX
package): every write registers its series in the sketch directory before
the store put, and a fully applied write folds its values into the
series' t-digest and its tag values into the (metric, tag key) HLLs.

``checkpoint()`` saves the sketch snapshot ``<wal>.sketches`` and then
spills the store to its sstable tier (``storage/kv.py``), so the snapshot
covers the spilled tier; ``shutdown()`` takes a checkpoint whenever the
store has a WAL, as the JAX package does under its default config. At
start-up the sketches load the snapshot and re-fold the WAL-replayed
memtable on top of it (or, without one, re-fold all of storage), and the
window is warmed from every tier.

Left out of this slice (all off here; see ROADMAP): the mesh-sharded
window, rollups, tenant accounting, replicas and the cluster tier. The
tenant snapshot in a JAX store directory is left, at each checkpoint, in a
state the JAX package rebuilds exactly from (``MemKVStore.checkpoint``).
"""

from __future__ import annotations

import os
import threading
import time

import numpy as np

from opentsdb_tpu_torch.core import codec, codec_np, tags as tags_mod
from opentsdb_tpu_torch.core.compaction import CompactionQueue
from opentsdb_tpu_torch.core.const import (MAX_TIMESPAN, TIMESTAMP_BYTES,
                                           UID_WIDTH)
from opentsdb_tpu_torch.core.errors import (IllegalDataError,
                                             PleaseThrottleError)
from opentsdb_tpu_torch.stats.livesketch import LiveSketches
from opentsdb_tpu_torch.storage.devstore import DeviceWindow
from opentsdb_tpu_torch.storage.kv import KVStore
from opentsdb_tpu_torch.uid.uniqueid import UniqueId
from opentsdb_tpu_torch.utils.config import Config, resolve_device

FAMILY = b"t"


class TSDB:
    def __init__(self, store: KVStore, config: Config | None = None,
                 start_compaction_thread: bool = True) -> None:
        self.config = config or Config()
        # Fail at construction, not at the first query: a daemon asked to
        # run on a card that is not there must not come up at all.
        self.device = resolve_device(self.config.device)
        self.store = store
        store.ensure_table(self.config.table)
        store.ensure_table(self.config.uidtable)
        self.table = self.config.table
        uidtable = self.config.uidtable
        self.metrics = UniqueId(store, uidtable, "metrics", 3)
        self.tagk = UniqueId(store, uidtable, "tagk", 3)
        self.tagv = UniqueId(store, uidtable, "tagv", 3)
        # One checkpoint at a time (the compaction thread's timer and an
        # explicit call may race).
        self._checkpoint_lock = threading.Lock()
        self.sketch_save_seconds = 0.0
        self.compactionq = CompactionQueue(
            self, start_thread=start_compaction_thread)
        # Streaming sketch state (stats/livesketch.py): loaded from the
        # checkpoint snapshot when one exists (then re-folding only the
        # WAL-replayed memtable), else rebuilt from a full storage scan.
        self.sketches = None
        self.sketch_load_seconds = 0.0
        if self.config.enable_sketches:
            self._init_sketches()
        # Device-resident columnar hot window (storage/devstore.py):
        # ingest mirrors into device memory so queries skip the scan and
        # the host->device copy. The oracle backend has nothing to serve
        # from it.
        self.devwindow = None
        self.warm_seconds = 0.0
        if self.config.device_window and self.config.backend != "cpu":
            self.devwindow = DeviceWindow(
                staging_points=self.config.device_window_staging,
                max_points=self.config.device_window_points,
                device=self.device)
            self._warm_devwindow()

    def _warm_devwindow(self) -> None:
        """Mirror what storage already holds (the sstable generations and
        the replayed WAL, the port's or the JAX package's) into the device
        window, one append per series, so it covers history from before
        this process started. ``warm_seconds`` keeps the time it took.

        Corrupt storage (conflicting duplicates — IllegalDataError, the
        fsck signal) disables the window outright: a partially warmed
        window would claim coverage it doesn't have."""
        t0 = time.perf_counter()
        try:
            _, per_series = self.scan_series(b"", b"\xff" * 64)
        except IllegalDataError:
            self.devwindow = None
            return
        for skey, cols in per_series.items():
            self.devwindow.append(skey[:UID_WIDTH], skey, cols.timestamps,
                                  cols.values)
        self.warm_seconds = time.perf_counter() - t0

    # ------------------------------------------------------------------
    # Streaming sketches
    # ------------------------------------------------------------------

    def _sketch_path(self) -> str | None:
        wal = getattr(self.store, "_wal_path", None)
        return wal + ".sketches" if wal else None

    def _init_sketches(self) -> None:
        """Load the snapshot and re-fold the live memtable on top of it
        (rows read without the spilled tiers, so nothing the snapshot
        covers folds twice), or, without a snapshot, build the sketches
        from all of storage. ``sketch_load_seconds`` keeps the load's
        time."""
        path = self._sketch_path()
        cfg = self.config
        if path and os.path.exists(path):
            t0 = time.perf_counter()
            self.sketches = LiveSketches.load(
                path, flush_points=cfg.sketch_flush_points,
                device=self.device)
            self.sketch_load_seconds = time.perf_counter() - t0
            self._refold(
                (k, self.read_row(k, self.store.memtable_cells(
                    self.table, k, FAMILY)))
                for k in self.store.memtable_keys(self.table))
            return
        self.sketches = LiveSketches(
            compression=cfg.sketch_compression, hll_p=cfg.sketch_hll_p,
            flush_points=cfg.sketch_flush_points, device=self.device)
        self._refold(self._scan_rows())

    def _scan_rows(self):
        """Every stored row, in row-key order, as (row key, columns): the
        JAX package's full re-fold reads storage this way, one row-hour
        at a time, and the fold's buffering follows that order."""
        _, per_series = self.scan_series(b"", b"\xff" * 64)
        rows = []
        for skey, cols in per_series.items():
            base = cols.timestamps - cols.timestamps % MAX_TIMESPAN
            cuts = np.flatnonzero(np.diff(base)) + 1
            starts = np.concatenate(([0], cuts))
            ends = np.concatenate((cuts, [len(base)]))
            for a, b in zip(starts.tolist(), ends.tolist()):
                key = codec.row_key(skey[:UID_WIDTH], int(base[a]), ())
                rows.append((key + skey[UID_WIDTH:], skey, a, b))
        rows.sort()
        for key, skey, a, b in rows:
            cols = per_series[skey]
            yield key, codec.Columns(cols.timestamps[a:b],
                                     cols.values[a:b],
                                     cols.int_values[a:b],
                                     cols.is_float[a:b])

    def _refold(self, rows) -> None:
        for key, cols in rows:
            if len(cols.timestamps) == 0:
                continue
            pr = codec.parse_row_key(key)
            self.sketches.observe(
                codec.series_key(key), cols.values,
                [(pr.metric_uid, k, v) for k, v in pr.tag_uids])
        self.sketches.flush()

    def _observe(self, series_key: bytes, metric_uid: bytes,
                 pairs: list[tuple[bytes, bytes]],
                 values: np.ndarray) -> None:
        if self.sketches is None:
            return
        self.sketches.observe(
            series_key, values, [(metric_uid, k, v) for k, v in pairs])

    # ------------------------------------------------------------------
    # Row-key construction
    # ------------------------------------------------------------------

    def resolve_tags(self, tag_map: dict[str, str],
                     create: bool = True) -> list[tuple[bytes, bytes]]:
        """Resolve tag names/values to UID pairs, sorted by tagk id: row
        keys for one logical series are byte-identical regardless of
        input order (reference Tags.java:308-348)."""
        get_k = self.tagk.get_or_create_id if create else self.tagk.get_id
        get_v = self.tagv.get_or_create_id if create else self.tagv.get_id
        pairs = [(get_k(k), get_v(v)) for k, v in tag_map.items()]
        pairs.sort()
        return pairs

    def _row_parts(self, metric: str, tag_map: dict[str, str],
                   create_metric: bool | None = None,
                   create_tags: bool = True,
                   ) -> tuple[bytes, list[tuple[bytes, bytes]]]:
        """(metric_uid, sorted tag UID pairs) for a series."""
        tags_mod.check_metric_and_tags(metric, tag_map)
        if create_metric is None:
            create_metric = self.config.auto_create_metrics
        metric_uid = (self.metrics.get_or_create_id(metric) if create_metric
                      else self.metrics.get_id(metric))
        return metric_uid, self.resolve_tags(tag_map, create_tags)

    def row_key_for(self, metric: str, tag_map: dict[str, str],
                    base_ts: int, create_metric: bool | None = None,
                    create_tags: bool = True) -> bytes:
        metric_uid, pairs = self._row_parts(metric, tag_map,
                                            create_metric, create_tags)
        return codec.row_key(metric_uid, base_ts, pairs)

    # ------------------------------------------------------------------
    # Write path
    # ------------------------------------------------------------------

    def add_point(self, metric: str, timestamp: int, value: int | float,
                  tag_map: dict[str, str], durable: bool = True) -> None:
        """Store one data point (reference TSDB.addPoint :236-352)."""
        if timestamp & ~0xFFFFFFFF:
            raise ValueError(
                f"{'negative' if timestamp < 0 else 'bad'} "
                f"timestamp={timestamp} when trying to add value={value} "
                f"to metric={metric}, tags={tag_map}")
        if isinstance(value, bool):
            raise ValueError("boolean value")
        if isinstance(value, float):
            buf, flags = codec.encode_float(value)
        else:
            buf, flags = codec.encode_long(value)
        base_ts = codec.base_time(timestamp)
        metric_uid, pairs = self._row_parts(metric, tag_map)
        row = codec.row_key(metric_uid, base_ts, pairs)
        qual = codec.encode_qualifier(timestamp - base_ts, flags)
        skey = codec.series_key(row)
        # The sketch directory learns the series before storage holds it.
        if self.sketches is not None:
            self.sketches.note_series(skey)
        self.store.put(self.table, row, FAMILY, qual, buf, durable=durable)
        if self.config.enable_compactions:
            self.compactionq.add(row)
        self._observe(skey, metric_uid, pairs,
                      np.asarray([value], np.float64))
        if self.devwindow is not None:
            self.devwindow.append(metric_uid, skey,
                                  np.asarray([timestamp], np.int64),
                                  np.asarray([value], np.float32))

    def add_batch(self, metric: str, timestamps: np.ndarray,
                  values: np.ndarray, tag_map: dict[str, str],
                  durable: bool = True,
                  is_float: np.ndarray | None = None,
                  int_values: np.ndarray | None = None) -> int:
        """Columnar ingest for one series: one pre-compacted cell per
        row-hour.

        ``values`` may be an integer or floating dtype; float points are
        stored as 4-byte floats (matching telnet ingest), int points on
        their smallest widths. ``is_float`` types points individually
        within a float-dtyped ``values`` array, with ``int_values`` (int64)
        alongside to keep integers above 2^53 exact. Returns the points
        written."""
        timestamps = np.asarray(timestamps, dtype=np.int64)
        if timestamps.size == 0:
            return 0
        if (timestamps & ~np.int64(0xFFFFFFFF)).any():
            raise ValueError("timestamp out of range in batch")
        if is_float is not None:
            fmask = np.asarray(is_float, dtype=bool)
            fvals = np.asarray(values, dtype=np.float64)
            if int_values is not None:
                ivals = np.asarray(int_values, dtype=np.int64)
            else:
                ivals = np.where(fmask, 0, fvals).astype(np.int64)
        elif np.issubdtype(np.asarray(values).dtype, np.floating):
            fvals = np.asarray(values, dtype=np.float64)
            ivals = np.zeros_like(timestamps)
            fmask = np.ones(timestamps.shape, dtype=bool)
        else:
            ivals = np.asarray(values, dtype=np.int64)
            fvals = ivals.astype(np.float64)
            fmask = np.zeros(timestamps.shape, dtype=bool)

        # One vectorized pass for the whole series: global sort + dedup,
        # then every row-hour's cell encoded in one flat-buffer pass.
        ts_s, f_s, i_s, m_s = codec_np.sort_dedup(
            timestamps, fvals, ivals, fmask)
        base = ts_s - ts_s % MAX_TIMESPAN
        deltas = ts_s - base
        row_starts = np.concatenate(
            ([0], np.flatnonzero(np.diff(base)) + 1))
        quals, vals = codec_np.encode_cells_multi(deltas, f_s, i_s, m_s,
                                                  row_starts)
        metric_uid, pairs = self._row_parts(metric, tag_map)
        tmpl = bytes(codec.row_key(metric_uid, 0, pairs))
        # All row keys in one pass: broadcast the template, stamp the
        # base-time bytes, keep the contiguous blob for the columnar put.
        L = len(tmpl)
        keys = np.tile(np.frombuffer(tmpl, np.uint8), (len(quals), 1))
        keys[:, UID_WIDTH:UID_WIDTH + TIMESTAMP_BYTES] = (
            base[row_starts].astype(">u4").view(np.uint8).reshape(-1, 4))
        kb = keys.tobytes()
        skey = codec.series_key(kb[:L])
        # The sketch directory learns the series before any row of it is
        # visible in storage (over-registering a batch that then fails is
        # harmless).
        if self.sketches is not None:
            self.sketches.note_series(skey)
        try:
            existed = self.store.put_many_columnar(
                self.table, FAMILY, kb, L, quals, vals, durable=durable)
        except PleaseThrottleError as e:
            # The rows that did apply still need compaction; they will
            # never reach the window (this raise skips its append), and a
            # retry of the batch would fail its order check anyway: drop
            # the metric's window so queries take the scan path instead of
            # a partial view.
            self._queue_compactions(kb, L, e.partial_existed)
            if self.devwindow is not None:
                self.devwindow.invalidate(metric_uid)
            raise
        self._queue_compactions(kb, L, existed)
        # The sketch fold covers fully applied batches only (a throttled
        # batch raised above); one float32 conversion serves the sketches
        # and the window.
        if self.sketches is not None or self.devwindow is not None:
            f32 = f_s.astype(np.float32)
            self._observe(skey, metric_uid, pairs, f32)
            if self.devwindow is not None:
                self.devwindow.append(metric_uid, skey, ts_s, f32)
        return len(ts_s)

    def _queue_compactions(self, kb: bytes, L: int,
                           existed: list[bool]) -> None:
        """Rows that already held cells now hold several: queue them so
        the per-batch compacted cells merge into one."""
        if self.config.enable_compactions and any(existed):
            for i, e in enumerate(existed):
                if e:
                    self.compactionq.add(kb[i * L:(i + 1) * L])

    # ------------------------------------------------------------------
    # Compaction
    # ------------------------------------------------------------------

    def compact_row(self, key: bytes) -> None:
        """Merge all cells of a row into one compacted cell in storage.

        Parity: reference CompactionQueue.compact (:243-437) — single-cell
        rows are left alone (modulo the legacy float fix), the merged cell
        is written before the originals are deleted, and an original cell
        that already equals the merged form is never deleted-after-write.
        """
        cells = self.store.get(self.table, key, FAMILY)
        if len(cells) <= 1:
            if cells:
                qual, val = cells[0].qualifier, cells[0].value
                if len(qual) == 2 and codec.needs_float_fix(qual[1], val):
                    fixed_val = codec.fix_float_value(qual[1], val)
                    fixed_qual = bytes([
                        qual[0],
                        codec.fix_qualifier_flags(qual[1], len(fixed_val))])
                    self.store.put(self.table, key, FAMILY, fixed_qual,
                                   fixed_val)
                    if fixed_qual != qual:
                        self.store.delete(self.table, key, FAMILY, [qual])
            return
        qual, val = codec.compact_cells(
            [(c.qualifier, c.value) for c in cells])
        existing = {c.qualifier: c.value for c in cells}
        if existing.get(qual) != val:
            self.store.put(self.table, key, FAMILY, qual, val)
            self.compactionq.written_cells += 1
        to_delete = [c.qualifier for c in cells if c.qualifier != qual]
        if to_delete:
            self.store.delete(self.table, key, FAMILY, to_delete)
            self.compactionq.deleted_cells += len(to_delete)

    # ------------------------------------------------------------------
    # Read path
    # ------------------------------------------------------------------

    def read_row(self, key: bytes, cells: list) -> codec.Columns:
        """Decode one row's cells (possibly several) into sorted columnar
        arrays (the JAX package's ``TSDB.read_row``)."""
        base_ts = codec.key_base_time(key)
        kept = [c for c in cells
                if len(c.qualifier) % 2 == 0 and c.qualifier]
        if not kept:
            return codec.Columns(np.zeros(0, np.int64),
                                 np.zeros(0, np.float64),
                                 np.zeros(0, np.int64), np.zeros(0, bool))
        ts, f, i, isf, _ = codec_np.decode_cells_flat(
            [c.qualifier for c in kept], [c.value for c in kept],
            np.full(len(kept), base_ts, np.int64))
        if len(kept) == 1:
            return codec.Columns(ts, f, i, isf)
        d, f, i, isf = codec_np.sort_dedup(ts, f, i, isf)
        return codec.Columns(d, f, i, isf)

    def scan_series(self, start_key: bytes, stop_key: bytes,
                    key_regexp: bytes | None = None,
                    batch_cells: int = 1 << 18, series_hint=None):
        """Whole-range columnar scan regrouped BY SERIES: returns
        (series_keys, per_series Columns dict) with one global (series,
        timestamp) lexsort and one vectorized dedup pass. Duplicate
        (series, ts) points collapse when value-equal and raise
        IllegalDataError otherwise (reference complexCompact :600-679).
        ``series_hint`` goes to the store's scan (``scan_raw``), which may
        skip the generations it rules out."""
        quals: list[bytes] = []
        vals: list[bytes] = []
        bases: list[int] = []
        cell_sid: list[int] = []
        skey_index: dict[bytes, int] = {}
        skeys: list[bytes] = []
        parts: list[tuple] = []     # decoded (ts, f, i, isf, sid) batches

        def decode_batch():
            ts, f, i, isf, cop = codec_np.decode_cells_flat(
                quals, vals, np.asarray(bases, np.int64))
            sid = np.asarray(cell_sid, np.int64)[cop]
            parts.append((ts, f, i, isf, sid))
            quals.clear(), vals.clear(), bases.clear(), cell_sid.clear()

        for key, items in self.store.scan_raw(
                self.table, start_key, stop_key,
                family=FAMILY, key_regexp=key_regexp,
                series_hint=series_hint):
            base = codec.key_base_time(key)
            skey = codec.series_key(key)
            si = skey_index.get(skey)
            if si is None:
                si = skey_index[skey] = len(skeys)
                skeys.append(skey)
            for q, v in items:
                if len(q) % 2 != 0 or not q:
                    continue  # foreign/annotation cells
                quals.append(q)
                vals.append(v)
                bases.append(base)
                cell_sid.append(si)
            if len(quals) >= batch_cells:
                decode_batch()
        if quals:
            decode_batch()
        if not parts:
            return skeys, {}
        ts = np.concatenate([p[0] for p in parts])
        f = np.concatenate([p[1] for p in parts])
        i = np.concatenate([p[2] for p in parts])
        isf = np.concatenate([p[3] for p in parts])
        sid = np.concatenate([p[4] for p in parts])
        order = np.lexsort((ts, sid))
        ts, f, i, isf, sid = (ts[order], f[order], i[order], isf[order],
                              sid[order])
        if len(ts) > 1:
            dup = (sid[1:] == sid[:-1]) & (ts[1:] == ts[:-1])
            if dup.any():
                same = ((isf[1:] == isf[:-1])
                        & np.where(isf[1:], f[1:] == f[:-1],
                                   i[1:] == i[:-1]))
                if (dup & ~same).any():
                    bad = int(ts[1:][dup & ~same][0])
                    raise IllegalDataError(
                        f"Found out of order or duplicate data: "
                        f"ts={bad} -- run an fsck.")
                keep = np.concatenate(([True], ~dup))
                ts, f, i, isf, sid = (ts[keep], f[keep], i[keep],
                                      isf[keep], sid[keep])
        bounds = np.searchsorted(sid, np.arange(len(skeys) + 1))
        per_series = {
            skeys[s]: codec.Columns(ts[a:b], f[a:b], i[a:b], isf[a:b])
            for s, (a, b) in enumerate(zip(bounds[:-1], bounds[1:]))
            if b > a}
        return skeys, per_series

    # ------------------------------------------------------------------
    # Lifecycle
    # ------------------------------------------------------------------

    def flush(self) -> None:
        """Flush compactions then the storage engine (reference :384-417)."""
        self.compactionq.flush(cutoff=int(time.time()) - MAX_TIMESPAN - 1)
        self.store.flush()

    def checkpoint(self) -> int:
        """Save the sketch snapshot, then spill the store's memtable to its
        sstable tier and truncate the WAL (``MemKVStore.checkpoint``).
        Returns rows spilled, 0 when the store keeps no WAL.

        The snapshot commits before the spill, as in the JAX package: a
        crash in between leaves a snapshot that already covers the
        still-replayable memtable, whose re-fold then counts it twice
        (exact for HLLs, within sketch tolerance for digests), instead of
        a snapshot missing folds the truncated WAL can no longer replay.
        ``sketch_save_seconds`` keeps the last save's time.

        Without sketches a snapshot left by an earlier run would miss the
        rows spilled now, and the JAX package's next open would load it
        and re-fold only the memtable, under-counting. So it is removed,
        and that open re-folds all of storage (ROADMAP queue C, reference
        note 5)."""
        ckpt = getattr(self.store, "checkpoint", None)
        if ckpt is None:
            return 0
        with self._checkpoint_lock:
            path = self._sketch_path()
            if path and self.sketches is not None:
                t0 = time.perf_counter()
                self.sketches.save(path)
                self.sketch_save_seconds = time.perf_counter() - t0
            elif path and os.path.exists(path):
                os.unlink(path)
            return ckpt()

    def shutdown(self) -> None:
        """Idempotent: stop and drain the compaction queue, checkpoint
        when the store has a WAL (the JAX package checkpoints at every
        clean shutdown under its default config), flush the WAL, close the
        store (which releases the WAL's single-writer lock even when the
        checkpoint or the flush raises)."""
        if getattr(self, "_shutdown_done", False):
            return
        self._shutdown_done = True
        try:
            self.compactionq.shutdown()
            if getattr(self.store, "_wal_path", None):
                self.checkpoint()
            self.store.flush()
        finally:
            close = getattr(self.store, "close", None)
            if close:
                close()
