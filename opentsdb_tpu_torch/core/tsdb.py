"""TSDB — the thread-safe facade over storage, UIDs, and compaction.

Mirrors ``opentsdb_tpu/core/tsdb.py`` of the JAX package: the write path
(``add_point``, the columnar ``add_batch`` that stores one pre-compacted
cell per row-hour), row-key construction, row compaction and the
columnar read path (``scan_series``) — byte for byte the same rows, so
either package reads what the other wrote.

Left out of this slice (all off here; see ROADMAP): the resident device
window, live sketches, rollups, tenant accounting, checkpoints and the
cluster tier.
"""

from __future__ import annotations

import time

import numpy as np

from opentsdb_tpu_torch.core import codec, codec_np, tags as tags_mod
from opentsdb_tpu_torch.core.compaction import CompactionQueue
from opentsdb_tpu_torch.core.const import (MAX_TIMESPAN, TIMESTAMP_BYTES,
                                           UID_WIDTH)
from opentsdb_tpu_torch.core.errors import IllegalDataError
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
        self.compactionq = CompactionQueue(
            self, start_thread=start_compaction_thread)

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
        self.store.put(self.table, row, FAMILY, qual, buf, durable=durable)
        if self.config.enable_compactions:
            self.compactionq.add(row)

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
        existed = self.store.put_many_columnar(
            self.table, FAMILY, kb, L, quals, vals, durable=durable)
        # Rows that already held cells now hold several: queue them so the
        # per-batch compacted cells merge into one.
        if self.config.enable_compactions and any(existed):
            for i, e in enumerate(existed):
                if e:
                    self.compactionq.add(kb[i * L:(i + 1) * L])
        return len(ts_s)

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

    def scan_series(self, start_key: bytes, stop_key: bytes,
                    key_regexp: bytes | None = None,
                    batch_cells: int = 1 << 18):
        """Whole-range columnar scan regrouped BY SERIES: returns
        (series_keys, per_series Columns dict) with one global (series,
        timestamp) lexsort and one vectorized dedup pass. Duplicate
        (series, ts) points collapse when value-equal and raise
        IllegalDataError otherwise (reference complexCompact :600-679)."""
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
                family=FAMILY, key_regexp=key_regexp):
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

    def shutdown(self) -> None:
        """Idempotent: stop and drain the compaction queue, flush the WAL,
        close the store (which releases the WAL's single-writer lock even
        when the flush raises)."""
        if getattr(self, "_shutdown_done", False):
            return
        self._shutdown_done = True
        try:
            self.compactionq.shutdown()
            self.store.flush()
        finally:
            close = getattr(self.store, "close", None)
            if close:
                close()
