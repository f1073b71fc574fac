"""Query executor: scan -> span assembly -> group-by -> batched compute.

Mirrors the scan path of ``opentsdb_tpu/query/executor.py``. Parity
target: reference src/core/TsdbQuery.java + SpanGroup. The planner
reproduces the reference's query surface — exact-tag filtering pushed down
as a row-key regexp (:433-492), group-by materialization per distinct
combination of group-by tag values (:294-363), intersection/aggregated-tags
computation (SpanGroup.computeTags :149-173) — and executes each group (or
every group of a wide group-by at once) as one batched call of the
downsample core (``ops/kernels.py``) on the configured torch device.

Pipeline order matches the reference: per-span downsample first, then rate,
then cross-span aggregation, with linear interpolation for plain
aggregation and last-value-hold for rates. Downsampled queries emit
epoch-aligned bucket-start timestamps (as OpenTSDB 2.x and the JAX
package do).

Backends: 'device' runs ops/kernels.py on the torch device (padded
shapes); 'cpu' runs the float64 numpy oracle. Both agree bit-for-bit on
grids and to float32 tolerance on values.

Plans, as in the JAX package: a downsampled query with a moment or
percentile group aggregator is served first from the resident device
window (``storage/devstore.py``) when it exactly covers the range — plan
label "resident": no storage scan, no upload of points, only the [S]-sized
include/group maps (cached) and the filter-independent [S, B] stage
(cached per data version) — and otherwise from the storage scan, plan
"raw". Queries without a downsampler always take the scan: their spans
are aggregated on the union of their timestamps (``group_interpolate``,
or the union-grid quantile), with rates taken per point first. Percentile
downsamplers (``1h-p95``) run on the float64 oracle, as in the JAX
package. There is no rollup tier here.

The scan reads through the fragment cache (``_scan_selector``, on by
default as in the JAX package): the range splits into row-span-aligned
chunks, and each chunk with no memtable rows and no row create/remove
since its fragment was decoded serves from a per-store LRU of decoded
columns (``MemKVStore.chunk_state``); chunks with memtable rows are
scanned afresh every time. A warm answer is bit-identical to a cold scan.
The scan passes the storage a candidate-series hint from the sketch
directory, so generations whose series bloom holds none of the selector's
series are skipped.

Sketch queries (``/sketch`` and ``/distinct``) read the live sketches
(``stats/livesketch.py``) without a storage scan: quantiles of the merged
t-digests of the matching series, and the HyperLogLog estimate of a
(metric, tag key)'s distinct values. With a time range, with no rollup
tier to serve it, they take the JAX package's exact fallbacks: the pooled
float32 values' quantiles, an exact count of tag values, or, with a tag
filter, the tag values' HyperLogLog at p = 14 (``distinct_tagv``).
"""

from __future__ import annotations

import re
import threading
import weakref
from typing import NamedTuple

import numpy as np
import torch

from opentsdb_tpu_torch.core import codec
from opentsdb_tpu_torch.core.const import (MAX_TIMESPAN, TIMESTAMP_BYTES,
                                           UID_WIDTH)
from opentsdb_tpu_torch.core.errors import BadRequestError, NoSuchUniqueName
from opentsdb_tpu_torch.ops import kernels, oracle, sketches
from opentsdb_tpu_torch.query.aggregators import Aggregators
from opentsdb_tpu_torch.storage.sstable import series_hash
from opentsdb_tpu_torch.utils.lru import LRUCache

# One fragment cache PER STORE, shared by every QueryExecutor over it, so
# a second executor over the same store starts warm. Keyed by store
# identity through a weak map: a closed store's cache dies with it, and
# id() reuse cannot alias two stores. Fragment keys carry the table name,
# so two TSDBs sharing one store under different tables cannot cross-serve.
_FRAG_CACHES: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()
_FRAG_CACHES_LOCK = threading.Lock()


def _shared_frag_cache(store, max_entries: int,
                       max_points: int) -> LRUCache:
    with _FRAG_CACHES_LOCK:
        cache = _FRAG_CACHES.get(store)
        if cache is None:
            cache = LRUCache(max_entries, max_cost=max_points)
            _FRAG_CACHES[store] = cache
        elif (cache.max_entries != max_entries
              or cache.max_cost != max_points):
            # A later executor with other bounds rebounds the shared
            # instance in place (the newest config wins): earlier
            # executors hold direct references, and replacing the entry
            # would strand them on an orphaned cache.
            cache.resize(max_entries, max_cost=max_points)
        return cache


class QuerySpec(NamedTuple):
    metric: str
    tags: dict[str, str]            # value '*' or 'v1|v2' => group by
    aggregator: str = "sum"
    rate: bool = False
    downsample: tuple[int, str] | None = None
    counter: bool = False           # rate rollover correction
    counter_max: float = float(2**64)
    reset_value: float | None = None


class QueryResult(NamedTuple):
    metric: str
    tags: dict[str, str]
    aggregated_tags: list[str]
    timestamps: np.ndarray          # int64 epoch seconds
    values: np.ndarray              # float64


class _Span(NamedTuple):
    series_key: bytes
    tags: dict[str, str]
    timestamps: np.ndarray
    values: np.ndarray


def not_yet_ported(what: str) -> BadRequestError:
    return BadRequestError(f"not yet ported: {what}")


class QueryExecutor:
    def __init__(self, tsdb, backend: str | None = None) -> None:
        self.tsdb = tsdb
        self.backend = backend or tsdb.config.backend
        if self.backend not in ("device", "cpu"):
            raise ValueError(f"unknown backend {self.backend!r} "
                             f"(device or cpu)")
        self.device = tsdb.device
        # Resident-window caches: per (window instance, metric, filter)
        # the series plan and the device include/gmap maps, both
        # revalidated against the directory generation; per data version
        # and (range, interval, downsample) the stage grids.
        self._dw_mask_cache = LRUCache(128)
        self._dw_plan_cache = LRUCache(128)
        self._dw_stage_cache = LRUCache(4)
        cfg = tsdb.config
        # Fragment cache: decoded per-(selector, aligned time-chunk)
        # columns, bounded by cached POINTS; one per store, shared by
        # every executor over it.
        self._frag_cache = _shared_frag_cache(
            tsdb.store, cfg.qcache_fragments, cfg.qcache_points)
        # Candidate-series hint per (metric, filter), revalidated on the
        # metric's directory size; bounded in total cached hashes.
        self._ident_cache = LRUCache(256, max_cost=1 << 21)
        self.qcache_hits = 0
        self.qcache_misses = 0
        self.qcache_bypasses = 0

    # ------------------------------------------------------------------
    # Planning: scan + span assembly + grouping
    # ------------------------------------------------------------------

    def _build_regexp(self, exact: list[tuple[bytes, bytes]],
                      group_bys: list[tuple[bytes, list[bytes] | None]],
                      prefix: int = UID_WIDTH + TIMESTAMP_BYTES,
                      ) -> bytes | None:
        """Row-key regexp over raw UID bytes, merged in tagk-id order.

        Parity: reference TsdbQuery.createAndSetFilter (:433-492)."""
        if not exact and not group_bys:
            return None
        tagsize = 2 * UID_WIDTH
        items = []  # (tagk_uid, regex fragment)
        for k, v in exact:
            items.append((k, re.escape(k + v)))
        for k, values in group_bys:
            if values is None:
                frag = re.escape(k) + b".{%d}" % UID_WIDTH
            else:
                alts = b"|".join(re.escape(k + v) for v in sorted(values))
                frag = b"(?:" + alts + b")"
            items.append((k, frag))
        items.sort(key=lambda kv: kv[0])
        buf = b"(?s)^.{%d}" % prefix
        for _, frag in items:
            buf += b"(?:.{%d})*" % tagsize + frag
        buf += b"(?:.{%d})*$" % tagsize
        return buf

    def _tag_filters(self, tags: dict[str, str]):
        """Resolve a tag-filter map to UID-level (exact, group_bys)."""
        exact: list[tuple[bytes, bytes]] = []
        group_bys: list[tuple[bytes, list[bytes] | None]] = []
        for name, value in tags.items():
            k = self.tsdb.tagk.get_id(name)
            if value == "*":
                group_bys.append((k, None))
            elif "|" in value:
                vals = [self.tsdb.tagv.get_id(v) for v in value.split("|")]
                group_bys.append((k, vals))
            else:
                exact.append((k, self.tsdb.tagv.get_id(value)))
        return exact, group_bys

    def _find_spans(self, spec: QuerySpec, start: int, end: int,
                    info: dict | None = None):
        """Scan matching rows into per-series columnar spans, grouped by
        the distinct combinations of group-by tag values. ``info``, when
        given, receives {"cached": bool}: True iff every fragment of the
        range served from the warm cache."""
        metric_uid = self.tsdb.metrics.get_id(spec.metric)
        exact, group_bys = self._tag_filters(spec.tags)
        group_by_keys = sorted(k for k, _ in group_bys)
        regexp = self._build_regexp(exact, group_bys)
        per_series = self._scan_selector(metric_uid, exact, group_bys,
                                         regexp, start, end, info)
        groups: dict[tuple, list[_Span]] = {}
        for skey, cat in per_series.items():
            m = (cat.timestamps >= start) & (cat.timestamps <= end)
            if not m.any():
                continue
            tag_uids = codec.series_tag_uids(skey)
            named = {
                self.tsdb.tagk.get_name(k): self.tsdb.tagv.get_name(v)
                for k, v in tag_uids.items()}
            gkey = tuple(tag_uids.get(k, b"") for k in group_by_keys)
            groups.setdefault(gkey, []).append(_Span(
                skey, named, cat.timestamps[m], cat.values[m]))
        return groups

    # -- fragment cache (the query fast path) ----------------------------

    def _series_hint(self, metric_uid: bytes, exact, group_bys,
                     ) -> np.ndarray | None:
        """uint64 identity hashes of every known series matching the
        selector: a pruning hint for the per-generation series blooms.
        Read from the sketch slot directory, which the write path keeps a
        superset of the series with stored data (``TSDB.add_point`` and
        ``add_batch`` register with ``note_series`` before the put). None,
        which never prunes, without sketches or when nothing matches."""
        sk = self.tsdb.sketches
        if sk is None:
            return None
        fkey = (metric_uid, _filter_key(exact, group_bys))
        # Revalidate on THIS metric's directory size (it only grows): a
        # new series under another metric leaves the cached hint valid.
        count = sk.metric_series_count(metric_uid)
        ent = self._ident_cache.get(fkey)
        if ent is not None and ent[0] == count:
            return ent[1]
        regexp = self._build_regexp(exact, group_bys, prefix=UID_WIDTH)
        pattern = re.compile(regexp, re.S) if regexp else None
        hashes = [series_hash(k) for k in sk.metric_series_keys(metric_uid)
                  if pattern is None or pattern.match(k)]
        hint = np.asarray(hashes, np.uint64) if hashes else None
        self._ident_cache.put(fkey, (count, hint), cost=max(len(hashes), 1))
        return hint

    def _scan_chunk(self, metric_uid: bytes, regexp, hint,
                    c_lo: int, c_hi: int) -> dict:
        """Scan + decode the rows of base times [c_lo, c_hi) into a
        per-series Columns dict (a chunk's: the cacheable fragment
        unit)."""
        return self.tsdb.scan_series(
            metric_uid + _u32(c_lo), metric_uid + _u32(min(c_hi, 0xFFFFFFFF)),
            key_regexp=regexp, series_hint=hint)[1]

    def _scan_selector(self, metric_uid: bytes, exact, group_bys,
                       regexp, start: int, end: int,
                       info: dict | None = None) -> dict:
        """Per-series columns for a selector over [start, end] (the full
        covering row range: the caller masks to the exact bounds).

        The range splits into row-span-aligned chunks; a chunk serves
        from the fragment cache when (a) the store has no memtable
        ("dirty") rows in it now and (b) no base in it carries a row
        create/remove stamp newer than the fragment
        (``MemKVStore.chunk_state``: stamps outlive refcounts, so a
        create-then-delete that nets a chunk back to clean still
        invalidates fragments built in between). Dirty chunks bypass the
        cache both ways (scanned afresh, never stored), so a live tail is
        re-read every time while frozen history serves from RAM. Chunks
        align to the row span, so per-chunk decode + concatenation
        reproduces the whole-range decode order: answers are
        bit-identical to a cold scan."""
        tsdb = self.tsdb
        cfg = tsdb.config
        store = tsdb.store
        hint = self._series_hint(metric_uid, exact, group_bys)
        b_lo = codec.base_time(max(start, 0))
        b_hi = min(codec.base_time(min(end, 0xFFFFFFFF)), 0xFFFFFFFF)

        def full_scan() -> dict:
            return self._scan_chunk(metric_uid, regexp, hint, b_lo,
                                    b_hi + MAX_TIMESPAN)

        chunk_s = cfg.qcache_chunk_s - cfg.qcache_chunk_s % MAX_TIMESPAN
        if not cfg.qcache or chunk_s <= 0 or b_hi < b_lo:
            return full_scan()
        c0 = b_lo - b_lo % chunk_s
        nchunks = (b_hi - c0) // chunk_s + 1
        if nchunks > cfg.qcache_max_chunks:
            # All-time-style ranges: per-chunk scan setup would cost more
            # than it saves, and caching them would flush the dashboard
            # working set.
            return full_scan()
        table = tsdb.table
        fkey = (table, metric_uid, _filter_key(exact, group_bys))
        chunks = [c0 + i * chunk_s for i in range(nchunks)]
        # States read BEFORE each scan: content can only get newer between
        # the state read and the scan, so a racing mutation stamps its
        # bases past the fragment's tagged seq and the next lookup
        # invalidates, never the reverse.
        states = [store.chunk_state(table, c, c + chunk_s) for c in chunks]
        if all(st[3] for st in states):
            # Nothing cacheable (an all-memtable store, a fully hot
            # range): one unchunked scan beats per-chunk setup.
            self.qcache_bypasses += nchunks
            if info is not None:
                info["cached"] = False
            return full_scan()
        parts: dict[bytes, list] = {}
        all_hit = True
        for c, (seqs, floors, stamps, dirty) in zip(chunks, states):
            key = (fkey, c, chunk_s)
            if dirty:
                self.qcache_bypasses += 1
                all_hit = False
                frag = self._scan_chunk(metric_uid, regexp, hint, c,
                                        c + chunk_s)
            else:
                ent = self._frag_cache.get(key)
                if ent is not None and all(
                        e >= f and m <= e
                        for e, f, m in zip(ent[0], floors, stamps)):
                    self.qcache_hits += 1
                    frag = ent[1]
                else:
                    self.qcache_misses += 1
                    all_hit = False
                    frag = self._scan_chunk(metric_uid, regexp, hint, c,
                                            c + chunk_s)
                    cost = sum(len(cols.timestamps)
                               for cols in frag.values())
                    self._frag_cache.put(key, (seqs, frag),
                                         cost=max(cost, 1))
            for skey, cols in frag.items():
                parts.setdefault(skey, []).append(cols)
        if info is not None:
            info["cached"] = all_hit
        out: dict[bytes, codec.Columns] = {}
        for skey, lst in parts.items():
            if len(lst) == 1:
                out[skey] = lst[0]
            else:
                out[skey] = codec.Columns(
                    np.concatenate([c.timestamps for c in lst]),
                    np.concatenate([c.values for c in lst]),
                    np.concatenate([c.int_values for c in lst]),
                    np.concatenate([c.is_float for c in lst]))
        return out

    @staticmethod
    def _group_tags(spans: list[_Span]):
        """Intersection tags + aggregated (differing) tag names.

        Parity: reference SpanGroup.computeTags (:149-173)."""
        common = dict(spans[0].tags)
        keys = set(spans[0].tags)
        for sp in spans[1:]:
            keys &= set(sp.tags)
            for k in list(common):
                if sp.tags.get(k) != common[k]:
                    del common[k]
        common = {k: v for k, v in common.items() if k in keys}
        aggregated = sorted(
            {k for sp in spans for k in sp.tags} - set(common))
        return common, aggregated

    # ------------------------------------------------------------------
    # Execution
    # ------------------------------------------------------------------

    def run(self, spec: QuerySpec, start: int, end: int,
            ) -> list[QueryResult]:
        return self.run_with_plan(spec, start, end)[0]

    def run_with_plan(self, spec: QuerySpec, start: int, end: int,
                      ) -> tuple[list[QueryResult], str, bool]:
        """run() plus the plan label ("resident" when the device window
        served it, else "raw") and whether the scan's every fragment
        came from the warm fragment cache (always False for "resident",
        as in the JAX package: the window's stage cache holds grids, not
        scanned columns)."""
        if end <= start:
            raise BadRequestError(
                f"end time {end} is <= start time {start}")
        agg = Aggregators.get(spec.aggregator)
        if agg.kind == "cardinality":
            raise BadRequestError(
                "use the /distinct endpoint for cardinality queries")
        dev = self._run_devwindow(spec, start, end, agg)
        if dev is not None:
            return dev, "resident", False
        info: dict = {}
        groups = self._find_spans(spec, start, end, info)
        return (self._execute_groups(spec, groups, start, end), "raw",
                bool(info.get("cached")))

    @staticmethod
    def _oracle_downsample(spec: QuerySpec) -> bool:
        """Percentile DOWNSAMPLERS (1h-p95) run on the float64 oracle, as
        in the JAX package: the device kernels reduce moments, not
        per-bucket order statistics."""
        return bool(spec.downsample) and Aggregators.get(
            spec.downsample[1]).kind == "percentile"

    def _execute_groups(self, spec: QuerySpec, groups: dict,
                        start: int, end: int) -> list[QueryResult]:
        agg = Aggregators.get(spec.aggregator)
        gkeys = sorted(groups)
        use_cpu = self.backend == "cpu" or self._oracle_downsample(spec)
        if not use_cpu:
            # Ranges wider than int32 seconds (>68 years) would wrap the
            # int32 offsets the kernels use; the oracle serves them, as
            # in the JAX package.
            qbase = (start - start % spec.downsample[0] if spec.downsample
                     else start)
            use_cpu = end - qbase > 2**31 - 1
        # A wide downsampled group-by batches into ONE kernel call for all
        # groups; un-downsampled group-bys run per group, as in the JAX
        # package.
        per_group = None
        if not use_cpu and len(gkeys) > 1 and spec.downsample:
            per_group = self._run_device_multigroup(
                spec, [groups[k] for k in gkeys], start, end)
        results = []
        for gi, gkey in enumerate(gkeys):
            spans = groups[gkey]
            tags, aggregated = self._group_tags(spans)
            if per_group is not None:
                ts, vals = per_group[gi]
            elif use_cpu:
                ts, vals = self._run_cpu(spec, spans)
            else:
                ts, vals = self._run_device(spec, spans, start, end)
            results.append(QueryResult(
                spec.metric, tags, aggregated, ts, vals))
        return results

    def _run_cpu(self, spec: QuerySpec, spans: list[_Span]):
        series = []
        for sp in spans:
            ts, vals = sp.timestamps, sp.values
            if spec.downsample:
                interval, dsagg = spec.downsample
                ts, vals = oracle.downsample(ts, vals, interval, dsagg,
                                             mode="aligned",
                                             bucket_ts="start")
            if spec.rate:
                ts, vals = oracle.rate(
                    ts, vals,
                    counter_max=spec.counter_max if spec.counter else None,
                    reset_value=spec.reset_value)
            if len(ts):
                series.append((ts, vals))
        if not series:
            return (np.empty(0, np.int64), np.empty(0, np.float64))
        return oracle.group_aggregate(series, spec.aggregator,
                                      interp=self._interp(spec))

    @staticmethod
    def _interp(spec: QuerySpec) -> str:
        """Group-stage gap policy: the zimsum/mimmin/mimmax family never
        interpolates; rates hold the last value; everything else lerps
        (reference SGIterator semantics, SpanGroup.java:702-784)."""
        if not Aggregators.get(spec.aggregator).interpolates:
            return "none"
        return "step" if spec.rate else "lerp"

    # -- device kernel backend ----------------------------------------

    @staticmethod
    def _rate_kw(spec: QuerySpec) -> dict:
        return dict(
            rate=spec.rate,
            counter_max=spec.counter_max if spec.counter else 0.0,
            reset_value=spec.reset_value or 0.0,
            counter=spec.counter,
            drop_resets=spec.reset_value is not None)

    def _flatten_spans(self, spans: list[_Span], qbase: int):
        """Spans -> one flat (rel_ts, vals, sid, valid) point stream on
        the executor's device."""
        ts = np.concatenate([sp.timestamps for sp in spans])
        vals = np.concatenate(
            [sp.values for sp in spans]).astype(np.float32)
        sid = np.concatenate([
            np.full(len(sp.timestamps), i, np.int32)
            for i, sp in enumerate(spans)])
        rel = (ts - qbase).astype(np.int32)
        dev = self.device
        return (torch.from_numpy(rel).to(dev),
                torch.from_numpy(vals).to(dev),
                torch.from_numpy(sid).to(dev),
                torch.ones(len(rel), dtype=torch.bool, device=dev))

    def _run_device(self, spec: QuerySpec, spans: list[_Span], start: int,
                    end: int):
        """One group on the device (the JAX package's _run_tpu). With a
        downsampler: downsample_group (its _tpu_downsample_group), flat
        downsample [+ rate] + cross-series group in one call; a
        percentile group aggregator takes the per-series buckets, fills
        them and selects across series. Without one: the union grid."""
        if not spec.downsample:
            return self._run_device_union(spec, spans)
        interval, dsagg = spec.downsample
        qbase = start - start % interval
        # Power-of-two padding, as in the JAX package, so both compute on
        # identical grids; padded series/buckets hold no points.
        num_buckets = _pad_size(int((end - qbase) // interval + 1))
        agg = Aggregators.get(spec.aggregator)
        rel, vals, sid, valid = self._flatten_spans(spans, qbase)
        out = kernels.downsample_group(
            rel, vals, sid, valid, num_series=_pad_size(len(spans)),
            num_buckets=num_buckets, interval=interval, agg_down=dsagg,
            agg_group=spec.aggregator if agg.kind == "moment" else "count",
            **self._rate_kw(spec))
        gmask = out["group_mask"].cpu().numpy()
        if agg.kind == "percentile":
            # Post-rate buckets when spec.rate: rates step-hold, plain
            # values lerp.
            fill = kernels.step_fill if spec.rate else kernels.gap_fill
            filled, in_range = fill(out["series_values"],
                                    out["series_mask"], num_buckets)
            gv = kernels.masked_quantile_axis0(filled, in_range,
                                               [agg.quantile])[0]
        else:
            gv = out["group_values"]
        values = gv.cpu().numpy()[gmask]
        grid_ts = np.flatnonzero(gmask).astype(np.int64) * interval + qbase
        return grid_ts, values.astype(np.float64)

    def _run_device_union(self, spec: QuerySpec, spans: list[_Span]):
        """An un-downsampled group (the JAX package's _run_tpu general
        branch): optional per-point rate, then aggregation on the union
        of the spans' timestamps, relative to the earliest first one."""
        series = [(sp.timestamps, sp.values) for sp in spans]
        if spec.rate:
            series = [s for s in self._device_rate(series, spec)
                      if len(s[0])]
        if not series:
            return (np.empty(0, np.int64), np.empty(0, np.float64))
        counts = np.array([len(s[0]) for s in series], np.int32)
        S, T = len(series), _pad_size(int(counts.max()))
        base = min(int(s[0][0]) for s in series)
        # Left-aligned padded rows, filled in bulk.
        rows = np.repeat(np.arange(S), counts)
        cols = np.arange(len(rows)) - np.repeat(
            np.cumsum(counts) - counts, counts)
        ts_pad = np.zeros((S, T), np.int32)
        val_pad = np.zeros((S, T), np.float32)
        ts_pad[rows, cols] = np.concatenate([s[0] for s in series]) - base
        val_pad[rows, cols] = np.concatenate([s[1] for s in series])
        dev = self.device
        ts_t, val_t, cnt_t = (torch.from_numpy(x).to(dev)
                              for x in (ts_pad, val_pad, counts))
        interp = self._interp(spec)
        agg = Aggregators.get(spec.aggregator)
        if agg.kind == "percentile":
            grid, out = self._device_quantile_grid(ts_t, val_t, cnt_t,
                                                   agg.quantile, interp)
        else:
            grid, out, gmask = kernels.group_interpolate(
                ts_t, val_t, cnt_t, agg=spec.aggregator, interp=interp)
            grid, out = grid[gmask], out[gmask]
        return (grid.cpu().numpy().astype(np.int64) + base,
                out.cpu().numpy().astype(np.float64))

    @staticmethod
    def _device_quantile_grid(ts_pad, val_pad, counts, q: float,
                              interp: str):
        """Union-grid percentile (the JAX package's _tpu_quantile_grid):
        the grid once, each series' contributions at its U real points
        ([S, U], which must fit on the device), then the quantile across
        series. Returns (grid [U], values [U])."""
        grid, gmask = kernels.union_grid(ts_pad, counts)
        grid = grid[:int(gmask.sum())]
        contrib, cmask = kernels.series_contributions(
            ts_pad, val_pad, counts, grid, interp=interp)
        return grid, kernels.masked_quantile_axis0(contrib, cmask, [q])[0]

    def _device_rate(self, series, spec: QuerySpec):
        """Rate each series on the device with the flat kernel (the JAX
        package's _tpu_rate); [(ts, rates)] aligned with ``series``."""
        lens = [len(s[0]) for s in series]
        ts = np.concatenate([s[0] for s in series]).astype(np.int64)
        base = int(ts.min()) if len(ts) else 0
        vals = np.concatenate([s[1] for s in series]).astype(np.float32)
        sid = np.repeat(np.arange(len(series), dtype=np.int32), lens)
        dev = self.device
        rates, ok = kernels.flat_rate(
            torch.from_numpy((ts - base).astype(np.int32)).to(dev),
            torch.from_numpy(vals).to(dev), torch.from_numpy(sid).to(dev),
            torch.ones(len(ts), dtype=torch.bool, device=dev),
            counter_max=spec.counter_max,
            reset_value=spec.reset_value or 0.0,
            counter=spec.counter,
            drop_resets=spec.reset_value is not None)
        rates, ok = rates.cpu().numpy(), ok.cpu().numpy()
        cut = np.cumsum(lens)[:-1]
        return [(t[m], r[m].astype(np.float64)) for t, r, m in zip(
            np.split(ts, cut), np.split(rates, cut), np.split(ok, cut))]

    def _run_device_multigroup(self, spec: QuerySpec,
                               span_groups: list[list[_Span]],
                               start: int, end: int):
        """All group-by buckets through one downsample_multigroup call
        (the JAX package's _run_tpu_multigroup). Returns
        [(grid_ts, values)] aligned with span_groups."""
        interval, dsagg = spec.downsample
        qbase = start - start % interval
        num_buckets = _pad_size(int((end - qbase) // interval + 1))
        all_spans: list[_Span] = []
        group_of_sid: list[int] = []
        for gi, spans in enumerate(span_groups):
            all_spans.extend(spans)
            group_of_sid.extend([gi] * len(spans))
        G = _pad_size(len(span_groups))
        S = _pad_size(len(all_spans))
        # Padded series map to group G-1 (possibly a real group) — safe
        # solely because padded series carry no points.
        gmap = np.full(S, G - 1, np.int32)
        gmap[:len(group_of_sid)] = group_of_sid
        rel, vals, sid, valid = self._flatten_spans(all_spans, qbase)
        gmap_t = torch.from_numpy(gmap).to(self.device)
        agg = Aggregators.get(spec.aggregator)
        if agg.kind == "percentile":
            out = kernels.downsample_multigroup_quantile(
                rel, vals, sid, valid, gmap_t, [agg.quantile],
                num_series=S, num_groups=G, num_buckets=num_buckets,
                interval=interval, agg_down=dsagg,
                layout=kernels.group_layout(gmap, G, self.device),
                **self._rate_kw(spec))
        else:
            out = kernels.downsample_multigroup(
                rel, vals, sid, valid, gmap_t, num_series=S, num_groups=G,
                num_buckets=num_buckets, interval=interval,
                agg_down=dsagg, agg_group=spec.aggregator,
                **self._rate_kw(spec))
        gv = out["group_values"].cpu().numpy()
        gm = out["group_mask"].cpu().numpy()
        results = []
        for gi in range(len(span_groups)):
            mask = gm[gi]
            grid_ts = (np.flatnonzero(mask).astype(np.int64) * interval
                       + qbase)
            results.append((grid_ts, gv[gi][mask].astype(np.float64)))
        return results

    # -- device-resident window path ----------------------------------

    def _run_devwindow(self, spec: QuerySpec, start: int, end: int,
                       agg) -> list[QueryResult] | None:
        """Serve the query from the device-resident window
        (storage/devstore.py) when it exactly covers [start, end]: no
        storage scan, no host->device point upload — the host only
        filters the series directory and uploads [S]-sized maps. Returns
        None to fall back to the scan path (oracle backend, no window,
        un-downsampled queries, percentile downsamplers, dirty/evicted
        windows,
        unknown UIDs, out-of-int32 epochs/ranges, device out of
        memory)."""
        dw = self.tsdb.devwindow
        if (dw is None or self.backend == "cpu" or not spec.downsample
                or agg.kind not in ("moment", "percentile")
                or Aggregators.get(spec.downsample[1]).kind != "moment"):
            return None
        interval, dsagg = spec.downsample
        qbase = start - start % interval
        imin, imax = -(2**31), 2**31 - 1
        # Rebased in-range timestamps span up to end - qbase; past int32
        # they would wrap in the kernels. Checked BEFORE touching the
        # window: chunk_columns() forces a staged upload + drain.
        if end - qbase > imax:
            return None
        try:
            metric_uid = self.tsdb.metrics.get_id(spec.metric)
            exact, group_bys = self._tag_filters(spec.tags)
        except NoSuchUniqueName:
            return None  # the scan path raises the canonical error
        cols = dw.chunk_columns(metric_uid, start, end)
        if cols is None:
            return None
        groups, named = self._devwindow_groups(
            dw, metric_uid, cols, exact, group_bys)
        if not groups:
            return []
        # The shift (qbase - epoch) takes part in device arithmetic
        # (rel_ts - shift), unlike lo/hi, which only compare and clamp
        # safely: past int32, fall back rather than mis-bucket.
        if not imin <= qbase - cols.epoch <= imax:
            return None
        num_buckets = _pad_size(int((end - qbase) // interval + 1))
        S_pad = _pad_size(len(cols.series_keys))
        if S_pad * num_buckets >= 2**31:
            # The per-(series, bucket) segment ids are int32.
            return None
        gkeys = sorted(groups)
        G = _pad_size(len(gkeys))
        # Device include/gmap (and, for a group-by, gmap's rows sorted by
        # group for the rank select), cached per (window instance, metric,
        # filter); the generation lives in the VALUE, so a directory
        # growth overwrites in place and dead generations never
        # accumulate device tensors.
        mkey = (dw.instance_id, metric_uid, _filter_key(exact, group_bys))
        hit = self._dw_mask_cache.get(mkey)
        if hit is not None and hit[0] == cols.generation:
            include, gmap, layout = hit[1:]
        else:
            include = np.zeros(S_pad, bool)
            gmap = np.full(S_pad, G - 1, np.int32)
            for gi, gkey in enumerate(gkeys):
                for sid in groups[gkey]:
                    include[sid] = True
                    gmap[sid] = gi
            layout = (kernels.group_layout(gmap, G, dw.device)
                      if len(gkeys) > 1 else None)
            include = torch.from_numpy(include).to(dw.device)
            gmap = torch.from_numpy(gmap).to(dw.device)
            self._dw_mask_cache.put(mkey, (cols.generation, include, gmap,
                                           layout))
        ngroups = 1 if len(gkeys) == 1 else G
        rate_kw = self._rate_kw(spec)
        # The heavy N-point half (range mask + per-series downsample
        # [+ rate] + fill) is FILTER-INDEPENDENT: it caches per (window
        # instance, metric, data version, range, interval, downsample,
        # rate), so every panel over the same range pays only the
        # [S, B]-sized apply.
        skey = (dw.instance_id, metric_uid, cols.version, start, end,
                interval, dsagg, tuple(sorted(rate_kw.items())))
        cache = self._dw_stage_cache
        stage = cache.get(skey)
        if stage is None:
            try:
                grids = kernels.window_series_stage_chunks(
                    cols.chunks, min(max(start - cols.epoch, imin), imax),
                    min(max(end - cols.epoch, imin), imax),
                    qbase - cols.epoch, num_series=S_pad,
                    num_buckets=num_buckets, interval=interval,
                    agg_down=dsagg, **rate_kw)
            except torch.cuda.OutOfMemoryError:
                # A window filled near the device's memory can still run
                # out building the stage grids: the scan path serves.
                return None
            # [5] fills with the host copy of presence on first fetch.
            stage = list(grids) + [None]
            # Stages of this metric's EARLIER data versions can never hit
            # again (version is monotonic) but each pins [S, B] grids the
            # window's own budget can't see: drop them.
            for k in cache.keys():
                if k[:2] == (dw.instance_id, metric_uid) \
                        and k[2] != cols.version:
                    cache.pop(k)
            cache.put(skey, stage)
        sv, sm, filled, in_range, presence_dev = stage[:5]
        # Shrink-wrap the fetch: clip to the live group/bucket counts
        # (64-quantized) and bit-pack the mask on the device.
        b_live = int((end - qbase) // interval + 1)
        g_out = min(ngroups, _pad64(len(gkeys)))
        b_out = min(num_buckets, _pad64(b_live))
        try:
            if agg.kind == "percentile":
                gv, gm = kernels.window_quantile_apply(
                    sm, filled, in_range, include, gmap, [agg.quantile],
                    num_groups=ngroups, g_out=g_out, b_out=b_out,
                    layout=layout)
            else:
                gv, gm = kernels.window_moment_apply(
                    sv, sm, filled, in_range, include, gmap,
                    num_groups=ngroups, agg_group=spec.aggregator,
                    g_out=g_out, b_out=b_out)
            gv, gm = gv.cpu().numpy(), gm.cpu().numpy()
            if stage[5] is None:
                stage[5] = presence_dev.cpu().numpy()
        except torch.cuda.OutOfMemoryError:
            # Drop the stage too: it pins grids in the very memory that
            # just ran out.
            cache.pop(skey, None)
            return None
        # Series with no in-range points must not shape group labels or
        # emit empty groups — the scan path never sees them.
        has_points = stage[5]
        gm = np.unpackbits(gm, axis=1, count=b_out).astype(bool)
        results = []
        for gi, gkey in enumerate(gkeys):
            live = [sid for sid in groups[gkey] if has_points[sid]]
            if not live:
                continue
            spans = [_Span(cols.series_keys[sid], named[sid], None, None)
                     for sid in live]
            tags, aggregated = self._group_tags(spans)
            mask = gm[gi]
            grid_ts = (np.flatnonzero(mask).astype(np.int64) * interval
                       + qbase)
            results.append(QueryResult(
                spec.metric, tags, aggregated, grid_ts,
                gv[gi][mask].astype(np.float64)))
        return results

    def _devwindow_groups(self, dw, metric_uid: bytes, cols, exact,
                          group_bys):
        """Filter + group the window's series directory on host UIDs.

        Returns ({group_key_tuple: [sid]}, {sid: named_tags}); cached per
        (window instance, metric, filter) until the directory grows.
        ``dw`` is the window ``cols`` came from, so a window swap between
        the two cannot cache the old window's plan under the new one's
        instance_id."""
        fkey = (dw.instance_id, metric_uid, _filter_key(exact, group_bys))
        hit = self._dw_plan_cache.get(fkey)
        if hit is not None and hit[0] == cols.generation:
            return hit[1], hit[2]
        groups, named = self._series_groups(cols.series_keys, exact,
                                            group_bys)
        self._dw_plan_cache.put(fkey, (cols.generation, groups, named))
        return groups, named

    @staticmethod
    def _series_selector(exact, group_bys):
        """The tag-filter/group-by predicate of the window plan:
        series_key -> group key tuple when the series matches, None when
        filtered out (the scan path's row-key regexp, on UIDs)."""
        group_by_keys = sorted(k for k, _ in group_bys)
        want = dict(exact)
        gb = {k: (set(v) if v else None) for k, v in group_bys}

        def selector(skey: bytes):
            tag_uids = codec.series_tag_uids(skey)
            for k, v in want.items():
                if tag_uids.get(k) != v:
                    return None
            for k, allowed in gb.items():
                v = tag_uids.get(k)
                if v is None or (allowed is not None
                                 and v not in allowed):
                    return None
            return tuple(tag_uids.get(k, b"") for k in group_by_keys)

        return selector

    def _named_tags(self, skey: bytes) -> dict[str, str]:
        return {self.tsdb.tagk.get_name(k): self.tsdb.tagv.get_name(v)
                for k, v in codec.series_tag_uids(skey).items()}

    def _series_groups(self, series_keys, exact, group_bys):
        """Filter + group a series-key directory on host UIDs via
        ``_series_selector``; sid = position in ``series_keys``. Returns
        ({group_key_tuple: [sid]}, {sid: named_tags})."""
        selector = self._series_selector(exact, group_bys)
        groups: dict[tuple, list[int]] = {}
        named: dict[int, dict[str, str]] = {}
        for sid, skey in enumerate(series_keys):
            g = selector(skey)
            if g is None:
                continue
            groups.setdefault(g, []).append(sid)
            named[sid] = self._named_tags(skey)
        return groups, named

    # ------------------------------------------------------------------
    # Streaming-sketch queries (no storage rescan)
    # ------------------------------------------------------------------

    def _sketch_series(self, metric: str, tags: dict[str, str],
                       ) -> list[bytes]:
        """Series keys with sketch state matching metric + tag filter,
        selected from the sketch slot directory: the scan path's UID
        regexp, minus the base-time bytes."""
        metric_uid = self.tsdb.metrics.get_id(metric)
        exact, group_bys = self._tag_filters(tags)
        regexp = self._build_regexp(exact, group_bys, prefix=UID_WIDTH)
        pattern = re.compile(regexp, re.S) if regexp else None
        return [k for k in self.tsdb.sketches.series_keys()
                if k.startswith(metric_uid)
                and (pattern is None or pattern.match(k))]

    def sketch_quantiles(self, metric: str, tags: dict[str, str],
                         qs: list[float], start: int | None = None,
                         end: int | None = None,
                         max_error: float | None = None) -> dict:
        """Quantiles of the matching series' merged value distribution.

        Without a range: the merged per-series t-digests folded at ingest,
        each series' whole history, no storage rescan. With [start, end]:
        with no rollup tier to serve it, the JAX package's exact raw
        fallback (``max_error`` is a budget only a tier could use)."""
        if start is not None or end is not None:
            if start is None or end is None or end <= start:
                raise BadRequestError(
                    "sketch range needs both start and end (end > start)")
            return self._sketch_quantiles_range(metric, tags, qs, start,
                                                end)
        sk = self.tsdb.sketches
        if sk is None:
            raise BadRequestError(
                "streaming sketches are disabled (enable_sketches)")
        keys = self._sketch_series(metric, tags)
        out = sk.quantile(keys, np.asarray(qs, np.float32))
        if out is None:
            raise BadRequestError(
                f"no sketch state for metric {metric} with those tags")
        return {"metric": metric, "series": len(keys),
                "quantiles": {f"{q:g}": float(v)
                              for q, v in zip(qs, out)}}

    def _sketch_quantiles_range(self, metric: str, tags: dict[str, str],
                                qs: list[float], start: int,
                                end: int) -> dict:
        """Exact quantiles of every in-range value, pooled as float32
        (the digests' precision), as the JAX package answers when its
        rollup tier cannot serve the range."""
        groups = self._find_spans(QuerySpec(metric, tags), start, end)
        vals = [sp.values for spans in groups.values() for sp in spans]
        if not vals:
            raise BadRequestError(f"no data for metric {metric} in range")
        pool = np.concatenate(vals)
        est = np.quantile(pool.astype(np.float32).astype(np.float64),
                          np.clip(qs, 0.0, 1.0))
        return {"metric": metric, "series": len(vals), "rollup": "raw",
                "quantiles": {f"{q:g}": float(v)
                              for q, v in zip(qs, est)}}

    def sketch_distinct(self, metric: str, tagk: str,
                        start: int | None = None,
                        end: int | None = None) -> int | None:
        """Distinct-tagv count for a metric's tag key: the streaming HLL
        estimate without a range (None when the pair has no sketch
        state), an exact count over the series with data in the range
        with one."""
        return self.sketch_distinct_with_source(metric, tagk, start,
                                                end)[0]

    def sketch_distinct_with_source(
            self, metric: str, tagk: str, start: int | None = None,
            end: int | None = None) -> tuple[int | None, str]:
        """sketch_distinct() plus the label of what answered this call:
        "stream" (no range) or "scan" (the exact ranged count; "rollup"
        needs the tier this port does not have yet)."""
        if start is not None or end is not None:
            if start is None or end is None or end <= start:
                raise BadRequestError(
                    "distinct range needs both start and end")
            return self._sketch_distinct_range(metric, tagk, start, end)
        sk = self.tsdb.sketches
        if sk is None:
            return None, "stream"
        try:
            return (sk.distinct(self.tsdb.metrics.get_id(metric),
                                self.tsdb.tagk.get_id(tagk)), "stream")
        except NoSuchUniqueName:
            return None, "stream"

    def _sketch_distinct_range(self, metric: str, tagk: str, start: int,
                               end: int) -> tuple[int, str]:
        self.tsdb.tagk.get_id(tagk)  # an unknown tag key is a 400
        return (self.distinct_tagv(metric, {}, tagk, start, end,
                                   exact=True), "scan")

    def sketch_distinct_values(self, metric: str, tags: dict[str, str],
                               start: int, end: int) -> dict:
        """Count of distinct values a metric took over a range: with no
        rollup tier, the JAX package's exact fallback over the float32
        bit patterns of every in-range value."""
        groups = self._find_spans(QuerySpec(metric, tags), start, end)
        uniq: set = set()
        for spans in groups.values():
            for sp in spans:
                uniq.update(np.unique(sp.values.astype(np.float32)
                                      .view(np.uint32)).tolist())
        return {"metric": metric, "rollup": "raw",
                "distinct_values": len(uniq)}

    def distinct_tagv(self, metric: str, tags: dict[str, str],
                      tagk: str, start: int, end: int,
                      exact: bool | None = None) -> int:
        """Count distinct values of ``tagk`` among matching series.

        The HyperLogLog fold at p = 14 on the device backend (the kernel
        on a card), exact set counting on the cpu backend or when
        ``exact`` is forced, as in the JAX package."""
        spec = QuerySpec(metric, {**tags, tagk: "*"})
        groups = self._find_spans(spec, start, end)
        uids = []
        for spans in groups.values():
            for sp in spans:
                v = sp.tags.get(tagk)
                if v is not None:
                    uids.append(int.from_bytes(
                        self.tsdb.tagv.get_id(v), "big"))
        if exact or (exact is None and self.backend == "cpu"):
            return len(set(uids))
        if not uids:
            return 0
        pad = _pad_size(len(uids))
        items = np.zeros((1, pad), np.int32)
        items[0, :len(uids)] = uids
        valid = np.zeros((1, pad), bool)
        valid[0, :len(uids)] = True
        regs = sketches.hll_init(device=self.device)[None]
        sketches.hll_fold(
            regs, torch.zeros(1, dtype=torch.int32, device=self.device),
            torch.from_numpy(items).to(self.device),
            torch.from_numpy(valid).to(self.device),
            p=sketches.DEFAULT_HLL_P)
        return int(round(float(sketches.hll_estimate(regs)[0])))


def _u32(v: int) -> bytes:
    return int(v).to_bytes(4, "big")


def _pad_size(n: int) -> int:
    """Round up to a power of two (min 16) — the JAX package's padding,
    kept so both packages compute on identical grids."""
    size = 16
    while size < n:
        size *= 2
    return size


def _pad64(n: int) -> int:
    """Round up to a multiple of 64 (min 64): the fetch-slice quantum of
    the window path, as in the JAX package."""
    return max((n + 63) // 64 * 64, 64)


def _filter_key(exact, group_bys):
    """Canonical hashable form of a UID-level (exact, group_bys) tag
    filter — the shared component of the window's plan and mask cache
    keys, the fragment keys and the series-hint keys."""
    return (tuple(sorted(exact)),
            tuple(sorted((k, tuple(v) if v else None)
                         for k, v in group_bys)))
