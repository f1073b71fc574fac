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
"raw". Between the two, in the JAX package's order (resident, then
rollups, then fused, then raw): with the rollup tier open
(``Config.enable_rollups``), ``rollup/planner.plan`` serves a
window-aligned downsample from the tier's per-window records, raw
stitched over the edge and dirty windows, and the shared group stage
finishes on the planner's spans (plan label "1h" or "1d", the
resolution); then the fused plan serves a range
straight from TSST4 compressed blocks (``_run_fused_blocks``, plan label
"fused"): ``compress/fused.gather`` collects the covering blocks' payload
streams (exact or a counted decline), the hand-written decode kernel and
the segment kernels produce the same [S, B] stage grids the window path
makes, and the same apply kernels finish. It declines, counted under
``compress.fused.decline{reason=}``, on memtable rows in range
(``dirty``), a non-v4 generation, an ineligible block, mixed value
codecs, overlapping duplicate rows or an int32 overflow, and never runs
on the oracle backend. Warm gathers decode from the device block cache
(``compress/devcache.py``); stages cache per (range, plan, filter),
keyed on the generation set they came from. ``compress.fused.attempt`` /
``.served`` / ``.coverage`` and the ``compress.fused_agg`` timer account
for it. Queries without a downsampler always take the scan: their spans
are aggregated on the union of their timestamps (``group_interpolate``,
or the union-grid quantile), with rates taken per point first. Percentile
downsamplers (``1h-p95``) run on the float64 oracle, as in the JAX
package.

The scan reads through the fragment cache (``_scan_selector``, on by
default as in the JAX package): the range splits into row-span-aligned
chunks, and each chunk with no memtable rows and no row create/remove
since its fragment was decoded serves from a per-store LRU of decoded
columns (``MemKVStore.chunk_state``); chunks with memtable rows are
scanned afresh every time. A warm answer is bit-identical to a cold scan.
The scan passes the storage a candidate-series hint from the sketch
directory, so generations whose series bloom holds none of the selector's
series are skipped, and over a sharded store (``storage/sharded.py``)
whole shards no candidate routes to; ``chunk_state`` is then one element
per shard, and a fragment validates only when every shard agrees. The
``query.scan`` fault point fires once per selector scan.

Tracing (``obs/trace.py``): ``run_with_plan(..., trace=)`` records the
JAX package's span tree under the trace's root: ``planner.pick`` (tag
``plan``; the resident path runs inside it, its results' host copy
included), then on the scan path ``scan`` (tag ``cached``, the fragment
cache's ``qcache_hit`` / ``qcache_miss`` / ``qcache_bypass`` counts, and
a ``chunk.decode`` span per decoded chunk, tagged ``outcome`` and
``base``, with one ``shard.scan`` span per shard of a sharded store
under it) and ``aggregate``. Spans are wall-clock; untraced, each hook
is one global integer check. ``scan_latency`` (a LatencyDigest) keeps
the scan stage's milliseconds, traced or not.

Mesh legs (``QueryExecutor(mesh=...)``, ``parallel/``): with a mesh, a
downsampled moment or percentile group runs series-sharded
(``_tpu_downsample_sharded``; a wide group-by ``_multigroup_sharded``)
when it has at least one series a shard, time-sharded when its range has
at least four buckets a shard, else single-device, as in the JAX
package; the resident plan serves only from the mesh-sharded window
(``storage/devshard.py``, ``_dw_sharded_stage``: each shard's stage, then
the [S_shard, B] grids concatenated on the first shard's device), and a
single-device window declines under a mesh. The fused plan runs its
mesh leg (``compress/kernels.fused_block_stage_mesh``) over block-aligned
shards of the gather when the padded point stream divides the mesh, and
otherwise its single-device leg with ``mesh-indivisible`` counted; under a
mesh the device block cache is not used, as in the JAX package.

Approximate serving (``run_approx``, ``sketch/serving.py``): a caller
that opts in (``/q``'s ``approx=1`` or ``max_error=``) gets a percentile
downsample (``1h-p95``) served from the rollup tier's sketch columns with
its reported error bound (plan label ``approx-1h`` / ``approx-1d``), or,
when the bound exceeds ``max_error`` or the tier cannot serve it, the
exact answer.

Sketch queries (``/sketch`` and ``/distinct``) read the live sketches
(``stats/livesketch.py``) without a storage scan: quantiles of the merged
t-digests of the matching series, and the HyperLogLog estimate of a
(metric, tag key)'s distinct values. With a time range they are served
from the rollup tier where it covers the range (the windows' t-digest or
moment columns with their declared bound, record presence for a tag
value count, the windows' HLL registers for distinct values; label "1h"
or "1d"), else the JAX package's exact fallbacks: the pooled float32
values' quantiles, an exact count of tag values, or, with a tag filter,
the tag values' HyperLogLog at p = 14 (``distinct_tagv``).
"""

from __future__ import annotations

import re
import threading
import time
import weakref
from typing import NamedTuple

import numpy as np
import torch

from opentsdb_tpu_torch.compress import fused as _fused
from opentsdb_tpu_torch.compress import kernels as _ck
from opentsdb_tpu_torch.compress.devcache import DeviceBlockCache
from opentsdb_tpu_torch.compress.devcache import pad_fine as _pad_fine
from opentsdb_tpu_torch.core import codec
from opentsdb_tpu_torch.core.const import (MAX_TIMESPAN, NOLERP_AGGS,
                                           TIMESTAMP_BYTES,
                                           UID_WIDTH)
from opentsdb_tpu_torch.core.errors import (BadRequestError, NoSuchUniqueName,
                                             OverloadedError)
from opentsdb_tpu_torch.fault.faultpoints import fire as _fault
from opentsdb_tpu_torch.obs import trace as obs_trace
from opentsdb_tpu_torch.obs.registry import METRICS as _metrics
from opentsdb_tpu_torch.ops import kernels, oracle, sketches
from opentsdb_tpu_torch.query.aggregators import Aggregators
from opentsdb_tpu_torch.rollup import planner as rplanner
from opentsdb_tpu_torch.rollup import summary as rsummary
from opentsdb_tpu_torch.sketch import bounds as sbounds
from opentsdb_tpu_torch.sketch.moment import MomentSketch
from opentsdb_tpu_torch.stats.collector import LatencyDigest
from opentsdb_tpu_torch.storage.sstable import series_hash
from opentsdb_tpu_torch.utils.lru import LRUCache

# The fused plan off TSST4 blocks: wall time of the gather + stage + apply
# per served query, and the coverage accounting (attempts = queries past
# the fused gates, served = answered plan "fused"; every decline between
# the two counts under compress.fused.decline{reason=}).
_M_FUSED = _metrics.timer("compress.fused_agg")
_C_FUSED_ATTEMPT = _metrics.counter("compress.fused.attempt")
_C_FUSED_SERVED = _metrics.counter("compress.fused.served")
_metrics.gauge(
    "compress.fused.coverage",
    lambda: (_C_FUSED_SERVED.value / _C_FUSED_ATTEMPT.value
             if _C_FUSED_ATTEMPT.value else 0.0))


def _count_decline(reason: str) -> None:
    _metrics.counter("compress.fused.decline", {"reason": reason}).inc()


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
    def __init__(self, tsdb, backend: str | None = None,
                 mesh=None) -> None:
        """``mesh``: an optional ``parallel.mesh.Mesh``. With one, a
        downsampled moment or percentile query distributes over it:
        series-sharded (``parallel/sharded.py``) when a group has at
        least one series a shard, time-sharded
        (``parallel/timeshard.py``) when the range has at least four
        buckets a shard, otherwise single-device, by the JAX package's
        layout rules; the resident path serves only from a sharded
        window (``storage/devshard.py``). The fused plan runs its mesh
        leg over block-aligned shards when the padded point stream
        divides the mesh (else one device, ``mesh-indivisible`` counted),
        without the device block cache."""
        self.tsdb = tsdb
        if mesh is not None:
            from opentsdb_tpu_torch.parallel.plan import \
                flatten_series_mesh
            mesh = flatten_series_mesh(mesh)
        self.mesh = mesh
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
        # Fused-block stage cache: device grids keyed by range + plan +
        # filter; each entry pins the SSTable objects it came from, so a
        # generation swap mismatches (and id reuse cannot alias).
        self._fused_stage_cache = LRUCache(4)
        self.fused_shard_points = None
        # Device block cache (compress/devcache.py): decoded columns of
        # whole gathers, bounded by cached points.
        self._devcache = None
        if cfg.devblock_points > 0 and self.backend != "cpu":
            self._devcache = DeviceBlockCache(cfg.devblock_points,
                                              self.device)
        # Fragment cache: decoded per-(selector, aligned time-chunk)
        # columns, bounded by cached POINTS; one per store, shared by
        # every executor over it.
        self._frag_cache = _shared_frag_cache(
            tsdb.store, cfg.qcache_fragments, cfg.qcache_points)
        # Candidate-series hint per (metric, filter), revalidated on the
        # metric's directory size; bounded in total cached hashes.
        self._ident_cache = LRUCache(256, max_cost=1 << 21)
        # Approximate serving's rail cache (sketch/serving.py): per-series
        # (bucket_ts, est, lo, hi) rails of clean, fully window-covered
        # percentile ranges, revalidated against the tier's fold stamps.
        # Cost = cached buckets.
        self._sketch_rail_cache = LRUCache(16, max_cost=1 << 22)
        self.qcache_hits = 0
        self.qcache_misses = 0
        self.qcache_bypasses = 0
        # Scan-stage latency (the reference's TsdbQuery.scanlatency,
        # TsdbQuery.java:52,278): the /stats scan.latency lines.
        self.scan_latency = LatencyDigest()

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
        selector: a pruning hint for the per-generation series blooms and,
        over a sharded store, for the shards (``h % N`` routes).
        Read from the sketch slot directory, which the write path keeps a
        superset of the series with stored data (``TSDB.add_point`` and
        ``add_batch`` register with ``note_series`` before the put). None,
        which never prunes, without sketches, when nothing matches, or on
        a read-only replica: its directory reloads only at a writer's
        checkpoint, so it lags the series a WAL suffix replay brought."""
        sk = self.tsdb.sketches
        if sk is None or getattr(self.tsdb.store, "read_only", False):
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
        # Query-path fault point: delay or raise stretch or break exactly
        # the scan stage. Unarmed: one empty-dict check per selector scan.
        _fault("query.scan")
        hint = self._series_hint(metric_uid, exact, group_bys)
        b_lo = codec.base_time(max(start, 0))
        b_hi = min(codec.base_time(min(end, 0xFFFFFFFF)), 0xFFFFFFFF)

        def full_scan() -> dict:
            with obs_trace.span("chunk.decode", outcome="unchunked"):
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
            sp = obs_trace.current_span()
            if sp is not None:
                sp.tags["qcache_bypass"] = (
                    sp.tags.get("qcache_bypass", 0) + nchunks)
            return full_scan()
        parts: dict[bytes, list] = {}
        all_hit = True
        n_hit = n_miss = n_byp = 0
        for c, (seqs, floors, stamps, dirty) in zip(chunks, states):
            key = (fkey, c, chunk_s)
            if dirty:
                self.qcache_bypasses += 1
                n_byp += 1
                all_hit = False
                with obs_trace.span("chunk.decode", outcome="bypass",
                                    base=int(c)):
                    frag = self._scan_chunk(metric_uid, regexp, hint, c,
                                            c + chunk_s)
            else:
                ent = self._frag_cache.get(key)
                if ent is not None and all(
                        e >= f and m <= e
                        for e, f, m in zip(ent[0], floors, stamps)):
                    self.qcache_hits += 1
                    n_hit += 1
                    frag = ent[1]
                else:
                    self.qcache_misses += 1
                    n_miss += 1
                    all_hit = False
                    with obs_trace.span("chunk.decode", outcome="miss",
                                        base=int(c)):
                        frag = self._scan_chunk(metric_uid, regexp, hint,
                                                c, c + chunk_s)
                    cost = sum(len(cols.timestamps)
                               for cols in frag.values())
                    self._frag_cache.put(key, (seqs, frag),
                                         cost=max(cost, 1))
            for skey, cols in frag.items():
                parts.setdefault(skey, []).append(cols)
        if info is not None:
            info["cached"] = all_hit
        # The fragment cache's outcome on the enclosing span, accumulated
        # (a query scans several selectors). Hits cost a dict get: a
        # count, not a span.
        sp = obs_trace.current_span()
        if sp is not None:
            t = sp.tags
            t["qcache_hit"] = t.get("qcache_hit", 0) + n_hit
            t["qcache_miss"] = t.get("qcache_miss", 0) + n_miss
            t["qcache_bypass"] = t.get("qcache_bypass", 0) + n_byp
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
                      trace=None) -> tuple[list[QueryResult], str, bool]:
        """run() plus the plan label ("resident" when the device window
        served it, the resolution ("1h", "1d") when the rollup tier did,
        "fused" when the compressed blocks did, else "raw") and whether
        the scan's every fragment came from the warm fragment cache
        (always False for the other plans, as in the JAX package).

        ``trace`` (``obs/trace.Trace``): the stages record themselves as
        a span tree under ``trace.root``, whose tags then carry the plan
        and the cached flag. None (the default) costs one global integer
        check per hook."""
        return self.run_approx(spec, start, end, trace)[:3]

    def run_approx(self, spec: QuerySpec, start: int, end: int,
                   trace=None, approx=None, rollup_only: bool = False):
        """``run_with_plan`` under the approximate-serving contract
        (``sketch/serving.py``): ``(results, plan, cached, info)``, where
        ``info`` is None for an exact answer, an ``ApproxInfo`` for a
        percentile downsample served from the rollup tier's sketch columns
        (plan label ``approx-1h`` ...), or a ``"rollup-stale"`` dict that
        declares the stale, omitted and missing windows of a rollup-only
        answer over a dirty range. ``approx`` (``ApproxSpec``, None:
        exact) is the caller's opt-in and relative error budget: a
        reported bound over the budget runs the exact path instead.

        ``rollup_only`` is the load-shedding ladder's degraded step
        (``serve/admission.py``): a percentile downsample serves from the
        sketch columns (opted in or not); everything else serves from the
        materialized tier with no raw work (dirty and edge windows are
        omitted, not stitched). A query the tier cannot serve, or whose
        sketch answer is over the budget, raises ``OverloadedError``
        (503). The resident window's answers stay allowed: they are exact
        and read no storage."""
        if trace is None:
            return self._run_approx_inner(spec, start, end, approx,
                                          rollup_only)
        with obs_trace.activate(trace):
            out = self._run_approx_inner(spec, start, end, approx,
                                         rollup_only)
        trace.root.tags["plan"] = out[1]
        trace.root.tags["cached"] = bool(out[2])
        if out[3] is not None:
            trace.root.tags["approx"] = True
        return out

    def _run_approx_inner(self, spec: QuerySpec, start: int, end: int,
                          approx, rollup_only: bool = False):
        enabled = approx is not None and approx.enabled
        if (enabled or rollup_only) and self._oracle_downsample(spec):
            from opentsdb_tpu_torch.sketch import serving as _serving
            got = _serving.plan_percentile(self, spec, start, end,
                                           rollup_only=rollup_only)
            if got is not None:
                results, res, info = got
                max_error = approx.max_error if approx is not None else None
                if max_error is None or info.rel_error <= max_error:
                    from opentsdb_tpu_torch.rollup.tier import res_label
                    return (results, f"approx-{res_label(res)}", False,
                            info)
                _serving._M_FALLBACK.inc()
            if rollup_only:
                raise OverloadedError(
                    "shedding load: no approximate answer within the "
                    "error budget for this percentile query; retry "
                    "shortly", retry_after=0.5, status=503)
        meta: dict = {}
        results, plan, cached = self._run_planned(
            spec, start, end, rollup_only=rollup_only, meta_out=meta)
        info = None
        if rollup_only and (meta.get("stale_windows")
                            or meta.get("omitted_edges")
                            or meta.get("missing_windows")):
            # Rollup-only over a dirty range: stale windows were served
            # (their records reflect the last fold), edge windows omitted,
            # never-folded dirty windows absent; all declared.
            info = {"kind": "rollup-stale",
                    "stale_windows": int(meta.get("stale_windows", 0)),
                    "omitted_edges": int(meta.get("omitted_edges", 0)),
                    "missing_windows": int(meta.get("missing_windows", 0)),
                    "error": None}
        return results, plan, cached, info

    # -- expert-parallel dashboard batches ----------------------------

    def run_expert_batch(self, specs: "list[QuerySpec]", start: int,
                         end: int):
        """Serve a whole mixed dashboard batch in ONE mesh dispatch (the
        JAX package's ``run_expert_batch``).

        With a mesh (``Config.mesh_shape``) and expert serving on
        (``Config.expert_parallel``), the ``/q`` sub-queries -- mixed
        sum / avg / dev / max panels and pNN panels -- pack into expert
        buckets (``parallel/expert.py`` ``run_dashboard_batch``): the
        mesh's shards split by aggregator family and each shard runs its
        slots under its family's kernels. Answers match the serial leg to
        float32 tolerance. Like the JAX path, it scans the storage for
        every spec (``_find_spans``), even where the resident window
        covers the range.

        Returns ``(per_spec_results, None)`` on success or ``(None,
        reason)`` on a decline, with the JAX package's reasons in its
        order: the caller declares the decline (``plan:
        "expert-decline"`` per result and a counter) and runs the serial
        leg. The oracle backend ("cpu") declines; the device backend on
        the CPU runs the path."""
        from opentsdb_tpu_torch.parallel.expert import DASH_AGG_ID
        if self.mesh is None:
            return None, "no-mesh"
        if int(self.mesh.size) < 2:
            return None, "single-device-mesh"
        if self.backend == "cpu":
            return None, "cpu-backend"
        if len(specs) < 2:
            return None, "single-query"
        if end <= start:
            raise BadRequestError(
                f"end time {end} is <= start time {start}")
        intervals = set()
        for spec in specs:
            if not spec.downsample:
                return None, "no-downsample"
            interval, dsagg = spec.downsample
            ds = NOLERP_AGGS.get(dsagg, dsagg)
            if (Aggregators.get(dsagg).kind != "moment"
                    or ds not in DASH_AGG_ID):
                return None, "downsampler"
            agg = Aggregators.get(spec.aggregator)
            if agg.kind == "moment":
                if (spec.aggregator in NOLERP_AGGS
                        or spec.aggregator not in DASH_AGG_ID):
                    # The no-lerp family skips gap filling; the dash
                    # body is the lerp family only.
                    return None, "no-lerp-agg"
            elif agg.kind != "percentile":
                return None, "agg-family"
            if spec.rate:
                return None, "rate"
            intervals.add(interval)
        if len(intervals) != 1:
            # Mixed intervals are ragged bucket grids: slots share one
            # [S, B] layout.
            return None, "ragged-intervals"
        interval = intervals.pop()
        qbase = start - start % interval
        if end - qbase > 2**31 - 1:
            return None, "range"
        num_buckets = _pad_size(int((end - qbase) // interval + 1))
        per_spec_groups = []
        s_max = 1
        for spec in specs:
            with obs_trace.span("scan"):
                groups = self._find_spans(spec, start, end)
            per_spec_groups.append(groups)
            for spans in groups.values():
                s_max = max(s_max, len(spans))
        S = _pad_size(s_max)
        if S * num_buckets >= 2**31:
            return None, "grid"
        queries = []
        refs = []
        for si, (spec, groups) in enumerate(zip(specs, per_spec_groups)):
            _, dsagg = spec.downsample
            ds = NOLERP_AGGS.get(dsagg, dsagg)
            agg = Aggregators.get(spec.aggregator)
            for gkey in sorted(groups):
                spans = groups[gkey]
                rel, vals, sid = _flat_points(spans, qbase)
                qq = {"family": ("percentile" if agg.kind == "percentile"
                                 else "moment"),
                      "ts": rel, "vals": vals, "sid": sid, "dsagg": ds}
                if agg.kind == "percentile":
                    qq["quantile"] = agg.quantile
                else:
                    qq["agg"] = spec.aggregator
                queries.append(qq)
                refs.append((si, spans))
        per_spec: list = [[] for _ in specs]
        if not queries:
            return per_spec, None
        from opentsdb_tpu_torch.parallel.expert import run_dashboard_batch
        with obs_trace.span("aggregate"):
            got = run_dashboard_batch(
                queries, self.mesh, num_series=S,
                num_buckets=num_buckets, interval=interval)
        for (si, spans), (gv, gm) in zip(refs, got):
            tags, aggregated = self._group_tags(spans)
            grid_ts = (np.flatnonzero(gm).astype(np.int64) * interval
                       + qbase)
            per_spec[si].append(QueryResult(
                specs[si].metric, tags, aggregated, grid_ts,
                gv[gm].astype(np.float64)))
        return per_spec, None

    def _run_planned(self, spec: QuerySpec, start: int, end: int,
                     rollup_only: bool = False,
                     meta_out: dict | None = None,
                     ) -> tuple[list[QueryResult], str, bool]:
        if end <= start:
            raise BadRequestError(
                f"end time {end} is <= start time {start}")
        agg = Aggregators.get(spec.aggregator)
        if agg.kind == "cardinality":
            raise BadRequestError(
                "use the /distinct endpoint for cardinality queries")
        # The plan decision, the resident path's whole run included (its
        # answer's host copy ends inside it, so the window's device time
        # falls in this span).
        with obs_trace.span("planner.pick") as sp:
            dev = self._run_devwindow(spec, start, end, agg)
            planned = None
            fusedr = None
            if dev is None:
                # The rollup step (rollup/planner.py): window-aligned
                # downsamples from the summary tier, raw stitched over the
                # edge and dirty windows; its spans are already per-bucket
                # values, so the rewritten spec's downsample is the identity
                # and the shared group stage below runs unchanged. Its tier
                # reads and raw stitches are child spans of this one.
                planned = self._plan_rollup(spec, start, end,
                                            rollup_only=rollup_only,
                                            meta_out=meta_out)
            if dev is None and planned is None and rollup_only:
                raise OverloadedError(
                    "shedding load: this query needs a raw scan (no "
                    "eligible rollup resolution); retry shortly",
                    retry_after=0.5, status=503)
            if planned is not None:
                # Imported here: the tier's module registers its
                # instruments, which a daemon without the tier shows none
                # of (as in the JAX package).
                from opentsdb_tpu_torch.rollup.tier import res_label
                rlabel = res_label(planned[2])
            if dev is None and planned is None:
                # Fused decode-plus-aggregate off TSST4 blocks: after the
                # materialized tiers (the resident window, rollups), before
                # the raw scan. Exact or None.
                fusedr = self._run_fused_blocks(spec, start, end, agg)
            if sp is not None:
                sp.tags["plan"] = (
                    "resident" if dev is not None else
                    rlabel if planned is not None else
                    "fused" if fusedr is not None else "raw")
        if dev is not None:
            return dev, "resident", False
        if planned is not None:
            groups, spec2, _res = planned
            with obs_trace.span("aggregate"):
                results = self._execute_groups(spec2, groups, start, end)
            return results, rlabel, False
        if fusedr is not None:
            return fusedr, "fused", False
        t0 = time.time()
        info: dict = {}
        with obs_trace.span("scan") as sp:
            groups = self._find_spans(spec, start, end, info)
            if sp is not None:
                sp.tags["cached"] = bool(info.get("cached"))
        self.scan_latency.add((time.time() - t0) * 1000)
        with obs_trace.span("aggregate"):
            results = self._execute_groups(spec, groups, start, end)
        return results, "raw", bool(info.get("cached"))

    def _plan_rollup(self, spec: QuerySpec, start: int, end: int,
                     rollup_only: bool = False,
                     meta_out: dict | None = None):
        """The rollup tier's plan, ``(groups, spec2, res)``, or None.
        ``rollup_only`` (load shedding's degraded step) omits the raw
        stitches and counts what it left out into ``meta_out``."""
        if getattr(self.tsdb, "rollups", None) is None:
            return None
        return rplanner.plan(self, spec, start, end,
                             rollup_only=rollup_only, meta_out=meta_out)

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
        if self.mesh is not None and agg.kind in ("moment", "percentile"):
            sharded = self._tpu_downsample_sharded(
                spec, spans, qbase, interval, dsagg, num_buckets)
            if sharded is not None:
                return sharded
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

    def _tpu_downsample_sharded(self, spec: QuerySpec,
                                spans: list[_Span], qbase: int,
                                interval: int, dsagg: str,
                                num_buckets: int):
        """One group's downsample [+ rate] over self.mesh (the JAX
        package's function of the same name). Series-parallel when the
        group has at least one series a shard (local downsample + rate,
        the moment combine kernel, or a gather of the contributions for
        a percentile); time-parallel for long ranges with few series
        (bucket-aligned tiles, carries for lerp, step hold and rate).
        Returns (grid_ts, values), or None when neither layout applies
        (the caller runs single-device)."""
        from opentsdb_tpu_torch.parallel.mesh import TIME_AXIS, Mesh
        from opentsdb_tpu_torch.parallel.sharded import (
            pack_shards,
            sharded_downsample_group,
            sharded_downsample_quantile,
        )
        from opentsdb_tpu_torch.parallel.timeshard import (
            pack_time_shards,
            timeshard_downsample_group,
        )

        agg = Aggregators.get(spec.aggregator)
        rate_kw = self._rate_kw(spec)
        D = self.mesh.size
        if len(spans) >= D:
            series = [((sp.timestamps - qbase).astype(np.int64),
                       sp.values) for sp in spans]
            ts, vals, sid, valid, sps = pack_shards(series, D)
            if agg.kind == "percentile":
                gv, gm = sharded_downsample_quantile(
                    ts, vals, sid, valid, [agg.quantile], mesh=self.mesh,
                    series_per_shard=_pad_size(sps),
                    num_buckets=num_buckets, interval=interval,
                    agg_down=dsagg, **rate_kw)
                gv = gv[0]
            else:
                gv, gm = sharded_downsample_group(
                    ts, vals, sid, valid, mesh=self.mesh,
                    series_per_shard=_pad_size(sps),
                    num_buckets=num_buckets, interval=interval,
                    agg_down=dsagg, agg_group=spec.aggregator, **rate_kw)
        elif num_buckets >= 4 * D:
            bps = -(-num_buckets // D)
            rel = np.concatenate([sp.timestamps for sp in spans]) - qbase
            vals = np.concatenate([sp.values for sp in spans])
            sid = np.repeat(np.arange(len(spans), dtype=np.int32),
                            [len(sp.timestamps) for sp in spans])
            tsh = pack_time_shards(rel.astype(np.int32), vals, sid, D,
                                   interval, bps)
            gv, gm = timeshard_downsample_group(
                *tsh, mesh=Mesh(self.mesh.devices, (TIME_AXIS,)),
                num_series=_pad_size(len(spans)), buckets_per_shard=bps,
                interval=interval, agg_down=dsagg,
                agg_group=(spec.aggregator if agg.kind == "moment"
                           else "count"),
                quantile=(agg.quantile if agg.kind == "percentile"
                          else None), **rate_kw)
        else:
            return None
        gm = gm.cpu().numpy()
        grid_ts = np.flatnonzero(gm).astype(np.int64) * interval + qbase
        return grid_ts, gv.cpu().numpy()[gm].astype(np.float64)

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
        D = self.mesh.size if self.mesh is not None else 0
        if D and len(all_spans) >= D:
            gv, gm = self._multigroup_sharded(
                spec, all_spans, group_of_sid, G, qbase, interval, dsagg,
                num_buckets, D)
            return self._group_rows(gv, gm, len(span_groups), interval,
                                    qbase)
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
        return self._group_rows(out["group_values"].cpu().numpy(),
                                out["group_mask"].cpu().numpy(),
                                len(span_groups), interval, qbase)

    @staticmethod
    def _group_rows(gv, gm, n_groups: int, interval: int, qbase: int):
        """[(grid_ts, values)] of the first n_groups rows of [G, B]
        group values and masks."""
        results = []
        for gi in range(n_groups):
            mask = gm[gi]
            grid_ts = (np.flatnonzero(mask).astype(np.int64) * interval
                       + qbase)
            results.append((grid_ts, gv[gi][mask].astype(np.float64)))
        return results

    def _multigroup_sharded(self, spec: QuerySpec, all_spans: list[_Span],
                            group_of_sid: list[int], G: int, qbase: int,
                            interval: int, dsagg: str, num_buckets: int,
                            D: int):
        """A wide group-by over the mesh (the JAX package's function of
        the same name): series round-robin across the shards with a
        per-shard group map; the moment combine kernel merges the
        per-(group, bucket) partials, or the contributions are gathered
        for one grouped rank select. Returns numpy (gv [G, B],
        gm [G, B])."""
        from opentsdb_tpu_torch.parallel.sharded import (
            pack_shards,
            shard_placement,
            sharded_downsample_multigroup,
            sharded_downsample_multigroup_quantile,
        )
        series = [((sp.timestamps - qbase).astype(np.int64), sp.values)
                  for sp in all_spans]
        ts, vals, sid, valid, sps = pack_shards(series, D)
        sps_pad = _pad_size(sps)
        # The group map laid out by the packing's own placement. Padded
        # local series map to group G-1: safe, they carry no points.
        gmap = np.full((D, sps_pad), G - 1, np.int32)
        for (d, local), g in zip(shard_placement(len(series), D),
                                 group_of_sid):
            gmap[d, local] = g
        agg = Aggregators.get(spec.aggregator)
        if agg.kind == "percentile":
            gv, gm = sharded_downsample_multigroup_quantile(
                ts, vals, sid, valid, gmap, [agg.quantile],
                mesh=self.mesh, series_per_shard=sps_pad, num_groups=G,
                num_buckets=num_buckets, interval=interval,
                agg_down=dsagg, **self._rate_kw(spec))
        else:
            gv, gm = sharded_downsample_multigroup(
                ts, vals, sid, valid, gmap, mesh=self.mesh,
                series_per_shard=sps_pad, num_groups=G,
                num_buckets=num_buckets, interval=interval,
                agg_down=dsagg, agg_group=spec.aggregator,
                **self._rate_kw(spec))
        return gv.cpu().numpy(), gm.cpu().numpy()

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
        # A mesh executor serves the resident path only through the
        # mesh-sharded window (devshard.py): a single-device window under
        # a mesh declines, as in the JAX package.
        sharded = hasattr(dw, "shard_of")
        if (dw is None or self.backend == "cpu"
                or (self.mesh is not None and not sharded)
                or not spec.downsample
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
        # safely: past int32, fall back rather than mis-bucket. A sharded
        # window carries one epoch a shard; all must fit.
        epochs = ([sc.epoch for sc in cols.shards if sc is not None]
                  if sharded else [cols.epoch])
        if not all(imin <= qbase - e <= imax for e in epochs):
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
            # A sharded window's maps go to the combine device (the
            # first owning shard's), beside the gathered stage grids.
            dev = (next(sc.chunks[0][0].device for sc in cols.shards
                        if sc is not None) if sharded else dw.device)
            layout = (kernels.group_layout(gmap, G, dev)
                      if len(gkeys) > 1 else None)
            include = torch.from_numpy(include).to(dev)
            gmap = torch.from_numpy(gmap).to(dev)
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
                if sharded:
                    grids = self._dw_sharded_stage(
                        cols, start, end, qbase, num_buckets=num_buckets,
                        S_pad=S_pad, interval=interval, dsagg=dsagg,
                        rate_kw=rate_kw)
                    if grids is None:
                        return None
                else:
                    grids = kernels.window_series_stage_chunks(
                        cols.chunks,
                        min(max(start - cols.epoch, imin), imax),
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
        try:
            gv, gm, b_out = self._apply_stage(
                spec, agg, stage, include, gmap, layout, ngroups,
                len(gkeys), num_buckets, int((end - qbase) // interval + 1))
        except torch.cuda.OutOfMemoryError:
            # Drop the stage too: it pins grids in the very memory that
            # just ran out.
            cache.pop(skey, None)
            return None
        return self._stage_results(spec, groups, cols.series_keys, named,
                                   stage[5], gv, gm, b_out, interval,
                                   qbase)

    @staticmethod
    def _dw_sharded_stage(cols, start: int, end: int, qbase: int, *,
                          num_buckets: int, S_pad: int, interval: int,
                          dsagg: str, rate_kw: dict):
        """The stage half of a resident query over the mesh-sharded hot
        set (storage/devshard.py): each shard's chunk fold runs on its own
        device, then only the [S_shard, B] stage grids (never the point
        columns) go to the first shard's device, concatenate in the
        combined directory's order and pad to S_pad. Row order equals
        ``cols.series_keys``, so include / gmap and the apply kernels
        are oblivious to sharding.

        Numeric contract: the per-shard folds are the single-window
        kernels and a series never splits across shards, so count, min
        and max rows are identical across shard counts, and sum / avg /
        dev rows agree to float32 tolerance (bucket sums reassociate
        across chunk boundaries that fall differently per shard).

        Returns the window stage's grid tuple, or None when a shard's
        epoch shift does not fit int32 (scan fallback)."""
        imin, imax = -(2**31), 2**31 - 1
        parts = []
        for sc in cols.shards:
            if sc is None:
                continue
            if not imin <= qbase - sc.epoch <= imax:
                return None
            S_i = len(sc.series_keys)
            grids = kernels.window_series_stage_chunks(
                sc.chunks, min(max(start - sc.epoch, imin), imax),
                min(max(end - sc.epoch, imin), imax), qbase - sc.epoch,
                num_series=_pad_size(S_i), num_buckets=num_buckets,
                interval=interval, agg_down=dsagg, **rate_kw)
            parts.append((S_i, grids))
        if not parts:
            return None
        target = parts[0][1][0].device
        outs = []
        for gi in range(5):
            rows = [grids[gi][:S_i].to(target) for S_i, grids in parts]
            cat = rows[0] if len(rows) == 1 else torch.cat(rows)
            short = S_pad - cat.shape[0]
            if short:
                # Zero / False rows are what the one-window stage gives
                # its padding sids (no points), and the apply's include
                # mask never selects them.
                cat = torch.cat([cat, torch.zeros(
                    (short, *cat.shape[1:]), dtype=cat.dtype,
                    device=target)])
            outs.append(cat)
        return tuple(outs)

    @staticmethod
    def _apply_stage(spec, agg, stage, include, gmap, layout, ngroups,
                     live_groups, num_buckets, b_live):
        """The per-query half over a cached stage (resident and fused
        plans): include masking and group aggregation (moments, or the
        percentile), shrink-wrapped to the live group / bucket counts
        (64-quantized) with the mask bit-packed on the device, then
        fetched; the stage's presence is fetched once into ``stage[5]``.
        Returns (values, packed mask, b_out)."""
        sv, sm, filled, in_range, presence_dev = stage[:5]
        g_out = min(ngroups, _pad64(live_groups))
        b_out = min(num_buckets, _pad64(b_live))
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
        return gv, gm, b_out

    def _stage_results(self, spec, groups, series_keys, named, has_points,
                       gv, gm, b_out, interval, qbase):
        """QueryResults from a fetched apply: one per group in key order.
        Series with no in-range points must not shape group labels or
        emit empty groups (the scan path never sees them)."""
        gm = np.unpackbits(gm, axis=1, count=b_out).astype(bool)
        results = []
        for gi, gkey in enumerate(sorted(groups)):
            live = [sid for sid in groups[gkey] if has_points[sid]]
            if not live:
                continue
            spans = [_Span(series_keys[sid], named[sid], None, None)
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

    # -- fused plan over TSST4 compressed blocks ------------------------

    def _run_fused_blocks(self, spec: QuerySpec, start: int, end: int,
                          agg) -> list[QueryResult] | None:
        """Serve a downsampled query straight from TSST4 blocks: the
        decode kernel and the window stage produce the per-(series,
        bucket) grids on the device, then the apply kernels the resident
        window uses finish grouping and percentiles; under a mesh the
        stage runs over it (``_fused_stage_mesh``). Exact or None (the
        scan serves): memtable rows in range, a non-v4 generation, an
        ineligible block, overlay risk or an int32 overflow decline, each
        counted."""
        tsdb = self.tsdb
        cfg = tsdb.config
        if (self.backend == "cpu"
                or not spec.downsample
                or agg.kind not in ("moment", "percentile")
                or Aggregators.get(spec.downsample[1]).kind != "moment"
                or not cfg.sstable_fused_agg):
            return None
        store = tsdb.store
        interval, dsagg = spec.downsample
        imax = 2**31 - 1
        if start < 0 or end > 0xFFFFFFFF \
                or end - start > imax - 4 * MAX_TIMESPAN:
            return None
        qbase = start - start % interval
        if end - qbase > imax:
            return None
        try:
            metric_uid = tsdb.metrics.get_id(spec.metric)
            exact, group_bys = self._tag_filters(spec.tags)
        except NoSuchUniqueName:
            return None  # the scan path raises the canonical error
        b_lo = codec.base_time(start)
        b_hi = min(codec.base_time(end), 0xFFFFFFFF)
        _C_FUSED_ATTEMPT.inc()
        # Memtable rows in range: decline, since a frozen answer must
        # equal the scan's and overlaying live rows is the scan's job.
        if store.chunk_state(tsdb.table, b_lo, b_hi + MAX_TIMESPAN)[3]:
            _count_decline("dirty")
            return None
        with _M_FUSED.time():
            res = self._run_fused_inner(
                spec, start, end, agg, metric_uid, exact, group_bys,
                interval, dsagg, qbase, b_lo, b_hi)
        if res is not None:
            _C_FUSED_SERVED.inc()
        return res

    def _fused_stage(self, src, selector, S_pad, num_buckets, interval,
                     dsagg, rate_kw, lo32, hi32, shift32):
        """The stage grids of one gather: from the device block cache's
        decoded columns when the executor has one and no mesh (only
        per-record arrays go up, plus the matched points of a selective
        filter), else from the payload byte streams: over the mesh when
        the padded stream divides it (the JAX rule), else on one device,
        with ``mesh-indivisible`` counted. Every leg decodes
        identically."""
        dev = self.device

        def up(a):
            return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

        if self._devcache is not None and self.mesh is None:
            qd, vals, rec, _P, _P_pad, _R = self._devcache.columns(src)
            rel_base, sid_r, valid_r, sel = self._devcache.record_inputs(
                src, S_pad, selective=selector is not None)
            dev_kw = dict(
                num_series=S_pad, num_buckets=num_buckets,
                interval=interval, agg_down=dsagg, rate=rate_kw["rate"],
                counter=rate_kw["counter"],
                drop_resets=rate_kw["drop_resets"])
            args = (up(rel_base), up(sid_r), up(valid_r), lo32, hi32,
                    shift32, float(np.float32(rate_kw["counter_max"])),
                    float(np.float32(rate_kw["reset_value"])))
            if sel is not None:
                return _ck.devcache_window_stage_sel(
                    qd, vals, rec, up(sel), *args, **dev_kw)
            return _ck.devcache_window_stage(qd, vals, rec, *args,
                                             **dev_kw)
        P_pad = _pad_fine(src.npoints)
        kw = dict(num_series=S_pad, num_buckets=num_buckets,
                  interval=interval, agg_down=dsagg, vkind=src.kind,
                  **rate_kw)
        if self.mesh is not None:
            if P_pad % self.mesh.size == 0:
                return self._fused_stage_mesh(src, S_pad, lo32, hi32,
                                              shift32, **kw)
            _count_decline("mesh-indivisible")

        def pad(a, dtype, fill=0):
            out = np.full(P_pad, fill, dtype)
            out[:len(a)] = a
            return up(out)

        def padbuf(a):
            # Payload bytes pad to a power of two, as in the JAX package.
            n = max(len(a), 1)
            out = np.zeros(1 << (n - 1).bit_length(), np.uint8)
            out[:len(a)] = a
            return up(out)

        streams = (pad(src.ts_nb, np.int32), padbuf(src.ts_pay),
                   pad(src.v_nb, np.int32), padbuf(src.v_pay),
                   pad(src.first_idx, np.int32),
                   pad(src.blk_first, np.int32))
        matched = (np.flatnonzero(src.valid) if selector is not None
                   else None)
        if matched is not None and len(matched) < src.npoints:
            # Selective filter: decode the full streams (the value chains
            # span whole blocks) but stage only the matched points.
            # Padding sel entries re-read point 0 under valid=False.
            M_pad = _pad_fine(max(len(matched), 1))

            def padm(a, dtype, fill=0):
                out = np.full(M_pad, fill, dtype)
                out[:len(matched)] = a
                return up(out)

            return _ck.fused_block_stage_sel(
                *streams, padm(matched, np.int32),
                padm(src.rel_base_pt[matched], np.int32),
                padm(np.minimum(src.sid_pt[matched], S_pad - 1), np.int32),
                padm(np.ones(len(matched), bool), bool, False),
                lo32, hi32, shift32, **kw)
        return _ck.fused_block_stage(
            *streams, pad(src.rel_base_pt, np.int32),
            pad(np.minimum(src.sid_pt, S_pad - 1), np.int32),
            pad(src.valid, bool, False), lo32, hi32, shift32, **kw)

    def _fused_stage_mesh(self, src, S_pad, lo32, hi32, shift32, *,
                          counter_max, reset_value, **statics):
        """The fused stage's mesh leg: the gather's point stream cut into
        one run of whole blocks a shard (``compress/fused.block_shards``),
        every point staged under ``valid`` with no compaction (as the
        JAX leg stages it), one dispatch through the plane.
        ``fused_shard_points`` keeps the last cut's point count a shard
        (the cut's balance)."""
        mesh = self.mesh
        streams, self.fused_shard_points = _fused.block_shards(
            src.ts_nb, src.ts_pay, src.v_nb, src.v_pay, src.first_idx,
            src.blk_first, src.rel_base_pt,
            np.minimum(src.sid_pt, S_pad - 1), src.valid, mesh.size,
            _pad_fine)
        lo = mesh.offset
        streams = [a[lo:lo + len(mesh.devices)] for a in streams]
        fn = _ck.fused_block_stage_mesh(mesh, **statics)
        return fn(*streams, lo32, hi32, shift32,
                  float(np.float32(counter_max)),
                  float(np.float32(reset_value)))

    def _run_fused_inner(self, spec, start, end, agg, metric_uid, exact,
                         group_bys, interval, dsagg, qbase, b_lo, b_hi):
        tsdb = self.tsdb
        rate_kw = self._rate_kw(spec)
        # The tag filter is part of the stage's identity (it is pushed
        # into the gather: filtered-out series never reach the grid).
        skey_cache = (metric_uid, b_lo, b_hi, interval, dsagg, start, end,
                      _filter_key(exact, group_bys),
                      tuple(sorted(rate_kw.items())))
        hit = self._fused_stage_cache.get(skey_cache)
        if hit is not None:
            gens_hit, src_keys, epoch, stage, groups = hit
            # Valid only over the same generation objects (the entry
            # pins them): any checkpoint or merge swap rebuilds.
            spans = tsdb.store.encoded_range(
                tsdb.table, metric_uid + _u32(b_lo),
                metric_uid + _u32(min(b_hi + MAX_TIMESPAN, 0xFFFFFFFF)))
            if spans is None or len(spans) != len(gens_hit) or any(
                    g is not h for (g, _, _), h in zip(spans, gens_hit)):
                hit = None
                self._fused_stage_cache.pop(skey_cache)
        if hit is None:
            selector = self._series_selector(exact, group_bys)
            try:
                src = _fused.gather(tsdb.store, tsdb.table, metric_uid,
                                    b_lo, b_hi, selector=selector,
                                    points=(self._devcache is None
                                            or self.mesh is not None))
            except _fused.Decline as d:
                _count_decline(d.reason)
                return None
            if src.npoints == 0:
                return []
            epoch = src.epoch
            src_keys = src.series_keys
            groups = src.groups
        if not groups:
            return []
        S_pad = _pad_size(len(src_keys))
        imin, imax = -(2**31), 2**31 - 1
        if not imin <= qbase - epoch <= imax:
            _count_decline("int32-span")
            return None
        num_buckets = _pad_size(int((end - qbase) // interval + 1))
        if S_pad * num_buckets >= 2**31:
            _count_decline("grid-too-large")
            return None
        named = {sid: self._named_tags(src_keys[sid])
                 for sids in groups.values() for sid in sids}
        lo32 = min(max(start - epoch, imin), imax)
        hi32 = min(max(end - epoch, imin), imax)
        shift32 = qbase - epoch
        if hit is None:
            # [5] fills with the host copy of presence on first fetch.
            stage = list(self._fused_stage(
                src, selector, S_pad, num_buckets, interval, dsagg,
                rate_kw, lo32, hi32, shift32)) + [None]
            # Keyed on the snapshot the stage was computed FROM (src.spans,
            # not a fresh encoded_range a racing checkpoint could move).
            self._fused_stage_cache.put(
                skey_cache, (tuple(g for g, _, _ in src.spans), src_keys,
                             epoch, stage, groups))
        gkeys = sorted(groups)
        G = _pad_size(len(gkeys))
        ngroups = 1 if len(gkeys) == 1 else G
        include = np.zeros(S_pad, bool)
        gmap = np.full(S_pad, G - 1, np.int32)
        for gi, gkey in enumerate(gkeys):
            for sid in groups[gkey]:
                include[sid] = True
                gmap[sid] = gi
        dev = self.device
        layout = (kernels.group_layout(gmap, G, dev)
                  if agg.kind == "percentile" and ngroups > 1 else None)
        gv, gm, b_out = self._apply_stage(
            spec, agg, stage, torch.from_numpy(include).to(dev),
            torch.from_numpy(gmap).to(dev), layout, ngroups, len(gkeys),
            num_buckets, int((end - qbase) // interval + 1))
        return self._stage_results(spec, groups, src_keys, named, stage[5],
                                   gv, gm, b_out, interval, qbase)

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
        the rollup tier's window sketches and the raw edges, or the exact
        raw fallback (``_sketch_quantiles_range``)."""
        if start is not None or end is not None:
            if start is None or end is None or end <= start:
                raise BadRequestError(
                    "sketch range needs both start and end (end > start)")
            return self._sketch_quantiles_range(metric, tags, qs, start,
                                                end, max_error)
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
                                qs: list[float], start: int, end: int,
                                max_error: float | None = None) -> dict:
        """Quantiles over [start, end] from the rollup tier's per-window
        digest (or moment) columns, folded with the raw edge and dirty
        windows, with the declared enclosure (``approx``); the JAX
        package's exact raw fallback when the tier cannot serve the range
        or its bound exceeds ``max_error``."""

        def exact_raw() -> dict:
            # Every in-range value pooled as float32, the digests'
            # precision.
            groups = self._find_spans(QuerySpec(metric, tags), start, end)
            vals = [sp.values for spans in groups.values() for sp in spans]
            if not vals:
                raise BadRequestError(
                    f"no data for metric {metric} in range")
            pool = np.concatenate(vals)
            est = np.quantile(pool.astype(np.float32).astype(np.float64),
                              np.clip(qs, 0.0, 1.0))
            return {"metric": metric, "series": len(vals), "rollup": "raw",
                    "quantiles": {f"{q:g}": float(v)
                                  for q, v in zip(qs, est)}}

        tier = getattr(self.tsdb, "rollups", None)
        sel = rplanner.sketch_windows(self, tier, metric, tags, start, end)
        if sel is None:
            return exact_raw()
        from opentsdb_tpu_torch.rollup.tier import res_label
        res, records, raw_parts, dirty = sel
        kind = "tdigest" if tier.sketch_kinds(res)[0] else "moment"
        means: list[np.ndarray] = []
        weights: list[np.ndarray] = []
        msk: MomentSketch | None = None
        vmin, vmax = np.inf, -np.inf
        # Pooled-CDF rank uncertainty: each contributing window digest's
        # heaviest centroid weight; raw points contribute none.
        unc = 0.0
        # Series counted by contribution (digest or raw values), not by
        # map membership: a series whose windows are all dirty
        # contributes only through raw_parts.
        contributing: set[bytes] = set()
        for skey, (bases, recs, sketch_cells) in records.items():
            wstats = {int(b): (float(r["min"]), float(r["max"]))
                      for b, r in zip(bases, recs)}
            for wb, blob in sketch_cells:
                if wb in dirty:
                    continue
                m, w, _r, mblob = rsummary.sketch_decode_full(blob)
                got = False
                if kind == "tdigest" and len(m):
                    means.append(m.astype(np.float64))
                    weights.append(w.astype(np.float64))
                    unc += float(np.max(w))
                    got = True
                elif kind == "moment" and mblob is not None:
                    ms = MomentSketch.decode(mblob)
                    msk = ms if msk is None else msk.merge(ms)
                    got = True
                if got:
                    contributing.add(skey)
                    lo, hi = wstats.get(int(wb), (np.inf, -np.inf))
                    vmin, vmax = min(vmin, lo), max(vmax, hi)
        for skey, (ts, vals) in raw_parts.items():
            if len(vals):
                v32 = vals.astype(np.float32).astype(np.float64)
                if kind == "tdigest":
                    means.append(v32)
                    weights.append(np.ones(len(vals)))
                else:
                    add = MomentSketch(
                        msk.k if msk is not None else
                        MomentSketch().k).add(v32)
                    msk = add if msk is None else msk.merge(add)
                contributing.add(skey)
                vmin = min(vmin, float(v32.min()))
                vmax = max(vmax, float(v32.max()))
        if kind == "tdigest" and not means:
            return exact_raw()
        if kind == "moment" and (msk is None or msk.count <= 0):
            return exact_raw()
        ests, errs = [], {}
        rel_worst = 0.0
        if kind == "tdigest":
            m = np.concatenate(means)
            w = np.concatenate(weights)
            if len(m) > (1 << 16):
                m, w = rsummary.digest_compress(m, w, 4096)
                # The recompression adds its own within-centroid
                # uncertainty.
                unc += float(np.max(w))
            bounds = [sbounds.tdigest_quantile_bound(
                m, w, q, vmin=vmin, vmax=vmax, cdf_uncertainty_w=unc)
                for q in qs]
        else:
            bounds = [sbounds.moment_quantile_bound(msk, q) for q in qs]
        for q, qb in zip(qs, bounds):
            ests.append(qb.est)
            errs[f"{q:g}"] = qb.error
            rel_worst = max(rel_worst, qb.error / max(abs(qb.est), 1e-12))
        if max_error is not None and rel_worst > max_error:
            # The caller's budget is tighter than the sketch can promise.
            return exact_raw()
        return {"metric": metric, "series": len(contributing),
                "rollup": res_label(res),
                "quantiles": {f"{q:g}": float(v)
                              for q, v in zip(qs, ests)},
                "approx": {"kind": kind, "error": errs,
                           "rel_error": rel_worst,
                           "res": res_label(res)}}

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
        "stream" (no range), "rollup" (record presence) or "scan" (the
        exact ranged count)."""
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
        """Exact count over the series with data in the range: from
        rollup record presence at the finest resolution plus the raw
        stitches ("rollup"), or the exact scan ("scan")."""
        tagk_uid = self.tsdb.tagk.get_id(tagk)  # an unknown tag key: 400
        tier = getattr(self.tsdb, "rollups", None)
        sel = rplanner.sketch_windows(self, tier, metric, {}, start, end,
                                      presence_only=True)
        if sel is None:
            return (self.distinct_tagv(metric, {}, tagk, start, end,
                                       exact=True), "scan")
        _, records, raw_parts, dirty = sel
        vals: set[bytes] = set()
        for skey, (bases, _recs, _sk) in records.items():
            live = bases if not dirty else bases[
                ~np.isin(bases, np.fromiter(dirty, np.int64, len(dirty)))]
            if len(live):
                v = codec.series_tag_uids(skey).get(tagk_uid)
                if v is not None:
                    vals.add(v)
        for skey in raw_parts:
            v = codec.series_tag_uids(skey).get(tagk_uid)
            if v is not None:
                vals.add(v)
        return len(vals), "rollup"

    def sketch_distinct_values(self, metric: str, tags: dict[str, str],
                               start: int, end: int) -> dict:
        """Estimated count of distinct values a metric took over a range,
        from the rollup tier's per-window HLL registers (register max
        across windows and series) plus a raw fold over the edge and
        dirty windows; the JAX package's exact fallback over the float32
        bit patterns when no HLL-bearing resolution can serve."""
        tier = getattr(self.tsdb, "rollups", None)
        # Only HLL-bearing resolutions serve a distinct-values estimate:
        # a moment-only rung's cells carry no registers.
        sel = rplanner.sketch_windows(self, tier, metric, tags, start, end,
                                      want_hll=True)
        hll_p = tier.sketch_kinds(sel[0])[2] if sel is not None else 0
        if sel is None or not hll_p:
            groups = self._find_spans(QuerySpec(metric, tags), start, end)
            uniq: set = set()
            for spans in groups.values():
                for sp in spans:
                    uniq.update(np.unique(sp.values.astype(np.float32)
                                          .view(np.uint32)).tolist())
            return {"metric": metric, "rollup": "raw",
                    "distinct_values": len(uniq)}
        from opentsdb_tpu_torch.rollup.tier import res_label
        res, records, raw_parts, dirty = sel
        regs = np.zeros(1 << hll_p, np.uint8)
        for skey, (_bases, _recs, sketch_cells) in records.items():
            for wb, blob in sketch_cells:
                if wb in dirty:
                    continue
                _m, _w, r = rsummary.sketch_decode(blob)
                if r is not None and len(r) == len(regs):
                    np.maximum(regs, r, out=regs)
        for skey, (ts, vals) in raw_parts.items():
            if len(vals):
                rsummary.hll_update(
                    regs, vals.astype(np.float32).view(np.uint32))
        est = int(round(rsummary.hll_estimate(regs)))
        return {"metric": metric, "rollup": res_label(res),
                "distinct_values": est,
                "approx": {"kind": "hll",
                           "error": sbounds.hll_error(hll_p, est)}}

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


def _flat_points(spans, qbase: int):
    """Spans -> one flat (rel_ts int32, vals float32, sid int32) point
    stream in numpy, as the expert planner packs a slot."""
    ts = np.concatenate([sp.timestamps for sp in spans])
    vals = np.concatenate([sp.values for sp in spans]).astype(np.float32)
    sid = np.concatenate([np.full(len(sp.timestamps), i, np.int32)
                          for i, sp in enumerate(spans)])
    return (ts - qbase).astype(np.int32), vals, sid


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
