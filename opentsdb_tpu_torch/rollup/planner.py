"""Rollup query planning: serve window-aligned downsamples from the
materialized tier, stitching raw points over partial and dirty windows.

Mirrors ``opentsdb_tpu/rollup/planner.py`` of the JAX package, copied
whole. The rollup spans then run the port's group stage
(``QueryExecutor._execute_groups``: the card's kernels on the device
backend), as the JAX package runs its own. ``rollup_only`` stays in the
signature; the executor passes False until the query half of admission
(ROADMAP queue A item 10) brings the degraded step.

``plan()`` is the executor's rollup step. It either returns
``(groups, spec2, res)`` — per-series spans that are ALREADY
downsampled to the query's buckets, plus a rewritten QuerySpec whose
downsample stage is the identity — or ``None`` to fall back to the raw
scan. The executor then runs its normal group/interpolation stage on
either backend, so rollup-served and raw-served queries share every
line of group-aggregation code (and their answers can be compared
bucket for bucket).

Eligibility (the compatibility matrix, README "Rollup tier"):

- downsample present, interval a multiple of some resolution;
- downsample aggregator one of sum/count/min/max/avg (reconstructed
  exactly from the moment columns);
- no rate (rates need consecutive raw points);
- group aggregator any moment or percentile (both operate on the
  per-series bucket values, which are exact);
- tier ready (not rebuilding / crashed / corrupt).

Correctness: windows whose raw rows are still memtable-resident (or
mid-fold) are *dirty* — their summaries may be stale — so their
buckets, like the partial windows at the range edges, are recomputed
from a targeted raw scan. A mostly-dirty range falls back entirely:
the rollup path would degenerate into a slower raw scan.
"""

from __future__ import annotations

import numpy as np

from opentsdb_tpu_torch.core import codec
from opentsdb_tpu_torch.obs import trace as _trace
from opentsdb_tpu_torch.query.aggregators import Aggregators
from opentsdb_tpu_torch.rollup import summary
from opentsdb_tpu_torch.rollup.summary import EXACT_DSAGGS

# A range more dirty than this serves raw outright.
_MAX_DIRTY_FRACTION = 0.5


def _coalesce(ranges: list[tuple[int, int]]) -> list[tuple[int, int]]:
    """Merge overlapping/adjacent inclusive [lo, hi] ranges."""
    out: list[list[int]] = []
    for lo, hi in sorted(ranges):
        if out and lo <= out[-1][1] + 1:
            out[-1][1] = max(out[-1][1], hi)
        else:
            out.append([lo, hi])
    return [(lo, hi) for lo, hi in out]


def window_split(start: int, end: int, res: int):
    """Split [start, end] into (full-window range, raw edge ranges).
    Returns (w_lo, w_hi, edges) with w_hi < w_lo when no window fits."""
    s0, e0 = max(start, 0), min(end, 0xFFFFFFFF)
    w_lo = (s0 + res - 1) // res * res
    w_hi = (e0 + 1 - res) // res * res
    edges = []
    if w_hi >= w_lo:
        if s0 < w_lo:
            edges.append((s0, w_lo - 1))
        if w_hi + res <= e0:
            edges.append((w_hi + res, e0))
    return w_lo, w_hi, edges


def plan(executor, spec, start: int, end: int,
         rollup_only: bool = False, meta_out: dict | None = None):
    """``rollup_only`` (load shedding's degraded step): serve from the
    tier records alone — no raw stitching, no mostly-dirty bailout.
    Dirty windows serve their STALE records (their summaries reflect
    the last fold; ``meta_out['stale_windows']`` counts them) and the
    partial edge windows are omitted (``meta_out['omitted_edges']``)
    — the caller tags such results degraded AND reports the coverage,
    never a silent partial. Queries the tier can't serve at all still
    return None (the executor turns that into 503)."""
    tsdb = executor.tsdb
    tier = getattr(tsdb, "rollups", None)
    if tier is None:
        return None
    if not spec.downsample:
        tier.note_fallback("no-downsample")
        return None
    if spec.rate:
        tier.note_fallback("rate")
        return None
    interval, dsagg = spec.downsample
    if dsagg not in EXACT_DSAGGS:
        tier.note_fallback(f"dsagg-{dsagg}")
        return None
    agg = Aggregators.get(spec.aggregator)
    if agg.kind not in ("moment", "percentile"):
        tier.note_fallback("aggregator")
        return None
    res = tier.pick_resolution(interval)
    if res is None:
        tier.note_fallback("interval")
        return None
    if not tier.ready:
        tier.note_miss()
        return None
    sel = _select_windows(executor, tier, spec.metric, spec.tags,
                          start, end, res, want_sketches=False,
                          rollup_only=rollup_only)
    if sel is None:
        return None
    records, raw_parts, dirty_set = sel
    group_by_keys = sorted(
        k for k, _ in executor._tag_filters(spec.tags)[1])

    from opentsdb_tpu_torch.query.executor import _Span

    dirty_arr = (np.fromiter(dirty_set, np.int64, len(dirty_set))
                 if dirty_set else None)
    stale_served: set[int] = set()
    groups: dict[tuple, list] = {}
    for skey in sorted(set(records) | set(raw_parts)):
        bases_list, recs_list = [], []
        hit = records.get(skey)
        if hit is not None:
            bases, recs, _ = hit
            if dirty_arr is not None:
                if rollup_only:
                    # Degraded: dirty windows' records SERVE (stale —
                    # they reflect the last fold) instead of being
                    # silently dropped; the count is reported so the
                    # caller can declare the coverage.
                    stale = np.isin(bases, dirty_arr)
                    if stale.any():
                        stale_served.update(
                            int(b) for b in bases[stale])
                else:
                    keep = ~np.isin(bases, dirty_arr)
                    bases, recs = bases[keep], recs[keep]
            if len(bases):
                bases_list.append(bases)
                recs_list.append(recs)
        part = raw_parts.get(skey)
        if part is not None:
            ts, vals = part
            pb, pr = summary.window_summaries(ts, vals, res)
            if len(pb):
                bases_list.append(pb)
                recs_list.append(pr)
        if not bases_list:
            continue
        bases = np.concatenate(bases_list)
        recs = np.concatenate(recs_list)
        order = np.argsort(bases, kind="stable")
        bts, bvals = summary.combine_buckets(bases[order], recs[order],
                                             interval, dsagg)
        if not len(bts):
            continue
        tag_uids = codec.series_tag_uids(skey)
        named = {tsdb.tagk.get_name(k): tsdb.tagv.get_name(v)
                 for k, v in tag_uids.items()}
        gkey = tuple(tag_uids.get(k, b"") for k in group_by_keys)
        groups.setdefault(gkey, []).append(
            _Span(skey, named, bts, bvals))
    tier.note_hit(res)
    if meta_out is not None and rollup_only:
        meta_out["stale_windows"] = len(stale_served)
        meta_out["omitted_edges"] = len(
            window_split(start, end, res)[2])
        # Dirty windows NO fold has ever recorded (a fresh hour):
        # their buckets are absent — declared, never silent.
        meta_out["missing_windows"] = len(dirty_set - stale_served)
    # The spans are already per-bucket values at bucket-start
    # timestamps: re-downsampling with 'sum' is the identity (one
    # value per bucket), so the whole group stage — interpolation,
    # moments, percentiles, multigroup batching — runs unchanged.
    spec2 = spec._replace(downsample=(interval, "sum"))
    return groups, spec2, res


def _scan_raw_parts(executor, metric_uid: bytes, regexp: bytes | None,
                    ranges: list[tuple[int, int]],
                    exact, group_bys):
    """Targeted raw scans over the stitch ranges -> per-series sorted
    (ts, float64 values), filtered to the ranges.

    Routed through the executor's chunked fragment cache
    (_scan_selector) instead of bespoke scan_series calls: dirty
    windows bypass the cache by definition (they ARE the memtable-hot
    ranges), but the clean EDGE windows of repeat dashboard queries —
    re-stitched on every poll — now serve from the same warm decoded
    fragments full raw scans use, and golden parity vs a cold stitch
    holds because _scan_selector is bit-identical to an uncached scan
    by the fragment-cache contract."""
    parts: dict[bytes, list] = {}
    for lo, hi in ranges:
        with _trace.span("raw.stitch", lo=int(lo), hi=int(hi)):
            per_series = executor._scan_selector(
                metric_uid, exact, group_bys, regexp, lo, hi)
        for skey, cols in per_series.items():
            m = (cols.timestamps >= lo) & (cols.timestamps <= hi)
            if not m.any():
                continue
            parts.setdefault(skey, []).append(
                (cols.timestamps[m], cols.values[m]))
    return {
        skey: (np.concatenate([p[0] for p in ps]),
               np.concatenate([p[1] for p in ps]))
        for skey, ps in parts.items()}


def sketch_windows(executor, tier, metric: str, tags: dict,
                   start: int, end: int, presence_only: bool = False,
                   want_hll: bool = False):
    """Shared selection for the range-limited sketch endpoints: pick a
    sketch-bearing resolution, split the range, and return
    ``(res, records, raw_parts, dirty_set)`` — records carry sketch
    blobs, raw_parts the edge/dirty points to fold in. None when the
    tier cannot serve the range (caller falls back to an exact raw
    computation).

    ``presence_only`` (ranged /distinct): the caller needs record
    PRESENCE, not sketch columns — any resolution serves, so pick the
    finest one that fits (narrowest raw edges), skip the sketch-bearing
    gate (works with digest_k=0 / sub-sketch_min_res ranges, which
    otherwise force a full exact scan), and don't decode blobs."""
    if tier is None or not tier.ready:
        if tier is not None:
            tier.note_miss()
        return None
    span = max(end - start + 1, 1)
    if presence_only:
        if tier.resolutions[0] > span:
            tier.note_fallback("short-range")  # no sketch gate involved
            return None
        candidates = [tier.resolutions[0]]
    else:
        # Coarse to fine: a range WIDE enough for a resolution may
        # still contain no aligned full window of it (a 28h range
        # holds no whole day) — fall through to the next finer
        # sketch-bearing resolution instead of serving raw.
        # ``want_hll`` (distinct-values) skips moment-only rungs:
        # their cells carry no registers, and folding zero of them
        # would return a confident undercount.
        candidates = tier.sketch_candidates(span, want_hll=want_hll)
        if not candidates:
            tier.note_fallback("sketch-res")
            return None
    for res in candidates:
        sel = _select_windows(executor, tier, metric, tags, start,
                              end, res,
                              want_sketches=not presence_only)
        if sel is not None:
            records, raw_parts, dirty_set = sel
            tier.note_hit(res)
            return res, records, raw_parts, dirty_set
    return None


def _select_windows(executor, tier, metric: str, tags: dict,
                    start: int, end: int, res: int,
                    want_sketches: bool, rollup_only: bool = False):
    """THE range selection, shared by plan() and sketch_windows() so
    moment queries and sketch endpoints can never disagree on which
    windows serve from the tier: split [start, end] into full windows
    at ``res`` plus raw edges, derive the dirty-window set (any raw
    row still outside the folded tier, window granularity), fall back
    on short or mostly-dirty ranges, scan the tier's records, and
    raw-scan the coalesced edge+dirty stitch ranges. Returns
    ``(records, raw_parts, dirty_set)`` or None (caller serves raw)."""
    w_lo, w_hi, edges = window_split(start, end, res)
    if w_hi < w_lo:
        tier.note_fallback("short-range")
        return None
    hours = tier.dirty_hour_bases()
    dirty = np.unique(hours - hours % res) if len(hours) else hours
    dirty = dirty[(dirty >= w_lo) & (dirty <= w_hi)]
    n_windows = (w_hi - w_lo) // res + 1
    if (not rollup_only
            and len(dirty) > _MAX_DIRTY_FRACTION * n_windows):
        # A mostly-dirty range would degenerate into a slower raw
        # scan. Under rollup_only the comparison is moot — there IS no
        # raw path — so serve whatever clean windows exist.
        tier.note_fallback("mostly-dirty")
        return None
    # Raw path setup shared with the scan planner: same UID filters,
    # same key regexp (rollup keys have the raw key shape).
    tsdb = executor.tsdb
    metric_uid = tsdb.metrics.get_id(metric)
    exact, group_bys = executor._tag_filters(tags)
    regexp = executor._build_regexp(exact, group_bys)
    with _trace.span("rollup.read", res=res) as sp:
        records = tier.scan_records(res, metric_uid, w_lo, w_hi,
                                    key_regexp=regexp,
                                    want_sketches=want_sketches)
        if sp is not None:
            sp.tags["series"] = len(records)
            sp.tags["dirty_windows"] = int(len(dirty))
    dirty_set = frozenset(int(b) for b in dirty)
    if rollup_only:
        # Degraded: zero raw-scan work — no stitching. The caller
        # decides what dirty windows' records mean (plan() serves
        # them stale and reports the count; the sketch path widens
        # its error bound by their weight).
        return records, {}, dirty_set
    raw_ranges = _coalesce(
        edges + [(int(w), int(w) + res - 1) for w in dirty_set])
    raw_parts = _scan_raw_parts(executor, metric_uid, regexp,
                                raw_ranges, exact, group_bys)
    return records, raw_parts, dirty_set
