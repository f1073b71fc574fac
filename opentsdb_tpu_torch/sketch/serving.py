"""Error-contracted approximate serving of percentile downsamples.

Mirrors ``opentsdb_tpu/sketch/serving.py`` of the JAX package:
``ApproxSpec``, ``ApproxInfo``, ``plan_percentile`` with its rail cache,
the assembly of the tier's sketch columns into per-(series, bucket)
rails, the bounds-propagating group stage (``_group_stage``,
``_on_grid``, ``_agg_reduce_cols``) and the instruments
``sketch.serve.hit``, ``sketch.serve.fallback`` and
``sketch.error.reported``, registered when this module is imported (the
daemon imports it in every ``/q``, as the JAX daemon does). The JAX
module's test-only sabotage switch (its accuracy harness's
``TSDB_SKETCH_BUG``) is left out. The executor passes ``rollup_only``
at the admission ladder's degraded step (``/q`` past
``Config.query_max_inflight`` or ``?degrade=rollup-only``).

The planner step behind ``dsagg pNN`` approximate answers: merge the
rollup tier's per-window sketch columns (t-digest or moment — the
per-resolution allocation decides which exist) into per-(series,
bucket) quantile estimates WITH guaranteed enclosures
(sketch/bounds.py), run a bounds-propagating group stage (monotone
aggregators only — applying a monotone aggregator to the lo/hi rails
yields a sound group enclosure), and report one error figure per
result. The caller opts in (``approx=1`` / ``max_error=X``) or the
admission ladder's rollup-only step implies it; when the reported
bound exceeds the caller's budget the query falls back to the exact
raw path (or, under rollup-only, sheds with 503 — there IS no raw
path at that ladder step).

Two serving modes mirror the rollup planner's:

- **opt-in** (normal load): edge windows and dirty windows are
  raw-stitched — their contributions are EXACT (zero-width bounds),
  so the only error source is sketch compression on clean windows and
  the reported enclosure is unconditional.
- **rollup-only** (ladder degradation): zero raw work. Dirty windows
  serve their STALE sketch records with the rank bound widened by the
  stale weight fraction (bounds.dirty_rank_slack) and the result
  declares ``stale_windows``/``omitted_edges`` — degraded answers
  are bounded relative to the folded data and say so, never silently
  partial.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np

from opentsdb_tpu_torch.core import codec
from opentsdb_tpu_torch.obs import trace as _trace
from opentsdb_tpu_torch.obs.registry import METRICS as _metrics
from opentsdb_tpu_torch.query.aggregators import Aggregators
from opentsdb_tpu_torch.rollup import summary as rsummary
from opentsdb_tpu_torch.sketch import bounds as _bounds
from opentsdb_tpu_torch.sketch.moment import MomentSketch

_M_HIT = _metrics.counter("sketch.serve.hit")
_M_FALLBACK = _metrics.counter("sketch.serve.fallback")
# Histogram of reported RELATIVE error bounds (percent units so the
# p50/p95/p99 expansion reads naturally in /stats).
_M_ERR = _metrics.timer("sketch.error.reported")


class ApproxSpec(NamedTuple):
    """What the caller asked for. ``max_error`` is a RELATIVE
    half-width budget (reported_error <= max_error * |estimate|);
    None = serve at any bound (but still report it)."""
    enabled: bool = False
    max_error: float | None = None


class ApproxInfo(NamedTuple):
    kind: str             # "tdigest" | "moment"
    error: float          # max absolute half-width across buckets
    rel_error: float      # max relative half-width
    res: int
    stale_windows: int = 0
    omitted_edges: int = 0
    # Dirty windows in range that NO fold has ever recorded (a fresh
    # hour under rollup-only): their buckets are absent from the
    # answer and the contract requires saying so, not just bounding
    # what IS returned.
    missing_windows: int = 0

    def as_json(self) -> dict:
        from opentsdb_tpu_torch.rollup.tier import res_label
        out = {"kind": self.kind, "error": self.error,
               "rel_error": self.rel_error,
               "res": res_label(self.res)}
        if self.stale_windows:
            out["stale_windows"] = self.stale_windows
        if self.omitted_edges:
            out["omitted_edges"] = self.omitted_edges
        if self.missing_windows:
            out["missing_windows"] = self.missing_windows
        return out


# Group aggregators that are monotone in every argument — applying
# them to the lo/hi rails preserves enclosure soundness. ("dev" is
# not; it falls back to the exact path.)
_MONOTONE_MOMENTS = {"sum", "min", "max", "avg", "count",
                     "zimsum", "mimmin", "mimmax"}


class _Bucket:
    __slots__ = ("means", "weights", "vmin", "vmax", "clean_w",
                 "stale_w", "mblobs", "raw", "maxw")

    def __init__(self) -> None:
        self.means: list[np.ndarray] = []
        self.weights: list[np.ndarray] = []
        # Summed heaviest-centroid weight of every contributing
        # digest: the pooled CDF's rank uncertainty (bounds.py
        # cdf_uncertainty_w). Exact raw points contribute zero.
        self.maxw = 0.0
        self.vmin = np.inf
        self.vmax = -np.inf
        self.clean_w = 0.0
        self.stale_w = 0.0
        self.mblobs: list[bytes] = []
        self.raw: list[np.ndarray] = []


def plan_percentile(executor, spec, start: int, end: int, *,
                    rollup_only: bool = False):
    """Serve ``spec`` (percentile downsample aggregator) from sketch
    columns. Returns (results, res, ApproxInfo) or None (caller runs
    the exact path / sheds)."""
    tsdb = executor.tsdb
    tier = getattr(tsdb, "rollups", None)
    if tier is None or not tier.ready:
        _M_FALLBACK.inc()
        return None
    if spec.rate:
        _M_FALLBACK.inc()
        return None
    interval, dsagg = spec.downsample
    ds = Aggregators.get(dsagg)
    if ds.kind != "percentile":
        return None
    agg = Aggregators.get(spec.aggregator)
    if not (agg.kind == "percentile"
            or (agg.kind == "moment"
                and agg.name in _MONOTONE_MOMENTS)):
        _M_FALLBACK.inc()
        return None
    res = tier.sketch_res_for_interval(interval)
    if res is None:
        _M_FALLBACK.inc()
        return None
    digest_k, moment_k, _hp = tier.sketch_kinds(res)
    kind = "tdigest" if digest_k else "moment"

    q = float(ds.quantile)
    # Rail cache (the fragment-cache discipline for sketch serving):
    # a dashboard's repeat polls re-read the SAME clean window
    # records, and the record scan + cell decode + bound math is the
    # whole cost. A fully-window-covered range with no dirty windows
    # caches its per-series rails, keyed by the selector and
    # revalidated against the tier's fold/refresh stamps — any fold
    # (writer) or capture refresh (replica) invalidates. Dirty or
    # edge-stitched ranges bypass both ways (they ARE the live
    # tail).
    from opentsdb_tpu_torch.query.executor import _filter_key
    from opentsdb_tpu_torch.rollup.planner import window_split
    cache = getattr(executor, "_sketch_rail_cache", None)
    w_lo, w_hi, edges = window_split(start, end, res)
    hours = tier.dirty_hour_bases()
    range_clean = (w_hi >= w_lo and not edges and len(hours) == 0)
    if len(hours) and w_hi >= w_lo:
        dr = hours - hours % res
        range_clean = (not edges
                       and not ((dr >= w_lo) & (dr <= w_hi)).any())
    ckey = cval = None
    if cache is not None:
        try:
            exact, group_bys = executor._tag_filters(spec.tags)
        except Exception:
            exact = group_bys = None
        if exact is not None:
            ckey = (id(tier), spec.metric,
                    _filter_key(exact, group_bys), start, end, res,
                    interval, q, kind, rollup_only)
            cval = (tier.folds, getattr(tier, "refreshes", 0),
                    tier.records_written, tier.ready)
    spans = None
    stale_windows = 0
    missing_windows = 0
    if ckey is not None and range_clean:
        hit = cache.get(ckey)
        if hit is not None and hit[0] == cval:
            spans = hit[1]
    if spans is None:
        from opentsdb_tpu_torch.rollup import planner as rplanner
        sel = rplanner._select_windows(executor, tier, spec.metric,
                                       spec.tags, start, end, res,
                                       want_sketches=True,
                                       rollup_only=rollup_only)
        if sel is None:
            _M_FALLBACK.inc()
            return None
        records, raw_parts, dirty_set = sel
        with _trace.span("sketch.assemble", res=res, kind=kind):
            series = _assemble(records, raw_parts, dirty_set,
                               interval, kind, moment_k, rollup_only)
        if series is None:
            _M_FALLBACK.inc()
            return None
        per_series, stale_windows, seen_dirty = series
        if rollup_only:
            missing_windows = len(dirty_set - seen_dirty)
        if not per_series:
            # Nothing in range: the exact path answers (it knows how
            # to produce the canonical empty result / raise).
            _M_FALLBACK.inc()
            return None
        # Per-(series, bucket) estimates + enclosures, one batched
        # numpy pass per series (a dashboard is hundreds of
        # thousands of buckets; per-bucket python bound math was the
        # wall).
        spans = {}
        try:
            for skey, buckets in per_series.items():
                rails = _series_rails(buckets, q, kind,
                                      moment_k or MomentSketch().k)
                if rails is None:
                    _M_FALLBACK.inc()
                    return None  # undecodable cell: exact path
                spans[skey] = rails
        except ValueError:
            _M_FALLBACK.inc()
            return None
        if (ckey is not None and range_clean and not raw_parts
                and stale_windows == 0):
            cost = sum(len(r[0]) for r in spans.values())
            cache.put(ckey, (cval, spans), cost=max(cost, 1))

    results, err_abs, err_rel = _group_stage(executor, spec, spans)
    info = ApproxInfo(kind, err_abs, err_rel, res,
                      stale_windows=stale_windows,
                      omitted_edges=len(edges) if rollup_only else 0,
                      missing_windows=missing_windows)
    _M_HIT.inc()
    _M_ERR.observe(err_rel * 100.0)
    tier.note_hit(res)
    return results, res, info


def _assemble(records, raw_parts, dirty_set, interval, kind,
              moment_k, rollup_only):
    """-> ({series_key: {bucket_ts: _Bucket}}, stale_windows) or None
    when a clean window lacks the sketch column this tier claims to
    store (foreign/mixed layout: the exact path is the safe answer)."""
    per_series: dict[bytes, dict[int, _Bucket]] = {}
    stale_windows = 0
    seen_dirty: set[int] = set()

    def bucket(skey, bt) -> _Bucket:
        row = per_series.get(skey)
        if row is None:
            row = per_series[skey] = {}
        b = row.get(bt)
        if b is None:
            b = row[bt] = _Bucket()
        return b

    for skey, (bases, recs, sketches) in records.items():
        # Window -> (count, min, max) from the moment records: the
        # exact extremes that clamp the sketch enclosures.
        stats = {int(b): (float(r["count"]), float(r["min"]),
                          float(r["max"]))
                 for b, r in zip(bases, recs)}
        sk_bases = set()
        for wb, blob in sketches:
            wb = int(wb)
            sk_bases.add(wb)
            dirty = wb in dirty_set
            if dirty and not rollup_only:
                continue  # raw stitch covers it exactly
            try:
                means, weights, _regs, mblob = \
                    rsummary.sketch_decode_full(blob)
            except Exception:
                return None
            cnt, vmin, vmax = stats.get(wb, (0.0, np.inf, -np.inf))
            w = float(np.sum(weights)) if len(weights) else cnt
            if w <= 0 and mblob is None:
                continue
            b = bucket(skey, wb - wb % interval)
            if dirty:
                stale_windows += 1
                seen_dirty.add(wb)
                b.stale_w += max(w, cnt)
            else:
                b.clean_w += max(w, cnt)
            b.vmin = min(b.vmin, vmin)
            b.vmax = max(b.vmax, vmax)
            if kind == "tdigest":
                if len(means) == 0 and w > 0:
                    return None  # digest column missing at this res
                b.means.append(np.asarray(means, np.float64))
                b.weights.append(np.asarray(weights, np.float64))
                if len(weights):
                    b.maxw += float(np.max(weights))
            else:
                if mblob is None:
                    return None  # moment column missing
                b.mblobs.append(mblob)
        # A clean window with a record but NO sketch cell cannot be
        # served approximately; its points would silently vanish.
        for wb in stats:
            if wb not in sk_bases and wb not in dirty_set \
                    and stats[wb][0] > 0:
                return None
    for skey, (ts, vals) in raw_parts.items():
        if not len(ts):
            continue
        bts = ts - ts % interval
        cuts = np.concatenate(
            ([0], np.flatnonzero(np.diff(bts)) + 1, [len(ts)]))
        for a, z in zip(cuts[:-1], cuts[1:]):
            seg = np.asarray(vals[a:z], np.float64)
            b = bucket(skey, int(bts[a]))
            b.raw.append(seg)
            b.clean_w += len(seg)
            b.vmin = min(b.vmin, float(seg.min()))
            b.vmax = max(b.vmax, float(seg.max()))
    return per_series, stale_windows, seen_dirty


def _series_rails(buckets: dict, q: float, kind: str,
                  moment_k: int):
    """(bucket_ts[N], est[N], lo[N], hi[N]) for one series — the
    batched replacement for per-bucket bound math. t-digest buckets
    pack their (already-sorted) centroid arrays + unit-weight raw
    points into padded [N, K] rows and run one vectorized enclosure
    pass; moment buckets merge into MomentColumns (row additions)
    and run the elementwise Cantelli + Cornish-Fisher pass. Returns
    None on an empty/undecodable cell."""
    from opentsdb_tpu_torch.sketch.moment import MomentColumns
    bts = sorted(buckets)
    N = len(bts)
    slack = np.zeros(N)
    vmin = np.empty(N)
    vmax = np.empty(N)
    for i, bt in enumerate(bts):
        b = buckets[bt]
        if b.stale_w > 0:
            slack[i] = _bounds.dirty_rank_slack(b.clean_w, b.stale_w)
        vmin[i] = b.vmin
        vmax[i] = b.vmax
    if kind == "tdigest":
        rows = []
        needs_sort = False
        K = 0
        for bt in bts:
            b = buckets[bt]
            parts = len(b.means) + len(b.raw)
            if parts == 0:
                return None
            # Digest centroids come value-sorted; raw stitches come
            # TIME-sorted — any raw part (or a multi-digest merge)
            # forces the row re-sort.
            needs_sort = needs_sort or parts > 1 or bool(b.raw)
            K = max(K, sum(len(x) for x in b.means)
                    + sum(len(x) for x in b.raw))
            rows.append(b)
        if K == 0:
            return None
        means2d = np.full((N, K), np.inf)
        w2d = np.zeros((N, K))
        unc = np.empty(N)
        for i, b in enumerate(rows):
            off = 0
            for mm, ww in zip(b.means, b.weights):
                means2d[i, off:off + len(mm)] = mm
                w2d[i, off:off + len(mm)] = ww
                off += len(mm)
            for seg in b.raw:
                # Raw points fold in as unit-weight centroids: exact
                # contributions, no compression step.
                means2d[i, off:off + len(seg)] = seg
                w2d[i, off:off + len(seg)] = 1.0
                off += len(seg)
            unc[i] = b.maxw
        if needs_sort:
            order = np.argsort(means2d, axis=1, kind="stable")
            means2d = np.take_along_axis(means2d, order, 1)
            w2d = np.take_along_axis(w2d, order, 1)
        est, lo, hi = _bounds.tdigest_bounds_rows(
            np.where(np.isfinite(means2d), means2d, 0.0), w2d, q,
            vmin, vmax, rank_slack=slack, cdf_uncertainty_w=unc)
        return np.asarray(bts, np.int64), est, lo, hi
    cols = MomentColumns(N, moment_k)
    for i, bt in enumerate(bts):
        b = buckets[bt]
        for blob in b.mblobs:
            cols.add_blob(i, blob)   # raises ValueError on foreign
        for seg in b.raw:
            cols.add_values(i, seg)
    if (cols.count <= 0).any():
        return None
    est, lo, hi = _bounds.moment_bounds_batch(cols, q, slack)
    return np.asarray(bts, np.int64), est, lo, hi


def _group_stage(executor, spec, spans):
    """Bounds-propagating group aggregation on the shared bucket grid.

    Mirrors the exact path's semantics — union grid of member bucket
    timestamps, linear interpolation inside each series' [first,
    last] for interpolating aggregators, none for the zimsum family —
    applied to the est/lo/hi rails separately. Monotone aggregators
    only (callers gate), so the rails stay a sound enclosure.
    Returns ([QueryResult], max_abs_err, max_rel_err)."""
    from opentsdb_tpu_torch.query.executor import QueryResult, _Span

    tsdb = executor.tsdb
    group_by_keys = sorted(
        k for k, _ in executor._tag_filters(spec.tags)[1])
    groups: dict[tuple, list] = {}
    named_spans: dict[bytes, dict] = {}
    for skey in sorted(spans):
        tag_uids = codec.series_tag_uids(skey)
        named = {tsdb.tagk.get_name(k): tsdb.tagv.get_name(v)
                 for k, v in tag_uids.items()}
        named_spans[skey] = named
        gkey = tuple(tag_uids.get(k, b"") for k in group_by_keys)
        groups.setdefault(gkey, []).append(skey)

    agg = Aggregators.get(spec.aggregator)
    interp = executor._interp(spec)
    results = []
    max_abs = 0.0
    max_rel = 0.0
    for gkey in sorted(groups):
        skeys = groups[gkey]
        grid = np.unique(np.concatenate(
            [spans[s][0] for s in skeys]))
        rails = []  # per series (est, lo, hi) on grid, nan outside
        for s in skeys:
            bts, est, lo, hi = spans[s]
            rails.append(tuple(
                _on_grid(grid, bts, v, interp) for v in (est, lo, hi)))
        E = np.stack([r[0] for r in rails])    # [S, G]
        Lo = np.stack([r[1] for r in rails])
        Hi = np.stack([r[2] for r in rails])
        mask = (~np.isnan(E)).any(axis=0)
        with np.errstate(all="ignore"):
            est_g = _agg_reduce_cols(E, agg)
            lo_g = _agg_reduce_cols(Lo, agg)
            hi_g = _agg_reduce_cols(Hi, agg)
        sps = [_Span(s, named_spans[s], None, None) for s in skeys]
        tags, aggregated = executor._group_tags(sps)
        ts_out = grid[mask]
        est_out = est_g[mask]
        err = np.maximum(hi_g[mask] - est_out, est_out - lo_g[mask])
        if len(err):
            max_abs = max(max_abs, float(err.max()))
            denom = np.maximum(np.abs(est_out), 1e-12)
            max_rel = max(max_rel, float((err / denom).max()))
        results.append(QueryResult(spec.metric, tags, aggregated,
                                   ts_out, est_out.astype(np.float64)))
    return results, max_abs, max_rel


def _on_grid(grid, bts, vals, interp):
    """One series' rail evaluated on the union grid: exact at its own
    buckets, interpolated inside [first, last] per the group gap
    policy, nan outside (no contribution) — the exact group stage's
    participation rules."""
    out = np.full(len(grid), np.nan)
    idx = np.searchsorted(bts, grid)
    exact = (idx < len(bts)) & (bts[np.minimum(idx, len(bts) - 1)]
                                == grid)
    out[exact] = vals[np.searchsorted(bts, grid[exact])]
    if interp == "none" or len(bts) < 2:
        return out
    inside = (grid > bts[0]) & (grid < bts[-1]) & ~exact
    if not inside.any():
        return out
    if interp == "lerp":
        out[inside] = np.interp(grid[inside], bts, vals)
    else:  # step-hold
        j = np.searchsorted(bts, grid[inside], side="right") - 1
        out[inside] = vals[np.clip(j, 0, len(bts) - 1)]
    return out


def _agg_reduce_cols(M: np.ndarray, agg) -> np.ndarray:
    """Column-wise group reduction over a [S, G] rail matrix (nan =
    series not contributing at that bucket), one numpy pass for the
    whole grid."""
    if agg.kind == "percentile":
        return np.nanquantile(M, agg.quantile, axis=0)
    name = agg.name
    if name in ("sum", "zimsum"):
        return np.nansum(M, axis=0)
    if name in ("min", "mimmin"):
        return np.nanmin(M, axis=0)
    if name in ("max", "mimmax"):
        return np.nanmax(M, axis=0)
    if name == "avg":
        return np.nanmean(M, axis=0)
    if name == "count":
        return (~np.isnan(M)).sum(axis=0).astype(np.float64)
    raise ValueError(f"non-monotone group aggregator: {name}")
