"""Numpy float64 oracle for query math — exact reference semantics.

Mirrors ``opentsdb_tpu/ops/oracle.py`` of the JAX package, copied rather
than imported: the port imports nothing of that package.

Every kernel in ops/kernels.py must agree with these functions (to float32
tolerance). Semantics pinned here, with reference citations:

- Downsampling (reference Span.DownsamplingIterator :309-430): two modes.
  'legacy' reproduces 1.1 behavior — data-driven windows [t_first,
  t_first + interval) where t_first is the first point not in a previous
  window; 'aligned' uses epoch-aligned buckets (ts - ts % interval), the
  XLA-friendly mode (and what OpenTSDB 2.x standardized on). In both modes
  the emitted timestamp is the integer mean of member timestamps, unless
  bucket_ts='start' (aligned mode only) which emits the bucket start —
  making grids identical across series so group-agg needs no interpolation.
- Group aggregation (reference SpanGroup.SGIterator :370-796): emit at the
  union of member timestamps clipped to [start, end]; a span contributes
  its exact value at its own timestamps, a linear interpolation between its
  surrounding points elsewhere, and nothing outside [first, last] of its
  own points.
- Rate (reference :736-784): per span, (v_i - v_{i-1}) / (t_i - t_{i-1})
  emitted at t_i, step-held between points at aggregation time. The
  reference's bogus first-point rate (prev initialized to 0@0, yielding
  y0/x0) is deliberately NOT reproduced — rates start at each span's
  second point, as OpenTSDB 2.x fixed it.
- Aggregators (reference Aggregators.java): sum, min, max, avg,
  dev = population standard deviation (Welford, sqrt(M2/n), :196-243).
- Integer aggregation truncates toward zero at the end (runLong returns
  long); the oracle returns float64 and lets callers truncate.
"""

from __future__ import annotations

import numpy as np

from opentsdb_tpu_torch.core.const import NOLERP_AGGS

AGGS = ("sum", "min", "max", "avg", "dev", "count")


def agg_reduce(values: np.ndarray, agg: str) -> float:
    """Aggregate a 1-D array per the reference aggregator semantics.

    Percentile aggregators are named pNN / pNNN ('p50', 'p999'): numpy
    linear-interpolated quantiles.
    """
    if len(values) == 0:
        raise ValueError("empty aggregation")
    if agg == "sum":
        return float(np.sum(values))
    if agg == "min":
        return float(np.min(values))
    if agg == "max":
        return float(np.max(values))
    if agg == "avg":
        return float(np.mean(values))
    if agg == "dev":
        if len(values) == 1:
            return 0.0
        return float(np.sqrt(np.var(values)))  # population (M2/n)
    if agg == "count":
        return float(len(values))
    if agg in NOLERP_AGGS:
        # The interpolation-free family reduces like its base op; the
        # difference is purely which values reach it (interp='none').
        return agg_reduce(values, NOLERP_AGGS[agg])
    if len(agg) > 1 and agg[0] == "p" and agg[1:].isdigit():
        q = int(agg[1:]) / 10 ** len(agg[1:])
        return float(np.quantile(values, q))
    raise ValueError(f"unknown aggregator: {agg}")


# ---------------------------------------------------------------------------
# Downsampling
# ---------------------------------------------------------------------------

def downsample(timestamps: np.ndarray, values: np.ndarray, interval: int,
               agg: str, mode: str = "aligned", bucket_ts: str = "avg",
               ) -> tuple[np.ndarray, np.ndarray]:
    """Downsample one sorted series; returns (bucket_ts, bucket_values)."""
    ts = np.asarray(timestamps, dtype=np.int64)
    vals = np.asarray(values, dtype=np.float64)
    if len(ts) == 0:
        return ts.copy(), vals.copy()
    if mode == "aligned":
        starts = ts - ts % interval
        bounds = np.flatnonzero(np.diff(starts)) + 1
    elif mode == "legacy":
        # Data-driven windows: each bucket spans [first_ts, first_ts + iv).
        bounds = []
        i = 0
        n = len(ts)
        while i < n:
            end = ts[i] + interval
            j = i + 1
            while j < n and ts[j] < end:
                j += 1
            if j < n:
                bounds.append(j)
            i = j
        bounds = np.array(bounds, dtype=np.int64)
    else:
        raise ValueError(f"unknown downsample mode: {mode}")
    groups = np.split(np.arange(len(ts)), bounds)
    out_ts = np.empty(len(groups), dtype=np.int64)
    out_v = np.empty(len(groups), dtype=np.float64)
    for k, idx in enumerate(groups):
        if bucket_ts == "avg":
            out_ts[k] = int(np.sum(ts[idx])) // len(idx)  # integer mean
        elif bucket_ts == "start":
            if mode != "aligned":
                raise ValueError("bucket_ts='start' requires aligned mode")
            out_ts[k] = ts[idx[0]] - ts[idx[0]] % interval
        else:
            raise ValueError(f"unknown bucket_ts: {bucket_ts}")
        out_v[k] = agg_reduce(vals[idx], agg)
    return out_ts, out_v


# ---------------------------------------------------------------------------
# Rate
# ---------------------------------------------------------------------------

def rate(timestamps: np.ndarray, values: np.ndarray,
         counter_max: float | None = None, reset_value: float | None = None,
         ) -> tuple[np.ndarray, np.ndarray]:
    """Per-point rate of change, emitted at the later point of each pair.

    ``counter_max`` enables monotonic-counter rollover correction (a 2.x
    capability): a negative delta is treated as a wrap at counter_max;
    ``reset_value`` zeroes rates whose magnitude exceeds it (counter reset).
    """
    ts = np.asarray(timestamps, dtype=np.int64)
    vals = np.asarray(values, dtype=np.float64)
    if len(ts) < 2:
        return ts[:0], vals[:0]
    dt = np.diff(ts).astype(np.float64)
    dv = np.diff(vals)
    if counter_max is not None:
        dv = np.where(dv < 0, dv + counter_max, dv)
    r = dv / dt
    if reset_value is not None:
        r = np.where(np.abs(r) > reset_value, 0.0, r)
    return ts[1:], r


# ---------------------------------------------------------------------------
# Group aggregation with linear interpolation
# ---------------------------------------------------------------------------

def group_aggregate(series: list[tuple[np.ndarray, np.ndarray]], agg: str,
                    start: int | None = None, end: int | None = None,
                    interp: str = "lerp",
                    ) -> tuple[np.ndarray, np.ndarray]:
    """Aggregate spans on the union of their timestamps, interpolating gaps.

    ``series`` is a list of (sorted_ts, values). ``interp``: 'lerp' (normal
    aggregation) or 'step' (last-value hold, used for rates). A span
    contributes only inside [its first ts, its last ts]. Returns
    (grid_ts, aggregated values).
    """
    filtered = []
    for ts, vals in series:
        ts = np.asarray(ts, dtype=np.int64)
        vals = np.asarray(vals, dtype=np.float64)
        if start is not None or end is not None:
            m = np.ones(len(ts), dtype=bool)
            if start is not None:
                m &= ts >= start
            if end is not None:
                m &= ts <= end
            ts, vals = ts[m], vals[m]
        if len(ts):
            filtered.append((ts, vals))
    if not filtered:
        return (np.empty(0, dtype=np.int64), np.empty(0, dtype=np.float64))
    grid = np.unique(np.concatenate([ts for ts, _ in filtered]))
    contrib = np.full((len(filtered), len(grid)), np.nan)
    for s, (ts, vals) in enumerate(filtered):
        in_range = (grid >= ts[0]) & (grid <= ts[-1])
        x = grid[in_range]
        if interp == "lerp":
            contrib[s, in_range] = np.interp(x, ts, vals)
        elif interp == "step":
            idx = np.searchsorted(ts, x, side="right") - 1
            contrib[s, in_range] = vals[idx]
        elif interp == "none":
            # zimsum/mimmin/mimmax family: contribute only at own samples.
            idx = np.searchsorted(ts, x)
            exact = ts[np.minimum(idx, len(ts) - 1)] == x
            sub = np.full(len(x), np.nan)
            sub[exact] = vals[idx[exact]]
            contrib[s, in_range] = sub
        else:
            raise ValueError(f"unknown interp: {interp}")
    out = np.empty(len(grid), dtype=np.float64)
    for g in range(len(grid)):
        out[g] = agg_reduce(contrib[:, g][~np.isnan(contrib[:, g])], agg)
    return grid, out
