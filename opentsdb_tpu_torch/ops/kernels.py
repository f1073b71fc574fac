"""The downsample + group-by core of the query path, in PyTorch.

Mirrors the scan-path half of ``opentsdb_tpu/ops/kernels.py``:
``_segment_moments``, ``_finish``, ``gap_fill``, ``bucket_rate``,
``step_fill``, ``group_moments``, ``_group_stage``, ``_series_stage``,
``downsample_group`` and ``downsample_multigroup``, with the same
arguments, padding and results. Every segment sum, min and max goes
through the port's own kernels (``ops/segment_reduce.py``); the rest is
plain tensor code on whatever device the inputs lie on.

Layout, as in the JAX package: all points of a query in one flat [N]
stream with a parallel [N] series id; timestamps are int32 offsets from
the query's bucket-aligned start, values float32, and bucket mean
timestamps are summed relative to each bucket start so float32 stays
exact. Ids and bucket indices stay int32 at these functions and widen to
int64 only where torch indexing asks for it.

Contract against the JAX kernels (``query/executor.py``): masks, grids
and member timestamps bit-identical; count, min and max exact; float32
sums, means and deviations within float32 tolerance, because the
segment sums add in another order (on the card, in a run-dependent one).
"""

from __future__ import annotations

import torch

from opentsdb_tpu_torch.core.const import NOLERP_AGGS
from opentsdb_tpu_torch.ops.segment_reduce import segment_minmax, segment_sum

_NEG_INF = float("-inf")
_POS_INF = float("inf")
_I32_BIG = 2**31 - 1

# Which per-segment statistics each aggregator's _finish needs; count is
# always computed (it doubles as the bucket-nonempty mask).
_AGG_NEEDS = {"sum": frozenset({"sum"}), "min": frozenset({"min"}),
              "max": frozenset({"max"}), "avg": frozenset({"sum"}),
              "dev": frozenset({"sum", "m2"}),
              "count": frozenset()}


def _needs(agg: str) -> frozenset:
    return _AGG_NEEDS[NOLERP_AGGS.get(agg, agg)]


def _segment_moments(vals: torch.Tensor, seg: torch.Tensor,
                     valid: torch.Tensor, num_segments: int,
                     extra: torch.Tensor | None = None,
                     need: frozenset = frozenset({"sum", "m2", "min",
                                                  "max"})):
    """Per-segment count, sum, centered M2, min, max over masked points.

    Count, value sum and ``extra`` (bucket-relative timestamps from
    _series_stage) ride ONE stacked segment_sum of K = 2-3 features; the
    centered M2 (two-pass: mean first, then sum((x - mean)^2), which does
    not cancel in float32 the way E[x^2] - E[x]^2 does) is a second K = 1
    pass. Un-needed statistics return None."""
    cols = [valid.to(torch.float32)]
    with_sum = "sum" in need or "m2" in need
    if with_sum:
        cols.append(torch.where(valid, vals, 0.0))
    if extra is not None:
        cols.append(torch.where(valid, extra, 0.0))
    sums = segment_sum(torch.stack(cols, dim=1), seg, num_segments)
    count = sums[:, 0]
    total = sums[:, 1] if with_sum else None
    m2 = mn = mx = None
    if "m2" in need:
        mean = total / torch.clamp(count, min=1.0)
        centered = torch.where(valid, vals - mean[seg.long()], 0.0)
        m2 = segment_sum((centered * centered)[:, None], seg,
                         num_segments)[:, 0]
    if "min" in need:
        mn = segment_minmax(torch.where(valid, vals, _POS_INF)[:, None],
                            seg, num_segments)[0][:, 0]
    if "max" in need:
        mx = segment_minmax(torch.where(valid, vals, _NEG_INF)[:, None],
                            seg, num_segments)[1][:, 0]
    if extra is not None:
        return count, total, m2, mn, mx, sums[:, -1]
    return count, total, m2, mn, mx


def _finish(agg: str, count, total, m2, mn, mx):
    """Combine segment moments (m2 = centered sum of squares) into the agg."""
    agg = NOLERP_AGGS.get(agg, agg)  # same reduction, different feed
    safe = torch.clamp(count, min=1.0)
    if agg == "sum":
        return total
    if agg == "min":
        return mn
    if agg == "max":
        return mx
    if agg == "avg":
        return total / safe
    if agg == "dev":
        return torch.sqrt(torch.clamp(m2, min=0.0) / safe)
    if agg == "count":
        return count
    raise ValueError(f"unknown aggregator: {agg}")


def _cummin_reverse(x: torch.Tensor) -> torch.Tensor:
    return torch.flip(torch.cummin(torch.flip(x, (1,)), dim=1).values, (1,))


def _bucket_index(series_mask: torch.Tensor, num_buckets: int):
    """Each bucket's nearest nonempty bucket at or before it (-1 = none)
    and at or after it (num_buckets = none)."""
    b_idx = torch.arange(num_buckets, dtype=torch.int32,
                         device=series_mask.device)
    prev_loc = torch.cummax(
        torch.where(series_mask, b_idx[None, :], -1), dim=1).values
    next_loc = _cummin_reverse(
        torch.where(series_mask, b_idx[None, :], num_buckets))
    return b_idx, prev_loc, next_loc


def _take(values: torch.Tensor, idx: torch.Tensor,
          num_buckets: int) -> torch.Tensor:
    """take_along_axis(values, clip(idx, 0, B-1), axis=1)."""
    return torch.gather(values, 1,
                        torch.clamp(idx, 0, num_buckets - 1).long())


def gap_fill(series_values: torch.Tensor, series_mask: torch.Tensor,
             num_buckets: int):
    """Lerp-fill each series' empty buckets between its nonempty ones.

    A series with an empty bucket between two nonempty ones contributes a
    linear interpolation (the reference lerps missing samples at group
    time, SpanGroup.java:702-784); outside its first/last nonempty bucket
    it contributes nothing. Bucket starts are affine in the bucket index,
    so lerping in index space equals lerping in time space.

    Returns (filled [S, B], in_range [S, B]); filled is 0 outside range.
    """
    b_idx, prev_loc, next_loc = _bucket_index(series_mask, num_buckets)
    has_prev = prev_loc >= 0
    has_next = next_loc < num_buckets
    y0 = _take(series_values, prev_loc, num_buckets)
    y1 = _take(series_values, next_loc, num_buckets)
    prev_idx = torch.where(has_prev, prev_loc, -1)
    next_idx = torch.where(has_next, next_loc, _I32_BIG)
    in_range = (prev_idx >= 0) & (next_idx < _I32_BIG)
    dx = torch.clamp((next_idx - prev_idx).to(torch.float32), min=1.0)
    frac = (b_idx[None, :] - prev_idx).to(torch.float32) / dx
    filled = torch.where(series_mask, series_values, y0 + frac * (y1 - y0))
    return torch.where(in_range, filled, 0.0), in_range


def bucket_rate(series_values: torch.Tensor, series_mask: torch.Tensor,
                interval: int, counter_max: float = 0.0,
                reset_value: float = 0.0, *, counter: bool = False,
                drop_resets: bool = False):
    """Per-series rate of change on the shared bucket grid.

    Each nonempty bucket's rate is its backward difference against the
    series' previous nonempty bucket (bucket-start timestamps, so
    dt = (b - prev_b) * interval) — the downsample-then-rate composition
    of the reference (SpanGroup.java:736-784). The first nonempty bucket
    of a series yields no rate, matching oracle.rate.

    Returns (rates [S, B] float32, ok [S, B] bool).
    """
    S, B = series_values.shape
    b_idx = torch.arange(B, dtype=torch.int32, device=series_values.device)
    prev_incl = torch.cummax(
        torch.where(series_mask, b_idx[None, :], -1), dim=1).values
    prev_excl = torch.cat(
        [torch.full((S, 1), -1, dtype=torch.int32,
                    device=series_values.device), prev_incl[:, :-1]], dim=1)
    has_prev = prev_excl >= 0
    prev_val = _take(series_values, prev_excl, B)
    dt = torch.clamp((b_idx[None, :] - prev_excl).to(torch.float32)
                     * interval, min=1e-9)
    dv = series_values - prev_val
    if counter:
        dv = torch.where(dv < 0, dv + counter_max, dv)
    r = dv / dt
    if drop_resets:
        r = torch.where(torch.abs(r) > reset_value, 0.0, r)
    ok = series_mask & has_prev
    return torch.where(ok, r, 0.0), ok


def step_fill(series_values: torch.Tensor, series_mask: torch.Tensor,
              num_buckets: int):
    """Last-value-hold fill of empty buckets (the rate counterpart of
    gap_fill: rates step between points, SpanGroup.java:736-784 /
    oracle.group_aggregate(interp='step')). A series contributes its
    previous bucket's value in empty buckets between its first and last
    nonempty ones, nothing outside. Returns (filled [S, B], in_range)."""
    _, prev_loc, next_loc = _bucket_index(series_mask, num_buckets)
    in_range = (prev_loc >= 0) & (next_loc < num_buckets)
    y0 = _take(series_values, prev_loc, num_buckets)
    filled = torch.where(series_mask, series_values, y0)
    return torch.where(in_range, filled, 0.0), in_range


def group_moments(filled: torch.Tensor, in_range: torch.Tensor):
    """Masked per-bucket moments across series (axis 0): count, total,
    centered M2, mean, min, max."""
    n = in_range.to(torch.float32).sum(dim=0)
    total = torch.where(in_range, filled, 0.0).sum(dim=0)
    mean = total / torch.clamp(n, min=1.0)
    centered = torch.where(in_range, filled - mean[None, :], 0.0)
    m2 = (centered * centered).sum(dim=0)
    mn = torch.where(in_range, filled, _POS_INF).amin(dim=0)
    mx = torch.where(in_range, filled, _NEG_INF).amax(dim=0)
    return n, total, m2, mean, mn, mx


def _group_stage(filled, in_range, series_mask, gmap, *, num_groups,
                 agg_group):
    """Cross-series aggregation of a (filled, masked) [S, B] grid into
    [G, B]: segment reductions of whole [S, B] rows by ``gmap`` [S]
    (K = B features per series; never a flat S*B scatter). Count, value
    sum and the any-real-bucket mask ride one K = 3B call."""
    if num_groups == 1:
        g_count, g_total, g_m2, _, g_mn, g_mx = group_moments(
            filled, in_range)
        gv = _finish(agg_group, g_count, g_total, g_m2, g_mn, g_mx)[None]
        gm = series_mask.any(dim=0)[None]
        return gv, gm
    need = _needs(agg_group)
    B = filled.shape[1]
    v = torch.where(in_range, filled, 0.0)
    sums = segment_sum(
        torch.cat([in_range.to(torch.float32), v,
                   series_mask.to(torch.float32)], dim=1), gmap, num_groups)
    g_count, g_total, g_real = sums[:, :B], sums[:, B:2 * B], sums[:, 2 * B:]
    g_m2 = g_mn = g_mx = None
    if "m2" in need:
        g_mean = g_total / torch.clamp(g_count, min=1.0)
        centered = torch.where(in_range, filled - g_mean[gmap.long()], 0.0)
        g_m2 = segment_sum(centered * centered, gmap, num_groups)
    if "min" in need:
        g_mn = segment_minmax(torch.where(in_range, filled, _POS_INF),
                              gmap, num_groups)[0]
    if "max" in need:
        g_mx = segment_minmax(torch.where(in_range, filled, _NEG_INF),
                              gmap, num_groups)[1]
    gv = _finish(agg_group, g_count, g_total, g_m2, g_mn, g_mx)
    return gv, g_real > 0


def _series_stage(ts, vals, sid, valid, *, num_series, num_buckets,
                  interval, agg_down, with_ts: bool):
    """Shared per-(series, bucket) downsample stage: one segment
    reduction pass producing series_values/series_mask [S, B] (and, when
    ``with_ts``, per-bucket integer-mean member timestamps). Invalid
    points go to an in-range trash segment S*B that is sliced off."""
    bucket = torch.clamp(torch.div(ts, interval, rounding_mode="floor"),
                         0, num_buckets - 1)
    seg = torch.where(valid, sid * num_buckets + bucket,
                      num_series * num_buckets).to(torch.int32)
    nseg = num_series * num_buckets + 1  # +1 trash segment for padding
    need = _needs(agg_down)
    shape = (num_series, num_buckets)
    if with_ts:
        # Mean member timestamp rides the same reduction pass, relative
        # to bucket start for float32 exactness.
        rel = (ts - bucket * interval).to(torch.float32)
        count, total, m2, mn, mx, rel_sum = _segment_moments(
            vals, seg, valid, nseg, extra=rel, need=need)
    else:
        count, total, m2, mn, mx = _segment_moments(
            vals, seg, valid, nseg, need=need)
    per = _finish(agg_down, count, total, m2, mn, mx)
    series_values = per[:-1].reshape(shape)
    series_mask = count[:-1].reshape(shape) > 0
    if not with_ts:
        return series_values, series_mask, None
    mean_rel = torch.floor(rel_sum / torch.clamp(count, min=1.0))
    bucket_starts = torch.arange(num_buckets, dtype=torch.int32,
                                 device=ts.device) * interval
    series_ts = bucket_starts[None, :] + mean_rel[:-1].reshape(shape) \
        .to(torch.int32)
    return series_values, series_mask, series_ts


def _fill(series_values, series_mask, num_buckets, agg_group, rate):
    """The group stage's gap policy: the no-lerp family contributes only
    real buckets; rates step-hold; plain values lerp."""
    if agg_group in NOLERP_AGGS:
        return series_values, series_mask
    if rate:
        return step_fill(series_values, series_mask, num_buckets)
    return gap_fill(series_values, series_mask, num_buckets)


def downsample_group(ts: torch.Tensor, vals: torch.Tensor,
                     sid: torch.Tensor, valid: torch.Tensor, *,
                     num_series: int, num_buckets: int, interval: int,
                     agg_down: str, agg_group: str, rate: bool = False,
                     counter_max: float = 0.0, reset_value: float = 0.0,
                     counter: bool = False, drop_resets: bool = False):
    """Downsample every series into aligned buckets, then aggregate across
    series.

    Args:
      ts:    [N] int32 offsets from the query start (bucket-aligned base).
      vals:  [N] float32 point values.
      sid:   [N] int32 series index in [0, num_series).
      valid: [N] bool padding mask.
      interval: bucket width (seconds); num_buckets: bucket count
        covering the query range.

    Returns dict with:
      series_values [S, B] per-series downsampled buckets,
      series_ts     [S, B] int32 mean member-timestamp offset per bucket,
      series_mask   [S, B] bool bucket-nonempty mask,
      presence      [S] bool series has a point (before rate),
      group_values  [B] cross-series aggregate (over nonempty buckets),
      group_mask    [B] bool.

    ``rate=True`` inserts the rate stage between downsample and group
    (reference pipeline order, SpanGroup.java:736-784): series_values and
    series_mask become the per-bucket rates and their validity, and the
    group stage step-fills instead of lerping.
    """
    series_values, series_mask, series_ts = _series_stage(
        ts, vals, sid, valid, num_series=num_series,
        num_buckets=num_buckets, interval=interval, agg_down=agg_down,
        with_ts=True)
    presence = series_mask.any(dim=1)
    if rate:
        series_values, series_mask = bucket_rate(
            series_values, series_mask, interval, counter_max,
            reset_value, counter=counter, drop_resets=drop_resets)
    filled, in_range = _fill(series_values, series_mask, num_buckets,
                             agg_group, rate)
    g_count, g_total, g_m2, _, g_mn, g_mx = group_moments(filled, in_range)
    return {
        "series_values": series_values,
        "series_ts": series_ts,
        "series_mask": series_mask,
        "presence": presence,
        "group_values": _finish(agg_group, g_count, g_total, g_m2, g_mn,
                                g_mx),
        # Emit only buckets where some series has a real point (with
        # rate: a real rate); filled contributions never create points.
        "group_mask": series_mask.any(dim=0),
    }


def downsample_multigroup(ts: torch.Tensor, vals: torch.Tensor,
                          sid: torch.Tensor, valid: torch.Tensor,
                          group_of_sid: torch.Tensor, *, num_series: int,
                          num_groups: int, num_buckets: int, interval: int,
                          agg_down: str, agg_group: str,
                          rate: bool = False, counter_max: float = 0.0,
                          reset_value: float = 0.0, counter: bool = False,
                          drop_resets: bool = False):
    """Downsample + group-by for MANY group-by buckets in one call: the
    per-(series, bucket) stage, then per-(group, bucket) moments with
    ``group_of_sid`` [S] int32 mapping each series to its group in
    [0, num_groups). Returns dict with group_values / group_mask [G, B];
    per group, identical to downsample_group on that group's series."""
    series_values, series_mask, _ = _series_stage(
        ts, vals, sid, valid, num_series=num_series,
        num_buckets=num_buckets, interval=interval, agg_down=agg_down,
        with_ts=False)
    presence = series_mask.any(dim=1)
    if rate:
        series_values, series_mask = bucket_rate(
            series_values, series_mask, interval, counter_max,
            reset_value, counter=counter, drop_resets=drop_resets)
    filled, in_range = _fill(series_values, series_mask, num_buckets,
                             agg_group, rate)
    group_values, group_mask = _group_stage(
        filled, in_range, series_mask, group_of_sid,
        num_groups=num_groups, agg_group=agg_group)
    return {
        "group_values": group_values,
        "group_mask": group_mask,
        "series_values": series_values,
        "series_mask": series_mask,
        "presence": presence,
    }
