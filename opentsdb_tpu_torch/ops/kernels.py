"""The downsample + group-by core of the query path, in PyTorch.

Mirrors two halves of ``opentsdb_tpu/ops/kernels.py``, with the same
names, arguments, padding and results:

- the scan path: ``_segment_moments``, ``_finish``, ``gap_fill``,
  ``bucket_rate``, ``step_fill``, ``group_moments``, ``_group_stage``,
  ``_series_stage``, ``downsample_group`` and ``downsample_multigroup``;
- the resident-window path (``storage/devstore.py``), over the window's
  chunk list: ``_chunk_fold``, ``_chunk_stage_finish``,
  ``window_series_stage_chunks``, ``_shrink_wrap``,
  ``window_moment_apply`` and ``window_quantile_apply``;
- the window stage over one concatenated point stream,
  ``_window_series_stage``, which the fused block plan
  (``compress/kernels.py``) runs, and ``_stage_tail``, the fill both
  stages share. The JAX package's jitted wrappers of it
  (``window_series_stage``, ``window_query``) have no caller here;
- percentile group aggregation: ``_order_key``, ``_key_to_float``,
  ``masked_quantile_axis0``, ``masked_quantile_groups`` and
  ``downsample_multigroup_quantile``;
- the un-downsampled (union-grid) path: ``flat_rate``, ``union_grid``,
  ``series_contributions`` and ``group_interpolate``.

``gap_fill``, ``bucket_rate``, ``step_fill`` and ``flat_rate`` take the
JAX package's carry arguments, which the time-sharded path
(``parallel/timeshard.py``) passes; called without them, each computes
what it computes without a mesh.

Every segment sum, min and max goes through the port's own kernels
(``ops/segment_reduce.py``), every quantile through the rank-select kernel
(``ops/masked_select.py``) and every union-grid moment reduction through
the interpolate-and-reduce kernel (``ops/interp_moments.py``); the rest is
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
from opentsdb_tpu_torch.ops import masked_select
from opentsdb_tpu_torch.ops.interp_moments import (interp_moments,
                                                   series_contributions)
from opentsdb_tpu_torch.ops.masked_select import GroupLayout, group_layout
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
                            seg, num_segments, need="min")[:, 0]
    if "max" in need:
        mx = segment_minmax(torch.where(valid, vals, _NEG_INF)[:, None],
                            seg, num_segments, need="max")[:, 0]
    if extra is not None:
        return count, total, m2, mn, mx, sums[:, -1]
    return count, total, m2, mn, mx


def _finish(agg: str, count, total, m2, mn, mx):
    """Combine segment moments (m2 = centered sum of squares) into the agg."""
    agg = NOLERP_AGGS.get(agg, agg)  # same reduction, different feed
    if agg == "sum":
        return total
    if agg == "min":
        return mn
    if agg == "max":
        return mx
    if agg == "avg":
        return total / torch.clamp(count, min=1.0)
    if agg == "dev":
        return torch.sqrt(torch.clamp(m2, min=0.0)
                          / torch.clamp(count, min=1.0))
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
             num_buckets: int, *, glob_offset=0, left_idx=None,
             left_val=None, right_idx=None, right_val=None):
    """Lerp-fill each series' empty buckets between its nonempty ones.

    A series with an empty bucket between two nonempty ones contributes a
    linear interpolation (the reference lerps missing samples at group
    time, SpanGroup.java:702-784); outside its first/last nonempty bucket
    it contributes nothing. Bucket starts are affine in the bucket index,
    so lerping in index space equals lerping in time space.

    The optional carries serve the time-sharded path
    (``parallel/timeshard.py``), where this tile's buckets are the window
    ``[glob_offset, glob_offset + num_buckets)`` of a larger grid:
    ``left_idx``/``left_val`` [S] give the nearest nonempty global bucket
    before the window (-1 = none), ``right_idx``/``right_val`` the
    nearest after (2^31-1 = none); rows with no local prev/next fall back
    to them, so a cross-tile lerp equals the unsharded fill.

    Returns (filled [S, B], in_range [S, B]); filled is 0 outside range.
    """
    b_idx, prev_loc, next_loc = _bucket_index(series_mask, num_buckets)
    has_prev = prev_loc >= 0
    has_next = next_loc < num_buckets
    y0 = _take(series_values, prev_loc, num_buckets)
    y1 = _take(series_values, next_loc, num_buckets)
    if left_idx is None:
        prev_idx = torch.where(has_prev, glob_offset + prev_loc, -1)
        prev_val = y0
    else:
        prev_idx = torch.where(has_prev, glob_offset + prev_loc,
                               left_idx[:, None])
        prev_val = torch.where(has_prev, y0, left_val[:, None])
    if right_idx is None:
        next_idx = torch.where(has_next, glob_offset + next_loc, _I32_BIG)
        next_val = y1
    else:
        next_idx = torch.where(has_next, glob_offset + next_loc,
                               right_idx[:, None])
        next_val = torch.where(has_next, y1, right_val[:, None])
    in_range = (prev_idx >= 0) & (next_idx < _I32_BIG)
    dx = torch.clamp((next_idx - prev_idx).to(torch.float32), min=1.0)
    frac = (glob_offset + b_idx[None, :] - prev_idx).to(torch.float32) / dx
    filled = torch.where(series_mask, series_values,
                         prev_val + frac * (next_val - prev_val))
    return torch.where(in_range, filled, 0.0), in_range


def bucket_rate(series_values: torch.Tensor, series_mask: torch.Tensor,
                interval: int, counter_max: float = 0.0,
                reset_value: float = 0.0, *, counter: bool = False,
                drop_resets: bool = False, glob_offset=0, left_idx=None,
                left_val=None):
    """Per-series rate of change on the shared bucket grid.

    Each nonempty bucket's rate is its backward difference against the
    series' previous nonempty bucket (bucket-start timestamps, so
    dt = (b - prev_b) * interval) — the downsample-then-rate composition
    of the reference (SpanGroup.java:736-784). The first nonempty bucket
    of a series yields no rate, matching oracle.rate.

    The optional carries serve the time-sharded path: ``left_idx`` [S] is
    the series' nearest nonempty global bucket before this tile's window
    (-1 = none) and ``left_val`` its value; a tile-first bucket
    differences against it instead of having no predecessor.
    ``glob_offset`` maps local bucket indices to global ones.

    Returns (rates [S, B] float32, ok [S, B] bool).
    """
    S, B = series_values.shape
    b_idx = torch.arange(B, dtype=torch.int32, device=series_values.device)
    prev_incl = torch.cummax(
        torch.where(series_mask, b_idx[None, :], -1), dim=1).values
    prev_excl = torch.cat(
        [torch.full((S, 1), -1, dtype=torch.int32,
                    device=series_values.device), prev_incl[:, :-1]], dim=1)
    has_local = prev_excl >= 0
    prev_val = _take(series_values, prev_excl, B)
    prev_glob = glob_offset + prev_excl
    if left_idx is not None:
        use_carry = ~has_local & (left_idx[:, None] >= 0)
        prev_glob = torch.where(use_carry, left_idx[:, None], prev_glob)
        prev_val = torch.where(use_carry, left_val[:, None], prev_val)
        has_prev = has_local | use_carry
    else:
        has_prev = has_local
    glob = glob_offset + b_idx[None, :]
    dt = torch.clamp((glob - prev_glob).to(torch.float32) * interval,
                     min=1e-9)
    dv = series_values - prev_val
    if counter:
        dv = torch.where(dv < 0, dv + counter_max, dv)
    r = dv / dt
    if drop_resets:
        r = torch.where(torch.abs(r) > reset_value, 0.0, r)
    ok = series_mask & has_prev
    return torch.where(ok, r, 0.0), ok


def step_fill(series_values: torch.Tensor, series_mask: torch.Tensor,
              num_buckets: int, *, left_idx=None, left_val=None,
              right_idx=None):
    """Last-value-hold fill of empty buckets (the rate counterpart of
    gap_fill: rates step between points, SpanGroup.java:736-784 /
    oracle.group_aggregate(interp='step')). A series contributes its
    previous bucket's value in empty buckets between its first and last
    nonempty ones, nothing outside.

    The carries serve the time-sharded path; a step hold needs only
    presence and the left value: ``left_idx`` [S] >= 0 means the series
    has a nonempty bucket on an earlier tile, of value ``left_val``;
    ``right_idx`` [S] < 2^31-1 means one exists on a later tile.
    Returns (filled [S, B], in_range)."""
    _, prev_loc, next_loc = _bucket_index(series_mask, num_buckets)
    has_prev = prev_loc >= 0
    has_next = next_loc < num_buckets
    y0 = _take(series_values, prev_loc, num_buckets)
    if left_idx is None:
        prev_ok, prev_val = has_prev, y0
    else:
        prev_ok = has_prev | (left_idx[:, None] >= 0)
        prev_val = torch.where(has_prev, y0, left_val[:, None])
    next_ok = (has_next if right_idx is None
               else has_next | (right_idx[:, None] < _I32_BIG))
    in_range = prev_ok & next_ok
    filled = torch.where(series_mask, series_values, prev_val)
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
                              gmap, num_groups, need="min")
    if "max" in need:
        g_mx = segment_minmax(torch.where(in_range, filled, _NEG_INF),
                              gmap, num_groups, need="max")
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


# ---------------------------------------------------------------------------
# Percentile group aggregation
# ---------------------------------------------------------------------------

def _order_key(vals: torch.Tensor) -> torch.Tensor:
    """Monotone f32 -> uint32 mapping (IEEE total order): x < y iff
    key(x) < key(y); int64 values in [0, 2^32) (see
    ``masked_select.order_key``)."""
    return masked_select.order_key(vals)


def _key_to_float(key: torch.Tensor) -> torch.Tensor:
    """Inverse of _order_key."""
    return masked_select.key_to_float(key)


def masked_quantile_axis0(vals: torch.Tensor, mask: torch.Tensor, q):
    """Per-column quantiles across series (axis 0) with a validity mask:
    numpy's linear interpolation at position (n-1)*q between the sorted
    valid values of each column; a column with no valid entry gives 0.
    ``q`` is [K]; returns [K, B]. The selected values are exact rank
    statistics (the rank-select kernel, ``ops/masked_select.py``)."""
    return masked_select.select_columns(vals, mask, q)


def masked_quantile_groups(vals: torch.Tensor, mask: torch.Tensor,
                           gmap: torch.Tensor, q, *, num_groups: int,
                           layout: GroupLayout | None = None):
    """Per-(group, bucket) quantiles across member series, all groups in
    one call; ``gmap`` [S] maps each row to its group, and per group the
    semantics are masked_quantile_axis0's on that group's rows alone.
    ``layout`` is ``group_layout(gmap, num_groups)`` when the caller keeps
    one (built on the host otherwise). Returns [K, G, B]."""
    if layout is None:
        layout = group_layout(gmap, num_groups, vals.device)
    return masked_select.select_groups(vals, mask, layout, q)


def downsample_multigroup_quantile(
        ts: torch.Tensor, vals: torch.Tensor, sid: torch.Tensor,
        valid: torch.Tensor, group_of_sid: torch.Tensor, q, *,
        num_series: int, num_groups: int, num_buckets: int, interval: int,
        agg_down: str, rate: bool = False, counter_max: float = 0.0,
        reset_value: float = 0.0, counter: bool = False,
        drop_resets: bool = False, layout: GroupLayout | None = None):
    """Downsample [+ rate] + per-group PERCENTILE aggregation for many
    group-by buckets in one call (the percentile sibling of
    downsample_multigroup): series stage, optional bucket rates, gap or
    step fill between each series' real buckets, then quantile ``q[0]``
    across member series. Returns dict with group_values [G, B],
    group_mask [G, B], series_values, series_mask."""
    series_values, series_mask, _ = _series_stage(
        ts, vals, sid, valid, num_series=num_series,
        num_buckets=num_buckets, interval=interval, agg_down=agg_down,
        with_ts=False)
    if rate:
        series_values, series_mask = bucket_rate(
            series_values, series_mask, interval, counter_max,
            reset_value, counter=counter, drop_resets=drop_resets)
    fill = step_fill if rate else gap_fill
    filled, in_range = fill(series_values, series_mask, num_buckets)
    gv = masked_quantile_groups(filled, in_range, group_of_sid, q,
                                num_groups=num_groups, layout=layout)
    real = segment_sum(series_mask.to(torch.float32), group_of_sid,
                       num_groups) > 0
    return {
        "group_values": gv[0],
        "group_mask": real,
        "series_values": series_values,
        "series_mask": series_mask,
    }


# ---------------------------------------------------------------------------
# Resident-window stages (storage/devstore.py query path)
# ---------------------------------------------------------------------------

def _merge_min(acc: torch.Tensor, x: torch.Tensor) -> None:
    """acc = min(acc, x) in place, with -0.0 below +0.0 (the order of the
    segment_minmax kernel), so a chunk-by-chunk minimum equals one pass."""
    take = (x < acc) | ((x == acc) & torch.signbit(x))
    torch.where(take, x, acc, out=acc)


def _merge_max(acc: torch.Tensor, x: torch.Tensor) -> None:
    """acc = max(acc, x) in place, with +0.0 above -0.0."""
    take = (x > acc) | ((x == acc) & ~torch.signbit(x))
    torch.where(take, x, acc, out=acc)


def _chunk_fold(rel_ts, vals, sid, count, total, m2, mn, mx,
                lo, hi, shift, *, num_series, num_buckets, interval,
                need):
    """Fold ONE resident chunk into the per-(series, bucket) accumulators,
    in place (the JAX package donates them); points outside [lo, hi] go
    to the trash segment ``nseg - 1``. Accumulators ``need`` does not ask
    for may be None and stay so. Chunks hold no padding, so every point
    is valid (the JAX package's ``valid`` column has no counterpart).

    ``lo``/``hi`` bound the window-relative timestamps; ``shift`` (qbase -
    epoch) rebases them onto the query's bucket grid.

    Count and value sum ride one stacked K = 2 ``segment_sum``. ``m2``
    accumulates the exact pairwise (Chan et al.) combination: the chunk's
    M2 is centered on the CHUNK-local segment means, then corrected by
    the mean shift against the running accumulators BEFORE they take the
    chunk's count and sum. Min and max each ask ``segment_minmax`` for
    their one output. Returns (count, total, m2, mn, mx)."""
    lo, hi, shift = int(lo), int(hi), int(shift)
    nseg = num_series * num_buckets + 1
    ok = (rel_ts >= lo) & (rel_ts <= hi)
    bucket = torch.clamp(
        torch.div(rel_ts - shift, interval, rounding_mode="floor"),
        0, num_buckets - 1)
    seg = torch.where(ok, sid * num_buckets + bucket,
                      nseg - 1).to(torch.int32)
    with_sum = "sum" in need or "m2" in need
    cols = [ok.to(torch.float32)]
    if with_sum:
        cols.append(torch.where(ok, vals, 0.0))
    sums = segment_sum(torch.stack(cols, dim=1), seg, nseg)
    c_cnt = sums[:, 0]
    if "m2" in need:
        c_tot = sums[:, 1]
        c_mean = c_tot / torch.clamp(c_cnt, min=1.0)
        centered = torch.where(ok, vals - c_mean[seg.long()], 0.0)
        c_m2 = segment_sum((centered * centered)[:, None], seg,
                           nseg)[:, 0]
        a_mean = total / torch.clamp(count, min=1.0)
        tot_n = count + c_cnt
        delta = c_mean - a_mean
        corr = torch.where(tot_n > 0,
                           delta * delta * count * c_cnt
                           / torch.clamp(tot_n, min=1.0), 0.0)
        m2.add_(c_m2).add_(corr)
    count.add_(c_cnt)
    if with_sum:
        total.add_(sums[:, 1])
    if "min" in need:
        _merge_min(mn, segment_minmax(
            torch.where(ok, vals, _POS_INF)[:, None], seg, nseg,
            need="min")[:, 0])
    if "max" in need:
        _merge_max(mx, segment_minmax(
            torch.where(ok, vals, _NEG_INF)[:, None], seg, nseg,
            need="max")[:, 0])
    return count, total, m2, mn, mx


def _fold_chunks(chunks, lo, hi, shift, *, num_series, num_buckets,
                 interval, need):
    """Fresh accumulators on the chunks' device, folded chunk by chunk.
    Returns (count, total, m2, mn, mx); those ``need`` leaves out are
    None."""
    chunks = list(chunks)
    dev = chunks[0][0].device
    nseg = num_series * num_buckets + 1

    def full(fill):
        return torch.full((nseg,), fill, dtype=torch.float32, device=dev)

    with_sum = "sum" in need or "m2" in need
    acc = (full(0.0), full(0.0) if with_sum else None,
           full(0.0) if "m2" in need else None,
           full(_POS_INF) if "min" in need else None,
           full(_NEG_INF) if "max" in need else None)
    for rel_ts, vals, sid in chunks:
        acc = _chunk_fold(rel_ts, vals, sid, *acc, lo, hi, shift,
                          num_series=num_series, num_buckets=num_buckets,
                          interval=interval, need=need)
    return acc


def _window_series_stage(rel_ts, vals, sid, valid_in, lo, hi, shift, *,
                         num_series, num_buckets, interval, agg_down,
                         rate=False, counter_max=0.0, reset_value=0.0,
                         counter=False, drop_resets=False):
    """The window stage over one flat point stream: range masking +
    per-series downsample [+ rate] + the row-local fill, the
    FILTER-INDEPENDENT half of a query (the JAX package's function of the
    same name). ``rel_ts`` are int32 offsets from the stream's epoch;
    ``lo``/``hi`` bound them, ``shift`` moves them to the query's
    bucket-aligned base. Returns (series_values, series_mask, filled,
    in_range, presence)."""
    ok = valid_in & (rel_ts >= lo) & (rel_ts <= hi)
    # downsample_group's per-series half alone: XLA drops the JAX
    # function's unused group stage and member timestamps; eager torch
    # would compute them.
    series_values, series_mask, _ = _series_stage(
        rel_ts - shift, vals, sid, ok, num_series=num_series,
        num_buckets=num_buckets, interval=interval, agg_down=agg_down,
        with_ts=False)
    presence = series_mask.any(dim=1)  # pre-rate, like downsample_group
    if rate:
        series_values, series_mask = bucket_rate(
            series_values, series_mask, interval, counter_max,
            reset_value, counter=counter, drop_resets=drop_resets)
    return _stage_tail(series_values, series_mask, presence,
                       num_buckets=num_buckets, rate=rate)


def _stage_tail(series_values, series_mask, presence, *, num_buckets,
                rate):
    """The shared tail of both window stages (one stream and chunked):
    fill per the rate family and return the stage contract. One
    definition, so the fill choice cannot diverge between them."""
    fill = step_fill if rate else gap_fill
    filled, in_range = fill(series_values, series_mask, num_buckets)
    return series_values, series_mask, filled, in_range, presence


def _chunk_stage_finish(count, total, m2, mn, mx, *, num_series,
                        num_buckets, interval, agg_down, rate=False,
                        counter_max=0.0, reset_value=0.0, counter=False,
                        drop_resets=False):
    """Accumulators -> the window stage contract (trash segment sliced
    off)."""
    per = _finish(agg_down, count, total, m2, mn, mx)
    shape = (num_series, num_buckets)
    series_values = per[:-1].reshape(shape)
    series_mask = count[:-1].reshape(shape) > 0
    presence = series_mask.any(dim=1)  # pre-rate, like downsample_group
    if rate:
        series_values, series_mask = bucket_rate(
            series_values, series_mask, interval, counter_max,
            reset_value, counter=counter, drop_resets=drop_resets)
    return _stage_tail(series_values, series_mask, presence,
                       num_buckets=num_buckets, rate=rate)


def window_series_stage_chunks(chunks, lo, hi, shift, *, num_series,
                               num_buckets, interval, agg_down,
                               rate=False, counter_max=0.0,
                               reset_value=0.0, counter=False,
                               drop_resets=False):
    """The heavy, FILTER-INDEPENDENT half of a resident-window query, over
    the window's RAW CHUNK LIST: range masking + per-series downsample
    [+ rate] + the row-local fill. No include mask and no grouping, so
    one cached stage serves every panel over the same (metric, range,
    interval, downsample) whatever its tag filter, group-by or group
    aggregator. No concatenated copy of the columns ever exists, so peak
    device memory is the resident chunks + one accumulator set + one
    chunk's transients. Every moment family merges exactly (dev through
    the chunk-locally centered M2 + Chan mean-shift correction,
    _chunk_fold).

    ``chunks``: a non-empty iterable of (rel_ts, values, sid) tensors on
    one device. Returns (series_values, series_mask, filled,
    in_range, presence)."""
    acc = _fold_chunks(chunks, lo, hi, shift, num_series=num_series,
                       num_buckets=num_buckets, interval=interval,
                       need=_needs(agg_down))
    return _chunk_stage_finish(
        *acc, num_series=num_series, num_buckets=num_buckets,
        interval=interval, agg_down=agg_down, rate=rate,
        counter_max=counter_max, reset_value=reset_value,
        counter=counter, drop_resets=drop_resets)


def _packbits(mask: torch.Tensor) -> torch.Tensor:
    """np.packbits(mask, axis=1), byte for byte, for a [G, b] bool mask
    with b a multiple of 8: big-endian bit order within each byte."""
    g, b = mask.shape
    weights = (2 ** torch.arange(7, -1, -1, device=mask.device)) \
        .to(torch.uint8)
    return (mask.reshape(g, b // 8, 8).to(torch.uint8) * weights) \
        .sum(dim=2, dtype=torch.uint8)


def _shrink_wrap(gv, gm, g_out, b_out):
    """Clip apply outputs to the (64-quantized) live group/bucket counts
    and bit-pack the mask before they cross to the host. The JAX
    package's opt-in bfloat16 wire (``wire_bf16``) has no caller here and
    is left out."""
    return gv[..., :g_out, :b_out], _packbits(gm[:g_out, :b_out])


def window_moment_apply(series_values, series_mask, filled, in_range,
                        include, gmap, *, num_groups, agg_group,
                        g_out=None, b_out=None):
    """Cheap per-query half of a resident-window MOMENT query: include
    masking (row-wise — identical to having filtered the points upstream,
    since fill is row-local) + group aggregation over the cached [S, B]
    stage grids, shrink-wrapped for the fetch when g_out/b_out are
    given."""
    sm = series_mask & include[:, None]
    if agg_group in NOLERP_AGGS:
        f, ir = series_values, sm
    else:
        f, ir = filled, in_range & include[:, None]
    gv, gm = _group_stage(f, ir, sm, gmap,
                          num_groups=num_groups, agg_group=agg_group)
    if g_out is None:
        return gv, gm
    return _shrink_wrap(gv, gm, g_out, b_out)


def window_quantile_apply(series_mask, filled, in_range, include, gmap, q,
                          *, num_groups, g_out=None, b_out=None,
                          layout: GroupLayout | None = None):
    """Cheap per-query half of a resident-window PERCENTILE query (the
    JAX package's ``_quantile_apply``): include masking + [G, B] masked
    quantiles ``q[0]`` from the cached stage's filled grid (quantiles
    always take the lerp/step fill family). Excluded and padded series
    carry no valid bucket, so wherever gmap sends them they add nothing;
    ``layout`` is gmap's ``group_layout`` when num_groups > 1."""
    sm = series_mask & include[:, None]
    ir = in_range & include[:, None]
    if num_groups == 1:
        gv = masked_quantile_axis0(filled, ir, q)[:1]
        gm = sm.any(dim=0)[None]
    else:
        gv = masked_quantile_groups(filled, ir, gmap, q,
                                    num_groups=num_groups,
                                    layout=layout)[0]
        gm = segment_sum(sm.to(torch.float32), gmap, num_groups) > 0
    if g_out is None:
        return gv, gm
    return _shrink_wrap(gv, gm, g_out, b_out)


# ---------------------------------------------------------------------------
# Un-downsampled queries: flat rate and union-grid aggregation
# ---------------------------------------------------------------------------

def flat_rate(ts: torch.Tensor, vals: torch.Tensor, sid: torch.Tensor,
              valid: torch.Tensor, counter_max: float = 0.0,
              reset_value: float = 0.0, *, counter: bool = False,
              drop_resets: bool = False, carry_ts=None, carry_val=None,
              use_carry=None):
    """Per-point rate of change within each series, in flat layout.

    Requires points sorted by (sid, ts) — the natural scan order. The
    first point of each series yields no rate (its valid bit clears),
    matching oracle.rate. ``counter`` adds rollover correction at
    counter_max; ``drop_resets``/reset_value zeroes implausible spikes.
    The optional carries serve the time-sharded path
    (``parallel/timeshard.py``): where ``use_carry`` [N] is set, the
    point's predecessor is (carry_ts, carry_val) [N] — the series' last
    point on an earlier time tile — instead of the rolled neighbour,
    keeping counter/reset semantics in this one place.
    Returns (rates [N] float32 at each point's own ts, valid [N])."""
    prev_ts = torch.roll(ts, 1)
    prev_v = torch.roll(vals, 1)
    ok = valid & torch.roll(valid, 1) & (torch.roll(sid, 1) == sid)
    if ok.numel():
        ok[0] = False
    if use_carry is not None:
        prev_ts = torch.where(use_carry, carry_ts, prev_ts)
        prev_v = torch.where(use_carry, carry_val, prev_v)
        ok = ok | use_carry
    dt = torch.clamp((ts - prev_ts).to(torch.float32), min=1e-9)
    dv = vals - prev_v
    if counter:
        dv = torch.where(dv < 0, dv + counter_max, dv)
    r = dv / dt
    if drop_resets:
        r = torch.where(torch.abs(r) > reset_value, 0.0, r)
    return torch.where(ok, r, 0.0), ok


def union_grid(ts: torch.Tensor, counts: torch.Tensor):
    """Deduplicated sorted union of S padded timestamp rows.

    ts is [S, T] int32 left-aligned; counts [S]. Returns (grid [S*T]
    int32, gmask [S*T] bool) with real entries compacted to the front."""
    S, T = ts.shape
    idx = torch.arange(T, device=ts.device)
    flat = torch.where(idx[None, :] < counts[:, None], ts, _I32_BIG) \
        .reshape(-1)
    sorted_ts = torch.sort(flat).values
    first = torch.ones_like(sorted_ts, dtype=torch.bool)
    first[1:] = sorted_ts[1:] != sorted_ts[:-1]
    gmask = first & (sorted_ts != _I32_BIG)
    order = torch.argsort(~gmask, stable=True)
    return sorted_ts[order], gmask[order]


def group_interpolate(ts: torch.Tensor, vals: torch.Tensor,
                      counts: torch.Tensor, *, agg: str,
                      interp: str = "lerp"):
    """Aggregate S padded series on the union of their timestamps.

    Args:
      ts:     [S, T] int32, each row sorted, left-aligned (valid prefix).
      vals:   [S, T] float32.
      counts: [S] int32 valid-point counts per row.
      interp: 'lerp', 'step' (last-value hold, for rates) or 'none'.

    Returns (grid [S*T] int32, out [S*T] float32, gmask [S*T] bool): the
    deduplicated union grid (padded; gmask marks real entries) and the
    aggregate at each grid point. A series contributes exact values at
    its own timestamps, interpolation elsewhere, nothing outside its
    [first, last] (reference SGIterator semantics, SpanGroup.java:370-796).

    The moments at the U real grid points come from ``interp_moments``
    over the compacted grid (on the card, one fused kernel that never
    holds the [S, U] contributions); the padded entries get the moments
    of no contribution, so ``out`` equals the JAX package's everywhere."""
    grid, gmask = union_grid(ts, counts)
    U = int(gmask.sum())
    need_m2 = "m2" in _needs(agg)
    c, t, m2, mn, mx = interp_moments(ts, vals, counts, grid[:U],
                                      interp=interp, with_m2=need_m2)
    n = grid.shape[0]

    def padded(x, fill):
        out = torch.full((n,), fill, dtype=torch.float32, device=ts.device)
        out[:U] = x
        return out

    cnt = padded(c, 0.0)
    out = _finish(agg, cnt, padded(t, 0.0),
                  padded(m2, 0.0) if need_m2 else None, padded(mn, _POS_INF),
                  padded(mx, _NEG_INF))
    return grid, out, gmask & (cnt > 0)
