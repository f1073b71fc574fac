"""Time-axis parallelism: long queries cut into bucket-aligned tiles.

Mirrors ``opentsdb_tpu/parallel/timeshard.py``. A long query range is cut
into D contiguous tiles of ``buckets_per_shard`` downsample buckets, one
per shard, and each shard reduces its tile. Tiles are bucket-aligned
(the host cuts on ``buckets_per_shard * interval`` boundaries), so
bucket moments stay tile-local; what crosses tiles are per-series
carries:

- rate: a tile's first nonempty bucket (first point, for the per-point
  rate) differences against the series' nearest earlier tile that has
  it, which may lie several tiles back;
- lerp / step fill: a series with no sample inside a tile still
  contributes between its neighbours outside it.

Each tile publishes a tiny per-series edge summary (first / last
nonempty bucket and its value: 4 int32 words a series, values as their
bits), the summaries are gathered onto the mesh's first device, and the
hand-written ``tile_carries`` kernel (``ops/mesh_combine.py``) selects
every (tile, series)'s left and right carries in one pass; each tile
then finishes with the shared single-device kernels windowed to its
global bucket range (``gap_fill`` / ``step_fill`` / ``bucket_rate`` /
``flat_rate`` with carries), so the answers equal the unsharded ones.
"""

from __future__ import annotations

import numpy as np
import torch

from opentsdb_tpu_torch.core.const import NOLERP_AGGS
from opentsdb_tpu_torch.ops import mesh_combine
from opentsdb_tpu_torch.ops.kernels import (
    _finish,
    _needs,
    _segment_moments,
    bucket_rate,
    flat_rate,
    gap_fill,
    group_moments,
    masked_quantile_axis0,
    step_fill,
)
from opentsdb_tpu_torch.parallel.compile import combine, compile_with_plan
from opentsdb_tpu_torch.parallel.mesh import TIME_AXIS
from opentsdb_tpu_torch.parallel.plan import ExecPlan

_I32_BIG = 2**31 - 1


def _bits(x: torch.Tensor) -> torch.Tensor:
    return x.contiguous().view(torch.int32)


def _local_edge_summary(series_values, series_mask, bps):
    """Per-series (first / last nonempty local bucket idx, value there).

    Returns (first_idx [S] int32 local-or-bps, first_val [S],
             last_idx [S] int32 local-or--1, last_val [S])."""
    b_idx = torch.arange(bps, dtype=torch.int32,
                         device=series_values.device)
    last_idx = torch.where(series_mask, b_idx[None, :], -1).amax(dim=1)
    first_idx = torch.where(series_mask, b_idx[None, :], bps).amin(dim=1)
    lp = torch.clamp(last_idx, 0, bps - 1).long()
    fp = torch.clamp(first_idx, 0, bps - 1).long()
    last_val = torch.gather(series_values, 1, lp[:, None])[:, 0]
    first_val = torch.gather(series_values, 1, fp[:, None])[:, 0]
    return first_idx, first_val, last_idx, last_val


def _combine_carries(payloads, dev):
    """Gathered [D, S, 4] summaries -> each tile's [4, S] carry planes
    (the tile_carries kernel; the mode rides the payload)."""
    rows = torch.stack([p[0].to(dev) for p in payloads])
    planes = mesh_combine.tile_carries(rows, payloads[0][1])
    return [planes[:, d] for d in range(rows.shape[0])]


def _cross_tile_edges(series_values, series_mask, *, d, bps):
    """Per-series cross-tile carries for tile ``d`` (a generator: ``yield
    from`` it inside a mesh body). Publishes the edge summary, and gets
    back each series' nearest nonempty bucket on any earlier tile (left)
    and any later one (right): (left_idx [S] global-or--1, left_val [S],
    right_idx [S] global-or-2^31-1, right_val [S]) — the carry format of
    gap_fill / step_fill / bucket_rate."""
    first_i, first_v, last_i, last_v = _local_edge_summary(
        series_values, series_mask, bps)
    g_last = torch.where(last_i >= 0, d * bps + last_i, -1)
    g_first = torch.where(first_i < bps, d * bps + first_i, _I32_BIG)
    rows = torch.stack([g_last.to(torch.int32), _bits(last_v),
                        g_first.to(torch.int32), _bits(first_v)], dim=1)
    planes = yield combine(_combine_carries, rows, 0, per_shard=True)
    return (planes[0], planes[1].view(torch.float32), planes[2],
            planes[3].view(torch.float32))


def _cross_tile_gap_fill(series_values, series_mask, *, d, bps):
    """gap_fill with lerp carries across tile boundaries (a generator).
    Fills local empty buckets from the nearest nonempty bucket on any
    tile: equal to gap_fill on the unsharded [S, D * bps] grid. Returns
    (filled [S, bps], in_range [S, bps])."""
    left_idx, left_val, right_idx, right_val = yield from _cross_tile_edges(
        series_values, series_mask, d=d, bps=bps)
    return gap_fill(series_values, series_mask, bps, glob_offset=d * bps,
                    left_idx=left_idx, left_val=left_val,
                    right_idx=right_idx, right_val=right_val)


def _timeshard_group_body(ts, vals, sid, valid, q, rate_params, *,
                          axis_index, num_series, buckets_per_shard,
                          interval, agg_down, agg_group, rate, counter,
                          drop_resets, with_quantile):
    """Per-tile body of timeshard_downsample_group; ``q`` is the host
    quantile operand (read only with ``with_quantile``), ``rate_params``
    the [1, 2] (counter_max, reset_value) operand."""
    counter_max, reset_value = rate_params[0, 0], rate_params[0, 1]
    bps = buckets_per_shard
    d = axis_index
    # Tile-local bucketing: tiles are bucket-aligned, so every point's
    # bucket lies on its own tile.
    local = ts - d * bps * interval
    bucket = torch.clamp(torch.div(local, interval, rounding_mode="floor"),
                         0, bps - 1)
    seg = torch.where(valid, sid * bps + bucket,
                      num_series * bps).to(torch.int32)
    nseg = num_series * bps + 1
    count, total, m2, mn, mx = _segment_moments(
        vals, seg, valid, nseg, need=_needs(agg_down))
    per = _finish(agg_down, count, total, m2, mn, mx)
    shape = (num_series, bps)
    series_values = per[:-1].reshape(shape)
    series_mask = count[:-1].reshape(shape) > 0

    if rate:
        l_i, l_v, _, _ = yield from _cross_tile_edges(
            series_values, series_mask, d=d, bps=bps)
        series_values, series_mask = bucket_rate(
            series_values, series_mask, interval, counter_max,
            reset_value, counter=counter, drop_resets=drop_resets,
            glob_offset=d * bps, left_idx=l_i, left_val=l_v)

    if agg_group in NOLERP_AGGS and not with_quantile:
        # The no-lerp family contributes only where a series has a real
        # bucket: no carries.
        filled, in_range = series_values, series_mask
    elif rate:
        # Rates step-hold; edges recomputed on the post-rate grid.
        l_i, l_v, r_i, _ = yield from _cross_tile_edges(
            series_values, series_mask, d=d, bps=bps)
        filled, in_range = step_fill(
            series_values, series_mask, bps,
            left_idx=l_i, left_val=l_v, right_idx=r_i)
    else:
        filled, in_range = yield from _cross_tile_gap_fill(
            series_values, series_mask, d=d, bps=bps)
    if with_quantile:
        group_values = masked_quantile_axis0(filled, in_range, q)[0]
    else:
        g_n, g_total, g_m2, _, g_mn, g_mx = group_moments(
            filled, in_range)
        group_values = _finish(agg_group, g_n, g_total, g_m2, g_mn, g_mx)
    return group_values, series_mask.any(dim=0)


TIMESHARD_GROUP_PLAN = ExecPlan(
    name="timeshard.downsample_group", axis="time", style="shard_map",
    in_specs=(TIME_AXIS,) * 4 + (None, None),
    out_specs=(TIME_AXIS, TIME_AXIS))


def timeshard_downsample_group(ts, vals, sid, valid, *, mesh,
                               num_series: int, buckets_per_shard: int,
                               interval: int, agg_down: str, agg_group: str,
                               rate: bool = False, counter_max: float = 0.0,
                               reset_value: float = 0.0,
                               counter: bool = False,
                               drop_resets: bool = False,
                               quantile: float | None = None):
    """Downsample [+ rate] + group-by with the time axis sharded.

    Args:
      ts:    [D, N_tile] int32 global offsets from the query start.
      vals:  [D, N_tile] float32.
      sid:   [D, N_tile] int32 series index in [0, num_series) (the same
             across tiles).
      valid: [D, N_tile] bool. Points of tile d satisfy
             ts // (interval * buckets_per_shard) == d (pack_time_shards).

    ``rate=True`` inserts the per-series rate on the bucket grid, each
    tile's first nonempty bucket differencing against the carried-in
    nearest earlier one, so sharded rates equal the unsharded kernel.
    ``quantile`` switches the group stage from moments to a per-bucket
    quantile across series; once the fill carries are in, it is
    tile-local. Returns (group_values [D*bps], group_mask [D*bps]), the
    tiles' grids concatenated on the mesh's first device."""
    fn = compile_with_plan(
        _timeshard_group_body, TIMESHARD_GROUP_PLAN, mesh,
        statics=(("num_series", num_series),
                 ("buckets_per_shard", buckets_per_shard),
                 ("interval", interval), ("agg_down", agg_down),
                 ("agg_group", agg_group), ("rate", rate),
                 ("counter", counter), ("drop_resets", drop_resets),
                 ("with_quantile", quantile is not None)))
    q = (float(np.float32(0.0 if quantile is None else quantile)),)
    rp = np.asarray([[counter_max, reset_value]], np.float32)
    return fn(ts, vals, sid, valid, q, rp)


def _timeshard_rate_body(ts, vals, sid, valid, rate_params, *, axis_index,
                         num_series, counter, drop_resets):
    """Per-point rate with the time axis sharded: each tile's first point
    per series differences against a carried-in predecessor, the
    series' last point on the nearest earlier tile that has it (found
    by tile_carries over the gathered per-tile (has, last_ts, last_val)
    summaries). Returns (rates [1, N_tile], ok [1, N_tile])."""
    counter_max, reset_value = rate_params[0, 0], rate_params[0, 1]
    n = ts.shape[0]
    dev = ts.device
    pos = torch.arange(n, dtype=torch.int32, device=dev)
    seg = torch.where(valid, sid, num_series).long()
    nseg = num_series + 1

    last_pos = torch.full((nseg,), -1, dtype=torch.int32,
                          device=dev).scatter_reduce_(
        0, seg, torch.where(valid, pos, -1), "amax")[:num_series]
    has_last = last_pos >= 0
    lp = torch.clamp(last_pos, 0, n - 1).long()
    rows = torch.stack([has_last.to(torch.int32), ts[lp].to(torch.int32),
                        _bits(vals[lp]),
                        torch.zeros_like(last_pos)], dim=1)
    planes = yield combine(_combine_carries, rows, 1, per_shard=True)
    has_carry = planes[0] > 0
    carry_ts, carry_val = planes[1], planes[2].view(torch.float32)

    # The first valid point of each series in this tile uses the carry;
    # flat_rate does the differences and the counter / reset semantics.
    first_pos = torch.full((nseg,), _I32_BIG, dtype=torch.int32,
                           device=dev).scatter_reduce_(
        0, seg, torch.where(valid, pos, _I32_BIG), "amin")[:num_series]
    sidc = torch.clamp(sid, 0, num_series - 1).long()
    is_first = valid & (pos == first_pos[sidc])
    use_carry = is_first & has_carry[sidc]
    r, ok = flat_rate(
        ts, vals, sid, valid, counter_max, reset_value,
        counter=counter, drop_resets=drop_resets,
        carry_ts=carry_ts[sidc], carry_val=carry_val[sidc],
        use_carry=use_carry)
    return r[None], ok[None]


TIMESHARD_RATE_PLAN = ExecPlan(
    name="timeshard.rate", axis="time", style="shard_map",
    in_specs=(TIME_AXIS,) * 4 + (None,),
    out_specs=(TIME_AXIS, TIME_AXIS))


def timeshard_rate(ts, vals, sid, valid, *, mesh, num_series: int,
                   counter_max: float = 0.0, reset_value: float = 0.0,
                   counter: bool = False, drop_resets: bool = False):
    """Per-point rate with the time axis sharded. Args are [D, N_tile];
    each tile's points sorted by (sid, ts), and tile d's timestamps all
    before tile d+1's (per series). Equals ops.kernels.flat_rate on the
    concatenated sorted arrays: the first point of each series overall
    has no rate; first points of later tiles difference against the
    carried-in predecessor. Returns (rates [D, N_tile], ok [D, N_tile])."""
    fn = compile_with_plan(
        _timeshard_rate_body, TIMESHARD_RATE_PLAN, mesh,
        statics=(("num_series", num_series), ("counter", counter),
                 ("drop_resets", drop_resets)))
    rp = np.asarray([[counter_max, reset_value]], np.float32)
    return fn(ts, vals, sid, valid, rp)


# ---------------------------------------------------------------------------
# Host-side packing
# ---------------------------------------------------------------------------

def pack_time_shards(ts, vals, sid, n_shards: int, interval: int,
                     buckets_per_shard: int):
    """Partition flat (ts, vals, sid) points into n bucket-aligned time
    tiles, each padded to the largest tile. ``ts`` are global offsets
    from the query start; tile d owns
    ``[d*bps*interval, (d+1)*bps*interval)``. Within each tile points are
    sorted by (sid, ts), the order timeshard_rate requires. Returns
    (ts, vals, sid, valid) as [D, N_tile] numpy arrays."""
    ts = np.asarray(ts)
    vals = np.asarray(vals, np.float32)
    sid = np.asarray(sid, np.int32)
    span = interval * buckets_per_shard
    tile = np.clip(ts // span, 0, n_shards - 1)
    n_tile = max(int(np.bincount(tile, minlength=n_shards).max()), 1)
    out_ts = np.zeros((n_shards, n_tile), np.int32)
    out_vals = np.zeros((n_shards, n_tile), np.float32)
    out_sid = np.zeros((n_shards, n_tile), np.int32)
    out_valid = np.zeros((n_shards, n_tile), bool)
    for d in range(n_shards):
        m = tile == d
        t, v, s = ts[m], vals[m], sid[m]
        order = np.lexsort((t, s))
        t, v, s = t[order], v[order], s[order]
        k = len(t)
        out_ts[d, :k] = t
        out_vals[d, :k] = v
        out_sid[d, :k] = s
        out_valid[d, :k] = True
    return out_ts, out_vals, out_sid, out_valid
