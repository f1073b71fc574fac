"""Sharded query bodies: series-parallel execution over a mesh.

Mirrors ``opentsdb_tpu/parallel/sharded.py``. Layout: the host
partitions a query's series into D blocks (one per shard) and packs
each block's points into the flat layout, padded to a common [N_shard]
size; the arrays stack to [D, N_shard] and split over the mesh's series
axis. Each shard runs the same downsample [+ rate] + fill on its local
series (no communication), then the cross-series group stage combines
across the shards on the mesh's first device (``parallel/compile.py``):

- moments: per-cell partial count / sum / centered M2 / min / max, merged
  by the exact pairwise (Chan et al.) update
  M2 = sum_i M2_i + sum_i n_i (mean_i - mean)^2 in one pass of the
  hand-written ``moment_combine`` kernel (``ops/mesh_combine.py``), shard
  by shard in order, with the aggregator's finish and the any-real mask;
- percentiles: the shards' [S_local, B] contribution grids are gathered
  and the rank-select kernel runs once over the full set (exact);
- sketches: HLL registers by elementwise max, t-digests gathered and
  recompressed through the t-digest fold kernel;
- the rollup window fold: shard-local only, the combine a gather, so its
  grids are byte-identical across mesh widths.

Each body is a generator (see ``parallel/compile.py``): ``yield
combine(...)`` is where the JAX body calls its collectives. Client
rate parameters ride a [1, 2] float32 operand, never a static.
"""

from __future__ import annotations

import numpy as np
import torch

from opentsdb_tpu_torch.core.const import NOLERP_AGGS
from opentsdb_tpu_torch.ops import mesh_combine, sketches
from opentsdb_tpu_torch.ops.kernels import (
    _NEG_INF,
    _POS_INF,
    _series_stage,
    bucket_rate,
    gap_fill,
    group_moments,
    group_layout,
    masked_quantile_axis0,
    masked_quantile_groups,
    step_fill,
)
from opentsdb_tpu_torch.ops.segment_reduce import segment_minmax, segment_sum
from opentsdb_tpu_torch.parallel.compile import combine, compile_with_plan
from opentsdb_tpu_torch.parallel.mesh import SERIES_AXIS
from opentsdb_tpu_torch.parallel.plan import ExecPlan


def _rate_params(counter_max, reset_value):
    """[1, 2] float32 replicated operand carrying the client-controlled
    rate parameters into the mesh bodies (a static would mint a new
    dispatcher per distinct counterMax / resetValue)."""
    return np.asarray([[counter_max, reset_value]], np.float32)


def _local_filled(ts, vals, sid, valid, *, num_series, num_buckets,
                  interval, agg_down, lerp=True, rate=False,
                  counter_max=0.0, reset_value=0.0, counter=False,
                  drop_resets=False):
    """Per shard: downsample [+ rate] + fill, returning each local
    series' per-bucket contribution (filled [S, B], in_range [S, B]) and
    the post-rate real-bucket mask [S, B]. The fill policy is the
    single-device one: ``lerp=False`` (zimsum / mimmin / mimmax) none,
    rates step-hold, plain values lerp."""
    sv, sm, _ = _series_stage(
        ts, vals, sid, valid, num_series=num_series,
        num_buckets=num_buckets, interval=interval, agg_down=agg_down,
        with_ts=False)
    if rate:
        sv, sm = bucket_rate(sv, sm, interval, counter_max, reset_value,
                             counter=counter, drop_resets=drop_resets)
    if not lerp:
        filled, in_range = sv, sm
    elif rate:
        filled, in_range = step_fill(sv, sm, num_buckets)
    else:
        filled, in_range = gap_fill(sv, sm, num_buckets)
    return filled, in_range, sm


def _local_group_moments(ts, vals, sid, valid, **kw):
    """Per shard: partial group moments per bucket (count, total,
    M2 around the local mean, local mean, min, max, any real point)."""
    filled, in_range, sm = _local_filled(ts, vals, sid, valid, **kw)
    n, total, m2, mean, mn, mx = group_moments(filled, in_range)
    return n, total, m2, mean, mn, mx, sm.any(dim=0)


def _combine_moments(payloads, dev):
    """The moment fan-in: each shard's partial planes stacked [D, C] on
    the combine device, merged by the moment_combine kernel."""
    agg = payloads[0][0]
    want = mesh_combine.needs(agg)

    def plane(i, name=None):
        if name is not None and name not in want:
            return None
        return torch.stack([p[i].to(dev) for p in payloads])

    any_ = torch.stack([p[6].to(dev).to(torch.int32) for p in payloads])
    return mesh_combine.moment_combine(
        plane(1), plane(2, "total"), plane(3, "m2"), plane(4, "min"),
        plane(5, "max"), any_, agg=agg)


def _sharded_group_body(ts, vals, sid, valid, rate_params, *, axis_index,
                        series_per_shard, num_buckets, interval, agg_down,
                        agg_group, rate, counter, drop_resets):
    counter_max, reset_value = rate_params[0, 0], rate_params[0, 1]
    n, total, m2, _, mn, mx, any_real = _local_group_moments(
        ts, vals, sid, valid, num_series=series_per_shard,
        num_buckets=num_buckets, interval=interval, agg_down=agg_down,
        lerp=agg_group not in NOLERP_AGGS, rate=rate,
        counter_max=counter_max, reset_value=reset_value,
        counter=counter, drop_resets=drop_resets)
    out, g_any = yield combine(_combine_moments, agg_group, n, total, m2,
                               mn, mx, any_real)
    return out, g_any


SHARDED_GROUP_PLAN = ExecPlan(
    name="sharded.downsample_group", axis="series", style="shard_map",
    in_specs=(SERIES_AXIS,) * 4 + (None,),
    out_specs=(None, None))


def sharded_downsample_group(ts, vals, sid, valid, *, mesh,
                             series_per_shard: int, num_buckets: int,
                             interval: int, agg_down: str, agg_group: str,
                             rate: bool = False, counter_max: float = 0.0,
                             reset_value: float = 0.0,
                             counter: bool = False,
                             drop_resets: bool = False):
    """Downsample [+ rate] + cross-shard group aggregation.

    Args are [D, N_shard] stacked shards (sid local to each shard, in
    [0, series_per_shard)); returns (group_values [B], group_mask [B]) on
    the mesh's first device."""
    fn = compile_with_plan(
        _sharded_group_body, SHARDED_GROUP_PLAN, mesh,
        statics=(("series_per_shard", series_per_shard),
                 ("num_buckets", num_buckets), ("interval", interval),
                 ("agg_down", agg_down), ("agg_group", agg_group),
                 ("rate", rate), ("counter", counter),
                 ("drop_resets", drop_resets)))
    return fn(ts, vals, sid, valid, _rate_params(counter_max, reset_value))


def _combine_quantile(payloads, dev):
    """Gather every shard's contribution grid and select once."""
    filled = torch.cat([p[0].to(dev) for p in payloads])
    in_range = torch.cat([p[1].to(dev) for p in payloads])
    out = masked_quantile_axis0(filled, in_range, payloads[0][2])
    g_any = torch.stack([p[3].to(dev) for p in payloads]).any(dim=0)
    return out, g_any


def _sharded_quantile_body(ts, vals, sid, valid, q, rate_params, *,
                           axis_index, series_per_shard, num_buckets,
                           interval, agg_down, rate, counter, drop_resets):
    counter_max, reset_value = rate_params[0, 0], rate_params[0, 1]
    filled, in_range, sm = _local_filled(
        ts, vals, sid, valid, num_series=series_per_shard,
        num_buckets=num_buckets, interval=interval, agg_down=agg_down,
        rate=rate, counter_max=counter_max, reset_value=reset_value,
        counter=counter, drop_resets=drop_resets)
    out, g_any = yield combine(_combine_quantile, filled, in_range, q,
                               sm.any(dim=0))
    return out, g_any


SHARDED_QUANTILE_PLAN = ExecPlan(
    name="sharded.downsample_quantile", axis="series", style="shard_map",
    in_specs=(SERIES_AXIS,) * 4 + (None, None),
    out_specs=(None, None))


def sharded_downsample_quantile(ts, vals, sid, valid, q, *, mesh,
                                series_per_shard: int, num_buckets: int,
                                interval: int, agg_down: str,
                                rate: bool = False,
                                counter_max: float = 0.0,
                                reset_value: float = 0.0,
                                counter: bool = False,
                                drop_resets: bool = False):
    """Group-stage percentile across series, series-sharded: each shard
    computes its local series' per-bucket contributions (downsample
    [+ rate] + fill), the combine gathers the [S_local, B] blocks and
    selects across the full [S, B] set once (exact). ``q`` [K] (host
    values, an operand); returns (values [K, B], group_mask [B])."""
    fn = compile_with_plan(
        _sharded_quantile_body, SHARDED_QUANTILE_PLAN, mesh,
        statics=(("series_per_shard", series_per_shard),
                 ("num_buckets", num_buckets), ("interval", interval),
                 ("agg_down", agg_down), ("rate", rate),
                 ("counter", counter), ("drop_resets", drop_resets)))
    return fn(ts, vals, sid, valid, _q_operand(q),
              _rate_params(counter_max, reset_value))


def _q_operand(q) -> tuple:
    """Quantiles as a host tuple: an operand the rank select reads on
    the host, never a cache key."""
    return tuple(float(x) for x in np.atleast_1d(np.asarray(q, np.float32)))


def _multigroup_emission(sm, gmap, num_groups: int):
    """Per shard: the (group, bucket) cells where some local member
    series has a real post-rate bucket, [G * B] int32; the combine ORs
    the shards', so the emission invariant has one implementation."""
    real = segment_sum(sm.to(torch.float32), gmap, num_groups)
    return (real > 0).to(torch.int32).reshape(-1)


def _local_multigroup_moments(filled, in_range, sm, gmap, *, num_groups,
                              agg_group):
    """Per shard: per-(group, bucket) partial moments, [G * B] each:
    segment reductions of whole [S, B] rows by ``gmap`` (count, sum and
    the real-bucket count in one K = 3B call; the M2 around the local
    cell mean, min and max only when the aggregator reads them)."""
    want = mesh_combine.needs(agg_group)
    B = filled.shape[1]
    v = torch.where(in_range, filled, 0.0)
    sums = segment_sum(
        torch.cat([in_range.to(torch.float32), v,
                   sm.to(torch.float32)], dim=1), gmap, num_groups)
    n, total = sums[:, :B], sums[:, B:2 * B]
    real = (sums[:, 2 * B:] > 0).to(torch.int32)
    m2 = mn = mx = None
    if "m2" in want:
        mean = total / torch.clamp(n, min=1.0)
        centered = torch.where(in_range, filled - mean[gmap.long()], 0.0)
        m2 = segment_sum(centered * centered, gmap, num_groups)
    if "min" in want:
        mn = segment_minmax(torch.where(in_range, filled, _POS_INF), gmap,
                            num_groups, need="min")
    if "max" in want:
        mx = segment_minmax(torch.where(in_range, filled, _NEG_INF), gmap,
                            num_groups, need="max")
    flat = [None if x is None else x.reshape(-1)
            for x in (n, total, m2, mn, mx, real)]
    return tuple(flat)


def _sharded_multigroup_body(ts, vals, sid, valid, gmap, rate_params, *,
                             axis_index, series_per_shard, num_groups,
                             num_buckets, interval, agg_down, agg_group,
                             rate, counter, drop_resets):
    counter_max, reset_value = rate_params[0, 0], rate_params[0, 1]
    filled, in_range, sm = _local_filled(
        ts, vals, sid, valid, num_series=series_per_shard,
        num_buckets=num_buckets, interval=interval, agg_down=agg_down,
        lerp=agg_group not in NOLERP_AGGS, rate=rate,
        counter_max=counter_max, reset_value=reset_value,
        counter=counter, drop_resets=drop_resets)
    n, total, m2, mn, mx, real = _local_multigroup_moments(
        filled, in_range, sm, gmap, num_groups=num_groups,
        agg_group=agg_group)
    out, g_real = yield combine(_combine_moments, agg_group, n, total, m2,
                                mn, mx, real)
    shape = (num_groups, num_buckets)
    return out.reshape(shape), g_real.reshape(shape)


SHARDED_MULTIGROUP_PLAN = ExecPlan(
    name="sharded.downsample_multigroup", axis="series",
    style="shard_map",
    in_specs=(SERIES_AXIS,) * 5 + (None,),
    out_specs=(None, None))


def sharded_downsample_multigroup(ts, vals, sid, valid, gmap, *, mesh,
                                  series_per_shard: int, num_groups: int,
                                  num_buckets: int, interval: int,
                                  agg_down: str, agg_group: str,
                                  rate: bool = False,
                                  counter_max: float = 0.0,
                                  reset_value: float = 0.0,
                                  counter: bool = False,
                                  drop_resets: bool = False):
    """Many group-by buckets, series-sharded, in one call. ``gmap``
    [D, series_per_shard] maps each shard-local series to its global
    group in [0, num_groups); one group's series may lie on several
    shards. Each shard computes per-(group, bucket) partial moments and
    the combine merges them per cell (Chan). Returns (group_values
    [G, B], group_mask [G, B])."""
    fn = compile_with_plan(
        _sharded_multigroup_body, SHARDED_MULTIGROUP_PLAN, mesh,
        statics=(("series_per_shard", series_per_shard),
                 ("num_groups", num_groups),
                 ("num_buckets", num_buckets), ("interval", interval),
                 ("agg_down", agg_down), ("agg_group", agg_group),
                 ("rate", rate), ("counter", counter),
                 ("drop_resets", drop_resets)))
    return fn(ts, vals, sid, valid, gmap,
              _rate_params(counter_max, reset_value))


def _combine_group_quantile(payloads, dev):
    """Gather contributions and group maps; one grouped rank select."""
    filled = torch.cat([p[0].to(dev) for p in payloads])
    in_range = torch.cat([p[1].to(dev) for p in payloads])
    gmap = torch.cat([p[2].to(dev) for p in payloads])
    q, num_groups = payloads[0][3], payloads[0][5]
    gv = masked_quantile_groups(
        filled, in_range, gmap, q, num_groups=num_groups,
        layout=group_layout(gmap, num_groups, dev))[0]
    g_real = torch.stack([p[4].to(dev) for p in payloads]).any(dim=0)
    return gv, g_real


def _sharded_multigroup_quantile_body(ts, vals, sid, valid, gmap, q,
                                      rate_params, *, axis_index,
                                      series_per_shard, num_groups,
                                      num_buckets, interval, agg_down,
                                      rate, counter, drop_resets):
    counter_max, reset_value = rate_params[0, 0], rate_params[0, 1]
    filled, in_range, sm = _local_filled(
        ts, vals, sid, valid, num_series=series_per_shard,
        num_buckets=num_buckets, interval=interval, agg_down=agg_down,
        rate=rate, counter_max=counter_max, reset_value=reset_value,
        counter=counter, drop_resets=drop_resets)
    real = _multigroup_emission(sm, gmap, num_groups) > 0
    gv, g_real = yield combine(_combine_group_quantile, filled, in_range,
                               gmap, q, real, num_groups)
    return gv, g_real.reshape(num_groups, num_buckets)


SHARDED_MULTIGROUP_QUANTILE_PLAN = ExecPlan(
    name="sharded.downsample_multigroup_quantile", axis="series",
    style="shard_map",
    in_specs=(SERIES_AXIS,) * 5 + (None, None),
    out_specs=(None, None))


def sharded_downsample_multigroup_quantile(
        ts, vals, sid, valid, gmap, q, *, mesh, series_per_shard: int,
        num_groups: int, num_buckets: int, interval: int, agg_down: str,
        rate: bool = False, counter_max: float = 0.0,
        reset_value: float = 0.0, counter: bool = False,
        drop_resets: bool = False):
    """Many group-by buckets with a percentile group stage, series-
    sharded: each shard computes its local contributions, the combine
    gathers them with the group map and runs the grouped rank select
    once. Returns (group_values [G, B] for q[0], group_mask [G, B])."""
    fn = compile_with_plan(
        _sharded_multigroup_quantile_body,
        SHARDED_MULTIGROUP_QUANTILE_PLAN, mesh,
        statics=(("series_per_shard", series_per_shard),
                 ("num_groups", num_groups),
                 ("num_buckets", num_buckets), ("interval", interval),
                 ("agg_down", agg_down), ("rate", rate),
                 ("counter", counter), ("drop_resets", drop_resets)))
    return fn(ts, vals, sid, valid, gmap, _q_operand(q),
              _rate_params(counter_max, reset_value))


# ---------------------------------------------------------------------------
# Sketches
# ---------------------------------------------------------------------------

def _combine_hll(payloads, dev):
    regs = torch.stack([p[0].to(dev) for p in payloads]).amax(dim=0)
    return sketches.hll_estimate(regs)


def _sharded_hll_body(items, valid, *, axis_index, p):
    regs = sketches.hll_init(p, device=items.device)
    regs = sketches.hll_add(regs, items, valid, p=p)
    return (yield combine(_combine_hll, regs))


SHARDED_HLL_PLAN = ExecPlan(
    name="sharded.hll_distinct", axis="series", style="shard_map",
    in_specs=(SERIES_AXIS, SERIES_AXIS), out_specs=None)


def sharded_hll_distinct(items, valid, *, mesh, p: int = 14):
    """Distinct count over [D, N_shard] sharded items: local HLL
    registers (the hll_fold kernel), register max across the shards,
    one estimate."""
    fn = compile_with_plan(_sharded_hll_body, SHARDED_HLL_PLAN, mesh,
                           statics=(("p", p),))
    return fn(items, valid)


def _combine_tdigest(payloads, dev):
    means = torch.cat([p[0].to(dev) for p in payloads])
    weights = torch.cat([p[1].to(dev) for p in payloads])
    qs, compression = payloads[0][2], payloads[0][3]
    m, w = sketches.tdigest_init(compression, device=dev)
    m, w = sketches.tdigest_merge(m, w, means, weights,
                                  compression=compression)
    return sketches.tdigest_quantile(m, w, list(qs))


def _sharded_tdigest_body(values, valid, qs, *, axis_index, compression):
    means, weights = sketches.tdigest_init(compression,
                                           device=values.device)
    means, weights = sketches.tdigest_add(means, weights, values, valid,
                                          compression=compression)
    return (yield combine(_combine_tdigest, means, weights, qs,
                          compression))


SHARDED_TDIGEST_PLAN = ExecPlan(
    name="sharded.tdigest", axis="series", style="shard_map",
    in_specs=(SERIES_AXIS, SERIES_AXIS, None), out_specs=None)


def sharded_tdigest(values, valid, qs, *, mesh, compression: int = 128):
    """Quantiles over [D, N_shard] sharded values: local digests (the
    t-digest fold kernel), gathered and recompressed (the same kernel
    folding the D digests' centroids into an empty one), one answer."""
    fn = compile_with_plan(_sharded_tdigest_body, SHARDED_TDIGEST_PLAN,
                           mesh, statics=(("compression", compression),))
    return fn(values, valid, _q_operand(qs))


# ---------------------------------------------------------------------------
# Mesh-sharded rollup window fold
# ---------------------------------------------------------------------------

_I32_MIN = -(2**31)
_I32_MAX = 2**31 - 1


def _sharded_window_fold_body(ts, vals, sid, valid, *, axis_index,
                              series_per_shard, num_windows, res):
    """Per-shard half of the rollup window fold: the local series'
    points into per-(series, window) record columns. A series lives on
    one shard, so the combine is a pure gather: byte-exact, no
    arithmetic crosses the mesh."""
    nseg = series_per_shard * num_windows + 1
    widx = torch.clamp(torch.div(ts, res, rounding_mode="floor"), 0,
                       num_windows - 1)
    seg = torch.where(valid, sid * num_windows + widx,
                      nseg - 1).to(torch.int32)
    seg_l = seg.long()
    sums = segment_sum(torch.stack(
        [valid.to(torch.float32), torch.where(valid, vals, 0.0)], dim=1),
        seg, nseg)
    mn = segment_minmax(torch.where(valid, vals, _POS_INF)[:, None], seg,
                        nseg, need="min")[:, 0]
    mx = segment_minmax(torch.where(valid, vals, _NEG_INF)[:, None], seg,
                        nseg, need="max")[:, 0]
    # Integer first / last member timestamps: an empty cell keeps the
    # reduction's identity (int32 max / min), as XLA's segment_min / max.
    t_min = torch.full((nseg,), _I32_MAX, dtype=torch.int32,
                       device=ts.device).scatter_reduce_(
        0, seg_l, torch.where(valid, ts, _I32_MAX), "amin")
    t_max = torch.full((nseg,), _I32_MIN, dtype=torch.int32,
                       device=ts.device).scatter_reduce_(
        0, seg_l, torch.where(valid, ts, -1), "amax")
    # Points are deduplicated per series, so exactly one point matches
    # each bound and the masked sums below select, never add.
    is_first = valid & (ts == t_min[seg_l])
    is_last = valid & (ts == t_max[seg_l])
    fl = segment_sum(torch.stack(
        [torch.where(is_first, vals, 0.0), torch.where(is_last, vals, 0.0)],
        dim=1), seg, nseg)
    shape = (series_per_shard, num_windows)

    def grid(x):
        return x[:-1].reshape(shape)

    # The timestamp planes ride the float32 tensor as their bits, never
    # cast: a float32 cast rounds offsets past 2^24 s by whole seconds.
    out = torch.stack([grid(sums[:, 0]), grid(sums[:, 1]), grid(mn),
                       grid(mx), grid(fl[:, 0]), grid(fl[:, 1]),
                       grid(t_min.view(torch.float32)),
                       grid(t_max.view(torch.float32))])
    return out[None]


SHARDED_WINDOW_FOLD_PLAN = ExecPlan(
    name="rollup.window_fold", axis="series", style="shard_map",
    in_specs=(SERIES_AXIS,) * 4, out_specs=SERIES_AXIS)


def sharded_window_fold(ts, vals, sid, valid, *, mesh,
                        series_per_shard: int, num_windows: int,
                        res: int):
    """Rollup window fold sharded over the mesh's series-hash axis.

    Args are [D, N_shard] stacked shards (``pack_shards`` layout; ``ts``
    offsets from the fold's window-grid origin, deduplicated per
    series). Returns [D, 8, series_per_shard, num_windows] float32 grids
    — count, sum, min, max, first, last, first_ts, last_ts per
    (shard-local series, window); the two timestamp planes are int32
    bits in the float32 tensor (``.view(torch.int32)`` / numpy
    ``.view(np.int32)``). ``shard_placement`` maps (d, local) back to
    global series. A series never splits across shards and the combine
    is a gather, so the grids are byte-identical across mesh widths
    wherever each series' points keep their order."""
    fn = compile_with_plan(
        _sharded_window_fold_body, SHARDED_WINDOW_FOLD_PLAN, mesh,
        statics=(("series_per_shard", series_per_shard),
                 ("num_windows", num_windows), ("res", res)))
    return fn(ts, vals, sid, valid)


# ---------------------------------------------------------------------------
# Host-side packing
# ---------------------------------------------------------------------------

def shard_placement(n_series: int, n_shards: int) -> list[tuple[int, int]]:
    """(shard, local_id) for each series index under pack_shards'
    round-robin placement: the one definition callers use to build
    per-series side tables (the multigroup group map) that must agree
    with the packing."""
    return [(i % n_shards, i // n_shards) for i in range(n_series)]


def pack_shards(series: list[tuple], n_shards: int):
    """Partition [(ts, vals)] series into n stacked shards per
    shard_placement. Returns (ts, vals, sid, valid) as [D, N_shard]
    numpy arrays plus series_per_shard."""
    blocks: list[list[tuple]] = [[] for _ in range(n_shards)]
    for (d, _), s in zip(shard_placement(len(series), n_shards), series):
        blocks[d].append(s)
    series_per_shard = max(len(b) for b in blocks)
    n_shard = max(
        (sum(len(s[0]) for s in b) for b in blocks), default=1)
    n_shard = max(n_shard, 1)
    ts = np.zeros((n_shards, n_shard), np.int32)
    vals = np.zeros((n_shards, n_shard), np.float32)
    sid = np.zeros((n_shards, n_shard), np.int32)
    valid = np.zeros((n_shards, n_shard), bool)
    for d, block in enumerate(blocks):
        off = 0
        for local_id, (sts, svals) in enumerate(block):
            n = len(sts)
            ts[d, off:off + n] = sts
            vals[d, off:off + n] = svals
            sid[d, off:off + n] = local_id
            valid[d, off:off + n] = True
            off += n
    return ts, vals, sid, valid, series_per_shard
