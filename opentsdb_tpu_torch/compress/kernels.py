"""The fused decode-plus-aggregate stage over TSST4 blocks.

Mirrors ``opentsdb_tpu/compress/kernels.py`` of the JAX package, as plain
functions on tensors with the JAX signatures: the blocks' packed payload
streams go in, the per-(series, bucket) stage grids the query pipeline
consumes come out (``ops/kernels._window_series_stage``, the stage the
resident window's chunk fold also ends in, so every group aggregator,
percentile, rate and fill is shared, not re-implemented). The decoded
columns live only on the device.

- ``decode_points``: the batched decode, the hand-written kernel of
  ``ops/block_decode.py`` (its plain version on CPU tensors);
- ``fused_block_stage`` / ``fused_block_stage_sel``: decode + range mask +
  window stage over the byte streams, the second with the selector's
  matched-point compaction (decode the full streams, since the value
  chains span whole blocks, then stage only the matched points);
- ``block_decode_columns``: the device block cache's decode of one gather
  (``compress/devcache.py``);
- ``devcache_window_stage`` / ``devcache_window_stage_sel``: the window
  stage over cached decoded columns, expanding per-record uploads point by
  point.

The gathers (``deltas[sel]``, ``rel_base[rec_of_pt]`` and the like) are
one-index-a-point tensor indexing, as XLA also emits them as gathers; the
segment reductions under the stage are the port's kernels
(``ops/segment_reduce.py``). Answers are bit-identical between the legs:
the same decode on the same concatenated stream, the same point order,
the same stage.

The mesh leg (``FUSED_STAGE_PLAN``, ``_fused_block_stage_ops``,
``fused_block_stage_mesh``) runs the stage over block-aligned shards of the
point stream (``compress/fused.block_shards``: whole blocks a shard, each
with its own payload bytes, so no decode chain crosses a cut). Each shard
decodes its blocks with the decode kernel and folds its points into
per-(series, bucket) partials (count, sum, M2 centred on the shard's own
means, min, max) through the segment kernels; one collective merges the
[D, S*B] partial planes with the hand-written ``moment_combine`` kernel
(``ops/mesh_combine.py``: Chan et al.'s merge in shard order, then the
aggregator), and the rate and fill tail runs once on the mesh's first
device. The rate is a bucket rate over the finished [S, B] grid, so no
point crosses a cut after the merge. JAX's global-view program runs two
segment passes with a psum after each instead; the two agree within the
fused path's float32 contract (partial-sum order changes), with count,
min, max and the masks exact.
"""

from __future__ import annotations

import torch

from opentsdb_tpu_torch.ops import mesh_combine
from opentsdb_tpu_torch.ops.block_decode import decode_points
from opentsdb_tpu_torch.ops.kernels import (_needs, _segment_moments,
                                            _series_segments, _stage_tail,
                                            _window_series_stage,
                                            bucket_rate)
from opentsdb_tpu_torch.parallel.compile import combine, compile_with_plan
from opentsdb_tpu_torch.parallel.mesh import SERIES_AXIS
from opentsdb_tpu_torch.parallel.plan import ExecPlan


def fused_block_stage(ts_nb, ts_pay, v_nb, v_pay, first_idx, blk_first,
                      rel_base, sid, valid, lo, hi, shift, *, num_series,
                      num_buckets, interval, agg_down, rate=False,
                      counter_max=0.0, reset_value=0.0, counter=False,
                      drop_resets=False, vkind="f32"):
    """Decode + range mask + per-series downsample over per-point arrays
    (padding has valid=False and nb=0). Returns the window-stage contract
    (series_values, series_mask, filled, in_range, presence) that
    ops.kernels.window_moment_apply / window_quantile_apply consume."""
    rel_ts, vals = decode_points(ts_nb, ts_pay, v_nb, v_pay, first_idx,
                                 blk_first, rel_base, vkind=vkind)
    return _window_series_stage(
        rel_ts, vals, sid, valid, lo, hi, shift, num_series=num_series,
        num_buckets=num_buckets, interval=interval, agg_down=agg_down,
        rate=rate, counter_max=counter_max, reset_value=reset_value,
        counter=counter, drop_resets=drop_resets)


_FUSED_STATICS = ("num_series", "num_buckets", "interval", "agg_down",
                  "rate", "counter", "drop_resets", "vkind")

# The nine per-point and payload streams shard, one row of whole blocks a
# shard ([D, ...] stacked, compress/fused.block_shards); the range bounds
# and the client's rate parameters replicate. The five stage grids come
# back once, on the mesh's first device.
FUSED_STAGE_PLAN = ExecPlan(
    name="compress.fused_stage", axis="block", style="pjit",
    in_specs=(SERIES_AXIS,) * 9 + (None,) * 5,
    out_specs=(None,) * 5)


def _fused_combine(payloads, dev):
    """The mesh leg's one collective: the shards' [C] partial planes
    stacked [D, C] and merged by the moment_combine kernel, then the
    stage's rate and fill tail, once. Payload: (statics, counter_max,
    reset_value, count, total, m2, min, max)."""
    (num_series, num_buckets, interval, agg_down, rate, counter,
     drop_resets), counter_max, reset_value = payloads[0][:3]
    want = mesh_combine.needs(agg_down)

    def plane(i, name):
        if name not in want:
            return None
        return torch.stack([p[i].to(dev) for p in payloads])

    n = torch.stack([p[3].to(dev) for p in payloads])
    value, mask = mesh_combine.moment_combine(
        n, plane(4, "total"), plane(5, "m2"), plane(6, "min"),
        plane(7, "max"), (n > 0).to(torch.int32), agg=agg_down)
    shape = (num_series, num_buckets)
    series_values = value.reshape(shape)
    series_mask = mask.reshape(shape)
    presence = series_mask.any(dim=1)  # pre-rate, like downsample_group
    if rate:
        series_values, series_mask = bucket_rate(
            series_values, series_mask, interval, counter_max,
            reset_value, counter=counter, drop_resets=drop_resets)
    return _stage_tail(series_values, series_mask, presence,
                       num_buckets=num_buckets, rate=rate)


def _fused_block_stage_ops(ts_nb, ts_pay, v_nb, v_pay, first_idx,
                           blk_first, rel_base, sid, valid, lo, hi, shift,
                           counter_max, reset_value, *, axis_index=0,
                           num_series, num_buckets, interval, agg_down,
                           rate=False, counter=False, drop_resets=False,
                           vkind="f32"):
    """One shard of the fused stage's mesh leg, all positional (the JAX
    face's). ``counter_max`` / ``reset_value`` are operands, never
    statics: they are client-controlled, and a static would let one
    hostile dashboard mint a dispatcher per request. The shard decodes
    its own whole blocks, folds its in-range points into per-(series,
    bucket) partials (the trash segment S*B sliced off), and yields them
    to ``_fused_combine``; every shard returns the combined stage."""
    rel_ts, vals = decode_points(ts_nb, ts_pay, v_nb, v_pay, first_idx,
                                 blk_first, rel_base, vkind=vkind)
    ok = valid & (rel_ts >= lo) & (rel_ts <= hi)
    C = num_series * num_buckets
    seg, _ = _series_segments(rel_ts - shift, sid, ok,
                              num_series=num_series,
                              num_buckets=num_buckets, interval=interval)
    count, total, m2, mn, mx = _segment_moments(
        vals, seg, ok, C + 1, need=_needs(agg_down))
    statics = (num_series, num_buckets, interval, agg_down, rate, counter,
               drop_resets)
    stage = yield combine(
        _fused_combine, statics, counter_max, reset_value, count[:C],
        *(None if x is None else x[:C] for x in (total, m2, mn, mx)))
    return stage


def fused_block_stage_mesh(mesh, **statics):
    """The fused stage's dispatcher over ``mesh`` with the shape statics
    bound (``_FUSED_STATICS``); it takes the nine [D, ...] shard streams
    of ``compress/fused.block_shards``, then lo, hi, shift, counter_max
    and reset_value. The executor asks per dispatch; the plane's cache
    answers."""
    unknown = set(statics) - set(_FUSED_STATICS)
    if unknown:
        raise TypeError(f"fused_block_stage_mesh: unknown statics "
                        f"{sorted(unknown)}")
    return compile_with_plan(_fused_block_stage_ops, FUSED_STAGE_PLAN,
                             mesh, statics=tuple(sorted(statics.items())))


def fused_block_stage_sel(ts_nb, ts_pay, v_nb, v_pay, first_idx,
                          blk_first, sel, rel_base, sid, valid, lo, hi,
                          shift, *, num_series, num_buckets, interval,
                          agg_down, rate=False, counter_max=0.0,
                          reset_value=0.0, counter=False,
                          drop_resets=False, vkind="f32"):
    """The fused stage with the selector's compaction: decode the FULL
    streams, then stage only the matched points ``sel`` (host-computed
    indices; ``rel_base``/``sid``/``valid`` already in the same [M]
    layout, padding entries valid=False). Bit-identical to the unselected
    stage: dropped points belong to records the stage would mask out, and
    kept points stay in stream order."""
    deltas, vals = decode_points(ts_nb, ts_pay, v_nb, v_pay, first_idx,
                                 blk_first, 0, vkind=vkind)
    sel = sel.long()
    rel_ts = rel_base + deltas[sel]
    return _window_series_stage(
        rel_ts, vals[sel], sid, valid, lo, hi, shift,
        num_series=num_series, num_buckets=num_buckets, interval=interval,
        agg_down=agg_down, rate=rate, counter_max=counter_max,
        reset_value=reset_value, counter=counter, drop_resets=drop_resets)


def block_decode_columns(ts_nb, ts_pay, v_nb, v_pay, first_idx, blk_first,
                         *, vkind="f32"):
    """One gather's cached device columns: (qualifier deltas int32, values
    float32) over the concatenated block streams. Padding points carry
    nb == 0 and first_idx/blk_first == their own index, so they decode to
    exact zeros."""
    return decode_points(ts_nb, ts_pay, v_nb, v_pay, first_idx, blk_first,
                         torch.zeros_like(first_idx), vkind=vkind)


def devcache_window_stage(qd, vals, rec_of_pt, rel_base, sid, valid, lo,
                          hi, shift, counter_max, reset_value, *,
                          num_series, num_buckets, interval, agg_down,
                          rate=False, counter=False, drop_resets=False):
    """Window stage over cached decoded columns: the per-record uploads
    expanded point-wise (three gathers), no payload bytes, no decode.
    Padding points map to a trailing pad record with valid=False."""
    rec = rec_of_pt.long()
    rel_ts = rel_base[rec] + qd
    return _window_series_stage(
        rel_ts, vals, sid[rec], valid[rec], lo, hi, shift,
        num_series=num_series, num_buckets=num_buckets, interval=interval,
        agg_down=agg_down, rate=rate, counter_max=counter_max,
        reset_value=reset_value, counter=counter, drop_resets=drop_resets)


def devcache_window_stage_sel(qd, vals, rec_of_pt, sel, rel_base, sid,
                              valid, lo, hi, shift, counter_max,
                              reset_value, *, num_series, num_buckets,
                              interval, agg_down, rate=False,
                              counter=False, drop_resets=False):
    """Window stage over cached columns with the selector's compaction:
    only the matched points ``sel`` (padded with an index whose record is
    invalid) are gathered before the per-record uploads expand, so the
    cached columns stay selector-independent."""
    sel = sel.long()
    rec_g = rec_of_pt[sel].long()
    rel_ts = rel_base[rec_g] + qd[sel]
    return _window_series_stage(
        rel_ts, vals[sel], sid[rec_g], valid[rec_g], lo, hi, shift,
        num_series=num_series, num_buckets=num_buckets, interval=interval,
        agg_down=agg_down, rate=rate, counter_max=counter_max,
        reset_value=reset_value, counter=counter, drop_resets=drop_resets)
