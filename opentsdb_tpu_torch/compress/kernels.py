"""The fused decode-plus-aggregate stage over TSST4 blocks.

Mirrors ``opentsdb_tpu/compress/kernels.py`` of the JAX package, as plain
functions on tensors with the JAX signatures (less the mesh leg): the
blocks' packed payload streams go in, the per-(series, bucket) stage grids
the query pipeline consumes come out (``ops/kernels._window_series_stage``,
the stage the resident window's chunk fold also ends in, so every group
aggregator, percentile, rate and fill is shared, not re-implemented). The
decoded columns live only on the device.

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

Left out, with ROADMAP queue A item 11 (the mesh): ``fused_block_stage_mesh``,
``_fused_block_stage_ops`` and ``FUSED_STAGE_PLAN``.
"""

from __future__ import annotations

import torch

from opentsdb_tpu_torch.ops.block_decode import decode_points
from opentsdb_tpu_torch.ops.kernels import _window_series_stage


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
