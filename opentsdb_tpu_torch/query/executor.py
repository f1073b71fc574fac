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

Not ported yet, and answered with 400 "not yet ported" on the device
backend instead of being run elsewhere: percentile group aggregators and
un-downsampled queries (the union-grid kernels). The plan label is always
"raw": there is no resident window, rollup tier or fragment cache here.
"""

from __future__ import annotations

import re
from typing import NamedTuple

import numpy as np
import torch

from opentsdb_tpu_torch.core import codec
from opentsdb_tpu_torch.core.const import (MAX_TIMESPAN, TIMESTAMP_BYTES,
                                           UID_WIDTH)
from opentsdb_tpu_torch.core.errors import BadRequestError
from opentsdb_tpu_torch.ops import kernels, oracle
from opentsdb_tpu_torch.query.aggregators import Aggregators


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
    def __init__(self, tsdb, backend: str | None = None) -> None:
        self.tsdb = tsdb
        self.backend = backend or tsdb.config.backend
        if self.backend not in ("device", "cpu"):
            raise ValueError(f"unknown backend {self.backend!r} "
                             f"(device or cpu)")
        self.device = tsdb.device

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

    def _find_spans(self, spec: QuerySpec, start: int, end: int):
        """Scan matching rows into per-series columnar spans, grouped by
        the distinct combinations of group-by tag values."""
        metric_uid = self.tsdb.metrics.get_id(spec.metric)
        exact, group_bys = self._tag_filters(spec.tags)
        group_by_keys = sorted(k for k, _ in group_bys)
        regexp = self._build_regexp(exact, group_bys)
        b_lo = codec.base_time(max(start, 0))
        b_hi = min(codec.base_time(min(end, 0xFFFFFFFF)), 0xFFFFFFFF)
        per_series = self.tsdb.scan_series(
            metric_uid + _u32(b_lo),
            metric_uid + _u32(min(b_hi + MAX_TIMESPAN, 0xFFFFFFFF)),
            key_regexp=regexp)[1]
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
                      ) -> tuple[list[QueryResult], str, bool]:
        """run() plus the plan label ("raw": the scan path is the only
        plan here) and whether the answer came from a cache (never)."""
        if end <= start:
            raise BadRequestError(
                f"end time {end} is <= start time {start}")
        agg = Aggregators.get(spec.aggregator)
        if agg.kind == "cardinality":
            raise BadRequestError(
                "use the /distinct endpoint for cardinality queries")
        if self.backend != "cpu" and not self._oracle_downsample(spec):
            if not spec.downsample:
                raise not_yet_ported(
                    "queries without a downsampler (union-grid kernels)")
            if agg.kind == "percentile":
                raise not_yet_ported(
                    f"percentile group aggregator {spec.aggregator!r}")
        groups = self._find_spans(spec, start, end)
        return self._execute_groups(spec, groups, start, end), "raw", False

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
            qbase = start - start % spec.downsample[0]
            use_cpu = end - qbase > 2**31 - 1
        # A wide group-by batches into ONE kernel call for all groups.
        per_group = None
        if not use_cpu and len(gkeys) > 1:
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
        """One group through downsample_group (the JAX package's
        _tpu_downsample_group): flat downsample [+ rate] + cross-series
        group in one call."""
        interval, dsagg = spec.downsample
        qbase = start - start % interval
        # Power-of-two padding, as in the JAX package, so both compute on
        # identical grids; padded series/buckets hold no points.
        num_buckets = _pad_size(int((end - qbase) // interval + 1))
        rel, vals, sid, valid = self._flatten_spans(spans, qbase)
        out = kernels.downsample_group(
            rel, vals, sid, valid, num_series=_pad_size(len(spans)),
            num_buckets=num_buckets, interval=interval, agg_down=dsagg,
            agg_group=spec.aggregator, **self._rate_kw(spec))
        gmask = out["group_mask"].cpu().numpy()
        values = out["group_values"].cpu().numpy()[gmask]
        grid_ts = np.flatnonzero(gmask).astype(np.int64) * interval + qbase
        return grid_ts, values.astype(np.float64)

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
        S = _pad_size(len(all_spans))
        # Padded series map to group G-1 (possibly a real group) — safe
        # solely because padded series carry no points.
        gmap = np.full(S, G - 1, np.int32)
        gmap[:len(group_of_sid)] = group_of_sid
        rel, vals, sid, valid = self._flatten_spans(all_spans, qbase)
        out = kernels.downsample_multigroup(
            rel, vals, sid, valid, torch.from_numpy(gmap).to(self.device),
            num_series=S, num_groups=G, num_buckets=num_buckets,
            interval=interval, agg_down=dsagg, agg_group=spec.aggregator,
            **self._rate_kw(spec))
        gv = out["group_values"].cpu().numpy()
        gm = out["group_mask"].cpu().numpy()
        results = []
        for gi in range(len(span_groups)):
            mask = gm[gi]
            grid_ts = (np.flatnonzero(mask).astype(np.int64) * interval
                       + qbase)
            results.append((grid_ts, gv[gi][mask].astype(np.float64)))
        return results


def _u32(v: int) -> bytes:
    return int(v).to_bytes(4, "big")


def _pad_size(n: int) -> int:
    """Round up to a power of two (min 16) — the JAX package's padding,
    kept so both packages compute on identical grids."""
    size = 16
    while size < n:
        size *= 2
    return size
