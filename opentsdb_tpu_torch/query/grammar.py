"""The m= query expression grammar.

Mirrors ``opentsdb_tpu/query/grammar.py`` of the JAX package, copied rather
than imported: the port imports nothing of that package.

Parity: reference GraphHandler.parseQuery (:828-879) —
``agg:[interval-agg:][rate:]metric[{tag=value,...}]`` where the optional
middle parts may appear in either order; tag values support ``*`` (group
by all values) and ``v1|v2`` (group by listed values). Extension beyond
the 1.1 reference: ``rate{counter[,max[,reset]]}`` rollover options (the
2.x syntax), since the executor's rate kernel handles counter wraps.
"""

from __future__ import annotations

from typing import NamedTuple

from opentsdb_tpu_torch.core import tags as tags_mod
from opentsdb_tpu_torch.core.errors import BadRequestError
from opentsdb_tpu_torch.query.aggregators import Aggregators
from opentsdb_tpu_torch.utils.timeparse import parse_duration


def _validate_agg(name: str) -> None:
    try:
        Aggregators.get(name)
    except ValueError as e:
        raise BadRequestError(str(e)) from None


class ParsedMetric(NamedTuple):
    aggregator: str
    metric: str
    tags: dict[str, str]
    rate: bool
    downsample: tuple[int, str] | None  # (interval_seconds, agg)
    counter: bool = False
    counter_max: float = float(2 ** 64)
    reset_value: float | None = None


def _parse_rate_options(part: str, expr: str) -> tuple[bool, float,
                                                       float | None]:
    """``rate{counter[,max[,reset]]}`` -> (counter, counter_max, reset)."""
    body = part[len("rate{"):-1]
    fields = body.split(",") if body else []
    if not fields or fields[0] != "counter":
        raise BadRequestError(f"Invalid rate options: {part} in m={expr}")
    counter_max = float(2 ** 64)
    reset: float | None = None
    try:
        if len(fields) > 1 and fields[1]:
            counter_max = float(fields[1])
        if len(fields) > 2 and fields[2]:
            reset = float(fields[2])
        if len(fields) > 3:
            raise ValueError("too many rate options")
    except ValueError as e:
        raise BadRequestError(
            f"Invalid rate options: {part} in m={expr}: {e}") from None
    return True, counter_max, reset


def parse_m(expr: str) -> ParsedMetric:
    parts = expr.split(":")
    if len(parts) < 2:
        raise BadRequestError(
            f"smallest possible metric name is 7 chars, got: {expr}"
            if not expr else f"Invalid parameter m={expr}")
    agg = parts[0]
    _validate_agg(agg)

    rate = False
    counter = False
    counter_max = float(2 ** 64)
    reset_value: float | None = None
    downsample = None
    for part in parts[1:-1]:
        if part == "rate":
            rate = True
        elif part.startswith("rate{") and part.endswith("}"):
            rate = True
            counter, counter_max, reset_value = _parse_rate_options(
                part, expr)
        elif "-" in part:
            interval_s, _, ds_agg = part.partition("-")
            interval = parse_duration(interval_s)
            _validate_agg(ds_agg)
            # Moment downsamplers (the classic set) plus percentile
            # downsamplers (``1h-p95``): the latter serve exactly via
            # the float64 oracle, or approximately from rollup sketch
            # columns under the error contract (sketch/serving.py).
            kind = Aggregators.get(ds_agg).kind
            if kind not in ("moment", "percentile"):
                raise BadRequestError(
                    f"downsampler must be a moment or percentile "
                    f"aggregator: {ds_agg}")
            downsample = (interval, ds_agg)
        else:
            raise BadRequestError(f"Invalid query part: {part} in m={expr}")

    tag_map: dict[str, str] = {}
    try:
        metric = tags_mod.parse_with_metric(parts[-1], tag_map)
    except ValueError as e:
        raise BadRequestError(str(e)) from None
    return ParsedMetric(agg, metric, tag_map, rate, downsample,
                        counter, counter_max, reset_value)
