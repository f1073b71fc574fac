"""Tag and metric-name grammar: parsing, validation, resolution helpers.

Mirrors ``opentsdb_tpu/core/tags.py`` of the JAX package, copied rather
than imported: the port imports nothing of that package.

Parity with reference src/core/Tags.java: the ``k=v`` pair grammar (:77-91),
``metric{k=v,k2=v2}`` combined grammar (:101-125), the allowed character set
``[a-zA-Z0-9-_./]`` (:282-297), fast whitespace splitting (:46-67), and
O(1)-space integer parsing (:137-178).
"""

from __future__ import annotations

import re

from opentsdb_tpu_torch.core.const import MAX_NUM_TAGS

_ALLOWED = frozenset(
    "abcdefghijklmnopqrstuvwxyzABCDEFGHIJKLMNOPQRSTUVWXYZ0123456789-_./")


def split_string(s: str, sep: str = " ") -> list[str]:
    """Split on single-char separator, skipping empty runs.

    Matches reference Tags.splitString used by the telnet word splitter:
    consecutive separators yield no empty tokens.
    """
    return [tok for tok in s.split(sep) if tok]


def validate_string(what: str, s: str) -> None:
    """Ensure s is non-empty and uses only the legal character set."""
    if not s:
        raise ValueError(f"Invalid {what}: empty string")
    for c in s:
        if c not in _ALLOWED:
            raise ValueError(
                f"Invalid {what} (\"{s}\"): illegal character: {c}")


def parse(tags: dict[str, str], tag: str) -> None:
    """Parse one "name=value" into the dict; duplicate names must agree."""
    eq = tag.find("=")
    if eq < 1 or eq == len(tag) - 1:
        raise ValueError(f"invalid tag: {tag}")
    name, value = tag[:eq], tag[eq + 1:]
    if tags.get(name, value) != value:
        raise ValueError(f"duplicate tag: {tag}, tags={tags}")
    tags[name] = value


def parse_with_metric(expr: str, tags: dict[str, str]) -> str:
    """Parse "metric" or "metric{k=v,...}" filling tags; returns the metric.

    An empty tag list inside braces ("metric{}") is invalid, matching the
    reference's strictness (Tags.java:101-125).
    """
    curly = expr.find("{")
    if curly < 0:
        return expr
    if curly == 0:
        raise ValueError(f"Missing metric name: {expr}")
    if not expr.endswith("}"):
        raise ValueError(f"Missing '}}' at the end of: {expr}")
    metric = expr[:curly]
    inner = expr[curly + 1:-1]
    if not inner:
        raise ValueError(f"Empty tag list in: {expr}")
    for tag in inner.split(","):
        parse(tags, tag)
    return metric


def parse_long(s: str) -> int:
    """Parse a signed base-10 int64, rejecting junk and overflow."""
    if not s:
        raise ValueError("empty string")
    body = s[1:] if s[0] in "+-" else s
    if not body or not body.isdigit():
        raise ValueError(f"Invalid character in {s}")
    v = int(s)
    if not -0x8000000000000000 <= v <= 0x7FFFFFFFFFFFFFFF:
        raise ValueError(f"number overflow: {s}")
    return v


def looks_like_integer(s: str) -> bool:
    """Cheap sniff used by the ingest path to pick int vs float encoding."""
    if not s:
        return False
    body = s[1:] if s[0] in "+-" else s
    return body.isdigit()


_FLOAT_RE = re.compile(r"[+-]?(\d+(\.\d*)?|\.\d+)([eE][+-]?\d+)?")


def parse_value(s: str) -> tuple[bool, int, float]:
    """Parse a wire value into (is_float, int_value, float_value).

    The float grammar is strict — [+-]?(digits[.digits] | .digits)[exp] —
    and shared byte-for-byte with the native decoder, so acceptance never
    depends on which parser handled the line (no hex floats, no
    underscore literals, no nan/inf).
    """
    if looks_like_integer(s):
        iv = parse_long(s)
        return False, iv, float(iv)
    if not _FLOAT_RE.fullmatch(s):
        raise ValueError(f"invalid value: {s}")
    return True, 0, float(s)


def check_metric_and_tags(metric: str, tags: dict[str, str]) -> None:
    """Validate a full (metric, tags) pair before ingest.

    Parity: reference IncomingDataPoints.checkMetricAndTags (:83-104) —
    non-empty tags, at most MAX_NUM_TAGS, charset-clean names/values.
    """
    if not tags:
        raise ValueError(
            f"Need at least one tag (metric={metric}, tags={tags})")
    if len(tags) > MAX_NUM_TAGS:
        raise ValueError(
            f"Too many tags: {len(tags)} maximum allowed: {MAX_NUM_TAGS}")
    validate_string("metric name", metric)
    for k, v in tags.items():
        validate_string("tag name", k)
        validate_string("tag value", v)
