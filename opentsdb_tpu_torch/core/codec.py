"""Byte codecs for row keys, qualifiers, values, and compacted cells.

Mirrors ``opentsdb_tpu/core/codec.py`` of the JAX package, copied rather
than imported: the port imports nothing of that package.

This module is the *only* place that knows the byte-packed cell format; the
compute path decodes rows into columnar numpy arrays (see ``to_columns``) and
never touches bytes again. Format parity with the reference:

  row key    = [metric:3][base_time:4][tagk:3 tagv:3]*   (13..19+ bytes)
               reference src/core/IncomingDataPoints.java:109-135
  qualifier  = 2 bytes big-endian: (delta << 4) | flags, delta in [0, 3599]
               reference src/core/TSDB.java:340-344
  flags      = FLAG_FLOAT(0x8) | (value_len - 1)
               ints: 1/2/4/8-byte big-endian two's complement (smallest fit,
               reference src/core/TSDB.java:240-249); floats: 4-byte IEEE754
               single (flags 0xB), doubles: 8-byte (flags 0xF,
               reference src/core/TSDB.java:276-328)
  compacted  = concatenated 2-byte qualifiers || concatenated values || 0x00
               meta byte (reference src/core/CompactionQueue.java:450-474)

The historical float-encoding bug (4-byte float stored on 8 bytes with 4
leading zero bytes, flags claiming 4) is detected and repaired exactly like
reference CompactionQueue.fixFloatingPointValue (:519-544).
"""

from __future__ import annotations

import struct
from typing import Iterable, NamedTuple

import numpy as np

from opentsdb_tpu_torch.core.const import (
    FLAG_BITS,
    FLAG_FLOAT,
    FLAGS_MASK,
    LENGTH_MASK,
    MAX_TIMESPAN,
    TIMESTAMP_BYTES,
    UID_WIDTH,
)
from opentsdb_tpu_torch.core.errors import IllegalDataError

_INT8 = struct.Struct(">b")
_INT16 = struct.Struct(">h")
_INT32 = struct.Struct(">i")
_INT64 = struct.Struct(">q")
_FLOAT32 = struct.Struct(">f")
_FLOAT64 = struct.Struct(">d")
_UINT16 = struct.Struct(">H")
_UINT32 = struct.Struct(">I")


# ---------------------------------------------------------------------------
# Values
# ---------------------------------------------------------------------------

def encode_long(value: int) -> tuple[bytes, int]:
    """Encode an integer on the smallest of 1/2/4/8 big-endian bytes.

    Returns (value_bytes, flags). Parity: reference TSDB.java:240-249.
    """
    if -0x80 <= value <= 0x7F:
        return _INT8.pack(value), 0
    if -0x8000 <= value <= 0x7FFF:
        return _INT16.pack(value), 1
    if -0x80000000 <= value <= 0x7FFFFFFF:
        return _INT32.pack(value), 3
    if -0x8000000000000000 <= value <= 0x7FFFFFFFFFFFFFFF:
        return _INT64.pack(value), 7
    raise ValueError(f"value out of int64 range: {value}")


def encode_float(value: float) -> tuple[bytes, int]:
    """Encode a float on 4 IEEE754 bytes. Parity: reference TSDB.java:321-328."""
    if value != value or value in (float("inf"), float("-inf")):
        raise ValueError(f"value is NaN or Infinite: {value}")
    return _FLOAT32.pack(value), FLAG_FLOAT | 0x3



def decode_value(buf: bytes, flags: int) -> int | float:
    """Decode a value given its qualifier flags.

    Parity: reference RowSeq.extractIntegerValue/extractFloatingPointValue
    (:194-226), including tolerance for the 8-bytes-with-leading-zeros float.
    """
    if flags & FLAG_FLOAT:
        length = (flags & LENGTH_MASK) + 1
        if length == 4:
            if len(buf) == 8:
                # Historical mis-encoding: real float in the last 4 bytes.
                if buf[:4] != b"\x00\x00\x00\x00":
                    raise IllegalDataError(
                        f"Corrupted floating point value: {buf.hex()} flags="
                        f"{flags:#x} -- first 4 bytes are expected to be zeros")
                buf = buf[4:]
            return _FLOAT32.unpack(buf)[0]
        if length == 8:
            return _FLOAT64.unpack(buf)[0]
        raise IllegalDataError(
            f"Unsupported float length {length} (flags={flags:#x})")
    length = len(buf)
    if length == 1:
        return _INT8.unpack(buf)[0]
    if length == 2:
        return _INT16.unpack(buf)[0]
    if length == 4:
        return _INT32.unpack(buf)[0]
    if length == 8:
        return _INT64.unpack(buf)[0]
    raise IllegalDataError(f"Invalid integer value length {length}")


# ---------------------------------------------------------------------------
# Qualifiers
# ---------------------------------------------------------------------------

def encode_qualifier(delta: int, flags: int) -> bytes:
    """Pack (delta seconds within the row, flags) into the 2-byte qualifier."""
    if not 0 <= delta < MAX_TIMESPAN:
        raise ValueError(f"time delta out of range: {delta}")
    return _UINT16.pack((delta << FLAG_BITS) | (flags & FLAGS_MASK))


def decode_qualifier(qual: bytes) -> tuple[int, int]:
    """Unpack a 2-byte qualifier into (delta, flags)."""
    q = _UINT16.unpack(qual)[0]
    return q >> FLAG_BITS, q & FLAGS_MASK


def fix_qualifier_flags(flags: int, val_len: int) -> int:
    """Zero every flag bit but FLAG_FLOAT; set length from the actual value.

    Parity: reference CompactionQueue.fixQualifierFlags (:490-501).
    """
    return (flags & ~(FLAGS_MASK >> 1)) | (val_len - 1)


def needs_float_fix(flags: int, value: bytes) -> bool:
    """True for the historical float-on-8-bytes bug (flags say 4 bytes)."""
    return bool(flags & FLAG_FLOAT) and (flags & LENGTH_MASK) == 0x3 \
        and len(value) == 8


def fix_float_value(flags: int, value: bytes) -> bytes:
    """Strip the 4 leading zero bytes off a mis-encoded float value.

    Parity: reference CompactionQueue.fixFloatingPointValue (:519-544).
    """
    if needs_float_fix(flags, value):
        if value[:4] != b"\x00\x00\x00\x00":
            raise IllegalDataError(
                f"Corrupted floating point value: {value.hex()} flags="
                f"{flags:#x} -- first 4 bytes are expected to be zeros")
        return value[4:]
    return value


# ---------------------------------------------------------------------------
# Row keys
# ---------------------------------------------------------------------------

def base_time(timestamp: int) -> int:
    """Row base time: timestamp floored to the MAX_TIMESPAN boundary."""
    return timestamp - (timestamp % MAX_TIMESPAN)


def row_key(metric_uid: bytes, base_ts: int,
            tag_uids: Iterable[tuple[bytes, bytes]]) -> bytes:
    """Build [metric][base_time][tagk tagv]* — tag pairs must be pre-sorted.

    Parity: reference IncomingDataPoints.rowKeyTemplate (:109-135).
    """
    parts = [metric_uid, _UINT32.pack(base_ts & 0xFFFFFFFF)]
    for tagk, tagv in tag_uids:
        parts.append(tagk)
        parts.append(tagv)
    return b"".join(parts)



class ParsedRowKey(NamedTuple):
    metric_uid: bytes
    base_time: int
    tag_uids: tuple[tuple[bytes, bytes], ...]


def parse_row_key(key: bytes) -> ParsedRowKey:
    """Split a row key back into (metric, base_time, ((tagk, tagv), ...))."""
    prefix = UID_WIDTH + TIMESTAMP_BYTES
    if len(key) < prefix or (len(key) - prefix) % (2 * UID_WIDTH) != 0:
        raise IllegalDataError(f"invalid row key length {len(key)}")
    metric = key[:UID_WIDTH]
    base_ts = _UINT32.unpack(key[UID_WIDTH:prefix])[0]
    tags = []
    for off in range(prefix, len(key), 2 * UID_WIDTH):
        tags.append((key[off:off + UID_WIDTH],
                     key[off + UID_WIDTH:off + 2 * UID_WIDTH]))
    return ParsedRowKey(metric, base_ts, tuple(tags))


def key_base_time(key: bytes) -> int:
    """Just the base-time field of a row key — the scan hot loop calls
    this per row, where parse_row_key's full tag-tuple build would be
    ~3x the row's entire decode budget."""
    return _UINT32.unpack(key[UID_WIDTH:UID_WIDTH + TIMESTAMP_BYTES])[0]


def series_key(key: bytes) -> bytes:
    """The row key minus its base-time bytes: identifies one time series.

    Two rows belong to the same Span iff their series keys are equal —
    parity with reference TsdbQuery.SpanCmp (:594-623), which compares keys
    ignoring the timestamp bytes.
    """
    return key[:UID_WIDTH] + key[UID_WIDTH + TIMESTAMP_BYTES:]


def series_tag_uids(skey: bytes) -> dict[bytes, bytes]:
    """Tag (tagk_uid -> tagv_uid) pairs of a SERIES key (metric UID then
    alternating tagk/tagv UIDs — no base-time bytes). The one definition
    of the series-key tag layout; query planning and the devwindow
    series directory both parse through here."""
    w = UID_WIDTH
    return {skey[i:i + w]: skey[i + w:i + 2 * w]
            for i in range(w, len(skey), 2 * w)}


# ---------------------------------------------------------------------------
# Cells and compaction-format helpers
# ---------------------------------------------------------------------------

class Cell(NamedTuple):
    """One (qualifier, value) pair; sort order is by qualifier bytes.

    Parity: reference CompactionQueue.Cell (:690-743 environs).
    """
    qualifier: bytes  # always 2 bytes here (single data point)
    value: bytes

    @property
    def delta(self) -> int:
        return decode_qualifier(self.qualifier)[0]

    @property
    def flags(self) -> int:
        return decode_qualifier(self.qualifier)[1]

    def decode(self) -> int | float:
        return decode_value(self.value, self.flags)


def is_compacted_qualifier(qual: bytes) -> bool:
    """A qualifier longer than 2 (even) bytes marks a compacted cell."""
    return len(qual) > 2 and len(qual) % 2 == 0


def explode_cell(qual: bytes, value: bytes) -> list[Cell]:
    """Break a cell (single or compacted) into individual fixed-up Cells.

    Parity: reference CompactionQueue.breakDownValues (:690-743): validates
    the trailing 0x00 meta byte and exact value-length consumption.
    """
    if len(qual) == 2:
        flags = qual[1] & FLAGS_MASK
        fixed = fix_float_value(flags, value)
        if len(fixed) != len(value) or \
                fix_qualifier_flags(qual[1], len(fixed)) != qual[1]:
            qual = bytes([qual[0], fix_qualifier_flags(qual[1], len(fixed))])
        return [Cell(qual, fixed)]
    if len(qual) % 2 != 0 or len(qual) == 0:
        raise IllegalDataError(f"invalid qualifier length {len(qual)}")
    if value[-1] != 0:
        raise IllegalDataError(
            f"Don't know how to read this value: {value.hex()} -- this "
            "compacted value might have been written by a future version, "
            "or could be corrupt.")
    cells = []
    val_idx = 0
    for i in range(0, len(qual), 2):
        q = qual[i:i + 2]
        vlen = (q[1] & LENGTH_MASK) + 1
        v = value[val_idx:val_idx + vlen]
        if len(v) != vlen:
            raise IllegalDataError(
                f"Corrupted value: ran out of bytes at qualifier {i // 2}")
        val_idx += vlen
        cells.append(Cell(q, v))
    if val_idx != len(value) - 1:
        raise IllegalDataError(
            f"Corrupted value: couldn't break down into individual values "
            f"(consumed {val_idx} bytes, but was expecting to consume "
            f"{len(value) - 1})")
    return cells


def merge_cells(cells: list[Cell]) -> tuple[bytes, bytes]:
    """Merge sorted-deduped Cells into one compacted (qualifier, value).

    Appends the trailing 0x00 meta byte for multi-point cells. A merge that
    collapses to a single point yields a plain single-value cell (2-byte
    qualifier, raw value): on the wire a 2-byte qualifier always means "raw
    value, no meta byte". Callers must have sorted and deduplicated (see
    ``compact_cells``).
    """
    quals = b"".join(c.qualifier for c in cells)
    vals = b"".join(c.value for c in cells)
    if len(cells) != 1:
        vals += b"\x00"
    return quals, vals


def compact_cells(raw: list[tuple[bytes, bytes]]) -> tuple[bytes, bytes]:
    """Full compaction merge of a row's cells -> one (qualifier, value).

    Explodes compacted cells, sorts by qualifier, drops exact duplicates
    (same delta, flags, and value), and raises IllegalDataError on same-delta
    conflicts — parity with reference CompactionQueue.complexCompact
    (:600-679). Works for the trivial all-single-cell case too.
    """
    cells: list[Cell] = []
    for qual, value in raw:
        if len(qual) % 2 != 0 or len(qual) == 0:
            continue  # junk / future format: skip, stay forward-compatible
        cells.extend(explode_cell(qual, value))
    cells.sort(key=lambda c: c.qualifier)
    out: list[Cell] = []
    last_delta = -1
    for cell in cells:
        delta = cell.delta
        if delta == last_delta:
            prev = out[-1]
            if cell.qualifier[1] != prev.qualifier[1] or \
                    cell.value != prev.value:
                raise IllegalDataError(
                    f"Found out of order or duplicate data: delta={delta}, "
                    f"cell={cell}, prev={prev} -- run an fsck.")
            continue  # true duplicate: skip
        last_delta = delta
        out.append(cell)
    return merge_cells(out)


# ---------------------------------------------------------------------------
# Columnar decode — the bridge into the query kernels
# ---------------------------------------------------------------------------

class Columns(NamedTuple):
    """A decoded row (or span of rows) as parallel arrays.

    ``timestamps`` are absolute epoch seconds (int64); ``values`` carries
    every point as float64 (lossless for floats and for ints up to 2^53 —
    beyond that the exact int64 is preserved in ``int_values``);
    ``is_float`` marks which points were stored as floating point.
    """
    timestamps: np.ndarray  # int64 (n,)
    values: np.ndarray      # float64 (n,)
    int_values: np.ndarray  # int64 (n,) — valid where ~is_float
    is_float: np.ndarray    # bool (n,)


