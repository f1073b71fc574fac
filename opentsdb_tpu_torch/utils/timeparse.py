"""Human-friendly duration and date parsing for queries and CLI tools.

Mirrors ``opentsdb_tpu/utils/timeparse.py`` of the JAX package, copied rather
than imported: the port imports nothing of that package.

Parity with reference src/tsd/GraphHandler.java: parseDuration (:903-923 —
suffixes s/m/h/d/w/y, year = 365 days), and getQueryStringDate (:955-990 —
"Nu-ago" relatives, "yyyy/MM/dd-HH:mm:ss" absolutes, raw UNIX timestamps).
"""

from __future__ import annotations

import time
import zoneinfo
from datetime import datetime

from opentsdb_tpu_torch.core.errors import BadRequestError

_SUFFIX_SECONDS = {
    "s": 1,
    "m": 60,
    "h": 3600,
    "d": 3600 * 24,
    "w": 3600 * 24 * 7,
    "y": 3600 * 24 * 365,  # no leap years, like the reference
}


def parse_duration(duration: str) -> int:
    """Parse "10m" / "3h" / "14d" into a strictly positive seconds count."""
    if len(duration) < 2:
        raise BadRequestError(f"Invalid duration (number): {duration}")
    try:
        interval = int(duration[:-1])
    except ValueError:
        raise BadRequestError(f"Invalid duration (number): {duration}") from None
    if interval <= 0:
        raise BadRequestError(f"Zero or negative duration: {duration}")
    mult = _SUFFIX_SECONDS.get(duration[-1])
    if mult is None:
        raise BadRequestError(f"Invalid duration (suffix): {duration}")
    return interval * mult



def is_relative_date(date: str | None) -> bool:
    """True if the date is absent (defaultable) or ends in "-ago"."""
    return date is None or date.endswith("-ago")


def parse_date(date: str, tz: str | None = None,
               now: int | None = None) -> int:
    """Parse a query date into UNIX seconds.

    Accepts "5m-ago"-style relatives, "yyyy/MM/dd-HH:mm:ss" (also with a
    space or missing time component), or a raw UNIX timestamp.
    """
    if now is None:
        now = int(time.time())
    if date.endswith("-ago"):
        return now - parse_duration(date[:-4])
    if len(date) < 5 or date[4] != "/":
        try:
            ts = int(date)
        except ValueError:
            raise BadRequestError(f"Invalid time: {date}") from None
        if ts < 0:
            raise BadRequestError(f"Bad date: {date}")
        return ts
    text = date.replace(" ", "-")
    for fmt in ("%Y/%m/%d-%H:%M:%S", "%Y/%m/%d-%H:%M", "%Y/%m/%d"):
        try:
            dt = datetime.strptime(text, fmt)
            break
        except ValueError:
            continue
    else:
        raise BadRequestError(f"Invalid date: {date}")
    if tz is not None:
        try:
            dt = dt.replace(tzinfo=zoneinfo.ZoneInfo(tz))
        except (zoneinfo.ZoneInfoNotFoundError, ValueError):
            raise BadRequestError(f"Invalid timezone name: {tz}") from None
    else:
        dt = dt.astimezone()
    ts = int(dt.timestamp())
    if ts < 0:
        raise BadRequestError(f"Bad date: {date}")
    return ts
