"""Trace ring + slow-query log: where finished query traces go.

Mirrors ``opentsdb_tpu/obs/ring.py`` of the JAX package, copied rather
than imported. The slow-query logger is ``opentsdb_tpu_torch.slowquery``
(the JAX package's is ``opentsdb_tpu.slowquery``).

Two consumers, one record shape:

- ``TraceRing``: a bounded in-memory ring (``Config.trace_ring``
  records) served verbatim at ``/api/traces`` — the last N traced
  queries (explicit ``?trace=1`` requests and every slow query), newest
  last. Bounded by construction; an idle server holds whatever the last
  burst left, nothing grows.
- the slow-query log: queries slower than ``Config.slow_query_ms``
  additionally emit ONE line of JSON on the
  ``opentsdb_tpu_torch.slowquery`` logger (captured by the server's /logs
  ring like every other log line, and by whatever handler the
  operator attaches) — structured enough to grep a day of them into a
  latency histogram, flat enough to read raw.

A record is a plain JSON-ready dict::

    {"ts": epoch_s, "q": "<m= spec>", "wall_ms": 12.3,
     "plan": "1h"|"raw"|"resident", "cached": bool, "slow": bool,
     "shards": N, "replica": bool, "trace": {span tree}}

The span tree is ``obs.trace.Span.to_dict`` output: ``name``/``ms``/
``tags``/``spans``.
"""

from __future__ import annotations

import collections
import json
import logging
import threading
import time

SLOW_LOG = logging.getLogger("opentsdb_tpu_torch.slowquery")


class TraceRing:
    """Bounded ring of finished trace records, newest last."""

    def __init__(self, capacity: int = 256) -> None:
        self._ring: collections.deque = collections.deque(
            maxlen=max(int(capacity), 1))
        self._lock = threading.Lock()
        self.recorded = 0      # total records ever added (stats)
        self.slow = 0          # records flagged slow (stats)

    def add(self, record: dict) -> None:
        with self._lock:
            self._ring.append(record)
            self.recorded += 1
            if record.get("slow"):
                self.slow += 1

    def snapshot(self) -> list[dict]:
        with self._lock:
            return list(self._ring)

    def __len__(self) -> int:
        with self._lock:
            return len(self._ring)


def make_record(q: str, trace, plan: str, cached: bool,
                slow_ms: float, shards: int, replica: bool) -> dict:
    """Build one ring/log record from a finished ``obs.trace.Trace``."""
    wall = float(trace.total_ms)
    return {
        "ts": int(time.time()),
        "trace_id": getattr(trace, "trace_id", None),
        "q": q,
        "wall_ms": round(wall, 3),
        "plan": plan,
        "cached": bool(cached),
        "slow": bool(slow_ms > 0 and wall >= slow_ms),
        "shards": int(shards),
        "replica": bool(replica),
        "trace": trace.to_dict(),
    }


def log_slow(record: dict) -> None:
    """Emit the one-line JSON slow-query record (WARNING level so the
    default INFO config shows it without drowning in per-query noise)."""
    SLOW_LOG.warning("%s", json.dumps(record, separators=(",", ":"),
                                      sort_keys=True))
