"""In-RAM ring of recent log events, surfaced at /logs.

Mirrors ``opentsdb_tpu/server/logbuffer.py`` of the JAX package, copied
rather than imported. Its lines carry the logger's name, so the port's
records name ``opentsdb_tpu_torch.*`` loggers where the JAX daemon's
name ``opentsdb_tpu.*`` ones.

Parity: reference src/logback.xml's CyclicBufferAppender (1024 events) +
LogsRpc (:62-103) including runtime log-level changes via ?level=.
"""

from __future__ import annotations

import collections
import logging

RING_SIZE = 1024


class RingBufferHandler(logging.Handler):
    def __init__(self, capacity: int = RING_SIZE) -> None:
        super().__init__()
        self.events: collections.deque[logging.LogRecord] = \
            collections.deque(maxlen=capacity)

    def emit(self, record: logging.LogRecord) -> None:
        self.events.append(record)

    def formatted(self, reverse: bool = True) -> list[str]:
        out = []
        # Snapshot: other threads append concurrently, and iterating a
        # mutating deque raises RuntimeError.
        for rec in list(self.events):
            out.append("%d\t%s\t%s\t%s\t%s" % (
                int(rec.created), rec.levelname, rec.threadName,
                rec.name, rec.getMessage()))
        if reverse:
            out.reverse()
        return out


_handler: RingBufferHandler | None = None


def install() -> RingBufferHandler:
    global _handler
    if _handler is None:
        _handler = RingBufferHandler()
        logging.getLogger().addHandler(_handler)
    return _handler


def set_level(level: str) -> None:
    value = getattr(logging, level.upper(), None)
    if not isinstance(value, int):
        raise ValueError(f"Unrecognized log level: {level}")
    logging.getLogger().setLevel(value)
