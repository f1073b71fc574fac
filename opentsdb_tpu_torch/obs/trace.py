"""Per-query trace spans: a lightweight span tree threaded through the
executor, planner, and storage fan-out.

Mirrors ``opentsdb_tpu/obs/trace.py`` of the JAX package, copied rather
than imported. Span names and tags are the JAX package's, so a span tree
of either daemon reads the same. Spans are wall-clock: a CUDA launch is
asynchronous, so a span holds a kernel's device time only when the host
copy that waits for it falls inside the span.

Activation model (the faultpoints cost discipline): a module-level
active-trace counter gates every hook — with no trace active anywhere
in the process, ``span()`` / ``current_span()`` are one global integer
check and return a shared no-op. A trace is activated around one
query's execution (``activate``); the contextvar keeps concurrent
queries' spans separate even though they share one executor and one
thread pool.

Span durations are wall-clock (``perf_counter``) milliseconds. The
tree serializes as::

    {"name": ..., "ms": 12.3, "tags": {...}, "spans": [children]}

Storage fan-out gets ``timed_iter``: the sharded store's per-shard
scan iterators are interleaved by the heap merge, so each shard's span
accumulates only the time spent pulling from THAT shard and attaches
to the parent when the iterator is exhausted (the pull times are
disjoint, so shard spans always sum to <= their parent).

Armed ``delay``-mode faultpoints record a ``fault.delay`` child span
(site tag) under whatever span is current when they fire — how a
deterministic test proves exactly one stage stretched.
"""

from __future__ import annotations

import contextvars
import threading
import time
from contextlib import contextmanager

_ACTIVE = 0                     # process-wide count of active traces
_ACTIVE_LOCK = threading.Lock()


def new_trace_id() -> str:
    """16 hex chars of urandom — collision-safe across processes
    (os.urandom, not random: child processes fork with copied PRNG
    state and routers/replicas must never mint the same id)."""
    import os
    return os.urandom(8).hex()
_CURRENT: contextvars.ContextVar = contextvars.ContextVar(
    "opentsdb_tpu_torch_trace_span", default=None)


class Span:
    __slots__ = ("name", "tags", "t0", "ms", "children")

    def __init__(self, name: str, tags: dict | None = None) -> None:
        self.name = name
        self.tags = tags if tags is not None else {}
        self.t0 = time.perf_counter()
        self.ms = 0.0
        self.children: list[Span] = []

    def to_dict(self) -> dict:
        d = {"name": self.name, "ms": round(self.ms, 3)}
        if self.tags:
            d["tags"] = self.tags
        if self.children:
            d["spans"] = [c.to_dict() for c in self.children]
        return d


class Trace:
    """One query's span tree; ``root.ms`` is set by ``activate``.

    ``trace_id`` is the cross-process correlation handle: the router
    mints one per front-door request and passes it to every replica
    hop (``?trace_parent=``), so the hop's ring record on the replica
    and the assembled tree on the router carry the SAME id — one grep
    finds a request's whole fan-out. Locally-originated traces mint
    their own."""

    def __init__(self, label: str, tags: dict | None = None,
                 trace_id: str | None = None) -> None:
        self.root = Span("query", dict(tags or ()))
        self.root.tags["q"] = label
        self.trace_id = trace_id or new_trace_id()

    @property
    def total_ms(self) -> float:
        return self.root.ms

    def to_dict(self) -> dict:
        return self.root.to_dict()


class _NoopSpan:
    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_NOOP = _NoopSpan()


class _SpanCtx:
    __slots__ = ("span", "_token")

    def __init__(self, name: str, tags: dict | None) -> None:
        self.span = Span(name, tags)

    def __enter__(self) -> Span:
        self._token = _CURRENT.set(self.span)
        self.span.t0 = time.perf_counter()
        return self.span

    def __exit__(self, *exc) -> None:
        sp = self.span
        sp.ms = (time.perf_counter() - sp.t0) * 1000.0
        _CURRENT.reset(self._token)
        parent = _CURRENT.get()
        if parent is not None:
            parent.children.append(sp)


def span(name: str, **tags):
    """Context manager for one timed child span of the current span.
    No-op (yields None) when no trace is active on this thread."""
    if not _ACTIVE or _CURRENT.get() is None:
        return _NOOP
    return _SpanCtx(name, tags or None)


def current_span() -> Span | None:
    """The innermost active span on this thread, None when untraced."""
    if not _ACTIVE:
        return None
    return _CURRENT.get()


@contextmanager
def activate(trace: Trace):
    """Run a block with ``trace`` active: its root becomes the current
    span on this thread and its total wall time is recorded."""
    global _ACTIVE
    with _ACTIVE_LOCK:
        _ACTIVE += 1
    token = _CURRENT.set(trace.root)
    trace.root.t0 = time.perf_counter()
    try:
        yield trace
    finally:
        trace.root.ms = (time.perf_counter() - trace.root.t0) * 1000.0
        _CURRENT.reset(token)
        with _ACTIVE_LOCK:
            _ACTIVE -= 1


def timed_iter(it, parent: Span, name: str, tags: dict | None = None):
    """Wrap an iterator so the time spent pulling from it accumulates
    into one child span of ``parent``, attached when the iterator is
    exhausted (or closed). Used for the sharded store's fan-out, where
    the heap merge interleaves shard iterators."""
    total = 0.0
    rows = 0
    try:
        while True:
            t0 = time.perf_counter()
            try:
                item = next(it)
            except StopIteration:
                total += time.perf_counter() - t0
                break
            total += time.perf_counter() - t0
            rows += 1
            yield item
    finally:
        sp = Span(name, dict(tags or ()))
        sp.tags["rows"] = rows
        sp.ms = total * 1000.0
        parent.children.append(sp)
