"""Stats collection: push-model collector + latency digests.

Mirrors ``opentsdb_tpu/stats/collector.py`` of the JAX package, copied
rather than imported: the port imports nothing of that package. The lines
it emits are the JAX package's, byte for byte.

Parity: reference src/stats/StatsCollector.java — ``record(name, value,
extra_tag)`` emits OpenTSDB text-import lines ``prefix.name timestamp value
tag=v...`` with a host tag and an extra-tag stack (:122-200), feeding the
telnet ``stats`` command and the ``/stats`` endpoint.

The reference's fixed-bucket Histogram (src/stats/Histogram.java) is
replaced by a t-digest-backed latency digest per the north star: mergeable,
constant-size, accurate at the tails. A pure-host accumulation buffer keeps
the hot `add()` path a list-append; the digest compresses lazily on read.
"""

from __future__ import annotations

import socket
import time

import numpy as np


_FOLD_THRESHOLD = 8192


class LatencyDigest:
    """Latency percentile tracker: cheap add(), bounded memory.

    Values accumulate in a host buffer that folds into a fixed-size
    t-digest (same k1-scale batch compression as ops/sketches, but pure
    numpy — no device round-trips or jit on the server's hot paths) every
    _FOLD_THRESHOLD adds, so memory stays bounded even if nobody ever
    polls /stats. For small counts percentiles are computed exactly.
    """

    def __init__(self, compression: int = 128) -> None:
        import threading

        self._buf: list[float] = []
        self._compression = compression
        self._means: np.ndarray | None = None
        self._weights: np.ndarray | None = None
        self.count = 0
        # add() runs on event-loop AND thread-pool threads (e.g. the
        # query executor's scan digest); fold/read must not race.
        self._lock = threading.Lock()

    def add(self, value: float) -> None:
        with self._lock:
            self._buf.append(float(value))
            self.count += 1
            if len(self._buf) >= _FOLD_THRESHOLD:
                self._fold()

    def _fold(self) -> None:
        # Caller must hold self._lock.
        if not self._buf:
            return
        new = np.asarray(self._buf, np.float64)
        self._buf = []
        if self._means is None:
            means = new
            weights = np.ones(len(new))
        else:
            means = np.concatenate([self._means, new])
            weights = np.concatenate([self._weights, np.ones(len(new))])
        self._means, self._weights = self._compress(means, weights)

    def _compress(self, means, weights):
        """Numpy twin of ops.sketches._compress (k1 scale, full range)."""
        order = np.argsort(means)
        m, w = means[order], weights[order]
        total = max(w.sum(), 1e-30)
        q_mid = np.clip((np.cumsum(w) - w / 2) / total, 1e-9, 1 - 1e-9)
        delta = float(self._compression)
        k = delta / np.pi * np.arcsin(2 * q_mid - 1) + delta / 2
        cluster = np.clip(k.astype(np.int64), 0, self._compression - 1)
        wsum = np.bincount(cluster, weights=w,
                           minlength=self._compression)
        msum = np.bincount(cluster, weights=m * w,
                           minlength=self._compression)
        keep = wsum > 0
        return msum[keep] / wsum[keep], wsum[keep]

    def percentile(self, p: float) -> float:
        """p in [0, 100] (reference Histogram.percentile convention)."""
        with self._lock:
            if self._means is None:
                if not self._buf:
                    return 0.0
                return float(np.percentile(np.asarray(self._buf), p))
            self._fold()
            m, w = self._means, self._weights
            centers = (np.cumsum(w) - w / 2) / max(w.sum(), 1e-30)
            return float(np.interp(p / 100.0, centers, m))


class StatsCollector:
    """Collects stats as OpenTSDB text lines; subclass or pass ``emit``."""

    def __init__(self, prefix: str, emit=None, host_tag: bool = True):
        self.prefix = prefix
        self.lines: list[str] = []
        self._emit = emit
        self._extra_tags: list[str] = []
        if host_tag:
            self._extra_tags.append(f"host={socket.gethostname()}")

    def record(self, name: str, value, xtratag: str | None = None) -> None:
        if isinstance(value, LatencyDigest):
            base = xtratag + " " if xtratag else ""
            for p in (50, 75, 90, 95):
                self.record(name, int(value.percentile(p)),
                            f"{base}percentile={p}".strip())
            return
        buf = [self.prefix, ".", name, " ", str(int(time.time())), " ",
               str(int(value) if float(value).is_integer() else value)]
        if xtratag:
            for tag in xtratag.split():
                if "=" not in tag:
                    raise ValueError(f"invalid extra tag: {tag}")
                buf.append(" ")
                buf.append(tag)
        for tag in self._extra_tags:
            buf.append(" ")
            buf.append(tag)
        line = "".join(buf)
        self.lines.append(line)
        if self._emit is not None:
            self._emit(line)

    def add_extra_tag(self, tag: str) -> None:
        if "=" not in tag:
            raise ValueError(f"invalid tag: {tag}")
        self._extra_tags.append(tag)

    def clear_extra_tag(self, name: str) -> None:
        self._extra_tags = [
            t for t in self._extra_tags if not t.startswith(name + "=")]
