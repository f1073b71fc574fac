"""Self-monitoring ingest: the TSDB stores its own telemetry.

Mirrors ``opentsdb_tpu/obs/selfmon.py`` of the JAX package. The
reference's pattern (src/stats/): the StatsCollector emits stats in
OpenTSDB's own text-import line format so the TSDB can monitor itself.
Every ``interval_s`` this loop snapshots the daemon's ``/stats`` lines
(server counters, engine stats, the metrics registry) and ingests them
into the store as ``tsd.*`` series, one ``add_batch`` of one point per
line, so ``/q``, the fragment cache and dashboards work on the engine's
own telemetry.

The ingest mirrors into the device window and the live sketches, so the
loop's thread makes the TSDB's card (its index resolved when the monitor
is built, in the daemon's thread) its current CUDA device before it
ingests.

Reentrancy: the ingest bumps the very counters the next snapshot reads
(``wal.appends``, ``datapoints.added``, ...): feedback, not recursion.
The ``_busy`` guard refuses a cycle started while a previous one is still
inside the ingest path, instead of nesting through its own
instrumentation.

Timestamps are strictly monotonic per cycle: two snapshots in the same
epoch second would write conflicting duplicate points (same series, same
timestamp, different value), the IllegalDataError shape fsck exists to
flag.
"""

from __future__ import annotations

import logging
import socket
import threading
import time

import numpy as np
import torch

from opentsdb_tpu_torch.core import tags as tags_mod

LOG = logging.getLogger(__name__)
_HOST = socket.gethostname()


class SelfMonitor:
    """Background stats-snapshot -> self-ingest loop.

    ``stats_fn`` returns the classic stats lines
    (``tsd.name timestamp value tag=v ...``); each line becomes one data
    point of the metric named by its first token (its UID created on
    demand: self-monitoring does not depend on auto_create_metrics).
    """

    def __init__(self, tsdb, stats_fn, interval_s: float) -> None:
        self.tsdb = tsdb
        self.stats_fn = stats_fn
        self.interval_s = float(interval_s)
        self.cycles = 0
        self.points = 0
        self.errors = 0
        self._busy = False
        self._last_ts = 0
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        # A new thread's current CUDA device is card 0: pin the loop to
        # the TSDB's card ("cuda" alone: the constructing thread's
        # current card).
        device = getattr(tsdb, "device", None)
        self._cuda_index = None
        if device is not None and device.type == "cuda":
            self._cuda_index = (device.index if device.index is not None
                                else torch.cuda.current_device())

    # -- one deterministic cycle (tests call this directly) -------------

    def run_once(self) -> int:
        """Snapshot and ingest one cycle; returns the points written.
        Refused (0) while a previous cycle is still ingesting."""
        if self._busy:
            return 0
        self._busy = True
        try:
            lines = self.stats_fn()
            # One shared timestamp per cycle, strictly after the previous
            # cycle's: duplicate (series, ts) points with different values
            # are corrupt data by this engine's rules.
            ts = max(int(time.time()), self._last_ts + 1)
            self._last_ts = ts
            stamp = np.asarray([ts], np.int64)
            n = 0
            for line in lines:
                parts = line.split()
                if len(parts) < 3:
                    continue
                name, value = parts[0], parts[2]
                tag_map: dict[str, str] = {}
                try:
                    for t in parts[3:]:
                        tags_mod.parse(tag_map, t)
                    fval = float(value)
                except ValueError:
                    continue
                if not tag_map:
                    # The engine requires a tag per point; the reference
                    # tags every stats line with host=.
                    tag_map = {"host": _HOST}
                is_int = fval.is_integer() and abs(fval) < 2**53
                try:
                    self.tsdb.metrics.get_or_create_id(name)
                    self.tsdb.add_batch(
                        name, stamp, np.asarray([fval], np.float64),
                        tag_map, is_float=np.asarray([not is_int]),
                        int_values=np.asarray(
                            [int(fval) if is_int else 0], np.int64))
                    n += 1
                except Exception:
                    self.errors += 1
                    LOG.exception("self-monitor ingest failed for %s",
                                  name)
            self.cycles += 1
            self.points += n
            return n
        finally:
            self._busy = False

    # -- lifecycle -------------------------------------------------------

    def start(self) -> None:
        if self.interval_s <= 0 or self._thread is not None:
            return
        self._thread = threading.Thread(
            target=self._loop, name="selfmon", daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        t, self._thread = self._thread, None
        if t is not None and t.is_alive():
            t.join(timeout=5.0)

    def _loop(self) -> None:
        if self._cuda_index is not None:
            torch.cuda.set_device(self._cuda_index)
        while not self._stop.wait(self.interval_s):
            try:
                self.run_once()
            except Exception:
                self.errors += 1
                LOG.exception("self-monitor cycle failed")
