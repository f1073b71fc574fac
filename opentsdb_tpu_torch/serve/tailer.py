"""WAL tailer: continuous replica catch-up with a measured lag bound.

Mirrors ``opentsdb_tpu/serve/tailer.py`` of the JAX package, copied rather
than imported. A dedicated thread calls ``TSDB.refresh_replica()`` every
``Config.tail_interval_s`` (default 250 ms; the suffix replay is O(new
bytes)) and timestamps every successful catch-up.

The lag definition is the contract's load-bearing part: ``refresh()``
replays the WAL to its durable end as of the call's START, so after a
successful refresh that began at T the replica reflects every record the
writer appended before T, the no-op case included. ``lag_ms`` is
therefore ``now - T_last_success``, not "time since data last changed":
a dead writer leaves the replica legitimately fresh, while a failing
refresh (writer churn mid-rebuild, a flaky volume, an injected fault)
lets the lag grow until the staleness contract trips.

Contract: with ``Config.max_staleness_ms > 0``, a replica whose lag
exceeds the bound reports unhealthy at ``/healthz`` and every ``/q``
answer carries a ``"degraded": "stale"`` tag until it catches up.

Instruments (``obs/registry.py``, the JAX names): the
``replica.refreshes`` and ``replica.refresh_errors`` counters, the
``replica.refresh`` timer and the ``replica.lag_ms`` gauge (rebound to
the newest tailer).
"""

from __future__ import annotations

import logging
import threading
import time

from opentsdb_tpu_torch.obs.registry import METRICS as _metrics

LOG = logging.getLogger(__name__)

_M_REFRESHES = _metrics.counter("replica.refreshes")
_M_ERRORS = _metrics.counter("replica.refresh_errors")
_M_REFRESH = _metrics.timer("replica.refresh")


class WalTailer:
    """Continuously tails the writer's WAL into a read-only TSDB.

    ``start()`` spawns the thread, ``stop()`` sets the event and joins;
    ``run_once()`` is the deterministic single cycle the tests drive
    without a thread.
    """

    def __init__(self, tsdb, interval_s: float | None = None,
                 max_staleness_ms: float | None = None) -> None:
        if not getattr(tsdb.store, "read_only", False):
            raise ValueError("WalTailer tails a READ-ONLY replica "
                             "store; writers don't lag themselves")
        self.tsdb = tsdb
        cfg = tsdb.config
        self.interval_s = (cfg.tail_interval_s if interval_s is None
                           else float(interval_s))
        self.max_staleness_ms = (
            cfg.max_staleness_ms if max_staleness_ms is None
            else float(max_staleness_ms))
        self.refreshes = 0
        self.errors = 0
        self.last_error: str | None = None
        # The store replayed the WAL's end while opening, so the contract
        # clock starts now.
        self._caught_up = time.monotonic()
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        # The gauge holds a callable read at export: rebind it, so a
        # process that opens a second replica exports the live one's lag.
        _metrics.gauge("replica.lag_ms", self.lag_ms).fn = self.lag_ms

    # -- the contract surface -------------------------------------------------

    def lag_ms(self) -> float:
        """Milliseconds since the last successful WAL catch-up."""
        return (time.monotonic() - self._caught_up) * 1000.0

    def stale(self) -> bool:
        """True when the staleness contract is violated (lag beyond
        ``max_staleness_ms``; always False with the contract off)."""
        return (self.max_staleness_ms > 0
                and self.lag_ms() > self.max_staleness_ms)

    def health(self) -> dict:
        """The ``/healthz`` body of a replica daemon."""
        lag = self.lag_ms()
        stale = self.max_staleness_ms > 0 and lag > self.max_staleness_ms
        return {
            "role": "replica",
            "ok": not stale,
            "stale": stale,
            "lag_ms": round(lag, 1),
            "max_staleness_ms": self.max_staleness_ms,
            "tail_interval_s": self.interval_s,
            "refreshes": self.refreshes,
            "refresh_errors": self.errors,
        }

    # -- the tail loop ----------------------------------------------------------

    def run_once(self) -> bool:
        """One tail cycle; True when the catch-up succeeded. A failure
        keeps the replica serving its coherent pre-refresh view; the lag
        clock simply does not advance."""
        t0 = time.monotonic()
        try:
            with _M_REFRESH.time():
                self.tsdb.refresh_replica()
        except Exception as e:
            self.errors += 1
            _M_ERRORS.inc()
            self.last_error = repr(e)
            LOG.warning("replica tail refresh failed: %r", e)
            return False
        # The refresh covers everything durable as of t0, not "now":
        # records appended during the replay belong to the next cycle.
        self._caught_up = t0
        self.refreshes += 1
        _M_REFRESHES.inc()
        return True

    def _loop(self) -> None:
        while not self._stop.wait(self.interval_s):
            self.run_once()

    def start(self) -> None:
        if self._thread is not None:
            return
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="wal-tailer")
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        t = self._thread
        if t is not None:
            t.join(timeout=10.0)
            self._thread = None

    def collect_stats(self, collector) -> None:
        collector.record("replica.lag_ms", self.lag_ms())
        collector.record("replica.refreshes", self.refreshes)
        collector.record("replica.refresh_errors", self.errors)
        collector.record("replica.stale", int(self.stale()))
