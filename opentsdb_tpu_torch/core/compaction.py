"""Background row-compaction queue.

Mirrors ``opentsdb_tpu/core/compaction.py`` of the JAX package, copied rather
than imported: the port imports nothing of that package.

Parity target: reference src/core/CompactionQueue.java — a set of "dirty" row
keys flushed by a daemon thread once their hour has passed, merging each
row's cells into one compacted cell and deleting the originals. Differences
by design:

- The merge itself is the vectorized ``codec_np`` path (sort/dedup on
  columnar arrays), not a per-cell pull loop.
- The queue is a plain dict row_key -> base_time; the flush scan is O(queue)
  per wake-up, which replaces the skip-list-ordered iteration (:936-950)
  without needing ordered traversal.

Error discipline matches the reference: PleaseThrottle re-enqueues the row
and backs off (:797-808), other errors are counted and dropped, and on memory
pressure the whole queue can be discarded — it is reconstructible soft state
(SURVEY.md §5.4).

The flusher thread also drives the periodic checkpoint
(``Config.checkpoint_interval``; 0 = off): it spills the memtable to the
sstable tier and truncates the WAL, or, over a read-only replica store,
catches the replica up (``TSDB.refresh_replica``).
"""

from __future__ import annotations

import logging
import threading
import time

from opentsdb_tpu_torch.core import codec
from opentsdb_tpu_torch.core.const import MAX_TIMESPAN
from opentsdb_tpu_torch.core.errors import (IllegalDataError,
                                             PleaseThrottleError)

LOG = logging.getLogger(__name__)


class CompactionQueue:
    """Queue of row keys awaiting compaction, with a background flusher."""

    def __init__(self, tsdb, start_thread: bool = True) -> None:
        self._tsdb = tsdb
        self._queue: dict[bytes, int] = {}
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        cfg = tsdb.config
        self.flush_interval = cfg.flush_interval
        self.min_flush_threshold = cfg.compaction_min_flush_threshold
        self.max_concurrent_flushes = cfg.compaction_max_concurrent_flushes
        self.flush_speed = cfg.compaction_flush_speed
        self.checkpoint_interval = cfg.checkpoint_interval
        self._last_checkpoint = time.time()
        # stats (reference :118-132)
        self.trivial_compactions = 0
        self.complex_compactions = 0
        self.written_cells = 0
        self.deleted_cells = 0
        self.errors = 0
        if start_thread and cfg.enable_compactions:
            self._thread = threading.Thread(
                target=self._loop, name="CompactionThread", daemon=True)
            self._thread.start()

    def __len__(self) -> int:
        return len(self._queue)

    def add(self, row_key: bytes) -> None:
        """Mark a row dirty (cheap, called on every write)."""
        base_ts = codec.parse_row_key(row_key).base_time
        with self._lock:
            self._queue[row_key] = base_ts

    def clear(self) -> None:
        """Drop every queued row (a demoted writer's queue: writer work,
        and soft state the new writer rebuilds as it reads)."""
        with self._lock:
            self._queue.clear()

    def flush(self, cutoff: int | None = None,
              max_flushes: int | None = None) -> int:
        """Compact every queued row with base_time <= cutoff; returns count.

        With no cutoff, flush everything (shutdown path, reference
        TSDB.java:384-417)."""
        if cutoff is None:
            cutoff = 2**62
        if max_flushes is None:
            max_flushes = 2**31
        with self._lock:
            eligible = [k for k, bt in self._queue.items() if bt <= cutoff]
            eligible.sort(key=lambda k: self._queue[k])  # oldest first
            eligible = eligible[:max_flushes]
            for k in eligible:
                del self._queue[k]
        done = 0
        for idx, key in enumerate(eligible):
            try:
                self._tsdb.compact_row(key)
                done += 1
            except PleaseThrottleError:
                with self._lock:  # re-enqueue and stop pushing the engine
                    for k in eligible[idx:]:
                        self._queue[k] = codec.parse_row_key(k).base_time
                break
            except IllegalDataError:
                self.errors += 1
                LOG.exception("Uncompactable row %s", key.hex())
            except Exception:
                self.errors += 1
                LOG.exception("WTF? Uncaught exception compacting %s",
                              key.hex())
        return done

    def _loop(self) -> None:
        while not self._stop.wait(self.flush_interval):
            try:
                now = time.time()
                if (self.checkpoint_interval
                        and now - self._last_checkpoint
                        >= self.checkpoint_interval):
                    if getattr(self._tsdb.store, "read_only", False):
                        # A legacy --read-only daemon: the timer polls
                        # the writer's durable state instead of spilling
                        # (TSDB.refresh_replica: store, sketches, rollup
                        # view, in that order). A --role replica daemon
                        # runs the same call from its WalTailer.
                        self._tsdb.refresh_replica()
                    else:
                        self._tsdb.checkpoint()
                    self._last_checkpoint = now
                size = len(self._queue)
                if size <= self.min_flush_threshold:
                    continue
                # Adaptive rate: flush at FLUSH_SPEED x the pace rows age
                # out, bounded by max_concurrent_flushes (reference
                # :881-928).
                max_flushes = min(
                    self.max_concurrent_flushes,
                    max(self.min_flush_threshold, 1,
                        int(size * self.flush_interval * self.flush_speed
                            / MAX_TIMESPAN)))
                cutoff = int(time.time()) - MAX_TIMESPAN - 1
                self.flush(cutoff, max_flushes)
            except MemoryError:
                # Discard the whole queue: it's reconstructible soft state.
                with self._lock:
                    self._queue.clear()
                LOG.error("OOM in compaction thread; queue discarded")
            except Exception:
                LOG.exception("Uncaught exception in compaction thread")

    def shutdown(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
        self.flush()
