"""Device-resident columnar hot window: queries without the storage scan.

Mirrors ``opentsdb_tpu/storage/devstore.py`` of the JAX package. The
recent ingest window's flat columns (rel-timestamp, value, series-id)
stay resident in device memory, appended as data arrives, so a
downsampled dashboard query touches the host only for the series
directory and the [S]-sized include/group maps; the points never cross
the host link at query time.

Design (the JAX package's, unchanged):

- **Per-metric windows.** Each metric holds a host-side series directory
  (series_key -> dense sid, the group-by/tag-filter substrate) and a list
  of immutable device chunks. ``chunk_columns`` hands the chunk list to
  the chunked query stage (ops/kernels ``window_series_stage_chunks``).
- **Host staging.** ``append`` is O(1) host work (copies into a list);
  chunks upload in ``staging_points``-sized batches on a bounded
  background uploader that keeps each metric's batches in ``seq`` order.
- **Exactness, not cache-maybe.** The window only serves a query when its
  answer equals the storage scan path's:
  - per-series timestamps must be strictly monotone across appends; an
    out-of-order or rewritten timestamp marks the metric dirty (sticky)
    and queries fall back to the scan path (``dirty_fallbacks``);
  - evicting old chunks (one budget across all metrics) advances
    ``complete_from``; queries reaching before it fall back;
  - a failed upload, or rel timestamps past int32, mark the metric dirty;
  - storage mutations the append stream did not see call ``invalidate``.
- **Stalls.** A wedged device must not hang ingest or queries: the
  wedged-vs-slow policy of ``_wait_quiet`` / ``_metric_stuck`` turns a
  metric that made no upload progress for a stall window into a sticky
  scan-path fallback, while a slow-but-progressing uploader only costs a
  plain miss.

In PyTorch:

- Chunks are torch tensors on the window's ``device`` (the TSDB's): rel_ts
  int32, values float32, sid int32. They are stored UNPADDED (the JAX
  package pads to powers of two so XLA does not recompile; eager PyTorch
  has nothing to recompile, and at 1000-point batches the padding would
  be half of every chunk), so every point is valid and the JAX chunks'
  ``valid`` column has no counterpart.
- Uploads are synchronous ``torch.from_numpy(...).to(device)`` on the
  uploader thread (or the query's drain helper): a blocking copy returns
  only once the data is on the device, and the chunk is published under
  the lock after that, so no query stream can read a chunk in flight.

The reshard hooks of the mesh-sharded window (``storage/devshard.py``):
``quiesce`` (every staged batch uploaded and every in-flight upload
drained), ``_snapshot_metrics`` (a refs-only view of the chunk lists)
and ``set_complete_from`` (a coverage floor carried over). A window
pinned to one device of a mesh passes ``device=``.

Left out: ``columns()`` / ``DevColumns``, the concatenated view: the
executor serves only from the chunk list.
"""

from __future__ import annotations

import queue
import threading
import time as _time
from typing import NamedTuple

import numpy as np
import torch

from opentsdb_tpu_torch.utils.config import resolve_device


class DevChunks(NamedTuple):
    """One metric's resident window as its raw device chunk list, with no
    concatenated copy: the chunked query stage folds the chunks into
    [S, B] grids one at a time, so the window can approach the whole
    device memory instead of half of it."""
    chunks: list            # [(rel_ts [n] int32 seconds since epoch,
    #                           values [n] float32, sid [n] int32)]
    epoch: int              # int64 base the rel timestamps offset from
    series_keys: list       # sid -> series_key bytes
    generation: int         # bumps when the directory grows
    version: int            # bumps on ANY data change (new/evicted
    #                         chunks) — derived-result cache key


class _MetricWindow:
    __slots__ = ("sids", "keys", "last_ts", "epoch", "chunks",
                 "staged_ts", "staged_vals", "staged_sid", "staged_n",
                 "dirty", "complete_from", "generation",
                 "version", "device_points", "inflight",
                 "inflight_since")

    def __init__(self) -> None:
        self.sids: dict[bytes, int] = {}
        self.keys: list[bytes] = []
        self.last_ts: list[int] = []
        self.epoch: int | None = None
        self.chunks: list[dict] = []      # ts/vals/sid + n/seq/...
        self.staged_ts: list[np.ndarray] = []
        self.staged_vals: list[np.ndarray] = []
        self.staged_sid: list[np.ndarray] = []
        self.staged_n = 0
        self.dirty = False
        self.complete_from: int | None = None  # None = since forever
        self.generation = 0
        self.version = 0
        self.device_points = 0
        self.inflight = 0               # taken-but-not-uploaded batches
        # Monotonic time of THIS metric's last upload progress while it
        # has in-flight batches (None = quiescent): the per-metric wedge
        # detector, immune to other metrics' completions keeping the
        # global liveness signal fresh.
        self.inflight_since: float | None = None


class DeviceWindow:
    """Thread-safe store of per-metric device-resident columns."""

    _instances = 0

    def __init__(self, staging_points: int = 1 << 20,
                 max_points: int = 1 << 26,
                 background: bool = True,
                 stall_timeout: float = 60.0,
                 device: torch.device | str = "cuda") -> None:
        # Process-unique instance token: version counters restart at 0 in
        # a replacement window, so derived-result caches key on
        # (instance_id, version).
        DeviceWindow._instances += 1
        self.instance_id = DeviceWindow._instances
        self.staging_points = staging_points
        self.max_points = max_points
        self.background = background
        self.device = resolve_device(device)
        # Degraded-mode guard: a wedged device freezes the uploader
        # mid-copy. After stall_timeout, ingest and queries dirty-mark
        # the affected metric and proceed on the scan path.
        self.stall_timeout = stall_timeout
        self._lock = threading.RLock()
        self._metrics: dict[bytes, _MetricWindow] = {}
        # Background uploader: bounded queue = backpressure; one worker =
        # chunk order (and so per-series time order) is preserved.
        self._pending: queue.Queue = queue.Queue(maxsize=2)
        self._uploader: threading.Thread | None = None
        # Per-metric upload completion: queries wait only for THEIR
        # metric's in-flight batches, not the whole queue.
        self._cond = threading.Condition(self._lock)
        # Global residency accounting: max_points caps the SUM across
        # metrics (the device memory budget is per card); chunks carry an
        # upload sequence number so eviction picks the oldest chunk
        # fleet-wide.
        self._total_points = 0
        self._seq = 0
        # Liveness signal: bumps on EVERY upload completion (success or
        # failure). A backlogged-but-progressing uploader must produce
        # backpressure or a cache miss, never the sticky dirty mark
        # reserved for a wedged device.
        self._uploads_completed = 0
        # stats
        self.appended_points = 0
        self.evicted_points = 0
        self.dirty_fallbacks = 0
        self.upload_stalls = 0
        self.window_hits = 0
        self.window_misses = 0

    # -- ingest side ---------------------------------------------------

    def append(self, metric_uid: bytes, series_key: bytes,
               timestamps: np.ndarray, values: np.ndarray) -> None:
        """Record one series batch (timestamps int64 sorted ascending,
        values float64/float32). O(1) host work plus a device upload
        every ``staging_points`` points."""
        n = len(timestamps)
        if n == 0:
            return
        with self._lock:
            mw = self._metrics.get(metric_uid)
            if mw is None:
                mw = self._metrics[metric_uid] = _MetricWindow()
            if mw.dirty:
                return
            sid = mw.sids.get(series_key)
            if sid is None:
                sid = len(mw.keys)
                mw.sids[series_key] = sid
                mw.keys.append(series_key)
                mw.last_ts.append(-1)
                mw.generation += 1
            if int(timestamps[0]) <= mw.last_ts[sid]:
                # Out-of-order or rewritten timestamp: correctness now
                # needs storage's dedup/overwrite semantics. Mark the
                # metric dirty and free its device state.
                self._mark_dirty(mw)
                return
            mw.last_ts[sid] = int(timestamps[-1])
            if mw.epoch is None:
                mw.epoch = int(timestamps[0])
            # Stage COPIES: the window owns its buffers. A caller reusing
            # its batch buffer must not rewrite staged points under the
            # window.
            mw.staged_ts.append(np.array(timestamps, np.int64))
            mw.staged_vals.append(np.array(values, np.float32))
            mw.staged_sid.append(np.full(n, sid, np.int32))
            mw.staged_n += n
            self.appended_points += n
            work = (self._take_staged(mw)
                    if mw.staged_n >= self.staging_points else None)
        # The bounded put happens OUTSIDE _lock: the uploader takes the
        # lock to append finished chunks, so blocking on a full queue
        # while holding it would deadlock.
        if work is not None:
            self._submit(work)

    def _take_staged(self, mw: _MetricWindow):
        """Swap the staged batch out (caller holds _lock); the returned
        work item is submitted outside the lock. The upload sequence
        number is assigned HERE, under the lock, so racing producers
        can't enqueue a metric's batches out of time order."""
        if mw.staged_n == 0:
            return None
        batch = (mw.staged_ts, mw.staged_vals, mw.staged_sid,
                 mw.staged_n)
        mw.staged_ts, mw.staged_vals, mw.staged_sid = [], [], []
        mw.staged_n = 0
        if mw.inflight == 0:
            mw.inflight_since = _time.monotonic()
        mw.inflight += 1
        seq = self._seq
        self._seq += 1
        return (mw, batch, seq)

    def _run_upload(self, work) -> None:
        """Execute one upload on the calling thread with full failure
        handling (dirty-mark under the lock: the metric falls back to the
        scan path, which still runs on the same device) and completion
        signalling. Must be called without _lock."""
        try:
            self._upload(*work)
        except Exception:
            with self._lock:
                self._mark_dirty(work[0])
        finally:
            self._upload_done(work[0])

    def _submit(self, work) -> None:
        """Queue one (mw, batch, seq) for the uploader thread, or upload
        inline when background=False. Must be called without _lock."""
        if not self.background:
            self._run_upload(work)
            return
        if self._uploader is None:
            with self._lock:
                if self._uploader is None:
                    self._uploader = threading.Thread(
                        target=self._upload_loop, daemon=True,
                        name="devwindow-uploader")
                    self._uploader.start()
        while True:
            with self._cond:
                base = self._uploads_completed
            try:
                self._pending.put(work, timeout=self.stall_timeout)
                return
            except queue.Full:
                with self._cond:
                    if (self._uploads_completed != base
                            and not self._metric_stuck(
                                work[0], _time.monotonic())):
                        # An upload finished during the wait: the
                        # uploader is alive, just backlogged. Keep
                        # blocking (the bounded queue IS the
                        # backpressure).
                        continue
                    # No upload completed for a full stall window on a
                    # full queue: the device is wedged. Drop THIS metric
                    # to degraded mode, and release the dropped item's
                    # in-flight count (it never reaches _run_upload), or
                    # queries would wait on it forever.
                    mw = work[0]
                    self.upload_stalls += 1
                    self._mark_dirty(mw)
                    mw.inflight -= 1
                    self._cond.notify_all()
                    return

    def _upload_loop(self) -> None:
        while True:
            work = self._pending.get()
            try:
                self._run_upload(work)
            finally:
                self._pending.task_done()

    def _upload_done(self, mw: _MetricWindow) -> None:
        with self._cond:
            mw.inflight -= 1
            if mw.inflight == 0:
                mw.inflight_since = None
            else:
                # This metric itself made progress: restart its
                # per-metric wedge clock.
                mw.inflight_since = _time.monotonic()
            self._uploads_completed += 1
            self._cond.notify_all()

    def _upload(self, mw: _MetricWindow, batch, seq: int) -> None:
        """Upload one staged batch as an immutable (unpadded) chunk."""
        staged_ts, staged_vals, staged_sid, _ = batch
        ts = np.concatenate(staged_ts)
        rel64 = ts - mw.epoch
        if (rel64 > 2**31 - 1).any() or (rel64 < -(2**31)).any():
            # >68 years from the metric's epoch: the int32 rel column
            # would wrap silently. Fall back rather than mis-bucket.
            with self._lock:
                self._mark_dirty(mw)
            return
        n = len(ts)
        dev = self.device
        # Blocking copies: each returns once its data is on the device,
        # before the chunk is published below.
        chunk = {
            "ts": torch.from_numpy(rel64.astype(np.int32)).to(dev),
            "vals": torch.from_numpy(np.concatenate(staged_vals)).to(dev),
            "sid": torch.from_numpy(np.concatenate(staged_sid)).to(dev),
            "n": n, "seq": seq,
            "min_ts": int(ts.min()), "max_ts": int(ts.max()),
        }
        with self._lock:
            if mw.dirty:  # marked dirty while we were copying
                return
            # Insert in seq order (assigned at _take_staged time): racing
            # producers and a query-side drain can land out of order, and
            # eviction relies on chunks[0] being the metric's oldest.
            pos = len(mw.chunks)
            while pos > 0 and mw.chunks[pos - 1]["seq"] > seq:
                pos -= 1
            mw.chunks.insert(pos, chunk)
            mw.device_points += n
            self._total_points += n
            mw.version += 1
            # Evict the globally-oldest chunks past the (per-card, NOT
            # per-metric) budget. complete_from of the owning metric
            # advances past everything the evicted chunk could cover.
            while self._total_points > self.max_points:
                victim = min(
                    (m for m in self._metrics.values() if m.chunks),
                    key=lambda m: m.chunks[0]["seq"], default=None)
                if victim is None or (victim is mw
                                      and len(mw.chunks) == 1):
                    break  # never evict the chunk just added
                old = victim.chunks.pop(0)
                victim.device_points -= old["n"]
                self._total_points -= old["n"]
                self.evicted_points += old["n"]
                victim.version += 1
                nxt = old["max_ts"] + 1
                if (victim.complete_from is None
                        or nxt > victim.complete_from):
                    victim.complete_from = nxt

    def flush(self) -> None:
        """Upload every metric's staged points and wait for the uploader
        to drain (bounded by stall_timeout: a wedged uploader never
        finishes its task)."""
        with self._lock:
            work = [w for w in map(self._take_staged,
                                   self._metrics.values()) if w]
        for w in work:
            self._submit(w)
        deadline = _time.monotonic() + self.stall_timeout
        while (self._pending.unfinished_tasks
               and _time.monotonic() < deadline):
            _time.sleep(0.01)

    def quiesce(self) -> None:
        """Materialize everything into device chunks: upload every staged
        batch and wait for every metric's in-flight uploads. The reshard
        gate's drain (devshard.py): after it returns, a refs-only chunk
        snapshot is the complete window. A metric whose uploads stall
        past the wedge deadline degrades to dirty (the standard sticky
        fallback) rather than blocking forever."""
        self.flush()
        deadline = _time.monotonic() + 2 * self.stall_timeout
        with self._cond:
            while any(mw.inflight > 0 and not mw.dirty
                      for mw in self._metrics.values()):
                now = _time.monotonic()
                if now >= deadline:
                    for mw in self._metrics.values():
                        if mw.inflight > 0 and not mw.dirty:
                            self.upload_stalls += 1
                            self._mark_dirty(mw)
                    self._cond.notify_all()
                    break
                self._cond.wait(timeout=min(deadline - now, 0.05))

    def _snapshot_metrics(self) -> dict:
        """Refs-only snapshot for the reshard rebuild (devshard.py): per
        metric, the directory, epoch, chunk list and coverage state at
        this instant. Chunks are immutable once inserted, so holding refs
        is safe; every field is read-only to the caller. Call after
        ``quiesce``: staged and in-flight batches are not in it."""
        with self._lock:
            return {uid: {"keys": list(mw.keys),
                          "epoch": mw.epoch,
                          "chunks": list(mw.chunks),
                          "dirty": mw.dirty,
                          "complete_from": mw.complete_from}
                    for uid, mw in self._metrics.items()}

    def set_complete_from(self, metric_uid: bytes, floor: int) -> None:
        """Raise (never lower) a metric's coverage floor: the reshard
        rebuild carries the source shards' eviction horizon into the
        redistributed window, so it never claims coverage the old set
        had already evicted."""
        with self._lock:
            mw = self._metrics.get(metric_uid)
            if mw is None:
                return
            if mw.complete_from is None or floor > mw.complete_from:
                mw.complete_from = floor

    def invalidate(self, metric_uid: bytes | None = None) -> None:
        """Mark window state unusable after storage mutations the append
        stream didn't see (deletes, rewrites). The mark is sticky —
        popping the window instead would let the next append recreate one
        that claims coverage since forever while storage holds data it
        never saw."""
        with self._lock:
            targets = (list(self._metrics.values()) if metric_uid is None
                       else filter(None, [self._metrics.get(metric_uid)]))
            for mw in targets:
                self._mark_dirty(mw)

    def _mark_dirty(self, mw: _MetricWindow) -> None:
        """Sticky fallback mark + free the metric's device/staging state.
        Caller holds _lock."""
        mw.dirty = True
        mw.chunks.clear()
        mw.version += 1
        mw.staged_ts.clear()
        mw.staged_vals.clear()
        mw.staged_sid.clear()
        mw.staged_n = 0
        self._total_points -= mw.device_points
        mw.device_points = 0

    # -- query side ----------------------------------------------------

    def _wait_quiet(self, mw: _MetricWindow) -> str:
        """Wait for this metric's in-flight uploads with the
        wedged-vs-slow distinction: the sticky dirty mark is reserved for
        a device that has completed NOTHING for a full stall window; a
        backlogged-but-progressing uploader yields a bounded plain miss
        (scan fallback now, window intact for the next query). Returns
        ``"ready"`` (quiescent — caller still re-checks dirty under the
        lock), or ``"slow"``.

        Progress = ``_uploads_completed`` advancing, ANY metric. It is
        not proof THIS metric's upload moves, so a per-metric hard
        deadline — ``inflight_since`` older than 4x stall_timeout —
        converts a persistently-stuck metric to sticky dirty no matter
        how fresh the global signal is. ``dirty`` short-circuits."""
        with self._cond:
            last = self._uploads_completed
            now = _time.monotonic()
            deadline = now + self.stall_timeout       # wedge detector
            cap = now + 2 * self.stall_timeout        # latency bound
            while mw.inflight > 0 and not mw.dirty:
                now = _time.monotonic()
                if self._uploads_completed != last:
                    last = self._uploads_completed
                    deadline = now + self.stall_timeout
                if now >= deadline or self._metric_stuck(mw, now):
                    # Wedged: degrade this metric so the query (and every
                    # later one) takes the scan path. Wake the other
                    # waiters — their loop re-checks dirty.
                    self.upload_stalls += 1
                    self._mark_dirty(mw)
                    self._cond.notify_all()
                    break
                if now >= cap:
                    return "slow"
                self._cond.wait(timeout=min(deadline, cap) - now)
        return "ready"

    def _metric_stuck(self, mw: _MetricWindow, now: float) -> bool:
        """True when THIS metric's oldest in-flight batch has made no
        progress for 4x stall_timeout. Caller holds _cond/_lock."""
        return (mw.inflight_since is not None
                and now - mw.inflight_since >= 4 * self.stall_timeout)

    def chunk_columns(self, metric_uid: bytes, start: int,
                      end: int) -> DevChunks | None:
        """The metric's resident chunk list when it exactly covers
        [start, end]; None means the caller must use the scan path.

        Drains this metric's staged batch, waits for ITS in-flight
        uploads, then validates the exact-coverage contract."""
        with self._lock:
            mw = self._metrics.get(metric_uid)
            if mw is None:
                self.window_misses += 1
                return None
            work = self._take_staged(mw)
        # The query's staged batch uploads on a daemon helper thread, not
        # through the queue (that would couple this query's latency to
        # other metrics' stuck uploads) and not on the query thread (a
        # copy wedged in the device cannot be interrupted). The batch
        # counts in mw.inflight, so _wait_quiet applies the same
        # wedged-vs-slow policy to it.
        if work is not None:
            threading.Thread(target=self._run_upload, args=(work,),
                             daemon=True,
                             name="devwindow-query-drain").start()
        if self._wait_quiet(mw) == "slow":
            with self._lock:
                self.window_misses += 1
            return None
        with self._lock:
            if mw.dirty:
                self.dirty_fallbacks += 1
                return None
            if (mw.complete_from is not None
                    and start < mw.complete_from) or not mw.chunks:
                self.window_misses += 1
                return None
            self.window_hits += 1
            return DevChunks(
                chunks=[(c["ts"], c["vals"], c["sid"])
                        for c in mw.chunks],
                epoch=mw.epoch, series_keys=list(mw.keys),
                generation=mw.generation, version=mw.version)

    # -- observability -------------------------------------------------

    def collect_stats(self, collector) -> None:
        """Record the window's counters on ``collector`` (any object with
        ``record(name, value)``): the daemon's /stats lines."""
        collector.record("devwindow.points.appended", self.appended_points)
        collector.record("devwindow.points.evicted", self.evicted_points)
        collector.record("devwindow.hits", self.window_hits)
        collector.record("devwindow.misses", self.window_misses)
        collector.record("devwindow.dirty_fallbacks", self.dirty_fallbacks)
        collector.record("devwindow.upload_stalls", self.upload_stalls)
        with self._lock:
            collector.record("devwindow.metrics", len(self._metrics))
            collector.record(
                "devwindow.points.resident",
                sum(mw.device_points for mw in self._metrics.values()))
