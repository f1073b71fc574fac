"""Mesh-sharded device-resident hot set: the serving mesh's window.

Mirrors ``opentsdb_tpu/storage/devshard.py``. ``DeviceWindow``
(devstore.py) keeps one process's recent ingest resident on ONE device.
This module shards the same hot set on the series axis: K logical
shards, each a ``DeviceWindow`` pinned to one mesh device
(``device=``), series routed by the fleet-wide identity hash
(``storage.sstable.series_hash``, the hash of the storage sharder, the
blooms and the serve router). Each shard's stage folds only its own
series' chunks on its own device, and only the [S_shard, B] grids travel
to the first shard's device for the group combine.

Logical vs physical: ``n_shards`` may exceed the device count (shards
round-robin over the devices), so the CPU tests run the whole sharded
path (routing, per-shard eviction, reshard, crash recovery) on the one
CPU device, and the card runs four logical shards on one H100. Each
shard gets ``max_points // n_shards`` of the budget, so the shards
together stay inside the single window's.

Exactness: unchanged from devstore. A series lives in exactly one shard,
each shard keeps the per-series exact-coverage contract (monotone
appends, complete_from, sticky dirty marks), so the union serves a query
iff every shard owning any of the metric's series can; otherwise the
whole window declines to the scan path. Per-shard eviction is
independent: a shard evicting its oldest chunk never touches another's.

RESHARD (the shard count or device list changes) is live and follows the
coherent-swap discipline: build the new shard set complete off to the
side, swap it whole under the lock.

1. gate: journaling on, every old shard quiesced (staged batches
   uploaded, in-flight uploads drained); appends block only for this
   drain, and from here on ingest writes both to the old set (which
   keeps serving exact answers) and to the journal;
2. rebuild: device columns copied back per shard, split per series,
   redistributed by ``series_hash % n_new`` into freshly pinned windows
   (coverage floors carried: a series' new ``complete_from`` is the max
   over its metric's old shards);
3. drain: the journal replayed in passes until nearly empty, then a
   final pass under the lock, the ``mesh.reshard.commit`` fault point,
   and the swap (a generation bump invalidates every derived cache).

A query that captured the old shard list mid-reshard finishes on the old
set: pre-swap answers are complete, never a mix of old and new columns.
A crash at the commit point loses only device state (the hot set is a
cache); reopen + warm-up rebuilds a coherent set from storage, which the
crash matrix's ``meshreshard`` scenario proves.

In PyTorch, chunks hold no padding (devstore.py), so every point of a
snapshot chunk is real: the JAX chunks' ``valid`` column has no
counterpart in ``_split_series``.
"""

from __future__ import annotations

import threading
import time as _time
from typing import NamedTuple

import numpy as np

from opentsdb_tpu_torch.fault import faultpoints
from opentsdb_tpu_torch.storage.devstore import DeviceWindow
from opentsdb_tpu_torch.storage.sstable import series_hash


class ShardedDevChunks(NamedTuple):
    """One metric's resident window across every shard, ready for the
    per-shard stage kernels. Row order of the combined result is shard
    order: combined sid = shard_starts[i] + local sid."""
    shards: list            # per-shard DevChunks | None (no series routed)
    shard_devices: list     # per-shard torch device
    shard_starts: list      # combined-sid offset of each shard's rows
    series_keys: list       # combined directory (concat in shard order)
    generation: tuple       # (reshard_gen, per-shard generations)
    version: tuple          # (reshard_gen, per-shard (instance, version))


class ShardedDeviceWindow:
    """Series-hash-sharded fleet of device-pinned ``DeviceWindow``s."""

    _instances = 0

    def __init__(self, devices=("cuda",), n_shards: int | None = None,
                 staging_points: int = 1 << 20,
                 max_points: int = 1 << 26,
                 background: bool = True,
                 stall_timeout: float = 60.0) -> None:
        devices = list(devices)
        if not devices:
            raise ValueError("a sharded window needs at least one device")
        if n_shards is None:
            n_shards = max(len(devices), 1)
        ShardedDeviceWindow._instances += 1
        self.instance_id = ("sharded", ShardedDeviceWindow._instances)
        self.staging_points = staging_points
        self.max_points = max_points
        self.background = background
        self.stall_timeout = stall_timeout
        self._lock = threading.RLock()
        self._devices = devices
        self._shards = self._build_shards(n_shards, devices)
        # Which shards have seen each metric: lets chunk_columns skip
        # shards with nothing routed to them (a DeviceWindow miss there
        # would otherwise veto the whole window).
        self._metric_shards: dict[bytes, set[int]] = {}
        # Sticky fleet-level dirty marks: survive reshard (a reshard
        # must never resurrect a window storage has diverged from).
        self._dirty_metrics: set[bytes] = set()
        # Dual-write journal, non-None only while a reshard is running.
        self._journal: list | None = None
        self.generation = 0          # bumps on every committed reshard
        # stats
        self.reshard_count = 0
        self.reshard_ms = 0.0        # last committed reshard, wall ms
        self.dirty_fallbacks = 0
        self.window_hits = 0
        self.window_misses = 0

    def _build_shards(self, n_shards: int, devices) -> list[DeviceWindow]:
        per = max(self.max_points // max(n_shards, 1), 1)
        return [DeviceWindow(staging_points=self.staging_points,
                             max_points=per,
                             background=self.background,
                             stall_timeout=self.stall_timeout,
                             device=devices[i % len(devices)])
                for i in range(n_shards)]

    @property
    def n_shards(self) -> int:
        return len(self._shards)

    def shard_of(self, series_key: bytes) -> int:
        return series_hash(series_key) % len(self._shards)

    # -- ingest side ---------------------------------------------------

    def append(self, metric_uid: bytes, series_key: bytes,
               timestamps: np.ndarray, values: np.ndarray) -> None:
        if len(timestamps) == 0:
            return
        with self._lock:
            if metric_uid in self._dirty_metrics:
                return
            idx = series_hash(series_key) % len(self._shards)
            shard = self._shards[idx]
            self._metric_shards.setdefault(metric_uid, set()).add(idx)
            if self._journal is not None:
                # Journal COPIES under the gate lock: the record must be
                # immutable (replay happens later) and ordered with the
                # reshard's snapshot boundary.
                self._journal.append(
                    (metric_uid, series_key,
                     np.array(timestamps, np.int64),
                     np.array(values, np.float32)))
            # Delegate under the fleet lock: the reshard gate's
            # quiesce+snapshot must never interleave with a half-landed
            # append (staged in neither the snapshot nor the journal).
            shard.append(metric_uid, series_key, timestamps, values)

    def flush(self) -> None:
        with self._lock:
            shards = list(self._shards)
        for s in shards:
            s.flush()

    def invalidate(self, metric_uid: bytes | None = None) -> None:
        with self._lock:
            if metric_uid is None:
                self._dirty_metrics.update(self._metric_shards)
            else:
                self._dirty_metrics.add(metric_uid)
            shards = list(self._shards)
        for s in shards:
            s.invalidate(metric_uid)

    # -- query side ----------------------------------------------------

    def chunk_columns(self, metric_uid: bytes, start: int,
                      end: int) -> ShardedDevChunks | None:
        """The metric's resident columns across every owning shard when
        ALL of them exactly cover [start, end]; None = scan fallback.
        Snapshot-consistent under reshard: the shard list is captured
        once, so a concurrent swap leaves this query on the complete
        pre-swap set, never a mix."""
        with self._lock:
            if metric_uid in self._dirty_metrics:
                self.dirty_fallbacks += 1
                return None
            shards = list(self._shards)
            gen = self.generation
            owners = sorted(self._metric_shards.get(metric_uid, ()))
        if not owners:
            self.window_misses += 1
            return None
        per = [None] * len(shards)
        for i in owners:
            if i >= len(shards):     # mapping raced a shrink; decline
                self.window_misses += 1
                return None
            cols = shards[i].chunk_columns(metric_uid, start, end)
            if cols is None:
                # An owning shard declined (dirty / evicted coverage /
                # slow upload): a partial union would be WRONG, so the
                # whole window falls back to the scan path.
                self.window_misses += 1
                return None
            per[i] = cols
        starts, keys = [], []
        for cols in per:
            starts.append(len(keys))
            if cols is not None:
                keys.extend(cols.series_keys)
        self.window_hits += 1
        return ShardedDevChunks(
            shards=per,
            shard_devices=[s.device for s in shards],
            shard_starts=starts,
            series_keys=keys,
            generation=(gen, tuple(
                c.generation if c is not None else -1 for c in per)),
            version=(gen, tuple(
                (shards[i].instance_id, per[i].version)
                if per[i] is not None else (0, -1)
                for i in range(len(shards)))))

    # -- reshard -------------------------------------------------------

    def reshard(self, n_shards: int | None = None,
                devices=None) -> dict:
        """Live redistribution of the hot set over a new shard count /
        device list. Returns a stats dict. Serialized: concurrent calls
        run back to back."""
        t0 = _time.monotonic()
        devices = list(self._devices if devices is None else devices)
        if not devices:
            raise ValueError("a sharded window needs at least one device")
        if n_shards is None:
            n_shards = max(len(devices), 1)
        # Phase 1 — gate: journaling on + old set fully materialized
        # into device chunks (appends block only for this drain).
        with self._lock:
            if self._journal is not None:
                raise RuntimeError("reshard already in progress")
            self._journal = []
            old = list(self._shards)
            for s in old:
                s.quiesce()
            snaps = [s._snapshot_metrics() for s in old]
            dirty = set(self._dirty_metrics)
        # Phase 2 — rebuild off-gate (old set serves, journal fills).
        new = self._build_shards(n_shards, devices)
        new_owner: dict[bytes, set[int]] = {}
        try:
            for uid in sorted({u for sn in snaps for u in sn}):
                if uid in dirty or any(
                        sn.get(uid, {}).get("dirty") for sn in snaps):
                    dirty.add(uid)
                    continue
                floor = None
                for sn in snaps:
                    cf = sn.get(uid, {}).get("complete_from")
                    if cf is not None:
                        floor = cf if floor is None else max(floor, cf)
                per_series = self._split_series(
                    [sn[uid] for sn in snaps if uid in sn])
                for key, (ts, vals) in per_series.items():
                    j = series_hash(key) % n_shards
                    new[j].append(uid, key, ts, vals)
                    new_owner.setdefault(uid, set()).add(j)
                if floor is not None:
                    for j in new_owner.get(uid, ()):
                        new[j].set_complete_from(uid, floor)
            # Phase 3 — drain the journal in passes, then the gated
            # commit. Each pass replays what accumulated while the
            # previous one ran; the final (small) remainder replays
            # under the lock so the swap sees a complete new set.
            while True:
                with self._lock:
                    batch, self._journal = self._journal, []
                if not batch:
                    break
                self._replay(batch, new, n_shards, new_owner, dirty)
                if len(batch) < 64:
                    break
            with self._lock:
                self._replay(self._journal, new, n_shards, new_owner,
                             dirty)
                self._journal = None
                # Crash here = SIGKILL at the commit: the swap never
                # happens, the old set keeps serving (stale-but-
                # complete), and a restart rebuilds from storage.
                faultpoints.fire("mesh.reshard.commit")
                # Invalidations that came during the rebuild marked only
                # the old set; their metrics' appends were skipped since,
                # so the new set must not serve them either.
                late = self._dirty_metrics - dirty
                dirty |= late
                for uid in late:
                    new_owner.pop(uid, None)
                self._shards = new
                self._devices = devices
                self._metric_shards = new_owner
                self._dirty_metrics = dirty
                self.generation += 1
                self.reshard_count += 1
                self.reshard_ms = (_time.monotonic() - t0) * 1e3
                stats = {"n_shards": n_shards,
                         "generation": self.generation,
                         "metrics": len(new_owner),
                         "dirty_metrics": len(dirty),
                         "reshard_ms": round(self.reshard_ms, 2)}
        except BaseException:
            with self._lock:
                self._journal = None     # abort: old set stays live
            raise
        for uid in late:
            for shard in new:
                shard.invalidate(uid)
        return stats

    @staticmethod
    def _split_series(metric_snaps: list[dict]) -> dict:
        """Per-series (abs_ts, vals) in append order from the refs-only
        snapshots of one metric across its old shards. A series lives
        in exactly one shard, and within a shard its points are in time
        order across seq-ordered chunks, so per-key concatenation
        preserves the strict-monotone append contract."""
        out: dict[bytes, list] = {}
        for sn in metric_snaps:
            keys = sn["keys"]
            epoch = sn["epoch"]
            segs: dict[int, list] = {}
            for ch in sn["chunks"]:
                sid = ch["sid"].cpu().numpy()
                ts = ch["ts"].cpu().numpy().astype(np.int64) + epoch
                vals = ch["vals"].cpu().numpy()
                order = np.argsort(sid, kind="stable")
                sid_o, ts_o, vals_o = sid[order], ts[order], vals[order]
                bounds = np.searchsorted(
                    sid_o, np.arange(len(keys) + 1))
                for s in range(len(keys)):
                    lo, hi = bounds[s], bounds[s + 1]
                    if hi > lo:
                        segs.setdefault(s, []).append(
                            (ts_o[lo:hi], vals_o[lo:hi]))
            for s, parts in segs.items():
                ts_cat = np.concatenate([p[0] for p in parts])
                vl_cat = np.concatenate([p[1] for p in parts])
                out[keys[s]] = (ts_cat, vl_cat)
        return out

    @staticmethod
    def _replay(batch, new, n_shards, new_owner, dirty) -> None:
        for uid, key, ts, vals in batch:
            if uid in dirty:
                continue
            j = series_hash(key) % n_shards
            new[j].append(uid, key, ts, vals)
            new_owner.setdefault(uid, set()).add(j)

    # -- observability -------------------------------------------------

    def resident_points(self) -> int:
        with self._lock:
            shards = list(self._shards)
        total = 0
        for s in shards:
            with s._lock:
                total += sum(mw.device_points
                             for mw in s._metrics.values())
        return total

    def collect_stats(self, collector) -> None:
        with self._lock:
            shards = list(self._shards)
        # Point/eviction/stall counters sum across shards; hit/miss/
        # dirty counters are FLEET-level (one query = one verdict, not
        # one per owning shard).
        agg = {"devwindow.points.appended": 0,
               "devwindow.points.evicted": 0,
               "devwindow.upload_stalls": 0,
               "devwindow.metrics": 0,
               "devwindow.points.resident": 0}

        class _Sink:
            def record(self, name, value):
                if name in agg:
                    agg[name] += value
        sink = _Sink()
        for s in shards:
            s.collect_stats(sink)
        for name, value in agg.items():
            collector.record(name, value)
        collector.record("devwindow.hits", self.window_hits)
        collector.record("devwindow.misses", self.window_misses)
        collector.record("devwindow.dirty_fallbacks",
                         self.dirty_fallbacks)
        collector.record("mesh.resident.points",
                         agg["devwindow.points.resident"])
        collector.record("mesh.resident.shards", len(shards))
        collector.record("mesh.resident.reshard.count",
                         self.reshard_count)
        collector.record("mesh.resident.reshard_ms",
                         round(self.reshard_ms, 2))
