"""TSDB — the thread-safe facade over storage, UIDs, and compaction.

Mirrors ``opentsdb_tpu/core/tsdb.py`` of the JAX package: the write path
(``add_point``, the columnar ``add_batch`` that stores one pre-compacted
cell per row-hour), row-key construction, row compaction and the
columnar read path (``scan_series``) — byte for byte the same rows, so
either package reads what the other wrote — and the resident device
window (``storage/devstore.py``): on by default on the device backend,
mirrored from every write and warmed from what storage already holds.

Live sketches (``stats/livesketch.py``, on by default as in the JAX
package): every write registers its series in the sketch directory before
the store put, and a fully applied write folds its values into the
series' t-digest and its tag values into the (metric, tag key) HLLs.

``checkpoint()`` saves the sketch snapshot ``<wal>.sketches`` and then
spills the store to its sstable tier (``storage/kv.py``), so the snapshot
covers the spilled tier; ``shutdown()`` takes a checkpoint whenever the
store has a WAL, as the JAX package does under its default config. At
start-up the sketches load the snapshot and re-fold the WAL-replayed
memtable on top of it (or, without one, re-fold all of storage), and the
window is warmed from every tier.

Tenant accounting (``tenant/``, on by default as in the JAX package):
every write resolves its series behind the tenant gate (with limits
enforced, a series that needs a new UID is checked against its tenant's
budget before any UID is minted), counts a NEW series per tenant before
the store put, and counts the points after it. The checkpoint saves the
accountant's ``<wal>.tenants.json`` before the spill, beside the sketch
snapshot; at start-up it is loaded and the WAL-replayed memtable's series
folded on top, or, when the file is torn or foreign (a file another
writer marked for a rebuild among them), rebuilt from all of storage.

The store may be a ``MemKVStore`` or a ``ShardedKVStore``
(``storage/sharded.py``); over a sharded store the sketch snapshot is
``<dir>/store.sketches`` and the tenant snapshot ``<dir>/TENANTS.json``,
both saved once at the root. ``Config.wal_group_ms`` turns on the store's
WAL group commit; ``add_batch(..., sync=False)`` then leaves the covering
wait to the caller's ``store.wal_barrier()`` (``server/wire.ingest_batch``
calls it once per wire batch).

``collect_stats`` pushes the engine's ``/stats`` lines (the JAX
package's names) into a StatsCollector; ``drop_caches`` and the
``suggest_*`` calls serve the daemon's ``dropcaches`` and ``/suggest``.

The rollup tier (``rollup/tier.py``, ``Config.enable_rollups``, off by
default as in the JAX package) opens on a writer with a WAL: the
checkpoint brackets its spill with the tier's ``begin_spill`` and
``fold_after_spill``, ``add_batch`` feeds the tier's delta accumulators
(a throttled batch kills its windows, a scalar ``add_point`` invalidates
its window, ``compact_row`` marks its deletes as preserving), the tier
closes before the store, and ``collect_stats`` adds its lines.

Replicas (ROADMAP item 10a): over a read-only store the device window
and tenant accounting stay off (nothing would keep the window in step
with the writer's appends, and a replica neither admits nor snapshots),
queries take the scan path, and a rollup tier opens as
``ReadOnlyRollupTier``. ``refresh_replica`` catches up in the order that
keeps rollup answers safe: the store, then the sketches (reloaded from
the writer's snapshot when the store rebuilt, the old set's folder thread
stopped so its device stacks go once no query holds them), then the
rollup view. ``promote`` takes write ownership (store, sketches, tenants,
then the owning rollup tier) and ``demote`` gives it back.
``cluster_epoch_path`` (set by the CLI in cluster mode) adds the
``cluster.epoch`` / ``cluster.fenced`` / ``cluster.fenced_bytes_refused``
stats lines.

With ``Config.devwindow_shards`` > 0 the resident window is the
mesh-sharded one (``storage/devshard.py``): logical shards over the
mesh's devices (``_devwindow_devices``), warmed at open like the single
window.
"""

from __future__ import annotations

import logging
import os
import threading
import time

import numpy as np

from opentsdb_tpu_torch.core import codec, codec_np, tags as tags_mod
from opentsdb_tpu_torch.core.compaction import CompactionQueue
from opentsdb_tpu_torch.core.const import (MAX_TIMESPAN, TIMESTAMP_BYTES,
                                           UID_WIDTH)
from opentsdb_tpu_torch.core.errors import (IllegalDataError,
                                             NoSuchUniqueName,
                                             PleaseThrottleError)
from opentsdb_tpu_torch.stats.livesketch import LiveSketches
from opentsdb_tpu_torch.storage.devstore import DeviceWindow
from opentsdb_tpu_torch.storage.kv import KVStore
from opentsdb_tpu_torch.storage import sstable
from opentsdb_tpu_torch.storage.sstable import series_hash
from opentsdb_tpu_torch.tenant.accounting import TenantAccountant
from opentsdb_tpu_torch.tenant.limits import TenantLimiter, parse_overrides
from opentsdb_tpu_torch.uid.uniqueid import UniqueId
from opentsdb_tpu_torch.utils.config import Config, resolve_device

LOG = logging.getLogger(__name__)

FAMILY = b"t"


class TSDB:
    def __init__(self, store: KVStore, config: Config | None = None,
                 start_compaction_thread: bool = True) -> None:
        self.config = config or Config()
        # Fail at construction, not at the first query: a daemon asked to
        # run on a card that is not there must not come up at all.
        self.device = resolve_device(self.config.device)
        self.store = store
        # WAL group commit (storage/kv.py), pushed onto the store as the
        # JAX package does.
        group_ms = float(self.config.wal_group_ms or 0.0)
        if group_ms > 0 and hasattr(store, "wal_group_ms"):
            store.wal_group_ms = group_ms
        # Write-side sstable codec (compress/), pushed onto the store so
        # spills and merges encode in it; only a non-default value
        # overrides a store the embedder configured itself.
        codec = self.config.sstable_codec or "none"
        if codec != "none":
            if codec != "tsst4":
                raise ValueError(f"unknown sstable_codec {codec!r} "
                                 f"(one of: none, tsst4)")
            if hasattr(store, "sstable_codec"):
                store.sstable_codec = codec
        # The spill-encode pool is a module knob, shared by every store.
        sstable.set_encode_workers(
            int(self.config.spill_encode_workers or 0))
        store.ensure_table(self.config.table)
        store.ensure_table(self.config.uidtable)
        self.table = self.config.table
        uidtable = self.config.uidtable
        # Points written (the reference's datapoints_added counter).
        self.datapoints_added = 0
        self.metrics = UniqueId(store, uidtable, "metrics", 3)
        self.tagk = UniqueId(store, uidtable, "tagk", 3)
        self.tagv = UniqueId(store, uidtable, "tagv", 3)
        # One checkpoint at a time (the compaction thread's timer and an
        # explicit call may race).
        self._checkpoint_lock = threading.Lock()
        # Cluster mode: the epoch file this daemon's store is governed by
        # (None: not a cluster member), set by the CLI.
        self.cluster_epoch_path: str | None = None
        read_only = getattr(store, "read_only", False)
        self.sketch_save_seconds = 0.0
        # Tenant cardinality control plane (tenant/): per-tenant series
        # accounting + heavy hitters + admission limits, fed from this
        # write path's series-identity hash; set up once the window is
        # warm (None before, and on a read-only store).
        # ``tenant_load_seconds`` keeps the start-up load (or rebuild),
        # ``tenant_save_seconds`` / ``tenant_snapshot_bytes`` the last
        # save's.
        self.tenants = None
        self.tenant_limits = None
        self.tenant_load_seconds = 0.0
        self.tenant_save_seconds = 0.0
        self.tenant_snapshot_bytes = 0
        # skey -> "metric{k=v,...}" memo for the heavy-hitter summary:
        # the label is invariant per series, so the ingest path must not
        # rebuild (sort + join) it every batch. Cleared wholesale at the
        # cap.
        self._series_labels: dict[bytes, str] = {}
        # The rollup tier (set up last, below; the compaction thread's
        # compact_row may read it first).
        self.rollups = None
        self.compactionq = CompactionQueue(
            self, start_thread=start_compaction_thread)
        # Streaming sketch state (stats/livesketch.py): loaded from the
        # checkpoint snapshot when one exists (then re-folding only the
        # WAL-replayed memtable), else rebuilt from a full storage scan.
        self.sketches = None
        self.sketch_load_seconds = 0.0
        # Seconds of the last promote(), by step; whether its owning
        # rollup tier is still to be opened (_open_owning_tier).
        self.promote_seconds: dict[str, float] = {}
        self._tier_pending = False
        if self.config.enable_sketches:
            self._init_sketches()
        # Device-resident columnar hot window (storage/devstore.py):
        # ingest mirrors into device memory so queries skip the scan and
        # the host->device copy. The oracle backend has nothing to serve
        # from it.
        self.devwindow = None
        self.warm_seconds = 0.0
        # A replica never ingests, so nothing would keep a boot-warmed
        # window in step with the appends store.refresh() brings: it would
        # serve stale resident answers while claiming coverage. Replicas
        # take the scan path. Checked here, not written into the config,
        # which the caller owns.
        if (self.config.device_window and self.config.backend != "cpu"
                and not read_only):
            if self.config.devwindow_shards > 0:
                # Mesh-sharded hot set: logical shards round-robined over
                # the mesh devices (storage/devshard.py).
                from opentsdb_tpu_torch.storage.devshard import \
                    ShardedDeviceWindow

                self.devwindow = ShardedDeviceWindow(
                    devices=self._devwindow_devices(),
                    n_shards=self.config.devwindow_shards,
                    staging_points=self.config.device_window_staging,
                    max_points=self.config.device_window_points)
            else:
                self.devwindow = DeviceWindow(
                    staging_points=self.config.device_window_staging,
                    max_points=self.config.device_window_points,
                    device=self.device)
            self._warm_devwindow()
        if self.config.tenant_accounting and not read_only:
            self._init_tenants()
        # Materialized rollup tier (rollup/tier.py): stores with a WAL only
        # (an in-memory store never spills, so every window would stay
        # memtable-dirty). Writers own the fold; replicas open the
        # writer's tier read-only.
        if self.config.enable_rollups and getattr(store, "_wal_path", None):
            if read_only:
                self._open_replica_rollups()
            else:
                from opentsdb_tpu_torch.rollup.tier import RollupTier

                self.rollups = RollupTier(self, self.config)

    def _devwindow_devices(self) -> list:
        """The device list the sharded hot set pins its shards to: the
        mesh's (``mesh_shape``) when set, else every device of the TSDB's
        kind (each card, or the one CPU device). An unbuildable mesh
        raises, as at the daemon's boot: no quiet single-device
        placement."""
        from opentsdb_tpu_torch.parallel.mesh import local_devices
        from opentsdb_tpu_torch.parallel.plan import (build_mesh,
                                                      flatten_series_mesh)
        if self.config.mesh_shape:
            mesh = flatten_series_mesh(
                build_mesh(self.config.mesh_shape, device=self.device))
            return list(mesh.devices)
        return local_devices(self.device)

    def _warm_devwindow(self) -> None:
        """Mirror what storage already holds (the sstable generations and
        the replayed WAL, the port's or the JAX package's) into the device
        window, one append per series, so it covers history from before
        this process started. ``warm_seconds`` keeps the time it took.

        Corrupt storage (conflicting duplicates — IllegalDataError, the
        fsck signal) disables the window outright: a partially warmed
        window would claim coverage it doesn't have."""
        t0 = time.perf_counter()
        try:
            _, per_series = self.scan_series(b"", b"\xff" * 64)
        except IllegalDataError:
            self.devwindow = None
            return
        for skey, cols in per_series.items():
            self.devwindow.append(skey[:UID_WIDTH], skey, cols.timestamps,
                                  cols.values)
        self.warm_seconds = time.perf_counter() - t0

    # ------------------------------------------------------------------
    # Streaming sketches
    # ------------------------------------------------------------------

    def _sketch_path(self) -> str | None:
        wal = getattr(self.store, "_wal_path", None)
        return wal + ".sketches" if wal else None

    def _init_sketches(self) -> None:
        """Load the snapshot and re-fold the live memtable on top of it
        (rows read without the spilled tiers, so nothing the snapshot
        covers folds twice), or, without a snapshot, build the sketches
        from all of storage. ``sketch_load_seconds`` keeps the load's
        time. The set is built whole before it is published, so a query
        racing a replica's reload reads the previous set, never a half
        folded one; the previous set's folder thread then stops
        (``LiveSketches.close``)."""
        path = self._sketch_path()
        cfg = self.config
        if path and os.path.exists(path):
            t0 = time.perf_counter()
            sk = LiveSketches.load(
                path, flush_points=cfg.sketch_flush_points,
                device=self.device)
            self.sketch_load_seconds = time.perf_counter() - t0
            self._refold(
                ((k, self.read_row(k, self.store.memtable_cells(
                    self.table, k, FAMILY)))
                 for k in self.store.memtable_keys(self.table)), sk)
        else:
            sk = LiveSketches(
                compression=cfg.sketch_compression, hll_p=cfg.sketch_hll_p,
                flush_points=cfg.sketch_flush_points, device=self.device)
            self._refold(self._scan_rows(), sk)
        old, self.sketches = self.sketches, sk
        if old is not None:
            old.close()

    def _scan_rows(self):
        """Every stored row, in row-key order, as (row key, columns): the
        JAX package's full re-fold reads storage this way, one row-hour
        at a time, and the fold's buffering follows that order."""
        _, per_series = self.scan_series(b"", b"\xff" * 64)
        rows = []
        for skey, cols in per_series.items():
            base = cols.timestamps - cols.timestamps % MAX_TIMESPAN
            cuts = np.flatnonzero(np.diff(base)) + 1
            starts = np.concatenate(([0], cuts))
            ends = np.concatenate((cuts, [len(base)]))
            for a, b in zip(starts.tolist(), ends.tolist()):
                key = codec.row_key(skey[:UID_WIDTH], int(base[a]), ())
                rows.append((key + skey[UID_WIDTH:], skey, a, b))
        rows.sort()
        for key, skey, a, b in rows:
            cols = per_series[skey]
            yield key, codec.Columns(cols.timestamps[a:b],
                                     cols.values[a:b],
                                     cols.int_values[a:b],
                                     cols.is_float[a:b])

    @staticmethod
    def _refold(rows, sk: LiveSketches) -> None:
        for key, cols in rows:
            if len(cols.timestamps) == 0:
                continue
            pr = codec.parse_row_key(key)
            sk.observe(codec.series_key(key), cols.values,
                       [(pr.metric_uid, k, v) for k, v in pr.tag_uids])
        sk.flush()

    def _observe(self, series_key: bytes, metric_uid: bytes,
                 pairs: list[tuple[bytes, bytes]],
                 values: np.ndarray) -> None:
        if self.sketches is None:
            return
        self.sketches.observe(
            series_key, values, [(metric_uid, k, v) for k, v in pairs])

    # ------------------------------------------------------------------
    # Replicas and the cluster tier (ROADMAP item 10a)
    # ------------------------------------------------------------------

    def _open_replica_rollups(self) -> bool:
        """Open the writer's rollup tier read-only. A replica must come up
        even when that tier is mid-rebuild or foreign: it then serves raw,
        and every ``refresh_replica`` tries again."""
        from opentsdb_tpu_torch.rollup.tier import ReadOnlyRollupTier
        try:
            self.rollups = ReadOnlyRollupTier(self, self.config)
            return True
        except Exception:
            LOG.exception("replica rollup tier unavailable; serving raw")
            return False

    def refresh_replica(self) -> bool:
        """One replica catch-up: the store (a WAL suffix replay, or a
        rebuild after a writer checkpoint), the sketches when the store
        rebuilt (``reload_sketches``), then the read-only rollup tier, in
        THAT order, which keeps replica rollup answers safe
        (``ReadOnlyRollupTier``'s docstring). The WalTailer and the legacy
        ``--read-only`` timer drive it. True when the raw view changed."""
        if not getattr(self.store, "read_only", False):
            raise ValueError("refresh_replica() is for read-only "
                             "replica stores")
        before = self.store.rebuilds
        changed = self.store.refresh()
        if self.store.rebuilds != before:
            self.reload_sketches()
        tier = self.rollups
        if (tier is None and self.config.enable_rollups
                and getattr(self.store, "_wal_path", None)):
            # The tier failed to open at boot (the writer mid-rebuild, a
            # torn state file): adopt it once the writer settles.
            if self._open_replica_rollups():
                tier = self.rollups
        if tier is not None and getattr(tier, "read_only", False):
            tier.refresh()
        return changed

    def reload_sketches(self) -> None:
        """Re-load the writer's sketch snapshot and re-fold the (freshly
        rebuilt) memtable on top, as a boot does (``_init_sketches``).
        ``refresh_replica`` calls it whenever the store rebuilt, which
        every writer checkpoint causes, so a replica's sketches lag by at
        most the writer's checkpoint interval plus a poll (suffix replays
        are not folded). The replaced set's folder thread stops, and its
        device stacks go once no query holds it."""
        if self.config.enable_sketches:
            self._init_sketches()

    def promote(self, writer_epoch: int, epoch_guard=None) -> None:
        """Replica -> writer takeover. The caller has already bumped the
        persisted epoch. The store takes ownership first (fresh-inode WAL
        + epoch header, ``promote_writable``), then the sketches and the
        tenant accounting initialize as a writer's boot does, under the
        checkpoint lock; a failure there demotes the store back, so a
        half-promoted daemon never serves. Then the read-only rollup view
        swaps for the owning tier, outside the lock (the tier's close
        joins a catch-up thread that takes it). The device window stays
        off until the next restart. ``promote_seconds`` keeps the time of
        each step (store, sketches, tenants, rollups)."""
        times = {}
        with self._checkpoint_lock:
            t0 = time.perf_counter()
            self.store.promote_writable(writer_epoch,
                                        epoch_guard=epoch_guard)
            times["store"] = time.perf_counter() - t0
            try:
                t0 = time.perf_counter()
                if self.config.enable_sketches:
                    self._init_sketches()
                times["sketches"] = time.perf_counter() - t0
                t0 = time.perf_counter()
                if self.config.tenant_accounting:
                    # The promoted writer owns admission now: adopt the
                    # dead writer's snapshot (or rebuild).
                    self._init_tenants()
                times["tenants"] = time.perf_counter() - t0
                old = self.rollups
                self.rollups = None
            except BaseException:
                self.tenants = None
                self.tenant_limits = None
                try:
                    self.store.demote_readonly()
                except Exception:
                    LOG.exception("rollback demote after failed "
                                  "promotion")
                raise
        t0 = time.perf_counter()
        if old is not None:
            try:
                old.close()
            except Exception:
                LOG.exception("closing replica rollup view during "
                              "promotion")
        if self.config.enable_rollups and getattr(self.store, "_wal_path",
                                                  None):
            self._open_owning_tier()
        times["rollups"] = time.perf_counter() - t0
        self.promote_seconds = times

    def _open_owning_tier(self) -> None:
        """A promoted writer's owning rollup tier. The promoted writer must
        serve even without it (raw answers stay exact): a torn tier, or a
        deposed writer that still runs and holds the tier's lock. Then the
        next checkpoint opens it again before it spills (once the deposed
        writer is demoted or gone, its lock is free); while it cannot, the
        spill is refused (``MemKVStore._retire_snapshots``) rather than
        made under stale summaries. The JAX package tries once, at the
        promotion."""
        from opentsdb_tpu_torch.rollup.tier import RollupTier
        try:
            self.rollups = RollupTier(self, self.config)
            self._tier_pending = False
        except Exception:
            self._tier_pending = True
            LOG.exception("promoted writer rollup tier unavailable; "
                          "serving raw")

    def demote(self) -> None:
        """Writer -> tailing replica, in place. The owning rollup tier
        closes first, outside the checkpoint lock (its catch-up thread
        reads the store and takes that lock); then the queued compactions
        are dropped (writer work, reconstructible), the store drops its
        WAL and flock and rebuilds as a replica, the sketches reload from
        the new writer's snapshot, tenant accounting goes, and the
        read-only rollup view opens as a replica boot opens it."""
        with self._checkpoint_lock:
            old = self.rollups
            self.rollups = None
        if old is not None:
            try:
                old.close()
            except Exception:
                LOG.exception("closing rollup tier during demotion")
        with self._checkpoint_lock:
            self.compactionq.clear()
            self.store.demote_readonly()
            self.reload_sketches()
            self.tenants = None
            self.tenant_limits = None
        if self.config.enable_rollups and getattr(self.store, "_wal_path",
                                                  None):
            self._open_replica_rollups()

    # ------------------------------------------------------------------
    # Tenant cardinality control plane (tenant/)
    # ------------------------------------------------------------------

    def _tenants_path(self) -> str | None:
        """``<wal>.tenants.json`` beside a single-file WAL; a sharded
        store's ``TENANTS.json`` at its root, beside ``SHARDS.json`` (its
        ``_wal_path`` is the ``<dir>/store`` naming root, not a file)."""
        wal = getattr(self.store, "_wal_path", None)
        if not wal:
            return None
        if getattr(self.store, "shard_count", None) is not None:
            return os.path.join(os.path.dirname(wal), "TENANTS.json")
        return wal + ".tenants.json"

    def _init_tenants(self) -> None:
        """Load the snapshot and re-fold the WAL-replayed memtable's
        series on top — the snapshot commits BEFORE each spill, so it
        always covers the sstable tier and the memtable delta is
        everything it can be missing. A torn or foreign state file
        rebuilds from a full storage scan instead (totals exact;
        per-tenant splits land on the default tenant, declared via
        recovered_series)."""
        t0 = time.perf_counter()
        cfg = self.config
        self.tenant_limits = TenantLimiter(
            max_series=cfg.tenant_max_series,
            global_max=cfg.tenant_global_max_series,
            mode=cfg.tenant_limit_mode,
            overrides=parse_overrides(cfg.tenant_overrides))
        path = self._tenants_path()
        acct = None
        if path and os.path.exists(path):
            try:
                acct = TenantAccountant.load(
                    path, exact_cutoff=cfg.tenant_exact_cutoff,
                    hll_p=cfg.tenant_hll_p, topk=cfg.tenant_topk)
            except Exception as e:
                LOG.warning("tenant snapshot at %s torn/foreign (%r); "
                            "rebuilding tenant accounting from "
                            "storage", path, e)
        if acct is not None:
            acct.fold_recovered(self._memtable_series_hashes())
        else:
            torn = bool(path and os.path.exists(path))
            acct = TenantAccountant(
                path=path, exact_cutoff=cfg.tenant_exact_cutoff,
                hll_p=cfg.tenant_hll_p, topk=cfg.tenant_topk)
            if torn or self.tenant_limits.enabled:
                # The full scan is REQUIRED under enforcement (the limiter
                # must never refuse a pre-existing series as "new"), and a
                # torn snapshot means accounting was live here: recover it
                # exactly.
                acct.fold_recovered(self._storage_series_hashes())
            else:
                # Observability only, no snapshot (first boot, or a store
                # from before accounting): no checkpoint ever committed
                # a snapshot, so fold the memtable delta only; the first
                # checkpoint makes this a one-time transition.
                acct.fold_recovered(self._memtable_series_hashes())
            acct.rebuilt = torn
        self.tenants = acct
        self.tenant_load_seconds = time.perf_counter() - t0

    def _memtable_series_hashes(self):
        return (series_hash(codec.series_key(k))
                for k in self.store.memtable_keys(self.table))

    def _storage_series_hashes(self):
        """Every distinct series-identity hash currently in storage
        (raw key scan, no cell decode) — the rebuild source when the
        snapshot is gone."""
        seen: set[int] = set()
        for key, _items in self.store.scan_raw(self.table, b"",
                                               b"\xff" * 64):
            h = series_hash(codec.series_key(key))
            if h not in seen:
                seen.add(h)
                yield h

    def _admit_series(self, tenant: str, skey: bytes,
                      metric: str) -> None:
        """Tenant admission + accounting for one about-to-be-written
        series; raises TenantLimitError (enforce mode) when the series
        is NEW and the tenant (or the directory) is over budget.
        Counting happens here, BEFORE the storage put, mirroring the
        sketch directory's note_series placement."""
        acct = self.tenants
        if acct is None:
            return
        h = series_hash(skey)
        if acct.seen(h):
            return
        self.tenant_limits.admit_new_series(acct, tenant)
        acct.note_new_series(tenant, h, metric)

    _SERIES_LABEL_CAP = 65536

    def _account_points(self, tenant: str, metric: str,
                        tag_map: dict, n: int, skey: bytes) -> None:
        if self.tenants is None or n <= 0:
            return
        label = self._series_labels.get(skey)
        if label is None:
            label = metric
            if tag_map:
                label += "{" + ",".join(
                    f"{k}={v}" for k, v in sorted(tag_map.items())) + "}"
            if len(self._series_labels) >= self._SERIES_LABEL_CAP:
                self._series_labels.clear()
            self._series_labels[skey] = label
        self.tenants.note_points(tenant, label, n)

    # ------------------------------------------------------------------
    # Row-key construction
    # ------------------------------------------------------------------

    def resolve_tags(self, tag_map: dict[str, str],
                     create: bool = True) -> list[tuple[bytes, bytes]]:
        """Resolve tag names/values to UID pairs, sorted by tagk id: row
        keys for one logical series are byte-identical regardless of
        input order (reference Tags.java:308-348)."""
        get_k = self.tagk.get_or_create_id if create else self.tagk.get_id
        get_v = self.tagv.get_or_create_id if create else self.tagv.get_id
        pairs = [(get_k(k), get_v(v)) for k, v in tag_map.items()]
        pairs.sort()
        return pairs

    def _row_parts(self, metric: str, tag_map: dict[str, str],
                   create_metric: bool | None = None,
                   create_tags: bool = True,
                   ) -> tuple[bytes, list[tuple[bytes, bytes]]]:
        """(metric_uid, sorted tag UID pairs) for a series."""
        tags_mod.check_metric_and_tags(metric, tag_map)
        if create_metric is None:
            create_metric = self.config.auto_create_metrics
        metric_uid = (self.metrics.get_or_create_id(metric) if create_metric
                      else self.metrics.get_id(metric))
        return metric_uid, self.resolve_tags(tag_map, create_tags)

    def _row_parts_admitted(self, tenant: str, metric: str,
                            tag_map: dict[str, str],
                            ) -> tuple[bytes, list[tuple[bytes, bytes]]]:
        """``_row_parts`` behind the tenant gate. With enforcement on,
        resolve WITHOUT creating first: a missing UID means the series
        is certainly NEW, so the tenant/global budget check runs before
        ``get_or_create`` allocates durable UID mappings — a refused
        series must not grow the metric/tagk/tagv maps. When every UID
        resolves the combination may still be new: ``_admit_series``
        settles it against the seen-set once the series hash exists."""
        if (self.tenants is None or not self.tenant_limits.enabled
                or self.tenant_limits.mode != "enforce"):
            return self._row_parts(metric, tag_map)
        try:
            return self._row_parts(metric, tag_map, create_metric=False,
                                   create_tags=False)
        except NoSuchUniqueName:
            if not self.config.auto_create_metrics:
                # The metric itself may be the missing piece, and it can
                # never be created here: that put dies as "unknown
                # metric" regardless of any budget, so it must not count
                # as a tenant refusal. Re-raises NoSuchUniqueName if so.
                self.metrics.get_id(metric)
            self.tenant_limits.admit_new_series(self.tenants, tenant)
            return self._row_parts(metric, tag_map)

    def row_key_for(self, metric: str, tag_map: dict[str, str],
                    base_ts: int, create_metric: bool | None = None,
                    create_tags: bool = True) -> bytes:
        metric_uid, pairs = self._row_parts(metric, tag_map,
                                            create_metric, create_tags)
        return codec.row_key(metric_uid, base_ts, pairs)

    # ------------------------------------------------------------------
    # Write path
    # ------------------------------------------------------------------

    def add_point(self, metric: str, timestamp: int, value: int | float,
                  tag_map: dict[str, str], durable: bool = True,
                  tenant: str = "default") -> None:
        """Store one data point (reference TSDB.addPoint :236-352)."""
        if timestamp & ~0xFFFFFFFF:
            raise ValueError(
                f"{'negative' if timestamp < 0 else 'bad'} "
                f"timestamp={timestamp} when trying to add value={value} "
                f"to metric={metric}, tags={tag_map}")
        if isinstance(value, bool):
            raise ValueError("boolean value")
        if isinstance(value, float):
            buf, flags = codec.encode_float(value)
        else:
            buf, flags = codec.encode_long(value)
        base_ts = codec.base_time(timestamp)
        metric_uid, pairs = self._row_parts_admitted(tenant, metric,
                                                     tag_map)
        row = codec.row_key(metric_uid, base_ts, pairs)
        qual = codec.encode_qualifier(timestamp - base_ts, flags)
        skey = codec.series_key(row)
        # Tenant admission first (a refused NEW series leaves no trace),
        # then the sketch directory learns the series before storage
        # holds it.
        self._admit_series(tenant, skey, metric)
        if self.sketches is not None:
            self.sketches.note_series(skey)
        self.store.put(self.table, row, FAMILY, qual, buf, durable=durable)
        # Scalar puts bypass the delta-fold feed (add_batch): their coarse
        # window must take the full fold's re-read.
        delta = getattr(self.rollups, "delta", None)
        if delta is not None:
            delta.invalidate(skey, base_ts)
        if self.config.enable_compactions:
            self.compactionq.add(row)
        self.datapoints_added += 1
        self._account_points(tenant, metric, tag_map, 1, skey)
        self._observe(skey, metric_uid, pairs,
                      np.asarray([value], np.float64))
        if self.devwindow is not None:
            self.devwindow.append(metric_uid, skey,
                                  np.asarray([timestamp], np.int64),
                                  np.asarray([value], np.float32))

    def add_batch(self, metric: str, timestamps: np.ndarray,
                  values: np.ndarray, tag_map: dict[str, str],
                  durable: bool = True,
                  is_float: np.ndarray | None = None,
                  int_values: np.ndarray | None = None,
                  tenant: str = "default", sync: bool = True) -> int:
        """Columnar ingest for one series: one pre-compacted cell per
        row-hour.

        ``values`` may be an integer or floating dtype; float points are
        stored as 4-byte floats (matching telnet ingest), int points on
        their smallest widths. ``is_float`` types points individually
        within a float-dtyped ``values`` array, with ``int_values`` (int64)
        alongside to keep integers above 2^53 exact. ``tenant`` is charged
        for the series (raising TenantLimitError when it is NEW and over
        budget) and its points. ``sync=False`` skips the WAL group-commit
        wait, so a caller writing many series acknowledges them after one
        ``store.wal_barrier()``. Returns the points written."""
        timestamps = np.asarray(timestamps, dtype=np.int64)
        if timestamps.size == 0:
            return 0
        if (timestamps & ~np.int64(0xFFFFFFFF)).any():
            raise ValueError("timestamp out of range in batch")
        if is_float is not None:
            fmask = np.asarray(is_float, dtype=bool)
            fvals = np.asarray(values, dtype=np.float64)
            if int_values is not None:
                ivals = np.asarray(int_values, dtype=np.int64)
            else:
                ivals = np.where(fmask, 0, fvals).astype(np.int64)
        elif np.issubdtype(np.asarray(values).dtype, np.floating):
            fvals = np.asarray(values, dtype=np.float64)
            ivals = np.zeros_like(timestamps)
            fmask = np.ones(timestamps.shape, dtype=bool)
        else:
            ivals = np.asarray(values, dtype=np.int64)
            fvals = ivals.astype(np.float64)
            fmask = np.zeros(timestamps.shape, dtype=bool)

        # One vectorized pass for the whole series: global sort + dedup,
        # then every row-hour's cell encoded in one flat-buffer pass.
        ts_s, f_s, i_s, m_s = codec_np.sort_dedup(
            timestamps, fvals, ivals, fmask)
        base = ts_s - ts_s % MAX_TIMESPAN
        deltas = ts_s - base
        row_starts = np.concatenate(
            ([0], np.flatnonzero(np.diff(base)) + 1))
        quals, vals = codec_np.encode_cells_multi(deltas, f_s, i_s, m_s,
                                                  row_starts)
        metric_uid, pairs = self._row_parts_admitted(tenant, metric,
                                                     tag_map)
        tmpl = bytes(codec.row_key(metric_uid, 0, pairs))
        # All row keys in one pass: broadcast the template, stamp the
        # base-time bytes, keep the contiguous blob for the columnar put.
        L = len(tmpl)
        keys = np.tile(np.frombuffer(tmpl, np.uint8), (len(quals), 1))
        keys[:, UID_WIDTH:UID_WIDTH + TIMESTAMP_BYTES] = (
            base[row_starts].astype(">u4").view(np.uint8).reshape(-1, 4))
        kb = keys.tobytes()
        skey = codec.series_key(kb[:L])
        # Tenant admission precedes both the directory registration and
        # the put: a NEW series from an over-budget tenant refuses here
        # before any byte lands. The sketch directory then learns the
        # series before any row of it is visible in storage
        # (over-registering a batch that then fails is harmless).
        self._admit_series(tenant, skey, metric)
        if self.sketches is not None:
            self.sketches.note_series(skey)
        delta = getattr(self.rollups, "delta", None)
        try:
            existed = self.store.put_many_columnar(
                self.table, FAMILY, kb, L, quals, vals, durable=durable,
                sync=sync)
        except PleaseThrottleError as e:
            # Which rows landed is unknowable here: the batch's rollup
            # windows can no longer be folded from the delta buffers.
            if delta is not None:
                delta.kill_batch(skey, base[row_starts])
            # The rows that did apply still need compaction; they will
            # never reach the window (this raise skips its append), and a
            # retry of the batch would fail its order check anyway: drop
            # the metric's window so queries take the scan path instead of
            # a partial view.
            self._queue_compactions(kb, L, e.partial_existed)
            if self.devwindow is not None:
                self.devwindow.invalidate(metric_uid)
            raise
        self._queue_compactions(kb, L, existed)
        # The applied batch's columns are what a checkpoint fold's raw
        # re-read would decode: buffer them for the delta fold.
        if delta is not None:
            delta.feed(skey, ts_s, f_s, i_s, m_s, base, row_starts, existed)
        n = len(ts_s)
        self.datapoints_added += n
        self._account_points(tenant, metric, tag_map, n, skey)
        # The sketch fold covers fully applied batches only (a throttled
        # batch raised above); one float32 conversion serves the sketches
        # and the window.
        if self.sketches is not None or self.devwindow is not None:
            f32 = f_s.astype(np.float32)
            self._observe(skey, metric_uid, pairs, f32)
            if self.devwindow is not None:
                self.devwindow.append(metric_uid, skey, ts_s, f32)
        return n

    def _queue_compactions(self, kb: bytes, L: int,
                           existed: list[bool]) -> None:
        """Rows that already held cells now hold several: queue them so
        the per-batch compacted cells merge into one."""
        if self.config.enable_compactions and any(existed):
            for i, e in enumerate(existed):
                if e:
                    self.compactionq.add(kb[i * L:(i + 1) * L])

    # ------------------------------------------------------------------
    # Compaction
    # ------------------------------------------------------------------

    def compact_row(self, key: bytes) -> None:
        """Merge all cells of a row into one compacted cell in storage.

        Parity: reference CompactionQueue.compact (:243-437) — single-cell
        rows are left alone (modulo the legacy float fix), the merged cell
        is written before the originals are deleted, and an original cell
        that already equals the merged form is never deleted-after-write.
        """
        delta = getattr(self.rollups, "delta", None)
        if delta is None:
            self._compact_row(key)
            return
        # Compaction keeps the row's point set: this thread's deletes are
        # preserving, so the store's delete hook leaves the row's rollup
        # delta window alone.
        delta.preserve.on = True
        try:
            self._compact_row(key)
        finally:
            delta.preserve.on = False

    def _compact_row(self, key: bytes) -> None:
        cells = self.store.get(self.table, key, FAMILY)
        if len(cells) <= 1:
            if cells:
                qual, val = cells[0].qualifier, cells[0].value
                if len(qual) == 2 and codec.needs_float_fix(qual[1], val):
                    fixed_val = codec.fix_float_value(qual[1], val)
                    fixed_qual = bytes([
                        qual[0],
                        codec.fix_qualifier_flags(qual[1], len(fixed_val))])
                    self.store.put(self.table, key, FAMILY, fixed_qual,
                                   fixed_val)
                    if fixed_qual != qual:
                        self.store.delete(self.table, key, FAMILY, [qual])
            return
        qual, val = codec.compact_cells(
            [(c.qualifier, c.value) for c in cells])
        existing = {c.qualifier: c.value for c in cells}
        if existing.get(qual) != val:
            self.store.put(self.table, key, FAMILY, qual, val)
            self.compactionq.written_cells += 1
        to_delete = [c.qualifier for c in cells if c.qualifier != qual]
        if to_delete:
            self.store.delete(self.table, key, FAMILY, to_delete)
            self.compactionq.deleted_cells += len(to_delete)

    # ------------------------------------------------------------------
    # Read path
    # ------------------------------------------------------------------

    def read_row(self, key: bytes, cells: list) -> codec.Columns:
        """Decode one row's cells (possibly several) into sorted columnar
        arrays (the JAX package's ``TSDB.read_row``)."""
        base_ts = codec.key_base_time(key)
        kept = [c for c in cells
                if len(c.qualifier) % 2 == 0 and c.qualifier]
        if not kept:
            return codec.Columns(np.zeros(0, np.int64),
                                 np.zeros(0, np.float64),
                                 np.zeros(0, np.int64), np.zeros(0, bool))
        ts, f, i, isf, _ = codec_np.decode_cells_flat(
            [c.qualifier for c in kept], [c.value for c in kept],
            np.full(len(kept), base_ts, np.int64))
        if len(kept) == 1:
            return codec.Columns(ts, f, i, isf)
        d, f, i, isf = codec_np.sort_dedup(ts, f, i, isf)
        return codec.Columns(d, f, i, isf)

    def scan_series(self, start_key: bytes, stop_key: bytes,
                    key_regexp: bytes | None = None,
                    batch_cells: int = 1 << 18, series_hint=None):
        """Whole-range columnar scan regrouped BY SERIES: returns
        (series_keys, per_series Columns dict) with one global (series,
        timestamp) lexsort and one vectorized dedup pass. Duplicate
        (series, ts) points collapse when value-equal and raise
        IllegalDataError otherwise (reference complexCompact :600-679).
        ``series_hint`` goes to the store's scan (``scan_raw``), which may
        skip the generations it rules out."""
        quals: list[bytes] = []
        vals: list[bytes] = []
        bases: list[int] = []
        cell_sid: list[int] = []
        skey_index: dict[bytes, int] = {}
        skeys: list[bytes] = []
        parts: list[tuple] = []     # decoded (ts, f, i, isf, sid) batches

        def decode_batch():
            ts, f, i, isf, cop = codec_np.decode_cells_flat(
                quals, vals, np.asarray(bases, np.int64))
            sid = np.asarray(cell_sid, np.int64)[cop]
            parts.append((ts, f, i, isf, sid))
            quals.clear(), vals.clear(), bases.clear(), cell_sid.clear()

        for key, items in self.store.scan_raw(
                self.table, start_key, stop_key,
                family=FAMILY, key_regexp=key_regexp,
                series_hint=series_hint):
            base = codec.key_base_time(key)
            skey = codec.series_key(key)
            si = skey_index.get(skey)
            if si is None:
                si = skey_index[skey] = len(skeys)
                skeys.append(skey)
            for q, v in items:
                if len(q) % 2 != 0 or not q:
                    continue  # foreign/annotation cells
                quals.append(q)
                vals.append(v)
                bases.append(base)
                cell_sid.append(si)
            if len(quals) >= batch_cells:
                decode_batch()
        if quals:
            decode_batch()
        if not parts:
            return skeys, {}
        ts = np.concatenate([p[0] for p in parts])
        f = np.concatenate([p[1] for p in parts])
        i = np.concatenate([p[2] for p in parts])
        isf = np.concatenate([p[3] for p in parts])
        sid = np.concatenate([p[4] for p in parts])
        order = np.lexsort((ts, sid))
        ts, f, i, isf, sid = (ts[order], f[order], i[order], isf[order],
                              sid[order])
        if len(ts) > 1:
            dup = (sid[1:] == sid[:-1]) & (ts[1:] == ts[:-1])
            if dup.any():
                same = ((isf[1:] == isf[:-1])
                        & np.where(isf[1:], f[1:] == f[:-1],
                                   i[1:] == i[:-1]))
                if (dup & ~same).any():
                    bad = int(ts[1:][dup & ~same][0])
                    raise IllegalDataError(
                        f"Found out of order or duplicate data: "
                        f"ts={bad} -- run an fsck.")
                keep = np.concatenate(([True], ~dup))
                ts, f, i, isf, sid = (ts[keep], f[keep], i[keep],
                                      isf[keep], sid[keep])
        bounds = np.searchsorted(sid, np.arange(len(skeys) + 1))
        per_series = {
            skeys[s]: codec.Columns(ts[a:b], f[a:b], i[a:b], isf[a:b])
            for s, (a, b) in enumerate(zip(bounds[:-1], bounds[1:]))
            if b > a}
        return skeys, per_series

    # ------------------------------------------------------------------
    # UID admin and stats
    # ------------------------------------------------------------------

    def suggest_metrics(self, prefix: str = "") -> list[str]:
        return self.metrics.suggest(prefix)

    def suggest_tag_names(self, prefix: str = "") -> list[str]:
        return self.tagk.suggest(prefix)

    def suggest_tag_values(self, prefix: str = "") -> list[str]:
        return self.tagv.suggest(prefix)

    def drop_caches(self) -> None:
        self.metrics.drop_caches()
        self.tagk.drop_caches()
        self.tagv.drop_caches()

    def collect_stats(self, collector) -> None:
        """Push the engine's counters into a StatsCollector (reference
        TSDB.collectStats :129-175; the JAX package's lines and order).

        ``compress.ratio`` appears once a v4 generation exists, the rollup
        tier's ``rollup.*`` and ``sketch.bytes`` lines while it is open,
        and in cluster mode ``cluster.epoch`` (the epoch a writer owns, or
        the file's for a replica or a fenced writer), ``cluster.fenced``
        and, once nonzero, ``cluster.fenced_bytes_refused``."""
        collector.record("datapoints.added", self.datapoints_added)
        for uid in (self.metrics, self.tagk, self.tagv):
            kind = uid.kind()
            collector.record("uid.cache-hit", uid.cache_hits,
                             f"kind={kind}")
            collector.record("uid.cache-miss", uid.cache_misses,
                             f"kind={kind}")
            collector.record("uid.cache-size", uid.cache_size(),
                             f"kind={kind}")
        store = self.store
        collector.record("storage.wal.swallowed_flush_errors",
                         store.wal_swallowed_flush_errors)
        nshards = getattr(store, "shard_count", None)
        if nshards is not None:
            collector.record("storage.shards", nshards)
        # Live-memtable rows per shard: the skew a slow spill join shows
        # after the fact (checkpoint.shard_spill), live.
        for i, n in enumerate(store.memtable_row_counts(self.table)):
            collector.record("storage.memtable.rows", n, f"shard={i}")
        for fmt, nbytes in sorted(store.sstable_format_bytes().items()):
            collector.record("sstable.bytes", nbytes, f"format=v{fmt}")
        raw, enc = store.compress_stats()
        if enc:
            # Uncompressed-record bytes per stored byte across the v4
            # generations.
            collector.record("compress.ratio", round(raw / enc, 4))
        collector.record("bloom.files_skipped", store.bloom_files_skipped)
        if nshards is not None:
            collector.record("bloom.shards_skipped",
                             store.bloom_shards_skipped)
        collector.record("bloom.point_skips", store.bloom_point_skips)
        collector.record("dirty_set.size",
                         int(len(store.dirty_bases(self.table))))
        if self.cluster_epoch_path:
            epoch = getattr(store, "writer_epoch", None)
            if epoch is None:
                from opentsdb_tpu_torch.cluster.epoch import read_epoch
                try:
                    epoch, _ = read_epoch(self.cluster_epoch_path)
                except (OSError, ValueError, KeyError):
                    epoch = None
            if epoch is not None:
                collector.record("cluster.epoch", int(epoch))
            guard = getattr(store, "epoch_guard", None)
            if guard is not None:
                collector.record("cluster.fenced", int(guard.fenced))
            refused = getattr(store, "fenced_bytes_refused", 0)
            if refused:
                collector.record("cluster.fenced_bytes_refused", refused)
        cq = self.compactionq
        collector.record("compaction.count", cq.written_cells)
        collector.record("compaction.deleted_cells", cq.deleted_cells)
        collector.record("compaction.errors", cq.errors)
        collector.record("compaction.queue.size", len(cq))
        if self.sketches is not None:
            collector.record("sketches.series",
                             self.sketches.series_count())
        if self.tenants is not None:
            self.tenants.collect_stats(collector)
        if self.devwindow is not None:
            self.devwindow.collect_stats(collector)
        if self.rollups is not None:
            self.rollups.collect_stats(collector)

    # ------------------------------------------------------------------
    # Lifecycle
    # ------------------------------------------------------------------

    def flush(self) -> None:
        """Flush compactions then the storage engine (reference :384-417)."""
        self.compactionq.flush(cutoff=int(time.time()) - MAX_TIMESPAN - 1)
        self.store.flush()

    def checkpoint(self) -> int:
        """Save the sketch and tenant snapshots, then spill the store's memtable to its
        sstable tier and truncate the WAL (``MemKVStore.checkpoint``).
        Returns rows spilled, 0 when the store keeps no WAL.

        The snapshot commits before the spill, as in the JAX package: a
        crash in between leaves a snapshot that already covers the
        still-replayable memtable, whose re-fold then counts it twice
        (exact for HLLs, within sketch tolerance for digests), instead of
        a snapshot missing folds the truncated WAL can no longer replay.
        ``sketch_save_seconds`` keeps the last save's time. The tenant
        snapshot takes the same place for the same reason (its folds are
        idempotent by series hash); without accounting the store marks
        the tenant file foreign instead (``MemKVStore._retire_snapshots``).

        Without sketches a snapshot left by an earlier run would miss the
        rows spilled now, and the JAX package's next open would load it
        and re-fold only the memtable, under-counting. So it is removed,
        and that open re-folds all of storage (ROADMAP queue C, reference
        note 5)."""
        if getattr(self.store, "read_only", False):
            # A replica owns neither the snapshots nor the spill tier:
            # writing either would race the writer daemon.
            return 0
        if self._tier_pending and self.rollups is None:
            self._open_owning_tier()
        ckpt = getattr(self.store, "checkpoint", None)
        with self._checkpoint_lock:
            path = self._sketch_path()
            if path and self.sketches is not None:
                t0 = time.perf_counter()
                self.sketches.save(path)
                self.sketch_save_seconds = time.perf_counter() - t0
            elif path and os.path.exists(path):
                os.unlink(path)
            if self.tenants is not None:
                self._save_tenants()
            if ckpt is None:
                return 0
            # The rollup tier brackets the spill: the about-to-spill
            # windows go in flight (and the tier pending on disk) before
            # the spill, the spilled keys fold after it; a crash between
            # leaves the pending marker and the next open catches up.
            rollups = getattr(self, "rollups", None)
            if rollups is not None:
                rollups.begin_spill()
            rows = ckpt(tenant_marker=self.tenants is None)
            if rollups is not None:
                rollups.fold_after_spill()
            return rows

    def _save_tenants(self) -> None:
        t0 = time.perf_counter()
        self.tenant_snapshot_bytes = self.tenants.save()
        self.tenant_save_seconds = time.perf_counter() - t0

    def shutdown(self) -> None:
        """Idempotent: stop and drain the compaction queue, checkpoint
        when the store has a WAL (the JAX package checkpoints at every
        clean shutdown under its default config; the tenant snapshot is
        saved inside it, and has nowhere to go without a WAL), flush the
        WAL, close the store (which releases the WAL's single-writer lock
        even when the checkpoint or the flush raises)."""
        if getattr(self, "_shutdown_done", False):
            return
        self._shutdown_done = True
        try:
            self.compactionq.shutdown()
            if getattr(self.store, "_wal_path", None):
                self.checkpoint()
            self.store.flush()
        finally:
            # The rollup tier closes first: its close stops and joins the
            # catch-up thread, which reads the store. The store closes
            # even when that raises (it releases the WAL's flock).
            try:
                if getattr(self, "rollups", None) is not None:
                    self.rollups.close()
            finally:
                close = getattr(self.store, "close", None)
                if close:
                    close()
