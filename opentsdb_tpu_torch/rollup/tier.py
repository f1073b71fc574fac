"""RollupTier — the materialized multi-resolution summary tier.

Mirrors ``opentsdb_tpu/rollup/tier.py`` of the JAX package (``RollupTier``
and ``_MapBuffer``), with the same layout, state file, bracket, fault
sites and ``rollup.*`` instruments, so each package opens the other's
tier without a rebuild and the host fold writes the same bytes. What
differs:

- ``Config.rollup_device_fold`` folds with the port's window-fold kernel
  (``rollup/summary.window_summaries_device`` on the TSDB's device) and
  declares ``device-f64``;
- a tier store's own checkpoint writes no tenant marker (the JAX store
  has none to write);
- ``ReadOnlyRollupTier`` (replicas) comes with item 10.

A parallel per-shard storage tier holding one summary record per
(series, coarse window) at each configured resolution (default 1h and
1d), computed at checkpoint-spill time and served by the query
planner's rollup step (rollup/planner.py) so long-range downsampled
queries cost O(windows) instead of O(points).

Layout
------
Each raw shard gets sibling rollup stores::

    <dir>/shard-<i>/rollup-<res>/wal[.sst...]     (sharded stores)
    <wal>.rollup-<res>/wal[.sst...]               (single MemKVStore)

Every rollup store is a plain ``MemKVStore`` — WAL durability, crash
replay, sstable spill, and replica semantics are inherited, not
re-implemented. Rollup rows reuse the raw row-key SHAPE
(``[metric:3][base:4][tagk tagv]*``) with the base-time slot holding a
*superwindow* start (``resolution * pack`` seconds), so the sharded
store's series-hash routing and the scan regexps built for raw keys
apply unchanged; one row packs ``pack`` consecutive windows as cells
(qualifier = (window idx, kind)).

Consistency contract ("stale degrades, never lies")
---------------------------------------------------
A raw point is ALWAYS in at least one of: (a) the memtable/frozen tier
(its row key is in ``store.pending_keys``), (b) a window in the tier's
in-flight set (spilled but the fold hasn't committed), or (c) a rollup
record. The planner treats (a)+(b) windows as *dirty* and stitches
them from raw, so a summary is only ever served for windows whose
every point it covers. Records are REPLACED from a full re-read of the
window's raw rows (never incrementally merged on the write path), so
re-folds after WAL replay, duplicate ingest, out-of-order backfill,
and deletes are all idempotent.

Crash safety: ``ROLLUP.json`` flips to ``pending`` before each
checkpoint's spill and back to ``ok`` only after the fold commits; a
crash in between leaves ``pending`` and the next open schedules a
full rebuild (the catch-up daemon) while queries fall back to raw. A
missing/foreign-config tier rebuilds the same way.
"""

from __future__ import annotations

import functools
import json
import logging
import os
import re
import shutil
import threading
from typing import Iterable

import numpy as np

from opentsdb_tpu_torch.core import codec, codec_np
from opentsdb_tpu_torch.core.const import (MAX_TIMESPAN, TIMESTAMP_BYTES,
                                           UID_WIDTH)
from opentsdb_tpu_torch.core.errors import IllegalDataError
from opentsdb_tpu_torch.fault.faultpoints import fire as _fault
from opentsdb_tpu_torch.obs.registry import METRICS as _metrics
from opentsdb_tpu_torch.rollup import summary
from opentsdb_tpu_torch.rollup.summary import (QUAL_MOMENTS, QUAL_SKETCH,
                                               REC_DTYPE, REC_SIZE,
                                               ROLLUP_FAMILY)
from opentsdb_tpu_torch.storage.kv import MemKVStore

LOG = logging.getLogger(__name__)

STATE_NAME = "ROLLUP.json"

# Raw data family (core/tsdb.py FAMILY; duplicated to avoid importing
# the TSDB module from the tier it instantiates).
_RAW_FAMILY = b"t"

_FLUSH_CELLS = 1 << 16

# Checkpoint-fold and catch-up latency timers (obs/registry.py): one
# observation per fold / per completed rebuild, exported via /stats
# and /metrics.
_M_FOLD = _metrics.timer("rollup.fold")
_M_CATCHUP = _metrics.timer("rollup.catchup")

# Checkpoint-fold path split (rollup/delta.py): (metric, coarse
# window) groups served from ingest-time delta accumulators vs groups
# that took the full raw rescan.
_M_FOLD_DELTA = _metrics.counter("rollup.fold.delta")
_M_FOLD_FULL = _metrics.counter("rollup.fold.full")


class _TierClosed(Exception):
    """Internal: the catch-up rebuild was aborted by close()."""


def _u32(v: int) -> bytes:
    return int(v).to_bytes(4, "big")


def _metric_stop(metric_uid: bytes) -> bytes:
    """Smallest key after every row of this metric."""
    n = int.from_bytes(metric_uid, "big") + 1
    if n >= 1 << (8 * len(metric_uid)):
        return b"\xff" * (len(metric_uid) + TIMESTAMP_BYTES + 1)
    return n.to_bytes(len(metric_uid), "big")


def res_label(res: int) -> str:
    if res % 86400 == 0:
        return f"{res // 86400}d"
    if res % 3600 == 0:
        return f"{res // 3600}h"
    return f"{res}s"


class _MapBuffer:
    """Accumulates per-superrow window maps and flushes them as ONE
    map cell per (row, kind) via read-modify-write put_many batches.

    The RMW (merge with the stored map, new windows replacing same-idx
    entries) is safe because every writer — checkpoint folds and the
    catch-up rebuild — serializes on the tier's fold lock; a fold that
    touches a superrow across two of its own flushes reads its first
    flush back from the store's memtable."""

    def __init__(self, tier: "RollupTier",
                 track_emitted: bool = False) -> None:
        self.tier = tier
        # (res, shard) -> {row key -> (moment entries, sketch entries)}
        self.maps: dict[tuple[int, int], dict] = {}
        self.total = 0
        self.written = 0
        # Which window slots this buffer emitted a REAL record for,
        # surviving flushes (maps are cleared at _FLUSH_CELLS, so the
        # in-buffer state can't answer "did this fold cover that
        # window?"): (res, superrow key) -> bitmask of emitted window
        # idxs — a few bytes per superrow where a per-slot tuple set
        # cost ~64 bytes per RECORD (hundreds of MB on big folds).
        # Only folds track it — it gates _zero_leftovers, which the
        # full rebuild never runs.
        self.emitted: dict[tuple[int, bytes], int] | None = (
            {} if track_emitted else None)

    def entries(self, res: int, key: bytes) -> tuple[dict, dict]:
        si = self.tier._shard_of(key)
        rows = self.maps.get((res, si))
        if rows is None:
            rows = self.maps[(res, si)] = {}
        ent = rows.get(key)
        if ent is None:
            ent = rows[key] = ({}, {})
        return ent

    def count(self, n: int) -> None:
        self.total += n
        if self.total >= _FLUSH_CELLS:
            self.flush()

    def flush(self) -> None:
        table, fam = self.tier.table, ROLLUP_FAMILY
        for (res, si), rows in self.maps.items():
            store = self.tier.stores[res][si]
            cells = []
            for key, (moments, sketches) in rows.items():
                cur_m = cur_s = None
                # RMW only for PARTIAL maps (a map covering every
                # window of the superrow replaces outright), decided
                # per kind — moments can be complete while sketches
                # aren't.
                need_m = moments and len(moments) < self.tier.pack
                need_s = sketches and len(sketches) < self.tier.pack
                if need_m or need_s:
                    for c in store.get(table, key, fam):
                        if c.qualifier == QUAL_MOMENTS and need_m:
                            cur_m = c.value
                        elif c.qualifier == QUAL_SKETCH and need_s:
                            cur_s = c.value
                if moments:
                    blob = (summary.merge_moment_map(cur_m, moments)
                            if cur_m else
                            summary.pack_moment_map(moments))
                    cells.append((key, QUAL_MOMENTS, blob))
                    self.written += len(moments)
                if sketches:
                    blob = (summary.merge_sketch_map(cur_s, sketches)
                            if cur_s else
                            summary.pack_sketch_map(sketches))
                    cells.append((key, QUAL_SKETCH, blob))
            if cells:
                store.put_many(table, fam, cells)
        # Partial fold state: some (res, shard) flushes durable, the
        # rest still buffered. A crash here leaves summary rows the
        # pending bracket owes a rebuild for — the exact
        # half-materialized shape a torn bracket leaves.
        _fault("rollup.fold.flush")
        self.maps = {}
        self.total = 0


class RollupTier:
    def __init__(self, tsdb, config) -> None:
        self._init_layout(tsdb, config)
        if bool(getattr(config, "rollup_delta_fold", True)):
            from opentsdb_tpu_torch.rollup.delta import DeltaFolds
            self.delta = DeltaFolds(
                coarse=self.resolutions[-1],
                cap_points=int(getattr(config, "rollup_delta_points",
                                       1 << 22)))
        store = tsdb.store
        st = self._read_state()
        rebuild = self._needs_rebuild(st)
        if rebuild == "full":
            # A FULL rebuild starts from empty stores; the incremental
            # path keeps them — its windows' records are replaced from
            # raw and everything else is still valid.
            for dirs in self._dirs.values():
                for d in dirs:
                    shutil.rmtree(d, ignore_errors=True)
        try:
            for r in self.resolutions:
                self.stores[r] = []
                for d in self._dirs[r]:
                    s = MemKVStore(wal_path=os.path.join(d, "wal"))
                    # Tier spills ride the same codec knob as the raw
                    # store: under "tsst4" the summary superrows land
                    # in self-describing ROLLSUM blocks (columnar
                    # entry bytes — the block-direct read fast path in
                    # scan_records serves off them without inflating
                    # whole rows).
                    s.sstable_codec = getattr(config, "sstable_codec",
                                              "none")
                    s.ensure_table(self.table)
                    self.stores[r].append(s)
        except BaseException:
            self.close()
            raise
        store.record_spill_keys = True
        if self.delta is not None and hasattr(store, "delete_hook"):
            store.delete_hook = self._delta_delete_hook
        if rebuild != "none":
            windows = (self._incr_windows if rebuild == "incr"
                       else None)
            self._behind = True
            self._full_owed = windows is None
            # Keep the inflight set durable through an INCREMENTAL
            # catch-up: a crash mid-catch-up must redo the same
            # (idempotent) incremental work. A full rebuild persists
            # a bare pending record — no list, no shortcut.
            self._write_state(pending=True, inflight=windows)
            if windows is not None:
                self._inflight = frozenset(windows)
            mode = getattr(config, "rollup_catchup", "background")
            if mode == "sync":
                self._rebuilding = True
                self._rebuild(windows=windows)
            elif mode == "background":
                self._rebuilding = True
                self._rebuild_thread = threading.Thread(
                    target=self._rebuild, daemon=True,
                    name="rollup-catchup",
                    kwargs={"windows": windows})
                self._rebuild_thread.start()
            # "off": stays pending/not-ready; planner serves raw.
        else:
            self._write_state(pending=False)
            self._ready = True

    def _init_layout(self, tsdb, config) -> None:
        """Everything shared between the writer tier and the read-only
        replica tier: config validation, per-shard directory layout,
        state-file path, counters, and the planner-facing flags.
        Leaves ``self.stores`` EMPTY — each subclass opens them with
        its own store mode (writable vs read-only replica)."""
        self.tsdb = tsdb
        self.table = config.table
        res = tuple(sorted(int(r) for r in config.rollup_resolutions))
        if not res:
            raise ValueError("rollup_resolutions must not be empty")
        for i, r in enumerate(res):
            if r % MAX_TIMESPAN != 0:
                raise ValueError(
                    f"rollup resolution {r} is not a multiple of the "
                    f"row span ({MAX_TIMESPAN}s)")
            if i and res[i] % res[i - 1] != 0:
                raise ValueError(
                    f"rollup resolutions must nest (each divides the "
                    f"next): {res}")
        self.resolutions = res
        self.pack = int(config.rollup_pack)
        if not 1 <= self.pack <= 0xFFFF:
            raise ValueError(f"rollup_pack out of range: {self.pack}")
        self.digest_k = int(config.rollup_digest_k)
        self.hll_p = int(config.rollup_hll_p)
        self.sketch_min_res = int(config.rollup_sketch_min_res)
        self.moment_k = int(getattr(config, "rollup_moment_k", 0))
        self.moment_min_res = int(getattr(config,
                                          "rollup_moment_min_res", 0))
        self.sketch_byte_budget = int(getattr(config,
                                              "sketch_byte_budget", 0))

        # Checkpoint fold backend. Default is the host NumPy f64
        # pairwise fold (bit-exact across chunkings); Config.
        # rollup_device_fold moves the scatter fold on-device — f64
        # accumulation where the backend keeps it, else an EXPLICITLY
        # relaxed f32 contract. The applied kind is declared in the
        # state file: records folded under different kinds mix
        # accumulation orders inside the same stored rows, so a kind
        # change rebuilds like any layout change (but a legacy state
        # file with no "fold" key means host-f64 — see _needs_rebuild).
        if bool(getattr(config, "rollup_device_fold", False)):
            self.fold_kind = summary.device_fold_kind()
            self._fold_fn = functools.partial(
                summary.window_summaries_device, device=tsdb.device)
        else:
            self.fold_kind = "host-f64"
            self._fold_fn = summary.window_summaries

        store = tsdb.store
        self._sharded = hasattr(store, "shards") and hasattr(store, "_route")
        base_dirs: list[str]
        if self._sharded:
            root = store._dir
            base_dirs = [os.path.join(root, f"shard-{i}")
                         for i in range(store.shard_count)]
            self.state_path = os.path.join(root, STATE_NAME)
        else:
            wal = store._wal_path
            base_dirs = [wal]  # suffixed below, not a directory itself
            self.state_path = wal + ".rollup.json"
        self.shard_count = len(base_dirs)

        # Counters (exported via collect_stats; best-effort, unlocked).
        self.hits: dict[int, int] = {r: 0 for r in res}
        self.misses = 0
        self.fallbacks: dict[str, int] = {}
        self.folds = 0
        self.records_written = 0
        self.rebuilds = 0
        # Fold-path split counters and the delta accumulators
        # themselves; the writer tier attaches DeltaFolds in its
        # __init__ (the read-only replica never folds).
        self.fold_delta = 0
        self.fold_full = 0
        self.delta = None

        self._ready = False
        # True while a full catch-up is owed (crash/foreign state):
        # per-checkpoint folds must not flip the tier ready — only a
        # completed rebuild covers the pre-existing spilled history.
        self._behind = False
        # True while the owed catch-up must be the FULL rebuild
        # (foreign layout, never-built tier, crash mid-full-rebuild).
        # While set, the persisted state must NOT carry an "inflight"
        # list: an incremental catch-up over a half-built tier would
        # silently serve the never-folded remainder stale.
        self._full_owed = False
        self._rebuilding = False
        self._rebuild_error: BaseException | None = None
        self._rebuild_thread: threading.Thread | None = None
        # close() sets this and joins the catch-up thread: letting the
        # thread race the closing stores would discard the whole
        # rebuild into _rebuild_error (hours of work at scale) and
        # possibly trip mid-write fd races inside MemKVStore.close.
        self._stop = threading.Event()
        self._fold_lock = threading.Lock()
        self._defer_lock = threading.Lock()
        self._deferred: list[bytes] = []
        self._inflight: frozenset[int] = frozenset()
        # Debug oracle (Config.rollup_sweep_check): derive the dirty
        # set BOTH ways and fail loudly on divergence. Only meaningful
        # at quiescent instants — the two derivations are separate
        # lock acquisitions, so concurrent ingest between them is a
        # benign difference, and tests quiesce before comparing.
        self.sweep_check = bool(getattr(config, "rollup_sweep_check",
                                        False))

        self._dirs: dict[int, list[str]] = {}
        for r in res:
            if self._sharded:
                self._dirs[r] = [os.path.join(d, f"rollup-{r}")
                                 for d in base_dirs]
            else:
                self._dirs[r] = [f"{base_dirs[0]}.rollup-{r}"]
        self.stores: dict[int, list[MemKVStore]] = {}

        # Per-resolution sketch-column allocation: {res: (digest_k,
        # moment_k, hll_p)}. With Config.sketch_byte_budget set, a
        # Storyboard-style optimizer (sketch/budget.py) spends the
        # budget across resolutions; otherwise the uniform cutoffs apply
        # (digest at res >= sketch_min_res, moment at res >=
        # moment_min_res). Participates in the state file, so a layout
        # change rebuilds.
        self.sketch_alloc = self._compute_alloc()
        # Cumulative sketch-column bytes written per (resolution,
        # kind) — process lifetime; /stats `sketch.bytes{kind=}` sums
        # across resolutions, the bench reads the per-res split (the
        # moment-vs-digest size story differs by window density).
        self.sketch_bytes_res: dict[int, dict[str, int]] = {}

    @property
    def sketch_bytes(self) -> dict[str, int]:
        out = {"tdigest": 0, "moment": 0, "hll": 0}
        for kinds in self.sketch_bytes_res.values():
            for k, v in kinds.items():
                out[k] = out.get(k, 0) + v
        return out

    def _compute_alloc(self) -> dict[int, tuple[int, int, int]]:
        if self.sketch_byte_budget > 0:
            from opentsdb_tpu_torch.sketch import budget as _budget
            rows = self._estimate_row_hours()
            records = {r: max(rows // max(r // MAX_TIMESPAN, 1), 1)
                       for r in self.resolutions}
            allocs = _budget.allocate(self.sketch_byte_budget, records,
                                      hll_p=self.hll_p)
            return {r: (a.digest_k, a.moment_k,
                        a.hll_p if a.digest_k else 0)
                    for r, a in allocs.items()}
        out = {}
        for r in self.resolutions:
            dk = self.digest_k if r >= self.sketch_min_res else 0
            mk = self.moment_k if r >= self.moment_min_res else 0
            # HLL registers ride the digest rungs only: a moment-only
            # resolution keeps its ~200 B cells (the kind's whole
            # point); /distinct falls back to presence/exact there.
            out[r] = (dk, mk, self.hll_p if dk else 0)
        return out

    def _estimate_row_hours(self) -> int:
        """Rough raw row-hour count (the budget allocator's record-
        density input): memtable pending keys + sstable index sizes.
        The allocator quantizes, so order of magnitude is enough."""
        store = self.tsdb.store
        n = 0
        try:
            n += len(list(store.pending_keys(self.table)))
        except Exception:
            pass
        shards = getattr(store, "shards", None)
        subs = shards if isinstance(shards, list) else [store]
        for s in subs:
            for sst in getattr(s, "_ssts", []) or []:
                try:
                    n += sst.key_count(self.table)
                except Exception:
                    pass
        return max(n, 1)

    # -- state file --------------------------------------------------------

    STATE_VERSION = 3

    def _config_dict(self) -> dict:
        return {"version": self.STATE_VERSION,
                "resolutions": list(self.resolutions),
                "pack": self.pack, "digest_k": self.digest_k,
                "hll_p": self.hll_p,
                "sketch_min_res": self.sketch_min_res,
                "moment_k": self.moment_k,
                "moment_min_res": self.moment_min_res,
                "budget": self.sketch_byte_budget,
                # The APPLIED per-res allocation, not just the knobs:
                # a budget re-plan (operator re-budgeted) changes the
                # stored columns and must rebuild like any layout
                # change. Same-budget reopens ADOPT the persisted
                # allocation (_needs_rebuild) so record-count drift
                # around a quantization edge can't flap the layout.
                "alloc": {str(r): list(self.sketch_alloc[r])
                          for r in self.resolutions},
                # Declared numeric contract of the records: which fold
                # backend accumulated them. Compared with a host-f64
                # default so pre-existing state files (no key) stay
                # adopted — see _needs_rebuild / _adopt_state.
                "fold": self.fold_kind}

    @classmethod
    def adopt_config(cls, state_path: str, config) -> bool:
        """Copy an existing tier's layout (ROLLUP.json, the inverse of
        _config_dict) onto ``config`` — the CLI's tier auto-adopt, kept
        HERE so the state-file schema has one owner. Returns False
        (config untouched) for an unreadable, foreign-version, or
        malformed file; the tier then opens on Config defaults and the
        config-mismatch check schedules a rebuild."""
        try:
            with open(state_path) as f:
                rec = json.load(f)
            if rec.get("version") != cls.STATE_VERSION:
                return False
            resolutions = tuple(int(r) for r in rec["resolutions"])
            pack = int(rec["pack"])
            digest_k = int(rec["digest_k"])
            hll_p = int(rec["hll_p"])
            sketch_min_res = int(rec["sketch_min_res"])
            moment_k = int(rec["moment_k"])
            moment_min_res = int(rec["moment_min_res"])
        except (OSError, ValueError, TypeError, KeyError):
            return False
        config.rollup_resolutions = resolutions
        config.rollup_pack = pack
        config.rollup_digest_k = digest_k
        config.rollup_hll_p = hll_p
        config.rollup_sketch_min_res = sketch_min_res
        config.rollup_moment_k = moment_k
        config.rollup_moment_min_res = moment_min_res
        return True

    def _read_state(self) -> dict | None:
        try:
            with open(self.state_path) as f:
                return json.load(f)
        except (OSError, ValueError):
            return None

    def _write_state(self, pending: bool,
                     inflight: "frozenset[int] | list | None" = None,
                     ) -> None:
        """``inflight``: the hour bases whose spilled rows may be
        drained-but-unfolded — persisted alongside ``pending`` so a
        crash can catch up INCREMENTALLY (refold only these windows)
        instead of rebuilding the whole tier. Invariant maintained by
        begin_spill/fold_after_spill: at any instant the persisted set
        is a superset of every window whose raw rows left
        pending_keys without a durable fold."""
        rec = self._config_dict()
        rec["pending"] = pending
        if pending and inflight is not None:
            rec["inflight"] = sorted(int(b) for b in inflight)
        tmp = self.state_path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(rec, f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, self.state_path)

    def _needs_rebuild(self, st: dict | None) -> str:
        """"none" (tier is complete), "full" (wipe + rebuild), or
        "incr" (pending crash with a usable persisted inflight set —
        refold only those windows; self._incr_windows is set)."""
        self._incr_windows: list[int] | None = None
        if st is None:
            # No state: a store that already spilled data has raw
            # history no fold will ever cover; a fresh store starts
            # complete (its whole history is memtable-dirty).
            return ("full" if getattr(self.tsdb.store, "spilled",
                                      False) else "none")
        cfg = self._config_dict()
        # Same-budget reopen: adopt the persisted allocation before
        # comparing, so a record-count estimate that drifted across a
        # quantization edge can't force a rebuild the operator never
        # asked for (the budget knob itself still does).
        alloc = st.get("alloc")
        if (self.sketch_byte_budget > 0 and isinstance(alloc, dict)
                and st.get("budget") == self.sketch_byte_budget):
            try:
                adopted = {int(r): tuple(int(x) for x in v)
                           for r, v in alloc.items()}
            except (TypeError, ValueError):
                adopted = None
            if adopted is not None and set(adopted) == set(
                    self.resolutions):
                self.sketch_alloc = adopted
                cfg = self._config_dict()
        # "fold" compares against a host-f64 default: legacy state
        # files predate the key and their records ARE host-f64 folds.
        config_ok = (all(st.get(k) == v for k, v in cfg.items()
                         if k not in ("pending", "fold"))
                     and st.get("fold", "host-f64") == self.fold_kind)
        if st.get("pending", True):
            wins = st.get("inflight")
            if (config_ok and isinstance(wins, list)
                    and getattr(self.tsdb.config,
                                "rollup_incremental_catchup", True)):
                self._incr_windows = [int(b) for b in wins]
                return "incr"
            return "full"
        return "none" if config_ok else "full"

    # -- planner surface ---------------------------------------------------

    @property
    def ready(self) -> bool:
        return self._ready

    def wait_ready(self, timeout: float | None = None) -> bool:
        t = self._rebuild_thread
        if t is not None:
            t.join(timeout)
        if self._rebuild_error is not None:
            raise RuntimeError("rollup catch-up failed") \
                from self._rebuild_error
        return self._ready

    def pick_resolution(self, interval: int) -> int | None:
        """Coarsest resolution whose windows nest exactly into the
        downsample buckets."""
        best = None
        for r in self.resolutions:
            if r <= interval and interval % r == 0:
                best = r
        return best

    def sketch_candidates(self, span: int,
                          want_hll: bool = False) -> list[int]:
        """Sketch-bearing resolutions not wider than the range,
        COARSEST FIRST — the planner's candidate order for the ranged
        sketch endpoints (a range wide enough for a resolution may
        still hold no aligned full window of it, so selection falls
        through to the next). ``want_hll`` keeps only resolutions
        whose allocation carries HLL registers (distinct-VALUES
        estimates; moment-only rungs have none and must not serve
        them)."""
        out = []
        for r in reversed(self.resolutions):
            dk, mk, hp = self.sketch_alloc.get(r, (0, 0, 0))
            if r > span or not (dk or mk):
                continue
            if want_hll and not hp:
                continue
            out.append(r)
        return out

    def sketch_res_for_interval(self, interval: int) -> int | None:
        """Coarsest sketch-bearing resolution whose windows nest
        exactly into ``interval`` buckets — the approximate
        percentile-downsample planner's resolution pick (per-bucket
        sketches merge from whole windows only)."""
        best = None
        for r in self.resolutions:
            dk, mk, _ = self.sketch_alloc.get(r, (0, 0, 0))
            if (dk or mk) and r <= interval and interval % r == 0:
                best = r
        return best

    def note_hit(self, res: int) -> None:
        self.hits[res] = self.hits.get(res, 0) + 1

    def note_fallback(self, reason: str) -> None:
        self.fallbacks[reason] = self.fallbacks.get(reason, 0) + 1

    def note_miss(self) -> None:
        self.misses += 1

    def dirty_hour_bases(self) -> np.ndarray:
        """Sorted hour bases whose raw rows are not (yet) covered by
        rollup records: memtable + frozen rows + the undrained spill
        record, plus windows in flight between a spill and its fold
        commit. Served from the store's incrementally-maintained
        dirty-base index (MemKVStore.dirty_bases, O(1) amortized per
        mutation) — the old implementation re-swept the ENTIRE
        memtable key list under the store lock on every
        rollup-eligible query, so planning cost scaled with memtable
        size under live ingest (the ROADMAP follow-on this closes).
        ``rollup_sweep_check`` keeps the sweep as a cross-check
        oracle."""
        store = self.tsdb.store
        db = getattr(store, "dirty_bases", None)
        if db is None:
            base = self._sweep_dirty_bases()
        else:
            base = db(self.table)
            if self.sweep_check:
                swept = self._sweep_dirty_bases()
                if not np.array_equal(base, swept):
                    raise AssertionError(
                        f"incremental dirty set diverged from the "
                        f"sweep oracle: "
                        f"incremental={base.tolist()} "
                        f"swept={swept.tolist()}")
        infl = self._inflight
        if infl:
            base = np.union1d(
                base, np.fromiter(infl, np.int64, len(infl)))
        return base

    def _sweep_dirty_bases(self) -> np.ndarray:
        """The legacy O(memtable) derivation: sweep every pending key
        and collect base times. Kept as the sweep_check oracle (and
        the fallback for stores without the incremental index).
        Malformed/short keys (a stray delete_row from a tool) carry no
        base time to mark dirty — skip them like the fold paths do."""
        lo, hi = UID_WIDTH, UID_WIDTH + TIMESTAMP_BYTES
        keys = [k for k in self.tsdb.store.pending_keys(self.table)
                if len(k) >= hi]
        if not keys:
            return np.empty(0, np.int64)
        blob = b"".join(k[lo:hi] for k in keys)
        return np.unique(np.frombuffer(blob, ">u4").astype(np.int64))

    def scan_records(self, res: int, metric_uid: bytes, w_lo: int,
                     w_hi: int, key_regexp: bytes | None = None,
                     want_sketches: bool = False) -> dict:
        """All rollup records of ``metric`` with window base in
        [w_lo, w_hi], keyed by series. Returns
        ``{series_key: (bases int64[W], records REC_DTYPE[W],
        sketches [(base, blob)])}`` with zero-count (deleted) records
        dropped. Shards are scanned independently — a series' rows all
        live in one shard, so per-series ordering needs no merge."""
        span = res * self.pack
        start_key = metric_uid + _u32(w_lo - w_lo % span)
        stop_hi = w_hi - w_hi % span + span
        stop_key = (_metric_stop(metric_uid) if stop_hi > 0xFFFFFFFF
                    else metric_uid + _u32(stop_hi))
        # One map cell per (row, kind): a whole superrow of window
        # records decodes with a single frombuffer — the per-window
        # cell layout this replaced made reads sstable-unpack-bound.
        acc: dict[bytes, tuple[list, list, list]] = {}
        for s in self.stores[res]:
            rows = self._block_rows(s, start_key, stop_key, key_regexp)
            if rows is None:
                rows = s.scan_raw(self.table, start_key, stop_key,
                                  family=ROLLUP_FAMILY,
                                  key_regexp=key_regexp)
            for key, items in rows:
                sb = codec.key_base_time(key)
                skey = codec.series_key(key)
                ent = acc.get(skey)
                if ent is None:
                    ent = acc[skey] = ([], [], [])
                for q, v in items:
                    if q == QUAL_MOMENTS:
                        if len(v) % summary.ENTRY_SIZE:
                            continue  # foreign/corrupt: skip
                        e = summary.decode_moment_map(v)
                        wb = sb + e["idx"].astype(np.int64) * res
                        keep = (wb >= w_lo) & (wb <= w_hi)
                        if keep.any():
                            ent[0].append(wb[keep])
                            ent[1].append(e["rec"][keep])
                    elif q == QUAL_SKETCH and want_sketches:
                        for idx, blob in summary.decode_sketch_map(v):
                            wb1 = sb + idx * res
                            if w_lo <= wb1 <= w_hi:
                                ent[2].append((wb1, blob))
        out: dict[bytes, tuple] = {}
        for skey, (bases, recs, sk) in acc.items():
            if not bases and not sk:
                continue
            if bases:
                base_arr = np.concatenate(bases)
                rec = (np.concatenate(recs) if len(recs) > 1
                       else np.asarray(recs[0]))
                live = rec["count"] > 0
                if not live.all():
                    base_arr, rec = base_arr[live], rec[live]
            else:
                base_arr = np.empty(0, np.int64)
                rec = np.empty(0, REC_DTYPE)
            if len(base_arr) or sk:
                out[skey] = (base_arr, rec, sk)
        return out

    def _block_rows(self, s, start_key: bytes, stop_key: bytes,
                    key_regexp: bytes | None):
        """Block-direct read of one tier store's ROLLSUM blocks:
        [(key, [(qual, cell_bytes)])] sorted by key, or None when the
        store must fall back to scan_raw (memtable-resident rows in
        range, a non-ROLLSUM covering block, or duplicate keys across
        generations needing newest-wins overlay).

        Serving is byte-for-byte identical to the row scan: the cell
        bytes come straight off the block's columnar entry matrix —
        the very bytes the row framing would carry — so the moment/
        sketch decode downstream sees the same input. What this skips
        is the whole-row zlib inflate + v3 re-framing + per-row cell
        parse of the generic path (one transposed inflate per block,
        parsed once and cached on the immutable sstable object)."""
        er = getattr(s, "encoded_range", None)
        if er is None:
            return None
        try:
            # Memtable/frozen rows in range overlay the blocks —
            # that's scan_raw's job.
            for k in s.pending_keys(self.table):
                if start_key <= k < stop_key:
                    return None
            spans = er(self.table, start_key, stop_key)
        except Exception:
            return None
        if spans is None:
            return None
        if not spans:
            return []
        if len(spans) > 1:
            allk = [k for sst, lo, hi in spans
                    for k in sst._index[self.table][0][lo:hi]]
            if len(set(allk)) != len(allk):
                return None   # re-folded superrow: newest-wins overlay
        pattern = re.compile(key_regexp, re.S) if key_regexp else None
        out = []
        for sst, lo, hi in spans:
            keys, offs = sst._index[self.table]
            blk_ids = np.unique(
                np.searchsorted(sst._blk_raw,
                                np.asarray(offs[lo:hi], np.int64),
                                "right") - 1)
            for j in blk_ids.tolist():
                rb = self._rollsum_block(sst, j)
                if rb is None or rb.fam != ROLLUP_FAMILY[0] \
                        or rb.table != self.table.encode():
                    return None
                for i in range(rb.n):
                    key = rb.K[i, :rb.klen[i]].tobytes()
                    if not start_key <= key < stop_key:
                        continue
                    if pattern is not None and not pattern.match(key):
                        continue
                    fe = int(rb.first_ent[i])
                    items = [(QUAL_MOMENTS,
                              rb.ent_bytes[fe:fe + rb.nm[i]].tobytes())]
                    if rb.has_sketch[i]:
                        o = int(rb.sk_off[i])
                        items.append(
                            (QUAL_SKETCH,
                             rb.sk_blob[o:o + int(rb.sk_len[i])]))
                    out.append((key, items))
        # Generations may interleave key ranges; the row scan yields a
        # global key-ordered merge, so match it (keys are unique here).
        out.sort(key=lambda kv: kv[0])
        return out

    @staticmethod
    def _rollsum_block(sst, j: int):
        """Parsed ROLLSUM block ``j``, cached on the sstable; None for
        any other tag (caller falls back). The parse holds no views of
        the file mmap (all arrays are freshly inflated), so caching
        cannot pin a closed map."""
        from opentsdb_tpu_torch.compress import codecs as _codecs
        cache = sst.__dict__.setdefault("_rollsum_cache", {})
        if j in cache:
            return cache[j]
        rb = None
        try:
            tag, _raw_len, _enc_len = sst.block_header(j)
            if tag == _codecs.ROLLSUM:
                rb = _codecs.parse_rollsum_block(sst.block_enc(j))
        except Exception:
            rb = None
        cache[j] = rb
        return rb

    # -- checkpoint integration (called by TSDB.checkpoint) ---------------

    def begin_spill(self) -> None:
        """Before the raw spill: remember every currently-dirty window
        as in-flight (the spill moves its rows out of pending_keys, the
        fold hasn't covered them yet) and mark the tier pending on
        disk — WITH the in-flight window list, so a crash catches up
        incrementally (refold just those windows) instead of
        rebuilding the whole tier."""
        bases = self.dirty_hour_bases()
        self._inflight = self._inflight | frozenset(
            int(b) for b in bases)
        if self._full_owed:
            return  # state is already pending (bare: full owed)
        # During an incremental catch-up the state is already pending,
        # but the inflight list must still grow: a checkpoint's
        # spilled keys get deferred to the catch-up thread, and a
        # crash before that fold lands must know these windows are
        # owed too.
        self._write_state(pending=True, inflight=self._inflight)
        if self._rebuilding or self._behind:
            return
        # Bracket opened (pending durable), raw spill not started:
        # crash must catch up at next open even though no data moved.
        _fault("rollup.begin_spill", self.state_path)

    def fold_after_spill(self) -> None:
        """After the raw spill: fold the spilled keys into summary
        records, commit, and clear the in-flight set. During a rebuild
        the keys are deferred — the catch-up pass drains them."""
        store = self.tsdb.store
        # Rows ingested between begin_spill's dirty snapshot and the
        # store's memtable freeze were spilled WITHOUT being in the
        # pre-spill in-flight set. Mark their windows in flight from a
        # non-draining PEEK, while their keys still read as pending
        # (pending_keys includes the undrained spill record), so no
        # instant exists where a spilled-but-unfolded window is in
        # neither set; only then drain.
        peek = getattr(store, "peek_spill_keys", None)
        if peek is not None:
            extra = frozenset(
                int(codec.key_base_time(k))
                for k in peek().get(self.table, ())
                if len(k) >= UID_WIDTH + TIMESTAMP_BYTES)
            if not extra <= self._inflight:
                self._inflight = self._inflight | extra
                # Persist BEFORE draining: once take_spill_keys runs,
                # these keys exist only in this process's memory — a
                # crash must find their windows in the durable
                # inflight set or the incremental catch-up would
                # silently skip them (stale summaries). While a full
                # rebuild is owed the bare pending record stands.
                if not self._full_owed:
                    self._write_state(pending=True,
                                      inflight=self._inflight)
        keys = store.take_spill_keys().get(self.table, [])
        with self._defer_lock:
            if self._rebuilding:
                self._deferred.extend(keys)
                return
            if self._behind:
                # Full catch-up owed but not running (rollup_catchup
                # "off" / crashed): its eventual full scan covers these
                # keys; folding now could flip state to ok early.
                return
        try:
            # Spill record drained, fold not yet run: the spilled keys
            # exist ONLY in this process's memory — crash loses them
            # and the pending bracket must force a full rebuild (the
            # torn-bracket class).
            _fault("rollup.fold.start", self.state_path)
            with _M_FOLD.time():
                self._fold(keys)
        except IllegalDataError as e:
            # Corrupt raw data (the fsck signal): leave the tier
            # not-ready (state stays pending) so the planner serves
            # raw; never wedge the checkpoint itself. The drained keys
            # are lost, so mark a full rebuild owed (_behind): without
            # it the NEXT clean fold would clear _inflight, write
            # pending=false, and flip ready while THESE windows were
            # never folded — stale summaries served, and pending=false
            # on disk means a restart would skip the rebuild too. The
            # rebuild runs at the next open (state is still pending);
            # it aborts on the same corrupt rows until fsck --fix, and
            # queries serve raw throughout.
            LOG.warning("rollup fold skipped (corrupt data): %s", e)
            with self._defer_lock:
                self._behind = True
            self._ready = False
            self.note_fallback("corrupt")
            return
        # Fold durable in the rollup WALs, bracket still pending:
        # crash re-folds idempotently after the rebuild.
        _fault("rollup.fold.commit", self.state_path)
        for stores in self.stores.values():
            for s in stores:
                # Bound the rollup WALs (no tenant marker: a tier
                # store keeps no tenant snapshot).
                s.checkpoint(tenant_marker=False)
        self._write_state(pending=False)
        self._inflight = frozenset()
        self._ready = True
        # Bracket flipped ok: a crash from here on must NOT rebuild —
        # the tier is complete and the next open serves it as-is.
        _fault("rollup.bracket.flip", self.state_path)
        self.folds += 1

    # -- fold core ---------------------------------------------------------

    def _shard_of(self, key: bytes) -> int:
        if self._sharded:
            return self.tsdb.store._route(self.table, key)
        return 0

    def _fold(self, keys: list[bytes]) -> None:
        """Recompute every rollup record whose window holds one of the
        spilled ``keys`` (replace-from-raw; module docstring). Keys
        whose rows vanished (row tombstones / deletes) get zero
        records so stale summaries cannot outlive their points."""
        if not keys:
            return
        with self._fold_lock:
            coarse = self.resolutions[-1]
            groups: dict[tuple[bytes, int], list[bytes]] = {}
            must: set[bytes] = set()
            for k in keys:
                if len(k) < UID_WIDTH + TIMESTAMP_BYTES:
                    continue
                kb = bytes(k)
                must.add(kb)
                hb = codec.key_base_time(k)
                groups.setdefault(
                    (kb[:UID_WIDTH], hb - hb % coarse), []).append(kb)
            buf = _MapBuffer(self, track_emitted=True)
            seen: set[bytes] = set()
            # Delta fast path (rollup/delta.py): a (metric, coarse
            # window) group whose every spilled series-window is
            # completely buffered emits straight from memory; the rest
            # take the replace-from-raw rescan below. Both paths write
            # through the same buffer under this lock, so the final
            # record bytes are independent of the split.
            per_metric: dict[bytes, set[int]] = {}
            for (muid, cb), ks in groups.items():
                if self.delta is not None and self.delta.serve(
                        self, cb, ks, buf, seen):
                    self.fold_delta += 1
                    _M_FOLD_DELTA.inc()
                    continue
                per_metric.setdefault(muid, set()).add(cb)
                self.fold_full += 1
                _M_FOLD_FULL.inc()
            # Bound one scan chunk to ~4 days of coarse windows.
            chunk = max(1, (4 * 86400) // coarse)
            for metric_uid, cbases in per_metric.items():
                bases = sorted(cbases)
                i = 0
                while i < len(bases):
                    j = i
                    while (j + 1 < len(bases) and j - i + 1 < chunk
                           and bases[j + 1] == bases[j] + coarse):
                        j += 1
                    self._rollup_span(metric_uid, bases[i],
                                      bases[j] + coarse, buf, seen)
                    i = j + 1
            self._zero_leftovers(must - seen, buf)
            buf.flush()
            self.records_written += buf.written

    def _zero_leftovers(self, leftovers: Iterable[bytes],
                        buf: _MapBuffer) -> None:
        """Write count-0 records for spilled rows that no longer hold
        points (deleted): the planner skips them, replacing whatever
        stale summary the window had. Only slots the fold's rescan
        emitted NOTHING for are zeroed — a coarse window (say 1d) of a
        deleted hourly row usually still holds the series' surviving
        hours, and its record was just recomputed from them; zeroing it
        too would drop the whole day from rollup serving while raw
        scans keep returning the survivors ("stale degrades, never
        lies")."""
        zero = np.zeros(1, REC_DTYPE).tobytes()
        empty_sketch = summary.sketch_encode(
            np.empty(0, np.float32), np.empty(0, np.float32), None)
        emitted = buf.emitted
        assert emitted is not None, "_zero_leftovers needs a tracking buffer"
        for k in leftovers:
            skey = codec.series_key(k)
            hb = codec.key_base_time(k)
            for r in self.resolutions:
                wb = hb - hb % r
                span = r * self.pack
                sb = wb - wb % span
                key = skey[:UID_WIDTH] + _u32(sb) + skey[UID_WIDTH:]
                idx = (wb - sb) // r
                if emitted.get((r, key), 0) >> idx & 1:
                    continue
                moments, sketches = buf.entries(r, key)
                moments[idx] = zero
                if self._sketchy(r):
                    sketches[idx] = empty_sketch
                buf.count(1)

    def _sketchy(self, res: int) -> bool:
        dk, mk, _ = self.sketch_alloc.get(res, (0, 0, 0))
        return bool(dk or mk)

    def sketch_kinds(self, res: int) -> tuple[int, int, int]:
        """(digest_k, moment_k, hll_p) the tier stores at ``res``."""
        return self.sketch_alloc.get(res, (0, 0, 0))

    def _zero_unemitted(self, hours, buf: _MapBuffer) -> None:
        """Incremental catch-up's delete pass: zero every previously-
        recorded slot in the affected windows that the rescan emitted
        nothing for (its raw rows are gone — deletes whose spilled
        keys the crash lost). The full rebuild needs no analog: it
        starts from wiped stores."""
        zero = np.zeros(1, REC_DTYPE).tobytes()
        emitted = buf.emitted
        assert emitted is not None, \
            "_zero_unemitted needs a tracking buffer"
        names = self.tsdb.metrics.suggest("", limit=1 << 30)
        uids = [self.tsdb.metrics.get_id(n) for n in names]
        for r in self.resolutions:
            wins = {int(h) - int(h) % r for h in hours}
            if not wins:
                continue
            span = r * self.pack
            ranges: list[list[int]] = []
            for sb in sorted({w - w % span for w in wins}):
                if ranges and sb == ranges[-1][1]:
                    ranges[-1][1] = sb + span
                else:
                    ranges.append([sb, sb + span])
            empty_sketch = (summary.sketch_encode(
                np.empty(0, np.float32), np.empty(0, np.float32),
                None) if self._sketchy(r) else None)
            for uid in uids:
                for lo, hi in ranges:
                    start_key = uid + _u32(max(lo, 0))
                    stop_key = (_metric_stop(uid) if hi > 0xFFFFFFFF
                                else uid + _u32(hi))
                    for s in self.stores[r]:
                        for key, items in s.scan_raw(
                                self.table, start_key, stop_key,
                                family=ROLLUP_FAMILY):
                            sb = codec.key_base_time(key)
                            kb = bytes(key)
                            mask = emitted.get((r, kb), 0)
                            for q, v in items:
                                if (q != QUAL_MOMENTS
                                        or len(v) % summary.ENTRY_SIZE):
                                    continue
                                e = summary.decode_moment_map(v)
                                for idx in e["idx"].tolist():
                                    wb = sb + int(idx) * r
                                    if (wb not in wins
                                            or mask >> int(idx) & 1):
                                        continue
                                    ent = buf.entries(r, kb)
                                    ent[0][int(idx)] = zero
                                    if empty_sketch is not None:
                                        ent[1][int(idx)] = empty_sketch
                                    buf.count(1)

    def _rollup_span(self, metric_uid: bytes, lo: int, hi: int,
                     buf: _MapBuffer, seen: set | None = None,
                     stoppable: bool = False) -> None:
        """Recompute records for every raw point of ``metric`` with row
        base in [lo, hi) — streamed one coarsest window at a time (raw
        keys are base-major within a metric, so a coarse window's rows
        are contiguous in the scan). ``stoppable`` (the rebuild path)
        aborts at coarse-window boundaries once close() set _stop;
        checkpoint folds never abort — their caller owns shutdown
        ordering and an aborted fold would drop spilled keys."""
        coarse = self.resolutions[-1]
        start_key = metric_uid + _u32(max(lo, 0))
        stop_key = (_metric_stop(metric_uid) if hi > 0xFFFFFFFF
                    else metric_uid + _u32(hi))
        rows: list[tuple[bytes, list]] = []
        cur = None
        for key, items in self.tsdb.store.scan_raw(
                self.table, start_key, stop_key, family=_RAW_FAMILY):
            cb = codec.key_base_time(key)
            cb -= cb % coarse
            if cur is not None and cb != cur and rows:
                if stoppable and self._stop.is_set():
                    raise _TierClosed()
                self._summarize_group(rows, buf, seen)
                rows = []
            cur = cb
            rows.append((key, items))
        if rows:
            self._summarize_group(rows, buf, seen)

    def _summarize_group(self, rows: list, buf: _MapBuffer,
                         seen: set | None) -> None:
        """Decode one coarse window's rows into per-series sorted
        columns (the scan_series recipe: one batched decode + one
        lexsort + vectorized dedup) and emit records at every
        resolution."""
        quals: list[bytes] = []
        vals: list[bytes] = []
        bases: list[int] = []
        cell_sid: list[int] = []
        skeys: list[bytes] = []
        skey_index: dict[bytes, int] = {}
        for key, items in rows:
            base = codec.key_base_time(key)
            skey = codec.series_key(key)
            si = skey_index.get(skey)
            if si is None:
                si = skey_index[skey] = len(skeys)
                skeys.append(skey)
            kept = 0
            for q, v in items:
                if len(q) % 2 != 0 or not q:
                    continue
                quals.append(q)
                vals.append(v)
                bases.append(base)
                cell_sid.append(si)
                kept += 1
            if kept and seen is not None:
                seen.add(bytes(key))
        if not quals:
            return
        ts, f, i, isf, cop = codec_np.decode_cells_flat(
            quals, vals, np.asarray(bases, np.int64))
        sid = np.asarray(cell_sid, np.int64)[cop]
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
                ts, f, sid = ts[keep], f[keep], sid[keep]
        bounds = np.searchsorted(sid, np.arange(len(skeys) + 1))
        for s, (a, b) in enumerate(zip(bounds[:-1], bounds[1:])):
            if b <= a:
                continue
            self._emit_series(skeys[s], ts[a:b], f[a:b], buf)

    def _emit_series(self, skey: bytes, ts: np.ndarray, vals: np.ndarray,
                     buf: _MapBuffer) -> None:
        head, tail = skey[:UID_WIDTH], skey[UID_WIDTH:]
        for r in self.resolutions:
            wb, recs = self._fold_fn(ts, vals, r)
            blob = recs.tobytes()
            span = r * self.pack
            # Window emission is the fold's per-record hot loop: hoist
            # the row key (and its shard route + map lookup) per
            # superrow run — wb is sorted, so runs are contiguous.
            sbs = wb - wb % span
            idxs = ((wb - sbs) // r).astype(np.int64)
            run_starts = np.concatenate(
                ([0], np.flatnonzero(np.diff(sbs)) + 1, [len(wb)]))
            emitted = buf.emitted
            for a, b in zip(run_starts[:-1], run_starts[1:]):
                key = head + _u32(int(sbs[a])) + tail
                moments = buf.entries(r, key)[0]
                mask = 0
                for j in range(a, b):
                    idx = int(idxs[j])
                    moments[idx] = \
                        blob[j * REC_SIZE:(j + 1) * REC_SIZE]
                    mask |= 1 << idx
                if emitted is not None:
                    ek = (r, key)
                    emitted[ek] = emitted.get(ek, 0) | mask
                buf.count(b - a)
            if self._sketchy(r):
                dk, mk, hp = self.sketch_alloc[r]
                sb_arr, blobs = summary.window_sketches(
                    ts, vals, r, dk, hp, mk,
                    kind_bytes=self.sketch_bytes_res.setdefault(
                        r, {}))
                for j, sblob in enumerate(blobs):
                    w = int(sb_arr[j])
                    sb = w - w % span
                    key = head + _u32(sb) + tail
                    buf.entries(r, key)[1][(w - sb) // r] = sblob
                    buf.count(1)

    # -- catch-up daemon ---------------------------------------------------

    def _rebuild(self, windows: "list[int] | None" = None) -> None:
        """Tier catch-up from the raw store (crash / foreign state
        recovery). Runs on the catch-up thread; checkpoints folding in
        the meantime defer their spilled keys, drained at the end.

        ``windows`` (incremental mode, ROADMAP "Rollup incremental
        catch-up"): the persisted in-flight hour bases of the crashed
        bracket — ONLY those windows refold (every other record was
        durably committed by an earlier fold and records replace from
        raw idempotently), plus a zero pass for previously-recorded
        slots in those windows the rescan no longer emits (deleted
        rows; the crash lost the spilled keys _zero_leftovers would
        have keyed on). None = the full-tier scan."""
        try:
            import time as _time
            t_catchup0 = _time.perf_counter()
            buf = _MapBuffer(self, track_emitted=windows is not None)
            with self._fold_lock:
                names = self.tsdb.metrics.suggest("", limit=1 << 30)
                coarse = self.resolutions[-1]
                spans: list[tuple[int, int]] | None = None
                if windows is not None:
                    cw = sorted({int(b) - int(b) % coarse
                                 for b in windows})
                    spans = []
                    for b in cw:
                        if spans and b == spans[-1][1]:
                            spans[-1] = (spans[-1][0], b + coarse)
                        else:
                            spans.append((b, b + coarse))
                for name in names:
                    if self._stop.is_set():
                        raise _TierClosed()
                    uid = self.tsdb.metrics.get_id(name)
                    for lo, hi in (spans if spans is not None
                                   else [(0, 1 << 33)]):
                        self._rollup_span(uid, lo, hi, buf,
                                          stoppable=True)
                if windows is not None:
                    self._zero_unemitted(windows, buf)
                buf.flush()
                self.records_written += buf.written
            # Completion commits under the TSDB's checkpoint lock: the
            # flag flip + state write must not interleave with a
            # checkpoint's begin_spill/fold_after_spill bracket, or this
            # thread's pending=false + _inflight clear would land while
            # that checkpoint's spill is uncommitted (the same torn
            # bracket TSDB._checkpoint_lock closes for checkpoint vs
            # checkpoint). Lock order everywhere: checkpoint lock, then
            # defer lock, then fold lock — _fold and the rollup-store
            # spills below run with NEITHER outer lock held, so
            # checkpoints keep draining into _deferred instead of
            # blocking behind this thread's longest work.
            # Direct attribute access on purpose: a TSDB-like owner
            # without the lock must fail loudly here, not hand the
            # commit a private lock nobody else holds (which would
            # silently disable the torn-bracket protection).
            ckpt_lock = self.tsdb._checkpoint_lock
            while True:
                if self._stop.is_set():
                    raise _TierClosed()
                with self._defer_lock:
                    keys, self._deferred = self._deferred, []
                if keys:
                    self._fold(keys)
                    continue
                # Bound the rollup WALs BEFORE taking the checkpoint
                # lock: a full-tier spill can run for minutes at scale
                # and is WAL-durable regardless — only the flag flips
                # and the state write belong inside the bracket. A fold
                # sneaking in after these spills just re-checkpoints a
                # small delta on the next pass.
                for stores in self.stores.values():
                    for s in stores:
                        s.checkpoint(tenant_marker=False)
                with ckpt_lock:
                    with self._defer_lock:
                        if self._deferred:
                            continue  # a fold snuck in before the lock
                        # Both flags flip under the defer lock (and with
                        # no checkpoint mid-bracket) so a racing fold
                        # either lands in _deferred (drained here) or
                        # proceeds as a normal fold — never drops keys.
                        self._rebuilding = False
                        self._behind = False
                        self._full_owed = False
                    # Catch-up complete in memory, completion not yet
                    # durable: crash re-runs the whole rebuild at next
                    # open (idempotent, never stale).
                    _fault("rollup.catchup.commit", self.state_path)
                    self._write_state(pending=False)
                    self._inflight = frozenset()
                    self._ready = True
                    self.rebuilds += 1
                _M_CATCHUP.observe(
                    (_time.perf_counter() - t_catchup0) * 1000.0)
                break
        except BaseException as e:
            self._rebuilding = False
            if isinstance(e, _TierClosed) or self._stop.is_set():
                # Orderly close() abort (the stores may already be
                # closing under us): state stays pending and the next
                # open rebuilds — not a failure.
                LOG.info("rollup catch-up aborted by close(); the next "
                         "open rebuilds")
            else:
                self._rebuild_error = e
                LOG.exception(
                    "rollup catch-up failed; tier stays raw-only")

    # -- stats / lifecycle -------------------------------------------------

    def collect_stats(self, collector) -> None:
        collector.record("rollup.ready", int(self._ready))
        # Declared fold backend (gauge-of-1 with a kind tag): lets
        # operators confirm which numeric contract the stored records
        # carry without reading ROLLUP.json.
        collector.record("rollup.fold", 1, f"kind={self.fold_kind}")
        collector.record("rollup.folds", self.folds)
        collector.record("rollup.records", self.records_written)
        collector.record("rollup.rebuilds", self.rebuilds)
        collector.record("rollup.miss", self.misses)
        for r in self.resolutions:
            collector.record("rollup.hit", self.hits.get(r, 0),
                             f"res={res_label(r)}")
        for reason, n in sorted(self.fallbacks.items()):
            collector.record("rollup.fallback", n, f"reason={reason}")
        for kind, n in sorted(self.sketch_bytes.items()):
            collector.record("sketch.bytes", n, f"kind={kind}")

    def flush(self) -> None:
        for stores in self.stores.values():
            for s in stores:
                s.flush()

    def _delta_delete_hook(self, table: str, key: bytes) -> None:
        """Store delete hook: any raw-table delete (operator tools,
        query-path cleanups, sabotage workloads) drops the row's
        window from the delta accumulators. Compaction's preserving
        rewrites are excluded by the accumulator's thread-local
        preserve window (TSDB.compact_row)."""
        if table == self.table and self.delta is not None:
            self.delta.invalidate_key(key)

    def close(self) -> None:
        # Unhook from the raw store first: the store outlives tier
        # swaps (refresh_replica), and a stale hook would pin this
        # tier's accumulators alive.
        try:
            store = self.tsdb.store
            if getattr(store, "delete_hook", None) == \
                    self._delta_delete_hook:
                store.delete_hook = None
        except Exception:   # pragma: no cover - teardown best-effort
            pass
        # Stop + join the catch-up thread BEFORE closing its stores:
        # racing it would discard the whole rebuild into _rebuild_error
        # and close WAL fds out from under its writes.
        stop = getattr(self, "_stop", None)
        if stop is not None:
            stop.set()
        t = getattr(self, "_rebuild_thread", None)
        if t is not None and t.is_alive():
            t.join()
        first: BaseException | None = None
        for stores in getattr(self, "stores", {}).values():
            for s in stores:
                try:
                    s.close()
                except BaseException as e:
                    if first is None:
                        first = e
        if first is not None:
            raise first

    def _simulate_crash(self) -> None:
        """TEST HOOK: drop every rollup store's writer lock the way
        process death does (pairs with the raw store's hook)."""
        for stores in self.stores.values():
            for s in stores:
                s._simulate_crash()
