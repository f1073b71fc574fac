"""Per-tenant series-cardinality accounting fed from the ingest path.

Mirrors ``opentsdb_tpu/tenant/accounting.py`` of the JAX package (the
port imports nothing of that package); host code, numpy only. For the
same sequence of calls it holds the same state and writes the same
snapshot bytes, so either package loads the other's file.

The unit of accounting is the series-identity hash — the crc32 the
TSST3 blooms key on (``storage/sstable.series_hash``) — so the control
plane counts exactly what the directory, the blooms, and the UID maps
grow by.

Three structures per tenant, each with a bounded memory story:

- **Exact tier**: a set of identity hashes while the tenant stays
  below ``exact_cutoff`` distinct series. Counts are exact, membership
  is exact, snapshots round-trip exactly.
- **Sketch tier**: past the cutoff the set folds into a HyperLogLog
  register bank (2^p uint8 registers) and the exact set is dropped: a
  hostile tenant minting millions of series costs 2^p bytes, not
  O(series). Estimates carry the standard ~1.04/sqrt(2^p) relative
  error; register max keeps re-admission idempotent.
- **Heavy hitters**: two SpaceSaving summaries (Metwally et al.) — the
  top-K series by ingested POINTS (the hot keys) and the top-K metric
  prefixes by NEW SERIES (where a cardinality explosion is coming
  from). Capacity 4K for a top-K report keeps the per-entry
  overestimation error <= stream/(4K).

Membership for the "is this series NEW" admission question is a
GLOBAL exact hash set (not per-tenant): per-tenant sketch tiers cannot
answer membership, and refusing a tenant's *existing* series after a
restart would violate the enforcement contract (limits.py). The global
set persists in the snapshot as a packed uint32 array, so a reopened
store never mistakes old series for new.

Durability: ``save()`` writes the snapshot atomically (tmp + fsync +
rename) inside the checkpoint bracket BEFORE the storage spill: a crash
before the spill leaves a snapshot that already covers the sstable
tier, and boot re-folds only the WAL-replayed memtable's series on top
(attributed to the "default" tenant and counted in
``recovered_series`` — the WAL carries no tenant ids). A foreign or
torn state file rebuilds from a full storage scan instead: totals come
back exact, per-tenant splits re-accumulate.

The snapshot's two fault points are the JAX package's:
``tenant.snapshot.write`` (the temp file durable, the rename pending)
and ``tenant.snapshot.commit`` (renamed).

``collect_stats`` records the ``tenant.*`` lines of ``/stats``.
"""

from __future__ import annotations

import base64
import json
import os
import threading

import numpy as np

from opentsdb_tpu_torch.fault.faultpoints import fire as _fault

_VERSION = 1

# Reserved tenant id for boot-time re-attribution of series the
# snapshot missed (crash-window WAL replays, foreign-file rebuilds).
RECOVERED_TENANT = "default"


def hll_rel_error(p: int) -> float:
    """The standard HyperLogLog relative standard error."""
    return 1.04 / (1 << p) ** 0.5


def metric_prefix(metric: str) -> str:
    """The namespace a metric belongs to: its first two dot segments
    ("sys.cpu.user" -> "sys.cpu")."""
    parts = metric.split(".", 2)
    return ".".join(parts[:2])


class SpaceSaving:
    """SpaceSaving heavy-hitter summary: at most ``capacity`` tracked
    keys; an untracked arrival evicts the minimum-count entry and
    inherits its count as overestimation error. ``count - err`` is a
    guaranteed LOWER bound on the key's true weight, and any key with
    true weight > total/capacity is guaranteed tracked."""

    __slots__ = ("capacity", "items", "total")

    def __init__(self, capacity: int) -> None:
        self.capacity = max(int(capacity), 1)
        self.items: dict[str, list] = {}   # key -> [count, err]
        self.total = 0

    def offer(self, key: str, weight: int = 1) -> None:
        if weight <= 0:
            return
        self.total += weight
        ent = self.items.get(key)
        if ent is not None:
            ent[0] += weight
            return
        if len(self.items) < self.capacity:
            self.items[key] = [weight, 0]
            return
        victim = min(self.items, key=lambda k: self.items[k][0])
        vcount = self.items.pop(victim)[0]
        self.items[key] = [vcount + weight, vcount]

    def top(self, k: int) -> list[tuple[str, int, int]]:
        """[(key, count, err)] sorted by count descending."""
        ranked = sorted(self.items.items(), key=lambda kv: -kv[1][0])
        return [(key, ent[0], ent[1]) for key, ent in ranked[:k]]

    def to_json(self) -> list:
        return [[k, ent[0], ent[1]] for k, ent in self.items.items()]

    @classmethod
    def from_json(cls, capacity: int, data: list) -> "SpaceSaving":
        self = cls(capacity)
        for k, count, err in data:
            self.items[str(k)] = [int(count), int(err)]
        self.total = sum(ent[0] for ent in self.items.values())
        return self


def _mix64(h: np.ndarray) -> np.ndarray:
    """Spread the 32-bit identity hashes over 64 bits (splitmix-style
    multiply + xorshift): HLL needs independent index and rank bits."""
    h = h.astype(np.uint64)
    h = (h * np.uint64(0x9E3779B97F4A7C15)) & np.uint64(~0 & (1 << 64) - 1)
    h ^= h >> np.uint64(29)
    h = (h * np.uint64(0xBF58476D1CE4E5B9)) & np.uint64(~0 & (1 << 64) - 1)
    h ^= h >> np.uint64(32)
    return h


def _hll_fold(regs: np.ndarray, hashes: np.ndarray, p: int) -> None:
    """Fold identity hashes into a 2^p uint8 register bank in place."""
    if len(hashes) == 0:
        return
    h = _mix64(np.asarray(hashes, np.uint64))
    idx = (h >> np.uint64(64 - p)).astype(np.int64)
    w = (h << np.uint64(p)) | np.uint64((1 << p) - 1)
    # rho = leading zeros of the (64-p)-bit word + 1; the OR above
    # sentinels the low bits so rho caps at 64-p+1.
    rho = np.ones(len(h), np.uint8)
    mask = np.uint64(1) << np.uint64(63)
    w = w.copy()
    live = np.ones(len(h), bool)
    for _ in range(64):
        zero = live & ((w & mask) == 0)
        if not zero.any():
            break
        rho[zero] += 1
        live &= zero
        w = (w << np.uint64(1)) & np.uint64((1 << 64) - 1)
    np.maximum.at(regs, idx, rho)


def _hll_estimate(regs: np.ndarray) -> float:
    m = len(regs)
    alpha = 0.7213 / (1 + 1.079 / m)
    est = alpha * m * m / float(np.sum(2.0 ** -regs.astype(np.float64)))
    zeros = int(np.count_nonzero(regs == 0))
    if est <= 2.5 * m and zeros:
        est = m * np.log(m / zeros)   # linear counting, small range
    return float(est)


class _TenantState:
    __slots__ = ("exact", "hll", "points", "refused", "would_refuse",
                 "hh_series", "hh_prefixes")

    def __init__(self, topk_cap: int) -> None:
        self.exact: set[int] | None = set()
        self.hll: np.ndarray | None = None
        self.points = 0
        self.refused = 0
        self.would_refuse = 0
        self.hh_series = SpaceSaving(topk_cap)
        self.hh_prefixes = SpaceSaving(topk_cap)

    def tier(self) -> str:
        return "exact" if self.exact is not None else "hll"

    def count(self) -> int:
        if self.exact is not None:
            return len(self.exact)
        return int(round(_hll_estimate(self.hll)))

    def add(self, h: int, cutoff: int, hll_p: int) -> None:
        if self.exact is not None:
            self.exact.add(h)
            if len(self.exact) > cutoff:
                self.hll = np.zeros(1 << hll_p, np.uint8)
                _hll_fold(self.hll,
                          np.fromiter(self.exact, np.uint64,
                                      len(self.exact)), hll_p)
                self.exact = None
        else:
            _hll_fold(self.hll, np.asarray([h], np.uint64), hll_p)


class TenantAccountant:
    """Process-wide per-tenant series accounting (one per writer TSDB).

    Thread-safe: one lock around every mutation; reads of the summary
    endpoints snapshot under the same lock.
    """

    def __init__(self, path: str | None = None, exact_cutoff: int = 4096,
                 hll_p: int = 12, topk: int = 16) -> None:
        self.path = path
        self.exact_cutoff = int(exact_cutoff)
        self.hll_p = int(hll_p)
        self.topk = int(topk)
        self._lock = threading.RLock()
        self._seen: set[int] = set()
        self._tenants: dict[str, _TenantState] = {}
        self.total_new_series = 0
        self.recovered_series = 0
        self.rebuilt = False          # last open() fell back to a scan
        self.snapshots_written = 0

    # -- ingest-side API ---------------------------------------------------

    def seen(self, h: int) -> bool:
        return h in self._seen

    def count(self, tenant: str) -> int:
        with self._lock:
            st = self._tenants.get(tenant)
            return st.count() if st is not None else 0

    def total_tracked(self) -> int:
        return len(self._seen)

    def _state(self, tenant: str) -> _TenantState:
        st = self._tenants.get(tenant)
        if st is None:
            # SpaceSaving capacity 4x the report size: the classic
            # headroom that keeps top-K overestimation errors small.
            st = self._tenants[tenant] = _TenantState(4 * self.topk)
        return st

    def note_new_series(self, tenant: str, h: int, metric: str) -> None:
        """Record one admitted NEW series. Idempotent by hash: the
        global seen-set makes double counting impossible, and callers
        racing on the same fresh series at worst both fold the same
        hash (set add / HLL register max are idempotent)."""
        with self._lock:
            if h in self._seen:
                return
            self._seen.add(h)
            self.total_new_series += 1
            st = self._state(tenant)
            st.add(h, self.exact_cutoff, self.hll_p)
            st.hh_prefixes.offer(metric_prefix(metric), 1)

    def note_points(self, tenant: str, series_label: str,
                    n: int) -> None:
        with self._lock:
            st = self._state(tenant)
            st.points += n
            st.hh_series.offer(series_label, n)

    def record_refusal(self, tenant: str, warn_only: bool) -> None:
        with self._lock:
            st = self._state(tenant)
            if warn_only:
                st.would_refuse += 1
            else:
                st.refused += 1

    # -- boot / recovery ---------------------------------------------------

    def fold_recovered(self, hashes, tenant: str = RECOVERED_TENANT,
                       ) -> int:
        """Attribute hashes the snapshot doesn't know to ``tenant``
        (boot-time delta fold / full rebuild). The WAL carries no
        tenant ids, so crash-window series land on the default tenant
        and the count is DECLARED via ``recovered_series``. Returns how
        many were new."""
        added = 0
        with self._lock:
            for h in hashes:
                h = int(h)
                if h in self._seen:
                    continue
                self._seen.add(h)
                self.total_new_series += 1
                self._state(tenant).add(h, self.exact_cutoff,
                                        self.hll_p)
                added += 1
            self.recovered_series += added
        return added

    # -- snapshot ----------------------------------------------------------

    @staticmethod
    def _b64(arr: np.ndarray) -> str:
        # np.sort, not sorted(): this runs under the ingest lock, and
        # sorting is only for deterministic bytes.
        return base64.b64encode(
            np.sort(np.asarray(arr, np.uint32)).tobytes()).decode()

    @staticmethod
    def _unb64(s: str) -> np.ndarray:
        return np.frombuffer(base64.b64decode(s), np.uint32)

    def save(self, path: str | None = None) -> int:
        """Atomic snapshot (tmp + fsync + rename + dir fsync), called
        from the checkpoint bracket BEFORE the storage spill. Returns
        the bytes written (0 without a path). Fault points:
        ``tenant.snapshot.write`` (a torn temp file leaves the previous
        snapshot in place) and ``tenant.snapshot.commit`` (a torn final
        file is the corruption the rebuild from storage absorbs)."""
        path = path or self.path
        if not path:
            return 0
        with self._lock:
            tenants = {}
            for name, st in self._tenants.items():
                ent: dict = {
                    "tier": st.tier(), "count": st.count(),
                    "points": st.points, "refused": st.refused,
                    "would_refuse": st.would_refuse,
                    "hh_series": st.hh_series.to_json(),
                    "hh_prefixes": st.hh_prefixes.to_json(),
                }
                if st.exact is not None:
                    ent["exact_b64"] = self._b64(
                        np.fromiter(st.exact, np.uint32, len(st.exact)))
                else:
                    ent["hll_b64"] = base64.b64encode(
                        st.hll.tobytes()).decode()
                tenants[name] = ent
            payload = {
                "version": _VERSION,
                "exact_cutoff": self.exact_cutoff,
                "hll_p": self.hll_p,
                "topk": self.topk,
                "total_new_series": self.total_new_series,
                "recovered_series": self.recovered_series,
                "seen_b64": self._b64(np.fromiter(
                    self._seen, np.uint32, len(self._seen))),
                "tenants": tenants,
            }
        # The JSON encode runs OUTSIDE the lock: the captured payload is
        # all scalars and strings.
        body = json.dumps(payload).encode()
        tmp = path + ".tmp"
        with open(tmp, "wb") as f:
            f.write(body)
            f.flush()
            os.fsync(f.fileno())
        _fault("tenant.snapshot.write", tmp,
               rec_bytes=min(len(body), 64))
        os.replace(tmp, path)
        try:
            dfd = os.open(os.path.dirname(path) or ".", os.O_RDONLY)
            try:
                os.fsync(dfd)
            finally:
                os.close(dfd)
        except OSError:
            pass
        _fault("tenant.snapshot.commit", path,
               rec_bytes=min(len(body), 64))
        self.snapshots_written += 1
        return len(body)

    @classmethod
    def load(cls, path: str, exact_cutoff: int = 4096, hll_p: int = 12,
             topk: int = 16) -> "TenantAccountant":
        """Load a snapshot; raises on a missing, torn, or foreign
        file — the TSDB boot path catches and rebuilds from storage.
        A snapshot's own cutoff/p win over the config arguments: the
        persisted layout is authoritative for state built under it."""
        with open(path, "rb") as f:
            data = json.loads(f.read())
        if data.get("version") != _VERSION:
            raise ValueError(
                f"foreign TENANTS.json version {data.get('version')!r}")
        self = cls(path=path,
                   exact_cutoff=int(data["exact_cutoff"]),
                   hll_p=int(data["hll_p"]),
                   topk=int(data.get("topk", topk)))
        self._seen = set(int(h) for h in cls._unb64(data["seen_b64"]))
        self.total_new_series = int(data["total_new_series"])
        self.recovered_series = int(data.get("recovered_series", 0))
        cap = 4 * self.topk
        for name, ent in data["tenants"].items():
            st = _TenantState(cap)
            if "exact_b64" in ent:
                st.exact = set(int(h)
                               for h in cls._unb64(ent["exact_b64"]))
            else:
                st.exact = None
                st.hll = np.frombuffer(
                    base64.b64decode(ent["hll_b64"]),
                    np.uint8).copy()
                if len(st.hll) != 1 << self.hll_p:
                    raise ValueError("HLL register bank size mismatch")
            st.points = int(ent.get("points", 0))
            st.refused = int(ent.get("refused", 0))
            st.would_refuse = int(ent.get("would_refuse", 0))
            st.hh_series = SpaceSaving.from_json(
                cap, ent.get("hh_series", []))
            st.hh_prefixes = SpaceSaving.from_json(
                cap, ent.get("hh_prefixes", []))
            self._tenants[name] = st
        return self

    # -- reporting ---------------------------------------------------------

    def snapshot_info(self, limits=None) -> dict:
        """The /api/tenants body (JSON-ready). ``limits`` is the
        TenantLimiter (optional) so every tenant row names the limit
        that governs it."""
        with self._lock:
            tenants = {}
            for name, st in sorted(self._tenants.items()):
                ent = {
                    "series": st.count(),
                    "tier": st.tier(),
                    "error": (0.0 if st.exact is not None
                              else round(hll_rel_error(self.hll_p), 4)),
                    "points": st.points,
                    "refused": st.refused,
                    "would_refuse": st.would_refuse,
                    "top_series": [
                        {"series": k, "points": c, "err": e}
                        for k, c, e in st.hh_series.top(self.topk)],
                    "top_prefixes": [
                        {"prefix": k, "new_series": c, "err": e}
                        for k, c, e in st.hh_prefixes.top(self.topk)],
                }
                if limits is not None:
                    ent["limit"] = limits.limit_for(name)
                tenants[name] = ent
            body = {
                "tenants": tenants,
                "total_series": self.total_new_series,
                "tracked_series": len(self._seen),
                "recovered_series": self.recovered_series,
                "exact_cutoff": self.exact_cutoff,
                "hll_p": self.hll_p,
                "snapshots_written": self.snapshots_written,
            }
            if limits is not None:
                body["mode"] = limits.mode
                body["global_limit"] = limits.global_limit
            return body

    # -- /stats lines --------------------------------------------------------

    # Per-tenant lines are bounded: /stats is scraped into time series and
    # tenant ids come from clients, so only the top N by series count get
    # per-tenant lines; the rest show in tenant.count and /api/tenants.
    STATS_TENANTS = 32

    @staticmethod
    def _stats_tag(tenant: str) -> str:
        """Tenant ids are client strings and a /stats line is
        whitespace-split k=v pairs: anything outside a safe charset folds
        to '_' (the JSON endpoints carry the raw id)."""
        safe = "".join(ch if ch.isalnum() or ch in "._-" else "_"
                       for ch in tenant)
        return f"tenant={safe or '_'}"

    def collect_stats(self, collector) -> None:
        with self._lock:
            collector.record("tenant.count", len(self._tenants))
            collector.record("tenant.tracked_series", len(self._seen))
            collector.record("tenant.recovered_series",
                             self.recovered_series)
            collector.record("tenant.refused", sum(
                st.refused for st in self._tenants.values()))
            collector.record("tenant.would_refuse", sum(
                st.would_refuse for st in self._tenants.values()))
            ranked = sorted(self._tenants.items(),
                            key=lambda kv: -kv[1].count())
            for name, st in ranked[:self.STATS_TENANTS]:
                tag = self._stats_tag(name)
                collector.record("tenant.series", st.count(), tag)
                if st.refused:
                    collector.record("tenant.refused_by", st.refused,
                                     tag)
                top = st.hh_series.top(1)
                if top:
                    collector.record("tenant.hh.series_points",
                                     top[0][1], tag)
                top = st.hh_prefixes.top(1)
                if top:
                    collector.record("tenant.hh.prefix_series",
                                     top[0][1], tag)
