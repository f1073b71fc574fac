"""Admission control: per-tenant quotas + the query load-shedding ladder.

Mirrors ``opentsdb_tpu/serve/admission.py`` of the JAX package, whole
(``collect_stats`` records the ``admission.*`` lines of ``/stats``). The
port's daemon consults its ingest half (``admit_ingest`` /
``ingest_done``) on every telnet and HTTP put and its query half
(``admit_query`` / ``query_done``) on every ``/q``; the router consults
both, without the rollup-only step, which it asks of the replicas.

The failure this prevents is the classic collapse: an overloaded
daemon queues work it will never finish, memory grows, every request
slows together, and the process dies taking ALL tenants with it.
Admission control sheds EARLY and CHEAPLY instead:

- **Ingest**: a per-tenant token bucket in points/s plus a global cap on
  decoded-but-unapplied points. Over either bound, the put is refused
  with a throttle error + Retry-After BEFORE it allocates batch
  arrays — collectors already understand "Please throttle" lines.
- **Query**: a per-tenant queries/s bucket (429 when dry), then a
  process-wide ladder keyed on in-flight queries vs
  ``Config.query_max_inflight`` N:

      inflight <  N   full service
      inflight < 2N   DEGRADED: traces stripped, /q serves rollup-only
                      (no raw stitching; results carry
                      "degraded": "rollup-only"; a query the tier
                      cannot serve at all gets 503 + Retry-After)
      inflight >= 2N  503 + Retry-After

Retry-After values are honest: the bucket's time-to-refill for quota
sheds, a short constant for load sheds.
"""

from __future__ import annotations

import threading
import time


class TokenBucket:
    """The standard leaky counter: ``rate`` tokens/s, ``burst`` cap.

    ``take(n)`` returns 0.0 on admit or the seconds until ``n`` tokens
    will exist (the Retry-After hint) — it never blocks and never goes
    negative, so one oversized request can't mortgage the future.
    """

    def __init__(self, rate: float, burst: float,
                 tokens: float | None = None) -> None:
        if rate <= 0:
            raise ValueError(f"rate must be > 0, got {rate}")
        self.rate = float(rate)
        self.burst = max(float(burst), 1.0)
        # ``tokens`` overrides the initial fill (default: full burst).
        # The eviction path mints COLD buckets — see _bucket.
        self._tokens = self.burst if tokens is None else float(tokens)
        self._t = time.monotonic()
        # Last take() wall-clock (monotonic): the idle signal the
        # tenant-bucket LRU eviction keys on.
        self.last_take = self._t
        self._lock = threading.Lock()

    def take(self, n: float = 1.0, now: float | None = None) -> float:
        now = time.monotonic() if now is None else now
        with self._lock:
            self.last_take = now
            # max(0, ...): a caller-injected clock (tests) may start
            # below the construction-time monotonic stamp; time never
            # flows backwards through the bucket.
            self._tokens = min(
                self.burst,
                self._tokens + max(now - self._t, 0.0) * self.rate)
            self._t = now
            if n <= self._tokens:
                self._tokens -= n
                return 0.0
            return (n - self._tokens) / self.rate


# admit_query verdicts.
OK = "ok"
DEGRADE = "degrade"
SHED_QUOTA = "shed-quota"    # per-tenant bucket dry -> 429
SHED_LOAD = "shed-load"      # ladder top -> 503


class AdmissionController:
    """One per daemon; the server consults it on every put batch and
    every /q. All knobs default off (0), so an unconfigured daemon
    behaves exactly as before."""

    def __init__(self, config) -> None:
        self.config = config
        self._lock = threading.Lock()
        self._ingest_buckets: dict[str, TokenBucket] = {}
        self._query_buckets: dict[str, TokenBucket] = {}
        self.inflight_queries = 0
        self.inflight_ingest_points = 0
        # Shed counters (exported via /stats).
        self.ingest_shed_quota = 0
        self.ingest_shed_queue = 0
        self.query_shed_quota = 0
        self.query_shed_load = 0
        self.query_degraded = 0
        # Tenant-bucket table churn at MAX_TENANTS (see _bucket).
        self.tenants_evicted = 0
        self.tenants_collapsed = 0
        # Per bucket-table (keyed by id()): the earliest monotonic
        # time any current bucket could turn idle, recorded when an
        # eviction scan found NO victim. Until then every uncached
        # tenant collapses straight to the shared bucket without
        # re-scanning — the saturated-table attack otherwise pays an
        # O(MAX_TENANTS) scan under self._lock on EVERY request.
        self._no_idle_before: dict[int, float] = {}

    # -- ingest ----------------------------------------------------------

    def admit_ingest(self, points: int,
                     tenant: str = "default") -> float:
        """0.0 admits ``points`` (caller MUST pair with
        ``ingest_done``); > 0 is the Retry-After in seconds, and NO
        slot was taken."""
        cfg = self.config
        cap = int(getattr(cfg, "ingest_queue_points", 0) or 0)
        if cap:
            # Check-and-reserve under ONE lock acquisition: a check
            # now and an increment later would let two concurrent
            # batches both pass against the same headroom and
            # overshoot the cap by a whole batch each.
            with self._lock:
                if self.inflight_ingest_points + points > cap:
                    self.ingest_shed_queue += 1
                    # The queue drains at ingest speed; a beat is the
                    # honest hint (the caller can't see the drain rate).
                    return 0.5
                self.inflight_ingest_points += points
        rate = float(getattr(cfg, "ingest_rate", 0) or 0)
        if rate > 0:
            b = self._bucket(self._ingest_buckets, tenant, rate,
                             rate * float(cfg.ingest_burst_s))
            wait = b.take(points)
            if wait > 0:
                if cap:
                    with self._lock:
                        self.inflight_ingest_points = max(
                            0, self.inflight_ingest_points - points)
                self.ingest_shed_quota += 1
                return max(wait, 0.05)
        return 0.0

    def ingest_done(self, points: int) -> None:
        if int(getattr(self.config, "ingest_queue_points", 0) or 0):
            with self._lock:
                self.inflight_ingest_points = max(
                    0, self.inflight_ingest_points - points)

    # -- query -----------------------------------------------------------

    def admit_query(self, tenant: str = "default") -> tuple[str, float]:
        """(verdict, retry_after). OK and DEGRADE verdicts take an
        in-flight slot — the caller MUST pair them with
        ``query_done()``; shed verdicts don't."""
        cfg = self.config
        rate = float(getattr(cfg, "query_rate", 0) or 0)
        if rate > 0:
            b = self._bucket(self._query_buckets, tenant, rate,
                             float(cfg.query_burst))
            wait = b.take(1.0)
            if wait > 0:
                self.query_shed_quota += 1
                return SHED_QUOTA, max(wait, 0.05)
        n = int(getattr(cfg, "query_max_inflight", 0) or 0)
        if n <= 0:
            with self._lock:
                self.inflight_queries += 1
            return OK, 0.0
        with self._lock:
            if self.inflight_queries >= 2 * n:
                self.query_shed_load += 1
                return SHED_LOAD, 0.5
            verdict = OK if self.inflight_queries < n else DEGRADE
            if verdict == DEGRADE:
                self.query_degraded += 1
            self.inflight_queries += 1
        return verdict, 0.0

    def query_done(self) -> None:
        with self._lock:
            self.inflight_queries = max(0, self.inflight_queries - 1)

    # -- plumbing --------------------------------------------------------

    # Distinct tenants tracked per bucket table: the ?tenant=
    # parameter is client-controlled, so an uncapped dict would grow
    # one bucket per request — unbounded memory (each fresh tenant
    # also minting a fresh burst allowance) inside the component whose
    # job is shedding before memory does.
    #
    # At the cap, a NEW tenant first tries to EVICT the least-recently
    # -used bucket that has sat idle for >= IDLE_EVICT_S — so a
    # cardinality attack spraying fresh ?tenant= ids churns the
    # attacker's own abandoned buckets while every actively-ingesting
    # tenant keeps its quota untouched. A bucket minted through an
    # eviction starts COLD (zero tokens, earning at ``rate`` from its
    # first request): a full-burst grant here would let an attacker
    # cycle abandoned ids into ~MAX_TENANTS/IDLE_EVICT_S fresh burst
    # allowances per second forever. A legitimate newcomer arriving
    # mid-attack pays a one-time Retry-After instead of being
    # collapsed onto the shared bucket. Only when no bucket is idle
    # (every slot genuinely active) does the newcomer collapse onto
    # the shared "default" bucket — bounded memory AND no
    # fresh-burst-per-uuid once the attack saturates the table.
    MAX_TENANTS = 1024
    IDLE_EVICT_S = 30.0

    def _bucket(self, buckets: dict, tenant: str, rate: float,
                burst: float, now: float | None = None) -> TokenBucket:
        b = buckets.get(tenant)
        if b is None or b.rate != rate:
            now = time.monotonic() if now is None else now
            cold = False
            with self._lock:
                if (tenant not in buckets
                        and len(buckets) >= self.MAX_TENANTS):
                    victim = None
                    # Scan only when a victim is possible: a failed
                    # scan records when the oldest bucket COULD turn
                    # idle, and takes only push that later, so the
                    # stamp is a sound skip — at most one O(n) scan
                    # per idle window instead of one per request.
                    if now >= self._no_idle_before.get(id(buckets),
                                                       0.0):
                        v_last = now - self.IDLE_EVICT_S
                        oldest = None
                        for name, vb in buckets.items():
                            if name == "default":
                                continue
                            lt = vb.last_take
                            if oldest is None or lt < oldest:
                                oldest = lt
                            if lt <= v_last:
                                victim, v_last = name, lt
                        if victim is None and oldest is not None:
                            self._no_idle_before[id(buckets)] = (
                                oldest + self.IDLE_EVICT_S)
                    if victim is not None:
                        del buckets[victim]
                        self.tenants_evicted += 1
                        cold = True
                    else:
                        tenant = "default"
                        self.tenants_collapsed += 1
                b = buckets.get(tenant)
                if b is None or b.rate != rate:
                    b = buckets[tenant] = TokenBucket(
                        rate, burst, tokens=0.0 if cold else None)
        return b

    def collect_stats(self, collector) -> None:
        collector.record("admission.inflight_queries",
                         self.inflight_queries)
        collector.record("admission.inflight_ingest_points",
                         self.inflight_ingest_points)
        collector.record("admission.shed", self.ingest_shed_quota,
                         "path=ingest reason=quota")
        collector.record("admission.shed", self.ingest_shed_queue,
                         "path=ingest reason=queue")
        collector.record("admission.shed", self.query_shed_quota,
                         "path=query reason=quota")
        collector.record("admission.shed", self.query_shed_load,
                         "path=query reason=load")
        collector.record("admission.degraded_queries",
                         self.query_degraded)
        collector.record("admission.tenants",
                         max(len(self._ingest_buckets),
                             len(self._query_buckets)))
        collector.record("admission.tenants_evicted",
                         self.tenants_evicted)
        collector.record("admission.tenants_collapsed",
                         self.tenants_collapsed)
