"""Router-side writer failover: probe, grace, promote, demote.

Mirrors ``opentsdb_tpu/cluster/promote.py`` of the JAX package, copied
rather than imported: the same probe cadence, grace, candidate walk,
adopt-before-mint, flip and demote-on-return, and the same events and
``cluster.promotions`` / ``cluster.promote_failures`` /
``cluster.demotions`` counters.

The router is the natural place to promote from — it already probes every
backend's ``/healthz``, it is the single ingest door whose forwarding
must flip, and it is storage-free (a promotion decision never races
its own durability). ``PromotionManager`` rides the router's probe
loop:

- Every probe interval the WRITER's ``/healthz`` is checked. Failures
  accumulate ``dead_since``; a writer dead past
  ``Config.writer_grace_ms`` triggers promotion. The grace is the
  flap filter — a writer missing one probe (GC pause, checkpoint
  stall) must not lose its store.
- Promotion walks the healthy replicas in rotation order and asks
  each to ``/promote`` until one succeeds (a candidate crashing
  mid-promotion — the ``cluster.promote.rotate`` faultpoint scenario
  — just moves the walk along). On success the router's telnet/HTTP
  ingest forwarding flips to the promoted daemon atomically (one
  attribute swap on the event loop).
- A deposed writer that reappears (answers probes again with a stale
  ``writer_epoch``, or reports itself ``fenced``) is told to
  ``/demote`` — it rejoins the fleet as a tailing replica instead of
  sitting fenced and useless.

Single-promoter assumption: one router drives promotion for a store.
The on-disk epoch CAS turns a violated assumption into a loud
``EpochConflictError`` on the second bump, never two writers at the
same epoch.
"""

from __future__ import annotations

import asyncio
import json
import logging
import time

from opentsdb_tpu_torch.obs.registry import METRICS

LOG = logging.getLogger(__name__)

_M_PROMOTIONS = METRICS.counter("cluster.promotions")
_M_PROMOTE_FAILS = METRICS.counter("cluster.promote_failures")
_M_DEMOTIONS = METRICS.counter("cluster.demotions")


class PromotionManager:
    """Drives failover from inside the router's probe loop.

    ``router`` duck-types RouterServer: ``.backends`` (probe order =
    promotion candidate order), ``._writer`` (the forwarding target,
    swapped on promotion), ``.config``.
    """

    def __init__(self, router) -> None:
        self.router = router
        self.grace_ms = float(getattr(router.config,
                                      "writer_grace_ms", 0.0) or 0.0)
        self.dead_since: float | None = None
        self.promoting = False
        self.demoting = False
        self.epoch = 0           # last cluster epoch this router saw
        self.writer_probes_failed = 0
        # Failover history for /api/topology: [{ts, event, url, epoch}]
        self.events: list[dict] = []
        # The deposed writer we still owe a /demote (url string).
        self._deposed_url: str | None = None

    def snapshot(self) -> dict:
        return {
            "enabled": self.grace_ms > 0,
            "writer_grace_ms": self.grace_ms,
            "epoch": self.epoch,
            "writer_dead_for_ms":
                round((time.monotonic() - self.dead_since) * 1000.0, 1)
                if self.dead_since else None,
            "deposed_url": self._deposed_url,
            "events": self.events[-32:],
        }

    def _note(self, event: str, **kw) -> None:
        rec = {"ts": int(time.time()), "event": event, **kw}
        self.events.append(rec)
        LOG.warning("cluster failover: %s", rec)

    # -- the probe hook ---------------------------------------------------

    def _spawn_promote(self) -> None:
        """Run the promotion walk as its OWN task: /promote replays a
        WAL tail (seconds-to-minutes timeouts), and awaiting it inside
        the probe gather would stall every backend health probe for
        the duration — crippling ejection detection exactly when the
        fleet is degraded."""
        self.promoting = True

        async def go():
            try:
                await self._promote_someone()
            finally:
                self.promoting = False

        # Keep a strong reference: a fire-and-forget task may be
        # collected mid-flight otherwise.
        self._promote_task = asyncio.ensure_future(go())

    async def probe_writer(self) -> None:
        """One probe cycle against the current writer (and, when one
        exists, the deposed writer awaiting demotion). Called from the
        router's probe loop; never raises, never blocks the loop on
        the slow promote/demote RPCs (they run as separate tasks)."""
        w = self.router._writer
        if w is None:
            return
        from opentsdb_tpu_torch.serve.router import HopError, _http_fetch
        try:
            status, _, body = await _http_fetch(
                w.host, w.port, "/healthz", timeout_s=2.0)
            health = json.loads(body)
        except (HopError, ValueError):
            self.writer_probes_failed += 1
            if self.dead_since is None:
                self.dead_since = time.monotonic()
            elif (self.grace_ms > 0 and not self.promoting
                  and (time.monotonic() - self.dead_since) * 1000.0
                  >= self.grace_ms):
                self._spawn_promote()
            return
        w.last_health = health
        self.dead_since = None
        epoch = int(health.get("writer_epoch", 0) or 0)
        if epoch > self.epoch:
            self.epoch = epoch
        # A writer that answers but is FENCED (or reports an epoch
        # below one we've seen) has been deposed — it cannot ack, so
        # keeping ingest pointed at it is an outage. This runs even
        # with the grace at 0 (operator-driven mode): fencing is
        # unambiguous — a promotion ALREADY happened somewhere, and
        # the walk below adopts the existing new writer before it
        # would ever mint one.
        if health.get("fenced") or (epoch and epoch < self.epoch):
            if not self.promoting:
                self._note("writer-fenced", url=w.url, epoch=epoch)
                self._spawn_promote()
        if self._deposed_url is not None and not self.demoting:
            self.demoting = True

            async def go():
                try:
                    await self._demote_deposed()
                finally:
                    self.demoting = False

            self._demote_task = asyncio.ensure_future(go())

    async def _promote_someone(self) -> None:
        """Walk healthy replicas in rotation order; first /promote
        win flips the ingest forwarding target. The caller
        (_spawn_promote) owns the ``promoting`` flag."""
        from opentsdb_tpu_torch.serve.router import Backend, HopError, \
            _http_fetch
        old = self.router._writer
        candidates = [b for b in self.router.backends if b.healthy]
        if not candidates:
            # A dark fleet gets the same one desperate attempt the
            # read path gives it.
            candidates = list(self.router.backends)
        # ADOPT before minting: if a backend already reports itself
        # the writer (an operator-driven /promote the router wasn't
        # told about — the fenced-writer path at grace 0), flip to it
        # without bumping anyone.
        for b in candidates:
            if old is not None and b.url == old.url:
                continue
            h = b.last_health or {}
            if h.get("role") == "writer" and not h.get("fenced"):
                self.epoch = max(self.epoch,
                                 int(h.get("writer_epoch", 0) or 0))
                self.router._writer = Backend(b.url)
                if old is not None and old.url != b.url:
                    self._deposed_url = old.url
                self._note("adopted-writer", url=b.url,
                           epoch=self.epoch,
                           deposed=old.url if old else None)
                self.dead_since = None
                return
        for b in candidates:
            if old is not None and b.url == old.url:
                continue  # never promote the body we're replacing
            try:
                # Generous timeout: a promotion replays the WAL
                # tail and rotates files — seconds, not probe-ms.
                status, _, body = await _http_fetch(
                    b.host, b.port, "/promote", timeout_s=60.0)
                if status != 200:
                    raise HopError(f"/promote on {b.url} answered "
                                   f"{status}: {body[:200]!r}")
                rec = json.loads(body)
            except (HopError, ValueError) as e:
                _M_PROMOTE_FAILS.inc()
                self._note("promote-failed", url=b.url,
                           error=str(e)[:200])
                continue
            self.epoch = int(rec.get("epoch", self.epoch) or 0)
            # THE flip: one attribute swap on the event loop —
            # every later forwarded put goes to the new writer.
            self.router._writer = Backend(b.url)
            if old is not None and old.url != b.url:
                self._deposed_url = old.url
            _M_PROMOTIONS.inc()
            self._note("promoted", url=b.url, epoch=self.epoch,
                       deposed=old.url if old else None)
            self.dead_since = None
            return
        self._note("promotion-exhausted",
                   candidates=[b.url for b in candidates])

    async def _demote_deposed(self) -> None:
        """Offer the deposed writer its way back: once it answers
        probes again, tell it to /demote into a tailing replica."""
        url = self._deposed_url
        if url is None:
            return
        from opentsdb_tpu_torch.serve.router import Backend, HopError, \
            _http_fetch
        b = Backend(url)
        try:
            status, _, body = await _http_fetch(
                b.host, b.port, "/demote", timeout_s=15.0)
        except HopError:
            return  # still dead; keep owing it the demote
        if status == 200:
            _M_DEMOTIONS.inc()
            self._note("demoted", url=url)
            self._deposed_url = None
        # Non-200 (e.g. not a cluster member — operator restarted it
        # without --cluster): keep trying; the epoch fence keeps the
        # store safe regardless.
