"""Per-tenant series-cardinality limits, enforced at write admission.

Mirrors ``opentsdb_tpu/tenant/limits.py`` of the JAX package. The
contract:

- Only a **new** series is ever refused — a tenant at its cap keeps
  ingesting every series it already owns, so steady-state collection
  never breaks; only *growth* does, loudly.
- The refusal is **declared**: ``TenantLimitError`` names the tenant,
  the limit, and the current count; the telnet face is a distinct
  ``put: tenant series limit exceeded`` line (NOT a throttle) and the
  HTTP face is a 429 body naming the limit.
- ``warn`` mode counts and logs what WOULD have been refused
  (``would_refuse``) without refusing — the dry run an operator turns
  on before enforcement.
- Per-tenant overrides beat the blanket cap; a global cap backstops
  the sum (any tenant's new series refuses once the whole directory
  hits it, named as such).

Sabotage hook, as in the JAX package: ``TSDB_TENANT_BUG=no-limit``
silently disables enforcement, so a harness can show that it catches a
limiter that stopped limiting.
"""

from __future__ import annotations

import logging
import os

from opentsdb_tpu_torch.core.errors import TenantLimitError

LOG = logging.getLogger(__name__)

MODES = ("enforce", "warn")


def parse_overrides(specs) -> dict[str, int]:
    """``("tenantA=100", "tenantB=0")`` -> {"tenantA": 100, ...}.
    0 means unlimited for that tenant."""
    out: dict[str, int] = {}
    for spec in specs or ():
        name, sep, limit = str(spec).rpartition("=")
        if not sep or not name:
            raise ValueError(
                f"bad tenant override {spec!r} (want tenant=limit)")
        out[name] = int(limit)
    return out


class TenantLimiter:
    """Admission-side limit policy over a TenantAccountant's counts."""

    def __init__(self, max_series: int = 0, global_max: int = 0,
                 mode: str = "enforce",
                 overrides: dict[str, int] | None = None) -> None:
        if mode not in MODES:
            raise ValueError(f"tenant_limit_mode must be one of "
                             f"{MODES}, got {mode!r}")
        self.max_series = int(max_series)
        self.global_limit = int(global_max)
        self.mode = mode
        self.overrides = dict(overrides or {})
        self._warned: set[str] = set()

    @property
    def enabled(self) -> bool:
        return bool(self.max_series or self.global_limit
                    or any(self.overrides.values()))

    def limit_for(self, tenant: str) -> int:
        """The series cap governing one tenant; 0 = unlimited."""
        if tenant in self.overrides:
            return self.overrides[tenant]
        return self.max_series

    def admit_new_series(self, accountant, tenant: str) -> None:
        """Gate one NEW series for ``tenant``. Raises TenantLimitError
        (enforce mode) when the tenant's or the global budget is
        spent; warn mode records + logs instead. Existing series never
        reach this — the caller checks the seen-set first."""
        if not self.enabled:
            return
        if os.environ.get("TSDB_TENANT_BUG") == "no-limit":
            # The harness's gate: a disabled limiter must be caught by
            # the harness, not discovered as an out-of-memory.
            return
        warn = self.mode == "warn"
        limit = self.limit_for(tenant)
        if limit and accountant.count(tenant) >= limit:
            accountant.record_refusal(tenant, warn)
            if warn:
                self._log_once(tenant,
                               f"tenant {tenant!r} would exceed its "
                               f"series limit {limit} (warn mode)")
                return
            raise TenantLimitError(tenant, limit,
                                   accountant.count(tenant))
        if (self.global_limit
                and accountant.total_tracked() >= self.global_limit):
            accountant.record_refusal(tenant, warn)
            if warn:
                self._log_once("(global)",
                               f"global series limit "
                               f"{self.global_limit} would be "
                               f"exceeded (warn mode)")
                return
            raise TenantLimitError(tenant, self.global_limit,
                                   accountant.total_tracked(),
                                   scope="global")

    def _log_once(self, key: str, msg: str) -> None:
        if key not in self._warned:
            self._warned.add(key)
            LOG.warning(msg)
