"""Exceptions shared across the framework.

Mirrors ``opentsdb_tpu/core/errors.py`` of the JAX package, copied rather
than imported: the port imports nothing of that package.
"""


class IllegalDataError(Exception):
    """Corrupt or semantically invalid stored data.

    Raised by the codec / compaction paths on out-of-order duplicates,
    undecodable cells, or malformed values (parity with the reference's
    net.opentsdb.core.IllegalDataException).
    """


class PleaseThrottleError(Exception):
    """Backpressure signal from the storage engine.

    Parity with asynchbase's PleaseThrottleException: callers should slow
    down, switch to synchronous writes, or re-enqueue the work (reference
    CompactionQueue.java:797-808, TextImporter.java:106-126). A batched
    put that throttles part way carries the applied cells' flags as
    ``partial_existed``.
    """


class BadRequestError(Exception):
    """An HTTP 400-class client error (reference src/tsd/BadRequestException.java)."""

    def __init__(self, message: str, status: int = 400):
        super().__init__(message)
        self.status = status


class NoSuchUniqueName(Exception):
    """Name -> UID lookup failed (reference src/uid/NoSuchUniqueName.java)."""

    def __init__(self, kind: str, name: str):
        super().__init__(f"No such name for '{kind}': '{name}'")
        self.kind = kind
        self.name = name


class NoSuchUniqueId(Exception):
    """UID -> name lookup failed (reference src/uid/NoSuchUniqueId.java)."""

    def __init__(self, kind: str, uid: bytes):
        super().__init__(f"No such unique ID for '{kind}': {uid.hex()}")
        self.kind = kind
        self.id = uid


class OverloadedError(Exception):
    """The admission controller shed this request (serve/admission.py).

    Carries the Retry-After hint (seconds) and the HTTP status the
    server should answer with: 429 for a per-tenant quota breach, 503
    for process-wide load shedding.
    """

    def __init__(self, message: str, retry_after: float = 1.0,
                 status: int = 503):
        super().__init__(message)
        self.retry_after = max(float(retry_after), 0.0)
        self.status = status


class TenantLimitError(Exception):
    """A NEW series was refused by the tenant cardinality limiter
    (opentsdb_tpu_torch/tenant/limits.py).

    Declared, not transient: the telnet face is a distinct
    ``put: tenant series limit exceeded`` line and the HTTP face is a
    429 naming the limit — a collector must NOT treat this like a
    throttle and retry, because retrying a refused series can never
    succeed until the operator raises the limit (or a per-tenant
    override). The accountant is deliberately MONOTONIC — deleting
    series never lowers a tenant's count (the HLL tier cannot forget,
    and the exact tier matches it so behavior doesn't change at the
    cutoff); only a limit change, or a full storage-scan rebuild after a
    lost snapshot, moves the count down. Existing series keep ingesting.

    Subclasses Exception, NOT OSError: broad ``except OSError`` storage
    handlers must never swallow a policy refusal as a disk hiccup.
    """

    status = 429

    def __init__(self, tenant: str, limit: int, count: int,
                 scope: str = "tenant"):
        super().__init__(
            f"{'global' if scope == 'global' else f'tenant {tenant!r}'}"
            f" series limit exceeded: {count} >= {limit} "
            f"(new series refused; existing series keep ingesting)")
        self.tenant = tenant
        self.limit = limit
        self.count = count
        self.scope = scope
