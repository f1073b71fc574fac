"""End-to-end observability: metrics registry, trace spans, slow-query
log, self-monitoring.

Mirrors ``opentsdb_tpu/obs/`` of the JAX package, with its contract:
observability is close to free when idle.

- ``registry``: the process-wide metrics registry (counters, gauges,
  LatencyDigest-backed timers). Engine modules register their
  instruments at import time; exports flow into both the classic
  ``/stats`` line format and the Prometheus text ``/metrics`` endpoint.
- ``trace``: per-query span trees threaded through the executor and
  the storage fan-out. With no trace active every hot-path hook is one
  global integer check.
- ``ring``: the bounded trace ring behind ``/api/traces`` plus the
  one-line-JSON slow-query log (``Config.slow_query_ms``).
- ``selfmon``: the reference's own pattern (src/stats/: the TSDB
  monitors itself): a background loop snapshots the ``/stats`` lines
  and ingests them into the store as ``tsd.*`` series, queryable
  through ``/q`` like any other metric.
"""

from opentsdb_tpu_torch.obs.registry import (  # noqa: F401
    METRICS, MetricsRegistry)
