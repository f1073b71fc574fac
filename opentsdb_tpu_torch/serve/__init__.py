"""The serve tier: admission control, the replica's WAL tailer, the router.

Mirrors ``opentsdb_tpu/serve/__init__.py`` of the JAX package, whose
imports this keeps, so a daemon registers the tailer's ``replica.*``
instruments as the JAX daemon does:

- ``admission``: per-tenant token buckets, a bounded ingest queue and the
  query load-shedding ladder (429 / 503 + Retry-After, and the
  rollup-only degraded step between them);
- ``tailer.WalTailer``: a read-only replica's continuous WAL tail with a
  measured, bounded staleness contract;
- ``router.RouterServer``: the storage-free front door that fans ``/q``
  across replicas by series-hash ownership with per-hop deadlines,
  retries on another replica, hedged requests, ejection and readmission
  by ``/healthz`` probes, and writer failover (``cluster/promote.py``).
  Imported by name, as in the JAX package (``tsd --role router``).
"""

from opentsdb_tpu_torch.serve.admission import (AdmissionController,
                                                TokenBucket)
from opentsdb_tpu_torch.serve.tailer import WalTailer

__all__ = ["AdmissionController", "TokenBucket", "WalTailer"]
