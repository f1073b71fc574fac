"""The serve tier: admission control and the replica's WAL tailer.

Mirrors ``opentsdb_tpu/serve/__init__.py`` of the JAX package, whose
imports this keeps, so a daemon registers the tailer's ``replica.*``
instruments as the JAX daemon does:

- ``admission``: per-tenant token buckets and a bounded ingest queue
  (the ingest half; the query half comes with ROADMAP item 10b);
- ``tailer.WalTailer``: a read-only replica's continuous WAL tail with a
  measured, bounded staleness contract.

Not ported yet (item 10b): ``router``.
"""

from opentsdb_tpu_torch.serve.admission import (AdmissionController,
                                                TokenBucket)
from opentsdb_tpu_torch.serve.tailer import WalTailer

__all__ = ["AdmissionController", "TokenBucket", "WalTailer"]
