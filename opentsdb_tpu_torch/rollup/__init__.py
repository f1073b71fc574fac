"""Materialized multi-resolution rollup tier (summaries + planner).

Mirrors ``opentsdb_tpu/rollup/`` of the JAX package:

- summary.py: record format, batched window reductions, sketch columns,
  and the device checkpoint fold over ``ops/rollup_fold.py``
- delta.py:   ingest-time delta accumulators for the checkpoint fold
- tier.py:    per-shard persistence, checkpoint fold, catch-up daemon
- planner.py: query-side resolution pick + raw-edge stitching
"""

from opentsdb_tpu_torch.rollup.summary import (  # noqa: F401
    EXACT_DSAGGS, REC_DTYPE)
