"""Garbage-collector tuning for sustained ingest.

Mirrors ``opentsdb_tpu/utils/gctune.py`` of the JAX package. The
memtable holds millions of long-lived container objects (one dict per
row-hour plus key bytes), and CPython's generational collector rescans
them on every gen2 pass; none of it is reclaimable: the memtable is
alive by design until a checkpoint spills it.

``tune_for_ingest`` moves the current heap (the replayed WAL, the loaded
sstable index, the warmed window's host side, the interpreter) into the
permanent generation and pushes gen2 passes far out. This is safe for
this workload shape:

- the storage structures are acyclic (dicts/lists/bytes), so ordinary
  refcounting reclaims them when a checkpoint or delete drops them —
  freezing only exempts them from CYCLE detection;
- cycles created after the call still get collected — collection stays
  enabled, just less often;
- a higher gen0 threshold trades a little young-object latency for far
  fewer passes over the large old heap.

Call it once at daemon start-up after the store is open (so the replayed
state lands in the permanent generation). ``gc.freeze`` is process-wide.
"""

from __future__ import annotations

import gc

# (gen0 allocations, gen1 passes, gen2 passes) — gen2 ~50x rarer than
# default. gen0 at 50k keeps young-gen passes cheap without letting
# true garbage pile up between them.
_INGEST_THRESHOLDS = (50_000, 20, 50)


def tune_for_ingest() -> None:
    """Freeze the live heap out of cycle collection and raise the
    collection thresholds for ingest-heavy processes."""
    gc.collect()
    gc.freeze()
    gc.set_threshold(*_INGEST_THRESHOLDS)
