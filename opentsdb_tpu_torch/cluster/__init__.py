"""Cluster write tier: the epoch fence, failover and the ownership map.

Mirrors ``opentsdb_tpu/cluster/`` of the JAX package, copied rather than
imported:

- ``epoch``: the ownership protocol. A monotonically increasing writer
  epoch persisted next to the WAL (``EPOCH.json``, atomic write +
  rename), stamped into WAL segment headers (``storage/kv.py``
  ``_OP_EPOCH``), so a deposed zombie writer's appends are refused on
  replay and every mutation on a superseded writer raises
  ``FencedWriterError`` (core/errors.py).
- ``promote``: the router-side failover manager (``PromotionManager``):
  when the writer's ``/healthz`` stays dead past a grace, a healthy
  replica is asked to ``/promote`` and ingest forwarding flips to it; a
  deposed writer that returns is ``/demote``-d back to tailing.
- ``ownership``: the multi-writer shard map (``CLUSTER.json``): series-hash
  slots to writers, versioned by an epoch the router consults for ingest
  and read fan-out.

The epoch names below load on first use (PEP 562), not with the package:
the router imports ``ownership`` and ``promote`` and must not load the
storage engine's ``core/`` with them.
"""

import importlib

__all__ = ["EpochConflictError", "EpochGuard", "OwnershipMap", "bump_epoch",
           "epoch_path_for_wal", "read_epoch", "write_epoch"]

_LAZY = {"OwnershipMap": "opentsdb_tpu_torch.cluster.ownership"}


def __getattr__(name):
    if name not in __all__:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    mod = importlib.import_module(
        _LAZY.get(name, "opentsdb_tpu_torch.cluster.epoch"))
    return getattr(mod, name)
