"""Cluster write tier: the epoch fence of a failover-able writer.

Mirrors ``opentsdb_tpu/cluster/`` of the JAX package, copied rather than
imported. ``epoch`` is the ownership protocol: a monotonically
increasing writer epoch persisted next to the WAL (``EPOCH.json``,
atomic write + rename), stamped into WAL segment headers
(``storage/kv.py`` ``_OP_EPOCH``), so a deposed zombie writer's appends
are refused on replay and every mutation on a superseded writer raises
``FencedWriterError`` (core/errors.py).

Not ported yet (ROADMAP queue A item 10b): ``ownership`` (the
multi-writer shard map) and ``promote`` (the router-side
``PromotionManager``).
"""

from opentsdb_tpu_torch.cluster.epoch import (EpochConflictError,
                                              EpochGuard, bump_epoch,
                                              epoch_path_for_wal,
                                              read_epoch, write_epoch)

__all__ = ["EpochConflictError", "EpochGuard", "bump_epoch",
           "epoch_path_for_wal", "read_epoch", "write_epoch"]
