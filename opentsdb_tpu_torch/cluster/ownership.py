"""``CLUSTER.json``: the multi-writer ownership map.

Mirrors ``opentsdb_tpu/cluster/ownership.py`` of the JAX package, copied
rather than imported: ``slot_of``, ``OwnershipMap`` and the
``cluster.handoff.commit`` fault point, and ``CLUSTER.json`` written byte
for byte as the JAX package writes it, so each package loads the other's.

``SHARDS.json`` pins how a SINGLE writer partitions rows across its
local shard stores; this file generalizes the same idea one level up —
how the CLUSTER partitions series across N writer processes. The
series-hash space is cut into ``slots`` fixed slots (crc32 of the
metric name, the same chain ``storage/sharded`` routing and the TSST3
series blooms derive from), each slot owned by exactly one writer.

The map is **versioned by an epoch**: every mutation (handoff,
membership change) bumps it, and the router stamps the epoch into its
result-cache keys, so a cached answer can never outlive the ownership
layout it was computed under.

Handoff is drain-then-transfer: the single ingest door (the router)
drains its in-flight forwards to the old owner, then commits the
ownership flip as one atomic map write (``cluster.handoff.commit``
faultpoint brackets it). The old owner KEEPS the history it already
holds — the map records every writer that ever owned a slot
(``history``), and reads fan to all of them and merge, which is what
keeps queries byte-identical across the split without moving a byte
of sstable data.
"""

from __future__ import annotations

import json
import os
import zlib

from opentsdb_tpu_torch.fault.faultpoints import fire as _fault

CLUSTER_NAME = "CLUSTER.json"
DEFAULT_SLOTS = 64


def slot_of(name: bytes, slots: int) -> int:
    """The ownership slot for a series/metric name: the same crc32
    chain as ``sstable.series_hash`` — routing must be identical
    across processes, restarts, and builds (never ``hash()``)."""
    return zlib.crc32(name) % slots


class OwnershipMap:
    """In-memory view of ``CLUSTER.json`` + the mutation protocol."""

    def __init__(self, writers: list[str], slots: int = DEFAULT_SLOTS,
                 epoch: int = 1, assign: list[int] | None = None,
                 history: list[list[int]] | None = None) -> None:
        if not writers:
            raise ValueError("ownership map needs at least one writer")
        if slots < 1:
            raise ValueError(f"slots must be >= 1, got {slots}")
        self.writers = [w.rstrip("/") for w in writers]
        self.slots = int(slots)
        self.epoch = int(epoch)
        n = len(self.writers)
        if assign is None:
            # Equal contiguous split: slot s belongs to writer
            # s * n // slots — deterministic, and a 2-writer map is
            # exactly "low half / high half" of hash space.
            assign = [s * n // slots for s in range(slots)]
        if len(assign) != slots:
            raise ValueError(f"assign has {len(assign)} entries for "
                             f"{slots} slots")
        for idx in assign:
            if not 0 <= idx < n:
                raise ValueError(f"slot owner {idx} out of range for "
                                 f"{n} writers")
        self.assign = list(assign)
        if history is None:
            history = [[idx] for idx in self.assign]
        self.history = [list(h) for h in history]

    # -- lookups -----------------------------------------------------------

    def owner(self, name: bytes) -> int:
        """Index of the writer that owns NEW points for ``name``."""
        return self.assign[slot_of(name, self.slots)]

    def owner_url(self, name: bytes) -> str:
        return self.writers[self.owner(name)]

    def readers(self, name: bytes) -> list[int]:
        """Every writer index holding data for ``name``'s slot —
        current owner FIRST (it has the newest points and the warmest
        cache), then prior owners from the handoff history."""
        s = slot_of(name, self.slots)
        cur = self.assign[s]
        return [cur] + [i for i in self.history[s] if i != cur]

    def snapshot(self) -> dict:
        return {"version": 1, "epoch": self.epoch,
                "slots": self.slots, "writers": list(self.writers),
                "assign": list(self.assign),
                "history": [list(h) for h in self.history]}

    # -- mutation ----------------------------------------------------------

    def transfer(self, slot: int, to: int) -> None:
        """Flip one slot's ownership and bump the map epoch. The
        caller (the router's handoff endpoint) owns the drain step;
        this is the commit."""
        if not 0 <= slot < self.slots:
            raise ValueError(f"slot {slot} out of range "
                             f"(0..{self.slots - 1})")
        if not 0 <= to < len(self.writers):
            raise ValueError(f"writer index {to} out of range for "
                             f"{len(self.writers)} writers")
        old = self.assign[slot]
        self.assign[slot] = to
        if to not in self.history[slot]:
            self.history[slot].append(to)
        if old not in self.history[slot]:
            self.history[slot].append(old)
        self.epoch += 1

    # -- persistence -------------------------------------------------------

    def save(self, path: str) -> None:
        """The ``SHARDS.json`` atomic discipline: tmp + fsync +
        replace + dir fsync. The ``cluster.handoff.commit`` faultpoint
        sits between the durable tmp and the replace — a crash there
        loses the handoff but never tears the map."""
        parent = os.path.dirname(os.path.abspath(path))
        os.makedirs(parent, exist_ok=True)
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(self.snapshot(), f)
            f.flush()
            os.fsync(f.fileno())
        _fault("cluster.handoff.commit", tmp)
        os.replace(tmp, path)
        dfd = os.open(parent, os.O_RDONLY)
        try:
            os.fsync(dfd)
        finally:
            os.close(dfd)

    @classmethod
    def load(cls, path: str) -> "OwnershipMap":
        with open(path) as f:
            rec = json.load(f)
        if rec.get("version", 1) != 1:
            raise ValueError(f"unknown cluster-map version "
                             f"{rec.get('version')!r} at {path!r}")
        return cls(writers=list(rec["writers"]),
                   slots=int(rec["slots"]),
                   epoch=int(rec["epoch"]),
                   assign=list(rec["assign"]),
                   history=[list(h) for h in rec["history"]])
