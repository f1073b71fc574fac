"""Writer-epoch persistence + the zombie fence.

Mirrors ``opentsdb_tpu/cluster/epoch.py`` of the JAX package, copied
rather than imported; ``EPOCH.json`` is written byte for byte as the JAX
package writes it, so either package reads and bumps the other's.

The single source of ownership truth is ``EPOCH.json``, living next to
the WAL (store directory root for sharded stores, a ``<wal>.epoch.json``
sibling for single-file stores) and written with the same atomic
discipline as ``SHARDS.json``: tmp + fsync + ``os.replace`` + directory
fsync. It holds one monotonically increasing integer, the writer epoch,
plus the owner label that last bumped it.

Three cooperating mechanisms make a deposed writer harmless:

1. **The on-disk bump** (``bump_epoch``): promotion is a compare-and-set
   on the persisted epoch. A concurrent promotion loses loudly
   (``EpochConflictError``), never silently.
2. **The fence check** (``EpochGuard``): the writer re-reads the epoch
   file on a short stat cadence from every mutation entry point and
   from ``checkpoint()``. A persisted epoch above its own means it has
   been deposed: every further mutation raises ``FencedWriterError``
   and the guard stays tripped.
3. **The WAL segment header** (``storage/kv.py`` ``_OP_EPOCH``): every
   WAL segment a cluster-mode writer opens begins with its epoch.
   Replay refuses any segment whose header epoch is LOWER than one
   already replayed: a stale writer's segment concatenated after a
   newer writer's is cut off at the fence line instead of applied.

Fault points ``cluster.epoch.write`` (the tmp file written, before the
replace) and ``cluster.epoch.commit`` (after the replace) sit where the
JAX package's do. Its ``TSDB_CLUSTER_BUG=split-brain`` sabotage switch is
not ported (ROADMAP queue A item 10b).
"""

from __future__ import annotations

import fcntl
import json
import os
import time

from opentsdb_tpu_torch.core.errors import FencedWriterError
from opentsdb_tpu_torch.fault.faultpoints import fire as _fault

EPOCH_NAME = "EPOCH.json"


class EpochConflictError(Exception):
    """A compare-and-set epoch bump lost a race (or the file moved
    under the caller): the expected epoch no longer matches disk."""


def epoch_path_for_wal(wal_path: str, is_dir: bool | None = None) -> str:
    """Where the epoch file lives for a store rooted at ``wal_path``.

    A sharded store's ``--wal`` is its directory (``SHARDS.json``
    inside); the epoch is cluster-wide, so it sits at the root next to
    the manifest. A single store's ``--wal`` is the WAL file itself; the
    epoch is a sibling (the ``<wal>.sketches`` precedent). ``is_dir``
    overrides the on-disk probe: a first boot may not have created the
    directory yet.
    """
    if is_dir if is_dir is not None else os.path.isdir(wal_path):
        return os.path.join(wal_path, EPOCH_NAME)
    return wal_path + ".epoch.json"


def read_epoch(path: str) -> tuple[int, str | None]:
    """(epoch, owner) from ``path``; (0, None) when the file does not
    exist: epoch 0 is the pre-cluster state every legacy WAL is in."""
    try:
        with open(path) as f:
            rec = json.load(f)
    except FileNotFoundError:
        return 0, None
    if rec.get("version", 1) != 1:
        raise ValueError(f"unknown epoch-file version "
                         f"{rec.get('version')!r} at {path!r}")
    return int(rec["epoch"]), rec.get("owner")


def write_epoch(path: str, epoch: int, owner: str | None = None) -> None:
    """Atomically persist ``epoch`` (tmp + fsync + replace + directory
    fsync, so a crash leaves either the old epoch or the new one, never a
    torn file)."""
    if epoch < 1:
        raise ValueError(f"writer epoch must be >= 1, got {epoch}")
    parent = os.path.dirname(os.path.abspath(path))
    os.makedirs(parent, exist_ok=True)
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump({"version": 1, "epoch": int(epoch),
                   "owner": owner,
                   "bumped_at": int(time.time())}, f)
        f.flush()
        os.fsync(f.fileno())
    # A crash here leaves a stray tmp (ignored by every reader) and the
    # OLD epoch: a promotion that dies at this point never happened.
    _fault("cluster.epoch.write", tmp)
    os.replace(tmp, path)
    dfd = os.open(parent, os.O_RDONLY)
    try:
        os.fsync(dfd)
    finally:
        os.close(dfd)
    # The replace landed: a raise here exercises the callers' handling
    # of a bump that may or may not have stuck (both states consistent).
    _fault("cluster.epoch.commit", path)


def bump_epoch(path: str, owner: str | None = None,
               expect: int | None = None) -> int:
    """Compare-and-set increment: read the persisted epoch, verify it
    still matches ``expect`` (when given), write epoch + 1. Returns the
    NEW epoch.

    The read-check-write runs under an exclusive flock on
    ``<path>.lock``, so two concurrent bumps serialize: the loser
    re-reads the winner's epoch and either conflicts loudly (``expect``
    mismatch, ``EpochConflictError``) or bumps past it; two writers can
    never mint the same epoch. The flock is advisory and per host, like
    every other lock in the engine."""
    parent = os.path.dirname(os.path.abspath(path))
    os.makedirs(parent, exist_ok=True)
    lockfd = os.open(path + ".lock", os.O_CREAT | os.O_RDWR, 0o644)
    try:
        fcntl.flock(lockfd, fcntl.LOCK_EX)  # bumps are rare: block
        current, _ = read_epoch(path)
        if expect is not None and current != expect:
            raise EpochConflictError(
                f"epoch moved under the bump: expected {expect}, "
                f"disk has {current} ({path})")
        new = current + 1
        write_epoch(path, new, owner=owner)
        return new
    finally:
        os.close(lockfd)


class EpochGuard:
    """The writer-side fence: ``check()`` raises ``FencedWriterError``
    once the persisted epoch exceeds the epoch this writer owns.

    Called from every mutation entry point (``_check_writable``) and from
    ``checkpoint()``, the two places a zombie does damage: acks and WAL
    rotation. The guard re-stats at most every ``interval_s`` (default
    50 ms) and trusts the on-disk header fence and the fresh-inode
    rotation for the sub-interval window.

    Once tripped, the guard stays tripped: a deposed writer must not
    flicker back to acking between stats (``reset()`` exists for the
    promote path, which re-reads ownership deliberately).
    """

    def __init__(self, path: str, epoch: int,
                 interval_s: float = 0.05) -> None:
        self.path = path
        self.epoch = int(epoch)
        self.interval_s = float(interval_s)
        self.fenced = False
        self.fenced_epoch = 0      # the epoch that deposed us
        self._next_check = 0.0
        self._last_stat: tuple | None = None

    def _raise(self) -> None:
        raise FencedWriterError(
            f"writer epoch {self.epoch} superseded by "
            f"{self.fenced_epoch} ({self.path}); this process is "
            f"no longer the writer", self.epoch, self.fenced_epoch)

    def check(self, force: bool = False) -> None:
        """Raise if this writer has been deposed. Cheap when recently
        checked; one ``os.stat`` otherwise, one read when the file
        changed. ``force`` bypasses the stat cadence: checkpoint rotation
        and the manifest commit must see the CURRENT epoch."""
        if self.fenced:
            self._raise()
        now = time.monotonic()
        if not force and now < self._next_check:
            return
        self._next_check = now + self.interval_s
        try:
            st = os.stat(self.path)
            sig = (st.st_ino, st.st_mtime_ns, st.st_size)
        except OSError:
            return  # no epoch file (yet): nothing to be deposed by
        if sig == self._last_stat:
            return
        self._last_stat = sig
        try:
            current, _ = read_epoch(self.path)
        except (OSError, ValueError, KeyError):
            return  # torn/foreign file: the atomic writer never leaves
            #         one; don't fence on garbage
        if current > self.epoch:
            self.fenced = True
            self.fenced_epoch = current
            self._raise()

    def reset(self, epoch: int) -> None:
        """Adopt a new owned epoch (the promote path re-arms its own
        guard; a demoted daemon discards the guard entirely)."""
        self.epoch = int(epoch)
        self.fenced = False
        self.fenced_epoch = 0
        self._next_check = 0.0
        self._last_stat = None
