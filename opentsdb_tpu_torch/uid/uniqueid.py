"""Bidirectional name <-> fixed-width-id dictionary over the uid table.

Mirrors ``opentsdb_tpu/uid/uniqueid.py`` of the JAX package, copied rather
than imported: the port imports nothing of that package.

Schema parity with reference src/uid/UniqueId.java: forward mapping is
row=name, family 'id', qualifier=kind -> uid bytes; reverse mapping is
row=uid, family 'name', qualifier=kind -> name; the allocation counter lives
in row b"\\x00", family 'id', qualifier=kind (:47-53).

Allocation follows the same lock-free discipline (:227-356): atomic-increment
the MAXID cell, check the id fits the width, CAS the *reverse* mapping into
existence first (a dangling reverse mapping is harmless; a forward mapping
without reverse is not), then CAS the forward mapping — the loser of a
concurrent race leaks one id and retries, discovering the winner's id.

The cache counters (``cache_hits``, ``cache_misses``, ``cache_size``),
``suggest`` and ``drop_caches`` feed ``/stats``, ``/suggest`` and
``dropcaches`` as in the JAX package; ``rename`` is ``tsdb uid rename``.
"""

from __future__ import annotations

import struct
import threading

from opentsdb_tpu_torch.core.errors import NoSuchUniqueId, NoSuchUniqueName
from opentsdb_tpu_torch.storage.kv import KVStore

ID_FAMILY = b"id"
NAME_FAMILY = b"name"
MAXID_ROW = b"\x00"
MAX_ATTEMPTS_ASSIGN_ID = 3
MAX_SUGGESTIONS = 25
# Bound on cache entries a suggest scan adds: a scan over a huge UID set
# must not grow the caches for good (lookup-path entries stay unbounded:
# they are sized by the series the daemon serves).
SCAN_CACHE_MAX = 65536

class UniqueId:
    """One UID dictionary of a given kind ('metrics' | 'tagk' | 'tagv')."""

    def __init__(self, store: KVStore, table: str, kind: str,
                 width: int = 3) -> None:
        if not kind:
            raise ValueError("empty kind")
        if not 1 <= width <= 8:
            raise ValueError(f"invalid width: {width}")
        self._store = store
        self._table = table
        self._kind = kind
        self._kindb = kind.encode("iso-8859-1")
        self._width = width
        # name -> id and id -> name caches; immutable mappings so stale
        # entries are impossible (reference UniqueId.java:73-83).
        self._id_cache: dict[str, bytes] = {}
        self._name_cache: dict[bytes, str] = {}
        self.cache_hits = 0
        self.cache_misses = 0
        self._lock = threading.Lock()

    def kind(self) -> str:
        return self._kind

    def cache_size(self) -> int:
        return len(self._id_cache) + len(self._name_cache)

    def drop_caches(self) -> None:
        self._id_cache.clear()
        self._name_cache.clear()

    # -- lookups ----------------------------------------------------------

    def get_name(self, uid: bytes) -> str:
        """id -> name, raising NoSuchUniqueId when absent."""
        if len(uid) != self._width:
            raise ValueError(
                f"wrong id.length = {len(uid)} which is != {self._width} "
                f"required for '{self._kind}'")
        name = self._name_cache.get(uid)
        if name is not None:
            self.cache_hits += 1
            return name
        self.cache_misses += 1
        cells = self._store.get(self._table, uid, NAME_FAMILY)
        for c in cells:
            if c.qualifier == self._kindb:
                name = c.value.decode("iso-8859-1")
                self._name_cache[uid] = name
                self._id_cache.setdefault(name, uid)
                return name
        raise NoSuchUniqueId(self._kind, uid)

    def get_id(self, name: str) -> bytes:
        """name -> id, raising NoSuchUniqueName when absent."""
        uid = self._id_cache.get(name)
        if uid is not None:
            self.cache_hits += 1
            return uid
        self.cache_misses += 1
        cells = self._store.get(self._table, name.encode("iso-8859-1"),
                                ID_FAMILY)
        for c in cells:
            if c.qualifier == self._kindb:
                uid = c.value
                if len(uid) != self._width:
                    raise IllegalStateError(
                        f"Found id.length = {len(uid)} which is != "
                        f"{self._width} required for '{self._kind}'")
                self._id_cache[name] = uid
                self._name_cache.setdefault(uid, name)
                return uid
        raise NoSuchUniqueName(self._kind, name)

    # -- allocation -------------------------------------------------------

    def get_or_create_id(self, name: str) -> bytes:
        """Lookup-or-allocate with the reverse-then-forward CAS discipline."""
        attempt = MAX_ATTEMPTS_ASSIGN_ID
        while attempt > 0:
            attempt -= 1
            try:
                return self.get_id(name)
            except NoSuchUniqueName:
                pass
            with self._lock:
                new_id = self._store.atomic_increment(
                    self._table, MAXID_ROW, ID_FAMILY, self._kindb)
                row = struct.pack(">q", new_id)
                if any(row[: 8 - self._width]):
                    raise IllegalStateError(
                        f"All Unique IDs for {self._kind} on {self._width} "
                        "bytes are already assigned!")
                row = row[8 - self._width:]
                # Reverse mapping first (see module docstring).
                if not self._store.compare_and_set(
                        self._table, row, NAME_FAMILY, self._kindb, None,
                        name.encode("iso-8859-1")):
                    # Freshly allocated id already mapped: corruption; the
                    # reference logs and proceeds, we do the same.
                    pass
                if not self._store.compare_and_set(
                        self._table, name.encode("iso-8859-1"), ID_FAMILY,
                        self._kindb, None, row):
                    # Lost the allocation race: the id is leaked; retry to
                    # discover the winner's id.
                    continue
                self._id_cache[name] = row
                self._name_cache[row] = name
                return row
        raise IllegalStateError(
            f"Failed to assign an ID for kind='{self._kind}' name='{name}'")

    # -- admin ------------------------------------------------------------

    def suggest(self, prefix: str, limit: int = MAX_SUGGESTIONS) -> list[str]:
        """Names starting with ``prefix``, ordered, capped (reference
        UniqueId.suggest :367-406). An empty prefix scans the printable
        range [b'!', b'~'] like the reference's START_ROW/END_ROW."""
        if prefix:
            start = prefix.encode("iso-8859-1")
            # The smallest key above every key with this prefix: bump the
            # last byte below 0xFF, dropping trailing 0xFFs; an all-0xFF
            # prefix has no upper bound (an open-ended scan).
            stop = start.rstrip(b"\xff")
            stop = stop[:-1] + bytes([stop[-1] + 1]) if stop else b""
        else:
            start, stop = b"!", b"~"
        out: list[str] = []
        for key, items in self._store.scan_raw(self._table, start, stop,
                                               family=ID_FAMILY):
            for qual, uid in items:
                if qual == self._kindb:
                    name = key.decode("iso-8859-1")
                    # Warm the caches, bounded.
                    if len(self._id_cache) < SCAN_CACHE_MAX:
                        self._id_cache.setdefault(name, uid)
                        self._name_cache.setdefault(uid, name)
                    out.append(name)
                    if len(out) >= limit:
                        return out
        return out

    def rename(self, oldname: str, newname: str) -> None:
        """Admin rename (``tsdb uid rename``): not atomic, as in the
        reference (:425-495)."""
        row = self.get_id(oldname)
        try:
            self.get_id(newname)
        except NoSuchUniqueName:
            pass
        else:
            raise ValueError(
                f"An ID is already assigned to: '{newname}'")
        self._store.put(self._table, row, NAME_FAMILY, self._kindb,
                        newname.encode("iso-8859-1"))
        self._store.put(self._table, newname.encode("iso-8859-1"),
                        ID_FAMILY, self._kindb, row)
        self._store.delete(self._table, oldname.encode("iso-8859-1"),
                           ID_FAMILY, [self._kindb])
        with self._lock:
            self._id_cache.pop(oldname, None)
            self._id_cache[newname] = row
            self._name_cache[row] = newname

    def __str__(self) -> str:
        return f"UniqueId(table={self._table}, kind={self._kind})"


class IllegalStateError(RuntimeError):
    """Unrecoverable UID-table inconsistency (id overflow, width mismatch)."""
