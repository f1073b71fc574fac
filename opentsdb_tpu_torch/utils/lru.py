"""Small thread-safe bounded LRU — the one cache-eviction policy shared
by the query executor's resident-window caches.

Mirrors ``opentsdb_tpu/utils/lru.py`` of the JAX package (the port
imports nothing of that package), trimmed to what the executor calls:
get, put, pop and keys. It evicts least-recently-USED entries one at a
time, bounded by entry count (the JAX package's optional cost bound has
no caller here).

Built on dict's insertion order (re-inserting on access moves the entry
to the back); a lock makes the multi-step get/put sequences safe from
the server's worker threads.
"""

from __future__ import annotations

import threading
from typing import Any, Hashable, Iterable


class LRUCache:
    def __init__(self, max_entries: int) -> None:
        if max_entries < 1:
            raise ValueError(f"max_entries must be >= 1: {max_entries}")
        self.max_entries = max_entries
        self._d: dict[Hashable, Any] = {}
        self._lock = threading.Lock()

    def get(self, key: Hashable, default: Any = None) -> Any:
        """Fetch and mark most-recently-used."""
        with self._lock:
            if key not in self._d:
                return default
            value = self._d.pop(key)
            self._d[key] = value
            return value

    def put(self, key: Hashable, value: Any) -> None:
        """Insert/replace, then evict the oldest entries down to the
        bound."""
        with self._lock:
            self._d.pop(key, None)
            self._d[key] = value
            while len(self._d) > self.max_entries:
                del self._d[next(iter(self._d))]

    def pop(self, key: Hashable, default: Any = None) -> Any:
        with self._lock:
            return self._d.pop(key, default)

    def keys(self) -> Iterable[Hashable]:
        """Snapshot of the current keys (safe to mutate while
        iterating the snapshot)."""
        with self._lock:
            return list(self._d)
