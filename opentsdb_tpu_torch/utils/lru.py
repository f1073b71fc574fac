"""Small thread-safe bounded LRU — the one cache-eviction policy shared
by the query executor's caches.

Mirrors ``opentsdb_tpu/utils/lru.py`` of the JAX package (the port
imports nothing of that package). It evicts least-recently-USED entries
one at a time, bounded by entry count and, optionally, by a
caller-supplied cost total: the fragment cache bounds by cached POINT
count, since fragments vary from a few hundred bytes to megabytes.

Built on dict's insertion order (re-inserting on access moves the entry
to the back); a lock makes the multi-step get/put sequences safe from
the server's worker threads.
"""

from __future__ import annotations

import threading
from typing import Any, Hashable, Iterable


class LRUCache:
    def __init__(self, max_entries: int,
                 max_cost: int | None = None) -> None:
        if max_entries < 1:
            raise ValueError(f"max_entries must be >= 1: {max_entries}")
        self.max_entries = max_entries
        self.max_cost = max_cost
        self._d: dict[Hashable, tuple[Any, int]] = {}
        self._cost = 0
        self._lock = threading.Lock()
        self.evictions = 0

    def get(self, key: Hashable, default: Any = None) -> Any:
        """Fetch and mark most-recently-used."""
        with self._lock:
            ent = self._d.get(key)
            if ent is None:
                return default
            del self._d[key]
            self._d[key] = ent
            return ent[0]

    def peek(self, key: Hashable, default: Any = None) -> Any:
        """Fetch WITHOUT touching recency."""
        with self._lock:
            ent = self._d.get(key)
            return default if ent is None else ent[0]

    def put(self, key: Hashable, value: Any, cost: int = 1) -> None:
        """Insert/replace, then evict oldest entries until both bounds
        hold. An entry costlier than the whole budget is simply not
        cached (caching it would flush everything else for one entry
        that can never amortize)."""
        if self.max_cost is not None and cost > self.max_cost:
            self.pop(key)
            return
        with self._lock:
            old = self._d.pop(key, None)
            if old is not None:
                self._cost -= old[1]
            self._d[key] = (value, cost)
            self._cost += cost
            self._evict_locked()

    def resize(self, max_entries: int,
               max_cost: int | None = None) -> None:
        """Rebound the cache IN PLACE (evicting oldest entries down to
        the new limits): callers that share one cache instance keep
        their reference valid across a config change."""
        if max_entries < 1:
            raise ValueError(f"max_entries must be >= 1: {max_entries}")
        with self._lock:
            self.max_entries = max_entries
            self.max_cost = max_cost
            self._evict_locked()

    def _evict_locked(self) -> None:
        while len(self._d) > self.max_entries or (
                self.max_cost is not None and self._cost > self.max_cost):
            oldest = next(iter(self._d))
            self._cost -= self._d.pop(oldest)[1]
            self.evictions += 1

    def pop(self, key: Hashable, default: Any = None) -> Any:
        with self._lock:
            ent = self._d.pop(key, None)
            if ent is None:
                return default
            self._cost -= ent[1]
            return ent[0]

    def keys(self) -> Iterable[Hashable]:
        """Snapshot of the current keys (safe to mutate while
        iterating the snapshot)."""
        with self._lock:
            return list(self._d)

    def clear(self) -> None:
        with self._lock:
            self._d.clear()
            self._cost = 0

    @property
    def cost(self) -> int:
        return self._cost

    def __len__(self) -> int:
        return len(self._d)

    def __contains__(self, key: Hashable) -> bool:
        return key in self._d
