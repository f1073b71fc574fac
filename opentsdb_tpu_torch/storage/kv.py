"""Ordered key-value store: in-memory memtable + append-only WAL.

Mirrors ``opentsdb_tpu/storage/kv.py`` of the JAX package, trimmed to the
memtable tier: ``KVStore`` and ``MemKVStore`` with the WAL append and
replay, batched and columnar puts, ordered scans with a row-key regexp,
and the atomic counter/CAS pair the UID tables need. The WAL record
format is byte-identical to the JAX package's, so this store opens and
replays a WAL that the JAX ``MemKVStore`` wrote (and vice versa).

Not ported yet (the JAX store's spill tier and its satellites): sstable
generations and checkpoints, sharding, bloom filters, group commit, the
cluster epoch fence, throttling and fault points. A WAL directory that
holds any of their on-disk artifacts is refused at open rather than
half-read.
"""

from __future__ import annotations

import fcntl
import os
import re
import struct
import threading
from bisect import bisect_left
from typing import Iterator, NamedTuple

import numpy as np

_REC = struct.Struct(">BI")  # op, payload length

# WAL opcodes (the JAX store's numbering).
_OP_PUT = 1
_OP_DELETE = 2
_OP_DELETE_ROW = 3
_OP_PUT_BATCH = 4   # one columnar record for a whole put_many batch
_OP_EPOCH = 5       # cluster-mode segment header (fence not ported)


class Cell(NamedTuple):
    key: bytes
    family: bytes
    qualifier: bytes
    value: bytes


class KVStore:
    """Abstract ordered-KV interface; see MemKVStore for the semantics."""

    def get(self, table: str, key: bytes,
            family: bytes | None = None) -> list[Cell]:
        raise NotImplementedError

    def put(self, table: str, key: bytes, family: bytes, qualifier: bytes,
            value: bytes, durable: bool = True) -> None:
        raise NotImplementedError

    def put_many_columnar(self, table: str, family: bytes,
                          key_blob: bytes, key_len: int,
                          quals: list[bytes], vals: list[bytes],
                          durable: bool = True) -> list[bool]:
        raise NotImplementedError

    def delete(self, table: str, key: bytes, family: bytes,
               qualifiers: list[bytes]) -> None:
        raise NotImplementedError

    def scan_raw(self, table: str, start: bytes, stop: bytes,
                 family: bytes | None = None,
                 key_regexp: bytes | None = None,
                 ) -> Iterator[tuple[bytes, list[tuple[bytes, bytes]]]]:
        raise NotImplementedError

    def atomic_increment(self, table: str, key: bytes, family: bytes,
                         qualifier: bytes, amount: int = 1) -> int:
        raise NotImplementedError

    def compare_and_set(self, table: str, key: bytes, family: bytes,
                        qualifier: bytes, expected: bytes | None,
                        value: bytes) -> bool:
        raise NotImplementedError

    def flush(self) -> None:
        raise NotImplementedError

    def ensure_table(self, table: str) -> None:
        raise NotImplementedError


def _merge_unique(a: list[bytes], b: list[bytes]) -> list[bytes]:
    """Merge two sorted unique lists into one, dropping cross-duplicates
    (a key deleted and re-inserted can appear in both runs)."""
    out: list[bytes] = []
    i = j = 0
    na, nb = len(a), len(b)
    while i < na and j < nb:
        ka, kb = a[i], b[j]
        if ka < kb:
            out.append(ka)
            i += 1
        elif kb < ka:
            out.append(kb)
            j += 1
        else:
            out.append(ka)
            i += 1
            j += 1
    out.extend(a[i:])
    out.extend(b[j:])
    return out


class _Table:
    """Row storage + an incremental sorted key index.

    The index is two sorted runs, ``base`` (large, rebuilt rarely) and
    ``delta`` (small, absorbing recent inserts), plus an unsorted
    ``pending`` set of brand-new keys: inserts are O(1), a scan absorbs
    pending into delta and folds delta into base only when delta
    outgrows ~sqrt(base). Runs may carry deleted keys; readers filter on
    ``k in rows`` and a purge rewrites the runs when those dominate.
    """

    __slots__ = ("rows", "base", "delta", "pending", "stale")

    def __init__(self) -> None:
        self.rows: dict[bytes, dict[tuple[bytes, bytes], bytes]] = {}
        self.base: list[bytes] = []
        self.delta: list[bytes] = []
        self.pending: set[bytes] = set()
        self.stale = 0  # deleted keys still present in base/delta

    def _absorb(self) -> None:
        """Fold pending inserts into delta; compact when thresholds hit.
        Caller holds the store lock."""
        if self.pending:
            new = sorted(self.pending)
            self.pending.clear()
            self.delta = _merge_unique(self.delta, new) if self.delta \
                else new
        if len(self.delta) ** 2 > max(len(self.base), 64):
            self.base = _merge_unique(self.base, self.delta)
            self.delta = []
        if self.stale * 2 > len(self.base) + len(self.delta):
            rows = self.rows
            self.base = [k for k in self.base if k in rows]
            self.delta = [k for k in self.delta if k in rows]
            self.stale = 0

    def range_keys(self, start: bytes, stop: bytes | None) -> list[bytes]:
        """Sorted live keys in [start, stop); stop falsy = to the end.
        Caller holds the store lock."""
        self._absorb()
        a, b = self.base, self.delta
        i, j = bisect_left(a, start), bisect_left(b, start)
        ahi = bisect_left(a, stop) if stop else len(a)
        bhi = bisect_left(b, stop) if stop else len(b)
        rows = self.rows
        out: list[bytes] = []
        while i < ahi and j < bhi:
            ka, kb = a[i], b[j]
            if ka < kb:
                k = ka
                i += 1
            elif kb < ka:
                k = kb
                j += 1
            else:
                k = ka
                i += 1
                j += 1
            if k in rows:
                out.append(k)
        out.extend(k for k in a[i:ahi] if k in rows)
        out.extend(k for k in b[j:bhi] if k in rows)
        return out


class MemKVStore(KVStore):
    """In-memory ordered KV with optional WAL persistence.

    Thread-safe: a single lock guards all mutation (ingest is batched above
    this layer, so lock traffic is per batch, not per point). Every
    mutation's WAL record is flushed past the userspace buffer before the
    call returns; ``flush()`` fsyncs.
    """

    # _REC frames a payload with a u32 length: batches whose blobs approach
    # that split into several _OP_PUT_BATCH records (replay applies them in
    # order, so the split is invisible).
    _WAL_BATCH_LIMIT = 1 << 30

    def __init__(self, wal_path: str | None = None) -> None:
        self._tables: dict[str, _Table] = {}
        self._lock = threading.RLock()
        self._wal_path = wal_path
        self._wal = None
        self._lockfd: int | None = None
        if not wal_path:
            return
        _refuse_unported_artifacts(wal_path)
        os.makedirs(os.path.dirname(os.path.abspath(wal_path)),
                    exist_ok=True)
        # Single-writer lock on a side file (the JAX store's convention,
        # so the two packages also exclude each other on one WAL).
        self._lockfd = os.open(wal_path + ".lock",
                               os.O_CREAT | os.O_RDWR, 0o644)
        try:
            fcntl.flock(self._lockfd, fcntl.LOCK_EX | fcntl.LOCK_NB)
        except OSError:
            os.close(self._lockfd)
            self._lockfd = None
            raise RuntimeError(
                f"WAL path {wal_path!r} is locked by another store")
        try:
            if os.path.exists(wal_path):
                valid = self._replay(wal_path)
                if valid < os.path.getsize(wal_path):
                    # Torn record at the tail (crash mid-write): truncate
                    # so appends continue from the last valid boundary.
                    with open(wal_path, "r+b") as f:
                        f.truncate(valid)
            self._wal = open(wal_path, "ab")
        except BaseException:
            os.close(self._lockfd)
            self._lockfd = None
            raise

    # -- table helpers ----------------------------------------------------

    def _table(self, name: str) -> _Table:
        t = self._tables.get(name)
        if t is None:
            t = self._tables[name] = _Table()
        return t

    def ensure_table(self, table: str) -> None:
        with self._lock:
            self._table(table)

    # -- WAL --------------------------------------------------------------

    def _wal_append(self, op: int, *parts: bytes) -> None:
        if self._wal is None:
            return
        payload = b"".join(struct.pack(">I", len(p)) + p for p in parts)
        self._wal.write(_REC.pack(op, len(payload)) + payload)
        self._wal_flush()

    def _wal_flush(self) -> None:
        # Past the userspace buffer before the mutation returns: a crash
        # of the process then loses nothing acknowledged (flush() adds the
        # fsync that survives power loss).
        self._wal.flush()

    @classmethod
    def _batch_splits(cls, cell_bytes: np.ndarray) -> list[tuple[int, int]]:
        """[(start, stop)) cell ranges whose blob bytes each fit
        _WAL_BATCH_LIMIT; one range in the common case."""
        n = len(cell_bytes)
        limit = cls._WAL_BATCH_LIMIT
        csum = np.cumsum(cell_bytes, dtype=np.int64)
        if n <= 1 or csum[-1] <= limit:
            return [(0, n)]
        out = []
        lo = base = 0
        while lo < n:
            hi = max(int(np.searchsorted(csum, base + limit, side="right")),
                     lo + 1)
            out.append((lo, hi))
            base = int(csum[hi - 1])
            lo = hi
        return out

    def _wal_append_batch_columnar(self, table: bytes, family: bytes,
                                   key_blob: bytes, n: int, key_len: int,
                                   quals: list[bytes],
                                   vals: list[bytes]) -> None:
        """One _OP_PUT_BATCH record for a whole batch: header, three >u4
        length arrays, then the key/qualifier/value blobs."""
        if self._wal is None:
            return
        ql = np.fromiter(map(len, quals), ">u4", n)
        vl = np.fromiter(map(len, vals), ">u4", n)
        for lo, hi in self._batch_splits(ql.astype(np.int64)
                                         + vl.astype(np.int64) + key_len):
            payload = b"".join((
                struct.pack(">IHH", hi - lo, len(table), len(family)),
                table, family,
                np.full(hi - lo, key_len, ">u4").tobytes(),
                ql[lo:hi].tobytes(), vl[lo:hi].tobytes(),
                key_blob[lo * key_len:hi * key_len],
                b"".join(quals[lo:hi]), b"".join(vals[lo:hi])))
            self._wal.write(_REC.pack(_OP_PUT_BATCH, len(payload))
                            + payload)
        self._wal_flush()

    @staticmethod
    def _split_payload(payload: bytes) -> list[bytes]:
        parts = []
        off = 0
        while off < len(payload):
            (n,) = struct.unpack_from(">I", payload, off)
            off += 4
            parts.append(payload[off:off + n])
            off += n
        return parts

    def _replay(self, path: str) -> int:
        """Apply every complete WAL record; returns the valid byte count."""
        valid = 0
        with open(path, "rb") as f:
            while True:
                hdr = f.read(_REC.size)
                if len(hdr) < _REC.size:
                    break  # truncated tail: stop at last complete record
                op, plen = _REC.unpack(hdr)
                payload = f.read(plen)
                if len(payload) < plen:
                    break
                valid += _REC.size + plen
                if op == _OP_PUT_BATCH:
                    self._replay_batch(payload)
                    continue
                if op == _OP_EPOCH:
                    raise RuntimeError(
                        f"WAL {path!r} carries cluster epoch headers; the "
                        f"cluster write tier is not ported yet")
                parts = self._split_payload(payload)
                table = parts[0].decode()
                if op == _OP_PUT:
                    _, key, fam, qual, value = parts
                    self._apply_put(table, key, fam, qual, value)
                elif op == _OP_DELETE:
                    _, key, fam, *quals = parts
                    self._apply_delete(table, key, fam, quals)
                elif op == _OP_DELETE_ROW:
                    _, key = parts
                    self._apply_delete_row(table, key)
                else:
                    raise RuntimeError(f"unknown WAL opcode {op} in {path!r}")
        return valid

    def _replay_batch(self, payload: bytes) -> None:
        n, tl, fl = struct.unpack_from(">IHH", payload, 0)
        off = 8
        table = payload[off:off + tl].decode()
        off += tl
        fam = payload[off:off + fl]
        off += fl
        kl = np.frombuffer(payload, ">u4", n, off).tolist()
        ql = np.frombuffer(payload, ">u4", n, off + 4 * n).tolist()
        vl = np.frombuffer(payload, ">u4", n, off + 8 * n).tolist()
        ko = off + 12 * n
        qo = ko + sum(kl)
        vo = qo + sum(ql)
        for lk, lq, lv in zip(kl, ql, vl):
            self._apply_put(table, payload[ko:ko + lk], fam,
                            payload[qo:qo + lq], payload[vo:vo + lv])
            ko += lk
            qo += lq
            vo += lv

    def flush(self) -> None:
        """Force the WAL to stable storage."""
        with self._lock:
            if self._wal is not None:
                self._wal.flush()
                os.fsync(self._wal.fileno())

    def close(self) -> None:
        with self._lock:
            try:
                if self._wal is not None:
                    try:
                        self.flush()
                    finally:
                        self._wal.close()
                        self._wal = None
            finally:
                if self._lockfd is not None:
                    os.close(self._lockfd)
                    self._lockfd = None

    # -- mutation ---------------------------------------------------------

    def _apply_put(self, table: str, key: bytes, family: bytes,
                   qualifier: bytes, value: bytes) -> None:
        t = self._table(table)
        row = t.rows.get(key)
        if row is None:
            row = t.rows[key] = {}
            t.pending.add(key)
        row[(family, qualifier)] = value

    def _apply_delete(self, table: str, key: bytes, family: bytes,
                      qualifiers: list[bytes]) -> None:
        t = self._table(table)
        row = t.rows.get(key)
        if row is None:
            return
        for q in qualifiers:
            row.pop((family, q), None)
        if not row:
            del t.rows[key]
            t.stale += 1

    def _apply_delete_row(self, table: str, key: bytes) -> None:
        t = self._table(table)
        if t.rows.pop(key, None) is not None:
            t.stale += 1

    def put(self, table: str, key: bytes, family: bytes, qualifier: bytes,
            value: bytes, durable: bool = True) -> None:
        with self._lock:
            if durable:
                self._wal_append(_OP_PUT, table.encode(), key, family,
                                 qualifier, value)
            self._apply_put(table, key, family, qualifier, value)

    def put_many_columnar(self, table: str, family: bytes,
                          key_blob: bytes, key_len: int,
                          quals: list[bytes], vals: list[bytes],
                          durable: bool = True) -> list[bool]:
        """Batched put with cell i's key the i-th ``key_len``-byte slice of
        ``key_blob``. Returns, per cell, True when the row held other
        cells by the time this one landed (it existed before the batch,
        or an earlier cell of the batch hit it) — the rows the caller must
        queue for compaction."""
        n = len(quals)
        L = key_len
        if len(vals) != n or len(key_blob) != n * L:
            # The WAL record trusts n * key_len: a mis-framed batch would
            # corrupt durable state on replay.
            raise ValueError(
                f"columnar batch mismatch: {len(key_blob)} key bytes, "
                f"key_len {L}, {n} quals, {len(vals)} vals")
        if n == 0:
            return []
        keys = [key_blob[i:i + L] for i in range(0, n * L, L)]
        with self._lock:
            t = self._table(table)
            rows = t.rows
            existed = []
            for k, q, v in zip(keys, quals, vals):
                row = rows.get(k)
                existed.append(row is not None)
                if row is None:
                    rows[k] = {(family, q): v}
                    t.pending.add(k)
                else:
                    row[(family, q)] = v
            if durable:
                self._wal_append_batch_columnar(table.encode(), family,
                                                key_blob, n, L, quals, vals)
        return existed

    def delete(self, table: str, key: bytes, family: bytes,
               qualifiers: list[bytes]) -> None:
        with self._lock:
            self._wal_append(_OP_DELETE, table.encode(), key, family,
                             *qualifiers)
            self._apply_delete(table, key, family, qualifiers)

    # -- reads ------------------------------------------------------------

    def get(self, table: str, key: bytes,
            family: bytes | None = None) -> list[Cell]:
        with self._lock:
            row = self._table(table).rows.get(key)
            if not row:
                return []
            cells = [Cell(key, f, q, v) for (f, q), v in row.items()
                     if family is None or f == family]
        cells.sort(key=lambda c: (c.family, c.qualifier))
        return cells

    def scan_raw(self, table: str, start: bytes, stop: bytes,
                 family: bytes | None = None,
                 key_regexp: bytes | None = None, chunk: int = 1024,
                 ) -> Iterator[tuple[bytes, list[tuple[bytes, bytes]]]]:
        """Rows with key in [start, stop) as (key, sorted [(qualifier,
        value), ...]), the lock taken once per ``chunk`` keys.
        ``key_regexp`` applies a DOTALL bytes regex to the whole key (the
        HBase KeyRegexpFilter the reference's tag filtering uses).

        Snapshot semantics: keys are snapshotted at call time; rows deleted
        mid-scan are skipped, rows mutated mid-scan show their new cells."""
        pattern = re.compile(key_regexp, re.S) if key_regexp else None
        with self._lock:
            keys = self._table(table).range_keys(start, stop)
        if pattern is not None:
            keys = [k for k in keys if pattern.match(k)]
        for i in range(0, len(keys), chunk):
            out = []
            with self._lock:
                rows_get = self._table(table).rows.get
                for key in keys[i:i + chunk]:
                    row = rows_get(key)
                    if not row:
                        continue
                    items = [(q, v) for (f, q), v in row.items()
                             if family is None or f == family]
                    if items:
                        items.sort()
                        out.append((key, items))
            yield from out

    # -- atomics ----------------------------------------------------------

    def atomic_increment(self, table: str, key: bytes, family: bytes,
                         qualifier: bytes, amount: int = 1) -> int:
        """Increment an 8-byte big-endian counter cell, returning the new
        value (initialized from 0 like HBase's ICV); logged as the
        absolute value so replay is idempotent."""
        with self._lock:
            row = self._table(table).rows.get(key)
            cur = row.get((family, qualifier)) if row else None
            value = (struct.unpack(">q", cur)[0] if cur else 0) + amount
            self.put(table, key, family, qualifier, struct.pack(">q", value))
        return value

    def compare_and_set(self, table: str, key: bytes, family: bytes,
                        qualifier: bytes, expected: bytes | None,
                        value: bytes) -> bool:
        """Atomic CAS: write only if the cell currently equals ``expected``
        (None = cell must not exist). Returns success."""
        with self._lock:
            row = self._table(table).rows.get(key)
            cur = row.get((family, qualifier)) if row else None
            if cur != expected:
                return False
            self.put(table, key, family, qualifier, value)
        return True


def _refuse_unported_artifacts(wal_path: str) -> None:
    """The JAX store keeps checkpointed data beside the WAL (sstable
    generations, a manifest, an interrupted checkpoint's ``.old`` WAL).
    This port replays the WAL alone, so such a directory would read as
    silently incomplete: refuse it."""
    d = os.path.dirname(os.path.abspath(wal_path))
    base = os.path.basename(wal_path)
    if not os.path.isdir(d):
        return
    found = sorted(fn for fn in os.listdir(d)
                   if fn == base + ".old" or fn == base + ".sst"
                   or fn.startswith(base + ".sst."))
    if found:
        raise RuntimeError(
            f"WAL {wal_path!r} has spilled state beside it ({found}); the "
            f"sstable/checkpoint tier is not ported yet")
