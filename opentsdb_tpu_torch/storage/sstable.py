"""Immutable sorted-table file: the spill tier under the memtable.

Mirrors ``opentsdb_tpu/storage/sstable.py`` of the JAX package, copied
rather than imported: the port imports nothing of that package. A
checkpoint spills the memtable into immutable generation files, after
which the WAL is truncated, bounding both recovery time and memtable RAM.
The files are byte-identical to the JAX package's TSST3 files, so each
package opens the generations the other wrote.

File layout v3 (all integers big-endian):
    magic  b"TSST3"
    record*  :=  [u16 table_len][table][u16 key_len][key][u32 ncells]
                 ([u16 fam_len][fam][u16 q_len][q][u32 v_len][v])*
    records sorted by (table, key); one record per row.
    footer   :=  per table:
                   [u16 table_len][table][u32 nkeys]
                   [key_lens: nkeys x u32][offsets: nkeys x u64]
                   [keys blob]
    bloom    :=  per table (same order as footer):
                   [u16 table_len][table][u8 k][u64 nbits][bits]
                   (k == 0, nbits == 0 => table has no bloom)
    trailer  :=  [u32 ntables][u64 footer_start][u64 bloom_start]

v2 files (magic TSST2: no bloom section, 12-byte trailer) and v1 files
(magic TSST1: no footer, the index is rebuilt by a full scan) are read
too; they simply never prune. The writer writes v3 only.

The bloom section holds one fixed-size (BLOOM_BITS) bloom filter per
table over the series identities of its row keys (metric UID + tag UID
pairs, base-time bytes excluded, hashed with crc32), so readers can skip
generations that cannot hold a series. Fixed-size so that the copy-merge
ORs the source generations' bit arrays instead of re-hashing relocated
keys. A table whose source blooms are missing (v1/v2 input) or whose
keys are too short to carry a series identity gets k == 0: "may contain
anything".

The reader mmaps the file and keeps only (key -> offset) indexes in RAM;
rows decode lazily.

With the native extension (``utils/nativeext.py``, the handle ``_EXT``)
``write_sstable_bulk`` frames each table's records in one C pass,
``merge_sstables`` frames the frozen-only rows of a tombstone-free table
the same way, and the footer's key blob is sliced in C, as in the JAX
package; a test sets ``_EXT`` to None to take the Python reference. One
corner differs between the two, in the JAX package too: the C framer
writes a table with no rows as a footer entry of zero keys with an empty
bloom, where the streaming writer leaves the table out. Both read the
same.

Not ported yet: format v4 (TSST4, compressed columnar blocks; ROADMAP
queue A item 5), whose generations are refused at open rather than
half-read, the pipelined encode pool, fault points and the metrics
registry.
"""

from __future__ import annotations

import mmap
import os
import struct
import zlib
from bisect import bisect_left
from typing import Iterable, Iterator

import numpy as np

from opentsdb_tpu_torch.core.const import TIMESTAMP_BYTES, UID_WIDTH
from opentsdb_tpu_torch.utils.nativeext import EXT as _EXT

_MAGIC_V1 = b"TSST1"
_MAGIC_V2 = b"TSST2"
_MAGIC = b"TSST3"
_MAGIC_V4 = b"TSST4"
_U16 = struct.Struct(">H")
_U32 = struct.Struct(">I")
_TRAILER = struct.Struct(">IQ")     # v2: ntables, footer_start
_TRAILER_V3 = struct.Struct(">IQQ")  # ntables, footer_start, bloom_start
_BLOOM_HDR = struct.Struct(">BQ")   # k, nbits

# Series-identity byte ranges of a data row key (the base-time bytes
# between them are excluded). Keys shorter than _IDENT_HI carry no
# identity and make their table bloomless.
_IDENT_LO = UID_WIDTH
_IDENT_HI = UID_WIDTH + TIMESTAMP_BYTES

# Fixed per-table bloom geometry: 2^20 bits = 128 KiB per table per
# generation. K doubles as the format discriminator: a stored bloom whose
# (k, nbits) differ from these is read as bloomless (never a false
# negative).
BLOOM_BITS = 1 << 20
BLOOM_K = 3

# row := (table, key, [(family, qualifier, value), ...])
Row = tuple[str, bytes, list[tuple[bytes, bytes, bytes]]]


def series_hash(series_key: bytes) -> int:
    """The 32-bit series-identity hash of the blooms: crc32 of (metric
    UID + tag UID pairs). For a full row key, hash key[:_IDENT_LO] and
    key[_IDENT_HI:] chained; crc32 chaining equals crc32 of the
    concatenation, so both spellings agree."""
    return zlib.crc32(series_key)


def _bloom_positions(h1: np.ndarray) -> np.ndarray:
    """[n, BLOOM_K] bit positions from 32-bit identity hashes
    (Kirsch-Mitzenmacher). h2 mixes h1's high bits, odd-forced so the
    strides cycle the whole power-of-two table."""
    h1 = h1.astype(np.uint64)
    h2 = ((h1 >> np.uint64(16)) * np.uint64(0x9E3779B1)
          + np.uint64(0x7FEB352D)) & np.uint64(0xFFFFFFFF)
    h2 = h2 | np.uint64(1)
    ks = np.arange(BLOOM_K, dtype=np.uint64)
    return (h1[:, None] + ks * h2[:, None]) % np.uint64(BLOOM_BITS)


def _bloom_bits_from_hashes(h1s) -> np.ndarray:
    """BLOOM_BITS-bit array (packed uint8, little bit order) with the
    hashes' positions set."""
    bits = np.zeros(BLOOM_BITS, bool)
    if len(h1s):
        pos = _bloom_positions(np.asarray(h1s, np.uint64))
        bits[pos.ravel().astype(np.int64)] = True
    return np.packbits(bits, bitorder="little")


def _bloom_hashes_for_keys(keys: Iterable[bytes]) -> list[int] | None:
    """Identity hashes for a table's row keys; None when any key is too
    short to carry a series identity (that table gets no bloom: a filter
    that cannot cover every key would hide rows)."""
    crc = zlib.crc32
    out: set[int] = set()
    for k in keys:
        if len(k) < _IDENT_HI:
            return None
        out.add(crc(k[_IDENT_HI:], crc(k[:_IDENT_LO])))
    return list(out)


def _slice_varlen(blob: bytes, lens_be: bytes) -> list[bytes]:
    if _EXT is not None:
        return _EXT.slice_varlen(blob, lens_be)
    lens = np.frombuffer(lens_be, ">u4")
    ends = np.cumsum(lens)
    starts = ends - lens
    return [blob[a:b] for a, b in zip(starts.tolist(), ends.tolist())]


class _BodyWriter:
    """The record section of a new v3 sstable, written straight through.
    ``write_record``/``write_run`` return the file offset of the written
    bytes, which is what the footer indexes."""

    def __init__(self, f) -> None:
        self.f = f
        f.write(_MAGIC)
        self.raw_off = len(_MAGIC)

    def write_record(self, rec: bytes) -> int:
        off = self.raw_off
        self.raw_off += len(rec)
        self.f.write(rec)
        return off

    # A run of verbatim record bytes (the copy-merge's unit) writes the
    # same way.
    write_run = write_record


def _write_bloom_and_trailer(f, ntables: int, footer_start: int,
                             blooms: dict[str, np.ndarray | None]) -> None:
    """Write the bloom section and the trailer, then make the file
    durable. ``blooms`` maps table -> packed bit array or None."""
    bloom_start = f.tell()
    for table in sorted(blooms):
        tb = table.encode()
        bits = blooms[table]
        f.write(_U16.pack(len(tb)) + tb)
        if bits is None:
            f.write(_BLOOM_HDR.pack(0, 0))
        else:
            f.write(_BLOOM_HDR.pack(BLOOM_K, BLOOM_BITS))
            f.write(bits.tobytes())
    f.write(_TRAILER_V3.pack(ntables, footer_start, bloom_start))
    f.flush()
    os.fsync(f.fileno())


def _finish_file(f, index: dict[str, tuple[list[bytes], list[int]]],
                 footer_start: int,
                 blooms: dict[str, np.ndarray | None] | None = None,
                 ) -> None:
    """Write the footer, bloom section and trailer and make the file
    durable. ``blooms`` overrides the per-table bloom bits (the
    copy-merge passes OR-ed source blooms); by default each table's bloom
    is built from its index keys. The footer streams table by table, so
    a large generation's index is never buffered whole."""
    for table in sorted(index):
        keys, offs = index[table]
        tb = table.encode()
        f.write(_U16.pack(len(tb)) + tb + _U32.pack(len(keys)))
        f.write(np.fromiter(map(len, keys), ">u4", len(keys)).tobytes())
        f.write(np.asarray(offs, ">u8").tobytes())
        f.write(b"".join(keys))
    if blooms is None:
        blooms = {}
        for table, (keys, _) in index.items():
            hs = _bloom_hashes_for_keys(keys)
            blooms[table] = (None if hs is None
                             else _bloom_bits_from_hashes(hs))
    else:
        # One bloom entry per indexed table, always (the reader parses
        # the section by the trailer's table count).
        blooms = {t: blooms.get(t) for t in index}
    _write_bloom_and_trailer(f, len(index), footer_start, blooms)


def _durable_rename(tmp: str, path: str) -> None:
    """Rename the finished temp file into place, then fsync the
    directory: the rename itself must be durable before the caller
    truncates its WAL, or a power loss could surface the old generation
    beside an already-truncated WAL."""
    os.replace(tmp, path)
    dfd = os.open(os.path.dirname(os.path.abspath(path)), os.O_RDONLY)
    try:
        os.fsync(dfd)
    finally:
        os.close(dfd)


def write_sstable_bulk(path: str,
                       tables: dict[str, tuple[list[bytes], object]]) -> int:
    """write_sstable for pre-materialized data: per table, a SORTED key
    list and either a parallel list of cell lists or the memtable row
    dict itself (key -> {(fam, qual): value}, no tombstones). With the
    native extension the whole record section frames in one C pass per
    table (the JAX package measured per-row Python framing at ~5 us a
    row, the dominant cost of a spill); without it, the streaming
    writer."""
    if _EXT is None:
        def rows():
            for table in sorted(tables):
                keys, data = tables[table]
                if isinstance(data, dict):
                    for k in keys:
                        yield table, k, sorted(
                            (f, q, v) for (f, q), v in data[k].items())
                else:
                    for k, c in zip(keys, data):
                        yield table, k, c
        return write_sstable(path, rows())
    tmp = path + ".tmp"
    n = 0
    index: dict[str, tuple[list[bytes], np.ndarray]] = {}
    with open(tmp, "wb") as f:
        f.write(_MAGIC)
        off = len(_MAGIC)
        for table in sorted(tables):
            keys, data = tables[table]
            frame = (_EXT.frame_rows_dict if isinstance(data, dict)
                     else _EXT.frame_rows)
            recs, offs_be, _ = frame(table.encode(), keys, data, off)
            f.write(recs)
            off += len(recs)
            n += len(keys)
            # A table with no rows is indexed too, with zero keys, as
            # the JAX package's C path writes it.
            index[table] = (keys, np.frombuffer(offs_be, ">u8"))
        _finish_file(f, index, off)
    _durable_rename(tmp, path)
    return n


def _frame_record(table_b: bytes, key: bytes, cells) -> bytes:
    """One record from sorted (family, qualifier, value) triples."""
    parts = [_U16.pack(len(table_b)), table_b, _U16.pack(len(key)), key,
             _U32.pack(len(cells))]
    for fam, qual, value in cells:
        parts += [_U16.pack(len(fam)), fam, _U16.pack(len(qual)), qual,
                  _U32.pack(len(value)), value]
    return b"".join(parts)


def write_sstable(path: str, rows: Iterable[Row]) -> int:
    """Write rows (pre-sorted by (table, key)) to a new sstable at
    ``path``; returns the number of rows written. Writes a temp file and
    renames it atomically, so a crash mid-write never corrupts the
    previous generation."""
    tmp = path + ".tmp"
    n = 0
    index: dict[str, tuple[list[bytes], list[int]]] = {}
    with open(tmp, "wb") as f:
        bw = _BodyWriter(f)
        for table, key, cells in rows:
            off = bw.write_record(_frame_record(table.encode(), key, cells))
            keys, offs = index.setdefault(table, ([], []))
            keys.append(key)
            offs.append(off)
            n += 1
        _finish_file(f, index, bw.raw_off)
    _durable_rename(tmp, path)
    return n


def merge_sstables(path: str, gens: list[SSTable], frozen: dict) -> int:
    """Collapse sstable generations (OLDEST FIRST) and a frozen memtable
    tier into one new sstable at ``path``: the full-merge leg of
    checkpoint, as a copy-merge.

    ``frozen``: {table: (rows, row_tombs, has_cell_tombs)} with rows =
    {key: {(fam, qual): value-or-None}} (None = tombstone masking a lower
    generation) and row_tombs masking whole lower-tier rows.

    Keys present in exactly one generation and untouched by the frozen
    tier have their record bytes copied verbatim, contiguous runs as
    single slices; only multi-source keys and frozen rows are decoded and
    re-framed (tombstones applied). Returns rows written; the same tmp +
    fsync + atomic-rename contract as write_sstable."""
    names = set(frozen)
    for g in gens:
        names.update(g.tables())
    tmp = path + ".tmp"
    n = 0
    index: dict[str, tuple[list[bytes], list[int]]] = {}
    blooms: dict[str, np.ndarray | None] = {}
    with open(tmp, "wb") as f:
        bw = _BodyWriter(f)
        for name in sorted(names):
            rows_f, row_tombs, has_tombs = frozen.get(
                name, ({}, set(), False))
            tb = name.encode()
            extents = [g.record_extents(name) for g in gens]
            # Multi-source keys: seen in >1 generation, or overlaid by a
            # frozen row.
            seen: set[bytes] = set()
            dup: set[bytes] = set()
            for keys, _, _ in extents:
                ks = set(keys)
                dup |= seen & ks
                seen |= ks
            dup.update(k for k in rows_f if k in seen)
            pairs: list[tuple[bytes, int]] = []
            # 1) Verbatim copy of single-source, frozen-untouched runs:
            # the skipped keys are located by bisect, file-contiguity
            # breaks (key order != file order in a merged generation)
            # by one numpy compare.
            skip = dup | row_tombs
            for (keys, starts, ends), g in zip(extents, gens):
                m = len(keys)
                if m == 0:
                    continue
                excl = set()
                for k in skip:
                    p = bisect_left(keys, k)
                    if p < m and keys[p] == k:
                        excl.add(p)
                breaks = np.nonzero(starts[1:] != ends[:-1])[0] + 1
                cuts = np.unique(np.concatenate([
                    np.array([0, m], np.int64), breaks,
                    np.fromiter(excl, np.int64, len(excl)),
                    np.fromiter((p + 1 for p in excl), np.int64,
                                len(excl))]))
                for a, b in zip(cuts[:-1].tolist(), cuts[1:].tolist()):
                    if a in excl:
                        continue
                    lo, hi = int(starts[a]), int(ends[b - 1])
                    run_off = bw.write_run(g.raw_bytes(lo, hi))
                    pairs.extend(zip(
                        keys[a:b],
                        (starts[a:b] + (run_off - lo)).tolist()))
            # 2) Multi-source keys: overlay oldest -> newest -> frozen.
            for k in dup:
                merged: dict = {}
                if k not in row_tombs:
                    for g in gens:
                        cells = g.get(name, k)
                        if cells:
                            for fam, q, v in cells:
                                merged[(fam, q)] = v
                row = rows_f.get(k)
                if row:
                    for ck, v in row.items():
                        if v is None:
                            merged.pop(ck, None)
                        else:
                            merged[ck] = v
                if not merged:
                    continue
                rec = _frame_record(tb, k, sorted(
                    (fam, q, v) for (fam, q), v in merged.items()))
                pairs.append((k, bw.write_record(rec)))
            # 3) Frozen-only rows (C-framed when tombstone-free).
            fr_only = sorted(k for k in rows_f
                             if k not in dup and rows_f[k])
            if fr_only and _EXT is not None and not has_tombs:
                recs, offs_be, _ = _EXT.frame_rows_dict(
                    tb, fr_only, rows_f, bw.raw_off)
                bw.write_run(recs)
                pairs.extend(zip(fr_only,
                                 np.frombuffer(offs_be, ">u8").tolist()))
            else:
                for k in fr_only:
                    cells = sorted((fam, q, v) for (fam, q), v
                                   in rows_f[k].items() if v is not None)
                    if not cells:
                        continue
                    pairs.append((k, bw.write_record(
                        _frame_record(tb, k, cells))))
            if not pairs:
                continue
            # Timsort exploits the concatenated sorted runs.
            pairs.sort()
            index[name] = ([p[0] for p in pairs], [p[1] for p in pairs])
            n += len(pairs)
            # Bloom for the merged table: OR the source generations'
            # blooms (records relocate verbatim, so their identities
            # carry over; keys a tombstone dropped leave stale bits,
            # false positives only) and hash in the frozen tier's keys.
            # Any bloomless source makes the output bloomless.
            bloom: np.ndarray | None = np.zeros(BLOOM_BITS // 8, np.uint8)
            for g in gens:
                if g.key_count(name) == 0:
                    continue
                gb = g.bloom_bits(name)
                if gb is None:
                    bloom = None
                    break
                np.bitwise_or(bloom, gb, out=bloom)
            if bloom is not None and rows_f:
                hs = _bloom_hashes_for_keys(rows_f)
                if hs is None:
                    bloom = None
                else:
                    np.bitwise_or(bloom, _bloom_bits_from_hashes(hs),
                                  out=bloom)
            blooms[name] = bloom
        _finish_file(f, index, bw.raw_off, blooms)
    _durable_rename(tmp, path)
    return n


class SSTable:
    """mmap-backed reader over one sstable generation (TSST1-3)."""

    def __init__(self, path: str) -> None:
        self.path = path
        self._f = open(path, "rb")
        try:
            size = os.fstat(self._f.fileno()).st_size
            self._mm = mmap.mmap(self._f.fileno(), size,
                                 access=mmap.ACCESS_READ)
        except BaseException:
            self._f.close()
            raise
        # table -> (sorted keys, parallel row offsets)
        self._index: dict[str, tuple[list[bytes], list[int]]] = {}
        # table -> packed BLOOM_BITS bit array (absent = no pruning)
        self._blooms: dict[str, np.ndarray] = {}
        self._all_starts = None  # record_extents' sorted-start cache
        head = self._mm[:len(_MAGIC)]
        try:
            if head == _MAGIC:
                self.format = 3
                self._load_footer(v3=True)
            elif head == _MAGIC_V2:
                self.format = 2
                self._load_footer(v3=False)
            elif head == _MAGIC_V1:
                self.format = 1
                self._build_index_v1()
            elif head == _MAGIC_V4:
                raise RuntimeError(
                    f"{path}: a TSST4 (compressed) sstable generation; "
                    f"compressed blocks are not ported yet (ROADMAP "
                    f"queue A item 5)")
            else:
                raise IOError(f"{path}: bad sstable magic")
        except BaseException:
            self.close()
            raise

    def _load_footer(self, v3: bool) -> None:
        mm = self._mm
        if v3:
            ntables, footer_start, bloom_start = _TRAILER_V3.unpack_from(
                mm, len(mm) - _TRAILER_V3.size)
        else:
            ntables, footer_start = _TRAILER.unpack_from(
                mm, len(mm) - _TRAILER.size)
            bloom_start = None
        self._data_end = footer_start
        off = footer_start
        for _ in range(ntables):
            (tlen,) = _U16.unpack_from(mm, off)
            off += 2
            table = mm[off:off + tlen].decode()
            off += tlen
            (nkeys,) = _U32.unpack_from(mm, off)
            off += 4
            lens_be = mm[off:off + 4 * nkeys]
            off += 4 * nkeys
            offs = np.frombuffer(mm, ">u8", nkeys, off).tolist()
            off += 8 * nkeys
            blob_len = int(np.frombuffer(lens_be, ">u4").sum())
            keys = _slice_varlen(mm[off:off + blob_len], lens_be)
            off += blob_len
            self._index[table] = (keys, offs)
        if bloom_start is not None:
            off = bloom_start
            for _ in range(ntables):
                (tlen,) = _U16.unpack_from(mm, off)
                off += 2
                table = mm[off:off + tlen].decode()
                off += tlen
                k, nbits = _BLOOM_HDR.unpack_from(mm, off)
                off += _BLOOM_HDR.size
                if k:
                    # Copied out of the mmap (a view would pin the map
                    # open past close()).
                    bits = np.frombuffer(mm, np.uint8, nbits >> 3,
                                         off).copy()
                    off += nbits >> 3
                    # Foreign geometry reads fine but cannot be probed
                    # or OR-merged: treat as bloomless.
                    if k == BLOOM_K and nbits == BLOOM_BITS:
                        self._blooms[table] = bits

    def _build_index_v1(self) -> None:
        self._data_end = len(self._mm)
        mm, off, end = self._mm, len(_MAGIC_V1), len(self._mm)
        while off < end:
            start = off
            (tlen,) = _U16.unpack_from(mm, off)
            off += 2
            table = mm[off:off + tlen].decode()
            off += tlen
            (klen,) = _U16.unpack_from(mm, off)
            off += 2
            key = bytes(mm[off:off + klen])
            off += klen
            (ncells,) = _U32.unpack_from(mm, off)
            off += 4
            for _ in range(ncells):
                (flen,) = _U16.unpack_from(mm, off)
                off += 2 + flen
                (qlen,) = _U16.unpack_from(mm, off)
                off += 2 + qlen
                (vlen,) = _U32.unpack_from(mm, off)
                off += 4 + vlen
            keys, offs = self._index.setdefault(table, ([], []))
            keys.append(key)
            offs.append(start)

    def close(self) -> None:
        self._mm.close()
        self._f.close()

    def tables(self) -> list[str]:
        return list(self._index)

    def key_count(self, table: str) -> int:
        idx = self._index.get(table)
        return len(idx[0]) if idx else 0

    def key_bounds(self, table: str) -> tuple[bytes, bytes] | None:
        """(smallest, largest) row key stored for ``table``, or None when
        the table is absent: keys outside the range cannot be here."""
        idx = self._index.get(table)
        if not idx or not idx[0]:
            return None
        return idx[0][0], idx[0][-1]

    def bloom_bits(self, table: str) -> np.ndarray | None:
        """Packed bloom bit array for ``table`` (the copy-merge ORs
        these), or None when the table has no usable bloom."""
        return self._blooms.get(table)

    def bloom_may_contain(self, table: str, h1s: np.ndarray) -> bool:
        """Can this generation hold ANY series whose identity hash is in
        ``h1s`` (uint64 array of series_hash values)? True when the table
        has no bloom: absence of evidence never prunes."""
        bits = self._blooms.get(table)
        if bits is None or len(h1s) == 0:
            return True
        pos = _bloom_positions(h1s)
        got = (bits[(pos >> np.uint64(3)).astype(np.int64)]
               >> (pos & np.uint64(7)).astype(np.uint8)) & 1
        return bool(got.all(axis=1).any())

    def bloom_may_contain_hash(self, table: str, h1: int) -> bool:
        """Scalar bloom probe for one series-identity hash: exactly
        _bloom_positions' derivation in Python ints, so it can never
        disagree with the vectorized probe. True when the table has no
        bloom."""
        bits = self._blooms.get(table)
        if bits is None:
            return True
        h2 = (((h1 >> 16) * 0x9E3779B1 + 0x7FEB352D) & 0xFFFFFFFF) | 1
        for k in range(BLOOM_K):
            pos = (h1 + k * h2) % BLOOM_BITS
            if not (bits[pos >> 3] >> (pos & 7)) & 1:
                return False
        return True

    def has_key(self, table: str, key: bytes) -> bool:
        idx = self._index.get(table)
        if not idx:
            return False
        keys = idx[0]
        i = bisect_left(keys, key)
        return i < len(keys) and keys[i] == key

    def raw_bytes(self, lo: int, hi: int) -> bytes:
        """Record bytes [lo, hi): what the copy-merge relocates."""
        return self._mm[lo:hi]

    def _read_row(self, off: int) -> list[tuple[bytes, bytes, bytes]]:
        mm = self._mm
        (tlen,) = _U16.unpack_from(mm, off)
        off += 2 + tlen
        (klen,) = _U16.unpack_from(mm, off)
        off += 2 + klen
        (ncells,) = _U32.unpack_from(mm, off)
        off += 4
        cells = []
        for _ in range(ncells):
            (flen,) = _U16.unpack_from(mm, off)
            off += 2
            fam = mm[off:off + flen]
            off += flen
            (qlen,) = _U16.unpack_from(mm, off)
            off += 2
            qual = mm[off:off + qlen]
            off += qlen
            (vlen,) = _U32.unpack_from(mm, off)
            off += 4
            value = mm[off:off + vlen]
            off += vlen
            cells.append((fam, qual, value))
        return cells

    def get(self, table: str,
            key: bytes) -> list[tuple[bytes, bytes, bytes]] | None:
        """Cells of one row, or None when the key is absent."""
        idx = self._index.get(table)
        if not idx:
            return None
        keys, offs = idx
        i = bisect_left(keys, key)
        if i >= len(keys) or keys[i] != key:
            return None
        return self._read_row(offs[i])

    def scan_keys(self, table: str, start: bytes,
                  stop: bytes | None) -> list[bytes]:
        idx = self._index.get(table)
        if not idx:
            return []
        keys = idx[0]
        lo = bisect_left(keys, start)
        hi = bisect_left(keys, stop) if stop else len(keys)
        return keys[lo:hi]

    def record_extents(self, table: str) -> tuple[
            list[bytes], np.ndarray, np.ndarray]:
        """(sorted keys, record starts, record ends) for one table.

        Records carry no embedded offsets, so a [start, end) slice
        relocates verbatim into another file. Records are back to back
        but not necessarily in key order (a merge writes re-framed rows
        after the copy runs), so each record's end is the smallest record
        start greater than its own, over the file's full start set with
        the record section's end as the sentinel."""
        idx = self._index.get(table)
        if not idx or not idx[0]:
            e = np.empty(0, np.int64)
            return [], e, e
        keys, offs = idx
        starts = np.asarray(offs, dtype=np.int64)
        if self._all_starts is None:
            self._all_starts = np.sort(np.concatenate(
                [np.asarray(o, dtype=np.int64)
                 for _, o in self._index.values()]
                + [np.asarray([self._data_end], dtype=np.int64)]))
        all_starts = self._all_starts
        ends = all_starts[np.searchsorted(all_starts, starts, "right")]
        return keys, starts, ends

    def iter_rows_range(self, table: str, start: bytes,
                        stop: bytes | None,
                        skip: set[bytes] | None = None) -> Iterator[
            tuple[bytes, list[tuple[bytes, bytes, bytes]]]]:
        """Rows with start <= key < stop (stop None = to the end), in key
        order: one bisect pair per call instead of one per key. ``skip``
        (the caller's row tombstones) suppresses rows before the record
        decode."""
        idx = self._index.get(table)
        if not idx:
            return
        keys, offs = idx
        lo = bisect_left(keys, start)
        hi = bisect_left(keys, stop) if stop else len(keys)
        read = self._read_row
        for i in range(lo, hi):
            if not skip or keys[i] not in skip:
                yield keys[i], read(offs[i])

    def iter_rows(self, table: str) -> Iterator[
            tuple[bytes, list[tuple[bytes, bytes, bytes]]]]:
        idx = self._index.get(table)
        if not idx:
            return
        for key, off in zip(*idx):
            yield key, self._read_row(off)
