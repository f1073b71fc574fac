"""Self-describing per-block codecs over sstable record bytes.

A copy of ``opentsdb_tpu/compress/codecs.py`` of the JAX package (numpy
only), kept here because the port imports nothing of that package: the
two must encode every block byte for byte alike, since TSST4 generations
cross between them.

A TSST4 block is a run of consecutive, same-table record bytes (the
exact v3 wire framing: ``[u16 tlen][table][u16 klen][key][u32 ncells]
cells``) compressed as one unit. Every block carries its codec tag and
uncompressed size in the file, so readers never guess:

    VERBATIM (0)  raw bytes unchanged — the incompressible fallback.
    TSF32    (1)  columnar time-series block: single-cell data rows
                  whose points are all 4-byte floats. Timestamps store
                  as delta-of-delta of the qualifier deltas (two
                  segmented cumsums undo it); values store as the XOR
                  of consecutive float32 bit patterns, chained across
                  the whole block. Both streams use a 4-bit-per-point
                  byte-count control plus a packed payload of only the
                  significant bytes — fully vectorized both ways.
    TSINT    (2)  same shape for all-integer rows: zigzag deltas of
                  the int64 values; the per-point width flags are
                  recomputed at decode (eligibility requires stored
                  widths to be minimal, which the batch encoder
                  guarantees; legacy odd rows fall back).
    ZLIB     (3)  zlib over the raw bytes — structured-but-foreign
                  rows (UID maps, multi-cell rows) that still deflate.
    ROLLSUM  (4)  structured rollup-summary block: runs of rollup
                  records (1-byte family, one moment-map cell of
                  fixed-stride entries + an optional sketch-map cell).
                  Keys prefix-compress like the ts codecs; the moment
                  entries store byte-TRANSPOSED (each struct field's
                  bytes land contiguous, a columnar layout zlib
                  actually bites on) and readers get the whole block's
                  entry array back with one inflate + one frombuffer —
                  no per-row cell unpack, and the parsed columns cache
                  per block for rollup-served downsamples.

``encode_block`` picks the cheapest applicable codec and — belt and
suspenders for a format whose corruption surface is every byte in the
store — verifies decode(encode(raw)) == raw before committing to a
structured codec; any mismatch falls back. Decoding is pure numpy
(no per-record Python): record layout offsets come from vectorized
cumsums and field scatters, key prefixes expand via a column-wise
forward fill.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

from opentsdb_tpu_torch.core.const import FLAG_BITS, FLAG_FLOAT, LENGTH_MASK

VERBATIM = 0
TSF32 = 1
TSINT = 2
ZLIB = 3
ROLLSUM = 4

CODEC_NAMES = {VERBATIM: "verbatim", TSF32: "tsf32", TSINT: "tsint",
               ZLIB: "zlib", ROLLSUM: "rollsum"}

# Moment-map entry stride the ROLLSUM codec recognizes: one u2 window
# index + the 52-byte summary record (rollup/summary.py ENTRY_DTYPE).
# Duplicated (the _int_widths precedent) so the codec stays importable
# without dragging the rollup tier in; the stride also rides in every
# block header, so a future layout bump reads old blocks fine and
# simply stops ENCODING new ones until this constant follows.
ROLLSUM_STRIDE = 54

# Write-time decode-and-compare of every structured block. Cheap next
# to the spill's IO and the one guarantee that makes golden parity a
# non-event; tests flip it off only to prove encode alone is correct.
SELF_CHECK = True

_HDR = struct.Struct(">IIHB")   # nrec, npts, table_len, family byte
_U32 = struct.Struct(">I")

_LEGAL_INT_W = (1, 2, 4, 8)


class BlockCodecError(Exception):
    """A block that does not decode (unknown tag, torn payload,
    size mismatch) — fsck counts these; readers raise IOError."""


# -- bit/byte plumbing ------------------------------------------------------

def _zigzag(v: np.ndarray) -> np.ndarray:
    v = v.astype(np.int64, copy=False)
    return ((v << 1) ^ (v >> 63)).view(np.uint64)


def _unzigzag(z: np.ndarray) -> np.ndarray:
    half = (z >> np.uint64(1)).view(np.int64)
    return half ^ -((z & np.uint64(1)).view(np.int64))


def _nbytes_u64(u: np.ndarray) -> np.ndarray:
    """Per-value significant byte count (0..8) of uint64 values."""
    nb = np.zeros(u.shape, np.int64)
    for k in range(1, 9):
        nb[u >= np.uint64(1 << (8 * (k - 1)))] = k
    return nb


def _pack_nibbles(vals: np.ndarray) -> bytes:
    n = len(vals)
    pad = np.zeros(((n + 1) // 2) * 2, np.uint8)
    pad[:n] = vals
    return ((pad[0::2] << 4) | pad[1::2]).tobytes()


def _unpack_nibbles(buf: np.ndarray, n: int) -> np.ndarray:
    out = np.empty(len(buf) * 2, np.uint8)
    out[0::2] = buf >> 4
    out[1::2] = buf & 0xF
    if n > len(out):
        raise BlockCodecError("nibble control stream too short")
    return out[:n].astype(np.int64)


def _pack_varbytes(u: np.ndarray, nb: np.ndarray) -> bytes:
    """Concatenate the significant (big-endian low) bytes of each
    value, ``nb`` bytes per value."""
    total = int(nb.sum())
    out = np.zeros(total, np.uint8)
    offs = np.zeros(len(u), np.int64)
    if len(u) > 1:
        np.cumsum(nb[:-1], out=offs[1:])
    be = u.astype(">u8").view(np.uint8).reshape(-1, 8)
    for w in range(1, 9):
        m = nb == w
        if not m.any():
            continue
        pos = offs[m, None] + np.arange(w)
        out[pos.ravel()] = be[m][:, 8 - w:].ravel()
    return out.tobytes()


def _unpack_varbytes(buf: np.ndarray, nb: np.ndarray) -> np.ndarray:
    offs = np.zeros(len(nb), np.int64)
    if len(nb) > 1:
        np.cumsum(nb[:-1], out=offs[1:])
    if (int(offs[-1] + nb[-1]) if len(nb) else 0) > len(buf):
        raise BlockCodecError("varbyte payload too short")
    u = np.zeros(len(nb), np.uint64)
    for w in range(1, 9):
        m = nb == w
        if not m.any():
            continue
        pos = offs[m, None] + np.arange(w)
        padded = np.zeros((int(m.sum()), 8), np.uint8)
        padded[:, 8 - w:] = buf[pos.ravel()].reshape(-1, w)
        u[m] = padded.view(">u8").ravel().astype(np.uint64)
    return u


def _be16(arr: np.ndarray, pos: np.ndarray) -> np.ndarray:
    return (arr[pos].astype(np.int64) << 8) | arr[pos + 1]


def _be32(arr: np.ndarray, pos: np.ndarray) -> np.ndarray:
    return ((arr[pos].astype(np.int64) << 24)
            | (arr[pos + 1].astype(np.int64) << 16)
            | (arr[pos + 2].astype(np.int64) << 8)
            | arr[pos + 3])


def _scatter_be(out: np.ndarray, pos: np.ndarray, vals: np.ndarray,
                width: int) -> None:
    b = vals.astype(f">u{width}").view(np.uint8).reshape(-1, width)
    out[(pos[:, None] + np.arange(width)).ravel()] = b.ravel()


def _int_widths(v: np.ndarray) -> np.ndarray:
    """Minimal big-endian two's-complement width (1/2/4/8) per int64 —
    codec_np.int_widths, duplicated so decode stays importable from
    jax-free child processes without dragging the batch codec in."""
    w = np.full(v.shape, 8, np.int64)
    for width, lo, hi in ((4, -0x80000000, 0x7FFFFFFF),
                          (2, -0x8000, 0x7FFF),
                          (1, -0x80, 0x7F)):
        w = np.where((v >= lo) & (v <= hi), width, w)
    return w


# -- record-structure parse (shared by encode + the fused block source) -----

class ParsedRecords:
    """Vectorized field offsets of a run of v3-framed records, or the
    reason the run is not a structured time-series block."""

    __slots__ = ("arr", "n", "table", "fam", "key_start", "klen",
                 "npts", "first_pt", "rec_of_pt", "within", "deltas",
                 "flags", "vstart", "vlen", "P")


def parse_records(raw, offs: np.ndarray):
    """Parse same-table single-data-cell records. Returns a
    ParsedRecords or None when the run does not fit the columnar shape
    (multi-cell rows, foreign families, odd qualifiers, table mix)."""
    arr = np.frombuffer(raw, np.uint8)
    o = np.asarray(offs, np.int64)
    n = len(o)
    if n == 0 or len(arr) == 0:
        return None
    try:
        tlen = _be16(arr, o)
    except IndexError:
        return None
    t0 = int(tlen[0])
    if not (tlen == t0).all():
        return None
    tb = arr[(o[:, None] + 2 + np.arange(t0)).reshape(-1)].reshape(n, t0)
    if not (tb == tb[0]).all():
        return None
    ko = o + 2 + t0
    klen = _be16(arr, ko)
    key_start = ko + 2
    co = key_start + klen
    if int((co + 4).max()) > len(arr):
        return None
    ncells = _be32(arr, co)
    if not (ncells == 1).all():
        return None
    fo = co + 4
    flen = _be16(arr, fo)
    if not (flen == 1).all():
        return None
    fam = arr[fo + 2]
    if not (fam == fam[0]).all():
        return None
    qo = fo + 3
    qlen = _be16(arr, qo)
    if ((qlen == 0) | (qlen % 2 != 0)).any():
        return None
    npts = qlen // 2
    if (npts > 0xFFFF).any() or (klen > 0xFFFF).any():
        return None
    qstart = qo + 2
    vo = qstart + qlen
    if int((vo + 4).max()) > len(arr):
        return None
    vlen = _be32(arr, vo)
    vstart = vo + 4
    rec_end = vstart + vlen
    nxt = np.append(o[1:], len(arr))
    if not (rec_end == nxt).all():
        return None
    P = int(npts.sum())
    first_pt = np.zeros(n, np.int64)
    np.cumsum(npts[:-1], out=first_pt[1:])
    rec_of_pt = np.repeat(np.arange(n), npts)
    within = np.arange(P) - first_pt[rec_of_pt]
    quals = _be16(arr, qstart[rec_of_pt] + 2 * within)
    p = ParsedRecords()
    p.arr, p.n, p.P = arr, n, P
    p.table = bytes(tb[0])
    p.fam = int(fam[0])
    p.key_start, p.klen = key_start, klen
    p.npts, p.first_pt = npts, first_pt
    p.rec_of_pt, p.within = rec_of_pt, within
    p.deltas = quals >> FLAG_BITS
    p.flags = quals & (FLAG_FLOAT | LENGTH_MASK)
    p.vstart, p.vlen = vstart, vlen
    return p


def _key_matrix(p: ParsedRecords):
    """[n, kmax] uint8 key bytes (zero-padded) + the per-record shared
    prefix length with the previous key (first record: 0)."""
    kmax = int(p.klen.max()) if p.n else 0
    cols = np.arange(kmax)
    mask = cols < p.klen[:, None]
    pos = np.minimum(p.key_start[:, None] + cols, len(p.arr) - 1)
    K = np.where(mask, p.arr[pos], 0).astype(np.uint8)
    if p.n < 2 or kmax == 0:
        return K, np.zeros(p.n, np.int64), mask
    eq = (K[1:] == K[:-1]) & mask[1:] & mask[:-1]
    neq = ~eq
    pre = np.where(neq.any(axis=1), neq.argmax(axis=1), kmax)
    pre = np.minimum(pre, np.minimum(p.klen[1:], p.klen[:-1]))
    kpre = np.zeros(p.n, np.int64)
    kpre[1:] = np.minimum(pre, 255)
    return K, kpre, mask


def _ts_entries(p: ParsedRecords) -> np.ndarray:
    """Delta-of-delta entry stream: per record, entry 0 is the first
    qualifier delta, entry 1 the first step, the rest second
    differences — two segmented cumsums (decode) undo exactly this."""
    d = p.deltas
    first = p.within == 0
    prev = np.empty_like(d)
    prev[0] = 0
    prev[1:] = d[:-1]
    f = np.where(first, d, d - prev)
    prevf = np.empty_like(f)
    prevf[0] = 0
    prevf[1:] = f[:-1]
    return np.where(first, f, f - prevf)


def _seg_cumsum(x: np.ndarray, first_idx: np.ndarray) -> np.ndarray:
    """Inclusive per-segment cumsum; ``first_idx`` maps each element to
    its segment's first index."""
    c = np.concatenate(([0], np.cumsum(x)))
    return c[1:] - c[first_idx]


def _encode_ts_block(p: ParsedRecords, tag: int,
                     values_u64: np.ndarray) -> bytes:
    K, kpre, mask = _key_matrix(p)
    suf_mask = mask & (np.arange(K.shape[1]) >= kpre[:, None])
    ksuf = K[suf_mask].tobytes()
    ent = _zigzag(_ts_entries(p))
    ts_nb = _nbytes_u64(ent)
    ts_ctrl = _pack_nibbles(ts_nb)
    ts_pay = _pack_varbytes(ent, ts_nb)
    v_nb = _nbytes_u64(values_u64)
    v_ctrl = _pack_nibbles(v_nb)
    v_pay = _pack_varbytes(values_u64, v_nb)
    parts = [
        _HDR.pack(p.n, p.P, len(p.table), p.fam), p.table,
        p.klen.astype(">u2").tobytes(), kpre.astype(np.uint8).tobytes(),
        _U32.pack(len(ksuf)), ksuf,
        p.npts.astype(">u2").tobytes(),
        _U32.pack(len(ts_pay)), ts_ctrl, ts_pay,
        _U32.pack(len(v_pay)), v_ctrl, v_pay,
    ]
    return b"".join(parts)


def try_encode_data(raw, offs: np.ndarray) -> tuple[int, bytes] | None:
    """Attempt the structured codecs; None when the run is ineligible."""
    p = parse_records(raw, offs)
    if p is None:
        return None
    multi = p.npts > 1
    if (p.flags == (FLAG_FLOAT | 0x3)).all():
        want_vlen = np.where(multi, 4 * p.npts + 1, 4)
        if not (p.vlen == want_vlen).all():
            return None
        if multi.any() and p.arr[(p.vstart + p.vlen - 1)[multi]].any():
            return None
        bits = _be32(p.arr, p.vstart[p.rec_of_pt] + 4 * p.within) \
            .astype(np.uint64)
        prev = np.zeros_like(bits)
        prev[1:] = bits[:-1]
        return TSF32, _encode_ts_block(p, TSF32, bits ^ prev)
    if not (p.flags & FLAG_FLOAT).any():
        widths = (p.flags & LENGTH_MASK) + 1
        if not np.isin(widths, _LEGAL_INT_W).all():
            return None
        gcum = np.concatenate(([0], np.cumsum(widths)))
        woff = gcum[:-1] - gcum[p.first_pt][p.rec_of_pt]
        consumed = gcum[p.first_pt + p.npts] - gcum[p.first_pt]
        if not (p.vlen == consumed + multi.astype(np.int64)).all():
            return None
        if multi.any() and p.arr[(p.vstart + p.vlen - 1)[multi]].any():
            return None
        vpos = p.vstart[p.rec_of_pt] + woff
        vals = np.zeros(p.P, np.int64)
        for w in _LEGAL_INT_W:
            m = widths == w
            if not m.any():
                continue
            pos = vpos[m, None] + np.arange(w)
            u = np.zeros((int(m.sum()), 8), np.uint8)
            u[:, 8 - w:] = p.arr[pos.ravel()].reshape(-1, w)
            raw64 = u.view(">u8").ravel().astype(np.uint64)
            shift = np.uint64(64 - 8 * w)
            vals[m] = ((raw64 << shift).view(np.int64)
                       >> np.int64(64 - 8 * w))
        # Decode recomputes flags as the minimal width: non-minimal
        # legacy rows cannot round-trip through this codec.
        if not (_int_widths(vals) == widths).all():
            return None
        prev = np.zeros_like(vals)
        prev[1:] = vals[:-1]
        return TSINT, _encode_ts_block(p, TSINT, _zigzag(vals - prev))
    return None


# -- decode -----------------------------------------------------------------

def _expand_keys(klen: np.ndarray, kpre: np.ndarray,
                 ksuf: np.ndarray):
    """[n, kmax] key-byte matrix from prefix-compressed keys: byte j of
    key i comes from the most recent record whose own suffix covers
    column j (column-wise forward fill — no per-record Python)."""
    n = len(klen)
    kmax = int(klen.max()) if n else 0
    K = np.zeros((n, kmax), np.uint8)
    suf_len = klen - kpre
    offs = np.zeros(n, np.int64)
    if n > 1:
        np.cumsum(suf_len[:-1], out=offs[1:])
    if int(suf_len.sum()) != len(ksuf):
        raise BlockCodecError("key suffix blob length mismatch")
    cols = np.arange(kmax)
    own = (cols >= kpre[:, None]) & (cols < klen[:, None])
    # Own suffix bytes land at their columns...
    pos = np.minimum(offs[:, None] + (cols - kpre[:, None]),
                     max(len(ksuf) - 1, 0))
    S = np.where(own, ksuf[pos] if len(ksuf) else 0, 0).astype(np.uint8)
    rows = np.arange(n)
    for j in range(kmax):
        src = np.where(own[:, j], rows, -1)
        fill = np.maximum.accumulate(src)
        valid = fill >= 0
        K[valid, j] = S[fill[valid], j]
    return K


class TsBlock:
    """Parsed header + streams of a TSF32/TSINT block (decode side and
    the fused path's host prep)."""

    __slots__ = ("tag", "n", "P", "table", "fam", "klen", "kpre",
                 "npts", "first_pt", "rec_of_pt", "within",
                 "ts_nb", "ts_pay", "v_nb", "v_pay", "K")

    def keys_matrix(self) -> np.ndarray:
        if self.K is None:
            raise BlockCodecError("keys not decoded")
        return self.K

    def deltas(self) -> np.ndarray:
        ent = _unzigzag(_unpack_varbytes(self.ts_pay, self.ts_nb))
        first = self.first_pt[self.rec_of_pt]
        steps = _seg_cumsum(ent, first)
        return _seg_cumsum(steps, first)

    def float_bits(self) -> np.ndarray:
        """uint32 IEEE754 bit patterns (TSF32 blocks)."""
        xr = _unpack_varbytes(self.v_pay, self.v_nb).astype(np.uint32)
        return np.bitwise_xor.accumulate(xr)

    def int_values(self) -> np.ndarray:
        d = _unzigzag(_unpack_varbytes(self.v_pay, self.v_nb))
        return np.cumsum(d)


def parse_ts_block(tag: int, enc, keys_only: bool = False) -> TsBlock:
    """Parse a TSF32/TSINT block. ``keys_only`` stops after the key and
    record-structure sections — the fused source's filter pushdown
    probes keys per block and only pays the payload parse for blocks
    that actually hold matching in-range records (the ts/value stream
    fields are left None)."""
    buf = np.frombuffer(enc, np.uint8)
    if len(buf) < _HDR.size:
        raise BlockCodecError("block header truncated")
    n, P, tlen, fam = _HDR.unpack_from(enc, 0)
    off = _HDR.size
    b = TsBlock()
    b.tag, b.n, b.P, b.fam = tag, n, P, fam
    b.K = None

    def take(count):
        nonlocal off
        if off + count > len(buf):
            raise BlockCodecError("block payload truncated")
        out = buf[off:off + count]
        off += count
        return out

    b.table = take(tlen).tobytes()
    b.klen = take(2 * n).view(">u2").astype(np.int64)
    b.kpre = take(n).astype(np.int64)
    (ksuf_len,) = _U32.unpack_from(enc, off)
    off += 4
    ksuf = take(ksuf_len)
    b.npts = take(2 * n).view(">u2").astype(np.int64)
    if int(b.npts.sum()) != P:
        raise BlockCodecError("point count mismatch")
    b.first_pt = np.zeros(n, np.int64)
    np.cumsum(b.npts[:-1], out=b.first_pt[1:])
    b.rec_of_pt = np.repeat(np.arange(n), b.npts)
    b.within = np.arange(P) - b.first_pt[b.rec_of_pt]
    if keys_only:
        b.ts_nb = b.ts_pay = b.v_nb = b.v_pay = None
        b.K = _expand_keys(b.klen, b.kpre, ksuf)
        return b
    (ts_pay_len,) = _U32.unpack_from(enc, off)
    off += 4
    b.ts_nb = _unpack_nibbles(take((P + 1) // 2), P)
    b.ts_pay = take(ts_pay_len)
    if int(b.ts_nb.sum()) != ts_pay_len:
        raise BlockCodecError("timestamp payload length mismatch")
    (v_pay_len,) = _U32.unpack_from(enc, off)
    off += 4
    b.v_nb = _unpack_nibbles(take((P + 1) // 2), P)
    b.v_pay = take(v_pay_len)
    if int(b.v_nb.sum()) != v_pay_len:
        raise BlockCodecError("value payload length mismatch")
    if off != len(buf):
        raise BlockCodecError("trailing bytes after block payload")
    b.K = _expand_keys(b.klen, b.kpre, ksuf)
    return b


def _decode_ts_raw(tag: int, enc) -> bytes:
    b = parse_ts_block(tag, enc)
    n, P = b.n, b.P
    t0 = len(b.table)
    deltas = b.deltas()
    if tag == TSF32:
        flags = np.full(P, FLAG_FLOAT | 0x3, np.int64)
        widths = np.full(P, 4, np.int64)
        vals_bits = b.float_bits()
    else:
        ivals = b.int_values()
        widths = _int_widths(ivals)
        flags = widths - 1
        vals_bits = None
    gcum = np.concatenate(([0], np.cumsum(widths)))
    woff = gcum[:-1] - gcum[b.first_pt][b.rec_of_pt]
    consumed = gcum[b.first_pt + b.npts] - gcum[b.first_pt]
    multi = (b.npts > 1).astype(np.int64)
    vlen = consumed + multi
    rec_len = (2 + t0) + (2 + b.klen) + 4 + 3 + (2 + 2 * b.npts) \
        + (4 + vlen)
    rec_off = np.zeros(n, np.int64)
    np.cumsum(rec_len[:-1], out=rec_off[1:])
    total = int(rec_off[-1] + rec_len[-1]) if n else 0
    out = np.zeros(total, np.uint8)
    # Fixed header fields.
    _scatter_be(out, rec_off, np.full(n, t0, np.int64), 2)
    tb = np.frombuffer(b.table, np.uint8)
    out[(rec_off[:, None] + 2 + np.arange(t0)).ravel()] = \
        np.broadcast_to(tb, (n, t0)).ravel()
    ko = rec_off + 2 + t0
    _scatter_be(out, ko, b.klen, 2)
    key_start = ko + 2
    kmax = b.K.shape[1]
    if kmax:
        cols = np.arange(kmax)
        mask = cols < b.klen[:, None]
        kp = key_start[:, None] + cols
        out[kp[mask]] = b.K[mask]
    co = key_start + b.klen
    _scatter_be(out, co, np.ones(n, np.int64), 4)     # ncells
    _scatter_be(out, co + 4, np.ones(n, np.int64), 2)  # fam_len
    out[co + 6] = b.fam
    qo = co + 7
    _scatter_be(out, qo, 2 * b.npts, 2)
    qstart = qo + 2
    quals = (deltas << FLAG_BITS) | flags
    _scatter_be(out, qstart[b.rec_of_pt] + 2 * b.within, quals, 2)
    vo = qstart + 2 * b.npts
    _scatter_be(out, vo, vlen, 4)
    vstart = vo + 4
    vpos = vstart[b.rec_of_pt] + woff
    if tag == TSF32:
        _scatter_be(out, vpos, vals_bits.astype(np.int64), 4)
    else:
        for w in _LEGAL_INT_W:
            m = widths == w
            if not m.any():
                continue
            bwide = ivals[m].astype(">i8").view(np.uint8) \
                .reshape(-1, 8)[:, 8 - w:]
            out[(vpos[m, None] + np.arange(w)).ravel()] = bwide.ravel()
    # Trailing 0x00 meta bytes of multi-point cells are already zero.
    return out.tobytes()


# -- ROLLSUM: structured rollup-summary blocks ------------------------------

# nrec, table_len, family byte, entry stride
_RS_HDR = struct.Struct(">IHBH")


class RollupBlock:
    """Parsed ROLLSUM block: prefix-expanded keys plus the block's
    moment entries as ONE contiguous byte matrix ([E, stride] — view it
    with the summary ENTRY dtype) and per-record sketch blobs. The
    rollup tier serves straight off this (cached per block), never
    re-materializing row bytes."""

    __slots__ = ("n", "table", "fam", "stride", "K", "klen",
                 "nm", "first_ent", "has_sketch", "sk_len", "ent_bytes",
                 "sk_blob", "sk_off")


def _parse_rollup_run(raw, offs: np.ndarray):
    """Shape-check a run of v3-framed records as rollup-summary rows:
    same table, one 1-byte family, cells exactly [qual 0x00 moment map]
    or [qual 0x00, qual 0x01 sketch map], moment value a whole number
    of ROLLSUM_STRIDE entries. Returns the per-record field lists or
    None. Per-record Python is fine here: a 256 KB block holds ~100
    packed superrows, not the ~10k points of a data block."""
    arr = memoryview(raw) if not isinstance(raw, (bytes, bytearray)) \
        else raw
    n = len(offs)
    if n == 0:
        return None
    keys, moms, sks, has_sk = [], [], [], []
    table = fam = None
    end = 0
    for i in range(n):
        off = int(offs[i])
        try:
            (tlen,) = _U16_S.unpack_from(arr, off)
            tb = bytes(arr[off + 2:off + 2 + tlen])
            off += 2 + tlen
            (klen,) = _U16_S.unpack_from(arr, off)
            key = bytes(arr[off + 2:off + 2 + klen])
            off += 2 + klen
            (ncells,) = _U32.unpack_from(arr, off)
            off += 4
            if ncells not in (1, 2):
                return None
            cells = []
            for _ in range(ncells):
                (flen,) = _U16_S.unpack_from(arr, off)
                fb = bytes(arr[off + 2:off + 2 + flen])
                off += 2 + flen
                (qlen,) = _U16_S.unpack_from(arr, off)
                q = bytes(arr[off + 2:off + 2 + qlen])
                off += 2 + qlen
                (vlen,) = _U32.unpack_from(arr, off)
                v = bytes(arr[off + 4:off + 4 + vlen])
                if len(v) != vlen:
                    return None
                off += 4 + vlen
                cells.append((fb, q, v))
        except struct.error:
            return None
        if table is None:
            table = tb
        elif tb != table:
            return None
        f0 = cells[0][0]
        if len(f0) != 1 or any(f != f0 for f, _, _ in cells):
            return None
        if fam is None:
            fam = f0
        elif f0 != fam:
            return None
        if cells[0][1] != b"\x00" \
                or len(cells[0][2]) % ROLLSUM_STRIDE \
                or len(cells[0][2]) // ROLLSUM_STRIDE > 0xFFFF:
            return None
        if len(cells) == 2 and cells[1][1] != b"\x01":
            return None
        if len(key) > 0xFFFF or len(key) == 0:
            return None
        keys.append(key)
        moms.append(cells[0][2])
        sk = cells[1][2] if len(cells) == 2 else b""
        sks.append(sk)
        has_sk.append(len(cells) == 2)
        end = off
    if end != len(raw):
        return None
    return table, fam, keys, moms, sks, has_sk


_U16_S = struct.Struct(">H")


def _key_prefix_compress(keys: list[bytes]):
    """(klen, kpre, ksuf blob) for a sorted-ish key list — the same
    shared-prefix scheme the ts codecs use, over plain bytes."""
    n = len(keys)
    klen = np.fromiter((len(k) for k in keys), np.int64, n)
    kpre = np.zeros(n, np.int64)
    parts = [keys[0]]
    for i in range(1, n):
        a, b = keys[i - 1], keys[i]
        m = min(len(a), len(b), 255)
        p = 0
        while p < m and a[p] == b[p]:
            p += 1
        kpre[i] = p
        parts.append(b[p:])
    return klen, kpre, b"".join(parts)


def try_encode_rollup(raw, offs: np.ndarray) -> tuple[int, bytes] | None:
    got = _parse_rollup_run(raw, offs)
    if got is None:
        return None
    table, fam, keys, moms, sks, has_sk = got
    n = len(keys)
    klen, kpre, ksuf = _key_prefix_compress(keys)
    nm = np.fromiter((len(m) // ROLLSUM_STRIDE for m in moms),
                     np.int64, n)
    sk_len = np.fromiter((len(s) for s in sks), np.int64, n)
    flags = np.fromiter((1 if h else 0 for h in has_sk), np.uint8, n)
    ent = np.frombuffer(b"".join(moms), np.uint8)
    # Byte transpose: entry field bytes become contiguous columns —
    # idx deltas, counts, exponent bytes of the f8 fields each deflate
    # together instead of interleaved at stride 54.
    ent_t = ent.reshape(-1, ROLLSUM_STRIDE).T.copy() if len(ent) \
        else ent
    mom_z = zlib.compress(ent_t.tobytes(), 5)
    sk_z = zlib.compress(b"".join(sks), 5)
    parts = [
        _RS_HDR.pack(n, len(table), fam[0], ROLLSUM_STRIDE), table,
        klen.astype(">u2").tobytes(), kpre.astype(np.uint8).tobytes(),
        _U32.pack(len(ksuf)), ksuf,
        flags.tobytes(), nm.astype(">u2").tobytes(),
        sk_len.astype(">u4").tobytes(),
        _U32.pack(len(mom_z)), mom_z,
        _U32.pack(len(sk_z)), sk_z,
    ]
    return ROLLSUM, b"".join(parts)


def parse_rollsum_block(enc) -> RollupBlock:
    buf = np.frombuffer(enc, np.uint8)
    if len(buf) < _RS_HDR.size:
        raise BlockCodecError("rollsum header truncated")
    n, tlen, fam, stride = _RS_HDR.unpack_from(enc, 0)
    if stride == 0:
        raise BlockCodecError("rollsum zero stride")
    off = _RS_HDR.size
    b = RollupBlock()
    b.n, b.fam, b.stride = n, fam, stride

    def take(count):
        nonlocal off
        if off + count > len(buf):
            raise BlockCodecError("rollsum payload truncated")
        out = buf[off:off + count]
        off += count
        return out

    b.table = take(tlen).tobytes()
    b.klen = take(2 * n).view(">u2").astype(np.int64)
    kpre = take(n).astype(np.int64)
    (ksuf_len,) = _U32.unpack_from(enc, off)
    off += 4
    ksuf = take(ksuf_len)
    b.has_sketch = take(n) != 0
    b.nm = take(2 * n).view(">u2").astype(np.int64)
    b.sk_len = take(4 * n).view(">u4").astype(np.int64)
    (mom_z_len,) = _U32.unpack_from(enc, off)
    off += 4
    try:
        ent_t = np.frombuffer(zlib.decompress(take(mom_z_len)),
                              np.uint8)
    except zlib.error as e:
        raise BlockCodecError(f"rollsum moment inflate: {e}") from None
    E = int(b.nm.sum())
    if len(ent_t) != E * stride:
        raise BlockCodecError("rollsum moment section length mismatch")
    b.ent_bytes = np.ascontiguousarray(
        ent_t.reshape(stride, E).T) if E else \
        np.empty((0, stride), np.uint8)
    b.first_ent = np.zeros(n, np.int64)
    if n > 1:
        np.cumsum(b.nm[:-1], out=b.first_ent[1:])
    (sk_z_len,) = _U32.unpack_from(enc, off)
    off += 4
    try:
        b.sk_blob = zlib.decompress(take(sk_z_len).tobytes())
    except zlib.error as e:
        raise BlockCodecError(f"rollsum sketch inflate: {e}") from None
    if off != len(buf):
        raise BlockCodecError("trailing bytes after rollsum payload")
    b.sk_off = np.zeros(n, np.int64)
    if n > 1:
        np.cumsum(b.sk_len[:-1], out=b.sk_off[1:])
    if int(b.sk_len.sum()) != len(b.sk_blob):
        raise BlockCodecError("rollsum sketch section length mismatch")
    if ((b.sk_len > 0) & ~b.has_sketch).any():
        raise BlockCodecError("rollsum sketch bytes on sketchless row")
    b.K = _expand_keys(b.klen, kpre, ksuf)
    return b


def _decode_rollsum_raw(enc) -> bytes:
    b = parse_rollsum_block(enc)
    fam = bytes([b.fam])
    out = []
    th = _U16_S.pack(len(b.table)) + b.table
    for i in range(b.n):
        key = b.K[i, :b.klen[i]].tobytes()
        mom = b.ent_bytes[b.first_ent[i]:b.first_ent[i] + b.nm[i]] \
            .tobytes()
        cells = [(fam, b"\x00", mom)]
        if b.has_sketch[i]:
            sk = b.sk_blob[b.sk_off[i]:b.sk_off[i] + b.sk_len[i]]
            cells.append((fam, b"\x01", sk))
        rec = [th, _U16_S.pack(len(key)), key, _U32.pack(len(cells))]
        for f, q, v in cells:
            rec += [_U16_S.pack(len(f)), f, _U16_S.pack(len(q)), q,
                    _U32.pack(len(v)), v]
        out.append(b"".join(rec))
    return b"".join(out)


# -- public API -------------------------------------------------------------

def encode_block(raw: bytes, offs) -> tuple[int, bytes]:
    """Encode one run of record bytes (record start ``offs`` within
    ``raw``). Returns (tag, payload); always succeeds — structured if
    eligible (and, with SELF_CHECK, proven to round-trip), else zlib
    when it shrinks, else verbatim."""
    offs = np.asarray(offs, np.int64)
    try:
        got = try_encode_data(raw, offs)
    except Exception:
        got = None
    if got is None:
        try:
            got = try_encode_rollup(raw, offs)
        except Exception:
            got = None
    if got is not None:
        tag, enc = got
        if not SELF_CHECK:
            return tag, enc
        try:
            decoded = _decode_rollsum_raw(enc) if tag == ROLLSUM \
                else _decode_ts_raw(tag, enc)
            if decoded == raw:
                return tag, enc
        except Exception:
            pass
    z = zlib.compress(raw, 5)
    if len(z) < len(raw):
        return ZLIB, z
    return VERBATIM, raw


def encode_block_split(raw: bytes, offs) -> list:
    """Encode one pending run as one or more blocks:
    [(rel_raw_start, raw_slice, tag, payload)].

    Usually a single entry (= encode_block). But a run whose
    structured encode FAILS is probed at data-row metric boundaries
    (table + 3-byte key prefix): adjacent metrics of different value
    kinds — a float metric followed by an int metric — would otherwise
    force the whole run to zlib, and every fused gather covering the
    boundary block would decline. If splitting there lets at least one
    segment encode structurally, the run is emitted as one block per
    kind-segment (segments with equal probe outcomes are coalesced, so
    uid-table runs and single-kind runs stay one block)."""
    offs = np.asarray(offs, np.int64)
    tag, enc = encode_block(raw, offs)
    whole = [(0, raw, tag, enc)]
    if tag not in (ZLIB, VERBATIM) or len(offs) < 2:
        return whole
    n = len(raw)
    prefixes = []
    for o in offs:
        o = int(o)
        if o + 2 > n:
            return whole
        tlen = _U16_S.unpack_from(raw, o)[0]
        ko = o + 2 + tlen
        if ko + 2 > n:
            return whole
        klen = _U16_S.unpack_from(raw, ko)[0]
        if klen < 3 or ko + 5 > n:
            return whole
        prefixes.append(raw[o:o + 2 + tlen] + raw[ko + 2:ko + 5])
    bounds = [0] + [i for i in range(1, len(prefixes))
                    if prefixes[i] != prefixes[i - 1]]
    if len(bounds) < 2:
        return whole
    bounds.append(len(offs))

    def sub_run(i0: int, i1: int):
        lo = int(offs[i0])
        hi = int(offs[i1]) if i1 < len(offs) else n
        return raw[lo:hi], offs[i0:i1] - lo, lo

    segs: list = []  # (start record idx, structured tag or None)
    for gi in range(len(bounds) - 1):
        sraw, soffs, _ = sub_run(bounds[gi], bounds[gi + 1])
        try:
            got = try_encode_data(sraw, soffs)
        except Exception:
            got = None
        stag = got[0] if got is not None else None
        if not segs or segs[-1][1] != stag:
            segs.append((bounds[gi], stag))
    if len(segs) < 2 or all(s[1] is None for s in segs):
        return whole
    out = []
    starts = [s[0] for s in segs] + [len(offs)]
    for si in range(len(segs)):
        sraw, soffs, lo = sub_run(starts[si], starts[si + 1])
        stag, senc = encode_block(sraw, soffs)
        out.append((lo, sraw, stag, senc))
    return out


def decode_block(tag: int, enc, raw_len: int) -> bytes:
    """Exact raw record bytes of a block; raises BlockCodecError on an
    unknown tag or a payload that does not decode to ``raw_len``."""
    if tag == VERBATIM:
        out = bytes(enc)
    elif tag == ZLIB:
        try:
            out = zlib.decompress(enc)
        except zlib.error as e:
            raise BlockCodecError(f"zlib block: {e}") from None
    elif tag in (TSF32, TSINT):
        try:
            out = _decode_ts_raw(tag, enc)
        except BlockCodecError:
            raise
        except Exception as e:
            raise BlockCodecError(f"ts block decode failed: {e!r}") \
                from None
    elif tag == ROLLSUM:
        try:
            out = _decode_rollsum_raw(enc)
        except BlockCodecError:
            raise
        except Exception as e:
            raise BlockCodecError(
                f"rollsum block decode failed: {e!r}") from None
    else:
        raise BlockCodecError(f"unknown codec tag {tag}")
    if len(out) != raw_len:
        raise BlockCodecError(
            f"block decoded to {len(out)} bytes, header says {raw_len}")
    return out
