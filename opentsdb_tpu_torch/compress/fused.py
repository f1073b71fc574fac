"""Query-side source for the fused decode-aggregate path.

Mirrors ``opentsdb_tpu/compress/fused.py`` of the JAX package (numpy
only, copied: the port imports nothing of that package), with the same
decline reasons letter for letter.

``gather`` decides whether a [start, end] range of one metric can be
served straight from TSST4 blocks — exact-or-decline, the devwindow
contract: every generation holding range keys is v4 with disjoint key
ranges (store.encoded_range), every covering block is a TSF32 or
TSINT columnar block (one kind per gather — the stage's value inverse
is a compile-time static), and the caller has verified no
memtable-resident data overlaps the range (executor chunk_state). On
success it returns the concatenated per-point arrays
compress/kernels.fused_block_stage consumes plus the block-discovered
series directory (series keys -> sid) and, when a selector is pushed
down, the group segment map the apply kernels consume directly.

Declines raise ``Decline`` with a stable reason string — the executor
counts every one under compress.fused.decline{reason=} before falling
back to the scan path, so no decline is ever silent.

Host cost discipline, lazy per phase:
- block tag: one header read (sst.block_header), no parse;
- keys: parsed per selected block once (codecs.parse_ts_block
  keys_only) — range + tag-filter predicates run HERE, before any
  payload byte is touched, and non-matching blocks are skipped
  entirely;
- payload: nibble unpack + stream copies only for blocks that hold
  matching in-range records;
- qualifier-delta bounds (the duplicate-row overlay check): computed
  only when duplicate row keys are actually present across
  generations (single-generation gathers never pay it — sstable keys
  are unique within one file).
Everything parsed is cached on the (immutable) SSTable object; a
repeat query pays only numpy concatenation + one device dispatch.
"""

from __future__ import annotations

import numpy as np

from opentsdb_tpu_torch.compress import codecs
from opentsdb_tpu_torch.core.const import (MAX_TIMESPAN, TIMESTAMP_BYTES,
                                           UID_WIDTH)

_IDENT_LO = UID_WIDTH
_IDENT_HI = UID_WIDTH + TIMESTAMP_BYTES

_KIND = {codecs.TSF32: "f32", codecs.TSINT: "int"}


class Decline(Exception):
    """The fused path cannot serve this gather; ``reason`` is the
    stable label the executor counts under
    compress.fused.decline{reason=}. Always a correctness decline —
    the scan path serves the identical answer."""

    def __init__(self, reason: str):
        super().__init__(reason)
        self.reason = reason


class _BlockPrep:
    """Host-side arrays of one TSF32/TSINT block, independent of any
    query. Keys are parsed eagerly (the filter probe needs them);
    payload streams and delta bounds load lazily."""

    __slots__ = ("kind", "n", "base", "metric", "skeys", "local_sid",
                 "npts", "first_pt", "rec_of_pt", "P",
                 "ts_nb", "ts_pay", "v_nb", "v_pay",
                 "_pay_state", "_dmin", "_dmax")

    def __init__(self):
        self._pay_state = None   # None=unloaded, True=ok, str=reason
        self._dmin = None
        self._dmax = None

    def ensure_payload(self, sst, j: int) -> "str | None":
        """Load + validate the payload streams; None when the kernel
        can consume them, else the decline reason."""
        if self._pay_state is None:
            self._pay_state = self._load_payload(sst, j)
        return None if self._pay_state is True else self._pay_state

    def _load_payload(self, sst, j: int):
        try:
            tag, _raw_len, _enc_len = sst.block_header(j)
            b = codecs.parse_ts_block(tag, sst.block_enc(j))
        except Exception:
            return "block-ineligible"
        if int(b.ts_nb.max(initial=0)) > 4 \
                or int(b.v_nb.max(initial=0)) > 4:
            return "block-ineligible"
        if self.kind == "int":
            # The device inverse is an int32 modular cumsum cast to
            # f32; it is bit-exact iff every decoded value fits int32
            # (and the per-point deltas do too — implied by v_nb <= 4
            # checked above plus the value bound here).
            vals = b.int_values()
            if b.P and (int(vals.min()) < -(2**31)
                        or int(vals.max()) > 2**31 - 1):
                return "int-overflow"
        # COPIES, not views: parse_ts_block's streams view the
        # sstable's mmap, and a cached view would pin the map open
        # past close() (BufferError on shutdown).
        self.ts_nb = b.ts_nb.astype(np.int32)
        self.ts_pay = np.array(b.ts_pay, np.uint8, copy=True)
        self.v_nb = b.v_nb.astype(np.int32)
        self.v_pay = np.array(b.v_pay, np.uint8, copy=True)
        return True

    def delta_bounds(self):
        """Per-record qualifier-delta (min, max): the overlay check
        for a row-hour split across generations by a mid-hour
        checkpoint (disjoint delta ranges => the overlay is a pure
        union the kernel computes naturally). Lazy — only duplicate
        row keys across generations ever need it."""
        if self._dmin is None:
            ent = codecs._unzigzag(
                codecs._unpack_varbytes(self.ts_pay, self.ts_nb))
            first = self.first_pt[self.rec_of_pt]
            steps = codecs._seg_cumsum(ent, first)
            deltas = codecs._seg_cumsum(steps, first)
            self._dmin = np.minimum.reduceat(deltas, self.first_pt)
            self._dmax = np.maximum.reduceat(deltas, self.first_pt)
        return self._dmin, self._dmax


def _prep_keys(sst, j: int, table: str) -> "_BlockPrep | None":
    """Parse block ``j``'s keys once; None when the block is not a
    TSF32/TSINT data block of ``table`` (caller declines)."""
    cache = sst.__dict__.setdefault("_fused_prep", {})
    if j in cache:
        return cache[j]
    prep = None
    try:
        tag, _raw_len, _enc_len = sst.block_header(j)
        kind = _KIND.get(tag)
        if kind is not None:
            b = codecs.parse_ts_block(tag, sst.block_enc(j),
                                      keys_only=True)
            ok = (b.table == table.encode()
                  and b.n > 0
                  and not (b.klen < _IDENT_HI).any())
            if ok:
                K = b.K
                base = (K[:, _IDENT_LO].astype(np.int64) << 24) \
                    | (K[:, _IDENT_LO + 1].astype(np.int64) << 16) \
                    | (K[:, _IDENT_LO + 2].astype(np.int64) << 8) \
                    | K[:, _IDENT_LO + 3]
                skeys = []
                for i in range(b.n):
                    row = K[i]
                    skeys.append(row[:_IDENT_LO].tobytes()
                                 + row[_IDENT_HI:b.klen[i]].tobytes())
                uniq: dict[bytes, int] = {}
                local = np.empty(b.n, np.int32)
                for i, sk in enumerate(skeys):
                    sid = uniq.setdefault(sk, len(uniq))
                    local[i] = sid
                prep = _BlockPrep()
                prep.kind = kind
                prep.n, prep.P = b.n, b.P
                prep.npts = b.npts.astype(np.int64)
                prep.first_pt = b.first_pt.astype(np.int64)
                prep.rec_of_pt = b.rec_of_pt.astype(np.int32)
                prep.base = base
                prep.metric = K[:, :_IDENT_LO].copy()
                prep.local_sid = local
                prep.skeys = list(uniq)
    except Exception:
        prep = None
    cache[j] = prep
    return prep


class FusedSource:
    """Concatenated kernel inputs + the series directory for one
    (metric, range[, selector]) gather. ``spans`` is the
    encoded_range snapshot the arrays were built FROM — the
    executor's stage cache keys on (and pins) exactly these SSTable
    objects, so a checkpoint racing the gather can never get a stale
    stage cached under the new generation set.

    ``kind`` is the gather's value codec ("f32"/"int") — the stage's
    ``vkind`` static. ``groups`` maps each selector group key to its
    sid list (sids ascend by series key within a group, matching the
    scan path's float32 row-sum order). ``blocks`` carries the
    per-block structure [(sst, j, prep, rel_base_rec, sid_rec,
    valid_rec)] the device block-cache leg assembles from without the
    concatenated point stream; the per-point fields are None when the
    caller asked for ``points=False``."""

    __slots__ = ("ts_nb", "ts_pay", "v_nb", "v_pay", "first_idx",
                 "blk_first", "rel_base_pt", "sid_pt", "valid",
                 "series_keys", "epoch", "npoints", "spans", "kind",
                 "groups", "blocks")


def gather(store, table: str, metric_uid: bytes, b_lo: int,
           b_hi: int, selector=None, points: bool = True
           ) -> FusedSource:
    """Collect every block holding rows of ``metric_uid`` with base
    time in [b_lo, b_hi] from the store's v4 generations. Exact or
    ``Decline`` — any ineligible block, format, or overlay risk
    declines with a reason.

    ``selector(series_key) -> group_key_tuple | None`` is the pushed-
    down tag-filter/group-by predicate: it runs against the prefix-
    compressed block keys BEFORE payload decode, non-matching records
    are masked out, and blocks with no matching in-range records are
    skipped entirely (their payload bytes are never parsed). With
    ``points=False`` the concatenated per-point arrays are skipped
    too (the device block-cache leg rebuilds the point stream from
    per-block cached columns)."""
    start_key = metric_uid + b_lo.to_bytes(4, "big")
    stop_key = metric_uid + min(b_hi + MAX_TIMESPAN,
                                0xFFFFFFFF).to_bytes(4, "big")
    spans = store.encoded_range(table, start_key, stop_key)
    if spans is None:
        raise Decline("no-encoded-range")
    m = np.frombuffer(metric_uid, np.uint8)
    seen: set[bytes] = set()
    sel_memo: dict[bytes, tuple | None] = {}

    def group_of(sk: bytes):
        if selector is None:
            return ()
        try:
            return sel_memo[sk]
        except KeyError:
            g = sel_memo[sk] = selector(sk)
            return g

    parts = []           # (sst, j, prep, rec_mask)
    kinds: set[str] = set()
    total_pts = 0
    for sst, lo, hi in spans:
        keys, offs = sst._index[table]
        blk_ids = np.unique(
            np.searchsorted(sst._blk_raw,
                            np.asarray(offs[lo:hi], np.int64),
                            "right") - 1)
        for j in blk_ids.tolist():
            prep = _prep_keys(sst, j, table)
            if prep is None:
                raise Decline("block-ineligible")
            in_range = ((prep.base >= b_lo) & (prep.base <= b_hi)
                        & (prep.metric == m).all(axis=1))
            if selector is not None and in_range.any():
                keep = np.fromiter(
                    (group_of(sk) is not None for sk in prep.skeys),
                    bool, len(prep.skeys))
                in_range &= keep[prep.local_sid]
            if not in_range.any():
                continue
            for ls in np.unique(prep.local_sid[in_range]).tolist():
                seen.add(prep.skeys[ls])
            parts.append((sst, j, prep, in_range))
            kinds.add(prep.kind)
            total_pts += prep.P
    if not parts:
        src = FusedSource()
        src.npoints = 0
        src.series_keys = []
        src.groups = {}
        src.blocks = []
        src.kind = "f32"
        src.spans = spans
        return src
    if len(kinds) > 1:
        raise Decline("mixed-codec")
    # Payload streams only for surviving blocks — and only now.
    for sst, j, prep, _mask in parts:
        why = prep.ensure_payload(sst, j)
        if why is not None:
            raise Decline(why)
    # sid order = ascending series key: the scan path discovers series
    # in global key order; matching it keeps the group stage's
    # float32 row-sum order aligned with the scan's.
    sdir = {sk: i for i, sk in enumerate(sorted(seen))}
    luts = [np.fromiter((sdir.get(sk, 0) for sk in prep.skeys),
                        np.int64, len(prep.skeys))
            for _, _, prep, _ in parts]
    # Duplicate rows ACROSS generations (a mid-hour checkpoint splits
    # one row-hour over two spills): serveable only when the copies'
    # qualifier-delta ranges are disjoint — then the union the kernel
    # computes IS the overlay. Overlapping ranges could mean a
    # rewrite (newest-wins overlay) => decline to the scan path.
    # Keys are unique within one sstable, so single-generation
    # gathers skip the whole check (and its delta decode).
    if len(spans) > 1:
        rs = np.concatenate([lut[p.local_sid[mk]]
                             for (_, _, p, mk), lut
                             in zip(parts, luts)])
        rb = np.concatenate([p.base[mk] for _, _, p, mk in parts])
        rowkey = rs * np.int64(1 << 33) + rb
        order0 = np.argsort(rowkey, kind="stable")
        rk0 = rowkey[order0]
        if (rk0[1:] == rk0[:-1]).any():
            bounds = [p.delta_bounds() for _, _, p, _ in parts]
            rdn = np.concatenate([dn[mk] for (_, _, p, mk), (dn, _)
                                  in zip(parts, bounds)])
            rdx = np.concatenate([dx[mk] for (_, _, p, mk), (_, dx)
                                  in zip(parts, bounds)])
            order = np.lexsort((rdn, rowkey))
            rk = rowkey[order]
            dup_adj = rk[1:] == rk[:-1]
            if (rdx[order][:-1][dup_adj]
                    >= rdn[order][1:][dup_adj]).any():
                raise Decline("duplicate-overlap")
    epoch = min(int(p.base[mask].min()) for _, _, p, mask in parts)
    if any(int(p.base[mask].max()) - epoch > 2**31 - MAX_TIMESPAN - 1
           for _, _, p, mask in parts):
        raise Decline("int32-span")   # rel int32 would wrap
    src = FusedSource()
    src.kind = parts[0][2].kind
    src.series_keys = list(sdir)
    src.epoch = epoch
    src.spans = spans
    # Group segment map straight from the block keys: no host-side
    # re-partition after the gather. Selector-less gathers get the
    # single implicit group (the executor regroups as it always did).
    groups: dict[tuple, list[int]] = {}
    for sk, sid in sdir.items():
        g = group_of(sk)
        if g is not None:
            groups.setdefault(g, []).append(sid)
    src.groups = groups
    blocks = []
    for (sst, j, prep, rec_mask), lut in zip(parts, luts):
        lut = lut.astype(np.int32)
        blocks.append((sst, j, prep,
                       (prep.base - epoch).astype(np.int32),
                       lut[prep.local_sid],
                       rec_mask))
    src.blocks = blocks
    if not points:
        src.npoints = total_pts
        src.ts_nb = src.ts_pay = src.v_nb = src.v_pay = None
        src.first_idx = src.blk_first = None
        src.rel_base_pt = src.sid_pt = src.valid = None
        return src
    ts_nb = []
    v_nb = []
    ts_pay = []
    v_pay = []
    first_idx = []
    blk_first = []
    rel_base_pt = []
    sid_pt = []
    valid = []
    pt_off = 0
    for sst, j, prep, rel_base_rec, sid_rec, rec_mask in blocks:
        ts_nb.append(prep.ts_nb)
        v_nb.append(prep.v_nb)
        ts_pay.append(prep.ts_pay)
        v_pay.append(prep.v_pay)
        first_idx.append(prep.first_pt[prep.rec_of_pt] + pt_off)
        blk_first.append(np.full(prep.P, pt_off, np.int64))
        rel_base_pt.append(rel_base_rec[prep.rec_of_pt])
        sid_pt.append(sid_rec[prep.rec_of_pt])
        valid.append(rec_mask[prep.rec_of_pt])
        pt_off += prep.P
    src.npoints = pt_off
    src.ts_nb = np.concatenate(ts_nb)
    src.v_nb = np.concatenate(v_nb)
    src.ts_pay = np.concatenate(ts_pay) if ts_pay else \
        np.empty(0, np.uint8)
    src.v_pay = np.concatenate(v_pay) if v_pay else \
        np.empty(0, np.uint8)
    src.first_idx = np.concatenate(first_idx).astype(np.int32)
    src.blk_first = np.concatenate(blk_first).astype(np.int32)
    src.rel_base_pt = np.concatenate(rel_base_pt)
    src.sid_pt = np.concatenate(sid_pt)
    src.valid = np.concatenate(valid)
    return src


def block_shards(ts_nb, ts_pay, v_nb, v_pay, first_idx, blk_first,
                 rel_base, sid, valid, shards: int, pad_len):
    """Cut one concatenated point stream (``npoints = len(ts_nb)``, no
    padding) into ``shards`` runs of WHOLE blocks for the fused stage's
    mesh leg, balanced by point count: each cut is the block start
    nearest to d * P / D, so a shard holds at most P / D points plus one
    block. No record and no value chain crosses a block (``first_idx`` /
    ``blk_first`` are block-local plus the block's offset, and each
    block's XOR or delta chain restarts at its start), so each shard
    decodes alone.

    Each shard gets its own byte slices of the payloads (from the
    cumulative byte counts up to its cut) and its ``first_idx`` /
    ``blk_first`` rebased to its first point. Every shard pads to one
    length, ``pad_len(largest shard)``: padding points have nb = 0,
    ``first_idx`` = ``blk_first`` = their own index and valid = False,
    so they decode to zeros the stage masks out. Payloads pad to one
    power of two. A shard may be empty (fewer blocks than shards, or a
    block larger than P / D): it is all padding and adds nothing.

    Returns the nine stacked streams (``[D, P_shard]`` per point,
    ``[D, pay]`` uint8 payloads) in the stage's argument order, and each
    shard's point count."""
    P = len(ts_nb)
    blk_first = np.asarray(blk_first)
    starts = np.concatenate([[0], np.flatnonzero(np.diff(blk_first[:P]))
                             + 1]) if P else np.zeros(0, np.int64)
    cuts = [0]
    for d in range(1, shards):
        target = d * P / shards
        i = int(np.searchsorted(starts, target))
        best = P if i >= len(starts) else int(starts[i])
        if i > 0 and target - starts[i - 1] < best - target:
            best = int(starts[i - 1])
        cuts.append(max(best, cuts[-1]))
    cuts.append(P)
    counts = [b - a for a, b in zip(cuts[:-1], cuts[1:])]
    n_pad = pad_len(max(max(counts), 1))
    # Byte offsets of the cuts alone (no per-point prefix sums).
    ts_off = np.cumsum([0] + [int(ts_nb[a:b].sum(dtype=np.int64))
                              for a, b in zip(cuts[:-1], cuts[1:])])
    v_off = np.cumsum([0] + [int(v_nb[a:b].sum(dtype=np.int64))
                             for a, b in zip(cuts[:-1], cuts[1:])])
    pay_len = int(max(np.diff(ts_off).max(), np.diff(v_off).max()))
    pay_pad = 1 << (max(pay_len, 1) - 1).bit_length()
    out = [np.zeros((shards, n_pad), np.int32),
           np.zeros((shards, pay_pad), np.uint8),
           np.zeros((shards, n_pad), np.int32),
           np.zeros((shards, pay_pad), np.uint8),
           np.empty((shards, n_pad), np.int32),
           np.empty((shards, n_pad), np.int32),
           np.zeros((shards, n_pad), np.int32),
           np.zeros((shards, n_pad), np.int32),
           np.zeros((shards, n_pad), bool)]
    own = np.arange(n_pad, dtype=np.int32)
    for d, (a, b) in enumerate(zip(cuts[:-1], cuts[1:])):
        n = b - a
        out[0][d, :n] = ts_nb[a:b]
        out[1][d, :ts_off[d + 1] - ts_off[d]] = ts_pay[ts_off[d]:
                                                       ts_off[d + 1]]
        out[2][d, :n] = v_nb[a:b]
        out[3][d, :v_off[d + 1] - v_off[d]] = v_pay[v_off[d]:v_off[d + 1]]
        np.subtract(first_idx[a:b], a, out=out[4][d, :n], casting="unsafe")
        np.subtract(blk_first[a:b], a, out=out[5][d, :n], casting="unsafe")
        out[4][d, n:] = own[n:]
        out[5][d, n:] = own[n:]
        out[6][d, :n] = rel_base[a:b]
        out[7][d, :n] = sid[a:b]
        out[8][d, :n] = valid[a:b]
    return out, counts
