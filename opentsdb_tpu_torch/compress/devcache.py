"""Device-side cache of decoded block columns for the fused path.

Mirrors ``opentsdb_tpu/compress/devcache.py`` of the JAX package; the
columns live on the owning TSDB's torch device, and the decode is the
hand-written kernel (``compress/kernels.block_decode_columns``).

The byte-stream fused leg re-uploads and re-decodes every covering
block's payload streams on each dispatch. This cache keeps a gather's
QUERY-INDEPENDENT decoded columns resident on device — per-point
qualifier deltas (int32), decoded values (float32), and the
point->record map — so a repeat query over warm blocks uploads only
per-RECORD arrays (base time, series id, validity: ~two orders of
magnitude smaller than the point stream) plus, for selective tag
filters, the matched-point index vector, and runs
compress/kernels.devcache_window_stage with zero payload bytes moved.

Entries are WHOLE-GATHER: one entry per (vkind, ordered block set),
decoded in ONE batched kernel call (per-block entries would cost a
device dispatch per block). The padded sizes follow the JAX package's
ladder (``pad_fine``), so both packages decode identical streams.

Holding the SSTable OBJECTS in the key both identifies the generation
set and pins it against id reuse — a dropped generation's entries go
unreachable with it, they can never alias a new file. The bound is
total cached POINTS (Config.devblock_points), the same cost-bounded
LRU discipline as the executor's fragment cache.

Answers are bit-identical to the byte-stream fused program: identical
decode math on the identical concatenated stream (the XOR/delta
chains never cross block boundaries), identical point order, and
padding points decode to zeros and map to a trailing pad record the
stage marks invalid.

Counters: compress.devcache.{hit,miss,evict}.
"""

from __future__ import annotations

import numpy as np

import torch

from opentsdb_tpu_torch.obs.registry import METRICS
from opentsdb_tpu_torch.utils.lru import LRUCache

_HIT = METRICS.counter("compress.devcache.hit")
_MISS = METRICS.counter("compress.devcache.miss")
_EVICT = METRICS.counter("compress.devcache.evict")


def _pad_pow2(n: int) -> int:
    p = 1
    while p < n:
        p <<= 1
    return p


def pad_fine(n: int) -> int:
    """Smallest of {2^k, 1.25*2^k, 1.5*2^k, 1.75*2^k} >= n (k >= 6):
    the fused path's point-stream size ladder, the JAX package's (whose
    compiled shapes it bounds to four classes an octave). Quarter steps
    cap the padding tail's waste at 25%; the same ladder keeps both
    packages' decoded streams identical, padding included."""
    p = 64
    while p < n:
        p <<= 1
    h = p >> 1
    for m in (h * 5) >> 2, (h * 3) >> 1, (h * 7) >> 2:
        if m >= n:
            return m
    return p


class DeviceBlockCache:
    """Bounded LRU of per-gather decoded device columns on ``device``."""

    def __init__(self, max_points: int, device) -> None:
        # max_entries is a backstop; the real bound is point count.
        self.lru = LRUCache(max_entries=4096, max_cost=int(max_points))
        self.device = device

    def __len__(self) -> int:
        return len(self.lru)

    def columns(self, src):
        """(qd, vals, rec_of_pt, P, P_pad, R) device columns for one
        gather — decoded on miss in one batched dispatch over the
        concatenated streams, then cached at cost = padded point
        count. ``rec_of_pt`` maps every point to its gather-global
        record; the padding tail maps to pad record ``R`` (one past
        the last real record), which every query's per-record upload
        marks invalid. P_pad is strictly greater than P so index P is
        always a safe invalid target for selector padding."""
        key = (src.kind,) + tuple(
            (sst, j) for sst, j, *_ in src.blocks)
        ent = self.lru.get(key)
        if ent is not None:
            _HIT.inc()
            return ent
        _MISS.inc()
        from opentsdb_tpu_torch.compress import kernels as _ck
        ts_nb, v_nb, ts_pay, v_pay = [], [], [], []
        first_idx, blk_first, rec = [], [], []
        pt_off = 0
        roff = 0
        for sst, j, prep, _rb, _sid, _mask in src.blocks:
            ts_nb.append(prep.ts_nb)
            v_nb.append(prep.v_nb)
            ts_pay.append(prep.ts_pay)
            v_pay.append(prep.v_pay)
            first_idx.append(prep.first_pt[prep.rec_of_pt] + pt_off)
            blk_first.append(np.full(prep.P, pt_off, np.int64))
            rec.append(prep.rec_of_pt.astype(np.int64) + roff)
            pt_off += prep.P
            roff += prep.n
        P = pt_off
        P_pad = pad_fine(P + 1)

        def padded(cat, fill_idx):
            # Padding points decode to exact zeros: nb == 0 and
            # first/blk indices pointing at themselves (empty chain).
            out = (np.arange(P_pad, dtype=np.int32) if fill_idx
                   else np.zeros(P_pad, np.int32))
            out[:P] = np.concatenate(cat)
            return out

        def padbuf(chunks):
            # Payload bytes pad to a power of two, as in the JAX
            # package: decode work is per POINT, so byte padding costs
            # only upload bytes.
            cat = np.concatenate(chunks) if chunks else \
                np.empty(0, np.uint8)
            out = np.zeros(_pad_pow2(max(len(cat), 1)), np.uint8)
            out[:len(cat)] = cat
            return out

        def up(a):
            return torch.from_numpy(a).to(self.device)

        qd, vals = _ck.block_decode_columns(
            up(padded(ts_nb, False)), up(padbuf(ts_pay)),
            up(padded(v_nb, False)), up(padbuf(v_pay)),
            up(padded(first_idx, True)), up(padded(blk_first, True)),
            vkind=src.kind)
        rec_np = np.full(P_pad, roff, np.int32)
        rec_np[:P] = np.concatenate(rec)
        ent = (qd, vals, up(rec_np), P, P_pad, roff)
        before = self.lru.evictions
        self.lru.put(key, ent, cost=P_pad)
        d = self.lru.evictions - before
        if d:
            _EVICT.inc(d)
        return ent

    @staticmethod
    def record_inputs(src, S_cap: int, selective: bool):
        """Host-side per-query uploads for the cached columns:
        (rel_base, sid, valid) per gather-global record (pow-2 padded,
        the trailing pad record invalid) plus, when ``selective`` and
        the selector actually drops records, the matched-point index
        vector (padded with index P — the guaranteed-invalid pad
        point). sid is clipped to S_cap - 1, mirroring the byte leg's
        padding discipline."""
        rb, sd, vd, vpt = [], [], [], []
        nrec = 0
        for _sst, _j, prep, rel_base_rec, sid_rec, rec_mask \
                in src.blocks:
            rb.append(rel_base_rec)
            sd.append(np.minimum(sid_rec, S_cap - 1))
            vd.append(rec_mask)
            if selective:
                vpt.append(rec_mask[prep.rec_of_pt])
            nrec += prep.n
        R_pad = _pad_pow2(nrec + 1)

        def padrec(chunks, dtype, fill=0):
            out = np.full(R_pad, fill, dtype)
            cat = np.concatenate(chunks)
            out[:len(cat)] = cat
            return out

        sel = None
        if selective:
            valid_pt = np.concatenate(vpt) if vpt else \
                np.empty(0, bool)
            matched = np.flatnonzero(valid_pt)
            if len(matched) < len(valid_pt):
                M_pad = pad_fine(max(len(matched), 1))
                sel = np.full(M_pad, len(valid_pt), np.int32)
                sel[:len(matched)] = matched
        return (padrec(rb, np.int32), padrec(sd, np.int32),
                padrec(vd, bool, False), sel)
