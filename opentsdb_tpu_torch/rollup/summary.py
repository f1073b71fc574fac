"""Rollup record format + batched window-summary math.

Mirrors ``opentsdb_tpu/rollup/summary.py`` of the JAX package: the record
and map formats, the host fold ``window_summaries``, ``combine_buckets``,
the numpy t-digest and HLL twins, the sketch cell codec and
``window_sketches`` are copied unchanged, so the port's tier stores the
JAX package's bytes. The device checkpoint fold
(``window_summaries_device``) runs the port's hand-written window-fold
kernel (``ops/rollup_fold.py``) in float64, and declares ``device-f64``;
the tier folds a whole (metric, coarse window) group in one launch
(``group_summaries_device``).
The mesh leg ``window_summaries_sharded`` folds many series over a mesh
through ``parallel/sharded.sharded_window_fold`` (float32, byte-identical
across mesh widths).

One rollup record summarizes one (series, coarse window) of raw points:
count / sum / min / max / first / last, plus — at sketch-bearing
resolutions — serialized t-digest centroids and HyperLogLog registers
over the window's values. Records are mergeable (Storyboard,
arXiv:2002.03063; t-digest, arXiv:1902.04023): moments combine by
sum/min/max, digests by concatenate+recompress, HLLs by register max —
so a planner can answer any window-aligned downsample by combining
whole-window records instead of re-reducing raw points.

Storage layout (tier.py): rollup rows live in a parallel per-shard
MemKVStore tier under ``rollup-<res>/`` with the SAME key shape as raw
rows — ``[metric:3][superwindow_base:4][tagk tagv]*`` — so series
routing, key regexps, and heapq-merge reads work unchanged. One rollup
row PACKS many consecutive windows into one map cell per kind
(qualifier = kind byte; value = idx-keyed entry map), the rollup
analog of the raw tier's 3600-points-per-row packing: a week of
hourly records is a handful of rows — and a handful of CELLS — per
series, not 168 (the generic sstable row format frames every cell
individually, so per-window cells made reads unpack-bound).

Bit-exactness contract: the planner promises rollup-served sum / count /
min / max / avg answers EQUAL the raw scan's (float64 CPU path) when
one bucket == one window. That pins the reduction algorithms here to
the oracle's: per-window ``sum`` must be ``np.sum`` of the time-sorted
float64 values (numpy's pairwise reduction — ``np.add.reduceat`` is
strictly sequential and diverges in the last bits once a segment
reaches numpy's 8-element unroll threshold, so long segments take a
per-segment ``np.sum``), ``avg`` is served as sum/count (bitwise equal
to ``np.mean`` = pairwise-sum / n), and min/max/count are order-free.
Multi-window buckets combine window sums sequentially — associativity
error only, within float64 tolerance of the raw answer.
"""

from __future__ import annotations

import struct

import numpy as np

# One moment record per (series, window). Little-endian packed; decoded
# in bulk with np.frombuffer, so a scan never parses records one by one.
REC_DTYPE = np.dtype([
    ("count", "<u4"),
    ("sum", "<f8"), ("min", "<f8"), ("max", "<f8"),
    ("first", "<f8"), ("last", "<f8"),
    ("first_dt", "<u4"), ("last_dt", "<u4"),   # ts - window_base
])
REC_SIZE = REC_DTYPE.itemsize

# Cell kinds within a rollup row: ONE cell per (superrow, kind) holding
# a whole window map. The qualifier is the single kind byte; the value
# concatenates per-window entries. Packing many windows into one cell
# matters on both sides: the generic sstable row format frames every
# cell individually (~2 us of struct unpacking per cell on read), so a
# per-window-cell layout made the rollup READ leg unpack-bound, and the
# fold paid the same framing per record in its WAL batches.
KIND_MOMENTS = 0
KIND_SKETCH = 1
QUAL_MOMENTS = bytes([KIND_MOMENTS])
QUAL_SKETCH = bytes([KIND_SKETCH])

# Moment-map entry: window idx within the superrow + the record.
ENTRY_DTYPE = np.dtype([("idx", "<u2"), ("rec", REC_DTYPE)])
ENTRY_SIZE = ENTRY_DTYPE.itemsize

_SK_HDR = struct.Struct("<HI")  # sketch-map entry header: idx, blob len

ROLLUP_FAMILY = b"r"


def pack_moment_map(entries: dict[int, bytes]) -> bytes:
    """Serialize {window idx -> REC_SIZE record bytes}, idx-sorted."""
    return b"".join(struct.pack("<H", i) + entries[i]
                    for i in sorted(entries))


def decode_moment_map(blob: bytes) -> np.ndarray:
    """Inverse of pack_moment_map -> ENTRY_DTYPE array (idx-sorted)."""
    return np.frombuffer(blob, ENTRY_DTYPE)


def merge_moment_map(blob: bytes, entries: dict[int, bytes]) -> bytes:
    """RMW merge: new entries REPLACE same-idx entries of the stored
    map (the tier's replace-from-raw write semantics)."""
    merged = {int(e["idx"]): bytes(memoryview(blob)[
        i * ENTRY_SIZE + 2:(i + 1) * ENTRY_SIZE])
        for i, e in enumerate(decode_moment_map(blob))}
    merged.update(entries)
    return pack_moment_map(merged)


def pack_sketch_map(entries: dict[int, bytes]) -> bytes:
    return b"".join(_SK_HDR.pack(i, len(entries[i])) + entries[i]
                    for i in sorted(entries))


def decode_sketch_map(blob: bytes) -> list[tuple[int, bytes]]:
    out = []
    off = 0
    n = len(blob)
    while off + _SK_HDR.size <= n:
        idx, ln = _SK_HDR.unpack_from(blob, off)
        off += _SK_HDR.size
        out.append((idx, blob[off:off + ln]))
        off += ln
    return out


def merge_sketch_map(blob: bytes, entries: dict[int, bytes]) -> bytes:
    merged = dict(decode_sketch_map(blob))
    merged.update(entries)
    return pack_sketch_map(merged)

# The downsample aggregators a moment record reconstructs EXACTLY.
EXACT_DSAGGS = ("sum", "count", "min", "max", "avg")

# numpy switches from the sequential loop to the 8-accumulator unrolled
# pairwise reduction at 8 elements; below that np.add.reduceat computes
# the identical float64 result.
_PAIRWISE_MIN = 8


# ---------------------------------------------------------------------------
# Batched window summaries (segment reductions over decoded columns)
# ---------------------------------------------------------------------------

def window_summaries(ts: np.ndarray, vals: np.ndarray, res: int,
                     ) -> tuple[np.ndarray, np.ndarray]:
    """Summarize one series' sorted points into per-window records.

    Returns (window_bases int64 [W], records REC_DTYPE [W]). One
    vectorized pass: segment boundaries from the base-time diff, then
    ufunc.reduceat reductions — except ``sum`` for segments at numpy's
    pairwise threshold, which re-reduce with np.sum per segment so the
    stored sum is bit-identical to the oracle's bucket sum (module
    docstring).
    """
    n = len(ts)
    if n == 0:
        return (np.empty(0, np.int64), np.empty(0, REC_DTYPE))
    bases = ts - ts % res
    starts = np.concatenate(([0], np.flatnonzero(np.diff(bases)) + 1))
    ends = np.concatenate((starts[1:], [n]))
    rec = np.empty(len(starts), REC_DTYPE)
    rec["count"] = (ends - starts).astype(np.uint32)
    rec["sum"] = np.add.reduceat(vals, starts)
    long = np.flatnonzero(ends - starts >= _PAIRWISE_MIN)
    for i in long:
        rec["sum"][i] = np.sum(vals[starts[i]:ends[i]])
    rec["min"] = np.minimum.reduceat(vals, starts)
    rec["max"] = np.maximum.reduceat(vals, starts)
    rec["first"] = vals[starts]
    rec["last"] = vals[ends - 1]
    wbase = bases[starts]
    rec["first_dt"] = (ts[starts] - wbase).astype(np.uint32)
    rec["last_dt"] = (ts[ends - 1] - wbase).astype(np.uint32)
    return wbase, rec


# ---------------------------------------------------------------------------
# Bucket combination (planner side)
# ---------------------------------------------------------------------------

def combine_buckets(wbase: np.ndarray, rec: np.ndarray, interval: int,
                    dsagg: str) -> tuple[np.ndarray, np.ndarray]:
    """Combine one series' window records (sorted by base, count > 0)
    into downsample buckets of ``interval`` (a multiple of the window
    resolution). Returns (bucket_ts int64, values float64) — exactly
    the per-series output of oracle.downsample(mode='aligned',
    bucket_ts='start') over the same raw points when every bucket is
    one window, and within float64 associativity tolerance otherwise.
    """
    if len(wbase) == 0:
        return (np.empty(0, np.int64), np.empty(0, np.float64))
    bbase = wbase - wbase % interval
    starts = np.concatenate(
        ([0], np.flatnonzero(np.diff(bbase)) + 1))
    counts = np.add.reduceat(rec["count"].astype(np.int64), starts)
    if dsagg == "count":
        vals = counts.astype(np.float64)
    elif dsagg == "sum":
        vals = np.add.reduceat(rec["sum"], starts)
    elif dsagg == "avg":
        vals = np.add.reduceat(rec["sum"], starts) / counts
    elif dsagg == "min":
        vals = np.minimum.reduceat(rec["min"], starts)
    elif dsagg == "max":
        vals = np.maximum.reduceat(rec["max"], starts)
    else:
        raise ValueError(f"rollup cannot reconstruct dsagg {dsagg!r}")
    return bbase[starts], vals


# ---------------------------------------------------------------------------
# Sketch columns: numpy t-digest + HLL (no device round trips at spill)
# ---------------------------------------------------------------------------

def digest_compress(means: np.ndarray, weights: np.ndarray,
                    k: int) -> tuple[np.ndarray, np.ndarray]:
    """k1-scale batch compression (the numpy twin of
    ops.sketches._compress / stats.collector.LatencyDigest): sort by
    mean, cluster by the arcsine scale on cumulative quantiles, segment
    reduce. Returns (means, weights) sorted, <= k centroids, empties
    dropped."""
    keep = weights > 0
    means, weights = means[keep], weights[keep]
    if len(means) <= k:
        order = np.argsort(means, kind="stable")
        return (means[order].astype(np.float32),
                weights[order].astype(np.float32))
    order = np.argsort(means, kind="stable")
    m, w = means[order].astype(np.float64), weights[order].astype(
        np.float64)
    total = max(w.sum(), 1e-30)
    q_mid = np.clip((np.cumsum(w) - w / 2) / total, 1e-9, 1 - 1e-9)
    kk = k / np.pi * np.arcsin(2 * q_mid - 1) + k / 2
    cluster = np.clip(kk.astype(np.int64), 0, k - 1)
    wsum = np.bincount(cluster, weights=w, minlength=k)
    msum = np.bincount(cluster, weights=m * w, minlength=k)
    nz = wsum > 0
    return ((msum[nz] / wsum[nz]).astype(np.float32),
            wsum[nz].astype(np.float32))


def digest_quantile(means: np.ndarray, weights: np.ndarray,
                    qs) -> np.ndarray:
    """Quantiles by interpolating centroid centers (numpy twin of
    ops.sketches.tdigest_quantile, support-clamped)."""
    if len(means) == 0:
        return np.full(len(np.atleast_1d(qs)), np.nan)
    order = np.argsort(means, kind="stable")
    m = means[order].astype(np.float64)
    w = weights[order].astype(np.float64)
    centers = (np.cumsum(w) - w / 2) / max(w.sum(), 1e-30)
    qs = np.clip(np.atleast_1d(np.asarray(qs, np.float64)), 0.0, 1.0)
    return np.interp(qs, centers, m)


def _hll_ranks(items: np.ndarray, p: int,
               ) -> tuple[np.ndarray, np.ndarray]:
    """(register index, rank) per item — the murmur3-finalizer HLL
    update decomposed so batched callers can scatter into MANY
    register sets at once."""
    h = items.astype(np.uint32)
    h ^= h >> np.uint32(16)
    h *= np.uint32(0x85EBCA6B)
    h ^= h >> np.uint32(13)
    h *= np.uint32(0xC2B2AE35)
    h ^= h >> np.uint32(16)
    idx = (h >> np.uint32(32 - p)).astype(np.int64)
    w = (h << np.uint32(p)) >> np.uint32(p)
    bits = np.zeros(len(w), np.int64)
    nz = w > 0
    bits[nz] = np.frexp(w[nz].astype(np.float64))[1]  # floor(log2)+1
    rank = np.where(nz, (32 - p) - (bits - 1), (32 - p) + 1)
    return idx, rank.astype(np.uint8)


def hll_update(regs: np.ndarray, items: np.ndarray) -> None:
    """Fold hashed items into uint8 registers in place (numpy twin of
    ops.sketches.hll_add: same murmur3 finalizer, so host- and
    device-folded registers merge coherently)."""
    p = int(np.log2(len(regs)))
    idx, rank = _hll_ranks(items, p)
    np.maximum.at(regs, idx, rank)


def hll_estimate(regs: np.ndarray) -> float:
    """Cardinality estimate with the small/large-range corrections of
    ops.sketches.hll_estimate."""
    m = len(regs)
    alpha = 0.7213 / (1.0 + 1.079 / m)
    inv = np.sum(np.exp2(-regs.astype(np.float64)))
    raw = alpha * m * m / inv
    zeros = float(np.sum(regs == 0))
    if raw <= 2.5 * m and zeros > 0:
        est = m * np.log(m / zeros)
    else:
        est = raw
    two32 = 2.0 ** 32
    if est > two32 / 30.0:
        est = -two32 * np.log1p(-est / two32)
    return float(est)


def sketch_encode(means: np.ndarray, weights: np.ndarray,
                  regs: np.ndarray | None,
                  moment_blob: bytes | None = None) -> bytes:
    """Serialize one window's sketch cell: digest centroids + optional
    HLL registers (p=0 marks absent) + — version 2 — an optional
    moment-sketch section (sketch/moment.py wire bytes, u16 length
    prefix). Version 1 cells (pre-moment tiers) decode unchanged."""
    n = len(means)
    p = int(np.log2(len(regs))) if regs is not None else 0
    ver = 2 if moment_blob is not None else 1
    out = (struct.pack("<BHB", ver, n, p)
           + means.astype("<f4").tobytes()
           + weights.astype("<f4").tobytes()
           + (regs.astype(np.uint8).tobytes() if regs is not None
              else b""))
    if moment_blob is not None:
        out += struct.pack("<H", len(moment_blob)) + moment_blob
    return out


def sketch_decode(blob: bytes):
    """Inverse of sketch_encode -> (means, weights, regs | None).
    (The digest/HLL view; sketch_decode_full adds the moment bytes.)"""
    return sketch_decode_full(blob)[:3]


def sketch_decode_full(blob: bytes):
    """-> (means, weights, regs | None, moment_blob | None)."""
    ver, n, p = struct.unpack_from("<BHB", blob, 0)
    if ver not in (1, 2):
        raise ValueError(f"unknown rollup sketch version {ver}")
    off = 4
    means = np.frombuffer(blob, "<f4", n, off)
    weights = np.frombuffer(blob, "<f4", n, off + 4 * n)
    off += 8 * n
    regs = None
    if p:
        regs = np.frombuffer(blob, np.uint8, 1 << p, off)
        off += 1 << p
    moment = None
    if ver >= 2 and off + 2 <= len(blob):
        (mlen,) = struct.unpack_from("<H", blob, off)
        off += 2
        moment = bytes(blob[off:off + mlen]) if mlen else None
    return means, weights, regs, moment


def window_sketches(ts: np.ndarray, vals: np.ndarray, res: int,
                    digest_k: int, hll_p: int, moment_k: int = 0,
                    kind_bytes: dict | None = None):
    """Per-window sketch cells for one series: (bases, [blob]).
    Digest over the window's float32-cast values; HLL over their bit
    patterns (distinct-value estimates; hashable ints for hll_update);
    moment sketch (power + log-power sums, sketch/moment.py) over the
    same float32-cast values so both quantile columns see identical
    quantization. ``kind_bytes`` (mutated in place when given)
    accumulates encoded bytes per column kind — the
    ``sketch.bytes{kind=}`` accounting.
    """
    n = len(ts)
    if n == 0:
        return np.empty(0, np.int64), []
    v32 = vals.astype(np.float32)
    bases = ts - ts % res
    starts = np.concatenate(([0], np.flatnonzero(np.diff(bases)) + 1))
    ends = np.concatenate((starts[1:], [n]))
    W = len(starts)
    # Batched columns (the fold's hot loop at fine resolutions: 17.5M
    # hourly windows on the 100M corpus — per-window python folds cost
    # ~120 us each, reduceat passes ~10 us):
    # - moment power sums: one cumulative-product ladder over ALL
    #   points, segment-reduced per window (+ the log ladder for
    #   all-positive windows);
    # - HLL: hash every value once, scatter ranks into a [W, 2^p]
    #   register block with ONE maximum.at.
    moments = None
    if moment_k:
        v64 = v32.astype(np.float64)
        powers = np.empty((moment_k, n))
        p = v64.copy()
        for i in range(moment_k):
            powers[i] = p
            if i + 1 < moment_k:
                p = p * v64
        msums = np.add.reduceat(powers, starts, axis=1)     # [k, W]
        wmin = np.minimum.reduceat(v64, starts)
        wmax = np.maximum.reduceat(v64, starts)
        counts = (ends - starts).astype(np.float64)
        has_log = wmin > 0
        lsums = None
        if has_log.any():
            lv = np.log(np.maximum(v64, 1e-300))
            lpow = np.empty((moment_k, n))
            p = lv.copy()
            for i in range(moment_k):
                lpow[i] = p
                if i + 1 < moment_k:
                    p = p * lv
            lsums = np.add.reduceat(lpow, starts, axis=1)
        moments = (counts, wmin, wmax, msums, has_log, lsums)
    regs_all = None
    if hll_p:
        idx, rank = _hll_ranks(v32.view(np.uint32), hll_p)
        win_of_point = np.repeat(np.arange(W, dtype=np.int64),
                                 ends - starts)
        regs_all = np.zeros(W << hll_p, np.uint8)
        np.maximum.at(regs_all, (win_of_point << hll_p) + idx, rank)
        regs_all = regs_all.reshape(W, 1 << hll_p)
    blobs = []
    from opentsdb_tpu_torch.sketch.moment import from_arrays
    for j, (s, e) in enumerate(zip(starts, ends)):
        if digest_k:
            m, w = digest_compress(v32[s:e].astype(np.float64),
                                   np.ones(e - s), digest_k)
        else:
            m = w = np.empty(0, np.float32)
        regs = regs_all[j] if regs_all is not None else None
        moment = None
        if moments is not None:
            counts, wmin, wmax, msums, has_log, lsums = moments
            if has_log[j] and lsums is not None:
                sk = from_arrays(counts[j], wmin[j], wmax[j],
                                 msums[:, j], lsums[:, j])
            else:
                sk = from_arrays(counts[j], wmin[j], wmax[j],
                                 msums[:, j])
            moment = sk.encode()
        if kind_bytes is not None:
            kind_bytes["tdigest"] = (kind_bytes.get("tdigest", 0)
                                     + 8 * len(m))
            if regs is not None:
                kind_bytes["hll"] = kind_bytes.get("hll", 0) + len(regs)
            if moment is not None:
                kind_bytes["moment"] = (kind_bytes.get("moment", 0)
                                        + len(moment))
        blobs.append(sketch_encode(m, w, regs, moment))
    return bases[starts], blobs


# ---------------------------------------------------------------------------
# Mesh-sharded window fold (the execution plane's rollup-fold leg)
# ---------------------------------------------------------------------------

def window_summaries_sharded(series, res: int, mesh):
    """Fold MANY series' points into per-window records across a mesh
    (the JAX package's function of the same name).

    ``series``: [(ts int64 sorted + deduplicated, vals)], the inputs
    :func:`window_summaries` takes one at a time. The fold shards over
    the mesh's series-hash axis (``parallel/sharded.sharded_window_fold``):
    each shard folds its series block, the combine is a gather, so the
    answer is byte-identical across mesh widths.

    Returns [(wbase int64 [W_i], rec float32 structured array with
    count / sum / min / max / first / last / first_dt / last_dt)] per
    series. float32, as in the JAX package: this fold serves mesh
    batteries and read-side pipelines; the checkpoint fold stays the
    float64 one above."""
    from opentsdb_tpu_torch.parallel.sharded import (
        pack_shards,
        shard_placement,
        sharded_window_fold,
    )

    out_dtype = np.dtype([
        ("count", "<f4"), ("sum", "<f4"), ("min", "<f4"),
        ("max", "<f4"), ("first", "<f4"), ("last", "<f4"),
        ("first_dt", "<u4"), ("last_dt", "<u4")])
    if not series:
        return []
    nonempty = [i for i, (ts, _) in enumerate(series) if len(ts)]
    results = [(np.empty(0, np.int64), np.empty(0, out_dtype))
               for _ in series]
    if not nonempty:
        return results
    origin = min(int(series[i][0][0]) for i in nonempty)
    origin -= origin % res
    hi = max(int(series[i][0][-1]) for i in nonempty)
    num_windows = int((hi - origin) // res) + 1
    D = int(mesh.devices.size)
    packed = [(np.asarray(series[i][0], np.int64) - origin,
               np.asarray(series[i][1], np.float32)) for i in nonempty]
    ts, vals, sid, valid, sps = pack_shards(packed, D)
    grids = sharded_window_fold(
        ts, vals, sid, valid, mesh=mesh, series_per_shard=sps,
        num_windows=num_windows, res=res).cpu().numpy()
    for gi, (d, local) in zip(nonempty, shard_placement(len(packed), D)):
        g = grids[d, :, local, :]                  # [8, W]
        mask = g[0] > 0
        w_idx = np.flatnonzero(mask)
        rec = np.empty(len(w_idx), out_dtype)
        for j, name in enumerate(("count", "sum", "min", "max", "first",
                                  "last")):
            rec[name] = g[j][mask]
        wbase = origin + w_idx.astype(np.int64) * res
        # The timestamp planes are int32 bits in the float32 grid.
        t_min = np.ascontiguousarray(g[6][mask]).view(np.int32)
        t_max = np.ascontiguousarray(g[7][mask]).view(np.int32)
        rec["first_dt"] = (t_min.astype(np.int64)
                           + origin - wbase).astype(np.uint32)
        rec["last_dt"] = (t_max.astype(np.int64)
                          + origin - wbase).astype(np.uint32)
        results[gi] = (wbase, rec)
    return results


# ---------------------------------------------------------------------------
# Device CHECKPOINT fold (opt-in, declared storage contract)
# ---------------------------------------------------------------------------
#
# window_summaries (above) is the canonical float64 host fold with the
# bit-exactness contract against raw float64 scans. Config.
# rollup_device_fold moves it onto the card: the window-fold kernel
# accumulates in float64, but in its own fixed order, not numpy's
# pairwise one, so the records are tolerance-level (sum within rtol
# 1e-12; count, min, max, first, last and the brackets exact) and the
# tier declares the kind in its state file. A kind change rebuilds the
# tier like any layout change.

# Spans the int32 rebase cannot carry, or grids wider than this, take
# the host fold (the JAX package's domain rule).
_DEVICE_MAX_WINDOWS = 1 << 22


def device_fold_kind() -> str:
    """The storage-contract label of the device checkpoint fold: the
    kernel and its plain version both accumulate in float64, on the card
    and on the CPU alike."""
    return "device-f64"


def _records(count, total, mn, mx, first, last, t_first, t_last, origin,
             res) -> tuple[np.ndarray, np.ndarray]:
    """(window_bases, REC_DTYPE records) of the non-empty windows of a
    fold's per-window columns (windows from ``origin``, row-major)."""
    mask = count > 0
    w_idx = np.flatnonzero(mask)
    if count.ndim > 1:
        w_idx = w_idx % count.shape[-1]
    rec = np.empty(len(w_idx), REC_DTYPE)
    rec["count"] = count[mask].astype(np.uint32)
    rec["sum"] = total[mask]
    rec["min"] = mn[mask]
    rec["max"] = mx[mask]
    rec["first"] = first[mask]
    rec["last"] = last[mask]
    wbase = origin + w_idx.astype(np.int64) * res
    rec["first_dt"] = (t_first[mask].astype(np.int64)
                       + origin - wbase).astype(np.uint32)
    rec["last_dt"] = (t_last[mask].astype(np.int64)
                      + origin - wbase).astype(np.uint32)
    return wbase, rec


def group_summaries(ts: np.ndarray, vals: np.ndarray, bounds: np.ndarray,
                    origin: int, span: int, resolutions,
                    fold=window_summaries) -> list:
    """The host kind's group fold: ``fold`` (by default
    :func:`window_summaries`) of each series of one group at every
    resolution, in the layout of :func:`group_summaries_device` --
    per resolution ``(window_bases, records, starts)``, series ``j``'s
    records at ``[starts[j], starts[j + 1])``. ``origin`` and ``span``
    are the group's window; a one-series fold needs neither."""
    out = []
    for r in resolutions:
        parts = [fold(ts[a:b], vals[a:b], int(r))
                 for a, b in zip(bounds[:-1], bounds[1:])]
        out.append((
            np.concatenate([wb for wb, _ in parts]
                           or [np.empty(0, np.int64)]),
            np.concatenate([rec for _, rec in parts]
                           or [np.empty(0, REC_DTYPE)]),
            np.concatenate(([0], np.cumsum(
                [len(wb) for wb, _ in parts], dtype=np.int64))
            ).astype(np.int64)))
    return out


def group_summaries_device(ts: np.ndarray, vals: np.ndarray,
                           bounds: np.ndarray, origin: int, span: int,
                           resolutions, device="cuda") -> list:
    """:func:`window_summaries` of every series of one group at every
    resolution, in ONE launch of the window-fold kernel
    (``ops/rollup_fold.window_fold_batch``) and one read-back.

    ``ts`` / ``vals`` are the group's columns, series ``j`` at
    ``[bounds[j], bounds[j + 1])``, each sorted (the tier's lexsorted,
    deduplicated columns); every point lies in ``[origin, origin +
    span)``, and each resolution divides ``span``. Returns, per
    resolution, ``(window_bases, records, starts)``: series ``j``'s
    records are ``[starts[j], starts[j + 1])``, the same ones
    :func:`window_summaries_device` gives it, byte for byte (the same
    windows, the same order of addition). Unsorted input raises after
    the read-back. The domain rule of the one-series entry (a span past
    int32, more than 2^22 windows) cannot meet a group, which spans one
    coarse window: such a group, or a point outside it, raises."""
    import torch

    from opentsdb_tpu_torch.ops import rollup_fold

    resolutions = [int(r) for r in resolutions]
    windows = [span // r for r in resolutions]
    if span > 2**31 - 1 or any(span % r or not 0 < W <= _DEVICE_MAX_WINDOWS
                               for r, W in zip(resolutions, windows)):
        raise ValueError(f"a group's fold takes a span of at most int32 "
                         f"seconds that each resolution divides, in at "
                         f"most 2^22 windows: span {span}, {resolutions}")
    rel = np.asarray(ts, np.int64) - origin
    if len(rel) and (rel.min() < 0 or rel.max() >= span):
        raise ValueError(f"a point lies outside the group's window "
                         f"[{origin}, {origin + span})")
    S = len(bounds) - 1
    dev = torch.device(device)
    icol, fcol = rollup_fold.read_back(*rollup_fold.window_fold_batch(
        torch.from_numpy(rel.astype(np.int32)).to(dev, non_blocking=True),
        torch.from_numpy(np.ascontiguousarray(vals, np.float64)).to(
            dev, non_blocking=True),
        torch.from_numpy(np.asarray(bounds, np.int64)).to(
            dev, non_blocking=True),
        res=resolutions, num_windows=windows))
    slot0 = rollup_fold.grid_slots(S, windows)
    out = []
    for i, (r, W) in enumerate(zip(resolutions, windows)):
        cols = [c[slot0[i]:slot0[i + 1]].reshape(S, W)
                for c in (*icol, *fcol)]
        count, t_first, t_last, total, mn, mx, first, last = cols
        wb, rec = _records(count, total, mn, mx, first, last, t_first,
                           t_last, origin, r)
        starts = np.concatenate(([0], np.cumsum(
            (count > 0).sum(axis=1)))).astype(np.int64)
        out.append((wb, rec, starts))
    return out


def window_summaries_device(ts: np.ndarray, vals: np.ndarray, res: int,
                            device="cuda",
                            ) -> tuple[np.ndarray, np.ndarray]:
    """:func:`window_summaries` computed by the window-fold kernel
    (``ops/rollup_fold.window_fold``) on ``device``: the same
    ``(window_bases, REC_DTYPE records)``, empty windows dropped.

    ``ts`` must be sorted (every caller passes the lexsorted, deduplicated
    columns of one series); unsorted input raises. A span past int32 or
    more than 2^22 windows takes the host fold; nothing else does: a
    failed build or launch raises."""
    import torch

    from opentsdb_tpu_torch.ops import rollup_fold

    n = len(ts)
    if n == 0:
        return (np.empty(0, np.int64), np.empty(0, REC_DTYPE))
    origin = int(ts[0]) - int(ts[0]) % res
    span = int(ts[-1]) - origin
    num_windows = span // res + 1
    if span > 2**31 - 1 or num_windows > _DEVICE_MAX_WINDOWS:
        return window_summaries(ts, vals, res)
    dev = torch.device(device)
    rel = torch.from_numpy((np.asarray(ts, np.int64) - origin)
                           .astype(np.int32)).to(dev, non_blocking=True)
    v = torch.from_numpy(np.ascontiguousarray(vals, np.float64)).to(
        dev, non_blocking=True)
    (count, total, mn, mx, first, last, t_first,
     t_last) = rollup_fold.to_numpy(rollup_fold.window_fold(
         rel, v, num_windows=num_windows, res=res))
    return _records(count, total, mn, mx, first, last, t_first, t_last,
                    origin, res)
