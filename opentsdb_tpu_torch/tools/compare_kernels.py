"""Time the hand-written kernels of several checkouts of this repo against
each other on one NVIDIA card, at the shapes of the query paths.

    git archive <rev> | tar -x -C DIR      # one directory per revision
    python -m opentsdb_tpu_torch.tools.compare_kernels [--kernels K,..] \\
        DIR [DIR ...]

Kernels (``--kernels``, default all six):
- ``segment_reduce``: ``segment_sum_f32`` and ``segment_minmax_f32`` at
  the group-stage shapes;
- ``masked_select``: ``masked_select_columns`` on the resident window's
  ``sum:1h-avg`` stage grid [16384, 256] at q = 0.95 and at p50/p95/p99,
  ``masked_select_groups`` on it by dc (16 groups) and by host (16384),
  and the columns entry on the contributions of a p95 over ``{dc=dc0}``'s
  first day on its union grid [1000, ~41.6k];
- ``interp_moments``: ``interp_moments_f32`` on that day's union grid and
  on all 10,000 series for the week (~302k grid points);
- ``sketches``: ``hll_fold_i32`` and ``hll_estimate_f32`` at
  chip_smoke.py's HLL shapes (``hll_cases``), ``tdigest_fold_f32`` at
  one ingest hand-off and at the 4096-value chunk,
  ``tdigest_merged_quantile_f32`` over all 10,000 series' digests (each
  revision's own scratch size); the t-digest fold's outputs must be
  bit-identical between the revisions;
- ``block_decode``: ``block_decode_points`` on synthetic byte-stream
  gathers from a seed at the smoke's three sizes (the week's 10,485,760
  padded points, the day's 1,572,864, the TSINT week's 40,960; TSF32,
  records of 360 points, blocks of 120 records, the fused leg's
  padding), bit for bit against ``decode_points_plain``; a revision with
  ``block_decode_state_words`` gets its status words (zeroed once) and a
  new tag a call, an older one its scratch;
- ``smoothing``: ``ewma_scan_f32`` (alpha 0.3) at /forecast's two grids
  of the corpus, each series' hourly mean (169 x 10,000) and each dc's
  five-minute sum of its hosts' means (2,017 x 10). Each revision is called
  through its own C signature (the segmented scan's takes its checkout's
  ``EWMA_SEGMENT``) and held bit for bit against its own checkout's plain
  version (NaN cells as NaN), and every revision against the first within
  the models' tolerance (rtol 1e-5 plus 1e-5 x the series' largest
  |value|): revisions may differ in their order of operations.
The data is ``chip_smoke.py``'s corpus (10,000 series x 1,000 points over
7 days, drawn from seed 0), staged by this checkout's own functions.

Each DIR's ``opentsdb_tpu_torch/csrc/<kernel>.cu`` is built with nvcc (the
port's own flags, all builds started together) and called through its C
interface, so revisions whose wrappers differ compare on the same inputs.
Each case is checked against this checkout's plain PyTorch version (the
select bit for bit; interp_moments' count, min and max exactly and its
total within rtol 1e-5, at full width on 4,096 grid points drawn with a
seed, where the plain composition fits) and timed as device time per call:
20 calls queued back to back behind a GPU sleep, outputs filled before the
calls and not refilled; and as chip_smoke.py's ``ms`` (the median of 20
single calls from an idle card: the C entry point's host time counts,
the same Python for every revision). The revisions run in turns A B .. B
A, twice.
``segment_minmax_f32`` is asked for both outputs, the one request every
revision answers. One JSON line per case goes to standard output, after
the card's name and power limit; with ``--breakdown`` a second line gives
each revision's device time per kernel name (``torch.profiler``, 5 calls).
"""

from __future__ import annotations

import argparse
import ctypes
import importlib.util
import json
import os
import subprocess
import sys
from typing import Callable, NamedTuple

import numpy as np
import torch

from opentsdb_tpu_torch.compress.devcache import pad_fine
from opentsdb_tpu_torch.ops import block_decode, interp_moments, \
    kernels as wk, masked_select, sketches
from opentsdb_tpu_torch.ops.cuda_build import NVCC_FLAGS, _nvcc
from opentsdb_tpu_torch.query.executor import _pad_size
from opentsdb_tpu_torch.stats.livesketch import LiveSketches, _pad
from opentsdb_tpu_torch.utils.config import Config

SOURCES = ("segment_reduce", "masked_select", "interp_moments", "sketches",
           "block_decode", "smoothing")
S, B, SERIES = 16384, 256, 10_000    # chip_smoke.py's group stage
POINTS, SPAN, DAY, INTERVAL = 1_000, 7 * 86400, 86400, 3600
BASE = 1356998400


def bind(lib: ctypes.CDLL, kernel: str) -> ctypes.CDLL:
    """Set the argument types of ``kernel``'s C entry points."""
    p, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int32
    if kernel == "segment_reduce":
        lib.segment_sum_f32.argtypes = [p, p, i64, i32, i64, p, p]
        lib.segment_minmax_f32.argtypes = [p, p, i64, i32, i64, p, p, p]
    elif kernel == "masked_select":
        lib.masked_select_columns.argtypes = [p, p, i64, i64, p, i32, p, p]
        lib.masked_select_groups.argtypes = [p, p, i64, i64, p, p, i64, p,
                                             i64, p, i32, p, p]
    elif kernel == "block_decode":
        lib.block_decode_scratch_words.argtypes = [i64]
        lib.block_decode_scratch_words.restype = i64
        tail = [p, p, p, p]
        if hasattr(lib, "block_decode_state_words"):
            lib.block_decode_state_words.argtypes = [i64]
            lib.block_decode_state_words.restype = i64
            tail = [p, ctypes.c_uint32, p, p, p, p]
        lib.block_decode_points.argtypes = [p, p, i64, p, p, i64, p, p, p,
                                            i32, i32, i64] + tail
    elif kernel == "smoothing":
        lib.ewma_scan_f32.restype = ctypes.c_int
    elif kernel == "interp_moments":
        lib.interp_moments_f32.argtypes = [p, p, p, i64, i64, p, i64, i32,
                                           p, p, p, p, p, p]
    else:
        lib.tdigest_fold_f32.argtypes = [p, p, i64, i32, p, i64, p, p, p,
                                         i32, p]
        lib.tdigest_merged_quantile_f32.argtypes = [
            p, p, i32, p, p, i64, p, i32, i32, p, i64, p, p]
        lib.tdigest_merged_quantile_scratch.argtypes = [i64, i32]
        lib.tdigest_merged_quantile_scratch.restype = i64
        lib.hll_fold_i32.argtypes = [p, i64, i32, p, i64, p, p, i32, p]
        lib.hll_estimate_f32.argtypes = [p, i64, i32, p, p]
    return lib


def build(dirs: list[str], kernels=SOURCES) -> list[dict]:
    """Per DIR, {kernel: its loaded library}, every nvcc started at once."""
    jobs = []
    for d in dirs:
        for k in kernels:
            out = os.path.join(d, f"_compare_{k}.so")
            jobs.append((d, k, out, subprocess.Popen(
                [_nvcc(), *NVCC_FLAGS, "-o", out,
                 os.path.join(d, "opentsdb_tpu_torch", "csrc", k + ".cu")],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT)))
    libs: dict[str, dict] = {d: {} for d in dirs}
    for d, k, out, proc in jobs:
        log = proc.communicate()[0].decode(errors="replace")
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {out}:\n{log}")
        libs[d][k] = bind(ctypes.CDLL(os.path.abspath(out)), k)
        if k == "smoothing":
            own_smoothing(libs[d][k], d)
    return [libs[d] for d in dirs]


def own_smoothing(lib: ctypes.CDLL, d: str) -> None:
    """Bind ``ewma_scan_f32`` by DIR's own signature, and attach DIR's
    plain ``ewma_scan_plain`` (``lib.plain``) and segment (``lib.segment``:
    None before the segmented scan)."""
    path = os.path.join(d, "opentsdb_tpu_torch", "ops", "smoothing.py")
    spec = importlib.util.spec_from_file_location(
        f"_compare_smoothing_{abs(hash(d))}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    p, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int32
    lib.segment = getattr(mod, "EWMA_SEGMENT", None)
    lib.plain = mod.ewma_scan_plain
    lib.ewma_scan_f32.argtypes = (
        [p, p, i64, i64, ctypes.c_float, p, p] if lib.segment is None
        else [p, p, i64, i64, ctypes.c_float, i32, p, p])


def device_ms(fn, reps: int = 20) -> float:
    fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(10_000_000)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / reps


def median_ms(fn, reps: int = 20) -> float:
    """chip_smoke.py's ``ms``: the median over ``reps`` single calls, each
    timed from an idle card, so the host's time up to the launch counts."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


class Case(NamedTuple):
    """One shape of one kernel: ``fill`` resets the outputs, ``call(lib)``
    launches a revision's kernel on them, ``check()`` holds the outputs
    against the plain version and returns the largest absolute error."""
    kernel: str
    label: str
    info: dict
    fill: Callable[[], None]
    call: Callable[[ctypes.CDLL], None]
    check: Callable[[], float]


def _stream() -> int:
    return torch._C._cuda_getCurrentRawStream(torch.cuda.current_device())


def _rc(rc: int) -> None:
    if rc != 0:
        raise RuntimeError(f"CUDA error {rc}")


def _nothing() -> None:
    pass


def segment_cases(dev, seed: int = 1) -> list[Case]:
    """The group stage of chip_smoke.py's corpus, by the executor's layout
    (gmap sorted, padding rows in the last group; empty rows hold 0 for
    sums and -inf for max)."""
    rng = np.random.default_rng(seed)
    real = (100 + rng.normal(0, 5, (SERIES, B))).astype(np.float32)
    rows = np.zeros((S, 3 * B), np.float32)
    rows[:SERIES, :B] = 1.0
    rows[:SERIES, B:2 * B] = real
    rows[:SERIES, 2 * B:] = 1.0
    vals = np.full((S, B), -np.inf, np.float32)
    vals[:SERIES] = real
    dc = np.full(S, 15, np.int32)
    dc[:SERIES] = np.arange(SERIES) % 10
    host = np.full(S, S - 1, np.int32)
    host[:SERIES] = np.arange(SERIES)
    runs = np.ones((S, 3 * B), np.float32)
    runs[:, B:2 * B] = 100 + rng.normal(0, 5, (S, B))
    out = []
    for op, label, x_np, g_np, ns in [
            ("sum", "{dc=*}: 16 groups", rows, dc, 16),
            ("minmax", "{dc=*}: 16 groups", vals, dc, 16),
            ("sum", "{host=*}: 16384 groups, 1 series each", rows, host, S),
            ("minmax", "{host=*}: 16384 groups, 1 series each", vals, host,
             S),
            ("sum", "1024 groups, 16 series each", runs,
             (np.arange(S) // 16).astype(np.int32), 1024)]:
        x = torch.from_numpy(x_np).to(dev)
        g = torch.from_numpy(g_np).to(dev)
        n, k = x.shape
        idx = g.long()[:, None].expand(-1, k)
        shape = (ns, k)
        if op == "sum":
            want = (torch.zeros(shape, device=dev).index_add_(0, g.long(),
                                                              x),)
            outs = (torch.zeros(shape, device=dev),)
        else:
            want = (torch.full(shape, float("inf"), device=dev)
                    .scatter_reduce_(0, idx, x, "amin"),
                    torch.full(shape, float("-inf"), device=dev)
                    .scatter_reduce_(0, idx, x, "amax"))
            outs = (torch.empty(shape, device=dev),
                    torch.empty(shape, device=dev))

        def call(lib, outs=outs, x=x, g=g, n=n, k=k, ns=ns, op=op):
            fn = lib.segment_sum_f32 if op == "sum" \
                else lib.segment_minmax_f32
            _rc(fn(x.data_ptr(), g.data_ptr(), n, k, ns,
                   *(o.data_ptr() for o in outs), _stream()))

        def fill(outs=outs, op=op):
            if op == "sum":
                outs[0].zero_()
            else:
                outs[0].fill_(float("inf"))
                outs[1].fill_(float("-inf"))

        def check(outs=outs, want=want):
            for got, w in zip(outs, want):
                torch.testing.assert_close(got, w, rtol=1e-5, atol=1e-5)
            return max(float((o - w).abs().nan_to_num(0.0).max())
                       for o, w in zip(outs, want))

        out.append(Case("segment_reduce", label,
                        {"op": op, "n": n, "k": k, "groups": ns},
                        fill, call, check))
    return out


def corpus(seed: int = 0):
    """chip_smoke.py's corpus: 10,000 series x 1,000 jittered timestamps
    over 7 days, random-walk float32 values from 100."""
    rng = np.random.default_rng(seed)
    step = SPAN // POINTS
    ts0 = np.arange(POINTS, dtype=np.int64) * step
    jitter = rng.integers(0, step // 2, (SERIES, POINTS))
    ts = BASE + np.minimum(ts0[None, :] + jitter, SPAN - 1)
    vals = (np.cumsum(rng.normal(0, 1.0, (SERIES, POINTS)), axis=1)
            + 100.0).astype(np.float32)
    return ts, vals


def padded_rows(ts, vals, rows, end):
    """The executor's un-downsampled layout of corpus series ``rows`` over
    [BASE, end]: left-aligned [S, T] int32 offsets, float32 values, [S]
    int32 counts (numpy)."""
    keep = ts[rows] <= end
    counts = keep.sum(axis=1).astype(np.int32)
    T = _pad_size(int(counts.max()))
    base = int(ts[rows, 0].min())
    tp = np.zeros((len(rows), T), np.int32)
    vp = np.zeros((len(rows), T), np.float32)
    for i, s in enumerate(rows):
        tp[i, :counts[i]] = ts[s, :counts[i]] - base
        vp[i, :counts[i]] = vals[s, :counts[i]]
    return tp, vp, counts


def union_inputs(dev, ts, vals, rows, end):
    """[ts, vals, counts] tensors of ``padded_rows`` and their union grid,
    compacted to its U real points."""
    t = [torch.from_numpy(a).to(dev)
         for a in padded_rows(ts, vals, rows, end)]
    grid, gmask = wk.union_grid(t[0], t[2])
    return t, grid[:int(gmask.sum())].contiguous()


def _same(got, want) -> float:
    torch.testing.assert_close(got, want, rtol=0, atol=0, equal_nan=True)
    return float((got - want).abs().nan_to_num(0.0).max())


def select_cases(dev, ts, vals) -> list[Case]:
    chunk = (torch.from_numpy((ts - BASE).reshape(-1).astype(np.int32))
             .to(dev), torch.from_numpy(vals.reshape(-1)).to(dev),
             torch.from_numpy(np.repeat(np.arange(SERIES, dtype=np.int32),
                                        POINTS)).to(dev))
    _, _, filled, in_range, _ = wk.window_series_stage_chunks(
        [chunk], 0, SPAN - 1, 0, num_series=S, num_buckets=B,
        interval=INTERVAL, agg_down="avg")
    del chunk
    t, grid = union_inputs(dev, ts, vals, np.arange(0, SERIES, 10),
                           BASE + DAY - 1)
    contrib, cmask = wk.series_contributions(*t, grid)
    del t, grid

    def case(label, x, m, q, gmap=None, groups=1):
        rows, cols = x.shape
        qh = np.asarray(q, np.float32)
        if gmap is None:
            lay = None
            want = masked_select.select_columns_plain(x, m, q)
        else:
            lay = masked_select.group_layout(gmap, groups, dev)
            want = masked_select.select_groups_plain(x, m, lay, q)
        out = torch.empty_like(want)

        def call(lib):
            if lay is None:
                _rc(lib.masked_select_columns(
                    x.data_ptr(), m.data_ptr(), rows, cols, qh.ctypes.data,
                    len(q), out.data_ptr(), _stream()))
            else:
                _rc(lib.masked_select_groups(
                    x.data_ptr(), m.data_ptr(), rows, cols,
                    lay.order.data_ptr(), lay.offsets.data_ptr(), groups,
                    lay.big.data_ptr(), lay.big.shape[0], qh.ctypes.data,
                    len(q), out.data_ptr(), _stream()))

        return Case("masked_select", label,
                    {"rows": rows, "cols": cols, "groups": groups,
                     "quantiles": len(q)},
                    _nothing, call, lambda: _same(out, want))

    dc = np.full(S, 15, np.int32)
    dc[:SERIES] = np.arange(SERIES) % 10
    host = np.full(S, S - 1, np.int32)
    host[:SERIES] = np.arange(SERIES)
    return [
        case("window columns, q=0.95", filled, in_range, [0.95]),
        case("window columns, p50/p95/p99", filled, in_range,
             [0.5, 0.95, 0.99]),
        case("union p95 {dc=dc0} one day", contrib, cmask, [0.95]),
        case("window {dc=*}: 16 groups", filled, in_range, [0.95], dc, 16),
        case("window {host=*}: 16384 groups", filled, in_range, [0.95],
             host, S),
    ]


def interp_cases(dev, ts, vals, sample: int = 4096) -> list[Case]:
    """The one-day grid is checked whole; at full width the plain [S, U]
    composition does not fit, so it is checked at ``sample`` grid points
    drawn with a seed."""
    out = []
    for label, rows, end in (
            ("union {dc=dc0} one day", np.arange(0, SERIES, 10),
             BASE + DAY - 1),
            ("union full width", np.arange(SERIES), BASE + SPAN - 1)):
        t, grid = union_inputs(dev, ts, vals, rows, end)
        U = grid.shape[0]
        pick = torch.arange(U, device=dev)
        if t[0].shape[0] * U > 1 << 28:
            pick = torch.from_numpy(np.sort(np.random.default_rng(12).choice(
                U, sample, replace=False))).to(dev)
        want = interp_moments.interp_moments_plain(*t, grid[pick],
                                                   with_m2=False)
        res = [torch.empty(U, device=dev) for _ in range(4)]

        def call(lib, t=t, grid=grid, res=res, U=U):
            cnt, tot, mn, mx = res
            _rc(lib.interp_moments_f32(
                t[0].data_ptr(), t[1].data_ptr(), t[2].data_ptr(),
                t[0].shape[0], t[0].shape[1], grid.data_ptr(), U, 0,
                cnt.data_ptr(), tot.data_ptr(), None, mn.data_ptr(),
                mx.data_ptr(), _stream()))

        def check(res=res, pick=pick, want=want):
            cnt, tot, mn, mx = (r[pick] for r in res)
            for got, w in ((cnt, want[0]), (mn, want[3]), (mx, want[4])):
                if not torch.equal(got, w):
                    raise AssertionError("count/min/max not exact")
            torch.testing.assert_close(tot, want[1], rtol=1e-5, atol=1e-3)
            return float((tot - want[1]).abs().max())

        out.append(Case("interp_moments", label,
                        {"series": t[0].shape[0], "row_points":
                         t[0].shape[1], "grid_points": U,
                         "checked_points": pick.numel()},
                        _nothing, call, check))
    return out


def sketch_cases(dev, vals) -> list[Case]:
    """chip_smoke.py's sketch kernel shapes: the t-digest fold of one
    hand-off (the first 1,049 series' 1,000 values into empty digests,
    2,048 rows of 1,024) and of the 4096-value chunk (1,024 of those
    digests), and the merged quantile p50/p95/p99 over all 10,000 digests
    (S = 16,384). A fold's outputs must be bit-identical between the
    revisions (each sums a cluster's entries in sorted order) and hold
    against the plain version (weights exact, means rtol 1e-5); merged
    quantiles within rtol 1e-4 of the plain version's and of the first
    revision's."""
    K = Config.sketch_compression
    first = min(-(-Config.sketch_flush_points // POINTS), SERIES)
    rows, P = _pad(first), _pad(POINTS)
    batch = torch.zeros((rows, P), device=dev)
    batch[:first, :POINTS] = torch.from_numpy(vals[:first]).to(dev)
    valid = torch.zeros((rows, P), dtype=torch.bool, device=dev)
    valid[:first, :POINTS] = True
    idx = torch.full((rows,), rows, dtype=torch.int32, device=dev)
    idx[:first] = torch.arange(first, dtype=torch.int32, device=dev)
    zeros = torch.zeros((rows, K), device=dev)
    folded = [zeros.clone(), zeros.clone()]
    sketches.tdigest_fold_plain(*folded, idx, batch, valid, compression=K)
    P4 = LiveSketches._MAX_CHUNK
    rows4 = LiveSketches._MAX_FOLD_CELLS // P4
    chunk = torch.from_numpy(np.ascontiguousarray(
        vals.reshape(-1)[:rows4 * P4].reshape(rows4, P4))).to(dev)

    def fold_case(label, m0, w0, idx, batch, valid):
        m0, w0 = m0.contiguous(), w0.contiguous()
        m, w = m0.clone(), w0.clone()
        want = [m0.clone(), w0.clone()]
        sketches.tdigest_fold_plain(*want, idx, batch, valid, compression=K)
        first_out: list = []

        def fill():
            m.copy_(m0)
            w.copy_(w0)

        def call(lib):
            _rc(lib.tdigest_fold_f32(
                m.data_ptr(), w.data_ptr(), m.shape[0], K, idx.data_ptr(),
                idx.shape[0], batch.data_ptr(), valid.data_ptr(), None,
                batch.shape[1], _stream()))

        def check():
            if not torch.equal(w, want[1]):
                raise AssertionError("fold weights differ from the plain")
            torch.testing.assert_close(m, want[0], rtol=1e-5, atol=1e-6)
            if not first_out:
                first_out.extend([m.clone(), w.clone()])
            elif not (torch.equal(m, first_out[0])
                      and torch.equal(w, first_out[1])):
                raise AssertionError("fold outputs differ between the "
                                     "revisions")
            return float((m - want[0]).abs().max())

        return Case("sketches", label,
                    {"rows": int((idx < m0.shape[0]).sum()), "K": K,
                     "P": batch.shape[1]}, fill, call, check)

    S = _pad(SERIES)
    mq_m = torch.zeros((S, K), device=dev)
    mq_w = torch.zeros((S, K), device=dev)
    per = LiveSketches._MAX_FOLD_CELLS // P
    for lo in range(0, SERIES, per):
        hi = min(lo + per, SERIES)
        b = torch.zeros((hi - lo, P), device=dev)
        b[:, :POINTS] = torch.from_numpy(vals[lo:hi]).to(dev)
        v = torch.zeros((hi - lo, P), dtype=torch.bool, device=dev)
        v[:, :POINTS] = True
        sketches.tdigest_fold_plain(
            mq_m, mq_w, torch.arange(lo, hi, dtype=torch.int32, device=dev),
            b, v, compression=K)
    mq_idx = torch.arange(S, dtype=torch.int32, device=dev)
    mq_valid = mq_idx < SERIES
    qs = torch.tensor([0.5, 0.95, 0.99], device=dev)
    mq_want = sketches.merged_quantile_plain(mq_m, mq_w, mq_idx, mq_valid,
                                             qs, compression=K)
    mq_out = torch.empty(3, device=dev)
    scratch: dict = {}
    mq_first: list = []

    def mq_call(lib):
        if id(lib) not in scratch:
            scratch[id(lib)] = torch.empty(
                int(lib.tdigest_merged_quantile_scratch(S * K, K)),
                dtype=torch.uint8, device=dev)
        buf = scratch[id(lib)]
        _rc(lib.tdigest_merged_quantile_f32(
            mq_m.data_ptr(), mq_w.data_ptr(), K, mq_idx.data_ptr(),
            mq_valid.data_ptr(), S, qs.data_ptr(), 3, K, buf.data_ptr(),
            buf.numel(), mq_out.data_ptr(), _stream()))

    def mq_check():
        torch.testing.assert_close(mq_out, mq_want, rtol=1e-4, atol=1e-5)
        if not mq_first:
            mq_first.append(mq_out.clone())
        torch.testing.assert_close(mq_out, mq_first[0], rtol=1e-4,
                                   atol=1e-5)
        return float((mq_out - mq_want).abs().max())

    return [*hll_cases(dev, first), *[
        fold_case("tdigest_fold one hand-off (1,049 series x 1,000 "
                  "values)", zeros, zeros, idx, batch, valid),
        fold_case("tdigest_fold 4096-value chunk (1,024 rows)",
                  folded[0][:rows4], folded[1][:rows4],
                  torch.arange(rows4, dtype=torch.int32, device=dev),
                  chunk, torch.ones((rows4, P4), dtype=torch.bool,
                                    device=dev)),
        Case("sketches", "tdigest_merged_quantile all series, S = 16,384 "
             "(2,097,152 entries)",
             {"S": S, "K": K, "valid_rows": SERIES}, _nothing, mq_call,
             mq_check)]]


def hll_cases(dev, first: int, pool: int = 24) -> list[Case]:
    """chip_smoke.py's HLL shapes: the fold of one hand-off's host and dc
    tag-value UIDs at p = 12 (8 x 2,048 items), of every corpus host and
    dc (8 x 16,384), of dc0's 1,000 hosts at p = 14 (one row of 1,024),
    of the hand-off's hosts in four rows that name one slot, and of every
    host and dc again into the stack they raised; the estimate over that
    stack. Each timed call folds into its own copy of the starting stack
    (``pool`` copies, refilled before each run of calls). Registers must
    equal the plain version's, except in the repeated-slot case, where a
    revision's error is reported instead (a kernel that stages a row
    per block loses rows there); estimates within rtol 1e-6 of the plain
    version's."""
    host = np.where(np.arange(SERIES) < 10, 2 * np.arange(SERIES) + 1,
                    np.arange(SERIES) + 11).astype(np.int32)
    dc = (2 * np.arange(10) + 2).astype(np.int32)

    def rows(uid_rows, slots, C, H=None, U=None):
        H = H or _pad(len(uid_rows))
        U = U or _pad(max(map(len, uid_rows)))
        items = np.zeros((H, U), np.int32)
        valid = np.zeros((H, U), bool)
        for i, u in enumerate(uid_rows):
            items[i, :len(u)] = u
            valid[i, :len(u)] = True
        idx = np.full(H, C, np.int32)
        idx[:len(slots)] = slots
        return [torch.from_numpy(a).to(dev) for a in (idx, items, valid)]

    def fold_case(label, p, C, args, start=None, exact=True):
        regs0 = (torch.zeros((C, 1 << p), dtype=torch.int32, device=dev)
                 if start is None else start)
        want = regs0.clone()
        sketches.hll_fold_plain(want, *args, p=p)
        stacks = torch.empty((pool, *regs0.shape), dtype=torch.int32,
                             device=dev)
        turn = [0]
        idx, items, valid = args

        def fill():
            stacks.copy_(regs0.expand_as(stacks))
            turn[0] = 0

        def call(lib):
            r = stacks[turn[0] % pool]
            turn[0] += 1
            _rc(lib.hll_fold_i32(r.data_ptr(), C, p, idx.data_ptr(),
                                 idx.shape[0], items.data_ptr(),
                                 valid.data_ptr(), items.shape[1],
                                 _stream()))

        def check():
            got = stacks[0]
            if exact and not torch.equal(got, want):
                raise AssertionError(f"{label}: registers differ")
            return float((got - want).abs().max())

        return Case("sketches", label,
                    {"p": p, "rows": list(items.shape),
                     "items": int(valid.sum())}, fill, call, check), want

    hand_off = [host[:first], np.unique(dc[np.arange(first) % 10])]
    quarter = -(-first // 4)
    split = [host[i:min(i + quarter, first)]
             for i in range(0, first, quarter)]
    dc0 = host[::10]
    one, _ = fold_case("hll_fold one hand-off: host + dc, p = 12", 12, 8,
                       rows(hand_off, [0, 1], 8))
    every_args = rows([host, dc], [0, 1], 8)
    every, raised = fold_case("hll_fold all hosts + dcs, p = 12", 12, 8,
                              every_args)
    p14, _ = fold_case("hll_fold dc0's hosts, p = 14 (distinct_tagv)", 14,
                       1, rows([dc0], [0], 1, H=1, U=_pad_size(len(dc0))))
    rep, _ = fold_case("hll_fold one hand-off, the hosts in 4 rows on one "
                       "slot", 12, 8,
                       rows(split + [hand_off[1]], [0, 0, 0, 0, 1], 8),
                       exact=False)
    again, _ = fold_case("hll_fold every host and dc again into the stack "
                         "they raised, p = 12", 12, 8, every_args,
                         start=raised)
    est = torch.empty(raised.shape[0], device=dev)
    est_want = sketches.hll_estimate_plain(raised)

    def est_call(lib):
        _rc(lib.hll_estimate_f32(raised.data_ptr(), raised.shape[0],
                                 raised.shape[1], est.data_ptr(),
                                 _stream()))

    def est_check():
        torch.testing.assert_close(est, est_want, rtol=1e-6, atol=0)
        return float((est - est_want).abs().max())

    return [one, every, p14, rep, again,
            Case("sketches", "hll_estimate over the p = 12 stack (8 x "
                 "4096)", {"rows": raised.shape[0], "m": raised.shape[1]},
                 _nothing, est_call, est_check)]


def decode_inputs(dev, points: int, seed: int) -> tuple:
    """A byte-stream gather of ``points`` points from a seed, padded to
    pad_fine as the fused leg pads it: 360-point records, 120 records a
    block, byte counts as a TSF32 block's (entries 0-2, value words 1-4),
    random payload bytes, one base time a record."""
    rng = np.random.default_rng(seed)
    n = pad_fine(points)
    pt = np.arange(points)
    ts_nb = np.zeros(n, np.int32)
    v_nb = np.zeros(n, np.int32)
    first = np.zeros(n, np.int32)
    blk = np.zeros(n, np.int32)
    base = np.zeros(n, np.int32)
    ts_nb[:points] = rng.choice(3, points, p=[0.3, 0.6, 0.1])
    v_nb[:points] = rng.choice(np.arange(1, 5), points,
                               p=[0.05, 0.25, 0.4, 0.3])
    first[:points] = pt - pt % 360
    blk[:points] = pt - pt % (360 * 120)
    base[:points] = rng.integers(0, 7 * DAY, -(-points // 360)).repeat(
        360)[:points]

    def pay(nbytes):
        out = np.zeros(1 << (max(nbytes, 1) - 1).bit_length(), np.uint8)
        out[:nbytes] = rng.integers(0, 256, nbytes, dtype=np.uint8)
        return torch.from_numpy(out).to(dev)

    return tuple(torch.from_numpy(a).to(dev) if isinstance(a, np.ndarray)
                 else a for a in (ts_nb, pay(int(ts_nb.sum())), v_nb,
                                  pay(int(v_nb.sum())), first, blk, base))


def decode_cases(dev) -> list[Case]:
    out = []
    for label, points in (("week-size gather", 10_000_400),
                          ("day-size gather", 1_500_000),
                          ("TSINT-week-size gather", 40_320)):
        args = decode_inputs(dev, points, seed=len(label))
        ts_nb, ts_pay, v_nb, v_pay, first, blk, base = args
        n = ts_nb.numel()
        rel = torch.empty(n, dtype=torch.int32, device=dev)
        vals = torch.empty(n, dtype=torch.float32, device=dev)
        want = block_decode.decode_points_plain(*args, vkind="f32")
        own: dict = {}   # per library: scratch, status words, tags

        def call(lib, args=args, rel=rel, vals=vals, own=own, n=n):
            st = own.get(id(lib))
            if st is None:
                st = own[id(lib)] = [torch.empty(
                    lib.block_decode_scratch_words(n), dtype=torch.int32,
                    device=dev)]
                if hasattr(lib, "block_decode_state_words"):
                    st += [torch.zeros(lib.block_decode_state_words(n),
                                       dtype=torch.int64, device=dev), 0]
            a = [args[0].data_ptr(), args[1].data_ptr(), args[1].numel(),
                 args[2].data_ptr(), args[3].data_ptr(), args[3].numel(),
                 args[4].data_ptr(), args[5].data_ptr(), args[6].data_ptr(),
                 0, 0, n]
            if len(st) > 1:
                st[2] += 1
                a += [st[1].data_ptr(), st[2]]
            _rc(lib.block_decode_points(*a, st[0].data_ptr(),
                                        rel.data_ptr(), vals.data_ptr(),
                                        _stream()))

        def check(rel=rel, vals=vals, want=want):
            same = torch.equal(rel, want[0]) and torch.equal(
                vals.view(torch.int32), want[1].view(torch.int32))
            return 0.0 if same else float("inf")

        out.append(Case("block_decode", label,
                        {"points": points, "padded_points": n},
                        _nothing, call, check))
    return out


def forecast_grids(ts, vals) -> dict:
    """chip_smoke.py's /forecast grids, time-major: each series' hourly
    mean [169, 10,000] and each dc's five-minute sum of its hosts' means
    [2,017, 10] (values, mask)."""
    out = {}
    for stage, step, by_dc in (("1h", 3600, False), ("5m", 300, True)):
        T = SPAN // step + 1
        b = (ts - BASE) // step
        rows = (np.arange(SERIES) % 10 if by_dc
                else np.arange(SERIES))[:, None].repeat(POINTS, 1)
        S = 10 if by_dc else SERIES
        cell = (b * S + rows).ravel()
        sums = np.bincount(cell, vals.ravel().astype(np.float64),
                           minlength=T * S)
        cnt = np.bincount(cell, minlength=T * S)
        mean = np.where(cnt > 0, sums / np.maximum(cnt, 1), 0.0)
        out[stage] = (mean.reshape(T, S).astype(np.float32),
                      (cnt > 0).reshape(T, S))
    return out


def smoothing_cases(dev, ts, vals, alpha: float = 0.3) -> list[Case]:
    out = []
    for stage, (v, m) in forecast_grids(ts, vals).items():
        v = torch.from_numpy(v).to(dev)
        m = torch.from_numpy(m).to(dev)
        T, S = v.shape
        res = torch.empty_like(v)
        first: dict = {}
        last: list = []
        tol = 1e-5 * v.abs().amax(dim=0)

        def call(lib, v=v, m=m, res=res, last=last, T=T, S=S):
            last[:] = [lib]
            seg = () if lib.segment is None else (lib.segment,)
            _rc(lib.ewma_scan_f32(v.data_ptr(), m.data_ptr(), S, T, alpha,
                                  *seg, res.data_ptr(), _stream()))

        def check(v=v, m=m, res=res, last=last, first=first, tol=tol):
            want = last[0].plain(v, m, alpha)
            nan = torch.isnan(want)
            if not (torch.equal(torch.isnan(res), nan) and torch.equal(
                    res.view(torch.int32)[~nan],
                    want.view(torch.int32)[~nan])):
                raise AssertionError("differs from its own plain version")
            ref = first.setdefault("out", res.clone())
            if (torch.abs(res - ref) > 1e-5 * torch.abs(ref) + tol).any():
                raise AssertionError("outside the models' tolerance of the "
                                     "first revision")
            return float((res - ref).abs().nan_to_num(0.0).max())

        out.append(Case("smoothing", f"ewma_scan_f32 /forecast {stage}",
                        {"series": S, "steps": T}, _nothing, call, check))
    return out


def cases(dev, kernels=SOURCES) -> list[Case]:
    out = []
    if "segment_reduce" in kernels:
        out += segment_cases(dev)
    if {"masked_select", "interp_moments", "sketches",
            "smoothing"} & set(kernels):
        ts, vals = corpus()
        if "masked_select" in kernels:
            out += select_cases(dev, ts, vals)
        if "interp_moments" in kernels:
            out += interp_cases(dev, ts, vals)
        if "sketches" in kernels:
            out += sketch_cases(dev, vals)
        if "smoothing" in kernels:
            out += smoothing_cases(dev, ts, vals)
    if "block_decode" in kernels:
        out += decode_cases(dev)
    return out


def compare(case: Case, names: list[str], libs: list[dict],
            card: str) -> dict:
    """Check every revision on ``case``, then time them in turns A B .. B A,
    twice."""
    errs = []
    for lib in libs:
        case.fill()
        case.call(lib[case.kernel])
        torch.cuda.synchronize()
        errs.append(case.check())
    order = list(range(len(libs)))
    order = order + order[::-1]
    times: list[list[float]] = [[] for _ in libs]
    host: list[list[float]] = [[] for _ in libs]
    for _ in range(2):
        for i in order:
            lib = libs[i][case.kernel]
            for clock, out in ((device_ms, times[i]), (median_ms, host[i])):
                case.fill()
                out.append(clock(lambda: case.call(lib)))
    return {"kernel": case.kernel, "case": case.label, **case.info,
            "card": card, "revisions": [
                {"dir": d, "device_ms": t, "median_ms": float(np.median(t)),
                 "ms": h, "median_of_ms": float(np.median(h)),
                 "max_abs_err": e}
                for d, t, h, e in zip(names, times, host, errs)]}


def breakdown(case: Case, names: list[str], libs: list[dict],
              reps: int = 5) -> dict:
    """Device time per call of each CUDA kernel one call of ``case``
    launches, per revision: ``reps`` calls under ``torch.profiler``."""
    from torch.profiler import ProfilerActivity, profile
    out = {}
    for name, lib in zip(names, libs):
        case.fill()
        case.call(lib[case.kernel])
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                case.call(lib[case.kernel])
            torch.cuda.synchronize()
        out[name] = {e.key: {"us": e.device_time_total / reps,
                             "calls": e.count / reps}
                     for e in prof.key_averages()
                     if e.device_time_total > 0}
    return {"kernel": case.kernel, "case": case.label, "breakdown": out}


def main(argv: list[str]) -> int:
    ap = argparse.ArgumentParser(add_help=False)
    ap.add_argument("--kernels", default=",".join(SOURCES))
    ap.add_argument("--breakdown", action="store_true")
    ap.add_argument("dirs", nargs="*")
    args = ap.parse_args(argv)
    kernels = tuple(args.kernels.split(","))
    if not args.dirs or not torch.cuda.is_available() \
            or not set(kernels) <= set(SOURCES):
        print(__doc__, file=sys.stderr)
        return 1
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip()
    print(smi, flush=True)
    libs = build(args.dirs, kernels)
    for case in cases(torch.device("cuda"), kernels):
        print(json.dumps(compare(case, args.dirs, libs, smi)), flush=True)
        if args.breakdown:
            print(json.dumps(breakdown(case, args.dirs, libs)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
