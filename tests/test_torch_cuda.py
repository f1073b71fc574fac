"""The port's CUDA kernels on the card, against their plain versions and
against the same downsample core and resident-window stages on the CPU.

Every test here is marked ``cuda`` and skips where no card is present.
This file imports neither JAX nor the JAX package, so it also runs on a
machine without them:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from opentsdb_tpu_torch.ops import interp_moments as im_mod
from opentsdb_tpu_torch.ops import kernels, masked_select
from opentsdb_tpu_torch.ops.smoothing import EWMA_SEGMENT
from opentsdb_tpu_torch.ops.segment_reduce import (
    segment_minmax,
    segment_minmax_plain,
    segment_sum,
    segment_sum_plain,
)
from opentsdb_tpu_torch.storage.devstore import DeviceWindow

AGGS = ("sum", "min", "max", "avg", "dev", "count", "zimsum", "mimmin",
        "mimmax")


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("n,nseg,k", [
    (17, 5, 2), (1000, 300, 3), (1025, 513, 1), (600, 40, 256),
    (1_000_000, 300_000, 3), (0, 4, 2), (8, 0, 1)])
def test_kernels_match_plain(card, n, nseg, k):
    """Sums within float32 tolerance (atomics add in a run-dependent
    order), min and max exact, out-of-range ids dropped, launches
    counted once per call."""
    rng = np.random.default_rng(n)
    f = torch.from_numpy(rng.normal(0, 1, (n, k)).astype(np.float32)) \
        .to(card)
    s = torch.from_numpy(rng.integers(-1, nseg + 1, n).astype(np.int32)) \
        .to(card)
    launches = (segment_sum.launches, segment_minmax.launches)
    got = segment_sum(f, s, nseg)
    mn, mx = segment_minmax(f, s, nseg)
    torch.cuda.synchronize()
    assert (segment_sum.launches, segment_minmax.launches) == (
        launches[0] + 1, launches[1] + 1)
    torch.testing.assert_close(got, segment_sum_plain(f, s, nseg),
                               rtol=1e-5, atol=1e-5)
    want_mn, want_mx = segment_minmax_plain(f, s, nseg)
    assert torch.equal(mn, want_mn) and torch.equal(mx, want_mx)


@pytest.mark.cuda
def test_integral_sums_exact(card):
    # Counts: integral float32 below 2^24, exact whatever the order.
    s = torch.randint(0, 1000, (5_000_000,), dtype=torch.int32,
                      device=card)
    got = segment_sum(torch.ones((s.numel(), 1), device=card), s, 1000)
    want = torch.bincount(s.long(), minlength=1000).float()[:, None]
    assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("rate", [False, True])
@pytest.mark.parametrize("agg_group", AGGS)
@pytest.mark.parametrize("agg_down", AGGS)
def test_downsample_on_card_matches_cpu(card, agg_down, agg_group, rate):
    """downsample_group / downsample_multigroup on the card against the
    same functions on the CPU: masks and member timestamps identical,
    values within float32 tolerance."""
    rng = np.random.default_rng(0)
    n, S, B, G, iv = 4000, 64, 64, 4, 60
    cpu_in = [torch.from_numpy(x) for x in (
        rng.integers(0, B * iv, n).astype(np.int32),
        rng.normal(10, 3, n).astype(np.float32),
        rng.integers(0, S - 8, n).astype(np.int32),
        rng.random(n) > 0.1,
        rng.integers(0, G, S).astype(np.int32))]
    dev_in = [x.to(card) for x in cpu_in]
    kw = dict(num_series=S, num_buckets=B, interval=iv, agg_down=agg_down,
              agg_group=agg_group, rate=rate)
    for fn, args, extra in (
            (kernels.downsample_group, 4, {}),
            (kernels.downsample_multigroup, 5, {"num_groups": G})):
        want = fn(*cpu_in[:args], **kw, **extra)
        got = fn(*dev_in[:args], **kw, **extra)
        for key, w in want.items():
            g = got[key].cpu()
            if w.dtype == torch.float32:
                torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-5,
                                           msg=key)
            else:
                assert torch.equal(g, w), key


def _ints(rng, shape):
    # Integral float32 values: their sums are exact in any order (well
    # below 2^24), so the kernels' sums compare bit for bit.
    return rng.integers(-8, 9, shape).astype(np.float32)


def _on(card, x, misaligned=False):
    """x on the card; misaligned puts it 4 bytes past a 16-byte boundary
    (a contiguous view into a larger buffer), so the kernels take their
    unvectorised loads."""
    t = torch.from_numpy(x)
    if not misaligned:
        return t.to(card)
    buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=card)
    out = buf[1:].view(t.shape)
    out.copy_(t)
    assert out.data_ptr() % 16 != 0
    return out


def _check_all(f, s, nseg):
    """Sum bit-exact (integral inputs) and min/max bit-exact against the
    plain versions, for every need= variant."""
    got = segment_sum(f, s, nseg)
    assert torch.equal(got, segment_sum_plain(f, s, nseg))
    mn, mx = segment_minmax(f, s, nseg)
    want_mn, want_mx = segment_minmax_plain(f, s, nseg)
    assert torch.equal(mn, want_mn) and torch.equal(mx, want_mx)
    assert torch.equal(segment_minmax(f, s, nseg, need="min"), want_mn)
    assert torch.equal(segment_minmax(f, s, nseg, need="max"), want_mx)


@pytest.mark.cuda
@pytest.mark.parametrize("misaligned", [False, True])
@pytest.mark.parametrize("k", [1, 3, 5])
@pytest.mark.parametrize("run", [1, 31, 32, 33, 1_000_000])
def test_sorted_runs(card, run, k, misaligned):
    """Sorted ids in runs of every length around the thread (8 points),
    warp (256) and tile (2048) edges, and one run of 1M points across
    many tiles and blocks; 100 empty segments past the last id keep the
    run-merge design."""
    rng = np.random.default_rng(run + k)
    n = 3_000_000 if run == 1_000_000 else 100_003
    ids = (np.arange(n) // run).astype(np.int32)
    nseg = int(ids[-1]) + 101
    f = _on(card, _ints(rng, (n, k)), misaligned)
    _check_all(f, torch.from_numpy(ids).to(card), nseg)


@pytest.mark.cuda
@pytest.mark.parametrize("k", [1, 3, 8])
def test_sorted_ids_with_dropped_ids(card, k):
    """Trash ids (-1) and ids past the end inside sorted runs break the
    runs and drop out; they never merge into a neighbouring run."""
    rng = np.random.default_rng(k)
    n, nseg = 200_000, 200_000 // 7 + 1
    ids = (np.arange(n) // 7).astype(np.int32)
    ids[::5] = -1
    ids[3::11] = nseg + 3
    ids[6::13] = nseg
    f = _on(card, _ints(rng, (n, k)))
    _check_all(f, torch.from_numpy(ids).to(card), nseg)


@pytest.mark.cuda
@pytest.mark.parametrize("misaligned", [False, True])
@pytest.mark.parametrize("k", [1, 3, 256, 768])
@pytest.mark.parametrize("nseg", [2, 16, 64, 65])
def test_few_segments(card, nseg, k, misaligned):
    """Few segments, many columns, unsorted ids (with -1 and past-the-end
    ones): the privatised design up to 64 segments, run merge at 65."""
    rng = np.random.default_rng(nseg * 1000 + k)
    n = 16384
    ids = rng.integers(-1, nseg + 1, n).astype(np.int32)
    f = _on(card, _ints(rng, (n, k)), misaligned)
    _check_all(f, torch.from_numpy(ids).to(card), nseg)
    # Non-integral values, thousands per segment: two float32 sums in
    # different orders differ by up to ~n * eps * sum|x|, so the bound is
    # 1e-5 of each output's sum of magnitudes rather than of the
    # (cancelling) sum itself.
    v = _on(card, rng.normal(0, 1, (n, k)).astype(np.float32), misaligned)
    s = torch.from_numpy(ids).to(card)
    scale = segment_sum_plain(v.abs(), s, nseg)
    err = (segment_sum(v, s, nseg) - segment_sum_plain(v, s, nseg)).abs()
    assert bool((err <= 1e-5 * scale).all())


@pytest.mark.cuda
@pytest.mark.parametrize("k", [5, 256, 768])
@pytest.mark.parametrize("per_group", [1, 3, 16])
def test_many_groups_executor_layout(card, per_group, k):
    """The group stage of a group-by into many groups, laid out as the
    executor builds it: sorted gmap, per_group series per group, and the
    padding rows (empty) all in group G-1, one long run."""
    rng = np.random.default_rng(per_group * 1000 + k)
    S, series = 4096, 3000
    groups = -(-series // per_group)
    G = 1 << (groups - 1).bit_length()
    ids = np.full(S, G - 1, np.int32)
    ids[:series] = np.arange(series) // per_group
    x = _ints(rng, (S, k))
    x[series:] = 0.0
    _check_all(_on(card, x), torch.from_numpy(ids).to(card), G)


_SPECIAL = np.array(
    [0.0, -0.0, np.inf, -np.inf, 1.0, -1.0,
     np.finfo(np.float32).max, -np.finfo(np.float32).max,
     np.finfo(np.float32).tiny, -np.finfo(np.float32).tiny,
     np.float32(1e-45), np.float32(-1e-45)], np.float32)


def _order_keys(x):
    """The _order_key mapping of the JAX package's kernels.py, as int64."""
    b = x.view(torch.int32).long() & 0xFFFFFFFF
    return torch.where(b >= 0x80000000, ~b & 0xFFFFFFFF, b | 0x80000000)


def _from_keys(k):
    b = torch.where(k >= 0x80000000, k & 0x7FFFFFFF, ~k & 0xFFFFFFFF)
    return (b - (b >= 0x80000000).long() * (1 << 32)).to(torch.int32) \
        .view(torch.float32)


def _order_key_minmax(x, ids, nseg):
    """Test-only reference: min and max of the order keys through
    scatter_reduce_ on int64, mapped back to floats; -0.0 < +0.0."""
    keep = (ids >= 0) & (ids < nseg)
    keys = _order_keys(x[keep])
    idx = ids[keep].long()[:, None].expand(-1, x.shape[1])
    shape = (nseg, x.shape[1])
    pos = _order_keys(torch.tensor([np.inf], dtype=torch.float32))
    neg = _order_keys(torch.tensor([-np.inf], dtype=torch.float32))
    mn = pos.expand(shape).clone().scatter_reduce_(0, idx, keys, "amin")
    mx = neg.expand(shape).clone().scatter_reduce_(0, idx, keys, "amax")
    return _from_keys(mn), _from_keys(mx)


@pytest.mark.cuda
@pytest.mark.parametrize("k", [1, 3, 256])
@pytest.mark.parametrize("nseg,sorted_ids", [
    (16, False), (5000, False), (5000, True)])
def test_minmax_special_values_bit_exact(card, nseg, sorted_ids, k):
    """+-0.0, +-inf and the float32 extremes: min and max bit for bit
    equal to the order-key reference, in both designs."""
    rng = np.random.default_rng(nseg + k)
    n = 50_000
    x = rng.choice(_SPECIAL, (n, k))
    ids = (np.sort(rng.integers(-1, nseg + 1, n)) if sorted_ids
           else rng.integers(-1, nseg + 1, n)).astype(np.int32)
    want_mn, want_mx = _order_key_minmax(torch.from_numpy(x),
                                         torch.from_numpy(ids), nseg)
    f, s = torch.from_numpy(x).to(card), torch.from_numpy(ids).to(card)
    for got, want in ((segment_minmax(f, s, nseg, need="min"), want_mn),
                      (segment_minmax(f, s, nseg, need="max"), want_mx),
                      *zip(segment_minmax(f, s, nseg), (want_mn, want_mx))):
        assert torch.equal(got.cpu().view(torch.int32),
                           want.view(torch.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("need", ["min", "max", "both"])
@pytest.mark.parametrize("nseg", [16, 300_000])
def test_minmax_need(card, need, nseg):
    """need= computes one output (or both), counted as one launch, equal
    to the plain version with the same need=."""
    rng = np.random.default_rng(nseg)
    n = 1_000_000
    f = torch.from_numpy(rng.normal(0, 1, (n, 2)).astype(np.float32)) \
        .to(card)
    s = torch.from_numpy(rng.integers(-1, nseg + 1, n).astype(np.int32)) \
        .to(card)
    before = segment_minmax.launches
    got = segment_minmax(f, s, nseg, need=need)
    assert segment_minmax.launches == before + 1
    want = segment_minmax_plain(f, s, nseg, need=need)
    if need == "both":
        assert all(torch.equal(a, b) for a, b in zip(got, want))
    else:
        assert torch.equal(got, want)


# ---------------------------------------------------------------------------
# Resident-window stage and apply: on the card vs the same on the CPU
# ---------------------------------------------------------------------------

MUID = b"\x00\x00\x01"
T0, SPAN, IV = 1_700_000_000, 86_400, 3600
WINDOW_AGGS = ("sum", "avg", "dev", "min", "max", "count", "rate")


def _skey(s):
    return MUID + b"\x00\x00\x01" + s.to_bytes(3, "big")


def _series(rng, n_series, points, values=None):
    """Per series: strictly increasing timestamps over SPAN, values."""
    step = SPAN // points
    out = []
    for s in range(n_series):
        ts = T0 + np.arange(points) * step + rng.integers(0, step // 2,
                                                          points)
        v = (rng.normal(100, 5, points) if values is None
             else rng.choice(values, points)).astype(np.float32)
        out.append((ts.astype(np.int64), v))
    return out


def _appends(layout, rng, values=None):
    """(series, timestamps, values) appends for one layout."""
    if layout == "interleaved":
        # One point per append, round robin: sids change every point.
        data = _series(rng, 40, 100, values)
        return [(s, data[s][0][i:i + 1], data[s][1][i:i + 1])
                for i in range(100) for s in range(40)], 1024
    if layout == "many_chunks":
        data = _series(rng, 300, 700, values)
        return [(s, ts, v) for s, (ts, v) in enumerate(data)], 1000
    data = _series(rng, 200, 1000, values)         # "sorted"
    return [(s, ts, v) for s, (ts, v) in enumerate(data)], 1 << 16


def _window_pair(card, layout, values=None):
    """The same appends into a window on the card and one on the CPU;
    their chunk lists, cut at the same points."""
    appends, staging = _appends(layout, np.random.default_rng(7), values)
    out = []
    for dev in (card, "cpu"):
        dw = DeviceWindow(staging_points=staging, max_points=1 << 26,
                          background=False, device=dev)
        for s, ts, v in appends:
            dw.append(MUID, _skey(s), ts, v)
        out.append(dw.chunk_columns(MUID, T0, T0 + SPAN))
    return out


def _stage(cols, agg):
    s_pad = 1 << max(4, (len(cols.series_keys) - 1).bit_length())
    return kernels.window_series_stage_chunks(
        cols.chunks, 600, SPAN - 600, 0, num_series=s_pad,
        num_buckets=32, interval=IV, agg_down="avg" if agg == "rate"
        else agg, rate=agg == "rate")


def _assert_stage_close(got, want, exact):
    for name, g, w in zip(("sv", "sm", "filled", "in_range", "presence"),
                          got, want):
        g = g.cpu()
        if w.dtype == torch.bool or (exact and name == "sv"):
            assert torch.equal(g, w), name
        else:
            torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-5,
                                       msg=name)


@pytest.mark.cuda
@pytest.mark.parametrize("agg", WINDOW_AGGS)
@pytest.mark.parametrize("layout", ["sorted", "interleaved", "many_chunks"])
def test_window_stage_on_card_matches_cpu(card, layout, agg):
    """window_series_stage_chunks and window_moment_apply on the card vs
    the same functions on CPU tensors of the same chunk lists: masks
    identical, count/min/max exact, sums within rtol 1e-5 (dev merges
    chunk-local M2 across chunk boundaries); the {dc=*}-like and the
    {host=*} group layouts."""
    gpu, cpu = _window_pair(card, layout)
    assert len(gpu.chunks) == len(cpu.chunks)
    if layout == "many_chunks":
        assert len(gpu.chunks) > 100
    launches = segment_sum.launches
    got, want = _stage(gpu, agg), _stage(cpu, agg)
    torch.cuda.synchronize()
    assert segment_sum.launches > launches
    _assert_stage_close(got, want, exact=agg in ("min", "max", "count"))
    s_pad = got[0].shape[0]
    n = len(cpu.series_keys)
    include = torch.arange(s_pad) < n
    few = torch.where(include, torch.arange(s_pad) % 10, 15).int()
    host = torch.where(include, torch.arange(s_pad), s_pad - 1).int()
    for gmap, groups, agg_group in ((few, 16, "sum"), (few, 16, "max"),
                                    (host, s_pad, "sum"),
                                    (host, s_pad, "mimmax")):
        gv, gm = kernels.window_moment_apply(
            *got[:4], include.to(card), gmap.to(card), num_groups=groups,
            agg_group=agg_group, g_out=min(groups, 64 * (-(-n // 64))),
            b_out=32)
        wv, wm = kernels.window_moment_apply(
            *want[:4], include, gmap, num_groups=groups,
            agg_group=agg_group, g_out=min(groups, 64 * (-(-n // 64))),
            b_out=32)
        assert torch.equal(gm.cpu(), wm)
        torch.testing.assert_close(gv.cpu(), wv, rtol=1e-5, atol=1e-5)


_WINDOW_SPECIAL = np.array([0.0, -0.0, np.inf, -np.inf, 1.0, -1.0,
                            np.finfo(np.float32).max], np.float32)


@pytest.mark.cuda
@pytest.mark.parametrize("agg", ["min", "max"])
@pytest.mark.parametrize("layout", ["sorted", "interleaved"])
def test_window_minmax_special_values_exact(card, layout, agg):
    """Min and max stages over +-0.0, +-inf and float32 extremes: exact
    against the CPU (as IEEE values: +0.0 and -0.0 compare equal; the
    plain CPU version does not order them), and the group stage of the
    no-lerp max on top."""
    gpu, cpu = _window_pair(card, layout, values=_WINDOW_SPECIAL)
    got, want = _stage(gpu, agg), _stage(cpu, agg)
    assert torch.equal(got[0].cpu(), want[0])
    assert torch.equal(got[1].cpu(), want[1])
    s_pad = got[0].shape[0]
    gmap = (torch.arange(s_pad) % 10).int()
    include = torch.ones(s_pad, dtype=torch.bool)
    gv, gm = kernels.window_moment_apply(
        *got[:4], include.to(card), gmap.to(card), num_groups=16,
        agg_group="mim" + agg)
    wv, wm = kernels.window_moment_apply(
        *want[:4], include, gmap, num_groups=16, agg_group="mim" + agg)
    assert torch.equal(gv.cpu(), wv) and torch.equal(gm.cpu(), wm)


@pytest.mark.cuda
def test_window_eviction_at_budget(card):
    """A window on the card filled to a (reduced) budget evicts its
    oldest chunk on the next batch, advances complete_from, declines a
    query reaching before it, and folds what stays like the CPU."""
    staging, budget = 1 << 14, 1 << 18
    dw = DeviceWindow(staging_points=staging, max_points=budget,
                      device=card)
    data = _series(np.random.default_rng(1), 64, 4096)
    for s, (ts, v) in enumerate(data):
        dw.append(MUID, _skey(s), ts, v)
    dw.flush()
    assert dw.evicted_points == 0 and dw._total_points == budget
    mw = dw._metrics[MUID]
    oldest_max = mw.chunks[0]["max_ts"]
    for s in range(4):   # one more staging batch, later in time
        ts = T0 + SPAN + np.arange(4096, dtype=np.int64)
        dw.append(MUID, _skey(s), ts, np.ones(4096, np.float32))
    dw.flush()
    assert dw.evicted_points == staging
    assert mw.complete_from == oldest_max + 1
    assert dw.chunk_columns(MUID, T0, T0 + 2 * SPAN) is None
    cols = dw.chunk_columns(MUID, mw.complete_from, T0 + 2 * SPAN)
    assert cols is not None and len(cols.chunks) == budget // staging
    cpu_chunks = [tuple(x.cpu() for x in c) for c in cols.chunks]
    for agg in ("avg", "max"):
        kw = dict(num_series=64, num_buckets=64, interval=IV, agg_down=agg)
        got = kernels.window_series_stage_chunks(
            cols.chunks, 0, 2 * SPAN, 0, **kw)
        want = kernels.window_series_stage_chunks(
            cpu_chunks, 0, 2 * SPAN, 0, **kw)
        _assert_stage_close(got, want, exact=agg == "max")


# ---------------------------------------------------------------------------
# masked_select: the rank-select kernel against its plain version
# ---------------------------------------------------------------------------

QS = [0.0, 0.5, 0.95, 0.99, 0.999, 1.0]


def _select_grid(rng, S, B, case="normal"):
    vals = rng.normal(100, 20, (S, B)).astype(np.float32)
    if case == "ties":
        vals = np.round(vals / 25).astype(np.float32)
    elif case == "special":
        vals = rng.choice(_WINDOW_SPECIAL, (S, B)).astype(np.float32)
    mask = rng.random((S, B)) > 0.3
    mask[:, 0] = False              # all-masked column
    if S > 3:
        mask[:, 1] = False
        mask[3, 1] = True           # one valid entry
    return torch.from_numpy(vals), torch.from_numpy(mask)


def _same(got, want):
    """Kernel against plain on the card: both select exact rank keys and
    lerp with separate float32 roundings, so bit-identical (NaN where an
    infinity meets its opposite on both sides)."""
    torch.testing.assert_close(got, want, rtol=0, atol=0, equal_nan=True)


@pytest.mark.cuda
@pytest.mark.parametrize("S,B,case", [
    (1, 37, "normal"), (2, 64, "ties"), (32, 40, "normal"),
    (33, 40, "ties"), (1000, 257, "normal"), (1000, 100, "special"),
    (16384, 256, "normal"), (16384, 256, "ties"), (300, 42001, "normal")])
def test_select_columns_matches_plain(card, S, B, case):
    rng = np.random.default_rng(S + B)
    vals, mask = _select_grid(rng, S, B, case)
    v, m = vals.to(card), mask.to(card)
    n0 = masked_select.select_columns.launches
    got = masked_select.select_columns(v, m, QS)
    assert masked_select.select_columns.launches == n0 + 1
    want = masked_select.select_columns_plain(v, m, QS)
    torch.cuda.synchronize()
    assert got.shape == (len(QS), B)
    _same(got, want)
    assert (got[:, 0] == 0).all()


def _layout_gmap(kind, S):
    """Group maps as the executor lays them out."""
    if kind == "host":      # one series per group, padding in the last
        real = S * 10020 // 16384
        gmap = np.full(S, S - 1)
        gmap[:real] = np.arange(real)
        return gmap, S
    if kind == "dc":        # 10 groups of ~S/16, padding into group 15
        real = S * 10020 // 16384
        gmap = np.full(S, 15)
        gmap[:real] = np.arange(real) % 10
        return gmap, 16
    if kind == "edges":     # groups of 0, 1, 32 and 33 rows and the rest
        sizes = [0, 1, 32, 33, 0, S - 66]
        return np.repeat(np.arange(len(sizes)), sizes), len(sizes)
    raise ValueError(kind)


@pytest.mark.cuda
@pytest.mark.parametrize("kind,S,B", [
    ("host", 16384, 256), ("dc", 16384, 256), ("edges", 400, 37),
    ("host", 64, 33), ("dc", 2048, 100)])
def test_select_groups_matches_plain(card, kind, S, B):
    rng = np.random.default_rng(S)
    vals, mask = _select_grid(rng, S, B, "ties" if kind == "edges"
                              else "normal")
    gmap, G = _layout_gmap(kind, S)
    gmap = rng.permutation(gmap).astype(np.int32) if kind == "edges" \
        else gmap.astype(np.int32)
    layout = masked_select.group_layout(gmap, G, card)
    v, m = vals.to(card), mask.to(card)
    n0 = masked_select.select_groups.launches
    got = masked_select.select_groups(v, m, layout, QS[1:4])
    assert masked_select.select_groups.launches == n0 + 1
    want = masked_select.select_groups_plain(v, m, layout, QS[1:4])
    torch.cuda.synchronize()
    assert got.shape == (3, G, B)
    _same(got, want)


@pytest.mark.cuda
def test_select_rejects_bad_inputs(card):
    v = torch.zeros((4, 8), device=card)
    with pytest.raises(ValueError):
        masked_select.select_columns(v, torch.ones((4, 8), device=card), [0.5])
    with pytest.raises(ValueError):
        masked_select.select_columns(v.double(),
                                     torch.ones((4, 8), dtype=torch.bool,
                                                device=card), [0.5])
    lay = masked_select.group_layout(np.zeros(4, np.int32), 1)  # on the CPU
    with pytest.raises(ValueError):
        masked_select.select_groups(v, torch.ones_like(v, dtype=torch.bool),
                                    lay, [0.5])


@pytest.mark.cuda
@pytest.mark.parametrize("rate", [False, True])
def test_percentile_stages_on_card_match_cpu(card, rate):
    """downsample_multigroup_quantile and window_quantile_apply on the
    card against the CPU: masks identical, values within float32
    tolerance (the buckets are float32 sums in another order)."""
    rng = np.random.default_rng(2)
    n, S, B, G, iv = 20000, 256, 64, 8, 60
    host = [torch.from_numpy(x) for x in (
        rng.integers(0, B * iv, n).astype(np.int32),
        rng.normal(10, 3, n).astype(np.float32),
        rng.integers(0, S - 6, n).astype(np.int32),
        rng.random(n) > 0.1,
        np.concatenate([rng.integers(0, G, S - 6),
                        np.full(6, G - 1)]).astype(np.int32))]
    kw = dict(num_series=S, num_groups=G, num_buckets=B, interval=iv,
              agg_down="avg", rate=rate)
    got = kernels.downsample_multigroup_quantile(
        *(x.to(card) for x in host), [0.95], **kw)
    want = kernels.downsample_multigroup_quantile(*host, [0.95], **kw)
    assert torch.equal(got["group_mask"].cpu(), want["group_mask"])
    torch.testing.assert_close(got["group_values"].cpu(),
                               want["group_values"], rtol=1e-5, atol=1e-4)
    fill = kernels.step_fill if rate else kernels.gap_fill
    filled, in_range = fill(want["series_values"], want["series_mask"], B)
    include = torch.from_numpy(rng.random(S) > 0.2)
    for groups, gmap in ((1, torch.zeros(S, dtype=torch.int32)),
                         (G, host[4])):
        args = (want["series_mask"], filled, in_range, include, gmap)
        wv, wm = kernels.window_quantile_apply(*args, [0.5],
                                               num_groups=groups)
        gv, gm = kernels.window_quantile_apply(
            *(a.to(card) for a in args), [0.5], num_groups=groups)
        assert torch.equal(gm.cpu(), wm)
        torch.testing.assert_close(gv.cpu(), wv, rtol=0, atol=0)


# ---------------------------------------------------------------------------
# interp_moments: the fused union-grid kernel against its plain version
# ---------------------------------------------------------------------------

def _padded_rows(rng, S, T, span, dups=False):
    counts = rng.integers(1, T + 1, S).astype(np.int32)
    counts[0] = 1
    ts = np.zeros((S, T), np.int32)
    for s in range(S):
        if dups:
            row = np.sort(rng.integers(0, span, counts[s]))
        else:
            row = np.sort(rng.choice(span, counts[s], replace=False))
        ts[s, :counts[s]] = row
    vals = rng.normal(50, 10, (S, T)).astype(np.float32)
    return ts, vals, counts


@pytest.mark.cuda
@pytest.mark.parametrize("interp", ["lerp", "step", "none"])
@pytest.mark.parametrize("S,T,span,extra", [
    (7, 16, 100, 0), (300, 64, 5000, 37), (600, 32, 20000, 0)])
def test_interp_moments_matches_plain(card, interp, S, T, span, extra):
    """Count, min and max exact (the same float32 operations each side);
    total and M2 within rtol 1e-5 (the kernel adds series in order, the
    plain sum in its own). The grid holds the union of the rows (shared
    timestamps across series), points before and after every series'
    range, and U is not a multiple of the 256-point tile."""
    rng = np.random.default_rng(S)
    ts, vals, counts = _padded_rows(rng, S, T, span, dups=S == 300)
    t = [torch.from_numpy(x).to(card) for x in (ts, vals, counts)]
    grid, gmask = kernels.union_grid(*t[::2])
    grid = grid[:int(gmask.sum())]
    if extra:
        grid = torch.cat([torch.arange(-extra, 0, device=card,
                                       dtype=torch.int32), grid,
                          grid[-1] + 1 + torch.arange(
                              extra, device=card, dtype=torch.int32)])
    assert grid.numel() % 256
    n0 = im_mod.interp_moments.launches
    got = im_mod.interp_moments(*t, grid, interp=interp)
    assert im_mod.interp_moments.launches == n0 + 1
    want = im_mod.interp_moments_plain(*t, grid, interp=interp)
    torch.cuda.synchronize()
    for name, g, w in zip(("count", "total", "m2", "min", "max"), got,
                          want):
        if name in ("count", "min", "max"):
            assert torch.equal(g, w), name
        else:
            torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-3)
    cnt, _, m2, *_ = im_mod.interp_moments(*t, grid, interp=interp,
                                           with_m2=False)
    assert m2 is None and torch.equal(cnt, want[0])


@pytest.mark.cuda
@pytest.mark.parametrize("agg", AGGS)
def test_group_interpolate_on_card_matches_cpu(card, agg):
    rng = np.random.default_rng(9)
    ts, vals, counts = _padded_rows(rng, 40, 32, 3000)
    host = [torch.from_numpy(x) for x in (ts, vals, counts)]
    for interp in ("lerp", "step", "none"):
        wg, wo, wm = kernels.group_interpolate(*host, agg=agg, interp=interp)
        gg, go, gm = kernels.group_interpolate(
            *(x.to(card) for x in host), agg=agg, interp=interp)
        assert torch.equal(gg.cpu(), wg) and torch.equal(gm.cpu(), wm)
        torch.testing.assert_close(go.cpu()[wm], wo[wm], rtol=1e-5,
                                   atol=1e-4)


# ---------------------------------------------------------------------------
# masked_select: the staged radix select's launch plans and edge cases
# ---------------------------------------------------------------------------

# One 32-column tile of S rows: the plan widens the cluster while a block
# keeps 256 rows (1, 2, 4, 8, 16 blocks), stages a block's share while it
# fits in shared memory, counts from device memory past that (40,000
# rows), and takes 32-bit counters past 65,535 rows a block (1.1M rows).
_PLAN_ROWS = [300, 600, 1200, 2100, 4200, 40_000, 1_100_000]


def _columns_vs_plain(card, vals, mask, q):
    v, m = vals.to(card), mask.to(card)
    n0 = masked_select.select_columns.launches
    got = masked_select.select_columns(v, m, q)
    assert masked_select.select_columns.launches == n0 + 1
    want = masked_select.select_columns_plain(v, m, q)
    torch.cuda.synchronize()
    _same(got, want)
    return got


@pytest.mark.cuda
@pytest.mark.parametrize("S", _PLAN_ROWS)
def test_select_columns_at_each_plan(card, S):
    rng = np.random.default_rng(S)
    B = 8 if S > 100_000 else 32
    vals, mask = _select_grid(rng, S, B, "ties")
    _columns_vs_plain(card, vals, mask, [0.25, 0.95, 0.99])


@pytest.mark.cuda
def test_select_plans_cover_every_path(card):
    """The shapes above reach every cluster width up to 8 (16 where the
    card co-schedules such clusters), a block share staged and one counted
    from device memory, and both counter widths."""
    plans = [masked_select.launch_plan(S, 8 if S > 100_000 else 32, 1, 3)
             for S in _PLAN_ROWS]
    widths = {p["cluster"] for p in plans}
    assert {1, 2, 4, 8} <= widths
    shares = [-(-S // p["cluster"]) for S, p in zip(_PLAN_ROWS, plans)]
    assert any(s <= p["stage_rows"] for s, p in zip(shares, plans))
    assert any(s > p["stage_rows"] for s, p in zip(shares, plans))
    assert any(p["wide_counters"] for p in plans)
    assert not all(p["wide_counters"] for p in plans)
    assert all(p["coresident_clusters"] >= 1 for p in plans)


@pytest.mark.cuda
@pytest.mark.parametrize("over", [0, 1])
def test_select_rows_around_the_staging_limit(card, over):
    """A block's share just at what its shared memory stages, and one row
    past it (the whole group then counts from device memory)."""
    big = masked_select.launch_plan(60_000, 32, 1, 3)
    C, cap = big["cluster"], big["stage_rows"]
    S = C * cap + over
    plan = masked_select.launch_plan(S, 32, 1, 3)
    assert plan["cluster"] == C
    assert (-(-S // C) > plan["stage_rows"]) == bool(over)
    rng = np.random.default_rng(S)
    vals, mask = _select_grid(rng, S, 32, "ties")
    _columns_vs_plain(card, vals, mask, [0.5, 0.95, 0.999])


@pytest.mark.cuda
@pytest.mark.parametrize("k", [1, 3, 7])
@pytest.mark.parametrize("S", [200, 5000])
def test_select_quantile_chunks_with_duplicates(card, S, k):
    """k quantiles in chunks of three; values on a coarse lattice, so runs
    of equal keys span the floor and ceil ranks."""
    rng = np.random.default_rng(S + k)
    vals = rng.integers(-3, 4, (S, 70)).astype(np.float32)
    mask = torch.from_numpy(rng.random((S, 70)) > 0.2)
    q = np.linspace(0.0, 1.0, k + 2)[1:-1].astype(np.float32).tolist()
    got = _columns_vs_plain(card, torch.from_numpy(vals), mask, q)
    assert got.shape == (k, 70)
    gmap = rng.integers(0, 5, S).astype(np.int32)
    layout = masked_select.group_layout(gmap, 5, card)
    v, m = torch.from_numpy(vals).to(card), mask.to(card)
    got = masked_select.select_groups(v, m, layout, q)
    want = masked_select.select_groups_plain(v, m, layout, q)
    torch.cuda.synchronize()
    _same(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("S", [40, 3000])
def test_select_special_columns(card, S):
    """Signed zeros, infinities, NaN, all-masked and single-valid columns
    (column 0 all masked, column 1 one valid entry, column 2 only zeros of
    both signs, column 3 only infinities)."""
    rng = np.random.default_rng(S)
    special = np.array([0.0, -0.0, np.inf, -np.inf, 1.0, -1.0, np.nan],
                       np.float32)
    vals = rng.choice(special, (S, 40)).astype(np.float32)
    vals[:, 2] = rng.choice([0.0, -0.0], S)
    vals[:, 3] = rng.choice([np.inf, -np.inf], S)
    mask = rng.random((S, 40)) > 0.3
    mask[:, 0] = False
    mask[:, 1] = False
    mask[S // 2, 1] = True
    got = _columns_vs_plain(card, torch.from_numpy(vals),
                            torch.from_numpy(mask), QS)
    assert (got[:, 0] == 0).all()


@pytest.mark.cuda
@pytest.mark.parametrize("B", [37, 256])
def test_select_groups_gathered_out_of_order(card, B):
    """Large groups whose rows lie scattered through the grid (the layout
    gathers them through ``order``), beside small groups and a padding
    group of masked rows."""
    rng = np.random.default_rng(B)
    S = 12_000
    vals, mask = _select_grid(rng, S, B)
    sizes = [3000, 2000, 40, 33, 32, 1, 0, 4000, 2894]
    gmap = rng.permutation(np.repeat(np.arange(len(sizes)), sizes)) \
        .astype(np.int32)
    mask[torch.from_numpy(gmap == len(sizes) - 1)] = False
    layout = masked_select.group_layout(gmap, len(sizes), card)
    v, m = vals.to(card), mask.to(card)
    got = masked_select.select_groups(v, m, layout, [0.5, 0.95])
    want = masked_select.select_groups_plain(v, m, layout, [0.5, 0.95])
    torch.cuda.synchronize()
    _same(got, want)
    assert (got[:, -1] == 0).all()


# ---------------------------------------------------------------------------
# interp_moments: the register-blocked kernel's tiles and edge cases
# ---------------------------------------------------------------------------

def _interp_vs_plain(card, ts, vals, counts, grid, interp):
    t = [torch.from_numpy(x).to(card) for x in (ts, vals, counts)]
    g = torch.from_numpy(grid.astype(np.int32)).to(card)
    got = im_mod.interp_moments(*t, g, interp=interp)
    want = im_mod.interp_moments_plain(*t, g, interp=interp)
    torch.cuda.synchronize()
    for name, a, b in zip(("count", "total", "m2", "min", "max"), got, want):
        if name in ("count", "min", "max"):
            assert torch.equal(a, b), name
        else:
            torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-3)


@pytest.mark.cuda
@pytest.mark.parametrize("interp", ["lerp", "step", "none"])
def test_interp_edge_series(card, interp):
    """S = 300 (each quarter of a block takes 75 series, not a multiple of
    its 64-series batch); series of one
    point; series that start and end inside a tile; a dense series with
    64 samples inside one tile (more than one staging step holds);
    duplicate timestamps; grid points before, between and after every
    series."""
    rng = np.random.default_rng(5)
    S, T, span = 300, 64, 40_000
    ts, vals, counts = _padded_rows(rng, S, T, span, dups=True)
    counts[1:5] = 1
    ts[1:5, 0] = rng.integers(0, span, 4)
    ts[5, :T] = 5000 + np.arange(T)      # dense: 64 samples in ~64 s
    counts[5] = T
    ts[6, :3] = [7000, 7000, 7005]      # duplicates inside a tile
    counts[6] = 3
    grid = np.unique(np.concatenate([
        ts[np.arange(T)[None, :] < counts[:, None]],
        rng.integers(-500, span + 500, 3000), [-10**6, 10**6]]))
    tile = im_mod.tile_shape(len(grid))["tile_points"]
    if len(grid) % tile == 0:
        grid = np.delete(grid, len(grid) // 2)
    assert len(grid) % im_mod.tile_shape(len(grid))["tile_points"]
    _interp_vs_plain(card, ts, vals, counts, grid, interp)


@pytest.mark.cuda
@pytest.mark.parametrize("P", [1, 2, 4, 8])
def test_interp_points_per_thread(card, P):
    """Grids long enough for 1, 2, 4 and 8 points a thread (the kernel's
    choice grows with the grid; the shortest grid at each, found through
    the tile query, plus a ragged 77 points), 40 series sampled at random
    over them (some points on a sample, most between)."""
    U = 64
    while im_mod.tile_shape(U)["points_per_thread"] < P:
        U *= 2
    U += 77
    assert im_mod.tile_shape(U)["points_per_thread"] == P
    rng = np.random.default_rng(U)
    grid = np.sort(rng.choice(4 * U, U, replace=False)).astype(np.int32)
    S, T = 40, 4096
    counts = rng.integers(1, T + 1, S).astype(np.int32)
    ts = np.zeros((S, T), np.int32)
    for s in range(S):
        pts = np.concatenate([rng.choice(grid, counts[s] // 2),
                              rng.integers(-100, 4 * U + 100,
                                           counts[s] - counts[s] // 2)])
        ts[s, :counts[s]] = np.sort(pts)
    vals = rng.normal(50, 10, (S, T)).astype(np.float32)
    _interp_vs_plain(card, ts, vals, counts, grid, "lerp")


# ---------------------------------------------------------------------------
# A store checkpointed on the CPU, reopened on the card
# ---------------------------------------------------------------------------

RESTART_QUERIES = [
    dict(metric="m.cpu", tags={}, aggregator="sum", downsample=(600, "avg")),
    dict(metric="m.cpu", tags={"host": "*"}, aggregator="max",
         downsample=(600, "max")),
    dict(metric="m.cpu", tags={"dc": "*"}, aggregator="dev",
         downsample=(1800, "avg")),
    dict(metric="m.cpu", tags={}, aggregator="count", rate=True,
         downsample=(600, "avg")),
    dict(metric="m.cpu", tags={"dc": "*"}, aggregator="p95",
         downsample=(600, "avg")),
]


@pytest.mark.cuda
def test_checkpointed_store_warms_the_window_on_card(card, tmp_path):
    """A TSDB on the CPU ingests, checkpoints twice and shuts down (which
    checkpoints again). Reopened on the CPU and then on the card, each
    warms its window from the generations and the WAL; the card's
    resident answers equal the CPU's: grids identical, count, min and max
    exact, sums within float32 tolerance."""
    from opentsdb_tpu_torch.core.tsdb import TSDB
    from opentsdb_tpu_torch.query.executor import QueryExecutor, QuerySpec
    from opentsdb_tpu_torch.storage.kv import MemKVStore
    from opentsdb_tpu_torch.utils.config import Config

    wal = str(tmp_path / "wal")
    rng = np.random.default_rng(11)

    def open_tsdb(device):
        return TSDB(MemKVStore(wal_path=wal),
                    Config(auto_create_metrics=True, device=device),
                    start_compaction_thread=False)

    tsdb = open_tsdb("cpu")
    for part in range(3):
        for h in range(16):
            ts = T0 + part * SPAN + np.sort(
                rng.choice(SPAN, 400, replace=False))
            tsdb.add_batch("m.cpu", ts, rng.normal(50, 10, 400),
                           {"host": f"h{h}", "dc": f"dc{h % 4}"})
        if part < 2:
            assert tsdb.checkpoint() > 0
    tsdb.shutdown()
    answers = {}
    for device in ("cpu", card):
        tsdb = open_tsdb(str(device))
        try:
            assert tsdb.devwindow.appended_points == 3 * 16 * 400
            ex = QueryExecutor(tsdb)
            got = []
            for fields in RESTART_QUERIES:
                res, plan, _ = ex.run_with_plan(QuerySpec(**fields), T0,
                                                T0 + 3 * SPAN - 1)
                assert plan == "resident" and res
                got.append(res)
            answers[str(device)] = got
        finally:
            tsdb.shutdown()
    for fields, want, got in zip(RESTART_QUERIES, answers["cpu"],
                                 answers[str(card)]):
        exact = fields["aggregator"] in ("max", "count")
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert g.tags == w.tags
            np.testing.assert_array_equal(g.timestamps, w.timestamps)
            if exact:
                np.testing.assert_array_equal(g.values, w.values)
            else:
                np.testing.assert_allclose(g.values, w.values, rtol=1e-5,
                                           atol=1e-5)


# ---------------------------------------------------------------------------
# Sketch kernels (csrc/sketches.cu)
# ---------------------------------------------------------------------------

def _sk():
    from opentsdb_tpu_torch.ops import sketches
    return sketches


def _digest_stack(sk, rng, C, K, device, n=600):
    means = torch.zeros(C, K, device=device)
    weights = torch.zeros(C, K, device=device)
    for s in range(0, C, 2):
        v = torch.from_numpy(rng.normal(s, 1 + s % 3, n).astype(np.float32))
        sk.tdigest_fold_plain(means, weights,
                              torch.tensor([s], dtype=torch.int32,
                                           device=device),
                              v[None].to(device),
                              torch.ones(1, n, dtype=torch.bool,
                                         device=device), compression=K)
    return means, weights


@pytest.mark.cuda
@pytest.mark.parametrize("P,special", [(8, False), (1024, False),
                                       (1024, True), (4096, False),
                                       (8064, False)])
def test_tdigest_fold_matches_plain(card, P, special):
    """The fold kernel against its plain version on the card (the same
    CUDA asinf): cluster weights exact (integral float32 sums), means
    within rtol 1e-5 (the plain version's scatter_add adds in atomic
    order); padded rows (idx = C) and untouched rows left alone."""
    sk = _sk()
    rng = np.random.default_rng(P)
    C, K = 16, 128
    means, weights = _digest_stack(sk, rng, C, K, card)
    idx = torch.tensor([3, 0, 9, 14, 7, C, C, C], dtype=torch.int32,
                       device=card)
    batch = rng.normal(2, 3, (8, P)).astype(np.float32)
    if special:
        batch[0, :100] = 0.0
        batch[0, 100:200] = -0.0
        batch[1, :] = 1.5
        batch[2, ::2] = np.round(batch[2, ::2])
    batch = torch.from_numpy(batch).to(card)
    valid = torch.from_numpy(rng.random((8, P)) < 0.8).to(card)
    before = sk.tdigest_fold.launches
    m1, w1 = means.clone(), weights.clone()
    sk.tdigest_fold(m1, w1, idx, batch, valid=valid, compression=K)
    torch.cuda.synchronize()
    assert sk.tdigest_fold.launches == before + 1
    m2, w2 = means.clone(), weights.clone()
    sk.tdigest_fold_plain(m2, w2, idx, batch, valid, compression=K)
    assert torch.equal(w1, w2)
    torch.testing.assert_close(m1, m2, rtol=1e-5, atol=1e-6)


@pytest.mark.cuda
def test_tdigest_merge_form_and_determinism(card):
    sk = _sk()
    rng = np.random.default_rng(1)
    K = 128
    means, weights = _digest_stack(sk, rng, 8, K, card, n=3000)
    idx = torch.tensor([1, 3], dtype=torch.int32, device=card)
    src = torch.tensor([4, 6], device=card)
    outs = []
    for _ in range(2):
        m, w = means.clone(), weights.clone()
        sk.tdigest_fold(m, w, idx, means[src].contiguous(),
                        batch_weights=weights[src].contiguous(),
                        compression=K)
        outs.append((m, w))
    m2, w2 = means.clone(), weights.clone()
    sk.tdigest_fold_plain(m2, w2, idx, means[src], weights_b=weights[src],
                          compression=K)
    assert torch.equal(outs[0][0], outs[1][0])
    assert torch.equal(outs[0][1], w2)
    torch.testing.assert_close(outs[0][0], m2, rtol=1e-5, atol=1e-6)


@pytest.mark.cuda
@pytest.mark.parametrize("p", [4, 12, 14, 18])
def test_hll_fold_and_estimate_match_plain(card, p):
    """Registers bit-identical; estimates within rtol 1e-6 (the same
    exact sum; the logs are CUDA's in both)."""
    sk = _sk()
    rng = np.random.default_rng(p)
    H, U, C = 6, 5000, 8
    regs = torch.from_numpy(rng.integers(0, 4, (C, 1 << p))
                            .astype(np.int32)).to(card)
    idx = torch.tensor([4, 0, 7, 2, C, C], dtype=torch.int32, device=card)
    items = np.concatenate([
        rng.integers(-2**31, 2**31, (H, U - 3)),
        np.tile([0, -1, -2**31], (H, 1))], axis=1).astype(np.int32)
    items = torch.from_numpy(items).to(card)
    valid = torch.from_numpy(rng.random((H, U)) < 0.7).to(card)
    r1 = regs.clone()
    sk.hll_fold(r1, idx, items, valid, p=p)
    r2 = regs.clone()
    sk.hll_fold_plain(r2, idx, items, valid, p=p)
    assert torch.equal(r1, r2)
    est = sk.hll_estimate(r1)
    want = sk.hll_estimate_plain(r1)
    torch.testing.assert_close(est, want, rtol=1e-6, atol=0)
    assert torch.equal(torch.round(est), torch.round(want))


def _hll_items(rng, H, U):
    return torch.from_numpy(rng.integers(-2**31, 2**31, (H, U))
                            .astype(np.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("p", [4, 12, 14, 18])
@pytest.mark.parametrize("case", ["repeated", "invalid_rows", "one_row",
                                  "outside", "unaligned"])
def test_hll_fold_edge_rows_match_plain(card, p, case):
    """Registers bit-identical to the plain version's (the max over every
    row that names a slot): three rows on one slot beside two distinct
    ones, rows with no valid item, a single row, slots outside [0, C)
    (negative ones skipped too) and a batch whose rows are not a whole
    number of 16-byte loads."""
    sk = _sk()
    rng = np.random.default_rng(p)
    C, U = 4, 1024
    idx = {"repeated": [1, 3, 1, 0, 1], "invalid_rows": [0, 1, 2, 3, 2],
           "one_row": [2], "outside": [-1, 0, C, -7, 3],
           "unaligned": [3, 3, 0, 1, 2]}[case]
    H = len(idx)
    if case == "unaligned":
        U = 1021
    items = _hll_items(rng, H, U).to(card)
    valid = torch.from_numpy(rng.random((H, U)) < 0.6).to(card)
    if case == "invalid_rows":
        valid[1] = False
        valid[4] = False
    regs = torch.from_numpy(rng.integers(0, 3, (C, 1 << p))
                            .astype(np.int32)).to(card)
    idx = torch.tensor(idx, dtype=torch.int32, device=card)
    before = sk.hll_fold.launches
    r1, r2 = regs.clone(), regs.clone()
    sk.hll_fold(r1, idx, items, valid, p=p)
    sk.hll_fold_plain(r2, idx, items, valid, p=p)
    torch.cuda.synchronize()
    assert sk.hll_fold.launches == before + 1
    assert torch.equal(r1, r2)
    if case == "outside":
        assert torch.equal(r1[[1, 2]], regs[[1, 2]])


@pytest.mark.cuda
@pytest.mark.parametrize("p", [4, 12, 14])
def test_hll_refold_changes_nothing(card, p):
    """Folding the same items again into the stack they raised (what
    every hand-off of a steady deployment does) leaves it bit for bit as
    it was, and equal to the plain version's."""
    sk = _sk()
    rng = np.random.default_rng(p + 100)
    C, H, U = 8, 8, 2048
    items = _hll_items(rng, H, U).to(card)
    valid = torch.from_numpy(rng.random((H, U)) < 0.5).to(card)
    idx = torch.tensor([0, 1, 2, 3, 4, 5, C, C], dtype=torch.int32,
                       device=card)
    regs = torch.zeros((C, 1 << p), dtype=torch.int32, device=card)
    sk.hll_fold(regs, idx, items, valid, p=p)
    once = regs.clone()
    sk.hll_fold(regs, idx, items, valid, p=p)
    want = torch.zeros_like(regs)
    sk.hll_fold_plain(want, idx, items, valid, p=p)
    sk.hll_fold_plain(want, idx, items, valid, p=p)
    assert torch.equal(regs, once) and torch.equal(regs, want)


def _unhash32(sk, h):
    """The item whose hash32 is ``h`` (uint32 in int64): the murmur3
    finalizer's inverse."""
    h = h ^ (h >> 16)
    h = sk._mul32(h, 0x7ED1B41D)
    h = h ^ (h >> 13) ^ (h >> 26)
    h = sk._mul32(h, 0xA5CB9243)
    return h ^ (h >> 16)


@pytest.mark.cuda
def test_hll_rank_of_every_w_at_p4(card):
    """The kernel's rank of every w < 2^28 (p = 4: the widest w, where
    float32 rounding of w decides floor(log2 w) near each power of two)
    equals the plain version's: in each chunk of 2^24 w, register j of
    row r gets the one item whose hash is (j << 28) | w with w = lo +
    16 r + j."""
    sk = _sk()
    p, bits = 4, 28
    chunk = 1 << 24
    rows = chunk // 16
    j = torch.arange(16, device=card, dtype=torch.int64)
    idx = torch.arange(rows, dtype=torch.int32, device=card)
    valid = torch.ones((rows, 16), dtype=torch.bool, device=card)
    for lo in range(0, 1 << bits, chunk):
        w = lo + torch.arange(chunk, device=card, dtype=torch.int64)
        h = (j.repeat(rows) << bits) | w
        items = _unhash32(sk, h).to(torch.int32).reshape(rows, 16)
        assert torch.equal(sk.hash32(items.reshape(-1)), h)
        got = torch.zeros((rows, 16), dtype=torch.int32, device=card)
        sk.hll_fold(got, idx, items, valid, p=p)
        want = torch.zeros_like(got)
        sk.hll_fold_plain(want, idx, items, valid, p=p)
        assert torch.equal(got, want), f"w in [{lo}, {lo + chunk})"
        # Rank 0 where float32(w) rounds up to 2^28 (w >= 2^28 - 8), as
        # the JAX package's frexp gives it.
        assert int(got.min()) >= 0 and int(got.max()) <= bits + 1
        assert int((got == 0).sum()) == (8 if lo + chunk == 1 << bits
                                         else 0)


@pytest.mark.cuda
@pytest.mark.parametrize("p,fill", [(4, 27), (12, None), (14, None),
                                    (18, None)])
def test_hll_estimate_ranges_match_plain(card, p, fill):
    """Estimates within rtol 1e-6 of the plain version's and equal once
    rounded, on stacks filled to each of the estimate's ranges (empty,
    the small-range count of zeros, the raw sum) and, with 16 registers
    of 27, the large-range correction; the same on every run."""
    sk = _sk()
    rng = np.random.default_rng(p)
    if fill is not None:
        regs = torch.full((1, 1 << p), fill, dtype=torch.int32, device=card)
    else:
        regs = torch.zeros((4, 1 << p), dtype=torch.int32, device=card)
        for r, n in enumerate([0, (1 << p) // 8, 1 << p, 20 << p]):
            items = _hll_items(rng, 1, max(n, 1)).to(card)
            valid = torch.full(items.shape, n > 0, device=card)
            sk.hll_fold(regs, torch.tensor([r], dtype=torch.int32,
                                           device=card), items, valid, p=p)
    est = sk.hll_estimate(regs)
    want = sk.hll_estimate_plain(regs)
    torch.testing.assert_close(est, want, rtol=1e-6, atol=0)
    assert torch.equal(torch.round(est), torch.round(want))
    assert torch.equal(sk.hll_estimate(regs), est)
    if fill is not None:
        assert float(est[0]) > 2.0 ** 32 / 30


@pytest.mark.cuda
def test_hll_estimate_unaligned_rows(card):
    """A row that starts off a 16-byte boundary is copied, not misread."""
    sk = _sk()
    flat = torch.randint(0, 20, (1 + 4096,), dtype=torch.int32,
                         device=card)
    row = flat[1:]
    assert row.data_ptr() % 16
    torch.testing.assert_close(sk.hll_estimate(row),
                               sk.hll_estimate_plain(row), rtol=1e-6,
                               atol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("S", [1, 16, 1024, 16384])
def test_merged_quantile_matches_plain(card, S):
    """The merged quantile (global sort, scans, cluster sums) against
    its plain version on the card: within rtol 1e-4, since a cluster's
    mean is a float32 sum of up to ~2e4 centroids at S = 16,384, added in
    another order by the plain version's atomics (rounding ~sqrt(n) eps,
    ~1e-5 of the sum); the same state answers bit-identically twice."""
    sk = _sk()
    rng = np.random.default_rng(S)
    K = 128
    C = max(S, 4)
    means, weights = _digest_stack(sk, rng, min(C, 64), K, card, n=300)
    if C > 64:
        reps = -(-C // 64)
        means = means.repeat(reps, 1)[:C].contiguous()
        weights = weights.repeat(reps, 1)[:C].contiguous()
    pad = 1
    while pad < S:
        pad *= 2
    sel = rng.choice(C, S, replace=False).astype(np.int32)
    idx = torch.zeros(pad, dtype=torch.int32, device=card)
    idx[:S] = torch.from_numpy(sel).to(card)
    valid = torch.arange(pad, device=card) < S
    q = torch.tensor([0.0, 0.01, 0.5, 0.95, 0.99, 1.0], device=card)
    got = sk.merged_quantile(means, weights, idx, valid, q, compression=K)
    again = sk.merged_quantile(means, weights, idx, valid, q,
                               compression=K)
    want = sk.merged_quantile_plain(means, weights, idx, valid, q,
                                    compression=K)
    assert torch.equal(got, again)
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-5)


FOLD_CASES = ["batch_all_invalid", "interleaved_empty", "equal_means",
              "max_entries", "nan_inf_means"]


@pytest.mark.cuda
@pytest.mark.parametrize("case", FOLD_CASES)
def test_tdigest_fold_edge_rows(card, case):
    """The fold's radix sort and zero-weight drop at the rows that test
    them, against the plain version: a batch with no valid value, old
    centroids with empties between them, batch values equal to old
    centroid means (ties between old and new entries keep index order),
    K + P = 8192, and NaN and +-inf means of positive weight. Cluster
    weights exact, means within rtol 1e-5 (the plain version's
    scatter_add adds in atomic order)."""
    sk = _sk()
    rng = np.random.default_rng(len(case))
    C, K = 16, 128
    P = 8192 - K if case == "max_entries" else 1024
    means, weights = _digest_stack(sk, rng, C, K, card)
    idx = torch.tensor([3, 0, 9, 14, C, C], dtype=torch.int32, device=card)
    batch = torch.from_numpy(rng.normal(2, 3, (6, P)).astype(np.float32)) \
        .to(card)
    valid = torch.from_numpy(rng.random((6, P)) < 0.8).to(card)
    if case == "batch_all_invalid":
        valid[0] = False
    elif case in ("interleaved_empty", "max_entries"):
        weights[:, 1::2] = 0.0
        means[:, 1::2] = torch.from_numpy(
            rng.normal(0, 4, (C, K // 2)).astype(np.float32)).to(card)
        valid[:, ::3] = False
    elif case == "equal_means":
        for r in range(4):
            src = means[idx[r]][weights[idx[r]] > 0]
            batch[r, :len(src)] = src
            batch[r, len(src):2 * len(src)] = src.flip(0)
    else:
        means[3, 5], means[0, 7], means[9, 9] = (float("nan"),
                                                 float("inf"),
                                                 float("-inf"))
        weights[3, 5] = weights[0, 7] = weights[9, 9] = 2.0
        batch[:, :3] = torch.tensor([float("nan"), float("inf"),
                                     float("-inf")], device=card)
        valid[:, :3] = True
    m1, w1 = means.clone(), weights.clone()
    sk.tdigest_fold(m1, w1, idx, batch, valid=valid, compression=K)
    m2, w2 = means.clone(), weights.clone()
    sk.tdigest_fold_plain(m2, w2, idx, batch, valid, compression=K)
    torch.cuda.synchronize()
    assert torch.equal(w1, w2)
    torch.testing.assert_close(m1, m2, rtol=1e-5, atol=1e-6, equal_nan=True)



@pytest.mark.cuda
def test_tdigest_fold_nan_weight(card):
    """A NaN weight stays in the fold (only weights of +-0 are dropped)
    and makes the total NaN, as jnp.maximum keeps it: every positive
    entry then lands in cluster 0, in the kernel as in the plain
    version."""
    sk = _sk()
    rng = np.random.default_rng(7)
    K = 128
    means, weights = _digest_stack(sk, rng, 4, K, card)
    bm = torch.from_numpy(rng.normal(0, 1, (2, K)).astype(np.float32)) \
        .to(card)
    bw = torch.from_numpy(rng.integers(0, 3, (2, K)).astype(np.float32)) \
        .to(card)
    bw[0, 9] = float("nan")
    bw[1, 3] = -0.0
    idx = torch.tensor([0, 2], dtype=torch.int32, device=card)
    m1, w1 = means.clone(), weights.clone()
    sk.tdigest_fold(m1, w1, idx, bm, batch_weights=bw, compression=K)
    m2, w2 = means.clone(), weights.clone()
    sk.tdigest_fold_plain(m2, w2, idx, bm, weights_b=bw, compression=K)
    torch.cuda.synchronize()
    assert torch.equal(w1, w2)
    assert int((w1[0] > 0).sum()) == 1
    torch.testing.assert_close(m1, m2, rtol=1e-5, atol=1e-6, equal_nan=True)

def _bulk_stack(sk, rng, C, K, device, n=300):
    """C digests of n values each (row s centred on s % 50), one plain
    fold call."""
    means = torch.zeros(C, K, device=device)
    weights = torch.zeros(C, K, device=device)
    vals = rng.normal(np.arange(C)[:, None] % 50, 1 + np.arange(C)[:, None]
                      % 3, (C, n)).astype(np.float32)
    sk.tdigest_fold_plain(means, weights,
                          torch.arange(C, dtype=torch.int32, device=device),
                          torch.from_numpy(vals).to(device),
                          torch.ones(C, n, dtype=torch.bool, device=device),
                          compression=K)
    return means, weights


MERGED_CASES = ["daemon_shape", "duplicated_rows", "one_valid_row",
                "q_ends"]


@pytest.mark.cuda
@pytest.mark.parametrize("case", MERGED_CASES)
def test_merged_quantile_edge_selections(card, case):
    """The merged quantile's radix sort at the selections that test it:
    the daemon's shape (10,000 valid of 16,384 rows), 64 digests repeated
    256 times (equal keys in every radix tile), one valid row of 1,024,
    and q = 0 and 1 alone. Quantiles within rtol 1e-4 of the plain version
    (cluster means sum ~2e4 centroids in another order) and bit-identical
    on a second run; the merged digest's weights, integral sums below
    2^24, exactly the plain compress's."""
    sk = _sk()
    rng = np.random.default_rng(len(case))
    K = 128
    q = torch.tensor([0.0, 0.01, 0.5, 0.95, 0.99, 1.0], device=card)
    if case == "daemon_shape":
        means, weights = _bulk_stack(sk, rng, 10_000, K, card)
        S = 16384
        idx = torch.arange(S, dtype=torch.int32, device=card) % 10_000
        valid = torch.arange(S, device=card) < 10_000
    elif case == "duplicated_rows":
        means, weights = _bulk_stack(sk, rng, 64, K, card)
        idx = (torch.arange(64 * 256, device=card) % 64).to(torch.int32)
        valid = torch.ones(idx.shape[0], dtype=torch.bool, device=card)
    elif case == "one_valid_row":
        means, weights = _bulk_stack(sk, rng, 1024, K, card)
        idx = torch.arange(1024, dtype=torch.int32, device=card)
        valid = idx == 517
    else:
        means, weights = _bulk_stack(sk, rng, 256, K, card)
        idx = torch.arange(256, dtype=torch.int32, device=card)
        valid = torch.ones(256, dtype=torch.bool, device=card)
        q = torch.tensor([0.0, 1.0], device=card)
    got = sk.merged_quantile(means, weights, idx, valid, q, compression=K)
    again = sk.merged_quantile(means, weights, idx, valid, q,
                               compression=K)
    want = sk.merged_quantile_plain(means, weights, idx, valid, q,
                                    compression=K)
    dm, dw = sk.merged_digest(means, weights, idx, valid, compression=K)
    pm, pw = sk.merged_digest_plain(means, weights, idx, valid,
                                    compression=K)
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-5)
    assert torch.equal(dw, pw)
    torch.testing.assert_close(dm, pm, rtol=1e-4, atol=1e-5)


@pytest.mark.cuda
def test_live_sketches_on_card_match_cpu(card):
    """The same observe stream into stacks on the card (folded by the
    kernels, on the folder thread) and on the CPU: slots and HLL
    registers identical, each digest's total weight exact, quantiles
    within the t-digest tolerance."""
    from opentsdb_tpu_torch.stats.livesketch import LiveSketches
    rng = np.random.default_rng(2)
    sks = [LiveSketches(flush_points=5000, device=d) for d in (card, "cpu")]
    for i in range(300):
        v = rng.normal(i % 13, 2, 1 + i % 50)
        tags = [(b"m", b"k", int(i % 37).to_bytes(3, "big"))]
        for s in sks:
            s.observe(b"s%03d" % (i % 40), v, tags)
    for s in sks:
        s.flush()
    gpu, cpu = sks
    assert gpu._td_slots == cpu._td_slots
    assert torch.equal(gpu._hll_regs.cpu(), cpu._hll_regs)
    assert torch.equal(gpu._td_weights.sum(1).cpu(),
                       cpu._td_weights.sum(1))
    keys = cpu.series_keys()
    np.testing.assert_allclose(gpu.quantile(keys, [0.1, 0.5, 0.9]),
                               cpu.quantile(keys, [0.1, 0.5, 0.9]),
                               rtol=0.02)
    assert gpu.distinct(b"m", b"k") == cpu.distinct(b"m", b"k") == 37


@pytest.mark.cuda
def test_merge_from_on_card_matches_cpu(card):
    """merge_from on stacks on the card (the fold kernel with the
    incoming digests as the batch, register max) against the same merge
    on the CPU: slots and registers identical, total weights exact,
    quantiles within the t-digest tolerance."""
    from opentsdb_tpu_torch.stats.livesketch import LiveSketches
    rng = np.random.default_rng(4)
    feed = [(b"s%02d" % (i % 7), b"s%02d" % (i % 11),
             rng.normal(0, 1, 300), rng.normal(2, 1, 300),
             [(b"m", b"k", int(i).to_bytes(3, "big"))]) for i in range(30)]
    merged = []
    for device in (card, "cpu"):
        a, b = (LiveSketches(device=device) for _ in range(2))
        for ka, kb, va, vb, tags in feed:
            a.observe(ka, va, tags)
            b.observe(kb, vb, tags)
        launches = _sk().tdigest_fold.launches
        a.merge_from(b)
        if device == card:
            assert _sk().tdigest_fold.launches > launches
        merged.append(a)
    gpu, cpu = merged
    assert gpu._td_slots == cpu._td_slots
    assert torch.equal(gpu._hll_regs.cpu(), cpu._hll_regs)
    assert torch.equal(gpu._td_weights.sum(1).cpu(), cpu._td_weights.sum(1))
    keys = cpu.series_keys()
    np.testing.assert_allclose(gpu.quantile(keys, [0.1, 0.5, 0.9]),
                               cpu.quantile(keys, [0.1, 0.5, 0.9]),
                               rtol=0.02)


@pytest.mark.cuda
def test_sketch_queries_on_card_launch_kernels(card):
    from opentsdb_tpu_torch.core.tsdb import TSDB
    from opentsdb_tpu_torch.query.executor import QueryExecutor
    from opentsdb_tpu_torch.storage.kv import MemKVStore
    from opentsdb_tpu_torch.utils.config import Config
    sk = _sk()
    rng = np.random.default_rng(3)
    t = TSDB(MemKVStore(), Config(auto_create_metrics=True,
                                  device_window=False),
             start_compaction_thread=False)
    for h in range(20):
        t.add_batch("m", 1356998400 + np.arange(200) * 30,
                    rng.normal(50, 10, 200), {"host": f"h{h:02d}"})
    before = (sk.tdigest_fold.launches, sk.hll_fold.launches,
              sk.hll_estimate.launches, sk.merged_quantile.launches)
    ex = QueryExecutor(t)
    assert ex.sketch_distinct("m", "host") == 20
    out = ex.sketch_quantiles("m", {}, [0.5])
    assert 45 < out["quantiles"]["0.5"] < 55 and out["series"] == 20
    assert ex.distinct_tagv("m", {}, "host", 1356998400,
                            1356998400 + 7200) == 20
    after = (sk.tdigest_fold.launches, sk.hll_fold.launches,
             sk.hll_estimate.launches, sk.merged_quantile.launches)
    assert all(a > b for a, b in zip(after, before))
    t.shutdown()


@pytest.mark.cuda
def test_accounting_daemon_on_card_answers_like_cpu(card, tmp_path):
    """The daemon with the default Config (tenant accounting on, the
    window and the sketches on the card) answers /api/put (JSON and put
    lines, a 429 past the limit) and /api/tenants with the bytes the
    same daemon on the CPU answers."""
    import asyncio
    import json

    from opentsdb_tpu_torch.core.tsdb import TSDB
    from opentsdb_tpu_torch.server.tsd import TSDServer
    from opentsdb_tpu_torch.storage.kv import MemKVStore
    from opentsdb_tpu_torch.utils.config import Config
    bt = 1356998400
    rng = np.random.default_rng(6)
    pts = [{"metric": "card.m", "timestamp": bt + 30 * i,
            "value": round(float(v), 3), "tags": {"host": f"h{i % 12}"}}
           for i, v in enumerate(rng.normal(0, 5, 240))]
    lines = "\n".join(f"card.l {p['timestamp']} {p['value']} "
                      f"host={p['tags']['host']}" for p in pts)
    script = [("/api/put?tenant=a", "POST", json.dumps(pts)),
              ("/api/put?tenant=b", "POST", lines),
              ("/api/put?tenant=a", "POST",
               f"card.m {bt} 1 host=new\n"),
              ("/api/tenants", "GET", "")]

    async def http(port, target, method, body):
        reader, writer = await asyncio.open_connection("127.0.0.1", port)
        raw = body.encode()
        writer.write((f"{method} {target} HTTP/1.1\r\nContent-Length: "
                      f"{len(raw)}\r\nConnection: close\r\n\r\n").encode()
                     + raw)
        await writer.drain()
        out = await reader.read()
        writer.close()
        return out

    answers = []
    for device in ("cuda", "cpu"):
        tsdb = TSDB(MemKVStore(wal_path=str(tmp_path / f"{device}.wal")),
                    Config(auto_create_metrics=True, device=device,
                           port=0, bind="127.0.0.1", tenant_max_series=12),
                    start_compaction_thread=False)
        assert tsdb.tenants is not None
        server = TSDServer(tsdb)

        async def main():
            await server.start()
            try:
                return [await http(server.port, *step) for step in script]
            finally:
                await server.stop()
        answers.append(asyncio.run(main()))
    assert answers[0] == answers[1]
    assert answers[0][2].startswith(b"HTTP/1.1 429 ")
    info = json.loads(answers[0][3].partition(b"\r\n\r\n")[2])
    assert info["tenants"]["a"]["series"] == info["tenants"]["b"][
        "series"] == 12


# ---------------------------------------------------------------------------
# The TSST4 block decode (csrc/block_decode.cu) and the fused plan
# ---------------------------------------------------------------------------

def decode_stream(rng, P, pad=0, pad_layout="bytes", scalar_base=False,
                  empty_payload=False, rec=None, blk_recs=5,
                  irregular=False):
    """A seeded decode input: random byte counts (0-4) and payload bytes
    (so the running sums overflow int32 and the value words take every
    float32 bit pattern, NaNs included), records of random length (or of
    ``rec`` points each), blocks of ``blk_recs`` records, and ``pad``
    padding points in the byte-stream layout (first_idx = blk_first = 0)
    or the device cache's (each pointing at itself). ``irregular`` points
    1% of first_idx and blk_first anywhere in [-5, n + 5), forward and
    out of range included."""
    ts_nb = rng.integers(0, 5, P).astype(np.int32)
    v_nb = rng.integers(0, 5, P).astype(np.int32)
    if rec is None:
        starts = np.sort(rng.choice(P, min(P, max(P // 20, 1)),
                                    replace=False))
    else:
        starts = np.arange(0, P, rec)
    starts[0] = 0
    first = starts[np.searchsorted(starts, np.arange(P), "right") - 1]
    bstarts = starts[::blk_recs]
    blk = bstarts[np.searchsorted(bstarts, np.arange(P), "right") - 1]
    if irregular:
        for a in (first, blk):
            m = rng.random(P) < 0.01
            a[m] = rng.integers(-5, P + pad + 5, int(m.sum()))
    if pad_layout == "bytes":
        pad_idx = np.zeros(pad, np.int64)
    else:
        pad_idx = np.arange(P, P + pad)
    ts_nb = np.concatenate([ts_nb, np.zeros(pad, np.int32)])
    v_nb = np.concatenate([v_nb, np.zeros(pad, np.int32)])
    if empty_payload:
        ts_nb[:] = 0
        v_nb[:] = 0
        ts_pay = v_pay = np.zeros(0, np.uint8)
    else:
        ts_pay = rng.integers(0, 256, int(ts_nb.sum()) + 3).astype(np.uint8)
        v_pay = rng.integers(0, 256, int(v_nb.sum())).astype(np.uint8)
    n = P + pad
    base = (int(rng.integers(-2**31, 2**31)) if scalar_base else
            rng.integers(-2**31, 2**31, n).astype(np.int32))
    return (ts_nb, ts_pay, v_nb, v_pay,
            np.concatenate([first, pad_idx]).astype(np.int32),
            np.concatenate([blk, pad_idx]).astype(np.int32), base)


TILE = 4096  # csrc/block_decode.cu kTile

DECODE_CASES = {
    "small": dict(P=3000), "bytes_padding": dict(P=5000, pad=777),
    "devcache_padding": dict(P=5000, pad=777, pad_layout="self"),
    "scalar_base": dict(P=4096, scalar_base=True),
    "empty_payload": dict(P=100, pad=10, empty_payload=True),
    "one_point": dict(P=1),
    "many_tiles": dict(P=2_500_000, pad=1000),
    # 1-second records (3,600 points) over several tiles, 2 a block.
    "long_records": dict(P=20 * TILE + 17, rec=3600, blk_recs=2, pad=900),
    # first_idx and blk_first more than one tile back (4 tiles a record,
    # one record a block), device-cache padding.
    "first_idx_far": dict(P=40 * TILE, rec=4 * TILE + 3, blk_recs=1,
                          pad=333, pad_layout="self"),
    # every record and block start on a tile edge.
    "tile_edges": dict(P=24 * TILE, rec=TILE, blk_recs=2, pad=TILE),
    # first_idx / blk_first anywhere: the general launch's path.
    "irregular": dict(P=300_000, pad=100, irregular=True),
    # the week's gather: 10,485,760 points, 360-point records.
    "week_size": dict(P=10_000_400, rec=360, blk_recs=8, pad=485_360),
}
# n = k * tile - 1, k * tile, k * tile + 1, in both padding layouts.
for _k in (1, 7):
    for _d in (-1, 0, 1):
        for _lay in ("bytes", "self"):
            DECODE_CASES[f"edge_{_k}tile{_d:+d}_{_lay}"] = dict(
                P=_k * TILE + _d - 37, pad=37, pad_layout=_lay,
                rec=TILE // 3 + 5)


def _decode_inputs(case, card):
    rng = np.random.default_rng(sum(map(ord, case)))
    args = decode_stream(rng, **DECODE_CASES[case])
    cpu = [torch.from_numpy(a) if isinstance(a, np.ndarray) else a
           for a in args]
    return cpu, [a.to(card) if isinstance(a, torch.Tensor) else a
                 for a in cpu]


def _same_decode(got, want):
    return torch.equal(got[0].cpu(), want[0].cpu()) and torch.equal(
        got[1].cpu().view(torch.int32), want[1].cpu().view(torch.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("vkind", ["f32", "int"])
@pytest.mark.parametrize("case", list(DECODE_CASES))
def test_block_decode_matches_plain_bit_for_bit(card, case, vkind):
    """The decode kernel against decode_points_plain on the same inputs:
    rel_ts and the value bits identical on every point, padding points
    included; int32 sums that wrap; an empty payload; records far longer
    than a tile, lookups several tiles back, starts on tile edges, n one
    off a multiple of the tile; irregular lookups (the general launch);
    the week's gather size (10.5M points)."""
    from opentsdb_tpu_torch.ops.block_decode import (decode_points,
                                                     decode_points_plain)
    cpu, gpu = _decode_inputs(case, card)
    before = decode_points.launches
    got = decode_points(*gpu, vkind=vkind)
    torch.cuda.synchronize()
    assert decode_points.launches == before + 1
    assert _same_decode(got, decode_points_plain(*cpu, vkind=vkind))


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["long_records", "irregular"])
def test_block_decode_repeats_without_reset(card, case):
    """Three calls in a row, then calls on two streams at once, give the
    first call's bits: the status words need no reset between calls."""
    from opentsdb_tpu_torch.ops.block_decode import decode_points
    _, gpu = _decode_inputs(case, card)
    first = decode_points(*gpu, vkind="f32")
    for _ in range(3):
        assert _same_decode(decode_points(*gpu, vkind="f32"), first)
    streams = [torch.cuda.Stream(card) for _ in range(2)]
    torch.cuda.synchronize()
    outs = []
    for _ in range(3):
        for st in streams:
            with torch.cuda.stream(st):
                outs.append(decode_points(*gpu, vkind="f32"))
    torch.cuda.synchronize()
    assert all(_same_decode(o, first) for o in outs)


@pytest.mark.cuda
def test_fused_query_on_card(card, tmp_path):
    """A TSST4 store on a CUDA TSDB: downsampled queries take the fused
    plan through the decode kernel, with the answers of the raw scan and
    of the same store's fused plan on the CPU (within the executor's
    float32 contract)."""
    from opentsdb_tpu_torch.core.tsdb import TSDB
    from opentsdb_tpu_torch.ops.block_decode import decode_points
    from opentsdb_tpu_torch.query.executor import QueryExecutor, QuerySpec
    from opentsdb_tpu_torch.storage.kv import MemKVStore
    from opentsdb_tpu_torch.utils.config import Config
    base = 1356998400
    rng = np.random.default_rng(11)
    t = TSDB(MemKVStore(wal_path=str(tmp_path / "wal")),
             Config(auto_create_metrics=True, device="cuda",
                    enable_sketches=False, device_window=False,
                    sstable_codec="tsst4"), start_compaction_thread=False)
    try:
        for si in range(8):
            ts = base + np.arange(0, 24 * 3600, 300, dtype=np.int64) + si
            t.add_batch("m.cpu", ts,
                        np.cumsum(rng.normal(0, 1, len(ts))) + 50 + si,
                        {"host": f"h{si}", "dc": f"d{si % 2}"})
            t.add_batch("m.int", ts,
                        rng.integers(-1000, 10_000, len(ts)).astype(float),
                        {"host": f"h{si}"})
        t.checkpoint()
        ex = QueryExecutor(t)
        for spec in [QuerySpec("m.cpu", {}, "sum", downsample=(3600, "avg")),
                     QuerySpec("m.cpu", {"host": "*"}, "max",
                               downsample=(3600, "max")),
                     QuerySpec("m.cpu", {"dc": "d1"}, "p95",
                               downsample=(7200, "sum")),
                     QuerySpec("m.int", {}, "sum", downsample=(3600, "sum"))]:
            before = decode_points.launches
            ex._fused_stage_cache.clear()
            got, plan, _ = ex.run_with_plan(spec, base + 100,
                                            base + 20 * 3600)
            assert plan == "fused"
            t.config.sstable_fused_agg = False
            raw, plan_raw, _ = ex.run_with_plan(spec, base + 100,
                                                base + 20 * 3600)
            t.config.sstable_fused_agg = True
            assert plan_raw == "raw"
            assert len(got) == len(raw) > 0
            for a, b in zip(got, raw):
                assert a.tags == b.tags
                assert np.array_equal(a.timestamps, b.timestamps)
                np.testing.assert_allclose(a.values, b.values, rtol=1e-5,
                                           atol=1e-5)
            # The first query of a gather decodes (a device cache miss);
            # later ones over the same blocks reuse its columns.
            assert decode_points.launches >= before
        assert decode_points.launches > 0
    finally:
        t.shutdown()


# ---------------------------------------------------------------------------
# The rollup window fold (csrc/rollup_fold.cu)
# ---------------------------------------------------------------------------

def _fold_series(case: str):
    """(ts int64 sorted, vals float64, res) of one rollup fold layout."""
    rng = np.random.default_rng(ROLLUP_FOLD_CASES.index(case))
    base = 1356998400
    if case == "one point":
        return np.array([base + 17]), np.array([3.25]), 3600
    if case == "one window":
        ts = base + np.sort(rng.choice(3600, 40, replace=False))
        return ts, rng.normal(50, 10, 40), 3600
    if case == "empty interior windows":
        ts = np.concatenate([base + np.arange(0, 600, 60),
                             base + 5 * 3600 + np.arange(0, 900, 90),
                             base + 23 * 3600 + np.arange(0, 300, 30)])
        return ts, rng.normal(50, 10, len(ts)), 3600
    if case == "special values":
        ts = base + np.arange(0, 6 * 3600, 300)
        v = rng.normal(50, 10, len(ts))
        v[[2, 20, 41]] = [np.inf, -np.inf, np.inf]
        v[[55, 56]] = [-np.inf, np.nan]
        return ts, v, 3600
    if case.startswith("smoke day"):
        # One (series, day) of the smoke's corpus: ~143 points.
        step = 7 * 86400 // 1000
        ts = np.unique(base + np.minimum(
            np.arange(143) * step + rng.integers(0, step // 2, 143),
            86399))
        return (ts, 100 + np.cumsum(rng.normal(0, 1, len(ts))),
                int(case.split()[-1]))
    if case == "week at 1 s":
        ts = base + np.arange(604_800)
        return ts, 1000 + np.cumsum(rng.normal(0, 0.1, len(ts))), 3600
    if case == "2^22 windows":
        ts = np.unique(np.concatenate([
            rng.integers(0, (1 << 22) * 60, 5000), [(1 << 22) * 60 - 1]]))
        return base + ts, rng.normal(0, 1e6, len(ts)), 60
    raise AssertionError(case)


ROLLUP_FOLD_CASES = ("one point", "one window", "empty interior windows",
              "special values", "smoke day 3600", "smoke day 7200",
              "smoke day 86400", "week at 1 s", "2^22 windows")


def _fold_on(dev, ts, vals, res):
    from opentsdb_tpu_torch.ops import rollup_fold
    origin = int(ts[0]) - int(ts[0]) % res
    W = (int(ts[-1]) - origin) // res + 1
    rel = torch.from_numpy((ts - origin).astype(np.int32)).to(dev)
    v = torch.from_numpy(np.asarray(vals, np.float64)).to(dev)
    return rollup_fold.window_fold(rel, v, num_windows=W, res=res), W


@pytest.mark.cuda
@pytest.mark.parametrize("case", ROLLUP_FOLD_CASES)
def test_rollup_fold_matches_plain_and_host(card, case):
    """The kernel against its plain version and the host fold: count,
    min, max, first, last and the brackets exact (NaN where numpy gives
    NaN), sum within rtol 1e-12 (a fixed order, not numpy's pairwise
    one); one launch a call; two calls bit-identical."""
    from opentsdb_tpu_torch.ops import rollup_fold
    from opentsdb_tpu_torch.rollup import summary
    ts, vals, res = _fold_series(case)
    before = rollup_fold.window_fold.launches
    got, W = _fold_on(card, ts, vals, res)
    again, _ = _fold_on(card, ts, vals, res)
    torch.cuda.synchronize()
    assert rollup_fold.window_fold.launches == before + 2
    for a, b in zip(got, again):
        assert torch.equal(a.view(torch.int32) if a.dtype == torch.int32
                           else a.view(torch.int64),
                           b.view(torch.int32) if b.dtype == torch.int32
                           else b.view(torch.int64))
    plain, _ = _fold_on(torch.device("cpu"), ts, vals, res)
    g = [x.cpu() for x in got]
    count = g[0]
    assert torch.equal(count, plain[0])
    some = count > 0
    for i in (2, 3, 4, 5, 6, 7):
        assert torch.equal(g[i][some].nan_to_num(7.5),
                           plain[i][some].nan_to_num(7.5)), i
    torch.testing.assert_close(g[1][some], plain[1][some], rtol=1e-12,
                               atol=0, equal_nan=True)
    wbase, rec = summary.window_summaries(ts, vals, res)
    w_idx = torch.nonzero(some).flatten().numpy()
    origin = int(ts[0]) - int(ts[0]) % res
    assert np.array_equal(origin + w_idx.astype(np.int64) * res, wbase)
    assert np.array_equal(count[some].numpy(), rec["count"])
    for i, f in ((2, "min"), (3, "max"), (4, "first"), (5, "last")):
        np.testing.assert_array_equal(g[i][some].numpy(), rec[f])
    np.testing.assert_allclose(g[1][some].numpy(), rec["sum"], rtol=1e-12,
                               atol=0)
    assert np.array_equal(g[6][some].numpy() + origin - wbase,
                          rec["first_dt"])
    assert np.array_equal(g[7][some].numpy() + origin - wbase,
                          rec["last_dt"])


@pytest.mark.cuda
def test_rollup_fold_device_summaries_match_host(card):
    """window_summaries_device on the card, the tier's checkpoint fold:
    one launch a call, the host fold's records but for the sum's last
    bits."""
    from opentsdb_tpu_torch.ops import rollup_fold
    from opentsdb_tpu_torch.rollup import summary
    for case in ROLLUP_FOLD_CASES:
        ts, vals, res = _fold_series(case)
        before = rollup_fold.window_fold.launches
        wb, rec = summary.window_summaries_device(ts, vals, res,
                                                  device="cuda")
        assert rollup_fold.window_fold.launches == before + 1, case
        wb2, rec2 = summary.window_summaries(ts, vals, res)
        assert np.array_equal(wb, wb2), case
        for f in ("count", "min", "max", "first", "last", "first_dt",
                  "last_dt"):
            np.testing.assert_array_equal(rec[f], rec2[f], err_msg=case)
        np.testing.assert_allclose(rec["sum"], rec2["sum"], rtol=1e-12,
                                   atol=0, err_msg=case)


@pytest.mark.cuda
def test_rollup_fold_rejects_unsorted_and_launch_failure(card):
    """Unsorted timestamps raise (the windows that see it read count
    -1); a launch the card refuses (the library's call returns
    cudaErrorInvalidConfiguration, 9) raises, with no fallback, and
    counts no launch."""
    from opentsdb_tpu_torch.ops import rollup_fold
    from opentsdb_tpu_torch.rollup import summary
    rel = torch.tensor([0, 5, 3, 7200], dtype=torch.int32, device=card)
    v = torch.ones(4, dtype=torch.float64, device=card)
    with pytest.raises(ValueError, match="sorted"):
        rollup_fold.window_fold(rel, v, num_windows=3, res=3600)
    with pytest.raises(ValueError, match="sorted"):
        summary.window_summaries_device(
            np.array([100, 50, 4000]), np.ones(3), 3600, device="cuda")
    rel = torch.tensor([0, 5, 30], dtype=torch.int32, device=card)

    class Refused:
        @staticmethod
        def rollup_window_fold_f64(*args):
            return 9

    rollup_fold._kernels()
    before = rollup_fold.window_fold.launches
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(rollup_fold, "_lib", Refused())
        with pytest.raises(RuntimeError, match="launch failed"):
            rollup_fold.window_fold(rel, v[:3], num_windows=1, res=3600)
        with pytest.raises(RuntimeError, match="launch failed"):
            summary.window_summaries_device(
                np.array([0, 5, 30]), np.ones(3), 3600, device="cuda")
    assert rollup_fold.window_fold.launches == before


def _fold_group(S: int, seed: int, points: int = 143):
    """(ts int64, vals float64, bounds [S + 1]) of S series of one day:
    the smoke's group (``points`` a series) with every fourth series
    empty, one point or a few points instead, and NaN in some."""
    rng = np.random.default_rng(seed)
    base = 1356998400
    ts, vs, bounds = [], [], [0]
    for j in range(S):
        n = (points, 0, 1, int(rng.integers(2, 40)))[j % 4] if S > 1 \
            else points
        t = base + np.sort(rng.choice(86400, n, replace=False))
        v = 100 + np.cumsum(rng.normal(0, 1, n))
        if n > 3 and j % 7 == 0:
            v[rng.integers(0, n)] = np.nan
        ts.append(t)
        vs.append(v)
        bounds.append(bounds[-1] + n)
    return (np.concatenate(ts).astype(np.int64), np.concatenate(vs),
            np.asarray(bounds, np.int64))


def _bits(x: torch.Tensor) -> np.ndarray:
    x = x.cpu()
    return x.view(torch.int64 if x.element_size() == 8 else torch.int32) \
        .numpy() if x.is_floating_point() else x.numpy()


ROLLUP_GROUP_CASES = [
    # (series, points a full series, resolutions): the smoke's group
    # (2,500 series x one day at 1 h and 1 d), three nested resolutions,
    # one series, a long day of one series, and a lone empty series.
    (2500, 143, (3600, 86400)),
    (50, 143, (3600, 21600, 86400)),
    (1, 143, (3600, 86400)),
    (3, 86400, (3600, 86400)),
    (1, 0, (3600, 86400)),
]


@pytest.mark.cuda
@pytest.mark.parametrize("S,points,res", ROLLUP_GROUP_CASES)
def test_rollup_group_fold_bit_identical_to_plain(card, S, points, res):
    """The batched fold on the card against its plain version on the
    CPU, every output bit for bit (the plain version follows the kernel's
    order of addition); two calls identical; one launch a call; and the
    tier's entry, group_summaries_device, gives the CPU's records byte
    for byte."""
    from opentsdb_tpu_torch.ops import rollup_fold
    from opentsdb_tpu_torch.rollup import summary
    base = 1356998400
    ts, vals, bounds = _fold_group(S, S + points, points)
    W = [86400 // r for r in res]
    args = [torch.from_numpy((ts - base).astype(np.int32)),
            torch.from_numpy(vals), torch.from_numpy(bounds)]
    before = rollup_fold.window_fold.launches
    got = rollup_fold.window_fold_batch(*(a.to(card) for a in args),
                                        res=res, num_windows=W)
    again = rollup_fold.window_fold_batch(*(a.to(card) for a in args),
                                          res=res, num_windows=W)
    torch.cuda.synchronize()
    assert rollup_fold.window_fold.launches == before + 2
    want = rollup_fold.window_fold_batch_plain(*args, res=res,
                                               num_windows=W)
    for g, a, w in zip(got, again, want):
        assert np.array_equal(_bits(g), _bits(w))
        assert np.array_equal(_bits(a), _bits(w))
    before = rollup_fold.window_fold.launches
    dev = summary.group_summaries_device(ts, vals, bounds, base, 86400, res,
                                         device="cuda")
    assert rollup_fold.window_fold.launches == before + 1
    cpu = summary.group_summaries_device(ts, vals, bounds, base, 86400, res,
                                         device="cpu")
    for (wb, rec, st), (wb2, rec2, st2) in zip(dev, cpu):
        assert np.array_equal(wb, wb2) and np.array_equal(st, st2)
        assert rec.tobytes() == rec2.tobytes()


@pytest.mark.cuda
def test_rollup_group_fold_rejects_unsorted_and_launch_failure(card,
                                                               monkeypatch):
    """An unsorted series raises after the group's one read-back; a
    launch the card refuses raises, with no fallback, and counts no
    launch."""
    from opentsdb_tpu_torch.ops import rollup_fold
    from opentsdb_tpu_torch.rollup import summary
    base = 1356998400
    ts, vals, bounds = _fold_group(12, 5)
    a = bounds[4]
    ts[a], ts[a + 1] = ts[a + 1], ts[a]
    reads = []
    to_numpy = rollup_fold.to_numpy
    monkeypatch.setattr(rollup_fold, "to_numpy",
                        lambda out: reads.append(1) or to_numpy(out))
    with pytest.raises(ValueError, match="sorted"):
        summary.group_summaries_device(ts, vals, bounds, base, 86400,
                                       (3600, 86400), device="cuda")
    assert len(reads) == 1

    class Refused:
        @staticmethod
        def rollup_window_fold_f64(*args):
            return 9

    rollup_fold._kernels()
    before = rollup_fold.window_fold.launches
    monkeypatch.setattr(rollup_fold, "_lib", Refused())
    ts.sort()
    with pytest.raises(RuntimeError, match="launch failed"):
        summary.group_summaries_device(ts[:bounds[1]], vals[:bounds[1]],
                                       bounds[:2], base, 86400,
                                       (3600, 86400), device="cuda")
    assert rollup_fold.window_fold.launches == before


# ---------------------------------------------------------------------------
# The smoothing scans (csrc/smoothing.cu)
# ---------------------------------------------------------------------------

SMOOTHING_CASES = [
    # (S, T, season, horizon): /forecast's hourly week at full width, its
    # 5-minute week of ten dcs, the longest season the route takes, and
    # the seasons around the kernel's prefetch switch (m >= 16).
    (10_000, 169, 24, 24),
    (10, 2017, 288, 24),
    (64, 12_000, 10_000, 50),
    (100, 300, 0, 10),
    (100, 300, 1, 10),
    (100, 300, 7, 10),
    (100, 300, 15, 20),
    (100, 300, 16, 20),
    (33, 5, 24, 30),
]


def _smoothing_inputs(S, T, seed):
    """Time-major [T, S] values and mask: a level, a drift, a daily
    cycle, noise, ~20% gaps, one all-masked series and a spike."""
    rng = np.random.default_rng(seed)
    t = np.arange(T)[:, None]
    v = (rng.normal(100, 30, (1, S)) + rng.normal(0, 0.05, (1, S)) * t
         + rng.uniform(0, 10, (1, S)) * np.sin(2 * np.pi * t / 24)
         + rng.normal(0, 2, (T, S)))
    m = rng.random((T, S)) > 0.2
    m[:, 0] = False
    if S > 2:
        v[T // 2, 2] += 1000.0
        m[T // 2, 2] = True
    v = np.where(m, v, 0.0).astype(np.float32)
    return torch.from_numpy(v), torch.from_numpy(m)


@pytest.mark.cuda
@pytest.mark.parametrize("S,T,season,horizon", SMOOTHING_CASES)
def test_smoothing_kernels_bit_identical_to_plain(card, S, T, season,
                                                  horizon):
    """Both kernels against their plain versions on the card, bit for bit
    (every operation rounded on its own on both sides, sqrt correctly
    rounded): the EWMA, and the fused Holt-Winters fit, bands, anomaly
    flags, final state and forecasts; two calls bit-identical; one launch
    a call."""
    from opentsdb_tpu_torch.ops import smoothing
    v, m = _smoothing_inputs(S, T, S + T + season)
    v, m = v.to(card), m.to(card)
    kw = dict(alpha=0.3, beta=0.1, gamma=0.2, season=season, nsigma=3.0,
              resid_alpha=0.05, warmup=10, horizon=horizon)
    before = (smoothing.ewma_scan.launches,
              smoothing.holt_winters_bands.launches)
    got = smoothing.holt_winters_bands(v, m, **kw)
    again = smoothing.holt_winters_bands(v, m, **kw)
    e = smoothing.ewma_scan(v, m, 0.3)
    torch.cuda.synchronize()
    assert (smoothing.ewma_scan.launches,
            smoothing.holt_winters_bands.launches) == (before[0] + 1,
                                                       before[1] + 2)
    want = smoothing.holt_winters_bands_plain(v, m, **kw)
    assert got.keys() == want.keys()
    for k in want:
        assert torch.equal(got[k], want[k]), k
    for k in again:
        assert torch.equal(again[k], want[k]), k
    assert torch.equal(e, smoothing.ewma_scan_plain(v, m, 0.3))
    if S > 2:
        assert bool(got["anomaly"][T // 2, 2]) or T < 12


EWMA_GRID = [(S, T) for S in (1, 31, 33, 10_000)
             for T in (1, EWMA_SEGMENT - 1, EWMA_SEGMENT, EWMA_SEGMENT + 1,
                       2 * EWMA_SEGMENT + 1, 2017, 12_000)]


def _ewma_inputs(S, T, seed, device):
    """Time-major [T, S] values and mask on ``device``, each a view one
    element into its buffer (no row starts 16-byte aligned where S % 4,
    and none of them where S % 4 == 0): noise around a level, ~20% gaps,
    series 0 all masked (S > 1), NaN, +inf and -inf at real and masked
    steps, and in the last series an inf then the opposite inf across
    the first segment boundary."""
    rng = np.random.default_rng(seed)
    v = rng.normal(100, 30, (T, S)).astype(np.float32)
    m = rng.random((T, S)) > 0.2
    if S > 1:
        m[:, 0] = False
    k = max(4, S * T // 1000)
    rows, cols = rng.integers(T, size=k), rng.integers(S, size=k)
    v[rows, cols] = rng.choice(np.array([np.nan, np.inf, -np.inf],
                                        np.float32), k)
    m[rows, cols] = rng.random(k) > 0.3
    if T > EWMA_SEGMENT + 1:
        v[EWMA_SEGMENT:EWMA_SEGMENT + 2, S - 1] = (np.inf, -np.inf)
        m[EWMA_SEGMENT:EWMA_SEGMENT + 2, S - 1] = True
    out = []
    for a in (v, m):
        buf = torch.zeros(a.size + 1, dtype=torch.from_numpy(a).dtype,
                          device=device)
        buf[1:] = torch.from_numpy(a.ravel()).to(device)
        out.append(buf[1:].view(T, S))
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("S,T", EWMA_GRID)
def test_ewma_grid_bit_identical_to_plain(card, S, T):
    """The segmented EWMA scan on the card against its plain version on
    the card over the grid of series and steps around the segment length,
    at alpha 0, 0.3, 0.999 and 1: the plain version's bits wherever it is
    not NaN, and NaN at the same cells (NaN payloads may differ); inputs
    that are views one element in (offsets into the aligned chunks the
    kernel stages); one launch a call."""
    from opentsdb_tpu_torch.ops import smoothing
    v, m = _ewma_inputs(S, T, S + T, card)
    assert v.data_ptr() % 16 and m.data_ptr() % 16
    for alpha in (0.0, 0.3, 0.999, 1.0):
        before = smoothing.ewma_scan.launches
        got = smoothing.ewma_scan(v, m, alpha)
        torch.cuda.synchronize()
        assert smoothing.ewma_scan.launches == before + 1
        want = smoothing.ewma_scan_plain(v, m, alpha)
        nan = torch.isnan(want)
        assert torch.equal(torch.isnan(got), nan), alpha
        assert torch.equal(got.view(torch.int32)[~nan],
                           want.view(torch.int32)[~nan]), alpha


HW_GRID = [(S, m, T) for S in (1, 10, 33, 10_000) for m in (0, 1, 7, 24, 288)
           for T in (1, 15, 169, 2017)]


@pytest.mark.cuda
@pytest.mark.parametrize("S,season,T", HW_GRID)
def test_holt_winters_grid_bit_identical_to_plain(card, S, season, T):
    """holt_winters_bands on the card against its plain version on the
    card, every output bit for bit (NaN bits too), over the grid of
    series, seasons and steps: gaps in the mask, an all-masked series
    (series 0), a spike, NaN values where S > 3 and T > 3, seasons
    longer than the fit (m > T), horizons 0 and 24; one launch a call."""
    from opentsdb_tpu_torch.ops import smoothing
    v, m = _smoothing_inputs(S, T, S + T + season)
    if S > 3 and T > 3:
        v[T // 3, 3] = float("nan")
        v[1, S - 1] = float("nan")
        m[1, S - 1] = True
    v, m = v.to(card), m.to(card)
    horizon = 24 if (S + T + season) % 2 else 0
    kw = dict(alpha=0.3, beta=0.1, gamma=0.2, season=season, nsigma=3.0,
              resid_alpha=0.05, warmup=10, horizon=horizon)
    before = smoothing.holt_winters_bands.launches
    got = smoothing.holt_winters_bands(v, m, **kw)
    torch.cuda.synchronize()
    assert smoothing.holt_winters_bands.launches == before + 1
    want = smoothing.holt_winters_bands_plain(v, m, **kw)
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].shape == want[k].shape, k
        assert np.array_equal(_bits(got[k]), _bits(want[k])), k


@pytest.mark.cuda
@pytest.mark.parametrize("S,season", [(33, 24), (7, 5), (10, 288)])
def test_holt_winters_views_and_tiny_variances(card, S, season):
    """Inputs that are views at any offset (the kernel stages the aligned
    16-byte chunks around each row) and series whose residual variance
    is tiny (denormal), zero, huge or infinite (the square root's scaled
    and special cases; sigma shows the root only above its floor),
    bit for bit against the plain version."""
    from opentsdb_tpu_torch.ops import smoothing
    T = 500
    v, m = _smoothing_inputs(S, T + 1, S + season)
    v[:, 1] = v[:, 1] * 1e-22
    v[:, S - 1] = 7.0
    if S > 3:
        v[:, 3] = v[:, 3] * 1e18
        v[T // 2, 3] = float("inf")
    kw = dict(alpha=0.3, beta=0.1, gamma=0.2, season=season, nsigma=3.0,
              resid_alpha=0.05, warmup=10, horizon=24)
    v, m = v.to(card)[1:], m.to(card)[1:]
    assert m.data_ptr() % 4 or S % 4 == 0
    got = smoothing.holt_winters_bands(v, m, **kw)
    want = smoothing.holt_winters_bands_plain(v, m, **kw)
    for k in want:
        assert np.array_equal(_bits(got[k]), _bits(want[k])), k


@pytest.mark.cuda
def test_smoothing_models_on_card(card):
    """models/smoothing.py on CUDA tensors: the [S, T] views of the
    kernels' time-major outputs equal the plain versions'."""
    from opentsdb_tpu_torch.models import smoothing as sm
    v, m = _smoothing_inputs(500, 169, 3)
    v, m = v.t().to(card), m.t().to(card)
    got = sm.anomaly_bands(v, m, 0.3, 0.1, 0.1, 24, horizon=24)
    want = sm.anomaly_bands_plain(v, m, 0.3, 0.1, 0.1, 24, horizon=24)
    for k in want:
        assert torch.equal(got[k], want[k]), k
    assert torch.equal(sm.ewma(v, m, 0.5), sm.ewma_plain(v, m, 0.5))
    hw = sm.holt_winters(v, m, season_length=24)
    fc = sm.hw_forecast(hw["level"], hw["trend"], hw["seasonal"],
                        horizon=24, season_length=24, t_fitted=169)
    assert torch.equal(fc, got["forecast"])


@pytest.mark.cuda
def test_smoothing_build_or_launch_failure_raises(card):
    """A launch the card refuses (the library returns
    cudaErrorInvalidConfiguration, 9) and a failed build both raise, with
    no fallback to the plain version, and count no launch."""
    from opentsdb_tpu_torch.ops import cuda_build, smoothing
    v, m = _smoothing_inputs(8, 20, 1)
    v, m = v.to(card), m.to(card)

    class Refused:
        @staticmethod
        def ewma_scan_f32(*args):
            return 9

        @staticmethod
        def holt_winters_bands_f32(*args):
            return 9

    def no_build(name):
        raise RuntimeError(f"nvcc failed for csrc/{name}.cu")

    smoothing._kernels()
    before = (smoothing.ewma_scan.launches,
              smoothing.holt_winters_bands.launches)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(smoothing, "_lib", Refused())
        with pytest.raises(RuntimeError, match="launch failed"):
            smoothing.ewma_scan(v, m, 0.3)
        with pytest.raises(RuntimeError, match="launch failed"):
            smoothing.holt_winters_bands(v, m, season=4, horizon=3)
        mp.setattr(smoothing, "_lib", None)
        mp.setattr(cuda_build, "load", no_build)
        with pytest.raises(RuntimeError, match="nvcc failed"):
            smoothing.ewma_scan(v, m, 0.3)
        with pytest.raises(RuntimeError, match="nvcc failed"):
            smoothing.holt_winters_bands(v, m)
    assert (smoothing.ewma_scan.launches,
            smoothing.holt_winters_bands.launches) == before


# ---------------------------------------------------------------------------
# The mesh plane's combine kernels (csrc/mesh_combine.cu)
# ---------------------------------------------------------------------------

def _partials(rng, D, C, special=None):
    """[D, C] partial planes as a shard's group stage makes them: counts
    (with empty cells), sums, centered m2 >= 0, min, max, any flags.
    ``special`` puts NaN or +-inf into every plane's values."""
    n = rng.integers(0, 6, (D, C)).astype(np.float32)
    total = (rng.normal(0, 50, (D, C)) * (n > 0)).astype(np.float32)
    m2 = (rng.random((D, C)) * 30 * (n > 1)).astype(np.float32)
    mn = np.where(n > 0, rng.normal(-5, 3, (D, C)), np.inf) \
        .astype(np.float32)
    mx = np.where(n > 0, rng.normal(5, 3, (D, C)), -np.inf) \
        .astype(np.float32)
    any_ = (n > 0).astype(np.int32)
    if special == "nan":
        for x in (total, m2, mn, mx):
            x[:, ::7] = np.nan
    elif special == "inf":
        for x in (total, mn, mx):
            x[:, ::5] = np.inf
            x[:, 2::5] = -np.inf
    return n, total, m2, mn, mx, any_


@pytest.mark.cuda
@pytest.mark.parametrize("special", [None, "nan", "inf"])
@pytest.mark.parametrize("D,C", [(1, 1000), (4, 16 * 32), (4, 65_537),
                                 (8, 3000), (3, 0)])
@pytest.mark.parametrize("agg", ["sum", "avg", "dev", "count", "min",
                                 "max", "zimsum", "mimmin", "mimmax"])
def test_moment_combine_bit_for_bit(card, agg, D, C, special):
    """The moment combine kernel equals its plain version bit for bit
    (NaN positions included), empty cells and every plane's NaN / +-inf
    partials too, and counts one launch (none for no cells)."""
    from opentsdb_tpu_torch.ops import mesh_combine as mc
    rng = np.random.default_rng(D * 1000 + C)
    planes = [torch.from_numpy(x).to(card)
              for x in _partials(rng, D, C, special)]
    want = mc.moment_combine_plain(*planes, agg)
    before = mc.moment_combine.launches
    got = mc.moment_combine(*planes, agg=agg)
    torch.cuda.synchronize()
    assert mc.moment_combine.launches == before + (C > 0)
    assert torch.equal(got[1], want[1])
    assert got[0].cpu().numpy().tobytes() == want[0].cpu().numpy().tobytes()


@pytest.mark.cuda
@pytest.mark.parametrize("agg", ["dev", "avg", "min"])
def test_moment_combine_non_contiguous_planes(card, agg):
    """Planes given as transposed views (each copied to a contiguous
    temporary inside the wrapper) give the plain version's bits: every
    temporary lives until the launch is queued."""
    from opentsdb_tpu_torch.ops import mesh_combine as mc
    D, C = 4, 20_001
    rng = np.random.default_rng(11)
    planes = [torch.from_numpy(np.ascontiguousarray(x.T)).to(card).T
              for x in _partials(rng, D, C)]
    assert not any(p.is_contiguous() for p in planes)
    want = mc.moment_combine_plain(*(p.contiguous() for p in planes), agg)
    for _ in range(3):
        got = mc.moment_combine(*planes, agg=agg)
        torch.cuda.synchronize()
        assert torch.equal(got[1], want[1])
        assert got[0].cpu().numpy().tobytes() == \
            want[0].cpu().numpy().tobytes()


def _summaries(rng, D, S, mode):
    """[D, S, 4] int32 tile summaries with series missing from whole
    tiles and one series (row 0) missing from every tile."""
    present = rng.random((D, S)) < 0.6
    if S:
        present[:, 0] = False
    rows = np.zeros((D, S, 4), np.int32)
    vals = rng.normal(0, 10, (D, S, 2)).astype(np.float32)
    if mode == 0:
        bps = 8
        base = (np.arange(D) * bps)[:, None]
        last = base + rng.integers(0, bps, (D, S))
        first = base + rng.integers(0, bps, (D, S))
        rows[:, :, 0] = np.where(present, last, -1)
        rows[:, :, 2] = np.where(present, first, 2**31 - 1)
        rows[:, :, 1] = vals[:, :, 0].view(np.int32)
        rows[:, :, 3] = vals[:, :, 1].view(np.int32)
    else:
        rows[:, :, 0] = present
        rows[:, :, 1] = (np.arange(D) * 1000)[:, None] + rng.integers(
            0, 1000, (D, S))
        rows[:, :, 2] = vals[:, :, 0].view(np.int32)
    return rows


@pytest.mark.cuda
@pytest.mark.parametrize("mode", [0, 1])
@pytest.mark.parametrize("D,S", [(1, 100), (4, 1), (4, 16_384), (8, 4097),
                                 (2, 0)])
def test_tile_carries_bit_for_bit(card, D, S, mode):
    """The carry selection kernel equals its plain version bit for bit,
    series absent from every tile included, and counts one launch (none
    for no series)."""
    from opentsdb_tpu_torch.ops import mesh_combine as mc
    rows = torch.from_numpy(_summaries(np.random.default_rng(S), D, S,
                                       mode)).to(card)
    want = mc.tile_carries_plain(rows, mode)
    before = mc.tile_carries.launches
    got = mc.tile_carries(rows, mode)
    torch.cuda.synchronize()
    assert mc.tile_carries.launches == before + (S > 0)
    assert torch.equal(got, want)
    if S:
        none = got[:, :, 0].cpu().numpy()
        if mode == 0:
            assert (none[0] == -1).all() and (none[2] == 2**31 - 1).all()
        else:
            assert (none[0] == 0).all()


# ---------------------------------------------------------------------------
# The expert dashboard's finish (csrc/expert.cu) and the hybrid mesh's
# two-level combine (csrc/mesh_combine.cu)
# ---------------------------------------------------------------------------

def _finish_planes(rng, Q, cells):
    count = rng.integers(0, 5, (Q, cells)).astype(np.float32)
    total = (rng.normal(0, 30, (Q, cells)) * (count > 0)).astype(np.float32)
    m2 = (rng.random((Q, cells)) * 20 * (count > 1)).astype(np.float32)
    mn = np.where(count > 0, rng.normal(-5, 3, (Q, cells)), np.inf) \
        .astype(np.float32)
    mx = np.where(count > 0, rng.normal(5, 3, (Q, cells)), -np.inf) \
        .astype(np.float32)
    for x in (total, m2, mn, mx):
        x[:, ::9] = np.nan
    m2[:, 4::11] = -1.0
    return count, total, m2, mn, mx


@pytest.mark.cuda
@pytest.mark.parametrize("Q,cells", [(1, 1), (6, 32), (15, 32_768),
                                     (10, 32_768), (40, 1000), (3, 0)])
def test_finish_cells_bit_for_bit(card, Q, cells):
    """The per-cell finish kernel (the fused dash_finish's first step,
    timed beside it) equals its plain version bit for bit at every
    aggregator code (slots of mixed codes in one launch, NaN partials,
    empty cells, a negative centred sum) and counts one launch (none for
    no cells)."""
    from opentsdb_tpu_torch.ops import expert_finish as ef
    rng = np.random.default_rng(Q * 7 + cells)
    planes = [torch.from_numpy(p).to(card)
              for p in _finish_planes(rng, Q, cells)]
    codes = [q % 6 for q in range(Q)]
    want = ef.finish_cells_plain(*planes, codes)
    before = ef.finish_cells.launches
    got = ef.finish_cells(*planes, codes)
    torch.cuda.synchronize()
    assert ef.finish_cells.launches == before + (cells > 0)
    assert got.cpu().numpy().tobytes() == want.cpu().numpy().tobytes()


def _dash_stage(card, Q, S, B, ds, seed, special=True):
    """A shard's series stage on the card, as the dashboard body makes
    it (strided [Q, S * B] views): series s of a slot take 0, 1, 2 or
    many non-empty buckets by s % 4 (one series: many); with
    ``special``, the second-last slot holds NaN and +-inf values and the
    last slot no valid point."""
    from opentsdb_tpu_torch.parallel import expert as tx
    rng = np.random.default_rng(seed)
    slots = []
    for q in range(Q):
        ts, vals, sid = [], [], []
        for s in range(S):
            shape = 3 if S == 1 else s % 4
            if shape == 0:
                continue
            buckets = (rng.choice(B, size=min(shape, B), replace=False)
                       if shape < 3 else np.flatnonzero(rng.random(B) < .6))
            k = rng.integers(1, 4, len(buckets))
            ts += list(np.repeat(buckets, k) * 60
                       + rng.integers(0, 60, int(k.sum())))
            vals += list(rng.normal(50.0, 12.0, int(k.sum())))
            sid += [s] * int(k.sum())
        vals = np.asarray(vals, np.float32)
        if special and Q > 2 and q == Q - 2 and len(vals):
            vals[::7] = np.nan
            vals[3::11] = np.inf
            vals[5::13] = -np.inf
        slots.append((ts, vals, sid,
                      not (special and Q > 1 and q == Q - 1)))
    n = max(1, max(len(x[0]) for x in slots))
    arr = [np.zeros((Q, n), t) for t in (np.int32, np.float32, np.int32,
                                         bool)]
    for q, (ts, vals, sid, ok) in enumerate(slots):
        arr[0][q, :len(ts)], arr[1][q, :len(ts)] = ts, vals
        arr[2][q, :len(ts)], arr[3][q, :len(ts)] = sid, ok
    return tx._dash_series_stage(
        *(torch.from_numpy(x).to(card) for x in arr), ds, num_series=S,
        num_buckets=B, interval=60)


def _same_or_nan(got, want):
    """Bit for bit, NaN in the same places (any NaN bits)."""
    g, w = got.cpu().numpy(), want.cpu().numpy()
    assert g.shape == w.shape and g.dtype == w.dtype
    if g.dtype.kind != "f":
        return np.array_equal(g, w)
    return (np.array_equal(np.isnan(g), np.isnan(w))
            and g[~np.isnan(g)].tobytes() == w[~np.isnan(w)].tobytes())


def _dash_check(got, want, agg):
    """A moment shard's answers: masks and the min / max / count slots
    bit for bit, sums, averages and deviations within rtol 1e-5 + 1e-5 x
    scale (the kernel sums over the series in its own order)."""
    assert _same_or_nan(got[1], want[1])
    for q, code in enumerate(agg):
        g, w = got[0][q], want[0][q]
        if code in (1, 2, 5):
            assert _same_or_nan(g, w), q
            continue
        w64 = w.double().cpu().numpy()
        fin = np.isfinite(w64)
        scale = float(np.abs(w64[fin]).max()) if fin.any() else 1.0
        np.testing.assert_allclose(g.double().cpu().numpy(), w64,
                                   rtol=1e-5, atol=1e-5 * scale)


@pytest.mark.cuda
@pytest.mark.parametrize("fill", [False, True])
@pytest.mark.parametrize("Q,S,B", [(1, 1, 1), (6, 3, 7), (15, 16, 32),
                                   (8, 5, 33), (15, 64, 256), (3, 20, 600),
                                   (15, 1024, 32), (15, 1024, 256)])
def test_dash_finish_bit_for_bit(card, Q, S, B, fill):
    """The fused shard finish equals its plain version (the series
    finish, gap_fill, group_moments and the group finish as torch runs
    them): filled, in_range and the group mask bit for bit, and in a
    moment shard the min / max / count slots bit for bit and the sums at
    float32 tolerance, over every downsampler and group aggregator code,
    series of 0, 1, 2 and many non-empty buckets, a NaN / inf slot and an
    all-empty slot, B past one 256-bucket tile; one launch a call."""
    from opentsdb_tpu_torch.ops import expert_finish as ef
    ds = [q % 6 for q in range(Q)]
    agg = None if fill else [(5 * q + 1) % 6 for q in range(Q)]
    planes = _dash_stage(card, Q, S, B, ds, seed=Q * 1000 + S + B)
    kw = dict(num_series=S, num_buckets=B)
    want = ef.dash_finish_plain(*planes, ds, agg, **kw)
    before = ef.dash_finish.launches
    got = ef.dash_finish(*planes, ds, agg, **kw)
    torch.cuda.synchronize()
    assert ef.dash_finish.launches == before + 1
    if fill:
        assert all(_same_or_nan(g, w) for g, w in zip(got, want))
    else:
        _dash_check(got, want, agg)


@pytest.mark.cuda
@pytest.mark.parametrize("code", range(6))
def test_dash_finish_reads_only_the_planes_its_codes_need(card, code):
    """A launch whose slots all take one downsampler runs with every
    plane it does not read absent (count always read: the series mask),
    on the series stage's strided views, and gives the answers of the
    plain version over contiguous copies of every plane, in both
    modes."""
    from opentsdb_tpu_torch.ops import expert_finish as ef
    Q, S, B = 4, 40, 64
    ds = [code] * Q
    agg = [(code + q) % 6 for q in range(Q)]
    views = _dash_stage(card, Q, S, B, list(range(6)), seed=code)
    need = ef.dash_needs(ds)
    planes = [v if n in need else None for v, n in zip(views, ef.PLANES)]
    assert all(v is not None and not v.is_contiguous() for v in views)
    full = [v.contiguous() for v in views]
    kw = dict(num_series=S, num_buckets=B)
    got = ef.dash_finish(*planes, ds, agg, **kw)
    _dash_check(got, ef.dash_finish_plain(*full, ds, agg, **kw), agg)
    got = ef.dash_finish(*planes, ds, **kw)
    want = ef.dash_finish_plain(*full, ds, **kw)
    torch.cuda.synchronize()
    assert all(_same_or_nan(g, w) for g, w in zip(got, want))


def _hybrid_partials(rng, H, C, cells, special=None):
    n = rng.integers(0, 6, (H, C, cells)).astype(np.float32)
    total = (rng.normal(0, 50, (H, C, cells)) * (n > 0)).astype(np.float32)
    mean = (total / np.maximum(n, 1)).astype(np.float32)
    m2 = (rng.random((H, C, cells)) * 30 * (n > 1)).astype(np.float32)
    mn = np.where(n > 0, rng.normal(-5, 3, (H, C, cells)), np.inf) \
        .astype(np.float32)
    mx = np.where(n > 0, rng.normal(5, 3, (H, C, cells)), -np.inf) \
        .astype(np.float32)
    if special == "nan":
        for x in (total, m2, mn, mx, mean):
            x[..., ::7] = np.nan
    elif special == "inf":
        for x in (total, mn, mx, mean):
            x[..., ::5] = np.inf
            x[..., 2::5] = -np.inf
    return n, total, m2, mean, mn, mx, (n > 0).astype(np.int32)


@pytest.mark.cuda
@pytest.mark.parametrize("special", [None, "nan", "inf"])
@pytest.mark.parametrize("H,C,cells", [(2, 2, 32), (2, 4, 65_537),
                                       (4, 2, 1000), (1, 3, 500),
                                       (3, 1, 500), (16, 2, 300),
                                       (2, 2, 0), (16, 1, 257),
                                       (1, 1, 33), (16, 16, 2_049),
                                       (2, 200, 70)])
@pytest.mark.parametrize("agg", ["sum", "avg", "dev", "count", "min",
                                 "max", "zimsum", "mimmin"])
def test_hybrid_moment_combine_bit_for_bit(card, agg, H, C, cells,
                                           special):
    """The hybrid combine kernel equals its plain version bit for bit,
    finishing and emitting, and emit-then-finish equals the finish in
    one launch; one launch a call (none for no cells). The shapes take
    16 rows, one chip a row, one member, and enough members that a
    block stages fewer than 32 cells."""
    from opentsdb_tpu_torch.ops import mesh_combine as mc
    rng = np.random.default_rng(H * 100 + C * 10 + cells)
    planes = [torch.from_numpy(x).to(card)
              for x in _hybrid_partials(rng, H, C, cells, special)]
    want = mc.hybrid_moment_combine_plain(*planes, agg)
    before = mc.hybrid_moment_combine.launches
    got = mc.hybrid_moment_combine(*planes, agg=agg)
    torch.cuda.synchronize()
    assert mc.hybrid_moment_combine.launches == before + (cells > 0)
    assert torch.equal(got[1], want[1])
    assert got[0].cpu().numpy().tobytes() == want[0].cpu().numpy().tobytes()
    if not cells:
        return
    rows = mc.hybrid_moment_combine(*planes, agg=agg, emit=True)
    prow = mc.hybrid_moment_combine_plain(*planes, agg, emit=True)
    for a, b in zip(rows, prow):
        assert (a is None) == (b is None)
        if a is not None:
            assert a.cpu().numpy().tobytes() == b.cpu().numpy().tobytes()
    again = mc.hybrid_moment_combine(
        *(None if r is None else r[:, None] for r in rows), agg=agg)
    torch.cuda.synchronize()
    assert torch.equal(again[1], got[1])
    assert again[0].cpu().numpy().tobytes() == \
        got[0].cpu().numpy().tobytes()


@pytest.mark.cuda
def test_hybrid_moment_combine_refuses_past_its_rows(card):
    from opentsdb_tpu_torch.ops import mesh_combine as mc
    z = torch.zeros((17, 1, 4), device=card)
    with pytest.raises(ValueError, match="at most"):
        mc.hybrid_moment_combine(z, z, z, z, z, z, z.int(), agg="sum")


@pytest.mark.cuda
def test_expert_dashboard_on_the_card_matches_the_cpu(card):
    """The dashboard body on logical shards of the card against the same
    body on the CPU: masks equal, counts / min / max exact, the rest at
    float32 tolerance (the card's segment sums add in their own order);
    the kernels launched."""
    from opentsdb_tpu_torch.ops import expert_finish as ef
    from opentsdb_tpu_torch.parallel import expert as tx
    from opentsdb_tpu_torch.parallel.mesh import Mesh
    rng = np.random.default_rng(3)
    queries = []
    for i, (fam, ds, agg) in enumerate([
            ("moment", "avg", "sum"), ("percentile", "avg", 0.95),
            ("moment", "max", "max"), ("moment", "sum", "dev"),
            ("percentile", "count", 0.5), ("moment", "dev", "count")]):
        n = 3000
        q = {"family": fam, "dsagg": ds,
             "ts": rng.integers(0, 32 * 300, n).astype(np.int32),
             "sid": rng.integers(0, 60, n).astype(np.int32),
             "vals": rng.normal(20, 6, n).astype(np.float32)}
        q["quantile" if fam == "percentile" else "agg"] = agg
        queries.append(q)
    kw = dict(num_series=64, num_buckets=32, interval=300)
    want = tx.run_dashboard_batch(queries, Mesh(["cpu"] * 4), **kw)
    before = ef.dash_finish.launches
    got = tx.run_dashboard_batch(queries, Mesh([card] * 4), **kw)
    fam = tx.plan_dashboard_batch(queries, 4).fam
    # One finish a shard, moment or percentile.
    assert ef.dash_finish.launches - before == len(fam)
    for q, (gv, gm), (wv, wm) in zip(queries, got, want):
        np.testing.assert_array_equal(gm, wm)
        if q.get("agg") in ("max", "count"):
            np.testing.assert_array_equal(gv[gm], wv[wm])
        else:
            np.testing.assert_allclose(gv[gm], wv[wm], rtol=1e-5,
                                       atol=1e-4)


@pytest.mark.cuda
def test_hybrid_bodies_on_the_card_match_the_cpu(card):
    """The three hybrid bodies on four logical shards of the card folded
    2 x 2 against the CPU fold: group masks equal and values at float32
    tolerance, the HLL estimate equal, t-digest quantiles within 1e-3 of
    the range; the hybrid combine launched once."""
    from opentsdb_tpu_torch.ops import mesh_combine as mc
    from opentsdb_tpu_torch.parallel import multihost as mh
    rng = np.random.default_rng(8)
    ts = rng.integers(0, 7200, (4, 5000)).astype(np.int32)
    vals = rng.normal(50, 10, (4, 5000)).astype(np.float32)
    sid = rng.integers(0, 8, (4, 5000)).astype(np.int32)
    valid = rng.random((4, 5000)) < 0.9
    on = mh.make_hybrid_mesh(2, 2, devices=[card] * 4)
    off = mh.make_hybrid_mesh(2, 2, devices=["cpu"] * 4)
    kw = dict(series_per_shard=8, num_buckets=32, interval=300,
              agg_down="avg", agg_group="dev")
    before = mc.hybrid_moment_combine.launches
    gv, gm = mh.hybrid_downsample_group(ts, vals, sid, valid, mesh=on, **kw)
    assert mc.hybrid_moment_combine.launches == before + 1
    wv, wm = mh.hybrid_downsample_group(ts, vals, sid, valid, mesh=off,
                                        **kw)
    assert torch.equal(gm.cpu(), wm)
    np.testing.assert_allclose(gv.cpu().numpy(), wv.numpy(), rtol=1e-5,
                               atol=1e-4)
    assert float(mh.hybrid_hll_distinct(ts, valid, mesh=on)) == \
        float(mh.hybrid_hll_distinct(ts, valid, mesh=off))
    q = [0.1, 0.5, 0.99]
    a = mh.hybrid_tdigest(vals, valid, q, mesh=on).cpu().numpy()
    b = mh.hybrid_tdigest(vals, valid, q, mesh=off).numpy()
    assert np.abs(a - b).max() <= 1e-3 * (vals.max() - vals.min())
