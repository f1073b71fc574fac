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
