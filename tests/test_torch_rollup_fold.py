"""The rollup window fold on the CPU: ``ops/rollup_fold.window_fold_plain``
and ``rollup/summary.window_summaries_device(..., device="cpu")`` against
the JAX package's host fold ``window_summaries`` on the same seeded
series (count, min, max, first, last and the brackets exact, the sum
within rtol 1e-12), and against the JAX package's own device fold within
its declared float32 tolerance (rtol 1e-5; in this sandbox its jax has no
``enable_x64``, so it folds in float32). The tier's group fold
(``window_fold_batch_plain`` behind ``summary.group_summaries_device``):
seeded groups of 1-50 series with empty, one-point and many-point
windows and NaN values, at resolutions (3600, 86400) and (3600, 21600,
86400), against the port's and the JAX package's host folds, against a
numpy loop of the kernel's order of addition (bit for bit), and against
the one-series entry (byte for byte). The kernel itself runs only on the
card (``tests/test_torch_cuda.py``)."""

import numpy as np
import pytest
import torch

from opentsdb_tpu.rollup import summary as jax_summary
from opentsdb_tpu_torch.ops import rollup_fold
from opentsdb_tpu_torch.rollup import summary

BASE = 1356998400


def _series(case: str, res: int):
    rng = np.random.default_rng(CASES.index(case) * 10 + res % 7)
    if case == "one point":
        return np.array([BASE + 17]), np.array([3.25])
    if case == "one window":
        ts = BASE + np.sort(rng.choice(res, 40, replace=False))
        return ts, rng.normal(50, 10, 40)
    if case == "empty interior windows":
        ts = np.concatenate([BASE + np.arange(0, 600, 60),
                             BASE + 5 * res + np.arange(0, 900, 90),
                             BASE + 23 * res + np.arange(0, 300, 30)])
        return ts, rng.normal(50, 10, len(ts))
    if case == "special values":
        ts = BASE + np.arange(0, 6 * 3600, 300)
        v = rng.normal(50, 10, len(ts))
        v[[2, 20, 41, 55]] = [np.inf, -np.inf, np.inf, -np.inf]
        return ts, v
    if case == "nan":
        ts = BASE + np.arange(0, 6 * 3600, 300)
        v = rng.normal(50, 10, len(ts))
        v[[3, 30]] = np.nan
        return ts, v
    if case == "week of the smoke's series":
        step = 7 * 86400 // 1000
        ts = np.unique(BASE + np.minimum(
            np.arange(1000) * step + rng.integers(0, step // 2, 1000),
            7 * 86400 - 1))
        return ts, 100 + np.cumsum(rng.normal(0, 1, len(ts)))
    if case == "dense":
        ts = BASE + 7 + np.arange(0, 3 * 86400, 10)
        return ts, 1000 + np.cumsum(rng.normal(0, 0.1, len(ts)))
    raise AssertionError(case)


CASES = ("one point", "one window", "empty interior windows",
         "special values", "nan", "week of the smoke's series", "dense")
RES = (3600, 7200, 86400)


def _assert_records(wb, rec, wb_want, rec_want, sum_rtol):
    assert np.array_equal(wb, wb_want)
    for f in ("count", "min", "max", "first", "last", "first_dt",
              "last_dt"):
        np.testing.assert_array_equal(rec[f], rec_want[f], err_msg=f)
    np.testing.assert_allclose(rec["sum"], rec_want["sum"], rtol=sum_rtol,
                               atol=0)


@pytest.mark.parametrize("res", RES)
@pytest.mark.parametrize("case", CASES)
def test_device_summaries_match_the_jax_host_fold(case, res):
    ts, vals = _series(case, res)
    wb, rec = summary.window_summaries_device(ts, vals, res, device="cpu")
    _assert_records(wb, rec, *jax_summary.window_summaries(ts, vals, res),
                    1e-12)
    assert rec.dtype == jax_summary.REC_DTYPE


@pytest.mark.parametrize("res", RES)
@pytest.mark.parametrize("case", CASES)
def test_plain_fold_columns(case, res):
    """window_fold_plain's eight per-window tensors: every window of the
    dense grid, empty ones with count 0, the rest the host fold's."""
    ts, vals = _series(case, res)
    origin = int(ts[0]) - int(ts[0]) % res
    W = (int(ts[-1]) - origin) // res + 1
    out = rollup_fold.window_fold_plain(
        torch.from_numpy((ts - origin).astype(np.int32)),
        torch.from_numpy(vals.astype(np.float64)), num_windows=W, res=res)
    assert [t.shape for t in out] == [(W,)] * 8
    assert [t.dtype for t in out] == [torch.int32] + [torch.float64] * 5 \
        + [torch.int32] * 2
    count, total, mn, mx, first, last, t_first, t_last = (
        t.numpy() for t in out)
    wb, rec = jax_summary.window_summaries(ts, vals, res)
    idx = (wb - origin) // res
    assert np.array_equal(np.flatnonzero(count), idx)
    assert np.array_equal(count[idx], rec["count"])
    np.testing.assert_allclose(total[idx], rec["sum"], rtol=1e-12, atol=0)
    for got, f in ((mn, "min"), (mx, "max"), (first, "first"),
                   (last, "last")):
        np.testing.assert_array_equal(got[idx], rec[f])
    assert np.array_equal(t_first[idx] + origin - wb, rec["first_dt"])
    assert np.array_equal(t_last[idx] + origin - wb, rec["last_dt"])
    empty = count == 0
    assert (total[empty] == 0).all() and np.isposinf(mn[empty]).all() \
        and np.isneginf(mx[empty]).all()


def test_window_fold_on_cpu_tensors_is_the_plain_version():
    ts, vals = _series("week of the smoke's series", 3600)
    rel = torch.from_numpy((ts - BASE).astype(np.int32))
    v = torch.from_numpy(vals)
    W = int(rel[-1]) // 3600 + 1
    before = rollup_fold.window_fold.launches
    a = rollup_fold.window_fold(rel, v, num_windows=W, res=3600)
    b = rollup_fold.window_fold_plain(rel, v, num_windows=W, res=3600)
    assert rollup_fold.window_fold.launches == before   # no kernel here
    assert all(torch.equal(x, y) for x, y in zip(a, b))


def test_span_past_int32_takes_the_host_fold(monkeypatch):
    """A span the int32 rebase cannot carry (or more than 2^22 windows)
    folds on the host: bit-identical records, the kernel's wrapper never
    called."""
    ts = np.array([0, 100, 2**31 + 5, 2**32 - 10], np.int64)
    vals = np.array([1.0, 2.0, 3.0, 4.0])

    def boom(*a, **k):
        raise AssertionError("the wrapper ran")

    monkeypatch.setattr(rollup_fold, "window_fold", boom)
    wb, rec = summary.window_summaries_device(ts, vals, 3600, device="cpu")
    wb2, rec2 = jax_summary.window_summaries(ts, vals, 3600)
    assert np.array_equal(wb, wb2) and rec.tobytes() == rec2.tobytes()
    many = np.array([0, (1 << 22) * 60], np.int64)
    wb, rec = summary.window_summaries_device(many, vals[:2], 60,
                                              device="cpu")
    assert rec.tobytes() == jax_summary.window_summaries(
        many, vals[:2], 60)[1].tobytes()


def test_unsorted_input_raises():
    with pytest.raises(ValueError, match="sorted"):
        summary.window_summaries_device(np.array([BASE + 100, BASE + 50]),
                                        np.ones(2), 3600, device="cpu")
    with pytest.raises(ValueError, match="sorted"):
        rollup_fold.window_fold_plain(
            torch.tensor([0, 9, 4], dtype=torch.int32),
            torch.ones(3, dtype=torch.float64), num_windows=1, res=3600)
    with pytest.raises(ValueError):
        rollup_fold.window_fold_plain(
            torch.tensor([0, 4], dtype=torch.int64),
            torch.ones(2, dtype=torch.float64), num_windows=1, res=3600)


def test_empty_series():
    wb, rec = summary.window_summaries_device(
        np.empty(0, np.int64), np.empty(0), 3600, device="cpu")
    assert len(wb) == len(rec) == 0 and rec.dtype == summary.REC_DTYPE


@pytest.mark.parametrize("case", ["one window", "empty interior windows",
                                  "week of the smoke's series", "dense"])
def test_against_the_jax_device_fold_within_its_declared_tolerance(case):
    """The JAX package's device fold declares its kind by what its jax
    computes: in float32 here (no enable_x64), so the records agree with
    the port's float64 fold within float32 tolerance, counts and
    brackets exactly."""
    ts, vals = _series(case, 3600)
    want_wb, want = jax_summary.window_summaries_device(ts, vals, 3600)
    wb, rec = summary.window_summaries_device(ts, vals, 3600, device="cpu")
    assert np.array_equal(wb, want_wb)
    for f in ("count", "first_dt", "last_dt"):
        assert np.array_equal(rec[f], want[f]), f
    for f in ("sum", "min", "max", "first", "last"):
        np.testing.assert_allclose(rec[f], want[f], rtol=1e-5, err_msg=f)
    assert summary.device_fold_kind() == "device-f64"


# ---------------------------------------------------------------------------
# The group fold: every series of a coarse window at every resolution
# ---------------------------------------------------------------------------

GROUP_RES = ((3600, 86400), (3600, 21600, 86400))
GROUP_SERIES = (1, 7, 50)


def _group(S: int, seed: int, nan: bool):
    """(ts int64, vals float64, bounds [S + 1]) of S series of one day:
    some series empty, some one point, some a few points an hour, some
    hundreds (windows of 0, 1 and many points), values over six decades,
    NaN in some series when ``nan``."""
    rng = np.random.default_rng(seed)
    ts, vs, bounds = [], [], [0]
    for j in range(S):
        n = (0, 1, int(rng.integers(2, 40)),
             int(rng.integers(40, 600)))[j % 4 if S > 1 else 3]
        t = BASE + np.sort(rng.choice(86400, n, replace=False))
        v = rng.normal(50, 10, n) * 10.0 ** int(rng.integers(-3, 4))
        if nan and n > 3 and j % 3 == 0:
            v[rng.integers(0, n, 2)] = np.nan
        ts.append(t)
        vs.append(v)
        bounds.append(bounds[-1] + n)
    return (np.concatenate(ts).astype(np.int64), np.concatenate(vs),
            np.asarray(bounds, np.int64))


def _butterfly_sums(vals: np.ndarray) -> np.float64:
    """The kernel's sum of one window's values: lane l adds values l,
    l + 32, ... in order from 0.0; then the xor butterfly over 32
    lanes."""
    lanes = np.zeros(32)
    for i, v in enumerate(vals):
        lanes[i % 32] = lanes[i % 32] + v
    for off in (16, 8, 4, 2, 1):
        lanes = lanes + lanes[np.arange(32) ^ off]
    return lanes[0]


def _same_bits(a: np.ndarray, b: np.ndarray) -> bool:
    """Bit for bit, NaN positions equal (a NaN's payload is the
    platform's)."""
    na, nb = np.isnan(a), np.isnan(b)
    return bool(np.array_equal(na, nb) and np.array_equal(
        a[~na].view(np.int64), b[~nb].view(np.int64)))


@pytest.mark.parametrize("nan", [False, True], ids=["finite", "nan"])
@pytest.mark.parametrize("S", GROUP_SERIES)
@pytest.mark.parametrize("res", GROUP_RES, ids=["1h,1d", "1h,6h,1d"])
def test_group_fold_matches_the_host_folds(res, S, nan):
    """Each series' records of the group fold against the port's host
    fold and the JAX package's: count, min, max, first, last and the
    brackets exact (NaN where numpy gives NaN), the sum within rtol
    1e-12."""
    ts, vals, bounds = _group(S, S * 7 + len(res), nan)
    out = summary.group_summaries_device(ts, vals, bounds, BASE, 86400,
                                         res, device="cpu")
    assert len(out) == len(res)
    for (wb_all, rec_all, st), r in zip(out, res):
        assert len(st) == S + 1 and st[-1] == len(rec_all)
        for j in range(S):
            a, b = bounds[j], bounds[j + 1]
            wb, rec = wb_all[st[j]:st[j + 1]], rec_all[st[j]:st[j + 1]]
            for host in (summary.window_summaries,
                         jax_summary.window_summaries):
                wb_want, want = host(ts[a:b], vals[a:b], r)
                assert np.array_equal(wb, wb_want)
                for f in ("count", "first_dt", "last_dt"):
                    assert np.array_equal(rec[f], want[f]), f
                for f in ("min", "max", "first", "last"):
                    np.testing.assert_array_equal(rec[f], want[f],
                                                  err_msg=f)
                np.testing.assert_allclose(rec["sum"], want["sum"],
                                           rtol=1e-12, atol=0)


@pytest.mark.parametrize("S", GROUP_SERIES)
@pytest.mark.parametrize("res", GROUP_RES, ids=["1h,1d", "1h,6h,1d"])
def test_group_fold_sums_follow_the_kernels_order(res, S):
    """Every window's sum equals, bit for bit, a numpy loop of the
    kernel's order: lane-strided sums, then the xor butterfly."""
    ts, vals, bounds = _group(S, S * 11 + len(res), True)
    out = summary.group_summaries_device(ts, vals, bounds, BASE, 86400,
                                         res, device="cpu")
    for (wb_all, rec_all, st), r in zip(out, res):
        for j in range(S):
            a, b = bounds[j], bounds[j + 1]
            t, v = ts[a:b], vals[a:b]
            want = np.array([_butterfly_sums(v[(t - t % r) == w])
                             for w in wb_all[st[j]:st[j + 1]]])
            assert _same_bits(rec_all["sum"][st[j]:st[j + 1]], want)


@pytest.mark.parametrize("S", GROUP_SERIES)
@pytest.mark.parametrize("res", GROUP_RES, ids=["1h,1d", "1h,6h,1d"])
def test_group_fold_equals_the_one_series_entry(res, S):
    """The group fold's records are the one-series entry's
    (window_summaries_device), byte for byte: the same windows in the
    same order of addition."""
    ts, vals, bounds = _group(S, S * 13 + len(res), True)
    out = summary.group_summaries_device(ts, vals, bounds, BASE, 86400,
                                         res, device="cpu")
    for (wb_all, rec_all, st), r in zip(out, res):
        for j in range(S):
            a, b = bounds[j], bounds[j + 1]
            wb, rec = summary.window_summaries_device(ts[a:b], vals[a:b],
                                                      r, device="cpu")
            assert np.array_equal(wb_all[st[j]:st[j + 1]], wb)
            assert rec_all[st[j]:st[j + 1]].tobytes() == rec.tobytes()


def test_batch_plain_grid_and_one_segment_case():
    """window_fold_batch_plain's dense slot grid (resolution-major, then
    series, then window; empty slots count 0, min +inf, max -inf) and
    window_fold as its one-series, one-resolution case."""
    ts, vals, bounds = _group(6, 3, False)
    rel = torch.from_numpy((ts - BASE).astype(np.int32))
    v = torch.from_numpy(vals)
    offs = torch.from_numpy(bounds)
    icol, fcol = rollup_fold.window_fold_batch_plain(
        rel, v, offs, res=(3600, 86400), num_windows=(24, 1))
    assert icol.shape == (3, 6 * 25) and fcol.shape == (5, 6 * 25)
    assert rollup_fold.grid_slots(6, (24, 1)) == [0, 144, 150]
    count = icol[0].numpy()
    for j in range(6):
        a, b = bounds[j], bounds[j + 1]
        hours = np.bincount((ts[a:b] - BASE) // 3600, minlength=24)
        assert np.array_equal(count[j * 24:(j + 1) * 24], hours)
        assert count[144 + j] == b - a
        one = rollup_fold.window_fold_plain(rel[a:b], v[a:b],
                                            num_windows=24, res=3600)
        for k, x in enumerate((icol[0], fcol[0], fcol[1], fcol[2],
                               fcol[3], fcol[4], icol[1], icol[2])):
            assert torch.equal(x[j * 24:(j + 1) * 24], one[k]), k
    empty = icol[0] == 0
    assert (fcol[0][empty] == 0).all() and torch.isposinf(
        fcol[1][empty]).all() and torch.isneginf(fcol[2][empty]).all()
    host_i, host_f = rollup_fold.read_back(icol, fcol)
    assert np.array_equal(host_i, icol.numpy())
    assert host_f.tobytes() == fcol.numpy().tobytes()


def test_group_fold_refuses_what_it_does_not_take():
    """Unsorted series raise after the read-back; a point outside the
    group's window, a span a resolution does not divide, a span past
    int32 or too many windows raise before any fold; bad arguments to
    the batch entry raise."""
    ts, vals, bounds = _group(5, 17, False)
    bad = ts.copy()
    a = bounds[3]
    bad[a], bad[a + 1] = bad[a + 1], bad[a]
    with pytest.raises(ValueError, match="sorted"):
        summary.group_summaries_device(bad, vals, bounds, BASE, 86400,
                                       (3600, 86400), device="cpu")
    with pytest.raises(ValueError, match="outside"):
        summary.group_summaries_device(ts, vals, bounds, BASE + 3600,
                                       86400, (3600, 86400), device="cpu")
    with pytest.raises(ValueError, match="divides"):
        summary.group_summaries_device(ts, vals, bounds, BASE, 86400,
                                       (3600, 7000), device="cpu")
    with pytest.raises(ValueError, match="divides"):
        summary.group_summaries_device(ts, vals, bounds, BASE, 2**31,
                                       (3600,), device="cpu")
    with pytest.raises(ValueError, match="divides"):
        summary.group_summaries_device(ts, vals, bounds, BASE,
                                       (1 << 22) * 2 * 60, (60,),
                                       device="cpu")
    rel = torch.zeros(3, dtype=torch.int32)
    v = torch.ones(3, dtype=torch.float64)
    offs = torch.tensor([0, 3])
    with pytest.raises(ValueError, match="resolutions"):
        rollup_fold.window_fold_batch_plain(
            rel, v, offs, res=tuple(range(3600, 3600 * 10, 3600)),
            num_windows=(1,) * 9)
    with pytest.raises(ValueError, match="offsets"):
        rollup_fold.window_fold_batch_plain(
            rel, v, offs.int(), res=(3600,), num_windows=(1,))
    with pytest.raises(ValueError, match="offsets"):
        rollup_fold.window_fold_batch_plain(
            rel, v, torch.tensor([0, 2]), res=(3600,), num_windows=(1,))


def test_empty_group():
    out = summary.group_summaries_device(
        np.empty(0, np.int64), np.empty(0), np.zeros(3, np.int64), BASE,
        86400, (3600, 86400), device="cpu")
    for wb, rec, st in out:
        assert len(wb) == len(rec) == 0 and list(st) == [0, 0, 0]
