"""The rollup window fold on the CPU: ``ops/rollup_fold.window_fold_plain``
and ``rollup/summary.window_summaries_device(..., device="cpu")`` against
the JAX package's host fold ``window_summaries`` on the same seeded
series (count, min, max, first, last and the brackets exact, the sum
within rtol 1e-12), and against the JAX package's own device fold within
its declared float32 tolerance (rtol 1e-5; in this sandbox its jax has no
``enable_x64``, so it folds in float32). The kernel itself runs only on
the card (``tests/test_torch_cuda.py``)."""

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
