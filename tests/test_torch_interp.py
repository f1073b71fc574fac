"""The port's un-downsampled functions (opentsdb_tpu_torch/ops/kernels.py
``flat_rate``, ``union_grid``, ``series_contributions``,
``group_interpolate`` over ops/interp_moments.py, on CPU tensors: the plain
versions) against the JAX package's on the same inputs.

Tolerances:
- grids, masks and counts: bit-identical;
- contributions at exact samples and step holds (copies), and min/max
  over them ('step', 'none'): bit-identical;
- lerped contributions, and min/max over them: rtol 1e-6, since XLA may
  round the float32 multiply-add in one step;
- sum/avg/dev: rtol 1e-5 (the summation order differs);
- rates: rtol 1e-6 (one float32 subtract and divide each side).
``group_interpolate``'s ``out`` is compared where ``gmask`` is set: the
padded grid entries carry no answer.
"""

import numpy as np
import pytest
import torch

from opentsdb_tpu.ops import kernels as jk
from opentsdb_tpu_torch.ops import interp_moments as im
from opentsdb_tpu_torch.ops import kernels as tk

AGGS = ("sum", "avg", "dev", "min", "max", "count", "zimsum", "mimmin",
        "mimmax")


def _t(x):
    return torch.from_numpy(np.array(x))


def _rows(case, seed=0, S=7, T=16):
    """[S, T] left-aligned padded rows: sorted timestamps that collide
    across series; 'dups' repeats timestamps inside rows; one series
    has a single point."""
    rng = np.random.default_rng(seed)
    ts = np.sort(rng.integers(0, 120, (S, T)), axis=1).astype(np.int32)
    if case != "dups":
        ts = np.sort(np.stack([rng.choice(120, T, replace=False)
                               for _ in range(S)]), axis=1).astype(np.int32)
    counts = rng.integers(2, T + 1, S).astype(np.int32)
    counts[1] = 1
    vals = rng.normal(10, 4, (S, T)).astype(np.float32)
    idx = np.arange(T)[None, :]
    ts = np.where(idx < counts[:, None], ts, 0).astype(np.int32)
    return ts, vals, counts


@pytest.mark.parametrize("case", ["distinct", "dups"])
def test_union_grid(case):
    ts, _, counts = _rows(case)
    want = jk.union_grid(ts, counts)
    got = tk.union_grid(_t(ts), _t(counts))
    for g, w in zip(got, want):
        assert g.numpy().dtype == np.asarray(w).dtype
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("interp", ["lerp", "step", "none"])
@pytest.mark.parametrize("case", ["distinct", "dups"])
def test_series_contributions(case, interp):
    ts, vals, counts = _rows(case, seed=1)
    grid = np.arange(-5, 130, dtype=np.int32)   # outside every range too
    wc, wm = jk.series_contributions(ts, vals, counts, grid, interp=interp)
    gc, gm = tk.series_contributions(_t(ts), _t(vals), _t(counts),
                                     _t(grid), interp=interp)
    np.testing.assert_array_equal(gm.numpy(), np.asarray(wm))
    if interp == "lerp":
        np.testing.assert_allclose(gc.numpy(), np.asarray(wc), rtol=1e-6,
                                   atol=1e-6)
    else:
        np.testing.assert_array_equal(gc.numpy(), np.asarray(wc))


@pytest.mark.parametrize("interp", ["lerp", "step", "none"])
@pytest.mark.parametrize("agg", AGGS)
def test_group_interpolate(agg, interp):
    ts, vals, counts = _rows("dups", seed=2)
    wg, wo, wm = (np.asarray(x) for x in jk.group_interpolate(
        ts, vals, counts, agg=agg, interp=interp))
    gg, go, gm = tk.group_interpolate(_t(ts), _t(vals), _t(counts), agg=agg,
                                      interp=interp)
    np.testing.assert_array_equal(gg.numpy(), wg)
    np.testing.assert_array_equal(gm.numpy(), wm)
    got, want = go.numpy()[wm], wo[wm]
    assert got.dtype == want.dtype == np.float32
    base = {"zimsum": "sum", "mimmin": "min", "mimmax": "max"}.get(agg, agg)
    if base == "count" or (base in ("min", "max") and interp != "lerp"):
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-5 if base in (
            "sum", "avg", "dev") else 1e-6, atol=1e-5)


@pytest.mark.parametrize("interp", ["lerp", "step", "none"])
def test_interp_moments_plain_over_compacted_grid(interp):
    """interp_moments over the compacted grid equals the JAX reduction
    over the padded one at every real grid point."""
    ts, vals, counts = _rows("distinct", seed=3)
    grid, gmask = tk.union_grid(_t(ts), _t(counts))
    U = int(gmask.sum())
    cnt, tot, m2, mn, mx = im.interp_moments(
        _t(ts), _t(vals), _t(counts), grid[:U], interp=interp)
    wc, wm = jk.series_contributions(ts, vals, counts, grid[:U].numpy(),
                                     interp=interp)
    wc, wm = np.asarray(wc), np.asarray(wm)
    np.testing.assert_array_equal(cnt.numpy(), wm.sum(0).astype(np.float32))
    np.testing.assert_allclose(tot.numpy(), np.where(wm, wc, 0).sum(0),
                               rtol=1e-5, atol=1e-5)
    mean = np.where(wm, wc, 0).sum(0) / np.maximum(wm.sum(0), 1)
    np.testing.assert_allclose(
        m2.numpy(), (np.where(wm, wc - mean, 0) ** 2).sum(0), rtol=1e-4,
        atol=1e-4)
    np.testing.assert_allclose(mn.numpy(), np.where(wm, wc, np.inf).min(0),
                               rtol=1e-6)
    assert im.interp_moments(_t(ts), _t(vals), _t(counts), grid[:U],
                             interp=interp, with_m2=False)[2] is None
    with pytest.raises(ValueError):
        im.interp_moments(_t(ts), _t(vals), _t(counts), grid[:U],
                          interp="cubic")


RATE_CASES = {
    "plain": dict(),
    "counter": dict(counter=True, counter_max=1000.0),
    "drop": dict(drop_resets=True, reset_value=2.0),
    "both": dict(counter=True, counter_max=1000.0, drop_resets=True,
                 reset_value=50.0),
}


@pytest.mark.parametrize("case", sorted(RATE_CASES))
def test_flat_rate(case):
    """Counter wrap (negative deltas + counter_max) and reset dropping on
    a flat (sid, ts)-sorted stream with a few padding points."""
    rng = np.random.default_rng(4)
    n = 400
    sid = np.sort(rng.integers(0, 9, n)).astype(np.int32)
    ts = np.concatenate([np.sort(rng.choice(5000, (sid == s).sum(),
                                            replace=False))
                         for s in range(9)]).astype(np.int32)
    vals = (np.cumsum(rng.integers(0, 40, n)) % 1000).astype(np.float32)
    valid = rng.random(n) > 0.05
    kw = dict(RATE_CASES[case])
    cm, rv = kw.pop("counter_max", 0.0), kw.pop("reset_value", 0.0)
    wr, wo = jk.flat_rate(ts, vals, sid, valid, cm, rv, **kw)
    gr, go = tk.flat_rate(*(_t(x) for x in (ts, vals, sid, valid)), cm, rv,
                          **kw)
    np.testing.assert_array_equal(go.numpy(), np.asarray(wo))
    np.testing.assert_allclose(gr.numpy(), np.asarray(wr), rtol=1e-6,
                               atol=1e-7)
