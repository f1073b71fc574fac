"""The port's percentile functions (opentsdb_tpu_torch/ops/kernels.py over
ops/masked_select.py, on CPU tensors: the plain versions) against the JAX
package's on the same inputs.

Tolerances:
- order keys and their inverse: bit-identical;
- masks and group masks: bit-identical;
- the selected rank values are bit-identical wherever the position is
  integral (q = 0, q = 1, and a single valid entry): both sides pick exact
  rank statistics;
- lerped quantiles within rtol 1e-6 (+1e-6 of the column scale): the lerp
  is one float32 multiply-add, which XLA may round in one step;
- quantiles of downsampled and filled grids: rtol 1e-5, as the moments,
  since the buckets they select from are float32 sums in another order.
"""

import numpy as np
import pytest
import torch

from opentsdb_tpu.ops import kernels as jk
from opentsdb_tpu_torch.ops import kernels as tk
from opentsdb_tpu_torch.ops import masked_select

QS = np.array([0.0, 0.5, 0.95, 0.99, 0.999, 1.0], np.float32)


def _t(x):
    return torch.from_numpy(np.array(x))


# ---------------------------------------------------------------------------
# Order keys
# ---------------------------------------------------------------------------

SPECIAL = np.array([0.0, -0.0, np.inf, -np.inf, 1e-45, -1e-45, 1e-40,
                    -1e-40, 1.1754944e-38, -1.1754944e-38, 3.4028235e38,
                    -3.4028235e38, 1.0, -1.0, 100.5, -7.25], np.float32)


@pytest.mark.parametrize("case", ["special", "random"])
def test_order_key_round_trip(case):
    if case == "special":
        vals = SPECIAL
    else:
        rng = np.random.default_rng(0)
        vals = rng.integers(0, 2**32, 4096, dtype=np.uint64) \
            .astype(np.uint32).view(np.float32)
        vals = vals[~np.isnan(vals)]
    want = np.asarray(jk._order_key(vals)).astype(np.int64)
    got = tk._order_key(_t(vals))
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), want)
    back = tk._key_to_float(got).numpy()
    assert back.dtype == np.float32
    np.testing.assert_array_equal(back.view(np.uint32), vals.view(np.uint32))
    np.testing.assert_array_equal(
        np.asarray(jk._key_to_float(want.astype(np.uint32))).view(np.uint32),
        back.view(np.uint32))


def test_order_key_is_monotone():
    keys = tk._order_key(_t(SPECIAL)).numpy()
    vals = SPECIAL[np.argsort(keys)]
    assert (np.diff(vals.astype(np.float64)) >= 0).all()
    # -0.0 sorts below +0.0.
    z = tk._order_key(_t(np.array([-0.0, 0.0], np.float32))).numpy()
    assert z[0] < z[1]


# ---------------------------------------------------------------------------
# masked_quantile_axis0 / masked_quantile_groups
# ---------------------------------------------------------------------------

def _grid(case, seed=0, S=48, B=40):
    rng = np.random.default_rng(seed)
    vals = rng.normal(0, 50, (S, B)).astype(np.float32)
    mask = rng.random((S, B)) > 0.35
    if case == "ties":
        vals = np.round(vals / 40).astype(np.float32)
    elif case == "signed":
        pick = rng.integers(0, 6, (S, B))
        vals = np.choose(pick, [vals, np.float32(0.0), np.float32(-0.0),
                                np.float32(np.inf), np.float32(-np.inf),
                                -np.abs(vals)]).astype(np.float32)
    elif case == "negative":
        vals = -np.abs(vals) - 1
    mask[:, 0] = False              # an all-masked column: 0
    mask[:, 1] = False
    mask[min(5, S - 1), 1] = True   # one valid entry
    return vals, mask


def _assert_quantiles(got, want, n):
    """``n`` [.., B] valid counts broadcast against [K, .., B]."""
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype
    n = np.broadcast_to(n, got.shape[1:])
    for k, q in enumerate(QS[:got.shape[0]]):
        exact = (n <= 1) | (q in (0.0, 1.0))
        np.testing.assert_array_equal(got[k][exact], want[k][exact])
        fin = np.isfinite(want[k]) & ~exact
        scale = np.abs(want[k][fin]).max() if fin.any() else 1.0
        np.testing.assert_allclose(got[k][fin], want[k][fin], rtol=1e-6,
                                   atol=1e-6 * scale)
        # Non-finite lerps (an infinite neighbour) agree where both are.
        inf = ~np.isfinite(want[k]) & ~exact
        np.testing.assert_array_equal(np.isnan(got[k][inf]),
                                      np.isnan(want[k][inf]))


@pytest.mark.parametrize("case", ["normal", "ties", "signed", "negative"])
def test_masked_quantile_axis0(case):
    vals, mask = _grid(case)
    want = jk.masked_quantile_axis0(vals, mask, QS)
    got = tk.masked_quantile_axis0(_t(vals), _t(mask), QS)
    _assert_quantiles(got.numpy(), want, mask.sum(0))
    assert (got[:, 0] == 0).all()


@pytest.mark.parametrize("S", [1, 2, 33])
def test_masked_quantile_axis0_few_rows(S):
    vals, mask = _grid("ties", seed=S, S=S, B=37)
    mask[:, 2] = True
    want = jk.masked_quantile_axis0(vals, mask, QS)
    got = tk.masked_quantile_axis0(_t(vals), _t(mask), QS)
    _assert_quantiles(got.numpy(), want, mask.sum(0))


def _gmap(layout, S, G, seed=0):
    """Group maps as the executor builds them: padded rows at the end all
    in group G-1; 'sizes' gives groups of 0, 1 and many rows."""
    rng = np.random.default_rng(seed)
    if layout == "sizes":
        gmap = np.concatenate([np.full(20, 2), [4], np.full(11, 5),
                               np.full(S - 32, G - 1)])
        return rng.permutation(gmap).astype(np.int32)
    if layout == "one_each":    # {host=*}: one series per group
        gmap = np.full(S, G - 1)
        gmap[:S - 8] = np.arange(S - 8)
        return gmap.astype(np.int32)
    gmap = np.full(S, G - 1)
    gmap[:S - 10] = rng.integers(0, max(G - 1, 1), S - 10)
    return gmap.astype(np.int32)


@pytest.mark.parametrize("layout,G", [("sizes", 8), ("one_each", 64),
                                      ("random", 6), ("random", 1)])
@pytest.mark.parametrize("case", ["normal", "ties", "signed"])
def test_masked_quantile_groups(case, layout, G):
    vals, mask = _grid(case, seed=G)
    S = vals.shape[0]
    if layout == "one_each":
        G = S - 8 + 1
    gmap = _gmap(layout, S, G)
    want = jk.masked_quantile_groups(vals, mask, gmap, QS, num_groups=G)
    got = tk.masked_quantile_groups(_t(vals), _t(mask), _t(gmap), QS,
                                    num_groups=G)
    n = np.zeros((G, vals.shape[1]), np.int64)
    np.add.at(n, gmap, mask)
    _assert_quantiles(got.numpy(), want, n)
    # A precomputed layout gives the same answer.
    lay = masked_select.group_layout(gmap, G)
    again = tk.masked_quantile_groups(_t(vals), _t(mask), None, QS,
                                      num_groups=G, layout=lay)
    np.testing.assert_array_equal(again.numpy(), got.numpy())


def test_group_layout():
    gmap = np.array([3, 0, 3, 1, 3, 0], np.int32)
    lay = masked_select.group_layout(gmap, 5)
    np.testing.assert_array_equal(lay.order.numpy(), [1, 5, 3, 0, 2, 4])
    np.testing.assert_array_equal(lay.offsets.numpy(), [0, 2, 3, 3, 6, 6])
    assert lay.big.numel() == 0
    big = masked_select.group_layout(
        np.repeat(np.arange(3), [1, masked_select.SMALL_ROWS,
                                 masked_select.SMALL_ROWS + 1])
        .astype(np.int32), 3)
    np.testing.assert_array_equal(big.big.numpy(), [2])
    with pytest.raises(ValueError):
        masked_select.group_layout(np.array([0, 3], np.int32), 3)


# ---------------------------------------------------------------------------
# downsample_multigroup_quantile and window_quantile_apply
# ---------------------------------------------------------------------------

N, S_PAD, B, G, INTERVAL = 1500, 16, 32, 4, 60
RATES = {"none": dict(rate=False), "rate": dict(rate=True),
         "counter": dict(rate=True, counter=True, counter_max=100.0,
                         drop_resets=True, reset_value=0.5)}


def _points(seed=0):
    rng = np.random.default_rng(seed)
    ts = rng.integers(0, B * INTERVAL, N).astype(np.int32)
    vals = rng.normal(10, 3, N).astype(np.float32)
    sid = rng.integers(0, 12, N).astype(np.int32)
    valid = rng.random(N) > 0.1
    gmap = np.concatenate([rng.integers(0, G, 12),
                           np.full(S_PAD - 12, G - 1)]).astype(np.int32)
    return ts, vals, sid, valid, gmap


@pytest.mark.parametrize("mode", sorted(RATES))
@pytest.mark.parametrize("agg_down", ["avg", "max", "sum"])
def test_downsample_multigroup_quantile(agg_down, mode):
    ts, vals, sid, valid, gmap = _points()
    q = np.array([0.95], np.float32)
    kw = dict(num_series=S_PAD, num_groups=G, num_buckets=B,
              interval=INTERVAL, agg_down=agg_down, **RATES[mode])
    want = jk.downsample_multigroup_quantile(ts, vals, sid, valid, gmap, q,
                                             **kw)
    got = tk.downsample_multigroup_quantile(
        *(_t(x) for x in (ts, vals, sid, valid, gmap)), q, **kw)
    assert set(got) == set(want)
    for key in ("group_mask", "series_mask"):
        np.testing.assert_array_equal(got[key].numpy(),
                                      np.asarray(want[key]))
    for key in ("group_values", "series_values"):
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]),
                                   rtol=1e-5, atol=1e-5, err_msg=key)


@pytest.mark.parametrize("mode", ["none", "rate"])
@pytest.mark.parametrize("groups", [1, G])
def test_window_quantile_apply(groups, mode):
    """The window's percentile apply over stage grids (rates step-fill,
    values lerp-fill), with include masking and the fetch shrink-wrap."""
    rng = np.random.default_rng(7)
    values = rng.normal(5, 2, (S_PAD, 64)).astype(np.float32)
    smask = rng.random((S_PAD, 64)) > 0.5
    smask[-4:] = False              # padded series
    if mode == "rate":
        values, smask = jk.bucket_rate(values, smask, INTERVAL)
        filled, in_range = jk.step_fill(values, smask, 64)
    else:
        filled, in_range = jk.gap_fill(values, smask, 64)
    smask, filled, in_range = (np.asarray(x) for x in (smask, filled,
                                                        in_range))
    include = np.arange(S_PAD) % 5 != 2
    gmap = (np.arange(S_PAD) % groups).astype(np.int32)
    q = np.array([0.5], np.float32)
    for shrink in ({}, dict(g_out=groups, b_out=40)):
        want = jk.window_quantile_apply(smask, filled, in_range, include,
                                        gmap, q, num_groups=groups,
                                        **shrink)
        got = tk.window_quantile_apply(
            *(_t(x) for x in (smask, filled, in_range, include, gmap)), q,
            num_groups=groups, **shrink)
        np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
        np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]),
                                   rtol=1e-6, atol=1e-6)
