"""Port downsample core (opentsdb_tpu_torch/ops/kernels.py) against the
JAX package's jitted kernels on the same inputs.

Contract (the executor's, opentsdb_tpu/query/executor.py:16-18): masks,
grids and member timestamps bit-identical; count, min and max exact
where nothing but order-free operations produced them; float32 sums,
means, deviations, rates and lerped values within rtol 1e-5, because the
port's segment sums add in another order than XLA's (and on the card in
a run-dependent one).
"""

import numpy as np
import pytest
import torch

from opentsdb_tpu.ops import kernels as jk
from opentsdb_tpu_torch.ops import kernels as tk

AGGS = ("sum", "min", "max", "avg", "dev", "count", "zimsum", "mimmin",
        "mimmax")
ORDER_FREE = ("min", "max", "count", "mimmin", "mimmax")
RATE_MODES = {
    "none": dict(rate=False),
    "rate": dict(rate=True),
    # Counter rollover and reset dropping: values are unsorted normals,
    # so negative deltas (wrapped by counter_max) and big rates
    # (dropped above reset_value) both occur.
    "counter": dict(rate=True, counter=True, counter_max=100.0,
                    drop_resets=True, reset_value=0.5),
}

N, S, B, G, INTERVAL = 1500, 12, 32, 4, 60


def _inputs(seed=0):
    rng = np.random.default_rng(seed)
    ts = rng.integers(0, B * INTERVAL, N).astype(np.int32)
    vals = rng.normal(10, 3, N).astype(np.float32)
    # Padded series ids 12..15 carry no points, like the executor's pow2
    # padding; every 10th point is padding (valid False).
    sid = rng.integers(0, S, N).astype(np.int32)
    valid = rng.random(N) > 0.1
    gmap = np.concatenate([rng.integers(0, G, S),
                           np.full(16 - S, G - 1)]).astype(np.int32)
    return ts, vals, sid, valid, gmap


def _compare(jax_out, torch_out, exact_keys):
    assert set(jax_out) == set(torch_out)
    for key in jax_out:
        want = np.asarray(jax_out[key])
        got = torch_out[key].numpy()
        assert got.dtype == want.dtype and got.shape == want.shape, key
        if want.dtype != np.float32 or key in exact_keys:
            np.testing.assert_array_equal(got, want, err_msg=key)
        else:
            np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5,
                                       err_msg=key)


def _exact_keys(agg_down, agg_group, rate):
    """Value outputs the contract holds exact: order-free series stages
    without rate, and order-free group stages fed only by them with no
    lerp (the lerp and rate arithmetic may round differently)."""
    if rate or agg_down not in ORDER_FREE:
        return set()
    keys = {"series_values"}
    if agg_group in ("count", "mimmin", "mimmax"):
        keys.add("group_values")
    return keys


@pytest.mark.parametrize("mode", sorted(RATE_MODES))
@pytest.mark.parametrize("agg_group", AGGS)
@pytest.mark.parametrize("agg_down", AGGS)
def test_downsample_group_and_multigroup(agg_down, agg_group, mode):
    ts, vals, sid, valid, gmap = _inputs()
    kw = dict(num_series=16, num_buckets=B, interval=INTERVAL,
              agg_down=agg_down, agg_group=agg_group, **RATE_MODES[mode])
    exact = _exact_keys(agg_down, agg_group, kw["rate"])
    t_in = [torch.from_numpy(x) for x in (ts, vals, sid, valid)]
    _compare(jk.downsample_group(ts, vals, sid, valid, **kw),
             tk.downsample_group(*t_in, **kw), exact)
    _compare(jk.downsample_multigroup(ts, vals, sid, valid, gmap,
                                      num_groups=G, **kw),
             tk.downsample_multigroup(*t_in, torch.from_numpy(gmap),
                                      num_groups=G, **kw), exact)


def _grid(seed):
    rng = np.random.default_rng(seed)
    values = rng.normal(5, 2, (9, 24)).astype(np.float32)
    mask = rng.random((9, 24)) > 0.6
    mask[0] = False          # an all-empty series
    mask[1] = False
    mask[1, 7] = True        # a single-bucket series
    return values, mask


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_gap_fill(seed):
    values, mask = _grid(seed)
    want_f, want_r = jk.gap_fill(values, mask, 24)
    got_f, got_r = tk.gap_fill(torch.from_numpy(values),
                               torch.from_numpy(mask), 24)
    np.testing.assert_array_equal(got_r.numpy(), np.asarray(want_r))
    np.testing.assert_allclose(got_f.numpy(), np.asarray(want_f),
                               rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_step_fill(seed):
    values, mask = _grid(seed)
    want_f, want_r = jk.step_fill(values, mask, 24)
    got_f, got_r = tk.step_fill(torch.from_numpy(values),
                                torch.from_numpy(mask), 24)
    # A step hold copies values: exact.
    np.testing.assert_array_equal(got_r.numpy(), np.asarray(want_r))
    np.testing.assert_array_equal(got_f.numpy(), np.asarray(want_f))


@pytest.mark.parametrize("mode", sorted(RATE_MODES))
def test_bucket_rate(mode):
    values, mask = _grid(3)
    kw = {k: v for k, v in RATE_MODES[mode].items() if k != "rate"}
    cm, rv = kw.pop("counter_max", 0.0), kw.pop("reset_value", 0.0)
    want_r, want_ok = jk.bucket_rate(values, mask, INTERVAL, cm, rv, **kw)
    got_r, got_ok = tk.bucket_rate(torch.from_numpy(values),
                                   torch.from_numpy(mask), INTERVAL, cm, rv,
                                   **kw)
    np.testing.assert_array_equal(got_ok.numpy(), np.asarray(want_ok))
    np.testing.assert_allclose(got_r.numpy(), np.asarray(want_r),
                               rtol=1e-5, atol=1e-6)
