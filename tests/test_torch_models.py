"""The port's smoothing models (``opentsdb_tpu_torch/models/smoothing.py``
over ``ops/smoothing.py``, device="cpu": the plain versions of the scan
kernels) against the JAX package's ``opentsdb_tpu/models/smoothing.py``
on the same seeded inputs.

Tolerance: rtol 1e-5 plus 1e-5 x the series' scale (its largest |value|)
for every float output. Both sides are float32 and round each operation,
but XLA on the CPU may fuse a multiply and an add into one rounding
(ROADMAP queue C, the note on lerped contributions), and the smoothing
chains carry such a difference forward. Anomaly flags are exact except
at cells whose value lies within that tolerance of a band.
"""

import numpy as np
import pytest
import torch

from opentsdb_tpu.models import smoothing as jax_sm
from opentsdb_tpu_torch.models import smoothing as sm
from opentsdb_tpu_torch.ops import smoothing as ops_sm

RTOL = 1e-5


def _series(S, T, season, seed):
    """[S, T] float32 values and bool mask: trend + season + noise with
    ~20% gaps; row 0 all masked, row 1 constant, row 2 a spike."""
    rng = np.random.default_rng(seed)
    t = np.arange(T)
    per = max(season, 1)
    vals = (rng.normal(50, 20, (S, 1)) + rng.normal(0, 0.2, (S, 1)) * t
            + rng.uniform(0, 8, (S, 1)) * np.sin(2 * np.pi * t / per)
            + rng.normal(0, 1.5, (S, T)))
    mask = rng.random((S, T)) > 0.2
    if S > 1:
        mask[0] = False
        vals[1] = 42.0
    if S > 2:
        vals[2, T // 2] += 500.0
        mask[2, T // 2] = True
    vals = np.where(mask, vals, 0.0).astype(np.float32)
    return vals, mask


def _tol(vals):
    scale = np.abs(vals).max(axis=1, keepdims=True)
    return RTOL * scale


def _close(got, want, vals, what):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, what
    atol = _tol(vals)
    if got.ndim == 1:
        atol = atol[:, 0]
    bad = np.abs(got - want) > RTOL * np.abs(want) + atol
    assert not bad.any(), (what, np.argwhere(bad)[:5], got[bad][:5],
                           want[bad][:5])


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


CASES = [
    # (S, T, season, alpha, beta, gamma, seed)
    (1, 50, 0, 0.3, 0.1, 0.1, 1),
    (8, 300, 0, 0.5, 0.2, 0.1, 2),
    (37, 200, 7, 0.3, 0.1, 0.1, 3),
    (8, 300, 24, 0.3, 0.1, 0.3, 4),
    (37, 120, 24, 0.0, 0.0, 0.0, 5),
    (8, 150, 7, 1.0, 1.0, 1.0, 6),
    (37, 96, 24, 1.0, 0.0, 0.5, 7),
    (1, 24, 24, 0.7, 0.05, 0.9, 8),
]


@pytest.mark.parametrize("S,T,season,alpha,beta,gamma,seed", CASES)
def test_anomaly_bands_match_jax(S, T, season, alpha, beta, gamma, seed):
    vals, mask = _series(S, T, season, seed)
    want = {k: np.asarray(v) for k, v in jax_sm.anomaly_bands(
        vals, mask, alpha, beta, gamma, season).items()}
    got = {k: v.numpy() for k, v in sm.anomaly_bands(
        _t(vals), _t(mask), alpha, beta, gamma, season).items()}
    assert set(got) == set(want)
    for k in ("fitted", "upper", "lower", "sigma", "level", "trend",
              "seasonal"):
        _close(got[k], want[k], vals, k)
    assert got["anomaly"].dtype == bool
    tol = RTOL * np.abs(vals) + _tol(vals)
    near = ((np.abs(vals - want["upper"]) <= tol)
            | (np.abs(vals - want["lower"]) <= tol))
    assert (got["anomaly"] == want["anomaly"])[~near].all()
    assert not got["anomaly"][~mask].any()
    if S > 2:
        # The spike is flagged; the all-masked and the constant rows
        # carry no flag but the spike's.
        assert got["anomaly"][2, T // 2] == want["anomaly"][2, T // 2]
        assert not got["anomaly"][0].any()


@pytest.mark.parametrize("S,T,season,alpha,beta,gamma,seed", CASES[:5])
def test_holt_winters_and_forecast_match_jax(S, T, season, alpha, beta,
                                             gamma, seed):
    vals, mask = _series(S, T, season, seed)
    want = {k: np.asarray(v) for k, v in jax_sm.holt_winters(
        vals, mask, alpha, beta, gamma, season).items()}
    got = sm.holt_winters(_t(vals), _t(mask), alpha, beta, gamma, season)
    for k in want:
        _close(got[k].numpy(), want[k], vals, k)
    for horizon in (1, 10, 37):
        wf = np.asarray(jax_sm.hw_forecast(
            want["level"], want["trend"], want["seasonal"],
            horizon=horizon, season_length=season, t_fitted=T))
        gf = sm.hw_forecast(got["level"], got["trend"], got["seasonal"],
                            horizon=horizon, season_length=season,
                            t_fitted=T)
        _close(gf.numpy(), wf, vals, f"forecast {horizon}")
        # The fused launch's forecasts are hw_forecast's on its state.
        fused = sm.anomaly_bands(_t(vals), _t(mask), alpha, beta, gamma,
                                 season, horizon=horizon)
        assert torch.equal(fused["forecast"], gf)


@pytest.mark.parametrize("S,T,alpha,seed", [
    (1, 50, 0.3, 1), (8, 300, 0.0, 2), (37, 200, 1.0, 3), (37, 300, 0.2, 4),
])
def test_ewma_matches_jax(S, T, alpha, seed):
    vals, mask = _series(S, T, 0, seed)
    want = np.asarray(jax_sm.ewma(vals, mask, alpha))
    got = sm.ewma(_t(vals), _t(mask), alpha)
    assert got.shape == (S, T) and got.dtype == torch.float32
    _close(got.numpy(), want, vals, "ewma")


def test_plain_versions_are_the_cpu_path():
    """On CPU tensors the kernel-backed functions are their plain
    versions, bit for bit, and count no launch."""
    vals, mask = _series(8, 100, 7, 9)
    before = (ops_sm.ewma_scan.launches,
              ops_sm.holt_winters_bands.launches)
    a = sm.anomaly_bands(_t(vals), _t(mask), season_length=7, horizon=5)
    b = sm.anomaly_bands_plain(_t(vals), _t(mask), season_length=7,
                               horizon=5)
    assert a.keys() == b.keys()
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert torch.equal(sm.ewma(_t(vals), _t(mask), 0.4),
                       sm.ewma_plain(_t(vals), _t(mask), 0.4))
    hw = sm.holt_winters(_t(vals), _t(mask), season_length=7)
    hp = sm.holt_winters_plain(_t(vals), _t(mask), season_length=7)
    assert all(torch.equal(hw[k], hp[k]) for k in hw)
    assert (ops_sm.ewma_scan.launches,
            ops_sm.holt_winters_bands.launches) == before


def test_padding_does_not_change_the_answer():
    """Masked tail steps and empty series carry the state through: the
    JAX handler's power-of-two padding gives the unpadded answer."""
    vals, mask = _series(5, 37, 7, 10)
    out = sm.anomaly_bands(_t(vals), _t(mask), season_length=7, horizon=4)
    pv = np.zeros((8, 64), np.float32)
    pm = np.zeros((8, 64), bool)
    pv[:5, :37], pm[:5, :37] = vals, mask
    pad = sm.anomaly_bands(_t(pv), _t(pm), season_length=7)
    for k in ("fitted", "upper", "lower", "sigma", "anomaly"):
        assert torch.equal(pad[k][:5, :37], out[k]), k
    for k in ("level", "trend", "seasonal"):
        assert torch.equal(pad[k][:5], out[k]), k
    fc = sm.hw_forecast(pad["level"], pad["trend"], pad["seasonal"],
                        horizon=4, season_length=7, t_fitted=37)[:5]
    assert torch.equal(fc, out["forecast"])


def test_bad_arguments_raise():
    vals, mask = _series(2, 10, 0, 11)
    with pytest.raises(ValueError):
        ops_sm.ewma_scan(_t(vals), _t(mask[:, :5]), 0.3)
    tm_v, tm_m = _t(vals.T.copy()), _t(mask.T.copy())
    with pytest.raises(ValueError):
        ops_sm.ewma_scan(tm_v.double(), tm_m, 0.3)
    with pytest.raises(ValueError):
        ops_sm.holt_winters_bands(tm_v, tm_m, season=-1)
