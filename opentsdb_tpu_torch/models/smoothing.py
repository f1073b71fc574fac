"""Batched exponential-smoothing models over [S, T] series.

Mirrors ``opentsdb_tpu/models/smoothing.py`` of the JAX package, with its
signatures and dict keys. Every function takes ``values [S, T]`` (S series
on a shared bucket grid) and ``mask [S, T]`` marking real buckets, as
tensors on one device; masked steps carry the state through unchanged.
The scans run in the hand-written kernels of ``csrc/smoothing.cu``
(``ops/smoothing.py``), which work time-major: a [S, T] argument whose
transpose is contiguous (the ``.t()`` of a time-major tensor) reaches the
kernel without a copy, and every [S, T] result is the ``.t()`` view of a
time-major tensor.

- ``ewma(values, mask, alpha)``: the EWMA [S, T].
- ``holt_winters(values, mask, alpha, beta, gamma, season_length)``:
  fitted [S, T] one-step-ahead predictions, level, trend [S], seasonal
  [S, max(season_length, 1)].
- ``hw_forecast(level, trend, seasonal, *, horizon, season_length,
  t_fitted)``: [S, horizon] forecasts (a broadcast and a gather, plain
  torch).
- ``anomaly_bands(values, mask, ...)``: the fit, the residual bands
  (upper, lower, sigma) and anomaly flags, and the final state; with
  ``horizon=`` > 0 (the port's keyword: ``/forecast`` asks for it) also
  ``"forecast"`` [S, horizon], from the same launch.

``ewma_plain``, ``holt_winters_plain`` and ``anomaly_bands_plain`` are
the plain PyTorch versions on any device (the tests and the smoke use
them); the kernel-backed functions take them by themselves on the CPU.
"""

from __future__ import annotations

import torch

from opentsdb_tpu_torch.ops import smoothing as _ops


def _time_major(values: torch.Tensor, mask: torch.Tensor):
    return (values.t().to(torch.float32).contiguous(),
            mask.t().to(torch.bool).contiguous())


def _fit_keys(out: dict) -> dict:
    return {"fitted": out["fitted"].t(), "level": out["level"],
            "trend": out["trend"], "seasonal": out["seasonal"].t()}


def _ewma(scan, values, mask, alpha):
    return scan(*_time_major(values, mask), alpha).t()


def ewma(values: torch.Tensor, mask: torch.Tensor,
         alpha: float) -> torch.Tensor:
    """Exponentially weighted moving average along axis 1. The first real
    sample initialises the mean; masked steps emit the carried mean and
    do not update it."""
    return _ewma(_ops.ewma_scan, values, mask, alpha)


def ewma_plain(values: torch.Tensor, mask: torch.Tensor,
               alpha: float) -> torch.Tensor:
    return _ewma(_ops.ewma_scan_plain, values, mask, alpha)


def _holt_winters(fn, values, mask, alpha, beta, gamma, season_length):
    # The one launch computes the bands too; holt_winters keeps the fit.
    return _fit_keys(fn(*_time_major(values, mask), alpha=alpha, beta=beta,
                        gamma=gamma, season=season_length))


def holt_winters(values: torch.Tensor, mask: torch.Tensor,
                 alpha: float = 0.3, beta: float = 0.1, gamma: float = 0.1,
                 season_length: int = 0) -> dict:
    """Additive Holt(-Winters) smoothing; ``season_length=0`` is Holt's
    linear trend. Returns fitted [S, T] (the prediction before each
    observation updates the state), level [S], trend [S] and seasonal
    [S, max(season_length, 1)]."""
    return _holt_winters(_ops.holt_winters_bands, values, mask, alpha,
                         beta, gamma, season_length)


def holt_winters_plain(values: torch.Tensor, mask: torch.Tensor,
                       alpha: float = 0.3, beta: float = 0.1,
                       gamma: float = 0.1, season_length: int = 0) -> dict:
    return _holt_winters(_ops.holt_winters_bands_plain, values, mask, alpha,
                         beta, gamma, season_length)


def hw_forecast(level: torch.Tensor, trend: torch.Tensor,
                seasonal: torch.Tensor, *, horizon: int,
                season_length: int = 0, t_fitted: int = 0) -> torch.Tensor:
    """h-step-ahead forecasts [S, horizon] from the final Holt-Winters
    state; step ``t_fitted + j`` reads seasonal slot
    ``(t_fitted + j) % season_length``."""
    return _ops.hw_forecast_tm(level, trend, seasonal.t(), horizon=horizon,
                               season=season_length, t_fitted=t_fitted).t()


def _anomaly_bands(fn, values, mask, alpha, beta, gamma, season_length,
                   nsigma, resid_alpha, warmup, horizon):
    out = fn(*_time_major(values, mask), alpha=alpha, beta=beta,
             gamma=gamma, season=season_length, nsigma=nsigma,
             resid_alpha=resid_alpha, warmup=warmup, horizon=horizon)
    res = {k: out[k].t() for k in ("upper", "lower", "sigma", "anomaly")}
    res.update(_fit_keys(out))
    if horizon > 0:
        res["forecast"] = out["forecast"].t()
    return res


def anomaly_bands(values: torch.Tensor, mask: torch.Tensor,
                  alpha: float = 0.3, beta: float = 0.1, gamma: float = 0.1,
                  season_length: int = 0, nsigma: float = 3.0,
                  resid_alpha: float = 0.05, warmup: int = 10, *,
                  horizon: int = 0) -> dict:
    """Residual-based anomaly detection: fits holt_winters, tracks an
    exponentially weighted variance of the one-step-ahead residuals and
    flags |residual| > nsigma * sigma once ``warmup`` observations have
    seeded it (sigma and count from before the step's own residual, sigma
    floored at 1e-6 * (1 + |fitted|)). Returns fitted, upper, lower,
    sigma [S, T], anomaly [S, T] bool (False where mask is False), the
    final level, trend and seasonal, and with ``horizon`` > 0 the
    forecasts [S, horizon]."""
    return _anomaly_bands(_ops.holt_winters_bands, values, mask, alpha,
                          beta, gamma, season_length, nsigma, resid_alpha,
                          warmup, horizon)


def anomaly_bands_plain(values: torch.Tensor, mask: torch.Tensor,
                        alpha: float = 0.3, beta: float = 0.1,
                        gamma: float = 0.1, season_length: int = 0,
                        nsigma: float = 3.0, resid_alpha: float = 0.05,
                        warmup: int = 10, *, horizon: int = 0) -> dict:
    return _anomaly_bands(_ops.holt_winters_bands_plain, values, mask,
                          alpha, beta, gamma, season_length, nsigma,
                          resid_alpha, warmup, horizon)
