"""The computation behind ``/forecast``: the model grid, one model launch,
the JSON body.

Mirrors the ``compute`` step of the JAX daemon's ``_forecast``
(``opentsdb_tpu/server/tsd.py``) in three parts, so each can be timed:

- ``model_grid(results, start, end, interval)``: the query results on
  the model's bucket grid, time-major ([T, S] float32 values and mask;
  the grid starts at ``start`` rounded down to the interval and holds
  ``(end - grid0) // interval + 1`` buckets);
- ``run_model(grid, opts, device)``: ``ewma`` or the fused Holt-Winters
  fit + bands + forecast (one launch of ``csrc/smoothing.cu`` on the
  card) on ``device``, the answers brought to the host as numpy;
- ``body(results, grid, out, opts)``: the JSON bytes, the JAX daemon's
  keys and order.

The JAX daemon pads S and T to powers of two to bound XLA recompiles;
masked tail steps and empty series carry the state through unchanged, so
the port runs the exact shapes and gets the same answers.
"""

from __future__ import annotations

import json
from typing import NamedTuple

import numpy as np
import torch

from opentsdb_tpu_torch.models import smoothing


class ForecastOpts(NamedTuple):
    model: str          # "hw" or "ewma"
    horizon: int
    season: int
    alpha: float
    beta: float
    gamma: float
    nsigma: float


class Grid(NamedTuple):
    values: np.ndarray   # [T, S] float32, time-major
    mask: np.ndarray     # [T, S] bool
    grid0: int
    interval: int


def model_grid(results, start: int, end: int, interval: int) -> Grid:
    grid0 = start - start % interval
    T = max((end - grid0) // interval + 1, 1)
    S = len(results)
    vals = np.zeros((T, S), np.float32)
    mask = np.zeros((T, S), bool)
    for i, r in enumerate(results):
        idx = ((np.asarray(r.timestamps) - grid0) // interval).astype(int)
        ok = (idx >= 0) & (idx < T)
        vals[idx[ok], i] = np.asarray(r.values)[ok]
        mask[idx[ok], i] = True
    return Grid(vals, mask, grid0, interval)


def run_model(grid: Grid, opts: ForecastOpts, device) -> dict:
    """The model's outputs as numpy, [S, T] / [S, horizon] (views of the
    time-major host copies): "fitted" and "forecast", and for "hw" also
    "upper", "lower" and "anomaly"."""
    T, S = grid.values.shape
    if S == 0:
        return {}
    v = torch.from_numpy(grid.values).to(device)
    m = torch.from_numpy(grid.mask).to(device)
    if opts.model == "ewma":
        fitted = smoothing.ewma(v.t(), m.t(), opts.alpha).cpu().numpy()
        level = fitted[:, -1]
        return {"fitted": fitted,
                "forecast": np.repeat(level[:, None], opts.horizon, axis=1)}
    out = smoothing.anomaly_bands(
        v.t(), m.t(), opts.alpha, opts.beta, opts.gamma, opts.season,
        opts.nsigma, horizon=opts.horizon)
    return {k: out[k].cpu().numpy()
            for k in ("fitted", "upper", "lower", "anomaly", "forecast")}


def body(results, grid: Grid, out: dict, opts: ForecastOpts) -> bytes:
    """The /forecast JSON: per result its metric, tags, model, the fitted
    values at its real buckets, the forecasts, and for "hw" the anomaly
    timestamps and the bands at its real buckets."""
    T = grid.values.shape[0]
    grid_ts = grid.grid0 + np.arange(T) * grid.interval
    future_ts = grid.grid0 + (T + np.arange(opts.horizon)) * grid.interval
    keys = [str(int(t)) for t in grid_ts]
    fkeys = [str(int(t)) for t in future_ts]
    hw = opts.model != "ewma"
    res = []
    for i, r in enumerate(results):
        real = np.flatnonzero(grid.mask[:, i])
        rkeys = [keys[j] for j in real]
        entry = {"metric": r.metric, "tags": r.tags, "model": opts.model,
                 "fitted": dict(zip(rkeys, out["fitted"][i, real].tolist())),
                 "forecast": dict(zip(fkeys, out["forecast"][i].tolist()))}
        if hw:
            entry["anomalies"] = grid_ts[out["anomaly"][i]].tolist()
            entry["upper"] = dict(zip(rkeys, out["upper"][i, real].tolist()))
            entry["lower"] = dict(zip(rkeys, out["lower"][i, real].tolist()))
        res.append(entry)
    return json.dumps(res).encode()
