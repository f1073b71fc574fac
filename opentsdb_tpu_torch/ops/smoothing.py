"""Smoothing scans: the CUDA kernels of ``csrc/smoothing.cu`` and their
plain PyTorch versions.

The ports of the three ``lax.scan``s of the JAX package's
``opentsdb_tpu/models/smoothing.py`` (``ewma``, ``holt_winters`` and
``anomaly_bands``, whose residual scan folds into the fit's pass here) and,
at the end of the same launch, ``hw_forecast``. ``models/smoothing.py``
puts the JAX package's signatures ([S, T] in and out) over them.

Everything here is time-major: ``values`` [T, S] float32 and ``mask``
[T, S] bool in, [T, S] grids out, the seasonal state [m, S] and the
forecasts [horizon, S]. A warp's lanes own neighbouring series, so
time-major keeps a warp's loads and stores on neighbouring words.

- ``ewma_scan(values, mask, alpha)`` returns the EWMA [T, S]: a segmented
  scan over time (below).
- ``holt_winters_bands(values, mask, *, alpha, beta, gamma, season,
  nsigma, resid_alpha, warmup, horizon)`` returns a dict: fitted, upper,
  lower, sigma [T, S] and anomaly [T, S] bool; level and trend [S];
  seasonal [max(season, 1), S]; forecast [horizon, S] (empty when
  ``horizon`` is 0). One launch.
- ``ewma_scan_plain`` / ``holt_winters_bands_plain`` are the plain
  versions, each float32 operation rounded on its own in the kernel's
  order, so on the card they agree with the kernels bit for bit.
  ``holt_winters_bands_plain`` is a Python loop over T of the JAX step
  functions, op for op.

The EWMA's order of operations (the contract ``ewma_scan_plain`` and the
kernel share). Between observations the step ``mean' = oma * mean + a *
x`` (oma = 1 - a) is affine in the mean, so time splits into segments of
``EWMA_SEGMENT`` (L) steps, the last possibly shorter, and:

1. per (series, segment), in parallel, over the segment's steps: A, the
   product of oma over its real steps (from 1); B, the segment run from
   mean 0 as if already seen (``B = oma * B + a * x`` at a real step);
   U, the segment run with the JAX step from (0, unseen), and whether the
   segment has a real step;
2. per series, over the segments in order, the carry (mean, seen) into
   each segment: from (0, unseen); when seen, ``mean = AC + B`` with
   ``AC = mean`` if mean is +-inf and oma > 0 (``A * mean`` could be 0 x
   inf where the step keeps inf) and ``A * mean`` otherwise; when not yet
   seen, U (and seen) if the segment has a real step, else unchanged;
3. per (series, segment), in parallel: the JAX step from the segment's
   carry, each step's mean stored.

Outputs within the first segment are the JAX step's bits; later ones
differ from the sequential recurrence only by the rounding of the carries
(JAX on the CPU itself fuses a multiply-add there).

The wrappers take the plain version only for CPU tensors; on a CUDA
tensor they launch the kernel on the current stream or raise.
``ewma_scan.launches`` and ``holt_winters_bands.launches`` count kernel
launches, and nothing else.
"""

from __future__ import annotations

import ctypes

import torch

from opentsdb_tpu_torch.ops import cuda_build

_lib = None

# L, the EWMA's segment length in steps: the order of operations of
# ewma_scan_plain, passed to the kernel, which refuses another L.
EWMA_SEGMENT = 16


def _kernels() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = cuda_build.load("smoothing")
        p, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int32
        f32 = ctypes.c_float
        lib.ewma_scan_f32.argtypes = [p, p, i64, i64, f32, i32, p, p]
        lib.ewma_scan_f32.restype = ctypes.c_int
        lib.holt_winters_bands_f32.argtypes = [
            p, p, i64, i64, f32, f32, f32, i32, f32, f32, i32, i32,
            p, p, p, p, p, p, p, p, p, p]
        lib.holt_winters_bands_f32.restype = ctypes.c_int
        _lib = lib
    return _lib


def _check(values: torch.Tensor, mask: torch.Tensor) -> None:
    if values.dim() != 2 or values.dtype != torch.float32:
        raise ValueError(f"values must be [T, S] float32, got "
                         f"{tuple(values.shape)} {values.dtype}")
    if mask.dtype != torch.bool or mask.shape != values.shape:
        raise ValueError(f"mask must be [T, S] bool matching values, got "
                         f"{tuple(mask.shape)} {mask.dtype}")
    if mask.device != values.device:
        raise ValueError(f"values on {values.device}, mask on {mask.device}")


def _launch(fn: str, values: torch.Tensor, *args) -> None:
    """Call the library's ``fn`` on ``values``' card and current stream."""
    dev = values.device
    if dev.type != "cuda":
        raise ValueError(f"no kernel for device {dev}")
    lib = _kernels()
    stream = torch._C._cuda_getCurrentRawStream(dev.index)
    if dev.index == torch._C._cuda_getDevice():
        rc = getattr(lib, fn)(*args, stream)
    else:
        with torch.cuda.device(dev):
            rc = getattr(lib, fn)(*args, stream)
    if rc != 0:
        raise RuntimeError(f"{fn} launch failed: CUDA error {rc}")


def _scalar(v: float, device) -> torch.Tensor:
    return torch.tensor(v, dtype=torch.float32, device=device)


def ewma_scan_plain(values: torch.Tensor, mask: torch.Tensor,
                    alpha: float) -> torch.Tensor:
    """Plain PyTorch ``ewma_scan``: the segmented scan's three phases
    (module docstring), vectorised over [segments, S]."""
    _check(values, mask)
    T, S = values.shape
    dev = values.device
    a = _scalar(alpha, dev)
    oma = _scalar(1.0, dev) - a
    L = EWMA_SEGMENT
    K = -(-T // L)
    x = torch.cat([values, values.new_zeros(K * L - T, S)]).view(K, L, S)
    m = torch.cat([mask, mask.new_zeros(K * L - T, S)]).view(K, L, S)
    # 1. Each segment's summaries.
    A = torch.ones(K, S, dtype=torch.float32, device=dev)
    B = torch.zeros(K, S, dtype=torch.float32, device=dev)
    U = torch.zeros(K, S, dtype=torch.float32, device=dev)
    has = torch.zeros(K, S, dtype=torch.bool, device=dev)
    for u in range(L):
        xu, mu = x[:, u], m[:, u]
        ax = a * xu
        A = torch.where(mu, A * oma, A)
        B = torch.where(mu, oma * B + ax, B)
        U = torch.where(mu, torch.where(has, oma * U + ax, xu), U)
        has = has | mu
    # 2. The carries, segment by segment.
    mean = torch.empty(K, S, dtype=torch.float32, device=dev)
    seen = torch.empty(K, S, dtype=torch.bool, device=dev)
    c = torch.zeros(S, dtype=torch.float32, device=dev)
    cs = torch.zeros(S, dtype=torch.bool, device=dev)
    keep = oma > 0
    for k in range(K):
        mean[k], seen[k] = c, cs
        ac = torch.where(torch.isinf(c) & keep, c, A[k] * c)
        c = torch.where(cs, ac + B[k], torch.where(has[k], U[k], c))
        cs = cs | has[k]
    # 3. The JAX step from each segment's carry.
    out = torch.empty(K, L, S, dtype=torch.float32, device=dev)
    for u in range(L):
        xu, mu = x[:, u], m[:, u]
        new_mean = torch.where(seen, oma * mean + a * xu, xu)
        mean = torch.where(mu, new_mean, mean)
        seen = seen | mu
        out[:, u] = mean
    return out.view(K * L, S)[:T]


def ewma_scan(values: torch.Tensor, mask: torch.Tensor,
              alpha: float) -> torch.Tensor:
    """EWMA [T, S] of time-major ``values`` / ``mask``: the first real
    sample initialises the mean; masked steps emit the carried mean and do
    not update it."""
    _check(values, mask)
    if values.device.type == "cpu":
        return ewma_scan_plain(values, mask, alpha)
    values, mask = values.contiguous(), mask.contiguous()
    T, S = values.shape
    out = torch.empty_like(values)
    if S and T:
        _launch("ewma_scan_f32", values, values.data_ptr(), mask.data_ptr(),
                S, T, float(alpha), EWMA_SEGMENT, out.data_ptr())
        ewma_scan.launches += 1
    return out


ewma_scan.launches = 0


def _outputs(T: int, S: int, season: int, horizon: int, device) -> dict:
    f32 = dict(dtype=torch.float32, device=device)
    out = {k: torch.empty(T, S, **f32)
           for k in ("fitted", "upper", "lower", "sigma")}
    out["anomaly"] = torch.empty(T, S, dtype=torch.bool, device=device)
    out["level"] = torch.empty(S, **f32)
    out["trend"] = torch.empty(S, **f32)
    out["seasonal"] = torch.empty(max(season, 1), S, **f32)
    out["forecast"] = torch.empty(horizon, S, **f32)
    return out


def _check_ints(season: int, horizon: int, warmup: int) -> None:
    if not all(0 <= v < 2**31 for v in (season, horizon, warmup)):
        raise ValueError(f"season {season}, horizon {horizon} and warmup "
                         f"{warmup} must be int32 >= 0")


def holt_winters_bands_plain(values: torch.Tensor, mask: torch.Tensor, *,
                             alpha: float = 0.3, beta: float = 0.1,
                             gamma: float = 0.1, season: int = 0,
                             nsigma: float = 3.0, resid_alpha: float = 0.05,
                             warmup: int = 10, horizon: int = 0) -> dict:
    """Plain PyTorch ``holt_winters_bands``: the JAX fit step and residual
    step, once per time step, then ``hw_forecast``'s broadcast."""
    _check(values, mask)
    _check_ints(season, horizon, warmup)
    T, S = values.shape
    dev = values.device
    out = _outputs(T, S, season, horizon, dev)
    one = _scalar(1.0, dev)
    a, b, g = (_scalar(alpha, dev), _scalar(beta, dev), _scalar(gamma, dev))
    oma, omb, omg = one - a, one - b, one - g
    ns, ra = _scalar(nsigma, dev), _scalar(resid_alpha, dev)
    omra = one - ra
    tiny = _scalar(1e-6, dev)
    zero = torch.zeros(S, dtype=torch.float32, device=dev)
    m = max(season, 1)
    level, trend, var = zero.clone(), zero.clone(), zero.clone()
    seas = out["seasonal"]
    seas.zero_()
    nobs = torch.zeros(S, dtype=torch.int32, device=dev)
    seen = torch.zeros(S, dtype=torch.bool, device=dev)
    for t in range(T):
        x, obs = values[t], mask[t]
        s_t = seas[t % m].clone() if season > 0 else zero
        lt = level + trend
        pred = torch.where(seen, lt + s_t, x)
        new_level = a * (x - s_t) + oma * lt
        new_trend = b * (new_level - level) + omb * trend
        new_level = torch.where(seen, new_level, x)
        new_trend = torch.where(seen, new_trend, zero)
        if season > 0:
            s_new = g * (x - new_level) + omg * s_t
            seas[t % m] = torch.where(obs, s_new, s_t)
        level = torch.where(obs, new_level, level)
        trend = torch.where(obs, new_trend, trend)
        seen = seen | obs
        out["fitted"][t] = pred
        floor = tiny * (one + torch.abs(pred))
        sigma = torch.maximum(torch.sqrt(var), floor)
        upper = pred + ns * sigma
        lower = pred - ns * sigma
        out["upper"][t] = upper
        out["lower"][t] = lower
        out["sigma"][t] = sigma
        out["anomaly"][t] = obs & (nobs >= warmup) & (
            (x > upper) | (x < lower))
        r = torch.where(obs, x - pred, zero)
        var = torch.where(obs, omra * var + ra * r * r, var)
        nobs = nobs + obs.to(torch.int32)
    out["level"].copy_(level)
    out["trend"].copy_(trend)
    out["forecast"].copy_(hw_forecast_tm(level, trend, seas,
                                         horizon=horizon, season=season,
                                         t_fitted=T))
    return out


def hw_forecast_tm(level: torch.Tensor, trend: torch.Tensor,
                   seasonal: torch.Tensor, *, horizon: int, season: int,
                   t_fitted: int) -> torch.Tensor:
    """Forecasts [horizon, S] from the final state (seasonal [m, S]):
    ``level + trend * h``, plus slot ``(t_fitted + j) % season``."""
    h = torch.arange(1, horizon + 1, dtype=torch.float32,
                     device=level.device)
    base = level[None, :] + trend[None, :] * h[:, None]
    if season > 0:
        idx = (t_fitted + torch.arange(horizon, device=level.device)) \
            % season
        base = base + seasonal[idx]
    return base


def holt_winters_bands(values: torch.Tensor, mask: torch.Tensor, *,
                       alpha: float = 0.3, beta: float = 0.1,
                       gamma: float = 0.1, season: int = 0,
                       nsigma: float = 3.0, resid_alpha: float = 0.05,
                       warmup: int = 10, horizon: int = 0) -> dict:
    """Additive Holt(-Winters) one-step-ahead fit of time-major
    ``values`` / ``mask`` (``season`` 0: Holt's linear trend), its
    residual bands and anomaly flags, and ``horizon`` forecasts from the
    final state: one launch on the card."""
    _check(values, mask)
    _check_ints(season, horizon, warmup)
    kw = dict(alpha=alpha, beta=beta, gamma=gamma, season=season,
              nsigma=nsigma, resid_alpha=resid_alpha, warmup=warmup,
              horizon=horizon)
    if values.device.type == "cpu":
        return holt_winters_bands_plain(values, mask, **kw)
    values, mask = values.contiguous(), mask.contiguous()
    T, S = values.shape
    out = _outputs(T, S, season, horizon, values.device)
    if S:
        _launch("holt_winters_bands_f32", values, values.data_ptr(),
                mask.data_ptr(), S, T, float(alpha), float(beta),
                float(gamma), season, float(nsigma), float(resid_alpha),
                warmup, horizon, *(out[k].data_ptr() for k in (
                    "fitted", "upper", "lower", "sigma", "anomaly",
                    "level", "trend", "seasonal", "forecast")))
        holt_winters_bands.launches += 1
    return out


holt_winters_bands.launches = 0
