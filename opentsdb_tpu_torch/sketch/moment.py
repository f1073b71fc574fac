"""Moment sketches: tiny, exactly-mergeable quantile summaries.

Mirrors ``opentsdb_tpu/sketch/moment.py`` of the JAX package, copied
whole (numpy only): the rollup fold encodes a moment column per window
with it, and the ranged ``/sketch`` decodes, merges and estimates.

One sketch summarizes a value multiset with its count, min, max, the
first ``k`` power sums sum(x^i), and — when every value is positive —
the first ``k`` log-power sums sum(ln(x)^i) (arXiv:1803.01969). Two
sketches merge by elementwise ADDITION of the sums (min/max fold), so
cross-window and cross-shard fan-in is associative and exact — unlike
a t-digest, whose merge recompresses lossily. The log-domain BOUNDS
need no extra bytes: when every value is positive, ln(min)/ln(max)
ARE the log-domain extremes. At the default k=5 a record is 104
bytes — under a quarter of the default 64-centroid t-digest column.

Read side, two estimators:

- ``quantile_estimate`` (one sketch, sharp): maximum-entropy density
  matching the Chebyshev-rebased moments, solved by damped Newton on
  a fixed grid. Used where one solve amortizes over a whole request
  (the ranged /sketch endpoint).
- ``cf_quantile`` (vectorized, ~1 us/bucket): the Cornish-Fisher
  expansion through skewness/kurtosis, computed in the log domain for
  wide-range positive data — the per-(series, bucket) serving path,
  where a dashboard asks for hundreds of thousands of buckets.

Estimates are soft; the GUARANTEED enclosure reported to callers
comes from ``sketch/bounds.py`` (Cantelli-style, needs only count/
mean/variance/min/max — so it holds for ANY underlying data, not
just data the estimators model well).
"""

from __future__ import annotations

import struct

import numpy as np

DEFAULT_K = 5

# Encoded layout (little-endian), version 2:
#   u8 version (=2)
#   u8 k        (power moments)
#   u8 logk     (log moments; 0 = no log section)
#   u8 pad
#   u4 count
#   f8 min, f8 max
#   f8 moments[k]                      (sum x^1 .. sum x^k)
#   [ f8 logs[logk] ]                  (iff logk > 0)
_HDR = struct.Struct("<BBBxIdd")
_VERSION = 2
# Version 1 (a pre-release) carried f8 count + explicit log
# min/max; nothing persisted it outside tests, so no legacy decode.


class MomentSketch:
    """Mutable host-side moment state (the numpy twin of the jitted
    fold in ops/sketches.moment_add)."""

    __slots__ = ("k", "count", "vmin", "vmax", "moments",
                 "log_ok", "logs")

    def __init__(self, k: int = DEFAULT_K) -> None:
        self.k = int(k)
        self.count = 0.0
        self.vmin = np.inf
        self.vmax = -np.inf
        self.moments = np.zeros(self.k, np.float64)
        # log_ok: every value folded so far was > 0 (the log section
        # is only meaningful — and only kept through merges — then).
        self.log_ok = True
        self.logs = np.zeros(self.k, np.float64)

    # -- folding -----------------------------------------------------------

    def add(self, values: np.ndarray) -> "MomentSketch":
        v = np.asarray(values, np.float64)
        if len(v) == 0:
            return self
        self.count += len(v)
        self.vmin = min(self.vmin, float(v.min()))
        self.vmax = max(self.vmax, float(v.max()))
        p = v.copy()
        for i in range(self.k):
            self.moments[i] += p.sum()
            if i + 1 < self.k:
                p *= v
        if self.log_ok and float(v.min()) > 0.0:
            lv = np.log(v)
            p = lv.copy()
            for i in range(self.k):
                self.logs[i] += p.sum()
                if i + 1 < self.k:
                    p *= lv
        else:
            self.log_ok = False
        return self

    def merge(self, other: "MomentSketch") -> "MomentSketch":
        if other.count == 0:
            return self
        k = min(self.k, other.k)
        if k < self.k:
            self.k = k
            self.moments = self.moments[:k]
            self.logs = self.logs[:k]
        self.count += other.count
        self.vmin = min(self.vmin, other.vmin)
        self.vmax = max(self.vmax, other.vmax)
        self.moments += other.moments[:k]
        if self.log_ok and other.log_ok:
            self.logs += other.logs[:k]
        else:
            self.log_ok = False
        return self

    # -- derived -----------------------------------------------------------

    @property
    def mean(self) -> float:
        return self.moments[0] / self.count if self.count else 0.0

    @property
    def var(self) -> float:
        if self.count < 1 or self.k < 2:
            return 0.0
        m = self.mean
        return max(self.moments[1] / self.count - m * m, 0.0)

    @property
    def log_min(self) -> float:
        """ln of the smallest value (log_ok implies vmin > 0)."""
        return float(np.log(self.vmin)) if self.vmin > 0 else -np.inf

    @property
    def log_max(self) -> float:
        return float(np.log(self.vmax)) if self.vmax > 0 else -np.inf

    def log_stats(self) -> tuple[float, float] | None:
        """(mean, var) of ln(x), or None when the log section is
        invalid (any non-positive value folded in)."""
        if not self.log_ok or self.count < 1 or self.k < 2:
            return None
        m = self.logs[0] / self.count
        return m, max(self.logs[1] / self.count - m * m, 0.0)

    # -- wire format -------------------------------------------------------

    def encode(self) -> bytes:
        logk = self.k if (self.log_ok and self.count > 0) else 0
        out = [_HDR.pack(_VERSION, self.k, logk,
                         min(int(self.count), 0xFFFFFFFF),
                         self.vmin if self.count else 0.0,
                         self.vmax if self.count else 0.0),
               self.moments.astype("<f8").tobytes()]
        if logk:
            out.append(self.logs.astype("<f8").tobytes())
        return b"".join(out)

    @classmethod
    def decode(cls, blob: bytes) -> "MomentSketch":
        ver, k, logk, count, vmin, vmax = _HDR.unpack_from(blob, 0)
        if ver != _VERSION:
            raise ValueError(f"unknown moment-sketch version {ver}")
        sk = cls(k)
        sk.count = float(count)
        sk.vmin = vmin if count else np.inf
        sk.vmax = vmax if count else -np.inf
        off = _HDR.size
        sk.moments = np.frombuffer(blob, "<f8", k, off).copy()
        off += 8 * k
        if logk:
            sk.logs = np.frombuffer(blob, "<f8", logk, off).copy()
            sk.log_ok = True
        else:
            sk.log_ok = False
        return sk

    @staticmethod
    def encoded_size(k: int, with_log: bool = True) -> int:
        return _HDR.size + 8 * k + (8 * k if with_log else 0)


def from_arrays(count, vmin, vmax, moments,
                logs=None) -> MomentSketch:
    """Assemble a sketch from already-summed arrays (the batched fold
    path: summary.window_sketches computes exactly these columns)."""
    sk = MomentSketch(len(moments))
    sk.count = float(count)
    sk.vmin, sk.vmax = float(vmin), float(vmax)
    sk.moments = np.asarray(moments, np.float64).copy()
    if logs is not None:
        sk.logs = np.asarray(logs, np.float64).copy()
        sk.log_ok = True
    else:
        sk.log_ok = False
    return sk


class MomentColumns:
    """Struct-of-arrays over many decoded sketches (one per window/
    bucket): the vectorized serving path's working form. Merging a
    window into a bucket is row addition; estimates and bounds are
    elementwise numpy over all rows at once."""

    __slots__ = ("k", "count", "vmin", "vmax", "moments", "log_ok",
                 "logs")

    def __init__(self, n: int, k: int = DEFAULT_K) -> None:
        self.k = k
        self.count = np.zeros(n)
        self.vmin = np.full(n, np.inf)
        self.vmax = np.full(n, -np.inf)
        self.moments = np.zeros((n, k))
        self.log_ok = np.ones(n, bool)
        self.logs = np.zeros((n, k))

    def add_blob(self, i: int, blob: bytes) -> None:
        """Merge one encoded sketch into row ``i``."""
        ver, k, logk, count, vmin, vmax = _HDR.unpack_from(blob, 0)
        if ver != _VERSION:
            raise ValueError(f"unknown moment-sketch version {ver}")
        use = min(k, self.k)
        self.count[i] += count
        self.vmin[i] = min(self.vmin[i], vmin)
        self.vmax[i] = max(self.vmax[i], vmax)
        self.moments[i, :use] += np.frombuffer(blob, "<f8", use,
                                               _HDR.size)
        if logk:
            self.logs[i, :use] += np.frombuffer(
                blob, "<f8", use, _HDR.size + 8 * k)
        else:
            self.log_ok[i] = False

    def add_values(self, i: int, values: np.ndarray) -> None:
        """Merge exact raw values into row ``i`` (the stitched edge/
        dirty contributions)."""
        v = np.asarray(values, np.float64)
        if not len(v):
            return
        self.count[i] += len(v)
        self.vmin[i] = min(self.vmin[i], float(v.min()))
        self.vmax[i] = max(self.vmax[i], float(v.max()))
        p = v.copy()
        for j in range(self.k):
            self.moments[i, j] += p.sum()
            if j + 1 < self.k:
                p *= v
        if self.log_ok[i] and float(v.min()) > 0:
            lv = np.log(v)
            p = lv.copy()
            for j in range(self.k):
                self.logs[i, j] += p.sum()
                if j + 1 < self.k:
                    p *= lv
        else:
            self.log_ok[i] = False

    def row(self, i: int) -> MomentSketch:
        return from_arrays(self.count[i], self.vmin[i], self.vmax[i],
                           self.moments[i],
                           self.logs[i] if self.log_ok[i] else None)


# ---------------------------------------------------------------------------
# Normal quantile (Acklam's rational approximation; no scipy)
# ---------------------------------------------------------------------------

_A = (-3.969683028665376e+01, 2.209460984245205e+02,
      -2.759285104469687e+02, 1.383577518672690e+02,
      -3.066479806614716e+01, 2.506628277459239e+00)
_B = (-5.447609879822406e+01, 1.615858368580409e+02,
      -1.556989798598866e+02, 6.680131188771972e+01,
      -1.328068155288572e+01)
_C = (-7.784894002430293e-03, -3.223964580411365e-01,
      -2.400758277161838e+00, -2.549732539343734e+00,
      4.374664141464968e+00, 2.938163982698783e+00)
_D = (7.784695709041462e-03, 3.224671290700398e-01,
      2.445134137142996e+00, 3.754408661907416e+00)


def norm_ppf(q: np.ndarray) -> np.ndarray:
    """Vectorized standard-normal quantile, |err| < 1.15e-9."""
    q = np.clip(np.asarray(q, np.float64), 1e-12, 1 - 1e-12)
    out = np.empty_like(q)
    lo = q < 0.02425
    hi = q > 1 - 0.02425
    mid = ~(lo | hi)
    if mid.any():
        r = q[mid] - 0.5
        s = r * r
        num = ((((_A[0] * s + _A[1]) * s + _A[2]) * s + _A[3]) * s
               + _A[4]) * s + _A[5]
        den = ((((_B[0] * s + _B[1]) * s + _B[2]) * s + _B[3]) * s
               + _B[4]) * s + 1.0
        out[mid] = r * num / den
    for sel, sign, qq in ((lo, -1.0, q), (hi, 1.0, 1.0 - q)):
        if sel.any():
            r = np.sqrt(-2.0 * np.log(qq[sel]))
            num = ((((_C[0] * r + _C[1]) * r + _C[2]) * r + _C[3]) * r
                   + _C[4]) * r + _C[5]
            den = (((_D[0] * r + _D[1]) * r + _D[2]) * r
                   + _D[3]) * r + 1.0
            out[sel] = sign * -(num / den)
    return out


def cf_quantile(count, mean, var, m3, m4, vmin, vmax,
                q: float) -> np.ndarray:
    """Vectorized Cornish-Fisher quantile estimate from the first
    four CENTRAL-moment inputs (elementwise over buckets): z adjusted
    by skewness and excess kurtosis, clamped to [min, max]. All
    inputs are same-shape arrays."""
    s = np.sqrt(np.maximum(var, 0.0))
    z = float(norm_ppf(np.array([q]))[0])
    with np.errstate(divide="ignore", invalid="ignore"):
        g1 = np.where(s > 0, m3 / np.maximum(s ** 3, 1e-300), 0.0)
        g2 = np.where(s > 0,
                      m4 / np.maximum(var ** 2, 1e-300) - 3.0, 0.0)
    # Clamp the shape terms: CF diverges for extreme skew/kurtosis,
    # and the estimate only needs to be NEAR — the bound is separate.
    g1 = np.clip(g1, -3.0, 3.0)
    g2 = np.clip(g2, -6.0, 6.0)
    w = (z + g1 * (z * z - 1.0) / 6.0
         + g2 * (z ** 3 - 3.0 * z) / 24.0
         - g1 * g1 * (2.0 * z ** 3 - 5.0 * z) / 36.0)
    est = mean + s * w
    return np.clip(est, vmin, vmax)


def central_moments(count, raw: np.ndarray):
    """(mean, var, m3, m4) columns from raw power-sum columns
    [N, k>=4] (elementwise; the k<4 tail pads with zeros — CF then
    degrades to the normal/2-moment estimate)."""
    n = np.maximum(count, 1.0)
    k = raw.shape[1]
    m1 = raw[:, 0] / n
    m2 = (raw[:, 1] / n if k > 1 else m1 * m1)
    var = np.maximum(m2 - m1 * m1, 0.0)
    if k > 2:
        e3 = raw[:, 2] / n
        m3 = e3 - 3 * m1 * m2 + 2 * m1 ** 3
    else:
        m3 = np.zeros_like(m1)
    if k > 3:
        e4 = raw[:, 3] / n
        e3 = raw[:, 2] / n
        m4 = (e4 - 4 * m1 * e3 + 6 * m1 * m1 * m2
              - 3 * m1 ** 4)
        m4 = np.maximum(m4, 0.0)
    else:
        m4 = 3.0 * var * var  # normal kurtosis: g2 = 0
    return m1, var, m3, m4


# ---------------------------------------------------------------------------
# Maximum-entropy quantile solver (the sharp single-sketch path)
# ---------------------------------------------------------------------------

_GRID = 257          # density grid points on [-1, 1]
_NEWTON_STEPS = 30
_TOL = 1e-9


def _cheb_vander(x: np.ndarray, k: int) -> np.ndarray:
    """[len(x), k+1] matrix of T_0..T_k evaluated at x (recurrence)."""
    out = np.empty((len(x), k + 1))
    out[:, 0] = 1.0
    if k >= 1:
        out[:, 1] = x
    for i in range(2, k + 1):
        out[:, i] = 2 * x * out[:, i - 1] - out[:, i - 2]
    return out


def _cheb_moments(power_sums: np.ndarray, count: float, lo: float,
                  hi: float) -> np.ndarray | None:
    """Chebyshev moments E[T_i(y)], y = (2x - (lo+hi)) / (hi-lo), from
    raw power sums — the binomial rebase. Returns None when the rebase
    is numerically untrustworthy (catastrophic cancellation leaves
    |E[T_i]| > 1, which no distribution on [-1, 1] can produce)."""
    k = len(power_sums)
    if hi <= lo:
        return None
    # Raw moments of x (E[x^i], i=0..k).
    mu = np.empty(k + 1)
    mu[0] = 1.0
    mu[1:] = power_sums / count
    # Moments of y via (a + b*x)^i expansion: a = -(lo+hi)/(hi-lo),
    # b = 2/(hi-lo).
    a = -(lo + hi) / (hi - lo)
    b = 2.0 / (hi - lo)
    ymom = np.empty(k + 1)
    for i in range(k + 1):
        acc = 0.0
        for j in range(i + 1):
            acc += (_BINOM(i, j) * (a ** (i - j)) * (b ** j) * mu[j])
        ymom[i] = acc
    # Chebyshev T_i as polynomials in y (coefficient recurrence).
    coef = [np.array([1.0]), np.array([0.0, 1.0])]
    for i in range(2, k + 1):
        c = np.zeros(i + 1)
        c[1:] += 2 * coef[-1]
        c[:len(coef[-2])] -= coef[-2]
        coef.append(c)
    cm = np.array([float(np.dot(c, ymom[:len(c)])) for c in coef])
    if not np.all(np.isfinite(cm)) or np.any(np.abs(cm[1:]) > 1.0 + 1e-6):
        return None
    return np.clip(cm, -1.0, 1.0)


def _BINOM(n: int, r: int) -> float:
    from math import comb
    return float(comb(n, r))


def _maxent_cdf(cheb_mom: np.ndarray) -> tuple[np.ndarray, np.ndarray] | None:
    """Solve the maxent density on [-1, 1] matching ``cheb_mom``
    (index 0 == 1). Returns (grid y, CDF at y) or None on failure."""
    k = len(cheb_mom) - 1
    y = np.linspace(-1.0, 1.0, _GRID)
    T = _cheb_vander(y, k)                     # [G, k+1]
    lam = np.zeros(k + 1)
    w = np.full(_GRID, 2.0 / (_GRID - 1))      # trapezoid weights
    w[0] *= 0.5
    w[-1] *= 0.5
    target = cheb_mom
    for _ in range(_NEWTON_STEPS):
        e = T @ lam
        e -= e.max()                           # overflow guard
        dens = np.exp(e) * w
        z = dens.sum()
        if not np.isfinite(z) or z <= 0:
            return None
        p = dens / z
        cur = T.T @ p                          # E[T_i]
        grad = cur - target
        if np.abs(grad).max() < _TOL:
            break
        # Hessian: Cov(T_i, T_j) under p.
        H = (T.T * p) @ T - np.outer(cur, cur)
        H[np.diag_indices_from(H)] += 1e-10
        try:
            step = np.linalg.solve(H, grad)
        except np.linalg.LinAlgError:
            return None
        # Damping: bound the update so a stiff Hessian can't explode.
        n = np.abs(step).max()
        if n > 5.0:
            step *= 5.0 / n
        lam = lam - step
    e = T @ lam
    e -= e.max()
    dens = np.exp(e) * w
    z = dens.sum()
    if not np.isfinite(z) or z <= 0:
        return None
    cdf = np.cumsum(dens / z)
    cdf[-1] = 1.0
    return y, cdf


def quantile_estimate(sk: MomentSketch, qs: np.ndarray,
                      fast: bool = False) -> np.ndarray:
    """Quantile estimates (one per q in [0, 1]): the maxent solve, or
    — ``fast`` / solver-declined — the vectorizable Cornish-Fisher
    form. Callers always get values inside [min, max]; the GUARANTEED
    enclosure is computed separately (sketch/bounds.py), so a cheap
    estimate is merely less sharp, never unsound."""
    qs = np.clip(np.asarray(qs, np.float64), 0.0, 1.0)
    if sk.count <= 0:
        return np.full(len(qs), np.nan)
    if sk.vmax <= sk.vmin:
        return np.full(len(qs), sk.vmin)
    use_log = (sk.log_ok and sk.vmin > 0
               and (sk.log_max - sk.log_min) > 2.0)
    if not fast and sk.k >= 3:
        for domain in (("log", "lin") if use_log else ("lin", "log")):
            if domain == "log":
                if not sk.log_ok or sk.log_max <= sk.log_min:
                    continue
                cm = _cheb_moments(sk.logs, sk.count, sk.log_min,
                                   sk.log_max)
                lo, hi = sk.log_min, sk.log_max
            else:
                cm = _cheb_moments(sk.moments, sk.count, sk.vmin,
                                   sk.vmax)
                lo, hi = sk.vmin, sk.vmax
            if cm is None:
                continue
            solved = _maxent_cdf(cm)
            if solved is None:
                continue
            y, cdf = solved
            est_y = np.interp(qs, cdf, y)
            est = lo + (est_y + 1.0) * 0.5 * (hi - lo)
            if domain == "log":
                est = np.exp(est)
            return np.clip(est, sk.vmin, sk.vmax)
    # Cornish-Fisher (log-domain preferred for wide positive data).
    one = np.ones(1)
    out = np.empty(len(qs))
    if use_log:
        raw = sk.logs.reshape(1, -1)
        m1, var, m3, m4 = central_moments(one * sk.count, raw)
        for i, q in enumerate(qs):
            out[i] = float(np.exp(np.clip(
                cf_quantile(one * sk.count, m1, var, m3, m4,
                            one * sk.log_min, one * sk.log_max,
                            float(q))[0],
                sk.log_min, sk.log_max)))
    else:
        raw = sk.moments.reshape(1, -1)
        m1, var, m3, m4 = central_moments(one * sk.count, raw)
        for i, q in enumerate(qs):
            out[i] = float(cf_quantile(
                one * sk.count, m1, var, m3, m4, one * sk.vmin,
                one * sk.vmax, float(q))[0])
    return np.clip(out, sk.vmin, sk.vmax)
