"""Error enclosures for approximately-served answers.

Mirrors ``opentsdb_tpu/sketch/bounds.py`` of the JAX package, copied
whole: the ranged ``/sketch`` served from rollups reports its
t-digest or moment enclosure with it, ``/distinct`` its HLL bound.

Every approximate answer the serving tier emits carries a bound the
caller can hold it to; the accuracy harness (scripts/sketch_harness.py)
asserts the exact-raw answer lies INSIDE the bound, so the math here
leans conservative:

- **Moment sketches**: Cantelli's one-sided inequality. For ANY
  distribution with mean m and variance s^2, the q-quantile satisfies

      m - s * sqrt((1-q)/q)  <=  Q(q)  <=  m + s * sqrt(q/(1-q)),

  clamped to the sketch's exact [min, max]. This holds for arbitrary
  data (no smoothness assumption — the maxent ESTIMATE may be sharp
  or sloppy, the bound stands regardless). When the log-domain
  moments are valid both domains' enclosures hold, so they intersect.

- **t-digests**: the neighbor-centroid enclosure from the accuracy
  analysis (arXiv:1902.04023-style): the q-quantile's rank falls in a
  known centroid; its value is enclosed by the NEIGHBOR centroid
  means (a centroid's members, under the digest's ordering invariant,
  do not stray past the adjacent means), widened by any caller rank
  slack (stale/dirty weight under degraded serving) and clamped to
  [min, max] when the caller knows them (moment records do).

- **HLL**: the classic 1.04/sqrt(m) standard error at 3 sigma.
"""

from __future__ import annotations

import numpy as np

from opentsdb_tpu_torch.sketch.moment import MomentSketch, quantile_estimate


class QuantileBound:
    """(estimate, lo, hi) triple; ``hi - lo`` is the enclosure width
    and ``error`` the reported half-width around the estimate."""

    __slots__ = ("est", "lo", "hi")

    def __init__(self, est: float, lo: float, hi: float) -> None:
        self.est = float(est)
        self.lo = float(min(lo, est))
        self.hi = float(max(hi, est))

    @property
    def error(self) -> float:
        return max(self.hi - self.est, self.est - self.lo)

    def widen(self, other: "QuantileBound") -> None:
        self.lo = min(self.lo, other.lo)
        self.hi = max(self.hi, other.hi)


def _cantelli(count: float, mean: float, var: float, vmin: float,
              vmax: float, q: float, rank_slack: float = 0.0,
              ) -> tuple[float, float]:
    """Guaranteed [lo, hi] for the q-quantile from two moments.
    ``rank_slack`` widens the target rank both ways (degraded serving
    over stale windows: the quantile's true rank within the sketched
    data is only known to +-slack)."""
    s = float(np.sqrt(max(var, 0.0)))
    ql = min(max(q - rank_slack, 0.0), 1.0)
    qh = min(max(q + rank_slack, 0.0), 1.0)
    if qh >= 1.0:
        hi = vmax
    else:
        hi = mean + s * float(np.sqrt(qh / (1.0 - qh)))
    if ql <= 0.0:
        lo = vmin
    else:
        lo = mean - s * float(np.sqrt((1.0 - ql) / ql))
    return max(lo, vmin), min(hi, vmax)


def moment_quantile_bound(sk: MomentSketch, q: float,
                          rank_slack: float = 0.0) -> QuantileBound:
    """Estimate + guaranteed enclosure for one quantile of a moment
    sketch. Linear-domain Cantelli always applies; the log-domain one
    (exp of the enclosure of ln x's quantile — quantiles commute with
    monotone maps) intersects in when valid."""
    est = float(quantile_estimate(sk, np.array([q]))[0])
    if sk.count <= 0 or not np.isfinite(est):
        return QuantileBound(np.nan, np.nan, np.nan)
    lo, hi = _cantelli(sk.count, sk.mean, sk.var, sk.vmin, sk.vmax, q,
                       rank_slack)
    ls = sk.log_stats()
    if ls is not None and sk.vmin > 0:
        lm, lv = ls
        llo, lhi = _cantelli(sk.count, lm, lv, sk.log_min, sk.log_max,
                             q, rank_slack)
        # Both enclosures are sound -> the intersection is.
        lo = max(lo, float(np.exp(llo)))
        hi = min(hi, float(np.exp(lhi)))
    # Small-count discreteness guard: with n values the empirical
    # quantile sits ON a sample; the enclosure already contains every
    # sample in rank range, nothing further needed — but numerical
    # round-off in the power sums can nip the enclosure past a sample
    # at tiny n, so pad by one part in 1e9 of the span.
    pad = (sk.vmax - sk.vmin) * 1e-9
    return QuantileBound(min(max(est, lo), hi), lo - pad, hi + pad)


def tdigest_quantile_bound(means: np.ndarray, weights: np.ndarray,
                           q: float, vmin: float | None = None,
                           vmax: float | None = None,
                           rank_slack: float = 0.0,
                           cdf_uncertainty_w: float = 0.0,
                           ) -> QuantileBound:
    """Estimate + enclosure for one quantile of a POOLED digest —
    the concatenation of several window digests plus exact raw
    points (the planner's bucket/range merges).

    Two rank-uncertainty sources add up:

    - ``rank_slack``: the caller's own slack (stale-weight fraction
      under degraded serving).
    - ``cdf_uncertainty_w``: summed WEIGHT uncertainty of the merged
      CDF — each contributing digest's interpolated CDF is off by at
      most its heaviest centroid's weight (the within-centroid
      distribution is unknown around any probe point; exact raw
      points contribute zero). Concatenating digests sums these. The
      old neighbor-centroid-only argument is sound within ONE
      digest's ordering invariant but NOT across a concatenation —
      window A's centroid members may stray past window B's adjacent
      mean — so the enclosure takes the slacked ranks [q - u, q + u]
      (u = total uncertainty fraction) and widens to the OUTER
      neighbor means beyond them, clamped to the exact [vmin, vmax]
      from the moment records."""
    keep = weights > 0
    m = np.asarray(means, np.float64)[keep]
    w = np.asarray(weights, np.float64)[keep]
    if len(m) == 0:
        return QuantileBound(np.nan, np.nan, np.nan)
    order = np.argsort(m, kind="stable")
    m, w = m[order], w[order]
    total = float(w.sum())
    cum = np.cumsum(w)
    centers = (cum - w / 2) / max(total, 1e-30)
    q = min(max(q, 0.0), 1.0)
    est = float(np.interp(q, centers, m))
    slack = rank_slack + cdf_uncertainty_w / max(total, 1e-30)
    rlo = min(max(q - slack, 0.0), 1.0) * total
    rhi = min(max(q + slack, 0.0), 1.0) * total
    # Centroid index whose span [cum - w, cum] contains each rank
    # end, then one more neighbor outward (within-centroid spread).
    ilo = int(np.searchsorted(cum, rlo, side="left"))
    ihi = int(np.searchsorted(cum, rhi, side="left"))
    ilo = min(ilo, len(m) - 1)
    ihi = min(ihi, len(m) - 1)
    lo = m[ilo - 1] if ilo > 0 else (vmin if vmin is not None else m[0])
    hi = (m[ihi + 1] if ihi + 1 < len(m)
          else (vmax if vmax is not None else m[-1]))
    if vmin is not None:
        lo = max(float(lo), float(vmin))
        est = max(est, float(vmin))
    if vmax is not None:
        hi = min(float(hi), float(vmax))
        est = min(est, float(vmax))
    return QuantileBound(est, float(lo), float(hi))


def moment_bounds_batch(cols, q: float,
                        rank_slack: np.ndarray | float = 0.0,
                        ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Vectorized (estimate, lo, hi) for one quantile over a
    MomentColumns block — the per-(series, bucket) serving path.
    Estimates are Cornish-Fisher (log domain where valid); the
    enclosure is the same Cantelli math as moment_quantile_bound,
    elementwise: linear-domain always, intersected with the
    log-domain enclosure on rows whose log section is valid. A
    dashboard's hundreds of thousands of buckets cost a handful of
    numpy passes instead of a maxent solve each."""
    from opentsdb_tpu_torch.sketch.moment import (central_moments,
                                            cf_quantile)
    n = np.maximum(cols.count, 1.0)
    slack = np.broadcast_to(np.asarray(rank_slack, np.float64),
                            cols.count.shape)
    ql = np.clip(q - slack, 0.0, 1.0)
    qh = np.clip(q + slack, 0.0, 1.0)
    m1, var, m3, m4 = central_moments(n, cols.moments)
    s = np.sqrt(var)
    with np.errstate(divide="ignore", invalid="ignore"):
        hi = np.where(qh >= 1.0, cols.vmax,
                      m1 + s * np.sqrt(qh / np.maximum(1 - qh,
                                                       1e-300)))
        lo = np.where(ql <= 0.0, cols.vmin,
                      m1 - s * np.sqrt((1 - ql) / np.maximum(ql,
                                                             1e-300)))
    lo = np.maximum(lo, cols.vmin)
    hi = np.minimum(hi, cols.vmax)
    log_rows = cols.log_ok & (cols.vmin > 0)
    est = cf_quantile(n, m1, var, m3, m4, cols.vmin, cols.vmax, q)
    if log_rows.any():
        lmin = np.where(log_rows, np.log(np.maximum(cols.vmin,
                                                    1e-300)), 0.0)
        lmax = np.where(log_rows, np.log(np.maximum(cols.vmax,
                                                    1e-300)), 1.0)
        lm1, lvar, lm3, lm4 = central_moments(n, cols.logs)
        ls = np.sqrt(lvar)
        with np.errstate(divide="ignore", invalid="ignore",
                         over="ignore"):
            lhi = np.where(qh >= 1.0, lmax,
                           lm1 + ls * np.sqrt(
                               qh / np.maximum(1 - qh, 1e-300)))
            llo = np.where(ql <= 0.0, lmin,
                           lm1 - ls * np.sqrt(
                               (1 - ql) / np.maximum(ql, 1e-300)))
            # Both enclosures are sound -> intersect on log rows.
            lo = np.where(log_rows,
                          np.maximum(lo, np.exp(np.maximum(llo,
                                                           -700))),
                          lo)
            hi = np.where(log_rows,
                          np.minimum(hi, np.exp(np.minimum(lhi,
                                                           700))),
                          hi)
            lest = np.exp(np.clip(
                cf_quantile(n, lm1, lvar, lm3, lm4, lmin, lmax, q),
                -700, 700))
        wide = log_rows & ((lmax - lmin) > 2.0)
        est = np.where(wide, np.clip(lest, cols.vmin, cols.vmax),
                       est)
    pad = (cols.vmax - cols.vmin) * 1e-9
    est = np.clip(est, lo, hi)
    return est, lo - pad, hi + pad


def tdigest_bounds_rows(means: np.ndarray, weights: np.ndarray,
                        q: float, vmin: np.ndarray, vmax: np.ndarray,
                        rank_slack: np.ndarray | float = 0.0,
                        cdf_uncertainty_w: np.ndarray | float = 0.0,
                        ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Row-wise tdigest_quantile_bound over padded [N, K] centroid
    arrays (pad slots carry weight 0), one numpy pass for every
    bucket of a series. Rows must already be value-sorted with pads
    at the END (digest cells store centroids sorted; the serving
    path pads on the right)."""
    w = np.asarray(weights, np.float64)
    m = np.asarray(means, np.float64)
    N, K = m.shape
    total = w.sum(axis=1)
    cum = np.cumsum(w, axis=1)
    centers = (cum - w / 2) / np.maximum(total, 1e-30)[:, None]
    # Pad slots: push centers past 1 so searches never land on them.
    centers = np.where(w > 0, centers, 2.0)
    live = (w > 0).sum(axis=1)
    q = min(max(q, 0.0), 1.0)
    # Row-wise interp at q: searchsorted per row on monotone centers.
    idx = np.clip(_row_searchsorted(centers, np.full(N, q)), 0,
                  np.maximum(live - 1, 0))
    idx0 = np.maximum(idx - 1, 0)
    c0 = np.take_along_axis(centers, idx0[:, None], 1)[:, 0]
    c1 = np.take_along_axis(centers, idx[:, None], 1)[:, 0]
    m0 = np.take_along_axis(m, idx0[:, None], 1)[:, 0]
    m1_ = np.take_along_axis(m, idx[:, None], 1)[:, 0]
    frac = np.where(c1 > c0, (q - c0) / np.maximum(c1 - c0, 1e-30),
                    0.0)
    est = m0 + np.clip(frac, 0.0, 1.0) * (m1_ - m0)
    first = m[:, 0]
    last = np.take_along_axis(m, np.maximum(live - 1, 0)[:, None],
                              1)[:, 0]
    est = np.where(q <= centers[:, 0], first, est)
    lastc = np.take_along_axis(centers,
                               np.maximum(live - 1, 0)[:, None],
                               1)[:, 0]
    est = np.where(q >= lastc, last, est)
    slack = (np.broadcast_to(np.asarray(rank_slack, np.float64),
                             total.shape)
             + np.asarray(cdf_uncertainty_w, np.float64)
             / np.maximum(total, 1e-30))
    rlo = np.clip(q - slack, 0.0, 1.0) * total
    rhi = np.clip(q + slack, 0.0, 1.0) * total
    cum_masked = np.where(w > 0, cum, np.inf)
    ilo = np.minimum(_row_searchsorted(cum_masked, rlo),
                     np.maximum(live - 1, 0))
    ihi = np.minimum(_row_searchsorted(cum_masked, rhi),
                     np.maximum(live - 1, 0))
    lo = np.where(ilo > 0,
                  np.take_along_axis(m, np.maximum(ilo - 1,
                                                   0)[:, None],
                                     1)[:, 0],
                  vmin)
    hi = np.where(ihi + 1 < live,
                  np.take_along_axis(m, np.minimum(ihi + 1,
                                                   K - 1)[:, None],
                                     1)[:, 0],
                  vmax)
    lo = np.maximum(lo, vmin)
    hi = np.minimum(hi, vmax)
    est = np.clip(est, vmin, vmax)
    est = np.clip(est, lo, hi)
    return est, lo, hi


def _row_searchsorted(a: np.ndarray, v: np.ndarray) -> np.ndarray:
    """searchsorted(a[i], v[i], side='left') per row, vectorized:
    count of entries strictly below v (rows are monotone)."""
    return (a < v[:, None]).sum(axis=1)


def hll_error(p: int, estimate: float, nsigma: float = 3.0) -> float:
    """Absolute +-bound on an HLL cardinality estimate with 2^p
    registers (relative standard error 1.04/sqrt(m), at nsigma)."""
    m = 1 << int(p)
    return float(estimate) * nsigma * 1.04 / float(np.sqrt(m))


def dirty_rank_slack(clean_weight: float, stale_weight: float,
                     assumed_growth: float = 1.0) -> float:
    """Rank slack for serving STALE windows under degraded
    (rollup-only) mode: a dirty window's record reflects its last
    fold; up to ``assumed_growth`` * its recorded weight may have
    arrived since (plus the recorded values themselves may have been
    superseded). Every unseen/changed point can shift the target rank
    by at most 1, so slack = changeable / total, capped at 0.5
    (beyond that the enclosure is the full [min, max] anyway)."""
    total = clean_weight + stale_weight
    if total <= 0:
        return 0.5
    changeable = stale_weight * (1.0 + assumed_growth)
    return float(min(changeable / (total + stale_weight * assumed_growth),
                     0.5))
