"""Storyboard-style byte-budget allocation for sketch columns.

Mirrors ``opentsdb_tpu/sketch/budget.py`` of the JAX package, copied
whole: the rollup tier spends ``Config.sketch_byte_budget`` with
``allocate`` (``rollup/tier.py``), and ``tsdb sketch-plan``
(``tools/cli.py``) prints ``render_plan``'s table, byte for byte the JAX
CLI's.

The rollup tier used to apply ONE uniform rule — t-digest + HLL
columns at every resolution >= ``rollup_sketch_min_res`` — which
spends the same bytes per record whether a resolution serves one
dashboard a day or every percentile panel in the fleet. Storyboard
(arXiv:2002.03063) frames this properly: given a fixed summary-byte
budget and a query workload over precomputed windows, choose each
window class's summary kind/size to minimize expected error.

``allocate`` is that optimizer, reduced to the tier's shape: per
RESOLUTION (the tier's window classes), pick a rung on the upgrade
ladder none -> moment -> moment+digest(k ascending), by greedy
marginal utility (workload-weighted error reduction per byte) — the
classic knapsack heuristic, optimal here because rung error gains are
diminishing. Record-count estimates are quantized to powers of 4 so
day-to-day data drift doesn't flap the chosen layout (a layout change
rebuilds the tier — intended when the operator re-budgets, not every
morning).

Inputs come from two places: the TIER derives record estimates from
its raw store at open (deterministic given the same data order of
magnitude), and ``tsdb sketch-plan`` additionally folds in a measured
workload profile from the slow-query / trace ring.
"""

from __future__ import annotations

from typing import Iterable, NamedTuple

from opentsdb_tpu_torch.sketch.moment import MomentSketch

# Upgrade ladder: (digest_k, moment_k, rank-error proxy). Error
# proxies are the documented accuracy scales of each summary — the
# allocator only needs their ORDER and rough ratios: a k-centroid
# t-digest's mid-quantile rank error ~ 1/k (arXiv:1902.04023), a
# k=8 moment sketch's maxent estimate lands near percent-level on
# smooth data but its GUARANTEED Cantelli enclosure is wide, scored
# here between "nothing" and "small digest".
LADDER: tuple[tuple[int, int, float], ...] = (
    (0, 0, 0.50),        # no sketch columns: pNN at this res is raw
    (0, 8, 0.08),        # moment-only rung (tiny, exactly mergeable)
    (32, 8, 0.031),      # + small digest
    (64, 8, 0.016),      # + default digest
    (128, 8, 0.008),     # + wide digest
)


class ResAllocation(NamedTuple):
    res: int
    digest_k: int
    moment_k: int
    hll_p: int
    records: int          # estimated records at this resolution
    bytes_per_record: int
    total_bytes: int
    err_proxy: float


def record_bytes(digest_k: int, moment_k: int, hll_p: int) -> int:
    """Encoded sketch-cell bytes per record for a rung (summary.py
    sketch_encode: 4B header + 8B/centroid + HLL registers + moment
    section). HLL registers ride the DIGEST rungs only: a moment-only
    rung stays ~200 B (its whole point), and ranged /distinct serves
    presence-only there while distinct-VALUES estimates need a digest
    rung anyway."""
    if not digest_k and not moment_k:
        return 0
    n = 4 + 8 * digest_k + ((1 << hll_p) if (hll_p and digest_k)
                            else 0)
    if moment_k:
        n += 2 + MomentSketch.encoded_size(moment_k)
    return n


def quantize_records(n: int) -> int:
    """Round a record-count estimate up to a power of 4 (min 256):
    allocation inputs must be stable under ordinary data growth."""
    q = 256
    while q < n:
        q *= 4
    return q


def allocate(budget_bytes: int, records: dict[int, int],
             workload: dict[int, float] | None = None, *,
             hll_p: int = 8,
             ladder: Iterable[tuple[int, int, float]] = LADDER,
             ) -> dict[int, ResAllocation]:
    """Spend ``budget_bytes`` across resolutions.

    ``records``: estimated record count per resolution (quantized
    internally). ``workload``: relative query weight per resolution
    (defaults to uniform — every resolution equally likely to serve).
    Deterministic: ties break toward the finer resolution.
    """
    ladder = tuple(ladder)
    res_list = sorted(records)
    if not res_list:
        return {}
    recs = {r: quantize_records(int(records[r])) for r in res_list}
    if workload:
        wsum = sum(max(float(workload.get(r, 0.0)), 0.0)
                   for r in res_list) or 1.0
        weights = {r: max(float(workload.get(r, 0.0)), 0.0) / wsum
                   for r in res_list}
        # A resolution nobody queries still deserves epsilon weight:
        # workloads shift, and a zero weight would starve it forever.
        weights = {r: max(w, 0.01) for r, w in weights.items()}
    else:
        weights = {r: 1.0 / len(res_list) for r in res_list}

    level = {r: 0 for r in res_list}
    spent = 0

    def rung_cost(r: int, lvl: int) -> int:
        dk, mk, _ = ladder[lvl]
        return record_bytes(dk, mk, hll_p if (dk or mk) else 0) * recs[r]

    while True:
        best = None
        for r in res_list:
            lvl = level[r]
            if lvl + 1 >= len(ladder):
                continue
            delta = rung_cost(r, lvl + 1) - rung_cost(r, lvl)
            if spent + delta > budget_bytes:
                continue
            gain = weights[r] * (ladder[lvl][2] - ladder[lvl + 1][2])
            util = gain / max(delta, 1)
            if best is None or util > best[0] or (
                    util == best[0] and r < best[1]):
                best = (util, r, delta)
        if best is None:
            break
        _, r, delta = best
        level[r] += 1
        spent += delta

    out = {}
    for r in res_list:
        dk, mk, err = ladder[level[r]]
        hp = hll_p if dk else 0   # HLL rides the digest rungs only
        bpr = record_bytes(dk, mk, hp)
        out[r] = ResAllocation(r, dk, mk, hp, recs[r], bpr,
                               bpr * recs[r], err)
    return out


def workload_from_ring(records: list[dict],
                       resolutions: Iterable[int]) -> dict[int, float]:
    """Derive per-resolution query weights from trace-ring records
    (the slow-query / ambient-sample ring at /api/traces): each
    record's downsample interval maps to the coarsest resolution that
    nests into it — the resolution a sketch-served percentile of that
    query would read."""
    res = sorted(int(r) for r in resolutions)
    weights = {r: 0.0 for r in res}
    for rec in records:
        iv = _interval_of(rec)
        if iv is None:
            continue
        best = None
        for r in res:
            if r <= iv and iv % r == 0:
                best = r
        if best is not None:
            weights[best] += 1.0
    return weights


def _interval_of(rec: dict) -> int | None:
    """Downsample interval of one trace-ring record (from the 'm'
    query expression it stores)."""
    m = rec.get("m") or rec.get("query")
    if not isinstance(m, str):
        return None
    try:
        from opentsdb_tpu_torch.query.grammar import parse_m
        parsed = parse_m(m)
    except Exception:
        return None
    return parsed.downsample[0] if parsed.downsample else None


def render_plan(allocs: dict[int, ResAllocation],
                budget_bytes: int) -> str:
    """Human-readable allocation table (the ``tsdb sketch-plan``
    output)."""
    from opentsdb_tpu_torch.rollup.tier import res_label
    lines = [f"sketch byte budget: {budget_bytes:,} B",
             f"{'res':>6} {'records~':>10} {'digest_k':>8} "
             f"{'moment_k':>8} {'hll_p':>5} {'B/rec':>6} "
             f"{'total':>12} {'err~':>6}"]
    total = 0
    for r in sorted(allocs):
        a = allocs[r]
        total += a.total_bytes
        lines.append(
            f"{res_label(r):>6} {a.records:>10,} {a.digest_k:>8} "
            f"{a.moment_k:>8} {a.hll_p:>5} {a.bytes_per_record:>6} "
            f"{a.total_bytes:>12,} {a.err_proxy:>6.3f}")
    lines.append(f"planned total: {total:,} B "
                 f"({'within' if total <= budget_bytes else 'OVER'} "
                 f"budget)")
    return "\n".join(lines)
