"""The fused dashboard-shard finish (opentsdb_tpu_torch/ops/expert_finish.py
``dash_finish``, its plain version on the CPU) against the JAX package's
composition it replaces, slot by slot: ``_dash_series_stage``
(``opentsdb_tpu/parallel/expert.py``), then ``gap_fill``, then for a
moment shard ``group_moments`` and ``_finish_switch``
(``moment_slot``), for a percentile shard nothing more (``pct_slot``
up to its select).

Both sides start from the same segment moments: JAX's
``_segment_moments`` over the slot's points, segmented as
``_dash_series_stage`` does, is the JAX series stage's own input and,
stacked as [Q, S * B] strided views (count and sum interleaved, as one
stacked segment sum leaves them), the port's. The port's own series
stage (``parallel/expert.py`` ``_dash_series_stage``) is held against
those planes too.

Inputs are seeded numpy: series with 0, 1, 2 and many non-empty
buckets, a slot with NaN and +-inf values, an all-empty slot, every
downsampler x group aggregator code pair. Tolerances: filled, in_range,
the series and group masks, counts, min and max exact (NaN in the same
places); sums, averages and deviations within rtol 1e-5 + 1e-5 x scale
(torch and XLA sum over the series in other orders). A slot downsampled
by dev holds its filled values, min and max within rtol 1e-6, as the
per-cell finish's test holds dev: torch's vectorised CPU square root is
not correctly rounded (XLA's and CUDA's are), so its series values may
differ from JAX's by an ulp; its in_range and counts stay exact.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from opentsdb_tpu.ops import kernels as jk
from opentsdb_tpu.parallel import expert as jx
from opentsdb_tpu_torch.ops import expert_finish as ef
from opentsdb_tpu_torch.parallel import expert as tx

INTERVAL = 60
SHAPES = [(1, 1), (3, 7), (16, 32), (5, 33), (64, 256)]
DS = list(range(6))          # slot q of the clean slots: downsampler q
CLEAN = len(DS)              # then the NaN / inf slot, the empty slot
DEV, COUNT = ef.DASH_AGGS.index("dev"), ef.DASH_AGGS.index("count")


def _slot_points(rng, S, B, kind):
    """One slot's points: series s takes 0, 1, 2 or many non-empty
    buckets by s % 4 (a one-series grid takes many); ``kind`` "special"
    adds NaN and +-inf values, "empty" marks every point invalid."""
    ts, vals, sid = [], [], []
    for s in range(S):
        shape = 3 if S == 1 else s % 4
        if shape == 0:
            continue
        buckets = (rng.choice(B, size=min(shape, B), replace=False)
                   if shape < 3 else
                   np.flatnonzero(rng.random(B) < 0.6))
        for b in buckets:
            k = int(rng.integers(1, 4))
            ts += list(b * INTERVAL + rng.integers(0, INTERVAL, k))
            vals += list(rng.normal(50.0, 12.0, k))
            sid += [s] * k
    ts = np.asarray(ts, np.int32)
    vals = np.asarray(vals, np.float32)
    sid = np.asarray(sid, np.int32)
    if kind == "special" and len(vals):
        vals[::7] = np.nan
        vals[3::11] = np.inf
        vals[5::13] = -np.inf
    valid = np.full(len(ts), kind != "empty")
    return ts, vals, sid, valid


def _case(S, B, seed):
    rng = np.random.default_rng(seed)
    kinds = ["clean"] * CLEAN + ["special", "empty"]
    slots = [_slot_points(rng, S, B, k) for k in kinds]
    n = max(1, max(len(p[0]) for p in slots))
    Q = len(slots)
    ts = np.zeros((Q, n), np.int32)
    vals = np.zeros((Q, n), np.float32)
    sid = np.zeros((Q, n), np.int32)
    valid = np.zeros((Q, n), bool)
    for q, (t, v, s, m) in enumerate(slots):
        ts[q, :len(t)], vals[q, :len(t)] = t, v
        sid[q, :len(t)], valid[q, :len(t)] = s, m
    return ts, vals, sid, valid


def _jax_planes(ts, vals, sid, valid, S, B):
    """JAX's segment moments of each slot, as _dash_series_stage
    segments them: [Q, S * B] numpy each (count, total, m2, min, max)."""
    nseg = S * B + 1
    out = []
    for q in range(ts.shape[0]):
        bucket = np.clip(ts[q] // INTERVAL, 0, B - 1)
        seg = np.where(valid[q], sid[q] * B + bucket, nseg - 1)
        out.append([np.asarray(x)[:-1] for x in jk._segment_moments(
            jnp.asarray(vals[q]), jnp.asarray(seg, jnp.int32),
            jnp.asarray(valid[q]), nseg)])
    return [np.stack([o[i] for o in out]) for i in range(5)]


def _port_planes(planes):
    """The planes as the port's series stage leaves them: [Q, S * B]
    views of a segment space with a trash column a slot, count and sum
    interleaved in one [Q * span, 2] array."""
    Q, cells = planes[0].shape
    span = cells + 1
    sums = torch.zeros((Q * span, 2), dtype=torch.float32)
    sums[:, 0].view(Q, span)[:, :-1] = torch.from_numpy(planes[0])
    sums[:, 1].view(Q, span)[:, :-1] = torch.from_numpy(planes[1])
    views = [sums[:, 0].reshape(Q, span)[:, :-1],
             sums[:, 1].reshape(Q, span)[:, :-1]]
    for x in planes[2:]:
        full = torch.zeros((Q * span, 1), dtype=torch.float32)
        full[:, 0].view(Q, span)[:, :-1] = torch.from_numpy(x)
        views.append(full[:, 0].reshape(Q, span)[:, :-1])
    return views


def _codes(r):
    """Downsamplers (each code on a clean slot, then two more) and the
    group aggregators rotated by r, so six r cover every pair."""
    ds = DS + [r, (r + 2) % 6]
    agg = [(q + r) % 6 for q in range(len(ds))]
    return ds, agg


def _exact(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    fin = ~np.isnan(want)
    np.testing.assert_array_equal(got[fin], want[fin])


def _near(got, want):
    got, want = np.asarray(got), np.asarray(want)
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_allclose(got, want, rtol=1e-6)


def _close(got, want):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    fin = np.isfinite(want)
    scale = float(np.abs(want[fin]).max()) if fin.any() else 1.0
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5 * scale)


def _jax_slot(ts, vals, sid, valid, ds, S, B):
    sv, sm = jx._dash_series_stage(
        jnp.asarray(ts), jnp.asarray(vals), jnp.asarray(sid),
        jnp.asarray(valid), jnp.int32(ds), num_series=S, num_buckets=B,
        interval=INTERVAL)
    filled, in_range = jk.gap_fill(sv, sm, B)
    return filled, in_range, sm


@pytest.mark.parametrize("r", range(6))
@pytest.mark.parametrize("S,B", SHAPES)
def test_moment_shard_matches_jax_composition(S, B, r):
    ts, vals, sid, valid = _case(S, B, seed=S * 1000 + B * 10 + r)
    ds, agg = _codes(r)
    planes = _jax_planes(ts, vals, sid, valid, S, B)
    gv, gm = ef.dash_finish(*_port_planes(planes), ds, agg, num_series=S,
                            num_buckets=B)
    assert gv.shape == gm.shape == (len(ds), B)
    assert gm.dtype == torch.bool
    for q in range(len(ds)):
        filled, in_range, sm = _jax_slot(ts[q], vals[q], sid[q], valid[q],
                                         ds[q], S, B)
        g_n, g_total, g_m2, _, g_mn, g_mx = jk.group_moments(filled,
                                                            in_range)
        want = np.asarray(jx._finish_switch(
            jnp.int32(agg[q]), (g_n, g_total, g_m2, g_mn, g_mx)))
        _exact(gm[q].numpy(), np.asarray(sm.any(axis=0)))
        exact = _near if ds[q] == DEV and agg[q] != COUNT else _exact
        if ef.DASH_AGGS[agg[q]] in ("min", "max", "count"):
            exact(gv[q].numpy(), want)
        else:
            _close(gv[q].numpy(), want)
    assert not gm[CLEAN + 1].any()       # the all-empty slot
    assert (gv[CLEAN + 1] == torch.where(
        torch.tensor(agg[CLEAN + 1]) == 1, torch.inf,
        torch.where(torch.tensor(agg[CLEAN + 1]) == 2, -torch.inf,
                    0.0))).all()


@pytest.mark.parametrize("S,B", SHAPES)
def test_percentile_shard_fill_matches_jax_composition(S, B):
    ts, vals, sid, valid = _case(S, B, seed=S * 1000 + B * 10 + 7)
    ds, _ = _codes(3)
    planes = _jax_planes(ts, vals, sid, valid, S, B)
    filled, in_range, gm = ef.dash_finish(*_port_planes(planes), ds,
                                          num_series=S, num_buckets=B)
    assert filled.shape == in_range.shape == (len(ds), S, B)
    for q in range(len(ds)):
        w_filled, w_in, sm = _jax_slot(ts[q], vals[q], sid[q], valid[q],
                                       ds[q], S, B)
        exact = _near if ds[q] == DEV else _exact
        exact(filled[q].numpy(), np.asarray(w_filled))
        _exact(in_range[q].numpy(), np.asarray(w_in))
        _exact(gm[q].numpy(), np.asarray(sm.any(axis=0)))
    # Series of 0 and 1 non-empty buckets fill nothing around them.
    if S > 2:
        assert not in_range[0, 0].any()
        assert int(in_range[0, 1].sum()) == int(
            (planes[0][0].reshape(S, B)[1] > 0).sum()) == 1


@pytest.mark.parametrize("S,B", [(3, 7), (16, 32)])
def test_port_series_stage_feeds_the_same_planes(S, B):
    """The port's stacked series stage gives JAX's per-slot segment
    moments (count, min, max exact; sums at tolerance) as the strided
    views dash_finish reads, and the body's answer through them equals
    the answer through JAX's planes at the sums' tolerance."""
    ts, vals, sid, valid = _case(S, B, seed=5)
    ds, agg = _codes(1)
    want = _jax_planes(ts, vals, sid, valid, S, B)
    got = tx._dash_series_stage(
        *(torch.from_numpy(x) for x in (ts, vals, sid, valid)), ds,
        num_series=S, num_buckets=B, interval=INTERVAL)
    for name, g, w in zip(ef.PLANES, got, want):
        if g is None:
            assert name not in ef.dash_needs(ds) and name != "m2"
            continue
        assert g.shape == w.shape and not g.is_contiguous()
        if name in ("count", "min", "max"):
            _exact(g.numpy(), w)
        else:
            _close(g.numpy(), w)
    a = ef.dash_finish(*got, ds, agg, num_series=S, num_buckets=B)
    b = ef.dash_finish(*_port_planes(want), ds, agg, num_series=S,
                       num_buckets=B)
    _exact(a[1].numpy(), b[1].numpy())
    _close(a[0].numpy(), b[0].numpy())


def test_dash_finish_checks_its_arguments():
    planes = [torch.zeros((2, 12)) for _ in range(5)]
    kw = dict(num_series=3, num_buckets=4)
    with pytest.raises(ValueError, match="needs"):
        ef.dash_finish(None, *planes[1:], [0, 0], [0, 0], **kw)
    with pytest.raises(ValueError, match="group aggregators"):
        ef.dash_finish(*planes, [0, 0], [0], **kw)
    with pytest.raises(ValueError, match="codes"):
        ef.dash_finish(*planes, [0, 6], **kw)
    with pytest.raises(ValueError, match="S \\* B"):
        ef.dash_finish(*planes, [0, 0], num_series=2, num_buckets=4)
    with pytest.raises(ValueError, match="at most"):
        ef.dash_finish(*planes, [0] * (ef.MAX_SLOTS + 1), **kw)
    with pytest.raises(ValueError, match="2\\^31"):
        ef.dash_finish(*planes, [0, 0], num_series=2**16, num_buckets=2**15)
    # A plane no downsampler reads may be absent: count alone for count.
    gv, gm = ef.dash_finish(planes[0], None, None, None, None, [5, 5],
                            [0, 0], **kw)
    assert gv.shape == (2, 4) and not gm.any()
    assert ef.dash_bytes([3, 5], False, 3, 4) == \
        4 * 12 * 2 + 5 * 4 + 4 * 12 + 5 * 4 + 16
    assert ef.dash_bytes([0], True, 3, 4) == 4 * 12 * 2 + 5 * 12 + 4 + 8
