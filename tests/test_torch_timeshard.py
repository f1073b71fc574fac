"""The port's time-sharded bodies (opentsdb_tpu_torch/parallel/
timeshard.py) and the carry arguments of its fill and rate kernels
against the JAX package's, on the same seeded numpy inputs.

The JAX side runs on its 8 virtual CPU devices; the port on
``Mesh(["cpu"] * D, "time")``. Both are also held against the
unsharded kernels of their own package (the time-sharded contract).

Tolerances: masks and emission grids exact; count / min / max of
order-free inputs exact; sums, averages, deviations, rates and lerped
values within rtol 1e-5 + 1e-5 x scale (the port's segment sums add in
another order than XLA's); the carry selections exact (they select).
"""

import numpy as np
import pytest
import torch

import jax

from opentsdb_tpu.ops import kernels as jk
from opentsdb_tpu.parallel import timeshard as jt
from opentsdb_tpu.parallel.mesh import TIME_AXIS
from opentsdb_tpu.parallel.mesh import make_mesh as jmake_mesh
from opentsdb_tpu_torch.ops import kernels as tk
from opentsdb_tpu_torch.parallel import timeshard as tt
from opentsdb_tpu_torch.parallel.mesh import Mesh

BPS, INTERVAL = 6, 60


def close(got, want, exact=False):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape
    if exact:
        np.testing.assert_array_equal(got, want)
        return
    fin = np.isfinite(want)
    scale = float(np.abs(want[fin]).max()) if fin.any() else 1.0
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5 * scale)


def meshes(D):
    return (jmake_mesh(D, axis=TIME_AXIS, devices=jax.devices("cpu")),
            Mesh(["cpu"] * D, TIME_AXIS))


def workload(D, num_series, n_points, seed):
    """Seeded points over D tiles. Series 0 lives only in the first and
    last tile (a gap spanning every tile between); series 1 only in tile
    1 (absent from all others); the rest at random."""
    span = D * BPS * INTERVAL
    rng = np.random.default_rng(seed)
    ts = rng.integers(0, span, n_points)
    sid = rng.integers(2, num_series, n_points)
    extra_ts = [5, span - 7]
    extra_sid = [0, 0]
    if D > 1:
        extra_ts += [BPS * INTERVAL + 3, BPS * INTERVAL + 130]
        extra_sid += [1, 1]
    ts = np.concatenate([ts, extra_ts]).astype(np.int32)
    sid = np.concatenate([sid, extra_sid]).astype(np.int32)
    vals = rng.normal(50.0, 5.0, len(ts)).astype(np.float32)
    # Deduplicate (sid, ts): the rate bodies want one point a timestamp.
    _, keep = np.unique(np.stack([sid, ts]), axis=1, return_index=True)
    return ts[keep], vals[keep], sid[keep]


RATE_MODES = {
    "none": dict(rate=False),
    "rate": dict(rate=True),
    "counter": dict(rate=True, counter=True, counter_max=100.0,
                    drop_resets=True, reset_value=0.5),
}


@pytest.mark.parametrize("D", [1, 2, 4, 8])
@pytest.mark.parametrize("mode", sorted(RATE_MODES))
@pytest.mark.parametrize("agg_down,agg_group,quantile", [
    ("avg", "sum", None), ("sum", "avg", None), ("max", "dev", None),
    ("min", "count", None), ("avg", "zimsum", None),
    ("max", "mimmax", None), ("avg", "count", 0.9)])
def test_group_body(D, mode, agg_down, agg_group, quantile):
    S = 16
    ts, vals, sid = workload(D, 11, 400, seed=D * 7 + len(mode))
    packed = jt.pack_time_shards(ts, vals, sid, D, INTERVAL, BPS)
    np.testing.assert_array_equal(
        np.concatenate(tt.pack_time_shards(ts, vals, sid, D, INTERVAL,
                                           BPS)),
        np.concatenate(packed))
    jm, tm = meshes(D)
    kw = dict(num_series=S, buckets_per_shard=BPS, interval=INTERVAL,
              agg_down=agg_down, agg_group=agg_group, quantile=quantile,
              **RATE_MODES[mode])
    jv, jmask = jt.timeshard_downsample_group(*packed, mesh=jm, **kw)
    tv, tmask = tt.timeshard_downsample_group(*packed, mesh=tm, **kw)
    np.testing.assert_array_equal(tmask.numpy(), np.asarray(jmask))
    close(tv.numpy(), np.asarray(jv),
          exact=agg_group in ("count", "mimmax") and mode == "none"
          and quantile is None and agg_down in ("min", "max"))
    # The port's tiles equal its own unsharded kernel.
    valid = torch.ones(len(ts), dtype=torch.bool)
    ref = tk.downsample_group(
        torch.from_numpy(ts), torch.from_numpy(vals),
        torch.from_numpy(sid), valid, num_series=S,
        num_buckets=D * BPS, interval=INTERVAL, agg_down=agg_down,
        agg_group=agg_group if quantile is None else "count",
        **RATE_MODES[mode])
    np.testing.assert_array_equal(tmask.numpy(),
                                  ref["group_mask"].numpy())
    if quantile is None:
        close(tv.numpy(), ref["group_values"].numpy())


@pytest.mark.parametrize("D", [1, 2, 4, 8])
@pytest.mark.parametrize("mode", sorted(RATE_MODES))
def test_rate_body(D, mode):
    ts, vals, sid = workload(D, 9, 300, seed=40 + D)
    packed = jt.pack_time_shards(ts, vals, sid, D, INTERVAL, BPS)
    jm, tm = meshes(D)
    kw = {k: v for k, v in RATE_MODES[mode].items() if k != "rate"}
    jr, jok = jt.timeshard_rate(*packed, mesh=jm, num_series=9, **kw)
    tr, tok = tt.timeshard_rate(*packed, mesh=tm, num_series=9, **kw)
    np.testing.assert_array_equal(tok.numpy(), np.asarray(jok))
    close(tr.numpy(), np.asarray(jr))
    # Against the port's unsharded flat_rate over the sorted points.
    order = np.lexsort((ts, sid))
    r1, ok1 = tk.flat_rate(
        torch.from_numpy(ts[order]), torch.from_numpy(vals[order]),
        torch.from_numpy(sid[order]), torch.ones(len(ts), dtype=torch.bool),
        **kw)
    valid = packed[3]
    got = {(int(s), int(t)): (float(r), bool(o)) for s, t, r, o, v in zip(
        packed[2].ravel(), packed[0].ravel(), tr.numpy().ravel(),
        tok.numpy().ravel(), valid.ravel()) if v}
    for s, t, r, o in zip(sid[order], ts[order], r1.numpy(), ok1.numpy()):
        gr, go = got[(int(s), int(t))]
        assert go == bool(o)
        if o:
            assert abs(gr - float(r)) <= 1e-5 * max(1.0, abs(float(r)))


# ---------------------------------------------------------------------------
# The four carry signatures
# ---------------------------------------------------------------------------

def _grid(seed, S=9, B=12):
    rng = np.random.default_rng(seed)
    sv = rng.normal(3, 2, (S, B)).astype(np.float32)
    sm = rng.random((S, B)) < 0.35
    sm[0] = False                       # a series empty on this tile
    left_idx = rng.integers(-1, 40, S).astype(np.int32)
    left_val = rng.normal(0, 5, S).astype(np.float32)
    right_idx = np.where(rng.random(S) < 0.3, 2**31 - 1,
                         rng.integers(100, 140, S)).astype(np.int32)
    right_val = rng.normal(0, 5, S).astype(np.float32)
    return sv, sm, left_idx, left_val, right_idx, right_val


def T(x):
    return torch.from_numpy(np.asarray(x))


@pytest.mark.parametrize("seed", range(4))
def test_gap_fill_carries(seed):
    sv, sm, li, lv, ri, rv = _grid(seed)
    jf, jr = jk.gap_fill(sv, sm, 12, glob_offset=48, left_idx=li,
                         left_val=lv, right_idx=ri, right_val=rv)
    tf, tr = tk.gap_fill(T(sv), T(sm), 12, glob_offset=48, left_idx=T(li),
                         left_val=T(lv), right_idx=T(ri), right_val=T(rv))
    np.testing.assert_array_equal(tr.numpy(), np.asarray(jr))
    close(tf.numpy(), np.asarray(jf))
    # Without carries: exactly the single-device fill.
    a, am = tk.gap_fill(T(sv), T(sm), 12)
    b, bm = jk.gap_fill(sv, sm, 12)
    np.testing.assert_array_equal(am.numpy(), np.asarray(bm))
    close(a.numpy(), np.asarray(b))


@pytest.mark.parametrize("seed", range(4))
def test_step_fill_carries(seed):
    sv, sm, li, lv, ri, _ = _grid(seed)
    jf, jr = jk.step_fill(sv, sm, 12, left_idx=li, left_val=lv,
                          right_idx=ri)
    tf, tr = tk.step_fill(T(sv), T(sm), 12, left_idx=T(li),
                          left_val=T(lv), right_idx=T(ri))
    np.testing.assert_array_equal(tr.numpy(), np.asarray(jr))
    np.testing.assert_array_equal(tf.numpy(), np.asarray(jf))


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("counter", [False, True])
def test_bucket_rate_carries(seed, counter):
    sv, sm, li, lv, _, _ = _grid(seed)
    kw = dict(counter=counter, drop_resets=counter)
    jr, jo = jk.bucket_rate(sv, sm, INTERVAL, 50.0, 0.2, glob_offset=48,
                            left_idx=li, left_val=lv, **kw)
    tr, to = tk.bucket_rate(T(sv), T(sm), INTERVAL, 50.0, 0.2,
                            glob_offset=48, left_idx=T(li),
                            left_val=T(lv), **kw)
    np.testing.assert_array_equal(to.numpy(), np.asarray(jo))
    close(tr.numpy(), np.asarray(jr))


@pytest.mark.parametrize("seed", range(4))
def test_flat_rate_carries(seed):
    rng = np.random.default_rng(seed)
    n = 64
    sid = np.sort(rng.integers(0, 5, n)).astype(np.int32)
    ts = (np.arange(n) * 7 + rng.integers(0, 3, n)).astype(np.int32)
    vals = rng.normal(10, 4, n).astype(np.float32)
    valid = rng.random(n) < 0.9
    use = rng.random(n) < 0.2
    cts = (ts - rng.integers(1, 50, n)).astype(np.int32)
    cval = rng.normal(10, 4, n).astype(np.float32)
    jr, jo = jk._flat_rate(ts, vals, sid, valid, 100.0, 0.7, counter=True,
                           drop_resets=True, carry_ts=cts, carry_val=cval,
                           use_carry=use)
    tr, to = tk.flat_rate(T(ts), T(vals), T(sid), T(valid), 100.0, 0.7,
                           counter=True, drop_resets=True,
                           carry_ts=T(cts), carry_val=T(cval),
                           use_carry=T(use))
    np.testing.assert_array_equal(to.numpy(), np.asarray(jo))
    close(tr.numpy(), np.asarray(jr))
