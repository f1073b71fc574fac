"""The port's mesh execution plane and series-sharded bodies
(opentsdb_tpu_torch/parallel/) against the JAX package's
(opentsdb_tpu/parallel/) on the same seeded numpy inputs.

The JAX side runs on its 8 virtual CPU devices (tests/conftest.py); the
port runs on ``Mesh(["cpu"] * D)``, D logical shards in one process.

Tolerances: counts, min, max, masks, emission grids, HLL estimates and
the window fold's count / min / max / first / last / timestamp planes
exact; sums, averages and deviations within rtol 1e-5 + 1e-5 x scale
(scale = the largest magnitude of the expected grid), because the port
sums shards in shard order where XLA's psum takes its own; percentiles
exact (rank selections of the same contributions) up to the lerp
between two ranks, held at the same float tolerance; t-digest
quantiles within 1e-3 of the value range (two digest builds). The
plane's cache counters equal JAX's over the same call sequence.
"""

import numpy as np
import pytest
import torch

import jax

from opentsdb_tpu.parallel import compile as jcompile
from opentsdb_tpu.parallel import sharded as js
from opentsdb_tpu.parallel.mesh import make_mesh as jmake_mesh
from opentsdb_tpu.parallel.plan import ExecPlan as JExecPlan
from opentsdb_tpu_torch.parallel import compile as tcompile
from opentsdb_tpu_torch.parallel import sharded as ts_
from opentsdb_tpu_torch.parallel.mesh import Mesh, make_mesh
from opentsdb_tpu_torch.parallel.plan import (ExecPlan, build_mesh,
                                              flatten_series_mesh)

INTERVAL, NB = 60, 32
MOMENT_AGGS = ("sum", "avg", "dev", "count", "min", "max", "zimsum",
               "mimmin", "mimmax")
EXACT_AGGS = ("count", "min", "max", "mimmin", "mimmax")
RATE_MODES = {
    "none": dict(rate=False),
    "rate": dict(rate=True),
    "counter": dict(rate=True, counter=True, counter_max=100.0,
                    drop_resets=True, reset_value=0.5),
}


def jmesh(d):
    return jmake_mesh(d, devices=jax.devices("cpu"))


def tmesh(d):
    return Mesh(["cpu"] * d)


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


def series_set(n, seed, gaps=True):
    """n seeded series of ts offsets in [0, NB * INTERVAL) and values;
    with ``gaps`` some series skip whole runs of buckets."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        k = int(rng.integers(5, 60))
        ts = np.sort(rng.choice(NB * INTERVAL, k, replace=False))
        if gaps and i % 3 == 0:
            ts = ts[(ts < 8 * INTERVAL) | (ts > 20 * INTERVAL)]
        vals = rng.normal(20, 6, len(ts)).astype(np.float32)
        out.append((ts.astype(np.int64), vals))
    return out


def packed(series, d):
    return js.pack_shards(series, d)


def pad16(n):
    size = 16
    while size < n:
        size *= 2
    return size


# ---------------------------------------------------------------------------
# The plane
# ---------------------------------------------------------------------------

def _cache_delta(mod, fn):
    info0 = mod.cache_info()
    fn()
    info1 = mod.cache_info()
    return tuple(info1[k] - info0[k] for k in ("size", "hit", "miss"))


def test_plan_cache_counts_equal_jax():
    series = series_set(8, 3)

    def seq(sh, compile_mod, mk_plan, mesh):
        def body(x, *, k=1):
            return x

        def run():
            plan = mk_plan(name="test.port.body")
            compile_mod.compile_with_plan(body, plan)
            compile_mod.compile_with_plan(body, plan)
            compile_mod.compile_with_plan(body, plan, statics=(("k", 2),))
            ts, vals, sid, valid, sps = sh.pack_shards(series, 4)
            for agg in ("sum", "sum", "avg"):
                for cmax in (2.0 ** 32, 123.0, 456.5):
                    sh.sharded_downsample_group(
                        ts, vals, sid, valid, mesh=mesh,
                        series_per_shard=sps, num_buckets=NB,
                        interval=INTERVAL, agg_down="avg", agg_group=agg,
                        rate=True, counter=True, counter_max=cmax)
        return run

    jcompile.clear_cache()
    tcompile.clear_cache()
    want = _cache_delta(jcompile, seq(js, jcompile, JExecPlan, jmesh(4)))
    got = _cache_delta(tcompile, seq(ts_, tcompile, ExecPlan, tmesh(4)))
    assert got == want
    # Distinct counterMax values reuse one dispatcher: 2 (bodies) + 2
    # (aggregators), nine group calls.
    assert got[0] == 4


def test_dispatch_and_registry_names():
    from opentsdb_tpu_torch.obs.registry import METRICS
    names = METRICS.names()
    for n in ("mesh.compile", "mesh.dispatch", "mesh.cache.hit",
              "mesh.cache.miss", "mesh.cache.size", "mesh.devices"):
        assert n in names
    before = tcompile._M_DISPATCH.count
    ts, vals, sid, valid, sps = ts_.pack_shards(series_set(4, 1), 2)
    ts_.sharded_downsample_group(
        ts, vals, sid, valid, mesh=tmesh(2), series_per_shard=sps,
        num_buckets=NB, interval=INTERVAL, agg_down="sum",
        agg_group="sum")
    assert tcompile._M_DISPATCH.count == before + 1


def test_build_mesh_shapes_and_errors():
    m = build_mesh("4", device="cpu")
    assert m.devices.size == 4 and m.axis_names == ("series",)
    assert all(d.type == "cpu" for d in m.devices)
    assert flatten_series_mesh(m) is m
    assert build_mesh("2", devices=["cpu", "cpu", "cpu"]).size == 2
    for bad in ("", "0", "-1"):
        with pytest.raises(ValueError):
            build_mesh(bad, device="cpu")
    # "RxC" folds R x C logical shards into the hybrid (host, series)
    # mesh (tests/test_torch_multihost.py holds it against JAX's).
    hybrid = build_mesh("2x4", device="cpu")
    assert hybrid.axis_names == ("host", "series")
    assert hybrid.devices.shape == (2, 4)
    assert flatten_series_mesh(hybrid).axis_names == ("series",)
    with pytest.raises(ValueError, match="needs 3 devices"):
        build_mesh("3", devices=["cpu", "cpu"])
    with pytest.raises(ValueError):
        make_mesh(5, devices=["cpu"] * 4)
    # A CUDA mesh past the cards of this process raises at boot.
    if not torch.cuda.is_available():
        with pytest.raises(ValueError, match="needs 1 devices, have 0"):
            build_mesh("1", device="cuda")
    # Hashable and equal by value: a plan-cache key component.
    assert Mesh(["cpu"] * 2) == Mesh(["cpu", "cpu"])
    assert len({Mesh(["cpu"] * 2), Mesh(["cpu"] * 2)}) == 1


def _port_collectives(x, *, axis_index):
    s = yield tcompile.psum(x)
    mn = yield tcompile.pmin(x)
    mx = yield tcompile.pmax(x)
    g = yield tcompile.all_gather(x)
    return s, mn, mx, g


def _jax_collectives(x):
    from opentsdb_tpu.parallel.mesh import SERIES_AXIS as AX
    x = x[0]
    return tuple(v[None] for v in (
        jax.lax.psum(x, AX), jax.lax.pmin(x, AX), jax.lax.pmax(x, AX),
        jax.lax.all_gather(x, AX)))


@pytest.mark.parametrize("D", [1, 2, 4, 8])
def test_plane_collectives_match_jax(D):
    """psum / pmin / pmax / all_gather of a mesh body against JAX's in a
    shard_map body, on integer-valued floats (so every sum order is
    exact); each shard gets the same replicated result."""
    from jax.sharding import PartitionSpec as P
    rng = np.random.default_rng(D)
    x = rng.integers(-1000, 1000, (D, 37)).astype(np.float32)
    jplan = JExecPlan(name="test.collectives", axis="series",
                      style="shard_map", in_specs=(P("series"),),
                      out_specs=(P("series"),) * 4)
    want = [np.asarray(v)[0] for v in jcompile.compile_with_plan(
        _jax_collectives, jplan, jmesh(D))(x)]
    tplan = ExecPlan(name="test.collectives", axis="series",
                     style="shard_map", in_specs=("series",),
                     out_specs=(None,) * 4)
    got = tcompile.compile_with_plan(_port_collectives, tplan, tmesh(D))(x)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), w)


@pytest.mark.parametrize("kw", [dict(axis="rows"), dict(style="pmap")])
def test_plan_validation_matches_jax(kw):
    with pytest.raises(ValueError) as je:
        JExecPlan(name="p", **kw)
    with pytest.raises(ValueError) as te:
        ExecPlan(name="p", **kw)
    assert str(te.value) == str(je.value)


# ---------------------------------------------------------------------------
# Series-sharded bodies against JAX
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("D", [1, 2, 4, 8])
@pytest.mark.parametrize("mode", sorted(RATE_MODES))
@pytest.mark.parametrize("agg", MOMENT_AGGS)
def test_group_body(D, mode, agg):
    series = series_set(11, 10 + D)
    ts, vals, sid, valid, sps = packed(series, D)
    kw = dict(series_per_shard=pad16(sps), num_buckets=NB,
              interval=INTERVAL, agg_down="avg", agg_group=agg,
              **RATE_MODES[mode])
    jv, jm = js.sharded_downsample_group(ts, vals, sid, valid,
                                         mesh=jmesh(D), **kw)
    tv, tm = ts_.sharded_downsample_group(ts, vals, sid, valid,
                                          mesh=tmesh(D), **kw)
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
    # avg buckets add in another order, so only the count is exact.
    close(tv.numpy(), np.asarray(jv), exact=agg == "count")


@pytest.mark.parametrize("D", [1, 2, 4, 8])
@pytest.mark.parametrize("mode", sorted(RATE_MODES))
@pytest.mark.parametrize("q", [0.5, 0.95])
def test_quantile_body(D, mode, q):
    series = series_set(13, 30 + D)
    ts, vals, sid, valid, sps = packed(series, D)
    kw = dict(series_per_shard=pad16(sps), num_buckets=NB,
              interval=INTERVAL, agg_down="sum", **RATE_MODES[mode])
    qa = np.array([q], np.float32)
    jv, jm = js.sharded_downsample_quantile(ts, vals, sid, valid, qa,
                                            mesh=jmesh(D), **kw)
    tv, tm = ts_.sharded_downsample_quantile(ts, vals, sid, valid, qa,
                                             mesh=tmesh(D), **kw)
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
    close(tv.numpy(), np.asarray(jv))


def _groups(n_series, n_groups, D):
    gmap_global = np.arange(n_series) % n_groups
    return gmap_global


def _shard_gmap(gmap_global, D, sps_pad, G):
    gmap = np.full((D, sps_pad), G - 1, np.int32)
    for (d, local), g in zip(js.shard_placement(len(gmap_global), D),
                             gmap_global):
        gmap[d, local] = g
    return gmap


# test_multigroup_body's grid (108 cases) runs in three parts, one rate
# mode a file (this one "counter", tests/test_torch_mesh_multigroup_
# {none,rate}.py the others), so that the tier-1 run's workers share it.
@pytest.mark.parametrize("D", [1, 2, 4, 8])
@pytest.mark.parametrize("mode", ["counter"])
@pytest.mark.parametrize("agg", MOMENT_AGGS)
def test_multigroup_body(D, mode, agg):
    check_multigroup_body(D, mode, agg)


def check_multigroup_body(D, mode, agg):
    """One case: the sharded multigroup body of both packages at width
    D."""
    # Groups split across shards: 21 series round-robin, 5 groups.
    series = series_set(21, 50 + D)
    ts, vals, sid, valid, sps = packed(series, D)
    G = 16
    gmap = _shard_gmap(_groups(21, 5, D), D, pad16(sps), G)
    kw = dict(series_per_shard=pad16(sps), num_groups=G, num_buckets=NB,
              interval=INTERVAL, agg_down="max", agg_group=agg,
              **RATE_MODES[mode])
    jv, jm = js.sharded_downsample_multigroup(ts, vals, sid, valid, gmap,
                                              mesh=jmesh(D), **kw)
    tv, tm = ts_.sharded_downsample_multigroup(ts, vals, sid, valid, gmap,
                                               mesh=tmesh(D), **kw)
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
    # max buckets are order-free: with no rate and no lerp the
    # no-interpolation min / max pick the same floats.
    close(tv.numpy(), np.asarray(jv), exact=agg == "count" or (
        agg in EXACT_AGGS and agg.startswith("mim") and mode == "none"))


@pytest.mark.parametrize("D", [1, 2, 4, 8])
@pytest.mark.parametrize("mode", sorted(RATE_MODES))
def test_multigroup_quantile_body(D, mode):
    series = series_set(19, 70 + D)
    ts, vals, sid, valid, sps = packed(series, D)
    G = 16
    gmap = _shard_gmap(_groups(19, 4, D), D, pad16(sps), G)
    kw = dict(series_per_shard=pad16(sps), num_groups=G, num_buckets=NB,
              interval=INTERVAL, agg_down="avg", **RATE_MODES[mode])
    qa = np.array([0.9], np.float32)
    jv, jm = js.sharded_downsample_multigroup_quantile(
        ts, vals, sid, valid, gmap, qa, mesh=jmesh(D), **kw)
    tv, tm = ts_.sharded_downsample_multigroup_quantile(
        ts, vals, sid, valid, gmap, qa, mesh=tmesh(D), **kw)
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
    close(tv.numpy(), np.asarray(jv))


@pytest.mark.parametrize("D", [1, 4, 8])
def test_hll_distinct(D):
    rng = np.random.default_rng(D)
    items = rng.integers(0, 5000, (D, 700)).astype(np.int32)
    valid = rng.random((D, 700)) < 0.9
    want = float(js.sharded_hll_distinct(items, valid, mesh=jmesh(D),
                                         p=12))
    got = float(ts_.sharded_hll_distinct(items, valid, mesh=tmesh(D),
                                         p=12))
    assert got == want


@pytest.mark.parametrize("D", [1, 4, 8])
def test_tdigest(D):
    rng = np.random.default_rng(100 + D)
    vals = rng.normal(0, 10, (D, 900)).astype(np.float32)
    valid = rng.random((D, 900)) < 0.95
    qs = [0.05, 0.5, 0.95]
    want = np.asarray(js.sharded_tdigest(vals, valid, qs, mesh=jmesh(D)))
    got = ts_.sharded_tdigest(vals, valid, qs, mesh=tmesh(D)).numpy()
    span = float(vals[valid].max() - vals[valid].min())
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-3 * span)


# ---------------------------------------------------------------------------
# The window fold
# ---------------------------------------------------------------------------

def _fold_series(n, seed, res, long_span=False):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        if i == 3:
            out.append((np.empty(0, np.int64), np.empty(0, np.float32)))
            continue
        k = int(rng.integers(1, 80))
        hi = (2**25 + 7 * res) if long_span else 9 * res
        ts = np.sort(rng.choice(hi, k, replace=False)).astype(np.int64)
        out.append((ts, rng.normal(5, 2, k).astype(np.float32)))
    return out


def _fold_grids(mod, mesh, series, D, res, W):
    ts, vals, sid, valid, sps = mod.pack_shards(series, D)
    g = mod.sharded_window_fold(ts, vals, sid, valid, mesh=mesh,
                                series_per_shard=sps, num_windows=W,
                                res=res)
    g = np.asarray(g)
    place = mod.shard_placement(len(series), D)
    return np.stack([g[d, :, local, :] for d, local in place])  # [S,8,W]


@pytest.mark.parametrize("long_span", [False, True])
def test_window_fold_byte_identical_across_widths(long_span):
    res = 3600
    series = _fold_series(13, 7, res, long_span)
    W = int(max(s[0].max() for s in series if len(s[0])) // res) + 1
    grids = {D: _fold_grids(ts_, tmesh(D), series, D, res, W)
             for D in (1, 2, 4, 8)}
    for D in (2, 4, 8):
        assert grids[D].tobytes() == grids[1].tobytes()
    want = _fold_grids(js, jmesh(4), series, 4, res, W)
    got = grids[4]
    # count / min / max / first / last / timestamp bits exact (the
    # timestamp planes compared as int32 bits); sums at the tolerance.
    for plane in (0, 2, 3, 4, 5):
        np.testing.assert_array_equal(got[:, plane], want[:, plane])
    for plane in (6, 7):
        np.testing.assert_array_equal(got[:, plane].view(np.int32),
                                      want[:, plane].view(np.int32))
    close(got[:, 1], want[:, 1])


def test_window_summaries_sharded_matches_jax():
    from opentsdb_tpu.rollup import summary as jsum
    from opentsdb_tpu_torch.rollup import summary as tsum
    res = 600
    base = 1_700_000_000
    series = [(s[0] + base, s[1]) for s in _fold_series(9, 11, res)]
    want = jsum.window_summaries_sharded(series, res, jmesh(4))
    got = tsum.window_summaries_sharded(series, res, tmesh(4))
    assert len(got) == len(want)
    for (gw, gr), (ww, wr) in zip(got, want):
        np.testing.assert_array_equal(gw, ww)
        assert gr.dtype == wr.dtype
        for f in ("count", "min", "max", "first", "last", "first_dt",
                  "last_dt"):
            np.testing.assert_array_equal(gr[f], wr[f])
        close(gr["sum"], wr["sum"])
    one = tsum.window_summaries_sharded(series, res, tmesh(1))
    for (a, ra), (b, rb) in zip(one, got):
        assert a.tobytes() == b.tobytes() and ra.tobytes() == rb.tobytes()
