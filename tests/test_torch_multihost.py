"""The port's hybrid host x series mesh (opentsdb_tpu_torch/parallel/
multihost.py, the 2-D Mesh and the axis collectives of parallel/
compile.py) against the JAX package's (opentsdb_tpu/parallel/
multihost.py) on the same seeded numpy inputs.

The JAX side runs on its 8 virtual CPU devices (tests/conftest.py),
folded 2 x 4 and 4 x 2; the port on 8 logical shards of the CPU folded
the same ways.

Tolerances: masks and counts exact, min and max exact against the
port's unsharded kernel and, over lerped values, within rtol 1e-6 of
JAX's (XLA rounds the float32 lerp in its own way: ROADMAP note 1 of
PR 4); sums, averages and deviations within rtol 2e-5 / atol 1e-4 of
the unsharded kernel (the JAX test's bounds) and within rtol 1e-5 +
1e-5 x scale of JAX's hybrid answer (the levels add in chip and row
order where XLA's psum takes its own); HLL within 5% of exact and within 1e-6 relative of
JAX's (the same registers); t-digest quantiles within 5% of exact (the
JAX test's bound) and within 2% of JAX's (two digest builds). The
hybrid combine's emit-then-finish equals its finish-in-one bit for bit.
"""

import zlib

import numpy as np
import pytest
import torch

import jax

from opentsdb_tpu.parallel import multihost as jmh
from opentsdb_tpu.parallel.sharded import pack_shards as jpack
from opentsdb_tpu_torch.ops import kernels
from opentsdb_tpu_torch.ops import mesh_combine as mc
from opentsdb_tpu_torch.parallel import compile as tcompile
from opentsdb_tpu_torch.parallel import multihost as tmh
from opentsdb_tpu_torch.parallel.mesh import HOST_AXIS, SERIES_AXIS, Mesh
from opentsdb_tpu_torch.parallel.plan import (ExecPlan, build_mesh,
                                              flatten_series_mesh)
from opentsdb_tpu_torch.parallel.sharded import pack_shards

FOLDS = [(2, 4), (4, 2)]
AGGS = ("sum", "avg", "dev", "min", "max", "count", "zimsum", "mimmin")


def tmesh(h, c):
    return tmh.make_hybrid_mesh(h, c, devices=["cpu"] * (h * c))


def jmesh(h, c):
    return jmh.make_hybrid_mesh(h, c, devices=jax.devices("cpu")[:h * c])


def random_series(rng, n_points, span=7200):
    ts = np.sort(rng.choice(np.arange(span), size=n_points,
                            replace=False)).astype(np.int64)
    return ts, rng.normal(50.0, 10.0, size=n_points)


def close(got, want):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    fin = np.isfinite(want)
    scale = float(np.abs(want[fin]).max()) if fin.any() else 1.0
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5 * scale)


def test_axes_shape_and_bad_fold():
    m = tmesh(2, 4)
    jm = jmesh(2, 4)
    assert m.axis_names == tuple(jm.axis_names) == (HOST_AXIS, SERIES_AXIS)
    assert m.devices.shape == tuple(jm.devices.shape) == (2, 4)
    assert m.size == jm.devices.size == 8
    assert flatten_series_mesh(m).axis_names == (SERIES_AXIS,)
    assert flatten_series_mesh(m).size == 8
    with pytest.raises(ValueError, match="don't fold"):
        tmh.make_hybrid_mesh(3, 3, devices=["cpu"] * 8)
    with pytest.raises(ValueError, match="don't fold"):
        jmh.make_hybrid_mesh(3, 3)
    assert tmesh(2, 2) == tmesh(2, 2)
    assert len({tmesh(2, 2), tmesh(2, 2), tmesh(4, 1)}) == 2


def test_single_process_init_is_noop(monkeypatch):
    for var in ("MASTER_ADDR", "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(var, raising=False)
    assert tmh.init_multihost() is False
    assert jmh.init_multihost() is False


def test_build_mesh_hybrid_matches_jax():
    from opentsdb_tpu.parallel.plan import build_mesh as jbuild
    for shape in ("2x4", "4x2", "1x8", "2X2"):
        got = build_mesh(shape, device="cpu")
        want = jbuild(shape, devices=jax.devices("cpu"))
        assert got.axis_names == tuple(want.axis_names)
        assert got.devices.shape == tuple(want.devices.shape)
    for bad in ("0x2", "2x0", "-1x2"):
        with pytest.raises(ValueError, match="bad mesh shape"):
            build_mesh(bad, device="cpu")
        with pytest.raises(ValueError, match="bad mesh shape"):
            jbuild(bad, devices=jax.devices("cpu"))
    with pytest.raises(ValueError, match="needs 9 devices, have 8"):
        build_mesh("3x3", devices=["cpu"] * 8)
    with pytest.raises(ValueError, match="needs 9 devices, have 8"):
        jbuild("3x3", devices=jax.devices("cpu"))
    if not torch.cuda.is_available():
        with pytest.raises(ValueError, match="needs 4 devices, have 0"):
            build_mesh("2x2", device="cuda")


# ---------------------------------------------------------------------------
# Axis collectives
# ---------------------------------------------------------------------------

def _port_axes(x, *, axis_index):
    row = yield tcompile.psum(x, axis=SERIES_AXIS)
    row_min = yield tcompile.pmin(x, axis=SERIES_AXIS)
    hosts = yield tcompile.psum(row, axis=HOST_AXIS)
    hmax = yield tcompile.pmax(row_min, axis=HOST_AXIS)
    g = yield tcompile.all_gather(x, axis=SERIES_AXIS)
    whole = yield tcompile.psum(x)
    return row[None], hosts[None], hmax[None], g[None], whole[None]


def _jax_axes(x):
    x = x[0]
    row = jax.lax.psum(x, SERIES_AXIS)
    row_min = jax.lax.pmin(x, SERIES_AXIS)
    hosts = jax.lax.psum(row, HOST_AXIS)
    hmax = jax.lax.pmax(row_min, HOST_AXIS)
    g = jax.lax.all_gather(x, SERIES_AXIS)
    whole = jax.lax.psum(x, (HOST_AXIS, SERIES_AXIS))
    return tuple(v[None] for v in (row, hosts, hmax, g, whole))


@pytest.mark.parametrize("fold", FOLDS)
def test_axis_collectives_match_jax(fold):
    from jax.sharding import PartitionSpec as P
    from opentsdb_tpu.parallel.mesh import shard_map
    h, c = fold
    x = np.random.default_rng(h).integers(-50, 50, (h * c, 5)) \
        .astype(np.float32)
    plan = ExecPlan(name="test.axes", axis="host", style="shard_map",
                    in_specs=((HOST_AXIS, SERIES_AXIS),),
                    out_specs=((HOST_AXIS, SERIES_AXIS),) * 5)
    got = tcompile.compile_with_plan(_port_axes, plan, tmesh(h, c))(x)
    spec = P((HOST_AXIS, SERIES_AXIS))
    want = jax.jit(shard_map(_jax_axes, mesh=jmesh(h, c), in_specs=spec,
                             out_specs=(spec,) * 5))(x)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def _port_host_columns(x, *, axis_index):
    s = yield tcompile.psum(x, axis=HOST_AXIS)
    lo = yield tcompile.pmin(x, axis=HOST_AXIS)
    hi = yield tcompile.pmax(x, axis=HOST_AXIS)
    g = yield tcompile.all_gather(x, axis=HOST_AXIS)
    return s[None], lo[None], hi[None], g[None]


def _jax_host_columns(x):
    x = x[0]
    return tuple(v[None] for v in (
        jax.lax.psum(x, HOST_AXIS), jax.lax.pmin(x, HOST_AXIS),
        jax.lax.pmax(x, HOST_AXIS), jax.lax.all_gather(x, HOST_AXIS)))


@pytest.mark.parametrize("fold", FOLDS + [(2, 2)])
def test_host_collectives_combine_each_chip_column(fold):
    """A host-axis collective on data that differs across a row's chips
    combines chip c of every row, as JAX's does, never one chip's
    payload for the whole row."""
    from jax.sharding import PartitionSpec as P
    from opentsdb_tpu.parallel.mesh import shard_map
    h, c = fold
    x = np.random.default_rng(h * 10 + c).integers(-50, 50, (h * c, 5)) \
        .astype(np.float32)
    plan = ExecPlan(name="test.host_columns", axis="host",
                    style="shard_map", in_specs=((HOST_AXIS, SERIES_AXIS),),
                    out_specs=((HOST_AXIS, SERIES_AXIS),) * 4)
    got = tcompile.compile_with_plan(_port_host_columns, plan,
                                     tmesh(h, c))(x)
    spec = P((HOST_AXIS, SERIES_AXIS))
    want = jax.jit(shard_map(_jax_host_columns, mesh=jmesh(h, c),
                             in_specs=spec, out_specs=(spec,) * 4))(x)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    cols = x.reshape(h, c, 5)
    np.testing.assert_array_equal(
        got[0].numpy().reshape(h, c, 5),
        np.broadcast_to(cols.sum(axis=0), (h, c, 5)))


def _divergent(x, *, axis_index):
    if axis_index < 4:
        y = yield tcompile.psum(x, axis=SERIES_AXIS)
    else:
        y = yield tcompile.psum(x, axis=HOST_AXIS)
    return y


def _divergent_fn(x, *, axis_index):
    if axis_index % 2:
        y = yield tcompile.pmax(x, axis=SERIES_AXIS)
    else:
        y = yield tcompile.psum(x, axis=SERIES_AXIS)
    return y


@pytest.mark.parametrize("body", [_divergent, _divergent_fn])
def test_rows_at_different_collectives_raise(body):
    plan = ExecPlan(name="test.diverge", axis="host", style="shard_map",
                    in_specs=((HOST_AXIS, SERIES_AXIS),), out_specs=None)
    fn = tcompile.compile_with_plan(body, plan, tmesh(2, 4))
    with pytest.raises(RuntimeError, match="different collectives"):
        fn(np.ones((8, 3), np.float32))


def _zeros(payloads, dev):
    return [0] * len(payloads)


def test_host_collective_is_replicated_only():
    def per(x, *, axis_index):
        return (yield tcompile.combine(_zeros, x, per_shard=True,
                                       axis=HOST_AXIS))
    plan = ExecPlan(name="test.per", axis="host", style="shard_map",
                    in_specs=((HOST_AXIS, SERIES_AXIS),), out_specs=None)
    with pytest.raises(ValueError, match="replicated"):
        tcompile.compile_with_plan(per, plan, tmesh(2, 2))(
            np.ones((4, 2), np.float32))
    with pytest.raises(ValueError, match="axis"):
        tcompile.compile_with_plan(
            _port_axes, plan, Mesh(["cpu"] * 4))(np.ones((4, 2), np.float32))


# ---------------------------------------------------------------------------
# The hybrid bodies
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("fold", FOLDS)
@pytest.mark.parametrize("agg_group", AGGS)
def test_hybrid_group_matches_jax_and_unsharded(fold, agg_group,
                                                monkeypatch):
    rng = np.random.default_rng(zlib.crc32(repr((fold, agg_group))
                                           .encode()))
    series = [random_series(rng, int(rng.integers(10, 80)))
              for _ in range(24)]
    interval, B = 300, 24
    ts, vals, sid, valid, sps = pack_shards(series, 8)
    kw = dict(series_per_shard=sps, num_buckets=B, interval=interval,
              agg_down="avg", agg_group=agg_group)
    calls = []
    orig = mc.hybrid_moment_combine

    def tap(*args, agg, emit=False):
        calls.append(args)
        return orig(*args, agg=agg, emit=emit)
    monkeypatch.setattr(mc, "hybrid_moment_combine", tap)
    gv, gm = tmh.hybrid_downsample_group(ts, vals, sid, valid,
                                         mesh=tmesh(*fold), **kw)
    monkeypatch.undo()
    # The body's partials through the cross-process sequence (each
    # row's emit, the rows gathered, the finish over the rows) give the
    # one-launch finish's bits.
    (args,) = calls
    rows = [orig(*(None if x is None else x[h:h + 1] for x in args),
                 agg=agg_group, emit=True) for h in range(fold[0])]
    gv2, gm2 = orig(*(None if rows[0][i] is None
                      else torch.cat([r[i] for r in rows])[:, None]
                      for i in range(7)), agg=agg_group)
    assert torch.equal(gm, gm2)
    assert gv.numpy().tobytes() == gv2.numpy().tobytes()
    jts, jvals, jsid, jvalid, jsps = jpack(series, 8)
    assert jsps == sps
    jv, jm = jmh.hybrid_downsample_group(jts, jvals, jsid, jvalid,
                                         mesh=jmesh(*fold), **kw)
    jv, jm = np.asarray(jv), np.asarray(jm)
    gv, gm = gv.numpy(), gm.numpy()
    np.testing.assert_array_equal(gm, jm)
    if agg_group in ("count", "mimmin"):
        np.testing.assert_array_equal(gv[gm], jv[jm])
    elif agg_group in ("min", "max"):
        # Over lerped values: XLA rounds the float32 lerp in its own way
        # (ROADMAP note 1 of PR 4); exact against the port's unsharded
        # kernel below.
        np.testing.assert_allclose(gv[gm], jv[jm], rtol=1e-6, atol=0)
    else:
        close(gv[gm], jv[jm])
    flat_ts = torch.from_numpy(
        np.concatenate([s[0] for s in series]).astype(np.int32))
    flat_vals = torch.from_numpy(
        np.concatenate([s[1] for s in series]).astype(np.float32))
    flat_sid = torch.from_numpy(np.concatenate(
        [np.full(len(s[0]), i, np.int32) for i, s in enumerate(series)]))
    ref = kernels.downsample_group(
        flat_ts, flat_vals, flat_sid, torch.ones(len(flat_ts), dtype=bool),
        num_series=len(series), num_buckets=B, interval=interval,
        agg_down="avg", agg_group=agg_group)
    np.testing.assert_array_equal(gm, ref["group_mask"].numpy())
    if agg_group in ("min", "max", "count", "mimmin"):
        np.testing.assert_array_equal(gv[gm],
                                      ref["group_values"].numpy()[gm])
    else:
        np.testing.assert_allclose(gv[gm], ref["group_values"].numpy()[gm],
                                   rtol=2e-5, atol=1e-4)


@pytest.mark.parametrize("fold", FOLDS)
def test_hybrid_hll_matches_jax(fold):
    rng = np.random.default_rng(fold[0])
    items = rng.integers(0, 5000, (8, 4000)).astype(np.int32)
    valid = np.ones_like(items, bool)
    valid[5:, 3000:] = False
    est = float(tmh.hybrid_hll_distinct(items, valid, mesh=tmesh(*fold),
                                        p=14))
    jest = float(jmh.hybrid_hll_distinct(items, valid, mesh=jmesh(*fold),
                                         p=14))
    exact = len(np.unique(items[valid]))
    assert abs(est - exact) / exact < 0.05
    assert abs(est - jest) <= 1e-6 * jest


@pytest.mark.parametrize("fold", FOLDS)
def test_hybrid_tdigest_matches_jax(fold):
    rng = np.random.default_rng(fold[1])
    values = rng.normal(100.0, 25.0, (8, 5000)).astype(np.float32)
    valid = np.ones_like(values, bool)
    qs = np.asarray([0.1, 0.5, 0.95, 0.99], np.float32)
    got = tmh.hybrid_tdigest(values, valid, qs, mesh=tmesh(*fold)).numpy()
    want = np.asarray(jmh.hybrid_tdigest(values, valid, qs,
                                         mesh=jmesh(*fold)))
    np.testing.assert_allclose(got, np.quantile(values.reshape(-1), qs),
                               rtol=0.05)
    np.testing.assert_allclose(got, want, rtol=0.02)


def test_hybrid_tdigest_recompresses_through_the_fold(monkeypatch):
    """Each level's recompress is one tdigest_fold call with batch
    weights: H row merges, then one host merge (plus a fold a shard)."""
    from opentsdb_tpu_torch.ops import sketches
    seen = []
    real = sketches.tdigest_fold

    def wrap(*a, **k):
        seen.append("batch_weights" if k.get("batch_weights") is not None
                    else "valid")
        return real(*a, **k)
    monkeypatch.setattr(sketches, "tdigest_fold", wrap)
    values = np.random.default_rng(3).normal(0, 1, (8, 300)) \
        .astype(np.float32)
    tmh.hybrid_tdigest(values, np.ones_like(values, bool), [0.5],
                       mesh=tmesh(2, 4))
    assert seen.count("valid") == 8
    assert seen.count("batch_weights") == 2 + 1


# ---------------------------------------------------------------------------
# hybrid_moment_combine
# ---------------------------------------------------------------------------

def _partials(rng, H, C, cells, special=None):
    n = rng.integers(0, 6, (H, C, cells)).astype(np.float32)
    total = (rng.normal(0, 50, (H, C, cells)) * (n > 0)).astype(np.float32)
    mean = (total / np.maximum(n, 1)).astype(np.float32)
    m2 = (rng.random((H, C, cells)) * 30 * (n > 1)).astype(np.float32)
    mn = np.where(n > 0, rng.normal(-5, 3, (H, C, cells)), np.inf) \
        .astype(np.float32)
    mx = np.where(n > 0, rng.normal(5, 3, (H, C, cells)), -np.inf) \
        .astype(np.float32)
    if special == "nan":
        for x in (total, m2, mn, mx, mean):
            x[..., ::7] = np.nan
    any_ = (n > 0).astype(np.int32)
    return [torch.from_numpy(x) for x in (n, total, m2, mean, mn, mx,
                                          any_)]


@pytest.mark.parametrize("special", [None, "nan"])
@pytest.mark.parametrize("H,C", [(2, 4), (4, 2), (1, 3), (3, 1), (2, 2)])
@pytest.mark.parametrize("agg", ["sum", "avg", "dev", "count", "min",
                                 "max", "zimsum", "mimmax"])
def test_hybrid_combine_emit_then_finish_is_finish_in_one(agg, H, C,
                                                          special):
    """The cross-process sequence -- each row's (1, C) emit, the rows
    gathered, a (H, 1) finish -- gives the bits of the (H, C) finish, and
    the emitted rows hold only the planes the aggregator reads."""
    planes = _partials(np.random.default_rng(H * 10 + C), H, C, 300,
                       special)
    want_v, want_m = mc.hybrid_moment_combine(*planes, agg=agg)
    rows = [mc.hybrid_moment_combine(*(p[h:h + 1] for p in planes),
                                     agg=agg, emit=True)
            for h in range(H)]
    need = mc.hybrid_needs(agg)
    for r in rows:
        assert [x is not None for x in r[:6]] == \
            [n in need for n in mc.HYBRID_PLANES]
    gathered = [None if rows[0][i] is None
                else torch.cat([r[i] for r in rows])[:, None]
                for i in range(7)]
    got_v, got_m = mc.hybrid_moment_combine(*gathered, agg=agg)
    assert torch.equal(got_m, want_m)
    assert got_v.numpy().tobytes() == want_v.numpy().tobytes()


@pytest.mark.parametrize("agg", ["sum", "avg", "dev", "count", "min",
                                 "max"])
def test_hybrid_combine_matches_a_float64_merge(agg):
    """Against the exact merge in float64 of the same partials (the
    pooled moments of all H x C chips)."""
    H, C, cells = 3, 4, 200
    n, total, m2, mean, mn, mx, any_ = _partials(
        np.random.default_rng(5), H, C, cells)
    got, mask = mc.hybrid_moment_combine(n, total, m2, mean, mn, mx, any_,
                                         agg=agg)
    n64, t64 = n.double().reshape(-1, cells), total.double().reshape(
        -1, cells)
    g_n, g_t = n64.sum(0), t64.sum(0)
    g_mean = g_t / g_n.clamp(min=1)
    g_m2 = (m2.double().reshape(-1, cells)
            + n64 * (mean.double().reshape(-1, cells) - g_mean) ** 2).sum(0)
    want = {"sum": g_t, "avg": g_t / g_n.clamp(min=1), "count": g_n,
            "dev": (g_m2.clamp(min=0) / g_n.clamp(min=1)).sqrt(),
            "min": mn.double().reshape(-1, cells).amin(0),
            "max": mx.double().reshape(-1, cells).amax(0)}[agg]
    assert torch.equal(mask, (any_ != 0).reshape(-1, cells).any(0))
    m = mask.numpy()
    np.testing.assert_allclose(got.numpy()[m], want.numpy()[m], rtol=1e-5,
                               atol=1e-4)
    with pytest.raises(ValueError, match="needs"):
        mc.hybrid_moment_combine(n, None, m2, mean, mn, mx, any_,
                                 agg="avg")
    with pytest.raises(ValueError, match="at most"):
        z = torch.zeros((17, 1, 2))
        mc.hybrid_moment_combine(z, z, z, z, z, z, z.int(), agg="sum")


def test_shard_digest_past_one_fold_row():
    """A shard past the fold kernel's row (FOLD_MAX_ENTRIES with the
    digest's centroids) folds rows of its values in one launch and
    recompresses their digests a level at a time: every valid value
    weighed once, the quantiles within 1% in rank of the exact ones (the
    live sketches' bound); a shard that fits takes tdigest_add's one
    compress, as in the JAX package."""
    from opentsdb_tpu_torch.ops import sketches
    rng = np.random.default_rng(12)
    values = torch.from_numpy(rng.normal(100, 25, 600_000)
                              .astype(np.float32))
    valid = torch.from_numpy(rng.random(600_000) < 0.9)
    m, w = tmh._shard_digest(values, valid, 128)
    assert float(w.sum()) == float(valid.sum())
    ordered = np.sort(values.numpy()[valid.numpy()])
    for q in (0.01, 0.5, 0.95, 0.99):
        est = float(sketches.tdigest_quantile(m, w, [q])[0])
        rank = np.searchsorted(ordered, est) / len(ordered)
        assert abs(rank - q) <= 0.01, (q, rank)
    small = values[:5000]
    ok = valid[:5000]
    got = tmh._shard_digest(small, ok, 128)
    want = sketches.tdigest_add(*sketches.tdigest_init(128, device="cpu"),
                                small, ok, compression=128)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
