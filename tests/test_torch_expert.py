"""The port's expert-parallel batches (opentsdb_tpu_torch/parallel/expert.py,
QueryExecutor.run_expert_batch and /q behind --expert-parallel) against
the JAX package's (opentsdb_tpu/parallel/expert.py and its serving face)
on the same seeded numpy inputs and stores.

The JAX side runs on its 8 virtual CPU devices (tests/conftest.py); the
port on logical shards of the CPU (``Mesh(["cpu"] * D)``, ``--mesh 2x2``
folded on one device list).

Tolerances: plans (routing, packed arrays, codes) equal; masks, grids,
tags and counts exact; min and max exact; sums, averages and deviations
within rtol 1e-5 + 1e-5 x scale (scale = the largest magnitude of the
expected row), since the segment sums add in another order; percentile
panels exact rank selections of the same filled grid, held at the same
float tolerance (the lerp between two ranks rounds once more when the
grid's sums differ by an ulp); t-digest quantiles within 2% of each
other (two digest builds, each within the JAX test's 5% of exact); HLL
estimates within 1e-6 relative (the same registers, the estimate summed
in another order); /q bodies against the JAX daemon's: the same keys,
"plan" values, timestamps and tags, values within the tolerances above.
"""

import asyncio
import json

import numpy as np
import pytest
import torch

import jax

from opentsdb_tpu.core.tsdb import TSDB as JaxTSDB
from opentsdb_tpu.parallel import expert as jx
from opentsdb_tpu.parallel.mesh import EXPERT_AXIS as JEXPERT
from opentsdb_tpu.parallel.mesh import make_mesh as jmake_mesh
from opentsdb_tpu.query.executor import QueryExecutor as JaxExecutor
from opentsdb_tpu.query.executor import QuerySpec as JaxSpec
from opentsdb_tpu.storage.kv import MemKVStore as JaxStore
from opentsdb_tpu.utils.config import Config as JaxConfig
from opentsdb_tpu_torch.core.tsdb import TSDB
from opentsdb_tpu_torch.ops import expert_finish as ef
from opentsdb_tpu_torch.parallel import expert as tx
from opentsdb_tpu_torch.parallel.mesh import Mesh
from opentsdb_tpu_torch.parallel.plan import build_mesh
from opentsdb_tpu_torch.query.executor import QueryExecutor, QuerySpec
from opentsdb_tpu_torch.storage.kv import MemKVStore
from opentsdb_tpu_torch.utils.config import Config

BT = 1356998400


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


def jmesh(d, axis=None):
    kw = {} if axis is None else {"axis": axis}
    return jmake_mesh(d, devices=jax.devices("cpu"), **kw)


# ---------------------------------------------------------------------------
# The research face
# ---------------------------------------------------------------------------

def _research_queries(seed):
    rng = np.random.default_rng(seed)

    def moment():
        n = 200
        return {"family": "moment",
                "ts": rng.integers(0, 3600, n).astype(np.int32),
                "vals": rng.normal(40.0, 8.0, n).astype(np.float32),
                "sid": rng.integers(0, 6, n).astype(np.int32)}

    def pct(n=4000):
        return {"family": "percentile",
                "vals": rng.normal(100.0, 25.0, n).astype(np.float32)}

    def card(n=5000):
        return {"family": "cardinality",
                "items": rng.integers(0, 700, n).astype(np.int32)}
    return ([moment() for _ in range(4)] + [pct() for _ in range(2)]
            + [card() for _ in range(2)])


SPEC_ARGS = dict(num_series=6, num_buckets=12, interval=300,
                 agg_down="avg", agg_group="sum")


def _specs(mod):
    return mod.ExpertSpecs(
        moment=mod.MomentSpec(**SPEC_ARGS),
        percentile=mod.PercentileSpec(qs=(0.5, 0.95), compression=128),
        cardinality=mod.CardinalitySpec(p=12))


@pytest.mark.parametrize("n_dev", [3, 4, 8])
def test_plan_expert_batch_equals_jax(n_dev):
    queries = _research_queries(1)
    got = tx.plan_expert_batch(queries, n_dev)
    want = jx.plan_expert_batch(queries, n_dev)
    for name in ("fam", "ts", "vals", "items", "sid", "valid"):
        np.testing.assert_array_equal(getattr(got, name),
                                      getattr(want, name))
    assert got.slot_of == want.slot_of
    with pytest.raises(ValueError):
        tx.plan_expert_batch(queries, 2)
    with pytest.raises(ValueError):
        tx.plan_expert_batch([{"family": "nope"}], 4)


@pytest.mark.parametrize("D", [4, 8])
def test_run_mixed_batch_matches_jax(D):
    queries = _research_queries(2)
    got = tx.run_mixed_batch(queries, Mesh(["cpu"] * D), _specs(tx))
    want = jx.run_mixed_batch(queries, jmesh(D, JEXPERT), _specs(jx))
    for q, g, w in zip(queries, got, want):
        if q["family"] == "moment":
            np.testing.assert_array_equal(np.isnan(g), np.isnan(w))
            close(g[~np.isnan(g)], w[~np.isnan(w)])
        elif q["family"] == "percentile":
            np.testing.assert_allclose(g, w, rtol=0.02)
            np.testing.assert_allclose(
                g, np.quantile(q["vals"], [0.5, 0.95]), rtol=0.05)
        else:
            assert abs(float(g) - float(w)) <= 1e-6 * float(w)


def test_research_families_fold_a_shard_in_one_launch(monkeypatch):
    """A percentile shard folds all its slots in one t-digest fold call
    and a cardinality shard in one HLL fold call and one estimate."""
    from opentsdb_tpu_torch.ops import sketches
    calls = {"tdigest_fold": 0, "hll_fold": 0, "hll_estimate": 0}
    for name in calls:
        real = getattr(sketches, name)

        def wrap(*a, _real=real, _name=name, **k):
            calls[_name] += 1
            return _real(*a, **k)
        monkeypatch.setattr(sketches, name, wrap)
    queries = _research_queries(3)
    tx.run_mixed_batch(queries, Mesh(["cpu"] * 3), _specs(tx))
    # One shard a family at D = 3: one call each.
    assert calls == {"tdigest_fold": 1, "hll_fold": 1, "hll_estimate": 1}


# ---------------------------------------------------------------------------
# The dashboard face
# ---------------------------------------------------------------------------

def _dash_queries(seed, S=6, B=12, interval=300):
    rng = np.random.default_rng(seed)
    out = []
    specs = [("moment", "avg", "sum"), ("percentile", "avg", 0.95),
             ("moment", "max", "max"), ("moment", "sum", "dev"),
             ("percentile", "count", 0.5), ("moment", "min", "avg"),
             ("moment", "dev", "count"), ("moment", "count", "min")]
    for fam, ds, agg in specs:
        n = int(rng.integers(50, 300))
        ts = rng.integers(0, B * interval, n).astype(np.int32)
        # Some series skip whole runs of buckets, so the fill lerps.
        sid = rng.integers(0, S - 1, n).astype(np.int32)
        gap = (sid == 0) & (ts > 3 * interval) & (ts < 8 * interval)
        ts, sid = ts[~gap], sid[~gap]
        q = {"family": fam, "ts": ts, "sid": sid, "dsagg": ds,
             "vals": rng.normal(20, 6, len(ts)).astype(np.float32)}
        if fam == "percentile":
            q["quantile"] = agg
        else:
            q["agg"] = agg
        out.append(q)
    return out


@pytest.mark.parametrize("n_dev", [2, 4, 8])
def test_plan_dashboard_batch_equals_jax(n_dev):
    queries = _dash_queries(4)
    got = tx.plan_dashboard_batch(queries, n_dev)
    want = jx.plan_dashboard_batch(queries, n_dev)
    for name in ("fam", "ts", "vals", "sid", "valid", "ds_id", "agg_id",
                 "q"):
        np.testing.assert_array_equal(getattr(got, name),
                                      getattr(want, name))
    assert got.slot_of == want.slot_of
    with pytest.raises(ValueError):
        tx.plan_dashboard_batch(queries, 1)
    assert tx.DASH_AGGS == jx.DASH_AGGS == ef.DASH_AGGS


@pytest.mark.parametrize("D", [2, 4, 8])
def test_run_dashboard_batch_matches_jax(D):
    queries = _dash_queries(5)
    kw = dict(num_series=16, num_buckets=16, interval=300)
    got = tx.run_dashboard_batch(queries, Mesh(["cpu"] * D), **kw)
    want = jx.run_dashboard_batch(queries, jmesh(D), **kw)
    for q, (gv, gm), (wv, wm) in zip(queries, got, want):
        wv, wm = np.asarray(wv), np.asarray(wm)
        np.testing.assert_array_equal(gm, wm)
        exact = q["family"] == "moment" and q["agg"] in ("min", "max",
                                                         "count")
        close(gv[wm], wv[wm], exact=exact)


def test_dashboard_slots_equal_the_serial_kernels():
    """Each slot of the stacked body against the port's own serial
    downsample_group (moments) and fill + select (percentiles) on that
    slot alone: the same answers."""
    from opentsdb_tpu_torch.ops import kernels
    queries = _dash_queries(6)
    S, B, interval = 16, 16, 300
    got = tx.run_dashboard_batch(queries, Mesh(["cpu"] * 4),
                                 num_series=S, num_buckets=B,
                                 interval=interval)
    for q, (gv, gm) in zip(queries, got):
        args = [torch.from_numpy(q[k]) for k in ("ts", "vals", "sid")]
        valid = torch.ones(len(q["ts"]), dtype=torch.bool)
        r = kernels.downsample_group(
            *args, valid, num_series=S, num_buckets=B, interval=interval,
            agg_down=q["dsagg"],
            agg_group=q.get("agg", "count"))
        wm = r["group_mask"].numpy()
        np.testing.assert_array_equal(gm, wm)
        if q["family"] == "moment":
            want = r["group_values"].numpy()
        else:
            filled, in_range = kernels.gap_fill(
                r["series_values"], r["series_mask"], B)
            want = kernels.masked_quantile_axis0(
                filled, in_range, [q["quantile"]])[0].numpy()
        close(gv[wm], want[wm])


def test_dashboard_shard_counts_its_kernel_calls(monkeypatch):
    """A shard, moment or percentile, finishes in one dash_finish call,
    whatever its slot count; a percentile shard selects once a routed
    slot (none for the padding slots)."""
    from opentsdb_tpu_torch.ops import masked_select
    counts = {"finish": 0, "select": 0}
    real_f, real_s = ef.dash_finish, masked_select.select_columns

    def fin(*a, **k):
        counts["finish"] += 1
        return real_f(*a, **k)

    def sel(*a, **k):
        counts["select"] += 1
        return real_s(*a, **k)
    monkeypatch.setattr(tx, "dash_finish", fin)
    monkeypatch.setattr(masked_select, "select_columns", sel)
    queries = _dash_queries(7)
    plan = tx.plan_dashboard_batch(queries, 2)
    tx.run_dashboard_batch(queries, Mesh(["cpu"] * 2), num_series=16,
                           num_buckets=16, interval=300)
    slots = plan.valid.any(axis=2).sum(axis=1)
    pct_dev = int(np.flatnonzero(plan.fam == 1)[0])
    assert counts["finish"] == len(plan.fam) == 2
    assert slots[pct_dev] == sum(q["family"] == "percentile"
                                 for q in queries)
    assert counts["select"] == slots[pct_dev] < plan.valid.shape[1]


# ---------------------------------------------------------------------------
# The per-cell finish (finish_cells, the first step of dash_finish)
# ---------------------------------------------------------------------------

def _finish_planes(rng, Q, cells):
    count = rng.integers(0, 5, (Q, cells)).astype(np.float32)
    total = (rng.normal(0, 30, (Q, cells)) * (count > 0)).astype(np.float32)
    m2 = (rng.random((Q, cells)) * 20 * (count > 1)).astype(np.float32)
    mn = np.where(count > 0, rng.normal(-5, 3, (Q, cells)), np.inf) \
        .astype(np.float32)
    mx = np.where(count > 0, rng.normal(5, 3, (Q, cells)), -np.inf) \
        .astype(np.float32)
    for x in (total, m2, mn, mx):
        x[:, ::9] = np.nan
    m2[:, 4::11] = -1.0   # a negative centered sum clamps to 0
    return count, total, m2, mn, mx


@pytest.mark.parametrize("code", range(6))
def test_dash_finish_plain_matches_jax_finish(code):
    """The per-cell finish dash_finish starts with (finish_cells): every
    aggregator code, NaN partials and empty cells included, against the
    JAX package's _finish_switch on the same planes; slots of mixed
    codes in one call take each slot's own."""
    import jax.numpy as jnp
    rng = np.random.default_rng(code)
    planes = _finish_planes(rng, 3, 257)
    codes = [code, (code + 1) % 6, (code + 4) % 6]
    got = ef.finish_cells(*(torch.from_numpy(p) for p in planes), codes)
    for q, c in enumerate(codes):
        want = np.asarray(jx._finish_switch(
            jnp.int32(c), tuple(jnp.asarray(p[q]) for p in planes)))
        g = got[q].numpy()
        np.testing.assert_array_equal(np.isnan(g), np.isnan(want))
        fin = ~np.isnan(want)
        if c in (0, 1, 2, 5):
            assert g[fin].tobytes() == want[fin].tobytes()
        else:
            np.testing.assert_allclose(g[fin], want[fin], rtol=1e-6)
    # Only the planes the codes read are needed.
    only = ef.finish_cells(torch.from_numpy(planes[0]), None, None, None,
                           None, [5, 5, 5])
    assert torch.equal(only, torch.from_numpy(planes[0]))
    with pytest.raises(ValueError, match="needs"):
        ef.finish_cells(torch.from_numpy(planes[0]), None, None, None,
                        None, [3, 5, 5])
    assert ef.finish_cells_bytes([0, 4], 10) == 4 * 10 * 2 + 4 * 10 * 3 + 8


# ---------------------------------------------------------------------------
# The executor: answers and every decline reason, in both packages
# ---------------------------------------------------------------------------

def _load(t, metrics=("m.cpu", "m.mem"), series=5, hours=6):
    rng = np.random.default_rng(17)
    for mi, metric in enumerate(metrics):
        for si in range(series):
            ts = BT + np.arange(0, hours * 3600, 120, dtype=np.int64) + si
            vals = rng.normal(40 + 10 * mi, 8, len(ts))
            t.add_batch(metric, ts, vals,
                        {"host": f"h{si}", "dc": "e" if si % 2 else "w"})


@pytest.fixture(scope="module")
def stores():
    jt = JaxTSDB(JaxStore(), JaxConfig(
        auto_create_metrics=True, backend="tpu", enable_sketches=False,
        device_window=False), start_compaction_thread=False)
    pt = TSDB(MemKVStore(), Config(
        device="cpu", auto_create_metrics=True, enable_sketches=False,
        device_window=False), start_compaction_thread=False)
    _load(jt)
    _load(pt)
    yield jt, pt
    jt.shutdown()
    pt.shutdown()


def _jspec(s):
    return JaxSpec(s.metric, s.tags, s.aggregator, rate=s.rate,
                   downsample=s.downsample)


BATCH = [
    QuerySpec("m.cpu", {}, "sum", downsample=(600, "avg")),
    QuerySpec("m.mem", {}, "p95", downsample=(600, "avg")),
    QuerySpec("m.cpu", {"host": "*"}, "max", downsample=(600, "max")),
    QuerySpec("m.mem", {"dc": "e"}, "dev", downsample=(600, "sum")),
    QuerySpec("m.cpu", {}, "p50", downsample=(600, "count")),
    QuerySpec("m.mem", {"dc": "*"}, "avg", downsample=(600, "dev")),
    QuerySpec("m.cpu", {"dc": "*"}, "count", downsample=(600, "min")),
]


def _results_close(got, want):
    assert [(r.metric, r.tags, r.aggregated_tags) for r in got] == \
        [(r.metric, r.tags, r.aggregated_tags) for r in want]
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.timestamps, b.timestamps)
        close(a.values, b.values)


@pytest.mark.parametrize("shape", ["2x2", "4", "8"])
def test_mixed_batch_matches_jax_and_serial(stores, shape):
    jt, pt = stores
    exm = QueryExecutor(pt, mesh=build_mesh(shape, device="cpu"))
    jmesh_ = (jx_hybrid(shape) if "x" in shape else jmesh(int(shape)))
    jexm = JaxExecutor(jt, mesh=jmesh_)
    start, end = BT + 60, BT + 5 * 3600
    got, why = exm.run_expert_batch(BATCH, start, end)
    want, jwhy = jexm.run_expert_batch([_jspec(s) for s in BATCH], start,
                                       end)
    assert why is None and jwhy is None
    ex0 = QueryExecutor(pt)
    for spec, g, w in zip(BATCH, got, want):
        _results_close(g, w)
        _results_close(g, ex0.run(spec, start, end))


def jx_hybrid(shape):
    from opentsdb_tpu.parallel.plan import build_mesh as jbuild
    return jbuild(shape, devices=jax.devices("cpu"))


def _decline_cases():
    b0 = BATCH[0]
    return [
        ("no-mesh", None, "device", [b0, BATCH[1]], None),
        ("single-device-mesh", "1", "device", [b0, BATCH[1]], None),
        ("cpu-backend", "4", "cpu", [b0, BATCH[1]], None),
        ("single-query", "4", "device", [b0], None),
        ("no-downsample", "4", "device",
         [b0, QuerySpec("m.mem", {}, "sum")], None),
        ("downsampler", "4", "device",
         [b0, QuerySpec("m.mem", {}, "sum", downsample=(600, "p95"))],
         None),
        ("no-lerp-agg", "4", "device",
         [b0, QuerySpec("m.mem", {}, "zimsum", downsample=(600, "avg"))],
         None),
        ("agg-family", "4", "device",
         [b0, QuerySpec("m.mem", {}, "cardinality",
                        downsample=(600, "avg"))], None),
        ("rate", "4", "device",
         [b0, QuerySpec("m.mem", {}, "sum", rate=True,
                        downsample=(600, "avg"))], None),
        ("ragged-intervals", "4", "device",
         [b0, QuerySpec("m.mem", {}, "sum", downsample=(300, "avg"))],
         None),
        ("range", "4", "device",
         [QuerySpec("m.cpu", {}, "sum", downsample=(60, "avg")),
          QuerySpec("m.mem", {}, "p95", downsample=(60, "avg"))],
         (BT, BT + 2**31 + 120)),
        ("grid", "4", "device",
         [QuerySpec("m.cpu", {}, "sum", downsample=(1, "avg")),
          QuerySpec("m.mem", {}, "p95", downsample=(1, "avg"))],
         (BT, BT + 2**31 - 2)),
    ]


@pytest.mark.parametrize("reason,shape,backend,specs,rng",
                         _decline_cases(),
                         ids=[c[0] for c in _decline_cases()])
def test_declines_are_jaxs(stores, reason, shape, backend, specs, rng):
    """Each JAX decline reason, on the batch that triggers it, in both
    packages, in the JAX package's order of checks."""
    jt, pt = stores
    start, end = rng or (BT + 60, BT + 5 * 3600)
    pmesh = None if shape is None else build_mesh(shape, device="cpu")
    jm = None if shape is None else jmesh(int(shape))
    jbackend = "cpu" if backend == "cpu" else "tpu"
    got = QueryExecutor(pt, backend=backend, mesh=pmesh).run_expert_batch(
        specs, start, end)
    want = JaxExecutor(jt, backend=jbackend, mesh=jm).run_expert_batch(
        [_jspec(s) for s in specs], start, end)
    assert got == (None, reason)
    assert want == (None, reason)


def test_empty_scan_returns_empty_per_spec(stores):
    jt, pt = stores
    exm = QueryExecutor(pt, mesh=build_mesh("4", device="cpu"))
    got = exm.run_expert_batch(BATCH[:2], BT + 40 * 86400, BT + 41 * 86400)
    want = JaxExecutor(jt, mesh=jmesh(4)).run_expert_batch(
        [_jspec(s) for s in BATCH[:2]], BT + 40 * 86400, BT + 41 * 86400)
    assert got == ([[], []], None)
    assert want == ([[], []], None)


# ---------------------------------------------------------------------------
# /q through both daemons with --expert-parallel on a 4-shard mesh
# ---------------------------------------------------------------------------

async def _get(port, target):
    reader, writer = await asyncio.open_connection("127.0.0.1", port)
    writer.write(f"GET {target} HTTP/1.1\r\nConnection: close\r\n\r\n"
                 .encode())
    await writer.drain()
    raw = await asyncio.wait_for(reader.read(), 60)
    writer.close()
    head, _, body = raw.partition(b"\r\n\r\n")
    return int(head.split()[1]), body


DASHBOARDS = {
    "served": ["sum:10m-avg:m.cpu", "p95:10m-avg:m.mem",
               "max:10m-max:m.cpu%7Bhost=*%7D", "dev:10m-avg:m.mem",
               "p50:10m-avg:m.cpu%7Bdc=*%7D"],
    "ragged": ["sum:10m-avg:m.cpu", "sum:5m-avg:m.mem"],
    "rate": ["sum:10m-avg:m.cpu", "sum:10m-avg:rate:m.mem"],
    "single": ["sum:10m-avg:m.cpu"],
}


def _daemon(cls, tsdb):
    server = cls(tsdb)
    _load(tsdb, series=3, hours=3)

    async def main():
        await server.start()
        try:
            out = {}
            for name, ms in DASHBOARDS.items():
                target = (f"/q?start={BT}&end={BT + 2 * 3600}&"
                          + "&".join(f"m={m}" for m in ms) + "&json")
                out[name] = await _get(server.port, target)
            out["queries"] = await _get(server.port, "/api/queries")
            return out
        finally:
            await server.stop()
    return asyncio.run(main())


def _both(expert, mesh_shape):
    from opentsdb_tpu.server.tsd import TSDServer as JaxServer
    from opentsdb_tpu_torch.parallel.compile import set_mesh_devices
    from opentsdb_tpu_torch.server.tsd import TSDServer
    cfg = dict(auto_create_metrics=True, port=0, bind="127.0.0.1",
               enable_sketches=False, device_window=False,
               mesh_shape=mesh_shape, expert_parallel=expert)
    want = _daemon(JaxServer, JaxTSDB(JaxStore(), JaxConfig(
        backend="tpu", **cfg), start_compaction_thread=False))
    try:
        got = _daemon(TSDServer, TSDB(MemKVStore(), Config(
            device="cpu", **cfg), start_compaction_thread=False))
    finally:
        set_mesh_devices(1)
    return got, want


def _bodies_close(gb, wb):
    g, w = json.loads(gb), json.loads(wb)
    assert [(r["metric"], r["tags"], r["aggregateTags"]) for r in g] == \
        [(r["metric"], r["tags"], r["aggregateTags"]) for r in w]
    for a, b in zip(g, w):
        assert set(a) == set(b)
        assert a.get("plan") == b.get("plan")
        assert a["rollup"] == b["rollup"]
        assert list(a["dps"]) == list(b["dps"])
        close(list(a["dps"].values()), list(b["dps"].values()))
    return g


@pytest.mark.parametrize("mesh_shape", ["4", "2x2"])
def test_q_through_both_daemons(mesh_shape):
    from opentsdb_tpu_torch.obs.registry import METRICS
    before = {k: METRICS.counter("mesh.expert.decline", {"reason": k}).value
              for k in ("ragged-intervals", "rate")}
    serve0 = METRICS.counter("mesh.expert.serve").value
    got, want = _both(True, mesh_shape)
    for name in DASHBOARDS:
        (gs, gb), (ws, wb) = got[name], want[name]
        assert gs == ws == 200
        g = _bodies_close(gb, wb)
        plan = {"served": "expert", "ragged": "expert-decline",
                "rate": "expert-decline", "single": None}[name]
        assert g and all(r.get("plan") == plan for r in g)
        if name == "served":
            assert all(r["rollup"] == "expert" for r in g)
    assert METRICS.counter("mesh.expert.serve").value - serve0 == 5
    for k, v in before.items():
        assert METRICS.counter("mesh.expert.decline",
                               {"reason": k}).value - v == 2
    gq, wq = (json.loads(x["queries"][1]) for x in (got, want))
    assert gq["mesh"]["expert_enabled"] is wq["mesh"]["expert_enabled"] \
        is True
    assert gq["plans"]["expert"] == wq["plans"]["expert"] == 5
    assert gq["plans"]["expert-decline"] == \
        wq["plans"]["expert-decline"] == 4
    assert gq["mesh"]["expert"]["serve"] >= 5
    assert gq["mesh"]["devices"] == wq["mesh"]["devices"] == 4


def test_q_expert_off_and_knob_without_mesh():
    """Expert off: no "plan" key, answers the serial ones (the served
    dashboard's bodies equal the expert daemon's within tolerance); the
    knob without a mesh declares the no-mesh decline."""
    off, woff = _both(False, "4")
    on, _ = _both(True, "4")
    for name in DASHBOARDS:
        g = _bodies_close(off[name][1], woff[name][1])
        assert all("plan" not in r for r in g)
    e, s = json.loads(on["served"][1]), json.loads(off["served"][1])
    assert [(r["metric"], r["tags"]) for r in e] == \
        [(r["metric"], r["tags"]) for r in s]
    for a, b in zip(e, s):
        assert list(a["dps"]) == list(b["dps"])
        close(list(a["dps"].values()), list(b["dps"].values()))
    assert json.loads(off["queries"][1])["mesh"]["expert_enabled"] is False
    nomesh, wnomesh = _both(True, "")
    for name in ("served", "ragged"):
        g = _bodies_close(nomesh[name][1], wnomesh[name][1])
        assert all(r["plan"] == "expert-decline" for r in g)
    assert json.loads(nomesh["queries"][1])["mesh"]["devices"] == 1
