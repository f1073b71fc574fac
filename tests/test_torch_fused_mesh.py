"""The fused plan's mesh leg (opentsdb_tpu_torch/compress/kernels.py
``fused_block_stage_mesh`` over ``compress/fused.block_shards``) against
the JAX package's ``fused_block_stage_mesh`` on a 4-device CPU mesh and
against the port's single-device ``fused_block_stage``.

Contracts:
- the body: the same padded streams of real TSF32, TSINT and large-mean
  gathers through the three, for sum, avg, dev, min, max, count, rate,
  counter and drop_resets: masks, in_range and presence identical; count,
  min and max exact; sums, averages and deviations within rtol 1e-5 +
  1e-5 x scale (the fused path's float32 contract: the shards' partial
  sums merge in another order);
- the cut: whole blocks a shard, balanced by point count, with an empty
  shard, a block larger than P / D and a (series, bucket) cell whose
  points lie in two shards;
- the executors under a mesh: the port's (``Mesh(["cpu"] * 4)``) and the
  JAX package's (four virtual CPU devices) serve the fused battery, the
  selector and ``mesh-indivisible`` at D = 3 with the same answers and
  every compress.* counter delta equal, no device block cache traffic.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JaxMesh

import opentsdb_tpu.compress.kernels as jax_ck
import opentsdb_tpu_torch.compress.kernels as port_ck
from opentsdb_tpu.compress import fused as jax_fused
from opentsdb_tpu.compress.devcache import pad_fine
from opentsdb_tpu.obs.registry import METRICS as JAX_METRICS
from opentsdb_tpu.query.executor import QueryExecutor as JaxExecutor
from opentsdb_tpu.query.executor import QuerySpec as JaxSpec
from opentsdb_tpu_torch.compress import fused as port_fused
from opentsdb_tpu_torch.obs.registry import METRICS as PORT_METRICS
from opentsdb_tpu_torch.ops import block_decode, mesh_combine
from opentsdb_tpu_torch.parallel import compile as plane
from opentsdb_tpu_torch.parallel.mesh import Mesh
from opentsdb_tpu_torch.query.executor import QueryExecutor, QuerySpec
from test_torch_compress import (BASE, OPEN, SPECS, _assert_contract,
                                 _counts, _delta, _ingest, _int_batch,
                                 _jax_tsdb)

D = 4


def jmesh(n):
    return JaxMesh(np.array(jax.devices()[:n]), ("series",))


@pytest.fixture(autouse=True)
def _python_paths(monkeypatch):
    from test_torch_native import use
    use(monkeypatch, (None, None), False, False)


def _ingest_big(t, seed=3):
    """|mean| >> std: 1,000 + N(0, 1), four series over 12 hours."""
    rng = np.random.default_rng(seed)
    for si in range(4):
        ts = BASE + np.arange(0, 12 * 3600, 120, dtype=np.int64) + si
        t.add_batch("m.big", ts, 1000.0 + rng.normal(0, 1, len(ts)),
                    {"host": f"b{si}"})


@pytest.fixture(scope="module")
def gathers(tmp_path_factory):
    """A JAX v4 store of three metrics, one generation a slab, and the
    JAX gather of each over the day."""
    from test_torch_native import use
    base = tmp_path_factory.mktemp("fm")
    with pytest.MonkeyPatch.context() as mp:
        use(mp, (None, None), False, False)
        t = _jax_tsdb(str(base / "g"), 1)
        for blk in range(3):
            _ingest(t, blk)
            t.checkpoint()
        _ingest_big(t)
        t.checkpoint()
        out = {}
        for metric in ("m.cpu", "m.int", "m.big"):
            uid = t.metrics.get_id(metric)
            out[metric] = jax_fused.gather(t.store, t.table, uid, BASE,
                                           BASE + 11 * 3600)
        yield out
        t.shutdown()


def _flat(src):
    """The executor's padded single-stream layout (P_pad, pow-2 bytes)."""
    P_pad = pad_fine(src.npoints)

    def pad(a, dtype, fill=0):
        out = np.full(P_pad, fill, dtype)
        out[:len(a)] = a
        return out

    def padbuf(a):
        n = max(len(a), 1)
        out = np.zeros(1 << (n - 1).bit_length(), np.uint8)
        out[:len(a)] = a
        return out

    return [pad(src.ts_nb, np.int32), padbuf(src.ts_pay),
            pad(src.v_nb, np.int32), padbuf(src.v_pay),
            pad(src.first_idx, np.int32), pad(src.blk_first, np.int32),
            pad(src.rel_base_pt, np.int32),
            pad(np.minimum(src.sid_pt, 15), np.int32),
            pad(src.valid, bool, False)]


def _shards(src, n=D):
    return port_fused.block_shards(
        src.ts_nb, src.ts_pay, src.v_nb, src.v_pay, src.first_idx,
        src.blk_first, src.rel_base_pt, np.minimum(src.sid_pt, 15),
        src.valid, n, pad_fine)


BODY_CASES = [
    # (metric, agg_down, rate, counter, counter_max, reset_value, drops)
    ("m.cpu", "sum", False, False, 0.0, 0.0, False),
    ("m.cpu", "avg", False, False, 0.0, 0.0, False),
    ("m.cpu", "dev", False, False, 0.0, 0.0, False),
    ("m.cpu", "min", False, False, 0.0, 0.0, False),
    ("m.cpu", "max", False, False, 0.0, 0.0, False),
    ("m.cpu", "count", False, False, 0.0, 0.0, False),
    ("m.cpu", "avg", True, False, 0.0, 0.0, False),
    ("m.int", "sum", False, False, 0.0, 0.0, False),
    ("m.int", "max", True, True, 6000.0, 0.0, False),
    ("m.int", "min", True, True, 6000.0, 100.0, True),
    ("m.int", "count", False, False, 0.0, 0.0, False),
    ("m.big", "dev", False, False, 0.0, 0.0, False),
    ("m.big", "avg", False, False, 0.0, 0.0, False),
]


def _held(got, want, exact, scale):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    if exact:
        assert np.array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-5,
                                   atol=1e-5 * scale)


@pytest.mark.parametrize("case", BODY_CASES,
                         ids=lambda c: "-".join(map(str, c[:4])))
def test_mesh_body_matches_jax_mesh_and_single_device(gathers, case):
    metric, agg_down, rate, counter, cmax, rval, drops = case
    src = gathers[metric]
    statics = dict(num_series=16, num_buckets=16, interval=3600,
                   agg_down=agg_down, rate=rate, counter=counter,
                   drop_resets=drops, vkind=src.kind)
    lo, hi, shift = 100, 11 * 3600, 0
    flat = _flat(src)
    assert len(flat[0]) % D == 0
    jout = jax_ck.fused_block_stage_mesh(jmesh(D), **statics)(
        *[jnp.asarray(a) for a in flat], np.int32(lo), np.int32(hi),
        np.int32(shift), np.float32(cmax), np.float32(rval))
    shards, counts = _shards(src)
    assert sum(counts) == src.npoints
    n0 = mesh_combine.moment_combine.launches
    mout = port_ck.fused_block_stage_mesh(Mesh(["cpu"] * D), **statics)(
        *shards, lo, hi, shift, cmax, rval)
    # The plain version on the CPU counts no launch.
    assert mesh_combine.moment_combine.launches == n0
    single_kw = dict(statics, counter_max=cmax, reset_value=rval)
    sout = port_ck.fused_block_stage(
        *[torch.from_numpy(a) for a in flat], lo, hi, shift, **single_kw)
    exact = agg_down in ("count", "min", "max") and not rate
    scale = float(np.abs(np.asarray(jout[0])).max()) or 1.0
    for other in (jout, sout):
        sv, sm, filled, in_range, presence = mout
        osv, osm, ofilled, oin, opres = (np.asarray(x) for x in other)
        _held(sm, osm, True, scale)
        _held(in_range, oin, True, scale)
        _held(presence, opres, True, scale)
        assert osm.any()
        _held(torch.where(sm, sv, 0.0), np.where(osm, osv, 0.0), exact,
              scale)
        _held(torch.where(in_range, filled, 0.0),
              np.where(oin, ofilled, 0.0), exact and agg_down == "count",
              scale)


def test_mesh_body_is_one_dispatch_through_the_plane(gathers):
    src = gathers["m.cpu"]
    shards, _ = _shards(src)
    statics = dict(num_series=16, num_buckets=16, interval=3600,
                   agg_down="avg", rate=False, counter=False,
                   drop_resets=False, vkind="f32")
    mesh = Mesh(["cpu"] * D)
    fn = port_ck.fused_block_stage_mesh(mesh, **statics)
    assert port_ck.fused_block_stage_mesh(mesh, **statics) is fn
    d0 = plane._M_DISPATCH.count
    b0 = block_decode.decode_points.launches
    fn(*shards, 100, 11 * 3600, 0, 0.0, 0.0)
    assert plane._M_DISPATCH.count == d0 + 1
    assert block_decode.decode_points.launches == b0   # plain on the CPU
    with pytest.raises(TypeError):
        port_ck.fused_block_stage_mesh(mesh, counter_max=1.0, **statics)


# ---------------------------------------------------------------------------
# The cut
# ---------------------------------------------------------------------------

def _decode_shards(shards, kind):
    """Each shard decoded alone, its real points only."""
    out = []
    for d in range(shards[0].shape[0]):
        args = [torch.from_numpy(np.ascontiguousarray(a[d]))
                for a in shards[:7]]
        rel, vals = block_decode.decode_points(*args, vkind=kind)
        out.append((rel.numpy(), vals.numpy()))
    return out


def _cut_holds(src, n):
    """The cut keeps whole blocks, every point once, in stream order, and
    each shard decodes alone to the single stream's values."""
    shards, counts = port_fused.block_shards(
        src.ts_nb, src.ts_pay, src.v_nb, src.v_pay, src.first_idx,
        src.blk_first, src.rel_base_pt, src.sid_pt, src.valid, n,
        pad_fine)
    P = src.npoints
    starts = set(np.flatnonzero(src.blk_first == np.arange(P)).tolist())
    cuts = np.cumsum([0] + counts)
    assert cuts[-1] == P and all(c in starts or c == P for c in cuts)
    largest = max(np.diff(sorted(starts | {P})))
    assert max(counts) <= P / n + largest
    whole = block_decode.decode_points(
        *[torch.from_numpy(np.ascontiguousarray(a)) for a in
          (src.ts_nb, src.ts_pay, src.v_nb, src.v_pay, src.first_idx,
           src.blk_first, src.rel_base_pt.astype(np.int32))],
        vkind=src.kind)
    parts = _decode_shards(shards, src.kind)
    rel = np.concatenate([p[0][:c] for p, c in zip(parts, counts)])
    vals = np.concatenate([p[1][:c] for p, c in zip(parts, counts)])
    assert np.array_equal(rel, whole[0].numpy())
    assert np.array_equal(vals.view(np.uint32),
                          whole[1].numpy().view(np.uint32))
    for d, c in enumerate(counts):
        # Padding decodes to zeros and is never valid.
        assert not shards[8][d, c:].any()
        assert not parts[d][1][c:].any()
    return shards, counts


@pytest.mark.parametrize("metric", ["m.cpu", "m.int"])
@pytest.mark.parametrize("n", [1, 2, 3, 4, 7])
def test_cut_keeps_whole_blocks_balanced(gathers, metric, n):
    _cut_holds(gathers[metric], n)


def test_cut_with_empty_shards_and_an_oversized_block(gathers):
    """More shards than blocks leaves shards empty; a block larger than
    P / D makes its neighbours small or empty. Either way every point is
    staged once and the stage equals the single-device one."""
    src = gathers["m.big"]
    P = src.npoints
    nblocks = int((src.blk_first == np.arange(P)).sum())
    n = nblocks + 3
    shards, counts = _cut_holds(src, n)
    assert counts.count(0) >= 3
    first = int(np.flatnonzero(src.blk_first == np.arange(P))[1]
                if nblocks > 1 else P)
    assert first > P / 8 or nblocks == 1
    shards8, counts8 = _cut_holds(src, 8)
    assert max(counts8) > P / 8
    for sh, m in ((shards, n), (shards8, 8)):
        statics = dict(num_series=16, num_buckets=16, interval=3600,
                       agg_down="dev", rate=False, counter=False,
                       drop_resets=False, vkind=src.kind)
        got = port_ck.fused_block_stage_mesh(Mesh(["cpu"] * m),
                                             **statics)(
            *sh, 100, 11 * 3600, 0, 0.0, 0.0)
        want = port_ck.fused_block_stage(
            *[torch.from_numpy(a) for a in _flat(src)], 100, 11 * 3600, 0,
            **statics)
        assert torch.equal(got[1], want[1])
        np.testing.assert_allclose(
            torch.where(got[1], got[0], 0.0).numpy(),
            torch.where(want[1], want[0], 0.0).numpy(), rtol=1e-5,
            atol=1e-5 * 1000)


def _disjoint(t):
    """Each row-hour split over two generations (the disjoint-duplicate
    store): a (series, bucket) cell's points lie in two blocks."""
    for h in range(4):
        _int_batch(t, "a", BASE + h * 3600, 1800, 300, 10 + h)
    t.checkpoint()
    for h in range(4):
        _int_batch(t, "a", BASE + h * 3600 + 1800, 1800, 300, 20 + h)
    t.checkpoint()


def test_cell_split_across_shards(tmp_path):
    t = _jax_tsdb(str(tmp_path / "dj"), 1)
    try:
        _disjoint(t)
        uid = t.metrics.get_id("m.d")
        src = jax_fused.gather(t.store, t.table, uid, BASE,
                               BASE + 4 * 3600)
        shards, counts = _cut_holds(src, 2)
        # Both shards hold points of bucket 0 of the one series.
        rel = [p[0][:c] for p, c in zip(_decode_shards(shards, src.kind),
                                         counts)]
        assert all(((r >= 0) & (r < 3600)).any() for r in rel)
        for agg in ("sum", "avg", "dev", "min", "max", "count"):
            statics = dict(num_series=16, num_buckets=16, interval=3600,
                           agg_down=agg, rate=False, counter=False,
                           drop_resets=False, vkind=src.kind)
            flat = _flat(src)
            jout = jax_ck.fused_block_stage(
                *flat, np.int32(100), np.int32(4 * 3600), np.int32(0),
                **statics)
            got = port_ck.fused_block_stage_mesh(Mesh(["cpu"] * 2),
                                                 **statics)(
                *shards, 100, 4 * 3600, 0, 0.0, 0.0)
            assert np.array_equal(got[1].numpy(), np.asarray(jout[1]))
            _held(torch.where(got[1], got[0], 0.0),
                  np.where(np.asarray(jout[1]), np.asarray(jout[0]), 0.0),
                  agg in ("count", "min", "max"), 5000.0)
    finally:
        t.shutdown()


# ---------------------------------------------------------------------------
# The executors under a mesh
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def mesh_pair(tmp_path_factory):
    """A JAX and a port TSDB over the same v4 contents (the fused battery's
    store), with the device block cache on in both."""
    from test_torch_native import use
    base = tmp_path_factory.mktemp("fmx")
    with pytest.MonkeyPatch.context() as mp:
        use(mp, (None, None), False, False)
        tsdbs = {}
        for name in ("jax", "port"):
            t = OPEN[name](str(base / name), 1, devblock_points=1 << 23)
            for blk in range(5):
                _ingest(t, blk)
                t.checkpoint()
            tsdbs[name] = t
        yield tsdbs
        for t in tsdbs.values():
            t.shutdown()


def _run_both(pair, specs, n, lo=BASE + 100, hi=BASE + 19 * 3600):
    """``specs`` through the JAX and the port executor over an n-shard
    mesh: (answers, plans, compress.* deltas) of each."""
    out = {}
    for pkg, metrics in (("jax", JAX_METRICS), ("port", PORT_METRICS)):
        ex = (JaxExecutor(pair["jax"], backend="tpu", mesh=jmesh(n))
              if pkg == "jax"
              else QueryExecutor(pair["port"], mesh=Mesh(["cpu"] * n)))
        mk = JaxSpec if pkg == "jax" else QuerySpec
        before = _counts(metrics)
        res = [ex.run_with_plan(mk(m, tags, agg, rate=rate,
                                   downsample=ds), lo, hi)
               for m, tags, agg, ds, rate in specs]
        out[pkg] = ([r[0] for r in res], [r[1] for r in res],
                    _delta(before, _counts(metrics)))
    return out


@pytest.mark.parametrize("i", range(len(SPECS)))
def test_executor_mesh_leg_matches_jax_mesh(mesh_pair, i):
    d0 = plane._M_DISPATCH.count
    out = _run_both(mesh_pair, [SPECS[i]], D)
    (j, jplans, jdelta), (p, pplans, pdelta) = out["jax"], out["port"]
    assert jplans == pplans == ["fused"]
    assert pdelta == jdelta
    assert not any("devcache" in k[0] for k in pdelta)
    assert not any(k[0] == "compress.fused.decline" for k in pdelta)
    assert plane._M_DISPATCH.count > d0
    _assert_contract(p[0], j[0])
    # And the port's own answer without a mesh.
    plain = QueryExecutor(mesh_pair["port"])
    m, tags, agg, ds, rate = SPECS[i]
    w, wplan, _ = plain.run_with_plan(
        QuerySpec(m, tags, agg, rate=rate, downsample=ds), BASE + 100,
        BASE + 19 * 3600)
    assert wplan == "fused"
    _assert_contract(p[0], w)


def test_executor_mesh_indivisible_at_three(mesh_pair):
    """P_pad of these gathers (896 points) is not a multiple of 3: both
    executors count
    mesh-indivisible and serve fused on one device (the selector's
    compaction included)."""
    specs = [SPECS[0], SPECS[2]]
    out = _run_both(mesh_pair, specs, 3, hi=BASE + 11 * 3600)
    (j, jplans, jdelta), (p, pplans, pdelta) = out["jax"], out["port"]
    assert jplans == pplans == ["fused", "fused"]
    assert pdelta == jdelta
    key = ("compress.fused.decline", (("reason", "mesh-indivisible"),))
    assert pdelta[key] == 2
    for a, b in zip(p, j):
        _assert_contract(a, b)


@pytest.mark.parametrize("shape", ["4", "2x2"])
def test_daemon_mesh_serves_fused_through_the_mesh_leg(tmp_path, shape):
    """``tsd --mesh N --sstable-codec tsst4`` (and ``RxC``, flattened):
    /q answers "fused" through the mesh leg (one plane dispatch a stage,
    the compile cache holding its dispatcher), with the single-device
    daemon's answer, and no device block cache traffic."""
    import asyncio
    import json

    from opentsdb_tpu_torch.server.tsd import TSDServer
    from test_torch_compress import _port_tsdb
    from test_torch_server import _get
    q = (f"/q?start={BASE + 100}&end={BASE + 10 * 3600}"
         f"&m=max:1h-max:m.cpu%7Bhost=*%7D&json")
    answers = {}
    for mesh in ("", shape):
        t = _port_tsdb(str(tmp_path / f"d{mesh}"), 1, port=0,
                       bind="127.0.0.1", mesh_shape=mesh)
        for blk in range(3):
            _ingest(t, blk)
        t.checkpoint()
        server = TSDServer(t)
        d0 = plane._M_DISPATCH.count
        c0 = _counts(PORT_METRICS)

        async def main():
            await server.start()
            try:
                return [await _get(server.port, target)
                        for target in (q, "/api/queries")]
            finally:
                await server.stop()

        (s1, b1), (s2, b2) = asyncio.run(main())
        assert s1 == s2 == 200
        got = json.loads(b1)
        assert {g["rollup"] for g in got} == {"fused"}
        delta = _delta(c0, _counts(PORT_METRICS))
        feed = json.loads(b2)
        if mesh:
            assert plane._M_DISPATCH.count == d0 + 1
            assert feed["mesh"]["compile_cache"]["size"] >= 1
            assert feed["mesh"]["compile_cache"]["devices"] == 4
            assert not any("devcache" in k[0] for k in delta)
        else:
            assert delta[("compress.devcache.miss", ())] == 1
        answers[mesh] = [(g["tags"], g["dps"]) for g in got]
    assert answers[shape] == answers[""]


_PLANE_CHILD = r'''
import json, os, sys
import numpy as np
from opentsdb_tpu_torch.core.tsdb import TSDB
from opentsdb_tpu_torch.parallel import fleet
from opentsdb_tpu_torch.parallel.mesh import Mesh
from opentsdb_tpu_torch.query.executor import QueryExecutor, QuerySpec
from opentsdb_tpu_torch.storage.kv import MemKVStore
from opentsdb_tpu_torch.utils.config import Config

BASE = 1356998400
SPECS = [("m.cpu", {}, "sum", (3600, "avg")),
         ("m.cpu", {"host": "*"}, "dev", (3600, "dev")),
         ("m.cpu", {"dc": "e"}, "max", (7200, "max"))]


def answers(root, mesh):
    t = TSDB(MemKVStore(wal_path=os.path.join(root, "wal")),
             Config(device="cpu", auto_create_metrics=True,
                    enable_sketches=False, device_window=False,
                    sstable_codec="tsst4"), start_compaction_thread=False)
    rng = np.random.default_rng(11)
    for blk in range(3):
        for si in range(6):
            ts = BASE + blk * 4 * 3600 + np.arange(0, 4 * 3600, 300) + si
            t.add_batch("m.cpu", ts, np.cumsum(rng.normal(0, 1, len(ts)))
                        + 50, {"host": f"h{si}", "dc": "ew"[si % 2]})
        t.checkpoint()
    ex = QueryExecutor(t, mesh=mesh)
    out = []
    for m, tags, agg, ds in SPECS:
        rs, plan, _ = ex.run_with_plan(QuerySpec(m, tags, agg,
                                                 downsample=ds),
                                       BASE + 100, BASE + 11 * 3600)
        out.append([plan, [[r.tags, r.timestamps.tolist(),
                            np.asarray(r.values, np.float64).tolist()]
                           for r in rs]])
    t.shutdown()
    return out


if __name__ == "__main__":
    coord, pid, root = sys.argv[1], int(sys.argv[2]), sys.argv[3]
    fleet.init_plane(coord, 2, pid, devices_local=2, device="cpu",
                     timeout_s=60)
    got = answers(root, Mesh(["cpu"] * 2, plane=(pid, 2)))
    print(json.dumps(got))
'''


def test_fused_mesh_leg_across_two_plane_processes(tmp_path):
    """The mesh leg over a plane of two gloo processes (two shards each):
    each process stages its own rows of the same cut, the combine runs
    over all four shards' partials, and both give the one-process
    4-shard answer bit for bit."""
    import json
    import socket
    import subprocess
    import sys
    script = tmp_path / "child.py"
    script.write_text(_PLANE_CHILD)
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=root)
    procs = [subprocess.Popen(
        [sys.executable, str(script), f"127.0.0.1:{port}", str(pid),
         str(tmp_path / f"p{pid}")], stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True, env=env, cwd=root)
        for pid in range(2)]
    outs = []
    for p in procs:
        try:
            out, err = p.communicate(timeout=120)
        finally:
            p.kill()
        assert p.returncode == 0, err[-2000:]
        outs.append(json.loads(out.strip().splitlines()[-1]))
    ns: dict = {}
    exec(compile(_PLANE_CHILD, "child", "exec"), ns)
    want = ns["answers"](str(tmp_path / "one"), Mesh(["cpu"] * 4))
    assert outs[0] == outs[1] == want
    assert [a[0] for a in want] == ["fused"] * 3
