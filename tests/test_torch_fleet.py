"""The port's mesh plane (opentsdb_tpu_torch/parallel/fleet.py) and the
two-process tool (opentsdb_tpu_torch/tools/multihost_run.py) against the
JAX package's (opentsdb_tpu/parallel/fleet.py, its hybrid mesh and
sharded bodies in one process).

The JAX package's own two-process runs skip on this machine (its jaxlib
has no CPU cross-process collectives), so the port's two gloo processes
are held against the JAX package's in-process hybrid mesh over its 8
virtual CPU devices on the same data, and against the port's own
one-process run bit for bit (checked inside each child).

Tolerances: masks exact; group values within rtol 1e-5 + 1e-5 x scale
of JAX's (the levels add in chip and row order where XLA's psum takes
its own); the HLL estimate within 1e-6 relative of JAX's (the same
registers); t-digest quantiles within 2% of JAX's (two digest builds,
each within 5% of exact); the plane's integer-valued reduction equal.
"""

import asyncio
import json
import socket

import numpy as np
import pytest

import jax

from opentsdb_tpu.parallel import fleet as jfleet
from opentsdb_tpu_torch.parallel import fleet
from opentsdb_tpu_torch.tools import multihost_run as mr


@pytest.fixture
def fresh_planes():
    fleet._reset_for_tests()
    jfleet._reset_for_tests()
    yield
    fleet._reset_for_tests()
    jfleet._reset_for_tests()


@pytest.mark.parametrize("coord,n,pid", [
    ("", 1, 0), ("nohostport", 1, 0), ("127.0.0.1:1", 2, 2),
    ("127.0.0.1:1", 0, 0), ("127.0.0.1:1", 2, -1)])
def test_init_plane_errors_are_jaxs(fresh_planes, coord, n, pid):
    with pytest.raises(ValueError) as got:
        fleet.init_plane(coord, n, pid)
    with pytest.raises(ValueError) as want:
        jfleet.init_plane(coord, n, pid)
    assert str(got.value) == str(want.value)
    assert fleet.plane_info() is None


def test_init_plane_idempotent_and_single_process(fresh_planes):
    info = fleet.init_plane("127.0.0.1:1", 1, 0, devices_local=3)
    assert info == {"coordinator": "127.0.0.1:1", "process_id": 0,
                    "process_count": 1, "devices_local": 3,
                    "devices_global": 3, "backend": "gloo"}
    assert fleet.init_plane("10.0.0.1:2", 1, 0) is info
    assert fleet.plane_info() is info
    # One process is no plane to span: meshes stay in-process.
    assert fleet.plane() is None
    jinfo = jfleet.init_plane("127.0.0.1:1", 1, 0)
    assert set(info) == set(jinfo) | {"backend"}
    for k in ("coordinator", "process_id", "process_count"):
        assert info[k] == jinfo[k]
    with pytest.raises(ValueError, match="local devices"):
        fleet._reset_for_tests()
        fleet.init_plane("127.0.0.1:1", 1, 0, devices_local=0)


def test_failed_join_raises_and_leaves_no_plane(fresh_planes):
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    with pytest.raises(RuntimeError, match="failed to join"):
        fleet.init_plane(f"127.0.0.1:{port}", 2, 1, timeout_s=1.0)
    assert fleet.plane_info() is None
    with pytest.raises(RuntimeError, match="joined no mesh plane"):
        fleet.all_gather([(1,)], "cpu")


# ---------------------------------------------------------------------------
# plane_info in /healthz and /api/queries
# ---------------------------------------------------------------------------

async def _get(port, target):
    reader, writer = await asyncio.open_connection("127.0.0.1", port)
    writer.write(f"GET {target} HTTP/1.1\r\nConnection: close\r\n\r\n"
                 .encode())
    await writer.drain()
    raw = await asyncio.wait_for(reader.read(), 60)
    writer.close()
    head, _, body = raw.partition(b"\r\n\r\n")
    return int(head.split()[1]), json.loads(body)


def _serve(cls, tsdb):
    server = cls(tsdb)

    async def main():
        await server.start()
        try:
            return (await _get(server.port, "/healthz"),
                    await _get(server.port, "/api/queries"))
        finally:
            await server.stop()
    return asyncio.run(main())


@pytest.mark.parametrize("shards", [0, 2])
def test_plane_in_healthz_and_queries(fresh_planes, shards):
    from opentsdb_tpu.core.tsdb import TSDB as JaxTSDB
    from opentsdb_tpu.server.tsd import TSDServer as JaxServer
    from opentsdb_tpu.storage.kv import MemKVStore as JaxStore
    from opentsdb_tpu.utils.config import Config as JaxConfig
    from opentsdb_tpu_torch.core.tsdb import TSDB
    from opentsdb_tpu_torch.server.tsd import TSDServer
    from opentsdb_tpu_torch.storage.kv import MemKVStore
    from opentsdb_tpu_torch.utils.config import Config
    cfg = dict(auto_create_metrics=True, port=0, bind="127.0.0.1",
               enable_sketches=False, devwindow_shards=shards,
               mesh_plane="127.0.0.1:1")
    fleet.init_plane("127.0.0.1:1", 1, 0, devices_local=max(shards, 1))
    jfleet.init_plane("127.0.0.1:1", 1, 0)
    (gs, gh), (_, gq) = _serve(TSDServer, TSDB(
        MemKVStore(), Config(device="cpu", **cfg),
        start_compaction_thread=False))
    (ws, wh), (_, wq) = _serve(JaxServer, JaxTSDB(
        JaxStore(), JaxConfig(**cfg), start_compaction_thread=False))
    assert gs == ws == 200
    assert set(gh["mesh"]) == set(wh["mesh"])
    assert gh["mesh"]["width"] == wh["mesh"]["width"] == max(shards, 1)
    assert set(gh["mesh"]["plane"]) == set(wh["mesh"]["plane"]) | {
        "backend"}
    assert gh["mesh"]["plane"]["devices_local"] == max(shards, 1)
    assert gq["mesh"]["serving"]["plane"] == gh["mesh"]["plane"]
    assert set(gq["mesh"]["serving"]) == set(wq["mesh"]["serving"])


# ---------------------------------------------------------------------------
# tools/multihost_run.py: two gloo processes on the CPU
# ---------------------------------------------------------------------------

def _jax_hybrid_answers():
    from opentsdb_tpu.parallel.multihost import (hybrid_downsample_group,
                                                 hybrid_hll_distinct,
                                                 hybrid_tdigest,
                                                 make_hybrid_mesh)
    shards = [mr.synth(h, c) for h in range(mr.N_PROC)
              for c in range(mr.CHIPS_PER_PROC)]
    ts, vals, sid, valid = (np.stack([s[i] for s in shards])
                            for i in range(4))
    mesh = make_hybrid_mesh(mr.N_PROC, mr.CHIPS_PER_PROC,
                            devices=jax.devices("cpu")[:len(shards)])
    gv, gm = hybrid_downsample_group(
        ts, vals, sid, valid, mesh=mesh, series_per_shard=1,
        num_buckets=mr.B, interval=mr.INTERVAL, agg_down="avg",
        agg_group="sum")
    est = float(hybrid_hll_distinct(ts, valid, mesh=mesh, p=14))
    tq = np.asarray(hybrid_tdigest(vals, valid,
                                   np.asarray([0.1, 0.5, 0.95], np.float32),
                                   mesh=mesh))
    return np.asarray(gv), np.asarray(gm), est, tq


def test_two_processes_hybrid_against_jax(tmp_path):
    rec = mr.run_parent("hybrid", "cpu", str(tmp_path), wall_s=90)
    assert rec["ok"], rec["errors"]
    assert len(rec["processes"]) == 2
    assert json.loads((tmp_path / "multihost_hybrid.json").read_text()) \
        == rec
    wv, wm, west, wtq = _jax_hybrid_answers()
    for p in rec["processes"]:
        assert p["bit_identical_to_one_process"] is True
        assert p["plane"]["process_count"] == 2
        assert p["plane"]["devices_global"] == 8
        assert p["plane"]["backend"] == "gloo"
        assert p["mesh"] == [2, 4]
        gv, gm = np.asarray(p["group_values"]), np.asarray(p["group_mask"])
        np.testing.assert_array_equal(gm, wm)
        scale = np.abs(wv[wm]).max()
        np.testing.assert_allclose(gv[gm], wv[wm], rtol=1e-5,
                                   atol=1e-5 * scale)
        assert abs(p["hll_estimate"] - west) <= 1e-6 * west
        np.testing.assert_allclose(p["tdigest"], wtq, rtol=0.02)
    # Both processes hold the same replicated answers.
    a, b = rec["processes"]
    assert a["group_values"] == b["group_values"]
    assert a["tdigest"] == b["tdigest"]
    # The straggler: process 0 waited for process 1's 2 s sleep.
    assert a["plane"]["process_id"] == 0
    assert a["group_wall_s"] >= 1.5


def test_two_processes_plane_and_serve_against_jax(tmp_path):
    from opentsdb_tpu.parallel.mesh import make_mesh as jmake_mesh
    from opentsdb_tpu.parallel.sharded import sharded_downsample_group
    rec = mr.run_parent("plane", "cpu", None, wall_s=90)
    assert rec["ok"], rec["errors"]
    rows = mr.N_PROC * mr.CHIPS_PER_PROC
    shards = [mr.synth_plane(d) for d in range(rows)]
    ts, vals, sid, valid = (np.stack([s[i] for s in shards])
                            for i in range(4))
    jv, _ = sharded_downsample_group(
        ts, vals, sid, valid, mesh=jmake_mesh(rows,
                                              devices=jax.devices("cpu")),
        series_per_shard=1, num_buckets=mr.B, interval=mr.INTERVAL,
        agg_down="sum", agg_group="sum")
    for p in rec["processes"]:
        assert p["reduction_byte_identical"] is True
        assert p["fold_shards_byte_checked"] == mr.CHIPS_PER_PROC
        np.testing.assert_array_equal(np.asarray(p["reduction"],
                                                 np.float32),
                                      np.asarray(jv))
    rec = mr.run_parent("serve", "cpu", None, wall_s=90)
    assert rec["ok"], rec["errors"]
    for pid, p in enumerate(rec["processes"]):
        assert p["plane"]["process_id"] == pid
        assert p["width_advertised"] == 2
        assert p["widths_after_reshards"] == [1, 2]
        assert p["reshard_answers_identical"] is True


def test_cli_flags_and_a_bad_plane_refuses_to_boot(fresh_planes, tmp_path):
    """``tsd --expert-parallel --mesh-plane ... --mesh-plane-procs
    --mesh-plane-id`` reach the Config; a malformed plane spec stops the
    boot before the storage opens."""
    from opentsdb_tpu_torch.tools import cli
    args = cli.build_parser().parse_args(
        ["tsd", "--device", "cpu", "--wal", str(tmp_path / "wal"),
         "--expert-parallel", "--mesh", "2x2", "--mesh-plane", "nohost",
         "--mesh-plane-procs", "2", "--mesh-plane-id", "1"])
    assert (args.expert_parallel, args.mesh, args.mesh_plane,
            args.mesh_plane_procs, args.mesh_plane_id) == (
        True, "2x2", "nohost", 2, 1)
    with pytest.raises(ValueError, match="needs HOST:PORT"):
        cli.cmd_tsd(args)
    assert not (tmp_path / "wal").exists()
    assert fleet.plane_info() is None
